"""Normalized-convolution primitives, the math under NCUP (port of
``raft_ncup_tpu/ops/nconv.py``).

The core op is a pair of convolutions sharing one non-negative kernel:

    out  = conv(data * conf, w) / (conv(conf, w) + eps) [+ bias]
    cout = conv(conf, w) / sum(w)        # propagated confidence

``impl`` picks the plain composition (``"xla"``, the JAX package's name)
or the fused kernel (``"pallas"``, CUDA in the port: ``ops/nconv_cuda.py``).
Public functions keep the JAX layouts (NHWC data, HWIO weights); the
``*_nchw`` forms are what the port's NCHW NCUP stack calls.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from raft_ncup_tpu_torch.ops.nconv_cuda import nconv2d_fused, nconv2d_plain
from raft_ncup_tpu_torch.parallel import halo


def positivity(raw: torch.Tensor, pos_fn: str = "softplus") -> torch.Tensor:
    """Map a raw parameter to a non-negative kernel (softplus with
    beta=10 by default: softplus(10 x) / 10). For 'softmax' the raw
    parameter is (..., Cout)-last, as in the JAX package (HWIO)."""
    pos_fn = pos_fn.lower()
    if pos_fn == "softplus":
        return F.softplus(10.0 * raw) / 10.0
    if pos_fn == "exp":
        return torch.exp(raw)
    if pos_fn == "sigmoid":
        return torch.sigmoid(raw)
    if pos_fn == "softmax":
        o = raw.shape[-1]
        return torch.softmax(raw.reshape(-1, o), dim=0).reshape(raw.shape)
    raise ValueError(f"unknown pos_fn: {pos_fn!r}")


def nconv2d_nchw(
    data: torch.Tensor,
    conf: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    eps: float = 1e-20,
    impl: str = "xla",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized convolution on (B, Cin, H, W) with an OIHW weight that
    is already non-negative; returns ``(out, conf_out)``.

    On a band of rows (``parallel/halo.py``) data and confidence are
    extended by k//2 rows of each neighbour in one exchange (zeros at the
    image's edges: SAME padding's zero data and zero confidence), the op
    runs on the extended band and its own rows are kept: the fused op
    keeps them itself (``rows``), so the rows it drops take no part in its
    backward."""
    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown nconv impl: {impl!r}")
    op = nconv2d_fused if impl == "pallas" else nconv2d_plain
    p = weight.shape[-1] // 2
    if halo.current() is None or p == 0:
        return op(data, conf, weight, bias, eps)
    cin, rows = data.shape[1], data.shape[2]
    both = halo.extend(torch.cat([data, conf], dim=1), p, p)
    d, c = both[:, :cin].contiguous(), both[:, cin:].contiguous()
    if impl == "pallas":
        return nconv2d_fused(d, c, weight, bias, eps, rows=(p, rows))
    out, conf_out = op(d, c, weight, bias, eps)
    return out[:, :, p:p + rows].contiguous(), conf_out[:, :, p:p + rows].contiguous()


def nconv2d(
    data: torch.Tensor,
    conf: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    eps: float = 1e-20,
    impl: str = "xla",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized convolution in the JAX layouts: data, conf (B, H, W, Cin)
    NHWC; weight (k, k, Cin, Cout) HWIO, already non-negative; bias
    (Cout,) or None. Returns ``(out, conf_out)``, both (B, H, W, Cout)."""
    out, conf_out = nconv2d_nchw(
        data.permute(0, 3, 1, 2).contiguous(),
        conf.permute(0, 3, 1, 2).contiguous(),
        weight.permute(3, 2, 0, 1).contiguous(),
        bias,
        eps=eps,
        impl=impl,
    )
    return out.permute(0, 2, 3, 1), conf_out.permute(0, 2, 3, 1)


def downsample_data_conf_nchw(
    data: torch.Tensor, conf: torch.Tensor, pooling_type: str = "conf_based"
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`downsample_data_conf` on (B, C, H, W)."""
    B, C, H, W = conf.shape
    if halo.current() is not None and H % 2:
        raise ValueError(f"a band of {H} rows does not pool 2x2 alone: pad the height to "
                         "a multiple of 8 times the spatial size")

    def blocks(x):  # (B, C, H/2, W/2, 4), window in row-major order
        x = x.reshape(B, C, H // 2, 2, W // 2, 2).permute(0, 1, 2, 4, 3, 5)
        return x.reshape(B, C, H // 2, W // 2, 4)

    cb = blocks(conf)
    conf_ds = cb.amax(dim=-1) / 4.0
    if pooling_type == "conf_based":
        idx = cb.argmax(dim=-1, keepdim=True)
        data_ds = torch.gather(blocks(data), -1, idx)[..., 0]
    elif pooling_type == "max_pooling":
        data_ds = blocks(data).amax(dim=-1)
    else:
        raise ValueError(f"unknown pooling_type: {pooling_type!r}")
    return data_ds, conf_ds


def downsample_data_conf(
    data: torch.Tensor, conf: torch.Tensor, pooling_type: str = "conf_based"
) -> tuple[torch.Tensor, torch.Tensor]:
    """2x2 stride-2 confidence-aware downsampling of (B, H, W, C): max-pool
    the confidence and gather data at its argmax ('conf_based') or
    max-pool the data ('max_pooling'); the pooled confidence is divided
    by 4."""
    d, c = downsample_data_conf_nchw(
        data.permute(0, 3, 1, 2), conf.permute(0, 3, 1, 2), pooling_type
    )
    return d.permute(0, 2, 3, 1), c.permute(0, 2, 3, 1)


def zero_stuff_upsample_nchw(
    x: torch.Tensor, scale_h: int, scale_w: int
) -> torch.Tensor:
    """:func:`zero_stuff_upsample` on (B, C, H, W)."""
    B, C, H, W = x.shape
    out = x.new_zeros((B, C, H * scale_h, W * scale_w))
    out[:, :, scale_h // 2:: scale_h, scale_w // 2:: scale_w] = x
    return out


def zero_stuff_upsample(
    x: torch.Tensor, scale_h: int, scale_w: int
) -> torch.Tensor:
    """Scatter (B, H, W, C) samples into a zeroed high-res grid at stride
    centers: ``out[:, sH//2::sH, sW//2::sW] = x``."""
    return zero_stuff_upsample_nchw(
        x.permute(0, 3, 1, 2), scale_h, scale_w
    ).permute(0, 2, 3, 1)
