"""Fused normalized convolution: the wrapper around the CUDA kernel
``csrc/nconv.cu`` and its plain PyTorch version.

Counterpart of ``raft_ncup_tpu/ops/nconv_pallas.py``'s ``nconv2d_fused``
(Pallas kernel ``_kernel``). The function, on NCHW planes with an OIHW
non-negative weight, stride 1 and SAME zero padding:

    out      = conv(data * conf, w) / (conv(conf, w) + eps) + bias
    conf_out = conv(conf, w) / sum(w)   (per output channel)

:func:`nconv2d_fused` is the wrapper. For a CPU tensor it runs the plain
version, :func:`nconv2d_plain` (the two-convolution composition of the
JAX package's ``ops/nconv.py``); for a CUDA tensor it launches the kernel
or raises. ``nconv2d_fused.launches`` counts the launches. Forward only in
this slice: a CUDA call whose inputs require grad raises. The kernel has
no size gate; it takes odd k <= 7 and at most 8 output channels, which
covers every NCUP layer.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from raft_ncup_tpu_torch.ops import cuda_build
from raft_ncup_tpu_torch.utils.device import f32_precision

KERNEL = "nconv"
SOURCE = "raft_ncup_tpu_torch/csrc/nconv.cu"
KERNEL_SIZES = (1, 3, 5, 7)
MAX_COUT = 8
MAX_WEIGHTS = 4096


@f32_precision()
def nconv2d_plain(
    data: torch.Tensor,
    conf: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    eps: float = 1e-20,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: two convolutions (TF32 off), a divide
    and a scale. data, conf: (B, Cin, H, W); weight: (Cout, Cin, k, k)."""
    pad = weight.shape[-1] // 2
    denom = F.conv2d(conf, weight, padding=pad)
    nomin = F.conv2d(data * conf, weight, padding=pad)
    out = nomin / (denom + eps)
    if bias is not None:
        out = out + bias.view(1, -1, 1, 1)
    s = weight.sum(dim=(1, 2, 3))
    return out, denom / s.view(1, -1, 1, 1)


_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = cuda_build.load(KERNEL)
        fn = lib.nconv_f32
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p,
        ]
        _fn = (lib, fn)
    return _fn


def _check_operands(data, conf, weight, bias) -> None:
    tensors = [data, conf, weight] + ([] if bias is None else [bias])
    for t in tensors:
        if t.device != data.device:
            raise ValueError(f"nconv: tensors on {t.device} and {data.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"nconv: f32 only in this slice, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("nconv: operands must be contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                "nconv kernel is forward-only in this slice; its backward "
                "lands with the training slice"
            )
    if data.dim() != 4 or conf.shape != data.shape:
        raise ValueError(
            f"nconv: data {tuple(data.shape)} / conf {tuple(conf.shape)} "
            "are not one (B, Cin, H, W) shape"
        )
    cout, cin, kh, kw = weight.shape
    if (
        cin != data.shape[1] or kh != kw or kh not in KERNEL_SIZES
        or cout > MAX_COUT or cout * cin * kh * kw > MAX_WEIGHTS
    ):
        raise ValueError(
            f"nconv: weight {tuple(weight.shape)} unsupported for data "
            f"{tuple(data.shape)} (odd square k in {KERNEL_SIZES}, "
            f"Cout <= {MAX_COUT})"
        )
    if bias is not None and bias.shape != (cout,):
        raise ValueError(f"nconv: bias {tuple(bias.shape)} is not ({cout},)")


def nconv2d_fused(
    data: torch.Tensor,
    conf: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    eps: float = 1e-20,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's wrapper: (B, Cin, H, W) data and conf, (Cout, Cin, k, k)
    weight -> ``(out, conf_out)``, each (B, Cout, H, W) f32.

    A CPU tensor takes :func:`nconv2d_plain`; a CUDA tensor launches the
    kernel on the current stream or raises."""
    if data.device.type == "cpu":
        return nconv2d_plain(data, conf, weight, bias, eps)
    if data.device.type != "cuda":
        raise ValueError(f"nconv: unsupported device {data.device}")
    _check_operands(data, conf, weight, bias)
    lib, fn = _launcher()
    B, cin, H, W = data.shape
    cout, _, k, _ = weight.shape
    out = torch.empty((B, cout, H, W), dtype=torch.float32, device=data.device)
    conf_out = torch.empty_like(out)
    rc = fn(
        data.data_ptr(), conf.data_ptr(), weight.data_ptr(),
        None if bias is None else bias.data_ptr(),
        out.data_ptr(), conf_out.data_ptr(), B, cin, cout, H, W, k, eps,
        data.device.index, torch.cuda.current_stream(data.device).cuda_stream,
    )
    cuda_build.check(rc, lib, "nconv_f32")
    nconv2d_fused.launches += 1
    return out, conf_out


nconv2d_fused.launches = 0
