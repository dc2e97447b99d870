"""Geometry and sampling ops (port of ``raft_ncup_tpu/ops/geometry.py``).

Public functions take and return NHWC tensors and ``(B, ..., 2)``
coordinates with x first, like the JAX package. The sampling semantics
are PyTorch's ``grid_sample(align_corners=True, padding='zeros')`` after
the pixel round trip the reference uses: each of the four corner taps
contributes 0 iff that tap is out of bounds.

Under the spatial axis (``parallel/halo.py``) the convex upsampler reads
one halo row of the low-res flow from each neighbour; the resizes with
aligned corners are not local in rows and run on the whole tensor, which
their callers gather (``halo.on_whole``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from raft_ncup_tpu_torch.parallel import halo


def coords_grid(
    batch: int, ht: int, wd: int, device=None, dtype=torch.float32, y0: int = 0
) -> torch.Tensor:
    """Pixel-coordinate grid (B, H, W, 2) with [..., 0] = x, [..., 1] = y,
    its rows starting at ``y0`` (a band's global first row)."""
    y, x = torch.meshgrid(
        torch.arange(y0, y0 + ht, device=device, dtype=dtype),
        torch.arange(wd, device=device, dtype=dtype),
        indexing="ij",
    )
    grid = torch.stack([x, y], dim=-1)
    return grid[None].expand(batch, ht, wd, 2)


def grid_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling at pixel coordinates with zero padding.

    Args:
      img:    (B, H, W, C)
      coords: (B, ..., 2) pixel coordinates; [..., 0] = x, [..., 1] = y.
    Returns:
      (B, ..., C) sampled values.
    """
    B, H, W, C = img.shape
    x = coords[..., 0]
    y = coords[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = x - x0
    dy = y - y0

    flat_img = img.reshape(B, H * W, C)
    batch_shape = x.shape  # (B, ...)
    out = torch.zeros(batch_shape + (C,), dtype=img.dtype, device=img.device)
    if H * W == 0:
        # An empty pyramid level (a small image pooled past 1x1): every
        # tap is out of bounds.
        return out
    taps = (
        (x0, y0, (1.0 - dx) * (1.0 - dy)),
        (x0 + 1.0, y0, dx * (1.0 - dy)),
        (x0, y0 + 1.0, (1.0 - dx) * dy),
        (x0 + 1.0, y0 + 1.0, dx * dy),
    )
    for tx, ty, w in taps:
        valid = (tx >= 0) & (tx <= W - 1) & (ty >= 0) & (ty <= H - 1)
        # A NaN coordinate (a corrupt frame's row) is invalid; its index is
        # clamped into the image like any other, as JAX's gather clamps.
        xi = tx.clamp(0, W - 1).nan_to_num(0.0).long()
        yi = ty.clamp(0, H - 1).nan_to_num(0.0).long()
        flat_idx = (yi * W + xi).reshape(B, -1, 1).expand(-1, -1, C)
        v = torch.gather(flat_img, 1, flat_idx).reshape(batch_shape + (C,))
        out = out + torch.where(valid, w, torch.zeros_like(w))[..., None] * v
    return out


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour integer upsampling of (B, H, W, C):
    out[i] = in[i // factor]."""
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)


def adaptive_area_resize_nchw(
    x: torch.Tensor, out_hw: tuple[int, int]
) -> torch.Tensor:
    """:func:`adaptive_area_resize` on (B, C, H, W)."""
    B, C, H, W = x.shape
    oh, ow = out_hw
    if oh == H and ow == W:
        return x
    if oh >= H and ow >= W:
        if oh % H == 0 and ow % W == 0:
            return x.repeat_interleave(oh // H, dim=2).repeat_interleave(
                ow // W, dim=3
            )
        raise NotImplementedError("area upsample only for integer factors")
    if H % oh == 0 and W % ow == 0:
        fh, fw = H // oh, W // ow
        return x.reshape(B, C, oh, fh, ow, fw).mean(dim=(3, 5))
    raise NotImplementedError("area resize only for integer ratios")


def adaptive_area_resize(
    x: torch.Tensor, out_hw: tuple[int, int]
) -> torch.Tensor:
    """``F.interpolate(mode='area')`` for integer size ratios, on
    (B, H, W, C)."""
    return adaptive_area_resize_nchw(
        x.permute(0, 3, 1, 2), out_hw
    ).permute(0, 2, 3, 1)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pooling, VALID (an odd trailing row or column
    is dropped), on (B, H, W, C). The mean is taken in f32 (float64 for a
    float64 input) and rounded once to the input's dtype."""
    B, H, W, C = x.shape
    h2, w2 = H // 2, W // 2
    x = x[:, : h2 * 2, : w2 * 2, :].reshape(B, h2, 2, w2, 2, C)
    wide = torch.promote_types(x.dtype, torch.float32)
    return x.to(wide).mean(dim=(2, 4)).to(x.dtype)


def bilinear_resize_align_corners_nchw(
    x: torch.Tensor, out_hw: tuple[int, int]
) -> torch.Tensor:
    """:func:`bilinear_resize_align_corners` on (B, C, H, W)."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=True)


def bilinear_resize_align_corners(
    x: torch.Tensor, out_hw: tuple[int, int]
) -> torch.Tensor:
    """Bilinear resize of (B, H, W, C) with ``align_corners=True``: the
    corner pixels of input and output coincide, so output pixel i reads
    input position i * (H - 1) / (H_out - 1) (0 for a 1-pixel output)."""
    return bilinear_resize_align_corners_nchw(
        x.permute(0, 3, 1, 2), out_hw
    ).permute(0, 2, 3, 1)


def upflow(flow: torch.Tensor, factor: int = 8, align_corners: bool = True) -> torch.Tensor:
    """Bilinear flow upsampling of (B, H, W, 2): resize x ``factor`` and
    scale the values by ``factor``. ``align_corners=False`` samples at
    half-pixel centres, clamped at the borders."""
    B, H, W, _ = flow.shape
    up = F.interpolate(
        flow.permute(0, 3, 1, 2), size=(H * factor, W * factor),
        mode="bilinear", align_corners=align_corners,
    )
    return factor * up.permute(0, 2, 3, 1)


def extract_3x3_patches(x: torch.Tensor) -> torch.Tensor:
    """3x3 patches with zero padding 1 in the tap order of
    ``F.unfold(x, [3, 3], padding=1)``: tap k = ky * 3 + kx reads input
    pixel (h - 1 + ky, w - 1 + kx). (B, H, W, C) -> (B, H, W, 9, C)."""
    B, H, W, C = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.stack(
        [xp[:, ky : ky + H, kx : kx + W, :] for ky in range(3) for kx in range(3)],
        dim=3,
    )


def convex_upsample_nchw(
    flow: torch.Tensor, mask: torch.Tensor, factor: int = 8
) -> torch.Tensor:
    """:func:`convex_upsample` on (B, 2, H, W) flow and (B, 9 f f, H, W)
    mask logits, returning (B, 2, f H, f W)."""
    B, C, H, W = flow.shape
    f = factor
    m = torch.softmax(mask.reshape(B, 1, 9, f, f, H, W), dim=2)
    if halo.current() is not None:
        # A band of rows: one halo row of the neighbours above and below.
        patches = F.unfold(f * halo.extend(flow, 1, 1), [3, 3], padding=(0, 1))
    else:
        patches = F.unfold(f * flow, [3, 3], padding=1)
    patches = patches.reshape(B, C, 9, 1, 1, H, W)
    up = (m * patches).sum(dim=2)  # (B, C, i, j, H, W)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(B, C, H * f, W * f)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """RAFT's learned convex upsampling of (B, H, W, 2) flow with
    (B, H, W, 9 f f) mask logits: each output pixel (h f + i, w f + j) is
    a softmax-weighted mix of the 3x3 neighbourhood of flow pixel (h, w),
    scaled by f. Mask channel c = k f^2 + i f + j, k the tap (row-major),
    the reference's layout, so its checkpoints map weight for weight."""
    return convex_upsample_nchw(
        flow.permute(0, 3, 1, 2), mask.permute(0, 3, 1, 2), factor
    ).permute(0, 2, 3, 1)
