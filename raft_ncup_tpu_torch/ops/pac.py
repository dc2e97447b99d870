"""Pixel-adaptive convolution (PAC) primitives (port of
``raft_ncup_tpu/ops/pac.py``), channel-last, in plain PyTorch.

The reference carries NVIDIA's PAC suite with hand-written autograd
Functions (reference: core/pac_modules.py:90-329); the JAX package
computes the same functions as einsums that autodiff differentiates, and
so does the port (autograd, no ``torch.autograd.Function``):

- patches are (B, H, W, k*k, C) stacks of dilated shifted slices, tap
  ``i * k + j`` reading row offset ``i`` and column offset ``j``;
- the adapting kernel is a Gaussian (or the 'inv' kernel) on
  guidance-feature differences from the window centre;
- the transposed convolution zero-stuffs by the stride, pads
  asymmetrically and runs the stride-1 PAC convolution with the weight
  ``(k*k, Cin, Cout)``.

JAX runs these with XLA, not Pallas: there is no TPU kernel here, and the
port has no CUDA kernel for them either.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _pad_nhwc(x: torch.Tensor, lo: tuple[int, int], hi: tuple[int, int]) -> torch.Tensor:
    """Zero padding of (B, H, W, C) rows by ``(lo[0], hi[0])`` and columns
    by ``(lo[1], hi[1])``; a negative amount crops."""
    return F.pad(x, (0, 0, lo[1], hi[1], lo[0], hi[0]))


def extract_patches(
    x: torch.Tensor,
    ksize: int,
    dilation: int = 1,
    pad_lo: Optional[tuple[int, int]] = None,
    pad_hi: Optional[tuple[int, int]] = None,
) -> torch.Tensor:
    """Stride-1 sliding windows: (B, H, W, C) -> (B, H', W', k*k, C).
    ``pad_lo``/``pad_hi`` are per-dim (top/left, bottom/right) paddings; the
    default is the 'same' padding (k-1)*d // 2 before and the rest after."""
    span = (ksize - 1) * dilation
    if pad_lo is None:
        pad_lo = (span // 2, span // 2)
    if pad_hi is None:
        pad_hi = (span - span // 2, span - span // 2)
    x = _pad_nhwc(x, pad_lo, pad_hi)
    h_out = x.shape[1] - span
    w_out = x.shape[2] - span
    rows = [x[:, i * dilation: i * dilation + h_out, j * dilation: j * dilation + w_out, :]
            for i in range(ksize) for j in range(ksize)]
    return torch.stack(rows, dim=3)


def pac_gaussian_kernel(guide: torch.Tensor, ksize: int, dilation: int = 1,
                        channel_wise: bool = False) -> torch.Tensor:
    """K = exp(-0.5 ||g_i - g_centre||^2) over each window (reference:
    core/pac_modules.py:377-404): (B, H, W, k*k), or (B, H, W, k*k, C)
    with ``channel_wise``."""
    patches = extract_patches(guide, ksize, dilation)
    d2 = (patches - guide[:, :, :, None, :]) ** 2
    if not channel_wise:
        d2 = d2.sum(dim=-1)
    return torch.exp(-0.5 * d2)


def smooth_kernel_2d(kind: str, device=None) -> torch.Tensor:
    """The fixed smoothing kernels of ``smooth_kernel_type`` (reference:
    core/pac_modules.py:566-580): 'gaussian' is the separable [.25, .5, .25]
    stencil, 'average_{sz}' a box filter."""
    if kind == "gaussian":
        # Filled on the device, never copied from the host (a CUDA graph
        # capture refuses a copy from pageable memory).
        s1 = torch.full((3,), 0.25, dtype=torch.float32, device=device)
        s1[1] = 0.5
    elif kind.startswith("average_"):
        sz = int(kind.split("_")[-1])
        s1 = torch.full((sz,), 1.0 / sz, dtype=torch.float32, device=device)
    else:
        raise ValueError(f"unknown fixed smooth kernel {kind!r}")
    return s1[:, None] * s1[None, :]


def _smoothed_center(guide: torch.Tensor, smooth_kernel: torch.Tensor, ksize: int,
                     stride: int, pad: tuple[int, int]) -> torch.Tensor:
    """The window-centre feature as a smoothed (depthwise-filtered) guide
    (reference: core/pac_modules.py:380-387): the guide filtered by the
    small kernel at padding ``pad - (ksize - smooth_sz) // 2`` (a crop when
    negative), so each output aligns with its window's centre."""
    sh, sw = smooth_kernel.shape
    sp_h = pad[0] - (ksize - sh) // 2
    sp_w = pad[1] - (ksize - sw) // 2
    g = _pad_nhwc(guide, (sp_h, sp_w), (sp_h, sp_w)).to(smooth_kernel.dtype)
    C = g.shape[-1]
    w = smooth_kernel[None, None].expand(C, 1, sh, sw)
    out = F.conv2d(g.permute(0, 3, 1, 2), w, stride=stride, groups=C)
    return out.permute(0, 2, 3, 1)


def pac_kernel2d(
    guide: torch.Tensor,
    ksize: int,
    *,
    stride: int = 1,
    dilation: int = 1,
    padding: int = 0,
    kernel_type: str = "gaussian",
    inv_alpha: Optional[torch.Tensor] = None,
    inv_lambda: Optional[torch.Tensor] = None,
    asym: bool = False,
    smooth_kernel: Optional[torch.Tensor] = None,
    channel_wise: bool = False,
    normalize_kernel: bool = False,
    mask: Optional[torch.Tensor] = None,
    pad_lo: Optional[tuple[int, int]] = None,
    pad_hi: Optional[tuple[int, int]] = None,
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The adapting kernel, the whole ``packernel2d`` surface (reference:
    core/pac_modules.py:332-424), channel-last: ``kernel_type`` 'gaussian'
    (exp(-0.5 d2)) or 'inv' (alpha + (d2 + 1e-4)^(0.5 lambda)), ``asym``
    (relu of the difference), ``smooth_kernel`` (a smoothed centre),
    ``channel_wise`` (per-channel kernels), ``mask`` (B, H, W, 1) validity
    (the kernel masked and, without ``normalize_kernel``, scaled by the
    window's coverage; the output-resolution mask comes back as the second
    element) and ``normalize_kernel`` (divided by the window sum). Returns
    ``(kernel, mask_out)``, ``mask_out`` None without ``mask``.
    ``pad_lo``/``pad_hi`` override the symmetric ``padding``."""
    pad = (padding, padding)
    lo = pad if pad_lo is None else pad_lo
    hi = pad if pad_hi is None else pad_hi
    patches = extract_patches(guide, ksize, dilation, lo, hi)[:, ::stride, ::stride]
    if smooth_kernel is None:
        center = patches[:, :, :, (ksize * ksize) // 2, :]
    else:
        center = _smoothed_center(guide, smooth_kernel, ksize, stride, lo)
    diff = patches - center[:, :, :, None, :]
    if asym:
        diff = torch.relu(diff)
    d2 = diff * diff
    if not channel_wise:
        d2 = d2.sum(dim=-1)

    if kernel_type == "gaussian":
        kernel = torch.exp(-0.5 * d2)
    elif kernel_type == "inv":
        shape = (1, 1, 1, 1, -1) if channel_wise else (1, 1, 1, -1)
        a = torch.as_tensor(inv_alpha, dtype=d2.dtype, device=d2.device).reshape(shape)
        lam = torch.as_tensor(inv_lambda, dtype=d2.dtype, device=d2.device).reshape(shape)
        if not channel_wise:
            d2 = d2[..., None]
        kernel = a + torch.pow(d2 + 1e-4, 0.5 * lam)
        if not channel_wise and kernel.shape[-1] == 1:
            kernel = kernel[..., 0]
    else:
        raise ValueError(f"unknown kernel_type {kernel_type!r}")

    per_channel = kernel.dim() == 5
    norm = None
    mask_out = None
    if mask is not None or normalize_kernel:
        # Taps on the zero padding do not count (reference mask_pattern,
        # core/pac_modules.py:353-356).
        ones = extract_patches(guide.new_ones((*guide.shape[:3], 1)), ksize, dilation, lo,
                               hi)[:, ::stride, ::stride, :, 0]
    if mask is not None:
        mask = mask.to(guide.dtype)
        mpat = extract_patches(mask, ksize, dilation, lo, hi)[:, ::stride, ::stride, :, 0]
        if not normalize_kernel:
            norm = mpat.sum(dim=3, keepdim=True) / ones.sum(dim=3, keepdim=True)
            if per_channel:
                norm = norm[..., None]
    else:
        mpat = ones if normalize_kernel else None
    if mpat is not None:
        kernel = kernel * (mpat[..., None] if per_channel else mpat)
    if normalize_kernel:
        norm = kernel.sum(dim=3, keepdim=True)
    if norm is not None:
        empty = (norm == 0).to(kernel.dtype)
        kernel = kernel / (norm + empty)
        if mask is not None:
            mask_out = 1.0 - empty.reshape(kernel.shape[0], *kernel.shape[1:3], -1)[..., :1]
    return kernel, mask_out


def zero_stuff_mask(shape_hw: tuple[int, int], stride: int, dtype=torch.float32,
                    device=None) -> torch.Tensor:
    """(1, (H-1)*s+1, (W-1)*s+1, 1) indicator of the real (not stuffed)
    positions of an (H, W) input zero-stuffed by ``stride``."""
    h, w = shape_hw
    m = torch.zeros((1, (h - 1) * stride + 1, (w - 1) * stride + 1, 1), dtype=dtype,
                    device=device)
    m[:, ::stride, ::stride, :] = 1.0
    return m


def _zero_stuff(x: torch.Tensor, stride: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, (H-1)*s+1, (W-1)*s+1, C) with ``x`` at the stride
    positions (the transposed convolution's expansion)."""
    if stride == 1:
        return x
    B, H, W, C = x.shape
    out = x.new_zeros((B, (H - 1) * stride + 1, (W - 1) * stride + 1, C))
    out[:, ::stride, ::stride, :] = x
    return out


def _pac_contract(patches, kernel, weight, bias, shared_filters=False):
    if shared_filters:
        out = torch.einsum("bhwkc,bhwk,k->bhwc", patches, kernel, weight.reshape(-1))
    else:
        out = torch.einsum("bhwkc,bhwk,kco->bhwo", patches, kernel, weight)
    if bias is not None:
        out = out + bias
    return out


def pacconv2d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    dilation: int = 1,
    pad_lo: Optional[tuple[int, int]] = None,
    pad_hi: Optional[tuple[int, int]] = None,
    stride: int = 1,
    shared_filters: bool = False,
) -> torch.Tensor:
    """PAC convolution (reference: core/pac_modules.py:427-449): ``x`` (B,
    H, W, Cin), ``kernel`` (B, H', W', k*k) from :func:`pac_kernel2d`,
    ``weight`` (k*k, Cin, Cout), or (k*k,) with ``shared_filters`` (one
    spatial filter for every channel)."""
    ksize = int(round(weight.shape[0] ** 0.5))
    patches = extract_patches(x, ksize, dilation, pad_lo, pad_hi)[:, ::stride, ::stride]
    return _pac_contract(patches, kernel, weight, bias, shared_filters)


def pacconv_transpose2d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 2,
    padding: int = 0,
    output_padding: int = 0,
    dilation: int = 1,
) -> torch.Tensor:
    """Transposed PAC convolution (reference: core/pac_modules.py:462-467):
    zero-stuff by ``stride``, pad (k-1)*d - p (plus ``output_padding`` at
    the bottom and right), then the stride-1 PAC convolution. ``kernel`` is
    computed from guidance at the output resolution; ``weight`` is (k*k,
    Cin, Cout)."""
    stuffed = _zero_stuff(x, stride)
    ksize = int(round(weight.shape[0] ** 0.5))
    pad = (ksize - 1) * dilation - padding
    return pacconv2d(stuffed, kernel, weight, bias, dilation, pad_lo=(pad, pad),
                     pad_hi=(pad + output_padding, pad + output_padding))


def pacpool2d(x: torch.Tensor, kernel: torch.Tensor, ksize: int, dilation: int = 1,
              stride: int = 1, padding: Optional[int] = None) -> torch.Tensor:
    """Kernel-weighted window sum per channel (reference:
    core/pac_modules.py:475-494). ``kernel`` is (B, H', W', k*k), shared by
    the channels, or (B, H', W', k*k, C); ``padding=None`` is the 'same'
    default."""
    pad = None if padding is None else (padding, padding)
    patches = extract_patches(x, ksize, dilation, pad, pad)[:, ::stride, ::stride]
    if kernel.dim() == 5:
        return torch.einsum("bhwkc,bhwkc->bhwc", patches, kernel)
    return torch.einsum("bhwkc,bhwk->bhwc", patches, kernel)


def _resize_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """(in, out) weights of ``jax.image.resize``'s 'bilinear' along one
    axis: half-pixel centres and a triangle kernel widened by the
    downsampling factor (JAX's default antialiasing), each column
    normalised, columns whose sample falls outside the input zeroed.
    Computed in float32 as JAX computes them, on ``device`` (nothing is
    copied from the host, so a CUDA graph can hold it)."""
    f32 = torch.float32
    inv_scale = torch.full((), out_size / in_size, dtype=f32, device=device).reciprocal()
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(out_size, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32, device=device)[:, None]
         ).abs() / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = float(torch.finfo(f32).eps)
    w = torch.where(total.abs() > 1000.0 * eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_half_pixel(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (B, H, W, C) to ``out_hw`` with half-pixel centres,
    as ``jax.image.resize(method="bilinear")`` computes it (antialiased when
    it shrinks): the JAX heads' ``_resize_half_pixel``."""
    wh = _resize_weights(x.shape[1], int(out_hw[0]), x.device).to(x.dtype)
    ww = _resize_weights(x.shape[2], int(out_hw[1]), x.device).to(x.dtype)
    return torch.einsum("bhwc,hi,wj->bijc", x, wh, ww)
