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

On a band of rows (a :func:`halo.spatial` context, ``parallel/halo.py``)
each op computes the band's rows of the whole image's result, as JAX's
partitioner does with the mesh's ``spatial`` axis:

- a window op that keeps the height (the patches, the adapting kernel,
  the PAC convolution and pooling, the smoothed centre) takes its rows of
  padding from the neighbouring bands (:func:`halo.extend`; zero rows only
  at the image's global top and bottom); a stride subsamples from the
  band's first row, which the stride divides;
- the transposed convolution exchanges the input rows its band's output
  rows read (one low-resolution row each side for the heads' k=5,
  stride-2 stage) and zero-stuffs them from a global row the stride
  divides, so the stuffing's parity is the whole image's;
- the half-pixel resize takes its weights from global row indices
  (``halo.resize_rows``) with the one input row of halo above and below
  that an upsampling or a halving resize reads.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from raft_ncup_tpu_torch.parallel import halo


def _pad_nhwc(x: torch.Tensor, lo: tuple[int, int], hi: tuple[int, int]) -> torch.Tensor:
    """Zero padding of (B, H, W, C) rows by ``(lo[0], hi[0])`` and columns
    by ``(lo[1], hi[1])``; a negative amount crops."""
    return F.pad(x, (0, 0, lo[1], hi[1], lo[0], hi[0]))


def _band_rows(x: torch.Tensor, span: int, pad_lo: tuple[int, int],
               pad_hi: tuple[int, int]) -> tuple:
    """The rows of padding of a window op over ``span + 1`` rows: on a band
    of rows, the neighbouring bands' rows (zeros past the image's edges) in
    place of the zeros, and no row padding left to add; else ``x`` and the
    paddings as they are. On a band the op must keep the height (a stride
    subsamples after), or its output would not be the band's rows."""
    if halo.current() is None or (pad_lo[0] == 0 and pad_hi[0] == 0):
        return x, pad_lo, pad_hi
    if pad_lo[0] + pad_hi[0] != span:
        raise ValueError(f"a window of {span + 1} rows padded ({pad_lo[0]}, {pad_hi[0]}) "
                         "changes the height: it cannot run on a band of rows")
    x = halo.extend(x, pad_lo[0], pad_hi[0], dim=1)
    return x, (0, pad_lo[1]), (0, pad_hi[1])


def _strided_band(x: torch.Tensor, stride: int) -> None:
    """A stride on a band subsamples from the band's first row: the whole
    image's rows only where the stride divides the band's height."""
    if stride > 1 and halo.current() is not None and x.shape[1] % stride:
        raise ValueError(f"a band of {x.shape[1]} rows does not split at stride {stride}")


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
    x, pad_lo, pad_hi = _band_rows(x, span, pad_lo, pad_hi)
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
    guide, lo, hi = _band_rows(guide, sh - 1, (sp_h, sp_w), (sp_h, sp_w))
    g = _pad_nhwc(guide, lo, hi).to(smooth_kernel.dtype)
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
    _strided_band(guide, stride)
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
    _strided_band(x, stride)
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
    ksize = int(round(weight.shape[0] ** 0.5))
    pad = (ksize - 1) * dilation - padding
    stuffed, rows = stuffed_rows(x, stride, ksize, dilation, padding, output_padding)
    return pacconv2d(stuffed, kernel, weight, bias, dilation, pad_lo=(rows[0], pad),
                     pad_hi=(rows[1], pad + output_padding))


def transpose_band_rows(rows: int, stride: int, ksize: int, dilation: int, padding: int,
                        output_padding: int) -> tuple[int, int, int, int]:
    """``(top, bottom, lo, hi)`` of a transposed convolution on a band of
    ``rows`` input rows whose output rows are the band's ``stride * rows``:
    the input rows of halo it reads above and below, and the zero rows (a
    negative count crops) the zero-stuffed, halo-extended band takes above
    and below before the stride-1 window. Output row ``o`` reads stuffed row
    ``o - p + j * dilation`` (``p = (k-1) d - padding``, ``j < k``), which
    is input row ``r / stride`` where the stride divides ``r``. The same on
    every band: the band's first row drops out."""
    s, span = int(stride), (int(ksize) - 1) * int(dilation)
    p = span - int(padding)
    whole_rows = (rows - 1) * s + 1 + 2 * p + int(output_padding) - span
    if whole_rows != s * rows:
        raise ValueError(f"a transposed convolution that makes {whole_rows} rows of {rows} "
                         f"at stride {s} cannot run on a band of rows")
    # The stuffed rows the band's outputs read, counted from stuffed row
    # s * first (the band's first input row): [-p, s rows - 1 - p + span].
    lo_r, hi_r = -p, s * rows - 1 - p + span
    top = (-lo_r) // s  # the input rows (stuffed rows the stride divides) among them
    bottom = hi_r // s - (rows - 1)
    return top, bottom, -s * top - lo_r, hi_r - s * (rows - 1 + bottom)


def stuffed_rows(x: torch.Tensor, stride: int, ksize: int, dilation: int, padding: int,
                 output_padding: int) -> tuple:
    """``x`` (B, H, W, C) zero-stuffed by ``stride`` and the rows of zero
    padding the stride-1 window of a transposed convolution adds to it,
    ``(stuffed, (lo, hi))``. On a band of rows the band first takes the
    input rows of halo its output reads (:func:`transpose_band_rows`), is
    stuffed from there, and is padded (or cropped) by the rows that
    function gives."""
    span = (int(ksize) - 1) * int(dilation)
    pad = span - int(padding)
    if halo.current() is None:
        return _zero_stuff(x, stride), (pad, pad + int(output_padding))
    top, bottom, lo, hi = transpose_band_rows(x.shape[1], stride, ksize, dilation, padding,
                                              output_padding)
    wide = _zero_stuff(halo.extend(x, top, bottom, dim=1), stride)
    return _pad_nhwc(wide, (lo, 0), (hi, 0)), (0, 0)


def stuffed_mask(x: torch.Tensor, stride: int, ksize: int, dilation: int, padding: int,
                 output_padding: int) -> tuple:
    """The indicator of the real (not stuffed) samples of ``x`` (B, H, W, C)
    zero-stuffed by ``stride``, shaped and padded as :func:`stuffed_rows`
    gives ``x``: ``(mask (1, H', W', 1), (lo, hi))``. On a band the rows
    with their halo, 1 on the image's rows and 0 past its edges (known
    without an exchange)."""
    sp = halo.current()
    if sp is None:
        pad = (int(ksize) - 1) * int(dilation) - int(padding)
        return (zero_stuff_mask(x.shape[1:3], stride, x.dtype, x.device),
                (pad, pad + int(output_padding)))
    H, W = x.shape[1:3]
    top, bottom, lo, hi = transpose_band_rows(H, stride, ksize, dilation, padding,
                                              output_padding)
    rows = torch.arange(top + H + bottom, device=x.device) + (halo.first_row(H) - top)
    real = ((rows >= 0) & (rows < H * sp.size)).to(x.dtype)
    ones = real[None, :, None, None].expand(1, -1, W, 1)
    return _pad_nhwc(_zero_stuff(ones, stride), (lo, 0), (hi, 0)), (0, 0)


def pacpool2d(x: torch.Tensor, kernel: torch.Tensor, ksize: int, dilation: int = 1,
              stride: int = 1, padding: Optional[int] = None) -> torch.Tensor:
    """Kernel-weighted window sum per channel (reference:
    core/pac_modules.py:475-494). ``kernel`` is (B, H', W', k*k), shared by
    the channels, or (B, H', W', k*k, C); ``padding=None`` is the 'same'
    default."""
    pad = None if padding is None else (padding, padding)
    _strided_band(x, stride)
    patches = extract_patches(x, ksize, dilation, pad, pad)[:, ::stride, ::stride]
    if kernel.dim() == 5:
        return torch.einsum("bhwkc,bhwkc->bhwc", patches, kernel)
    return torch.einsum("bhwkc,bhwk->bhwc", patches, kernel)


def _resize_weights(in_size: int, out_size: int, device, in_first: int = 0,
                    in_count: Optional[int] = None, out_first: int = 0,
                    out_count: Optional[int] = None) -> torch.Tensor:
    """(in, out) weights of ``jax.image.resize``'s 'bilinear' along one
    axis: half-pixel centres and a triangle kernel widened by the
    downsampling factor (JAX's default antialiasing), each column
    normalised, columns whose sample falls outside the input zeroed.
    Computed in float32 as JAX computes them, on ``device`` (nothing is
    copied from the host, so a CUDA graph can hold it). The block of input
    rows ``[in_first, in_first + in_count)`` and output rows ``[out_first,
    out_first + out_count)`` of the whole matrix (all of it by default), the
    input rows past the axis's ends weighing 0: a band's block, each element
    computed as the whole matrix computes it, each column normalised over
    the block, which holds every row the column reads."""
    f32 = torch.float32
    in_count = in_size if in_count is None else int(in_count)
    out_count = out_size if out_count is None else int(out_count)
    inv_scale = torch.full((), out_size / in_size, dtype=f32, device=device).reciprocal()
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(out_first, out_first + out_count, dtype=f32, device=device)
                + 0.5) * inv_scale - 0.5
    rows = torch.arange(in_first, in_first + in_count, dtype=f32, device=device)
    x = (sample_f[None, :] - rows[:, None]).abs() / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    if in_first < 0 or in_first + in_count > in_size:
        w = torch.where(((rows >= 0) & (rows < in_size))[:, None], w, torch.zeros_like(w))
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
    it shrinks): the JAX heads' ``_resize_half_pixel``. On a band of rows,
    ``x`` and ``out_hw[0]`` are the band's rows of the whole image's input and
    output: the weights come from global rows, over the band and its halo
    (``halo.resize_rows``)."""
    if halo.current() is None:
        wh = _resize_weights(x.shape[1], int(out_hw[0]), x.device)
    else:
        x, wh = halo.resize_rows(x, int(out_hw[0]), lambda *rows: _resize_weights(
            *rows[:2], x.device, *rows[2:]))
    ww = _resize_weights(x.shape[2], int(out_hw[1]), x.device).to(x.dtype)
    return torch.einsum("bhwc,hi,wj->bijc", x, wh.to(x.dtype), ww)
