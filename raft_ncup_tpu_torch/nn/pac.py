"""The PAC, DJIF and joint-bilateral upsampler heads (port of
``raft_ncup_tpu/nn/pac.py``), the reference's ablation baselines
(reference: core/pac_upsampler.py:67-251, core/upsampler.py:223-242).

The PAC primitives (``ops/pac.py``) are plain differentiable functions,
channel-last; the heads' plain convolutions are the port's ``Conv2d``
(NCHW), so the heads move between the two layouts around them. A head is
the flagship's final upsampler (``--final_upsampling PacJointUpsampleFull
| DjifOriginal``): ``_PacHead(x_lowres, guidance)`` takes the NCHW flow
after the nearest x2 and the NCHW GRU state as guidance, resizes the
guidance to the output resolution with JAX's half-pixel bilinear
(``ops.pac.resize_half_pixel``) and runs the PAC joint upsampler or DJIF;
channels fold into the batch as the reference's
``convert_to_single_channel`` does. JAX computes these with XLA, so there
is no kernel here.

On a band of rows of a spatial mesh (``parallel/halo.py``) a head computes
the band's rows of the whole image's output, as JAX's partitioner does:
the guidance resizes take their weights from global rows (``ops.pac``'s
banded ``resize_half_pixel``), the PAC primitives exchange the rows their
windows read, and the 'same' convolutions exchange halos as everywhere
else. DJIF's target and guidance branches pad unevenly, ``(2, 2, 2)`` for
``fs=(9, 1, 5)``, so their inner heights differ from the image's: a branch
exchanges its whole receptive field once, runs its convolutions valid in
the rows, zeroes the rows the whole image's zero padding holds, and keeps
the band's rows (:func:`_banded_branch`).

Parameter names follow the JAX modules', so ``utils.jax_weights`` carries
them as ``export_torch_state`` keys them: convolutions ``weight`` (OIHW)
and ``bias``; a PAC layer's ``weight`` as JAX holds it, (k*k, Cin, Cout)
(or (k*k,) for shared filters), with ``bias`` and, for 'inv' kernels and
learnable smoothing, ``inv_alpha``, ``inv_lambda`` and ``smooth_kernel``.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from raft_ncup_tpu_torch.config import UpsamplerConfig
from raft_ncup_tpu_torch.nn.layers import Conv2d
from raft_ncup_tpu_torch.ops.pac import (
    extract_patches,
    pac_kernel2d,
    pacconv2d,
    pacconv_transpose2d,
    pacpool2d,
    resize_half_pixel,
    smooth_kernel_2d,
    stuffed_mask,
)
from raft_ncup_tpu_torch.parallel import halo


def parse_kernel_type(kernel_type: str) -> dict:
    """The reference's kernel-type strings (reference:
    core/pac_modules.py:545-563,672-674): 'gaussian' or
    'inv_{alpha}_{lambda}[_asym][_fixed]'."""
    if kernel_type == "gaussian":
        return dict(base="gaussian", alpha=None, lam=None, asym=False, fixed=False)
    if kernel_type.startswith("inv_"):
        parts = kernel_type.split("_")
        return dict(base="inv", alpha=float(parts[1]), lam=float(parts[2]),
                    asym="asym" in parts[3:], fixed="fixed" in parts[3:])
    raise ValueError(f"kernel_type set to invalid value ({kernel_type})")


def _uniform(gen: torch.Generator, t: torch.Tensor, bound: float) -> None:
    t.copy_((torch.rand(t.shape, generator=gen) * 2 - 1) * bound)


class _PacKernel(nn.Module):
    """The adapting-kernel options shared by the PAC layers: the
    kernel-type string, the smoothing option and their parameters
    (learnable 'inv' alpha and lambda of ``n_channels`` entries, 0 for a
    scalar; a learnable 'full_{sz}' smoothing filter, 1/sz^2 at start)."""

    def __init__(self, kernel_type: str, smooth_kernel_type: str, n_channels: int = 0):
        super().__init__()
        self.kernel_type = kernel_type
        self.smooth_kernel_type = smooth_kernel_type
        kt = self._kt = parse_kernel_type(kernel_type)
        shape = (n_channels,) if n_channels > 0 else ()
        self._inv_shape = shape
        if kt["base"] == "inv" and not kt["fixed"]:
            self.inv_alpha = nn.Parameter(torch.full(shape, kt["alpha"]))
            self.inv_lambda = nn.Parameter(torch.full(shape, kt["lam"]))
        if smooth_kernel_type.startswith("full_"):
            sz = int(smooth_kernel_type.split("_")[-1])
            self.smooth_kernel = nn.Parameter(torch.full((sz, sz), 1.0 / (sz * sz)))

    def _kernel_params(self, device) -> dict:
        kt = self._kt
        kw: dict = dict(kernel_type=kt["base"], asym=kt["asym"])
        if kt["base"] == "inv":
            if kt["fixed"]:
                kw["inv_alpha"] = torch.full(self._inv_shape, kt["alpha"], device=device)
                kw["inv_lambda"] = torch.full(self._inv_shape, kt["lam"], device=device)
            else:
                kw["inv_alpha"], kw["inv_lambda"] = self.inv_alpha, self.inv_lambda
        if self.smooth_kernel_type.startswith("full_"):
            kw["smooth_kernel"] = self.smooth_kernel
        elif self.smooth_kernel_type != "none":
            kw["smooth_kernel"] = smooth_kernel_2d(self.smooth_kernel_type, device)
        return kw


class PacConv2d(_PacKernel):
    """Pixel-adaptive convolution (reference: core/pac_modules.py:662-710):
    ``forward(x, guide, mask=None)`` on (B, H, W, C); returns the output, or
    ``(output, mask_out)`` with a ``mask``."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 0, dilation: int = 1, use_bias: bool = True,
                 kernel_type: str = "gaussian", smooth_kernel_type: str = "none",
                 normalize_kernel: bool = False, shared_filters: bool = False):
        super().__init__(kernel_type, smooth_kernel_type)
        if shared_filters and features != in_ch:
            raise ValueError("shared_filters requires features == in-channels")
        self.in_ch, self.features, self.kernel_size = in_ch, features, kernel_size
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.normalize_kernel, self.shared_filters = normalize_kernel, shared_filters
        k = kernel_size
        wshape = (k * k,) if shared_filters else (k * k, in_ch, features)
        self.weight = nn.Parameter(torch.empty(wshape))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    @torch.no_grad()
    def init_from(self, gen: torch.Generator) -> None:
        # torch's 'uniform' filler: U(-b, b), b = 1/sqrt(in*k*k), times
        # in-channels for shared filters (reference: :586-596).
        bound = 1.0 / math.sqrt(self.in_ch * self.kernel_size ** 2)
        if self.shared_filters:
            bound *= self.in_ch
        _uniform(gen, self.weight, bound)
        if self.bias is not None:
            _uniform(gen, self.bias, bound)

    def forward(self, x, guide, mask=None):
        kernel, mask_out = pac_kernel2d(
            guide, self.kernel_size, stride=self.stride, dilation=self.dilation,
            padding=self.padding, normalize_kernel=self.normalize_kernel, mask=mask,
            **self._kernel_params(guide.device))
        pad = (self.padding, self.padding)
        out = pacconv2d(x, kernel, self.weight, self.bias, self.dilation, pad, pad,
                        stride=self.stride, shared_filters=self.shared_filters)
        return out if mask_out is None else (out, mask_out)


class PacPool2d(_PacKernel):
    """Pixel-adaptive pooling (reference: core/pac_modules.py:765-816): the
    kernel-weighted window sum, with per-channel kernels under
    ``channel_wise``; ``out_channels`` sizes a channel-wise 'inv' kernel's
    alpha and lambda."""

    def __init__(self, kernel_size: int = 3, stride: int = 1, padding: int = 0,
                 dilation: int = 1, kernel_type: str = "gaussian",
                 smooth_kernel_type: str = "none", channel_wise: bool = False,
                 normalize_kernel: bool = False, out_channels: int = -1):
        super().__init__(kernel_type, smooth_kernel_type,
                         out_channels if channel_wise else 0)
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.dilation, self.channel_wise = dilation, channel_wise
        self.normalize_kernel = normalize_kernel

    def forward(self, x, guide, mask=None):
        if self.channel_wise and guide.shape[-1] != x.shape[-1]:
            raise ValueError("input and kernel must have the same number of channels when "
                             "channel_wise=True")
        kernel, mask_out = pac_kernel2d(
            guide, self.kernel_size, stride=self.stride, dilation=self.dilation,
            padding=self.padding, channel_wise=self.channel_wise,
            normalize_kernel=self.normalize_kernel, mask=mask,
            **self._kernel_params(guide.device))
        out = pacpool2d(x, kernel, self.kernel_size, self.dilation, stride=self.stride,
                        padding=self.padding)
        return out if mask_out is None else (out, mask_out)


def _fold_channels(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(B, H, W, C) -> (B*C, H, W, 1); channel c of sample b at b*C + c."""
    B, H, W, C = x.shape
    if C == 1:
        return x, 1
    return x.permute(0, 3, 1, 2).reshape(B * C, H, W, 1), C


def _unfold_channels(x: torch.Tensor, ch: int) -> torch.Tensor:
    if ch == 1:
        return x
    BC, H, W, _ = x.shape
    return x.reshape(BC // ch, ch, H, W).permute(0, 2, 3, 1)


def _repeat_for_channels(x: torch.Tensor, ch: int) -> torch.Tensor:
    """The guidance tiled along the batch to match the folded channels."""
    return x if ch == 1 else torch.repeat_interleave(x, ch, dim=0)


def _conv(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """An NCHW convolution on (B, H, W, C)."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class PacConvTranspose2d(_PacKernel):
    """Guided upsampling convolution (reference: core/pac_modules.py:628-722,
    462-467): ``forward(x_low, guide_high)``, the adapting kernel from the
    output-resolution guidance, the weight (k*k, Cin, Cout)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 5, stride: int = 2,
                 padding: int = 2, output_padding: int = 1, normalize_kernel: bool = False,
                 use_bias: bool = True, identity_init: bool = False,
                 kernel_type: str = "gaussian", smooth_kernel_type: str = "none",
                 filler: str = "uniform"):
        super().__init__(kernel_type, smooth_kernel_type)
        self.in_ch, self.out_ch, self.kernel_size = in_ch, out_ch, kernel_size
        self.stride, self.padding, self.output_padding = stride, padding, output_padding
        self.normalize_kernel, self.identity_init, self.filler = (normalize_kernel,
                                                                  identity_init, filler)
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(k * k, in_ch, out_ch))
        self.bias = nn.Parameter(torch.empty(out_ch)) if use_bias else None

    def _linear_filler(self) -> np.ndarray:
        """Bilinear-interpolation weights on the channel diagonal, the
        'linear' filler (reference: core/pac_modules.py:597-611)."""
        k, s = self.kernel_size, self.stride
        p = (k - (2 * s - 1)) // 2
        w1 = np.concatenate([np.zeros(p), np.arange(1, s), np.arange(s, 0, -1),
                             np.zeros(p)]) / s
        if self.normalize_kernel:
            w1 = w1 * np.array([((k - j - 1) // s) + (j // s) + 1.0 for j in range(k)])
        w2 = (w1[:, None] * w1[None, :]).reshape(k * k)
        eye = np.zeros((k * k, self.in_ch, self.out_ch), np.float32)
        for c in range(min(self.in_ch, self.out_ch)):
            eye[:, c, c] = w2
        return eye

    @torch.no_grad()
    def init_from(self, gen: torch.Generator) -> None:
        k = self.kernel_size
        bound = 1.0 / math.sqrt(self.in_ch * k * k)
        if self.identity_init:
            self.weight.zero_()
            for c in range(min(self.in_ch, self.out_ch)):
                self.weight[:, c, c] = 1.0
        elif self.filler == "linear":
            self.weight.copy_(torch.from_numpy(self._linear_filler()))
        else:
            _uniform(gen, self.weight, bound)
        if self.bias is not None:
            if self.filler == "linear":
                self.bias.zero_()  # the linear filler zeroes the bias (reference: :610-611)
            else:
                _uniform(gen, self.bias, bound)

    def forward(self, x: torch.Tensor, guide: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size
        # The kernel at the output resolution with 'same' padding, split
        # asymmetrically for even sizes (reference: core/pac_modules.py:365-367).
        span = k - 1
        kernel, _ = pac_kernel2d(guide, k, pad_lo=(span // 2, span // 2),
                                 pad_hi=(span - span // 2, span - span // 2),
                                 **self._kernel_params(guide.device))
        if self.normalize_kernel:
            # Taps on stuffed zeros contribute nothing: normalise over the
            # real samples' taps (reference: core/pac_modules.py:352-360,417-424).
            pattern, rows = stuffed_mask(x, self.stride, k, 1, self.padding,
                                         self.output_padding)
            pad = span - self.padding
            pat = extract_patches(pattern, k, pad_lo=(rows[0], pad),
                                  pad_hi=(rows[1], pad + self.output_padding))[..., 0]
            kernel = kernel * pat
            kernel = kernel / torch.clamp(kernel.sum(dim=3, keepdim=True), min=1e-12)
        return pacconv_transpose2d(x, kernel, self.weight, self.bias, stride=self.stride,
                                   padding=self.padding, output_padding=self.output_padding)


class PacJointUpsample(nn.Module):
    """The guided upsampler with target, guidance and final branches and
    log2(factor) PacConvTranspose2d stages (reference:
    core/pac_upsampler.py:153-251), on (B, H, W, C)."""

    def __init__(self, factor: int, channels: int = 1, guide_channels: int = 3,
                 n_t_layers: int = 3, n_g_layers: int = 3, n_f_layers: int = 2,
                 n_filters: int = 32, k_ch: int = 16, f_sz_1: int = 5, f_sz_2: int = 5):
        super().__init__()
        if math.log2(factor) % 1:
            raise ValueError("factor must be a power of 2")
        self.factor, self.k_ch = factor, k_ch
        self.num_ups = num_ups = int(math.log2(factor))
        self.n_t, self.n_g, self.n_f = n_t_layers, n_g_layers, n_f_layers
        for li in range(n_t_layers):
            self.add_module(f"t_conv{li + 1}",
                            Conv2d(1 if li == 0 else n_filters, n_filters, f_sz_1))
        for li in range(n_g_layers):
            out = k_ch * num_ups if li == n_g_layers - 1 else n_filters
            self.add_module(f"g_conv{li + 1}",
                            Conv2d(guide_channels if li == 0 else n_filters, out, f_sz_1))
        for i in range(num_ups):
            self.add_module(f"up_convt{i + 1}", PacConvTranspose2d(
                n_filters, n_filters, kernel_size=f_sz_2, stride=2,
                padding=(f_sz_2 - 1) // 2, output_padding=f_sz_2 % 2))
        for li in range(n_f_layers):
            out = 1 if li == n_f_layers - 1 else n_filters
            self.add_module(f"f_conv{li + 1}", Conv2d(n_filters, out, f_sz_1))

    def forward(self, x_lowres: torch.Tensor, guidance: torch.Tensor) -> torch.Tensor:
        x, ch0 = _fold_channels(x_lowres)
        for li in range(self.n_t):  # the target branch at low resolution
            x = _conv(getattr(self, f"t_conv{li + 1}"), x)
            if li < self.n_t - 1:
                x = torch.relu(x)
        g = guidance  # the guidance branch: k_ch kernel features per stage
        for li in range(self.n_g):
            g = _conv(getattr(self, f"g_conv{li + 1}"), g)
            if li < self.n_g - 1:
                g = torch.relu(g)
        H, W = x_lowres.shape[1:3]
        for i in range(self.num_ups):
            # Each stage's guide features at its output resolution
            # (reference: core/pac_upsampler.py:239-248).
            scale = 2 ** (i + 1)
            g_cur = g[..., i * self.k_ch: (i + 1) * self.k_ch]
            if scale != self.factor:
                g_cur = resize_half_pixel(g_cur, (H * scale, W * scale))
            g_cur = _repeat_for_channels(g_cur, ch0)
            x = torch.relu(getattr(self, f"up_convt{i + 1}")(x, g_cur))
        for li in range(self.n_f):  # the final prediction branch
            x = _conv(getattr(self, f"f_conv{li + 1}"), x)
            if li < self.n_f - 1:
                x = torch.relu(x)
        return _unfold_channels(x, ch0)


class DJIF(nn.Module):
    """Deep joint image filtering (reference: core/pac_upsampler.py:105-145):
    the target resized up bilinearly, then target and guidance branches
    fused by a joint branch, on (B, H, W, C)."""

    def __init__(self, factor: int, channels: int = 1, guide_channels: int = 3,
                 fs: Sequence[int] = (9, 1, 5), ns_tg: Sequence[int] = (96, 48, 1),
                 ns_f: Sequence[int] = (64, 32)):
        super().__init__()
        self.factor, self.fs, self.ns_tg = factor, tuple(fs), tuple(ns_tg)
        # The reference spreads the t/g branches' total padding evenly
        # (paddings (2, 2, 2) for fs=(9, 1, 5)) rather than k//2 per layer
        # (reference: core/pac_upsampler.py:109-110,115-127): equal shares,
        # the remainder on the last layer.
        total_pad = sum(f // 2 for f in self.fs)
        n = len(self.fs)
        share = total_pad // n
        pads = (share,) * (n - 1) + (total_pad - (n - 1) * share,)
        for prefix, cin in (("t", 1), ("g", guide_channels)):
            for li, (nc, f) in enumerate(zip(self.ns_tg, self.fs)):
                self.add_module(f"{prefix}_conv{li + 1}",
                                Conv2d(cin, nc, f, padding=pads[li]))
                cin = nc
        self.chans = tuple(ns_f) + (1,)
        cin = 2 * self.ns_tg[-1]
        for li, (nc, f) in enumerate(zip(self.chans, self.fs)):
            self.add_module(f"j_conv{li + 1}", Conv2d(cin, nc, f))
            cin = nc

    def _branch(self, v: torch.Tensor, prefix: str) -> torch.Tensor:
        convs = [getattr(self, f"{prefix}_conv{li + 1}") for li in range(len(self.ns_tg))]
        if halo.current() is not None:
            return _banded_branch(convs, v)
        for li, conv in enumerate(convs):
            v = _conv(conv, v)
            if li < len(convs) - 1:
                v = torch.relu(v)
        return v

    def forward(self, x_lowres: torch.Tensor, guidance: torch.Tensor) -> torch.Tensor:
        x, ch0 = _fold_channels(x_lowres)
        if x.shape[2] < guidance.shape[2]:
            x = resize_half_pixel(x, (x.shape[1] * self.factor, x.shape[2] * self.factor))
        t = self._branch(x, "t")
        g = _repeat_for_channels(self._branch(guidance, "g"), ch0)
        v = torch.cat([t, g], dim=-1)
        for li in range(len(self.chans)):
            v = _conv(getattr(self, f"j_conv{li + 1}"), v)
            if li < len(self.chans) - 1:
                v = torch.relu(v)
        return _unfold_channels(v, ch0)


def _banded_branch(convs: Sequence[nn.Module], v: torch.Tensor) -> torch.Tensor:
    """A stack of stride-1 convolutions with a ReLU between them, whose
    paddings may differ from their kernels' halves (DJIF's branches), on
    this rank's band of rows of (B, H, W, C) ``v``: the band's rows of the
    whole image's output, which must have the image's height. The rows
    each layer's band needs are worked back from the last layer's band
    rows; the input's whole receptive field comes from the neighbours in
    one exchange (zeros past the image's edges); each convolution runs
    valid in the rows (padded in the columns), and the rows of its output
    that lie outside the whole image's output of that layer, where the
    next layer reads zero padding, are zeroed."""
    rows = v.shape[1]
    first = halo.first_row(rows)
    heights = [rows * halo.current().size]
    for conv in convs:
        span = conv.dilation[0] * (conv.kernel_size[0] - 1)
        heights.append(heights[-1] + 2 * conv.padding[0] - span)
    if heights[-1] != heights[0]:
        raise ValueError(f"a branch that takes {heights[0]} rows to {heights[-1]} cannot run "
                         "on a band of rows")
    starts = [first]  # each layer's first output row, from the last layer back
    for conv in reversed(convs):
        starts.insert(0, starts[0] - conv.padding[0])
    end = first + rows  # the input's end row: the same walk with each span
    for conv in reversed(convs):
        end += conv.dilation[0] * (conv.kernel_size[0] - 1) - conv.padding[0]
    x = halo.extend(v, first - starts[0], end - first - rows, dim=1).permute(0, 3, 1, 2)
    for li, conv in enumerate(convs):
        x = F.conv2d(x, conv.weight, conv.bias, conv.stride, (0, conv.padding[1]),
                     conv.dilation, conv.groups)
        if li < len(convs) - 1:
            x = torch.relu(x)
            g = torch.arange(x.shape[2], device=x.device) + starts[li + 1]
            inside = (g >= 0) & (g < heights[li + 1])
            x = torch.where(inside[None, None, :, None], x, torch.zeros_like(x))
    return x.permute(0, 2, 3, 1)


class JointBilateral(nn.Module):
    """Joint bilateral upsampling as a fixed-weight PAC transposed
    convolution over [colour * scale_color, position * scale_space]
    guidance (reference: core/pac_upsampler.py:67-93), on (B, H, W, C)."""

    def __init__(self, factor: int, channels: int = 2, kernel_size: int = 5,
                 scale_space: float = 0.125, scale_color: float = 1.0):
        super().__init__()
        self.factor, self.scale_space, self.scale_color = factor, scale_space, scale_color
        k, f = kernel_size, factor
        self.convt = PacConvTranspose2d(
            1, 1, kernel_size=k, stride=f, padding=1 + (k - f - 1) // 2,
            output_padding=(k - f) % 2, normalize_kernel=True, use_bias=False,
            identity_init=True)

    def forward(self, x_lowres: torch.Tensor, guidance: torch.Tensor) -> torch.Tensor:
        x, ch0 = _fold_channels(x_lowres)
        B, H, W, _ = guidance.shape
        # The position channel counts global rows (on a band, from its first).
        yy = torch.arange(H, dtype=guidance.dtype, device=guidance.device) + halo.first_row(H)
        xx = torch.arange(W, dtype=guidance.dtype, device=guidance.device)
        guide = torch.cat([
            guidance * self.scale_color,
            yy[None, :, None, None].expand(B, H, W, 1) * self.scale_space,
            xx[None, None, :, None].expand(B, H, W, 1) * self.scale_space,
        ], dim=-1)
        out = self.convt(x, _repeat_for_channels(guide, ch0))
        return _unfold_channels(out, ch0)


class _PacHead(nn.Module):
    """The PAC or DJIF head behind the upsampler interface: ``forward(x
    (B, C, h, w), guidance (B, G, gh, gw))`` -> (B, C, s*h, s*w), NCHW
    like the port's other upsamplers. The guidance (the GRU state, at the
    input's low resolution) is resized to the output resolution first, as
    JAX's head does (the reference wires full-resolution RGB guidance)."""

    def __init__(self, cfg: UpsamplerConfig, guidance_ch: int, data_ch: int = 2):
        super().__init__()
        self.cfg = cfg
        self.kind = cfg.kind
        if cfg.kind == "pac":
            self.pac = PacJointUpsample(factor=cfg.scale, channels=data_ch,
                                        guide_channels=guidance_ch)
        elif cfg.kind == "djif":
            self.djif = DJIF(factor=cfg.scale, channels=data_ch, guide_channels=guidance_ch)
        else:
            raise ValueError(f"not a PAC head kind: {cfg.kind!r}")

    def forward(self, x_lowres: torch.Tensor, guidance: torch.Tensor) -> torch.Tensor:
        x = x_lowres.permute(0, 2, 3, 1)
        H, W = x.shape[1:3]
        s = self.cfg.scale
        guide_hr = resize_half_pixel(guidance.permute(0, 2, 3, 1), (H * s, W * s))
        head = self.pac if self.kind == "pac" else self.djif
        return head(x, guide_hr).permute(0, 3, 1, 2)


def build_pac_upsampler(cfg: UpsamplerConfig, guidance_ch: int) -> nn.Module:
    """The registry's entry for the ``pac`` and ``djif`` kinds (reference
    wrappers: core/upsampler.py:223-242)."""
    return _PacHead(cfg, guidance_ch)
