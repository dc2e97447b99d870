"""Normalized-convolution U-Net of NCUP (port of
``raft_ncup_tpu/nn/nconv_unet.py``), NCHW.

Every layer is a normalized convolution propagating (data, confidence)
pairs; downsampling pools confidence and gathers data at its argmax; the
decoder nearest-upsamples and concatenates skip features. The decoder
indexing is the reference's, faithfully (``x[i + nds]`` / ``x[nds - i]``):
the output of the last encoder stage (the coarsest one) is overwritten
by the first decoder before anything reads it. The JAX package computes
that stage and leaves XLA to drop it; the port never computes it. For the
shipped ``num_downsampling=1`` this skips the whole half-resolution
branch; its layer (``nconv_x2.0`` under the shared encoder) still holds
weights, because the full-resolution encoder uses it too.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from raft_ncup_tpu_torch.ops.geometry import upsample_nearest
from raft_ncup_tpu_torch.ops.nconv import (
    downsample_data_conf_nchw,
    nconv2d_nchw,
    positivity,
)


class NConv2dLayer(nn.Module):
    """Normalized conv layer. The raw parameter ``weight_p`` (OIHW) is
    mapped through ``pos_fn`` at every call to the effective non-negative
    kernel; it is initialized to ``pos_fn(N(2, 2/n))`` with
    n = k*k*out_ch, as the reference's EnforcePos does."""

    def __init__(
        self,
        in_ch: int,
        out_ch: int,
        kernel_size: int = 3,
        pos_fn: str = "softplus",
        use_bias: bool = False,
        impl: str = "xla",
    ):
        super().__init__()
        k = kernel_size
        self.pos_fn = pos_fn
        self.impl = impl
        self.weight_p = nn.Parameter(torch.empty(out_ch, in_ch, k, k))
        self.bias = nn.Parameter(torch.empty(out_ch)) if use_bias else None

    @torch.no_grad()
    def init_from(self, gen: torch.Generator) -> None:
        out_ch, in_ch, k, _ = self.weight_p.shape
        n = k * k * out_ch
        w = 2.0 + math.sqrt(2.0 / n) * torch.randn(self.weight_p.shape, generator=gen)
        self.weight_p.copy_(self._positive(w))
        if self.bias is not None:
            b = 1.0 / math.sqrt(in_ch * k * k)
            self.bias.copy_(torch.rand(self.bias.shape, generator=gen) * 2 * b - b)

    def _positive(self, raw: torch.Tensor) -> torch.Tensor:
        # positivity() takes the JAX HWIO layout (it matters for 'softmax').
        return positivity(raw.permute(2, 3, 1, 0), self.pos_fn).permute(
            3, 2, 0, 1
        ).contiguous()

    def forward(
        self, data: torch.Tensor, conf: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        return nconv2d_nchw(
            data, conf, self._positive(self.weight_p), self.bias,
            impl=self.impl,
        )


class NConvUNet(nn.Module):
    """Submodules: ``nconv_in``, ``nconv_x2.i``, ``encoder.<stage>`` (only
    without a shared encoder), ``decoder.i``, ``nconv_out``."""

    def __init__(
        self,
        in_ch: int = 1,
        channels_multiplier: int = 2,
        num_downsampling: int = 1,
        encoder_filter_sz: int = 5,
        decoder_filter_sz: int = 3,
        out_filter_sz: int = 1,
        pos_fn: str = "softplus",
        use_bias: bool = False,
        data_pooling: str = "conf_based",
        shared_encoder: bool = True,
        use_double_conv: bool = False,
        impl: str = "xla",
    ):
        super().__init__()
        mult = in_ch * channels_multiplier
        self.nds = num_downsampling
        self.data_pooling = data_pooling
        self.shared_encoder = shared_encoder

        def layer(cin, cout, k, bias=use_bias):
            return NConv2dLayer(cin, cout, k, pos_fn, bias, impl)

        self.nconv_in = layer(in_ch, mult, encoder_filter_sz)
        self.nconv_x2 = nn.ModuleList(
            layer(mult, mult, encoder_filter_sz)
            for _ in range(2 if use_double_conv else 1)
        )
        if not shared_encoder:
            self.encoder = nn.ModuleDict({
                str(i + 1): layer(mult, mult, encoder_filter_sz)
                for i in range(self.nds)
            })
        self.decoder = nn.ModuleList(
            layer(2 * mult, mult, decoder_filter_sz) for _ in range(self.nds)
        )
        self.nconv_out = layer(mult, in_ch, out_filter_sz, bias=False)

    def _enc_deep(self, i: int, d, c):
        # The shared encoder reuses the first nconv_x2 layer at every scale.
        if self.shared_encoder:
            return self.nconv_x2[0](d, c)
        return self.encoder[str(i + 1)](d, c)

    def forward(
        self, data: torch.Tensor, conf: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        nds = self.nds
        x: list = [None] * (nds * 2 + 1)
        c: list = [None] * (nds * 2 + 1)
        d0, c0 = self.nconv_in(data, conf)
        for layer in self.nconv_x2:
            d0, c0 = layer(d0, c0)
        if nds == 0:
            return self.nconv_out(d0, c0)
        x[0], c[0] = data, conf
        x[1], c[1] = d0, c0
        # Encoder stages 2..nds; stage nds + 1 (x[nds + 1]) is overwritten
        # by decoder 0 before any read, so it is not computed.
        for i in range(1, nds):
            d_ds, c_ds = downsample_data_conf_nchw(x[i], c[i], self.data_pooling)
            x[i + 1], c[i + 1] = self._enc_deep(i - 1, d_ds, c_ds)
        for i, decoder in enumerate(self.decoder):
            # Faithful reference indexing (see module docstring).
            target_h = c[nds - i].shape[2]
            src_h = x[i + nds].shape[2]
            factor = target_h // src_h if src_h else 1
            if factor > 1:
                x_up = upsample_nearest(x[i + nds].permute(0, 2, 3, 1), factor)
                c_up = upsample_nearest(c[i + nds].permute(0, 2, 3, 1), factor)
                x_up, c_up = x_up.permute(0, 3, 1, 2), c_up.permute(0, 3, 1, 2)
            else:
                x_up, c_up = x[i + nds], c[i + nds]
            x[i + nds + 1], c[i + nds + 1] = decoder(
                torch.cat([x_up, x[nds - i]], dim=1),
                torch.cat([c_up, c[nds - i]], dim=1),
            )
        return self.nconv_out(x[-1], c[-1])
