"""Final flow upsamplers (port of ``raft_ncup_tpu/nn/upsampler.py``'s
``NConvUpsampler``, ``BilinearUpsampler`` and ``build_upsampler``, whose
``pac`` and ``djif`` kinds build the heads of ``nn/pac.py``), NCHW.

NCUP forward (shipped config: scale 4, data used for guidance, channels
folded into the batch, estimation at low resolution, no residuals):

1. zero-stuff the low-res data x4 onto the high-res grid;
2. area-resize the guidance to the low-res grid, concatenate it with the
   data and run the weights-estimation net (sigmoid confidences);
3. zero-stuff the confidences x4;
4. fold channels into the batch (free in NCHW: a reshape) and run the
   NConv U-Net on (data, confidence).

With ``est_on_high_res`` step 2 runs at high resolution instead, on the
zero-stuffed data and the guidance resized bilinearly (align_corners),
and step 3 falls away. The weights net is ``SimpleWeightsNet``,
``UNetWeightsNet`` or, for ``weights_est_net='binary'``, none: the
confidence is 1 where the data is positive, else 0.

On a band of rows (``parallel/halo.py``) the nearest x2, the area resize,
the zero-stuffing and the U-Net's pooling are local under the pad divisor
8 times the spatial size; the convolutions exchange halos; the resizes
with aligned corners (``est_on_high_res``'s guidance, the bilinear
upsampler) run on the gathered whole and keep the band.
"""

from __future__ import annotations

import torch
from torch import nn

from raft_ncup_tpu_torch.config import UpsamplerConfig
from raft_ncup_tpu_torch.nn.nconv_unet import NConvUNet
from raft_ncup_tpu_torch.nn.weights_est import SimpleWeightsNet, UNetWeightsNet
from raft_ncup_tpu_torch.ops.geometry import (
    adaptive_area_resize_nchw,
    bilinear_resize_align_corners_nchw,
)
from raft_ncup_tpu_torch.ops.nconv import zero_stuff_upsample_nchw
from raft_ncup_tpu_torch.parallel import halo


class NConvUpsampler(nn.Module):
    def __init__(
        self,
        cfg: UpsamplerConfig,
        data_ch: int = 2,
        guidance_ch: int = 128,
        use_bn: bool = False,
        nconv_impl: str = "xla",
    ):
        super().__init__()
        self.cfg = cfg
        west_in = guidance_ch + (data_ch if cfg.use_data_for_guidance else 0)
        self.weights_est_net = None
        if cfg.weights_est_net == "simple":
            self.weights_est_net = SimpleWeightsNet(
                west_in,
                num_ch=cfg.weights_est_num_ch,
                out_ch=data_ch,
                filter_sz=cfg.weights_est_filter_sz,
                dilation=cfg.weights_est_dilation,
                use_bn=use_bn,
            )
        elif cfg.weights_est_net == "unet":
            self.weights_est_net = UNetWeightsNet(
                west_in, num_ch=cfg.weights_est_num_ch, out_ch=data_ch
            )
        self.interpolation_net = NConvUNet(
            in_ch=1 if cfg.channels_to_batch else data_ch,
            channels_multiplier=cfg.channels_multiplier,
            num_downsampling=cfg.num_downsampling,
            encoder_filter_sz=cfg.encoder_filter_sz,
            decoder_filter_sz=cfg.decoder_filter_sz,
            out_filter_sz=cfg.out_filter_sz,
            pos_fn=cfg.pos_fn,
            use_bias=cfg.use_bias,
            data_pooling=cfg.data_pooling,
            shared_encoder=cfg.shared_encoder,
            use_double_conv=cfg.use_double_conv,
            impl=nconv_impl,
        )

    def forward(self, x_lowres: torch.Tensor, guidance: torch.Tensor) -> torch.Tensor:
        """x_lowres (B, C, h, w) and guidance (B, G, gh, gw) -> (B, C, s*h, s*w)."""
        cfg = self.cfg
        s = cfg.scale
        B, C, H, W = x_lowres.shape
        oh, ow = H * s, W * s
        x_highres = zero_stuff_upsample_nchw(x_lowres, s, s)
        if cfg.est_on_high_res:
            data = x_highres
            # Aligned corners read the whole height: resized whole, then banded.
            guid = halo.on_whole(lambda g: bilinear_resize_align_corners_nchw(
                g, (g.shape[2] * oh // guidance.shape[2], ow)), guidance)
        else:
            data = x_lowres
            guid = adaptive_area_resize_nchw(guidance, (H, W))
        if self.weights_est_net is None:
            w = (data > 0).to(x_lowres.dtype)
        else:
            west_in = torch.cat([data, guid], dim=1) if cfg.use_data_for_guidance else guid
            w = self.weights_est_net(west_in)
        w_highres = w if cfg.est_on_high_res else zero_stuff_upsample_nchw(w, s, s)
        if cfg.channels_to_batch:
            # Channel c of sample b lands at batch index b*C + c.
            out, _ = self.interpolation_net(
                x_highres.reshape(B * C, 1, oh, ow),
                w_highres.reshape(B * C, 1, oh, ow),
            )
            out = out.reshape(B, C, oh, ow)
        else:
            out, _ = self.interpolation_net(x_highres, w_highres)
        if cfg.use_residuals:
            out = torch.where(x_highres > 0, x_highres, out)
        return out


class BilinearUpsampler(nn.Module):
    """The bilinear baseline: x ``cfg.scale`` with align_corners; it has no
    weights and ignores the guidance."""

    def __init__(self, cfg: UpsamplerConfig):
        super().__init__()
        self.cfg = cfg

    def forward(self, x_lowres: torch.Tensor, guidance: torch.Tensor) -> torch.Tensor:
        s = self.cfg.scale
        return halo.on_whole(lambda x: bilinear_resize_align_corners_nchw(
            x, (x.shape[2] * s, x.shape[3] * s)), x_lowres)


def build_upsampler(
    cfg: UpsamplerConfig, dataset: str, nconv_impl: str = "xla",
    guidance_ch: int = 128,
) -> nn.Module:
    """Upsampler factory. BatchNorm in the simple weights-estimation net
    is on iff the model is configured for Sintel; the ``pac`` and ``djif``
    kinds are the heads of ``nn/pac.py``."""
    if cfg.kind == "nconv":
        return NConvUpsampler(
            cfg, guidance_ch=guidance_ch, use_bn=(dataset == "sintel"),
            nconv_impl=nconv_impl,
        )
    if cfg.kind == "bilinear":
        return BilinearUpsampler(cfg)
    if cfg.kind in ("pac", "djif"):
        from raft_ncup_tpu_torch.nn.pac import build_pac_upsampler

        return build_pac_upsampler(cfg, guidance_ch=guidance_ch)
    raise ValueError(f"unknown upsampler kind: {cfg.kind!r}")
