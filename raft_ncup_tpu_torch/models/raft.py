"""RAFT-NCUP model, test-mode and train-mode forward (port of
``raft_ncup_tpu/models/raft.py``).

The JAX bundle (fnet / cnet / update_block / upsampler plus a functional
forward over a ``lax.scan``) becomes one ``nn.Module`` whose refinement
is a Python loop. Submodules run NCHW; the public forward takes and
returns the JAX layouts (NHWC images and flows, (B, H, W, 2) coordinates
with x first).

This slice covers the flagship ``raft_nc_dbl`` variant, in f32 with TF32
off (``utils.device.f32_precision``):

- in eval mode, ``apply(test_mode=True)`` with ``flow_init``, under
  ``torch.no_grad``; BatchNorm uses its running statistics;
- in training mode (``model.train()``), ``apply(train=True)``: the
  stacked per-iteration upsampled flow, the NCUP upsampler run every
  iteration, coordinates detached at the start of each iteration, and
  each iteration under ``torch.utils.checkpoint`` when ``remat`` (the
  JAX ``jax.checkpoint``). BatchNorm trains unless :meth:`RAFT.freeze_bn`
  put it back in eval mode (the JAX ``freeze_bn``); its running
  statistics advance once per iteration, never again in the recompute.

The ``raft`` and small variants, segments, early exit, warm-started GRU
state and dropout are later slices.

The model lives on the card unless the caller passes ``device="cpu"``;
with no device and no CUDA, construction raises.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from raft_ncup_tpu_torch.config import ModelConfig
from raft_ncup_tpu_torch.nn.extractor import BasicEncoder
from raft_ncup_tpu_torch.nn.layers import frozen_batch_stats, init_weights
from raft_ncup_tpu_torch.nn.update import BasicUpdateBlock
from raft_ncup_tpu_torch.nn.upsampler import build_upsampler
from raft_ncup_tpu_torch.ops.corr import (
    build_corr_pyramid,
    corr_lookup,
    corr_lookup_onthefly,
)
from raft_ncup_tpu_torch.ops.corr_cuda import lookup_levels, prepare_levels
from raft_ncup_tpu_torch.ops.geometry import coords_grid, upsample_nearest
from raft_ncup_tpu_torch.utils.device import f32_precision, resolve_device


class RAFT(nn.Module):
    """Usage::

        model = RAFT(flagship_config(corr_impl="pallas", nconv_impl="pallas"))
        flow_lr, flow_up = model(img1, img2, iters=12)

    Images are (B, H, W, 3) float32 in [0, 255] on the model's device,
    with H and W divisible by 8 (pad with ``ops.padding.InputPadder``).
    Weights are drawn from ``seed``; ``utils.jax_weights`` carries the
    JAX package's variables across instead.
    """

    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0):
        super().__init__()
        if cfg.variant != "raft_nc_dbl" or cfg.small:
            raise NotImplementedError(
                f"variant {cfg.variant!r} (small={cfg.small}) lands with a "
                "later slice; the port runs raft_nc_dbl"
            )
        dev = resolve_device(device)
        self.cfg = cfg
        hdim, cdim = cfg.hidden_dim, cfg.context_dim
        self.fnet = BasicEncoder(cfg.fnet_dim, "instance", cfg.dropout)
        self.cnet = BasicEncoder(hdim + cdim, "batch", cfg.dropout)
        self.update_block = BasicUpdateBlock(cfg.corr_planes, hdim, cdim)
        # NCUP consumes the 2-channel flow with the GRU state as guidance.
        self.upsampler = build_upsampler(
            cfg.upsampler, cfg.dataset, cfg.nconv_impl, guidance_ch=hdim
        )
        init_weights(self, torch.Generator().manual_seed(int(seed)))
        self.eval()
        self.to(dev)
        self.device = dev

    def freeze_bn(self) -> "RAFT":
        """Put every BatchNorm in eval mode (running statistics, no
        update), as the reference's ``freeze_bn`` does for every stage but
        chairs. ``train()`` undoes it."""
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.eval()
        return self

    # ------------------------------------------------------------ pieces

    def _encode(self, image1, image2, flow_init=None):
        """Normalize, siamese fnet, context cnet, initial coordinates.
        Returns NHWC ``fmap1, fmap2``, NCHW ``net, inp`` and NHWC
        ``coords1``."""
        B, H, W, _ = image1.shape
        if H % 8 or W % 8:
            raise ValueError(
                f"image H, W must be divisible by 8, got {(H, W)}; pad inputs "
                "with raft_ncup_tpu_torch.ops.padding.InputPadder first"
            )
        img1 = 2.0 * (image1.float() / 255.0) - 1.0
        img2 = 2.0 * (image2.float() / 255.0) - 1.0
        img1 = img1.permute(0, 3, 1, 2)
        img2 = img2.permute(0, 3, 1, 2)
        fmaps = self.fnet(torch.cat([img1, img2], dim=0))
        fmap1, fmap2 = fmaps.permute(0, 2, 3, 1).split(B, dim=0)
        cnet = self.cnet(img1)
        hdim = self.cfg.hidden_dim
        net = torch.tanh(cnet[:, :hdim])
        inp = torch.relu(cnet[:, hdim:])
        coords1 = coords_grid(B, H // 8, W // 8, device=image1.device)
        if flow_init is not None:
            coords1 = coords1 + flow_init
        return fmap1, fmap2, net, inp, coords1.contiguous()

    def _build_corr_fn(self, fmap1, fmap2) -> Callable[[torch.Tensor], torch.Tensor]:
        """Correlation-lookup closure over one pair's (B, h, w, C) feature
        maps, per ``cfg.corr_impl``; maps (B, h, w, 2) coords to
        (B, h, w, corr_planes)."""
        cfg = self.cfg
        radius = cfg.resolved_corr_radius
        levels = cfg.corr_levels
        if cfg.corr_impl == "volume":
            pyramid = build_corr_pyramid(fmap1, fmap2, levels)
            return lambda coords: corr_lookup(pyramid, coords, radius)
        if cfg.corr_impl == "onthefly":
            return lambda coords: corr_lookup_onthefly(
                fmap1, fmap2, coords, radius, levels
            )
        # 'pallas': the fused lookup kernel. Pooling and the 1/sqrt(C)
        # scale happen once per pair; each iteration is one launch.
        f1s, f2_levels = prepare_levels(fmap1, fmap2, levels)
        return lambda coords: lookup_levels(
            f1s, f2_levels, coords.contiguous(), radius
        )

    def _upsample(self, flow_lr: torch.Tensor, net: torch.Tensor) -> torch.Tensor:
        """nearest x2, NCUP x4, values x8: (B, h, w, 2) -> (B, 8h, 8w, 2)."""
        flow2 = upsample_nearest(flow_lr, 2).permute(0, 3, 1, 2).contiguous()
        hr = self.upsampler(flow2, net)
        return (8.0 * hr).permute(0, 2, 3, 1)

    # ----------------------------------------------------------- forward

    @f32_precision()
    def forward(
        self,
        image1: torch.Tensor,
        image2: torch.Tensor,
        iters: int = 12,
        flow_init: Optional[torch.Tensor] = None,
        remat: bool = True,
    ):
        """In eval mode, the test-mode forward: ``(flow_lr, flow_up)``,
        (B, H/8, W/8, 2) and (B, H, W, 2) float32, without gradients. In
        training mode, the train-mode forward: the upsampled flow of every
        iteration, (iters, B, H, W, 2) float32, each iteration under
        ``torch.utils.checkpoint`` when ``remat``."""
        if self.training:
            return self._forward_train(image1, image2, iters, flow_init, remat)
        with torch.no_grad():
            return self._forward_test(image1, image2, iters, flow_init)

    def _forward_test(self, image1, image2, iters, flow_init):
        fmap1, fmap2, net, inp, coords1 = self._encode(image1, image2, flow_init)
        corr_fn = self._build_corr_fn(fmap1, fmap2)
        B, h8, w8, _ = coords1.shape
        coords0 = coords_grid(B, h8, w8, device=coords1.device)
        for _ in range(int(iters)):
            corr = corr_fn(coords1)
            flow = coords1 - coords0
            net, delta = self.update_block(
                net, inp, corr.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2)
            )
            coords1 = coords1 + delta.permute(0, 2, 3, 1)
        flow_lr = coords1 - coords0
        return flow_lr, self._upsample(flow_lr, net)

    def _forward_train(self, image1, image2, iters, flow_init, remat):
        fmap1, fmap2, net, inp, coords1 = self._encode(image1, image2, flow_init)
        corr_fn = self._build_corr_fn(fmap1, fmap2)
        B, h8, w8, _ = coords1.shape
        coords0 = coords_grid(B, h8, w8, device=coords1.device)

        def step(net, coords1):
            coords1 = coords1.detach()
            corr = corr_fn(coords1)
            flow = coords1 - coords0
            net, delta = self.update_block(
                net, inp, corr.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2)
            )
            coords1 = coords1 + delta.permute(0, 2, 3, 1)
            return net, coords1, self._upsample(coords1 - coords0, net)

        preds = []
        for _ in range(int(iters)):
            if remat:
                net, coords1, flow_up = checkpoint(
                    step, net, coords1, use_reentrant=False,
                    context_fn=_remat_contexts,
                )
            else:
                net, coords1, flow_up = step(net, coords1)
            preds.append(flow_up)
        return torch.stack(preds)


def _remat_contexts():
    """(forward, recompute) contexts of a checkpointed iteration: the
    recompute leaves BatchNorm's running statistics alone."""
    return contextlib.nullcontext(), frozen_batch_stats()
