"""RAFT and RAFT-NCUP models, test-mode and train-mode forward (port of
``raft_ncup_tpu/models/raft.py``).

The JAX bundle (fnet / cnet / update_block / upsampler plus a functional
forward over a ``lax.scan``) becomes one ``nn.Module`` whose refinement
is a Python loop. Submodules run NCHW; the public forward takes and
returns the JAX layouts (NHWC images and flows, (B, H, W, 2) coordinates
with x first).

Variants, as in the JAX package:

- ``raft_nc_dbl`` (full size or small): no mask head; the low-res flow
  goes nearest x2, through the configured upsampler (NCUP or bilinear)
  x4 with the GRU state as guidance, then x8 in value;
- ``raft``, full size: the update block's mask head and convex
  upsampling x8;
- ``raft``, small: bilinear ``upflow`` x8 with ``cfg.align_corners``.

In eval mode, ``apply(test_mode=True)`` with ``flow_init``, under
``torch.no_grad``; BatchNorm uses its running statistics. The upsampling
runs once, after the loop; the convex mask reads only the final GRU
state, so it is computed there once (the JAX model carries every
iteration's mask to the same end).

In training mode (``model.train()``), ``apply(train=True)``: the stacked
per-iteration upsampled flow, the upsampling (mask included) run every
iteration, coordinates detached at the start of each iteration, and
each iteration under ``torch.utils.checkpoint`` when ``remat`` (the
JAX ``jax.checkpoint``). BatchNorm trains unless :meth:`RAFT.freeze_bn`
put it back in eval mode (the JAX ``freeze_bn``); its running
statistics advance once per iteration, never again in the recompute.

Precision (``precision/policy.py``), as in the JAX package: the
configuration's policy gives the trunk's convolutions (both encoders,
the update block and the mask head) their compute dtype, and the
correlation features their dtype; the coordinates, the upsampling (NCUP
or convex, so kernels B and B' take f32) and the outputs stay f32. Under
f32 the forward adds no cast and runs with TF32 off
(``utils.device.f32_precision``). :meth:`RAFT.with_policy` runs the same
parameters under another preset.

Segments, early exit, warm-started GRU state and dropout are later
slices.

The model lives on the card unless the caller passes ``device="cpu"``;
with no device and no CUDA, construction raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from raft_ncup_tpu_torch.config import ModelConfig
from raft_ncup_tpu_torch.nn.extractor import Encoder
from raft_ncup_tpu_torch.nn.layers import frozen_batch_stats, init_weights
from raft_ncup_tpu_torch.nn.update import BasicUpdateBlock, SmallUpdateBlock
from raft_ncup_tpu_torch.nn.upsampler import build_upsampler
from raft_ncup_tpu_torch.ops.corr import (
    build_corr_pyramid,
    corr_lookup,
    corr_lookup_onthefly,
)
from raft_ncup_tpu_torch.ops.corr_cuda import lookup_levels, prepare_levels
from raft_ncup_tpu_torch.precision import PrecisionPolicy, resolve_policy
from raft_ncup_tpu_torch.ops.geometry import (
    convex_upsample_nchw,
    coords_grid,
    upflow,
    upsample_nearest,
)
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
        dev = resolve_device(device)
        self.cfg = cfg
        self.policy = cfg.precision_policy
        dtype = self.policy.module_dtype
        hdim, cdim = cfg.hidden_dim, cfg.context_dim
        if cfg.small:
            self.fnet = Encoder(cfg.fnet_dim, "instance", small=True, dtype=dtype)
            self.cnet = Encoder(hdim + cdim, "none", small=True, dtype=dtype)
            self.update_block = SmallUpdateBlock(cfg.corr_planes, hdim, cdim, dtype)
        else:
            self.fnet = Encoder(cfg.fnet_dim, "instance", dtype=dtype)
            self.cnet = Encoder(hdim + cdim, "batch", dtype=dtype)
            self.update_block = BasicUpdateBlock(
                cfg.corr_planes, hdim, cdim, use_mask_head=(cfg.variant == "raft"),
                dtype=dtype,
            )
        self.upsampler = None
        if cfg.variant == "raft_nc_dbl":
            # The upsampler takes the 2-channel flow with the GRU state as
            # guidance.
            self.upsampler = build_upsampler(
                cfg.upsampler, cfg.dataset, cfg.nconv_impl, guidance_ch=hdim
            )
        init_weights(self, torch.Generator().manual_seed(int(seed)))
        self.eval()
        self.to(dev)
        self.device = dev

    def with_policy(self, spec: str | PrecisionPolicy | None) -> "RAFT":
        """This model under the precision preset ``spec``: ``self`` when it
        is the model's own, else a model built at the preset's dtypes that
        holds this model's parameters and buffers themselves (shared, not
        copied), on the same device."""
        policy = resolve_policy(spec)
        if policy == self.policy:
            return self
        cfg = dataclasses.replace(self.cfg, precision=policy.name, mixed_precision=False)
        view = RAFT(cfg, device="meta")  # no memory: the tensors come next
        view.load_state_dict(self.state_dict(), strict=True, assign=True)
        view.device = self.device
        for mine, theirs in zip(view.modules(), self.modules()):
            mine.training = theirs.training  # a frozen BatchNorm stays frozen
        return view

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
        # The correlation features at the policy's corr dtype.
        fmap1, fmap2 = fmaps.permute(0, 2, 3, 1).to(self.policy.corr).split(B, dim=0)
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
        dtype = self.policy.corr
        if cfg.corr_impl == "volume":
            pyramid = build_corr_pyramid(fmap1, fmap2, levels, dtype)
            return lambda coords: corr_lookup(pyramid, coords, radius)
        if cfg.corr_impl == "onthefly":
            return lambda coords: corr_lookup_onthefly(
                fmap1, fmap2, coords, radius, levels, dtype
            )
        # 'pallas': the fused lookup kernel. Pooling and the 1/sqrt(C)
        # scale happen once per pair; each iteration is one launch.
        f1s, f2_levels = prepare_levels(fmap1, fmap2, levels, dtype)
        return lambda coords: lookup_levels(
            f1s, f2_levels, coords.contiguous(), radius
        )

    def _upsample(self, flow_lr: torch.Tensor, net: torch.Tensor) -> torch.Tensor:
        """(B, h, w, 2) low-res flow and the NCHW GRU state ``net`` ->
        (B, 8h, 8w, 2), per variant: nearest x2, the upsampler x4 and
        values x8 (raft_nc_dbl); convex upsampling with the mask of
        ``net`` (raft); bilinear x8 (small raft). The upsampling runs at
        the policy's upsampler dtype (f32): the guidance and the mask
        logits are cast to it."""
        up = self.policy.upsampler
        if self.upsampler is not None:
            flow2 = upsample_nearest(flow_lr, 2).permute(0, 3, 1, 2).contiguous()
            hr = self.upsampler(flow2, net.to(up))
            return (8.0 * hr).permute(0, 2, 3, 1)
        if self.cfg.small:
            return upflow(flow_lr, 8, self.cfg.align_corners)
        mask = self.update_block.mask_logits(net).to(up)
        return convex_upsample_nchw(flow_lr.permute(0, 3, 1, 2), mask, 8).permute(0, 2, 3, 1)

    def _refine(self, corr_fn, coords0, coords1, net, inp):
        """One GRU iteration: the lookup, the update block on the flow at
        the GRU state's dtype, and the delta joined to the f32
        coordinates. Returns ``(net, coords1)``."""
        corr = corr_fn(coords1)
        flow = (coords1 - coords0).to(net.dtype)
        net, delta = self.update_block(
            net, inp, corr.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2)
        )
        return net, coords1 + delta.permute(0, 2, 3, 1).to(self.policy.coord)

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
            net, coords1 = self._refine(corr_fn, coords0, coords1, net, inp)
        flow_lr = coords1 - coords0
        return flow_lr, self._upsample(flow_lr, net).to(self.policy.output)

    def _forward_train(self, image1, image2, iters, flow_init, remat):
        fmap1, fmap2, net, inp, coords1 = self._encode(image1, image2, flow_init)
        corr_fn = self._build_corr_fn(fmap1, fmap2)
        B, h8, w8, _ = coords1.shape
        coords0 = coords_grid(B, h8, w8, device=coords1.device)

        def step(net, coords1):
            net, coords1 = self._refine(corr_fn, coords0, coords1.detach(), net, inp)
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
