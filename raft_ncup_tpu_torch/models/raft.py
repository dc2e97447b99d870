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
iteration's mask to the same end). The test-mode options are JAX's:

- warm start: ``net_init`` (B, H/8, W/8, hidden) replaces the context
  encoder's initial GRU state in the rows where ``net_warm`` is True, by
  a select, so a cold row is bit for bit a run without carry; ``inp``,
  the current frame's context, is never carried. ``return_net`` appends
  the final GRU state (NHWC);
- early exit: with ``early_exit_tol`` a row whose mean |delta| (f32, in
  low-res pixels) falls below the tolerance is converged from the next
  iteration on, and its ``net`` and ``coords1`` are frozen by select; the
  loop stops once every row has converged. ``return_exec_iters`` appends
  each row's count of iterations it was active at entry. The convex mask
  is computed from the final ``net``, so a frozen ``net`` gives the
  frozen mask and no mask rides the loop;
- stages: ``encode -> refine_segment x S -> finalize`` equals the
  forward. All three and the forward run one step body (``_step``), as
  JAX's ``_make_step``.

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

Encoder dropout (``cfg.dropout``) acts in training mode only and draws
its masks from ``dropout_generator`` (the train step seeds one per step;
``None`` uses PyTorch's default generator); with ``dropout_rows = (rank,
world)`` (a data-parallel step) at the global batch's shape, keeping the
rank's rows.

The spatial axis (``forward(..., mesh=...)`` with a spatial size above 1,
``parallel/halo.py``): the test-mode forward split by image rows over the
ranks of this process's spatial group, JAX's ``mesh`` argument. Each rank
takes its band of the whole inputs; the convolutions exchange row halos,
instance norm sums its statistics over the group, the coordinates start
at the band's global first row, the lookup reads the gathered fmap2, and
the outputs are gathered, so every rank returns the whole flow. Under
early exit each band's sum of |delta| is summed over the group before a
row's mean is taken, so every rank freezes the same rows and stops at the
same iteration. In training mode each rank returns its band of every
iteration's prediction, with no gather: the halo primitives are
differentiable, and the recompute of a checkpointed iteration enters the
forward's group again, so the backward exchanges as the forward did.

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
    CorrPyramid,
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
from raft_ncup_tpu_torch.parallel import halo
from raft_ncup_tpu_torch.parallel.mesh import spatial_group
from raft_ncup_tpu_torch.utils.device import f32_precision, resolve_device

# The images are normalized in f32 under every preset (the encoders cast
# to PrecisionPolicy.compute after).
IMAGE_DTYPE = torch.float32


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
        drop = cfg.dropout
        if cfg.small:
            self.fnet = Encoder(cfg.fnet_dim, "instance", small=True, dtype=dtype, dropout=drop)
            self.cnet = Encoder(hdim + cdim, "none", small=True, dtype=dtype, dropout=drop)
            self.update_block = SmallUpdateBlock(cfg.corr_planes, hdim, cdim, dtype)
        else:
            self.fnet = Encoder(cfg.fnet_dim, "instance", dtype=dtype, dropout=drop)
            self.cnet = Encoder(hdim + cdim, "batch", dtype=dtype, dropout=drop)
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
        self.dropout_generator: Optional[torch.Generator] = None
        # (rank, world) of a data-parallel train step: the masks are drawn at
        # the global batch's shape and the rank's rows taken.
        self.dropout_rows: Optional[tuple[int, int]] = None
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

    def _encode(self, image1, image2, flow_init=None, net_init=None, net_warm=None):
        """Normalize, siamese fnet, context cnet, the warm-start select and
        the initial coordinates. Returns NHWC ``fmap1, fmap2``, NCHW ``net,
        inp`` and NHWC ``coords1``."""
        B, H, W, _ = image1.shape
        if H % 8 or W % 8:
            raise ValueError(
                f"image H, W must be divisible by 8, got {(H, W)}; pad inputs "
                "with raft_ncup_tpu_torch.ops.padding.InputPadder first"
            )
        img1 = 2.0 * (image1.to(IMAGE_DTYPE) / 255.0) - 1.0
        img2 = 2.0 * (image2.to(IMAGE_DTYPE) / 255.0) - 1.0
        img1 = img1.permute(0, 3, 1, 2)
        img2 = img2.permute(0, 3, 1, 2)
        gen, rows = self.dropout_generator, self.dropout_rows
        fmaps = self.fnet(torch.cat([img1, img2], dim=0), gen,
                          None if rows is None else (*rows, 2))
        # The correlation features at the policy's corr dtype.
        fmap1, fmap2 = fmaps.permute(0, 2, 3, 1).to(self.policy.corr).split(B, dim=0)
        cnet = self.cnet(img1, gen, None if rows is None else (*rows, 1))
        hdim = self.cfg.hidden_dim
        net = torch.tanh(cnet[:, :hdim])
        inp = torch.relu(cnet[:, hdim:])
        if net_init is not None:
            # The carried state, in the cold state's memory layout, replaces
            # it per row by a select, never a blend: a cold row stays bit for
            # bit the run without carry.
            carried = torch.empty_like(net).copy_(net_init.permute(0, 3, 1, 2))
            if net_warm is None:
                net = carried
            else:
                net = torch.where(net_warm.to(torch.bool)[:, None, None, None], carried, net)
        coords1 = coords_grid(B, H // 8, W // 8, device=image1.device,
                              y0=halo.first_row(H // 8))
        if flow_init is not None:
            coords1 = coords1 + flow_init
        return fmap1, fmap2, net, inp, coords1.contiguous()

    def corr_state(self, fmap1, fmap2) -> tuple:
        """What the correlation lookup reads, built once per pair from the
        (B, h, w, C) feature maps, per ``cfg.corr_impl``: the pooled
        correlation pyramid ('volume'), the maps themselves ('onthefly'),
        or the scaled fmap1 and the pooled fmap2 levels, the kernel's
        operands ('pallas'). A tuple of tensors, so a caller can keep it
        in buffers of its own."""
        cfg = self.cfg
        dtype = self.policy.corr
        # On a band of rows the lookup reads the whole fmap2, gathered once
        # per pair (JAX's replicated f2), against the band's fmap1.
        fmap2 = halo.all_gather_rows(fmap2, dim=1)
        if cfg.corr_impl == "volume":
            return build_corr_pyramid(fmap1, fmap2, cfg.corr_levels, dtype).levels
        if cfg.corr_impl == "onthefly":
            return fmap1, fmap2
        # 'pallas': pooling and the 1/sqrt(C) scale happen once per pair.
        f1s, f2_levels = prepare_levels(fmap1, fmap2, cfg.corr_levels, dtype)
        return (f1s, *f2_levels)

    def corr_fn_from(self, state: tuple) -> Callable[[torch.Tensor], torch.Tensor]:
        """The lookup over a :meth:`corr_state`: maps (B, h, w, 2) coords to
        (B, h, w, corr_planes); 'pallas' is one kernel launch a call."""
        cfg = self.cfg
        radius = cfg.resolved_corr_radius
        if cfg.corr_impl == "volume":
            return lambda coords: corr_lookup(CorrPyramid(levels=tuple(state)), coords, radius)
        if cfg.corr_impl == "onthefly":
            return lambda coords: corr_lookup_onthefly(
                state[0], state[1], coords, radius, cfg.corr_levels, self.policy.corr
            )
        return lambda coords: lookup_levels(state[0], list(state[1:]), coords.contiguous(), radius)

    def _build_corr_fn(self, fmap1, fmap2) -> Callable[[torch.Tensor], torch.Tensor]:
        """The correlation-lookup closure over one pair's feature maps."""
        return self.corr_fn_from(self.corr_state(fmap1, fmap2))

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
            # Bilinear resize reads across rows: the whole flow, then banded.
            return halo.on_whole(lambda f: upflow(f, 8, self.cfg.align_corners), flow_lr,
                                 dim=1)
        mask = self.update_block.mask_logits(net).to(up)
        return convex_upsample_nchw(flow_lr.permute(0, 3, 1, 2), mask, 8).permute(0, 2, 3, 1)

    def _step(self, corr_fn, coords0, inp, net, coords1, converged=None, tol=None):
        """One GRU iteration, the single step body of every loop (test,
        train, segments): the lookup, the update block on the flow at the
        GRU state's dtype, and the delta joined to the f32 coordinates.
        Returns ``(net, coords1, converged)``.

        With ``tol``, ``converged`` is the (B,) mask at step entry: those
        rows keep their ``net`` and ``coords1`` (a select, so a row that
        converged after k iterations is bit for bit its state after k),
        and a row converges when its mean |delta| is below ``tol``. The
        iteration that detects convergence still commits its update."""
        corr = corr_fn(coords1)
        flow = (coords1 - coords0).to(net.dtype)
        new_net, delta = self.update_block(
            net, inp, corr.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2)
        )
        delta = delta.permute(0, 2, 3, 1).to(self.policy.coord)
        new_coords = coords1 + delta
        if tol is None:
            return new_net, new_coords, converged
        keep = converged[:, None, None, None]
        new_net = torch.where(keep, net, new_net)
        new_coords = torch.where(keep, coords1, new_coords)
        group = halo.current()
        if group is None:
            dnorm = delta.abs().mean(dim=(1, 2, 3))
        else:
            # A band holds part of each row's pixels: the mean is the
            # group's sum over the whole image's count.
            dnorm = halo.group_sum(delta.abs().sum(dim=(1, 2, 3))) / (
                delta[0].numel() * group.size)
        return new_net, new_coords, converged | (dnorm < tol)

    def _advance(self, carry: dict, iters: int, corr_fn, early_exit_tol=None,
                 stop_early: bool = False) -> dict:
        """``iters`` iterations of :meth:`_step` on a segment carry. With a
        tolerance each row pays an iteration it was active at entry
        (``exec_iters``), and ``stop_early`` ends the loop once every row
        has converged (a read on the host)."""
        net, coords1 = carry["net"], carry["coords1"]
        B, h8, w8, _ = coords1.shape
        coords0 = coords_grid(B, h8, w8, device=coords1.device, y0=halo.first_row(h8))
        converged = carry.get("converged")
        exec_iters = carry.get("exec_iters")
        for _ in range(int(iters)):
            if early_exit_tol is not None and stop_early and bool(converged.all()):
                break
            frozen = converged
            net, coords1, converged = self._step(
                corr_fn, coords0, carry["inp"], net, coords1, converged, early_exit_tol
            )
            if early_exit_tol is not None:
                exec_iters = exec_iters + (~frozen).to(torch.int32)
        out = dict(carry, net=net, coords1=coords1)
        if early_exit_tol is not None:
            out.update(converged=converged, exec_iters=exec_iters)
        return out

    # ----------------------------------------------------------- forward

    @f32_precision()
    def forward(
        self,
        image1: torch.Tensor,
        image2: torch.Tensor,
        iters: int = 12,
        flow_init: Optional[torch.Tensor] = None,
        remat: bool = True,
        net_init: Optional[torch.Tensor] = None,
        net_warm: Optional[torch.Tensor] = None,
        return_net: bool = False,
        early_exit_tol: Optional[float] = None,
        return_exec_iters: bool = False,
        mesh=None,
    ):
        """In eval mode, the test-mode forward: ``(flow_lr, flow_up)``,
        (B, H/8, W/8, 2) and (B, H, W, 2) float32, without gradients, plus
        the final GRU state (B, H/8, W/8, hidden) with ``return_net`` and
        the (B,) int32 executed iterations with ``return_exec_iters``
        (which needs ``early_exit_tol``). In training mode, the train-mode
        forward: the upsampled flow of every iteration, (iters, B, H, W,
        2) float32, each iteration under ``torch.utils.checkpoint`` when
        ``remat``. ``net_init``/``net_warm`` warm-start the GRU in both.

        ``mesh`` (``parallel.mesh.make_mesh``) with a spatial axis above 1
        splits the forward by rows over this rank's spatial group
        (:meth:`_forward_spatial`); every rank of the group passes the same
        whole inputs and gets the same whole outputs in test mode, its band
        of every iteration's prediction in training mode."""
        if mesh is not None and mesh.spatial > 1:
            return self._forward_spatial(mesh, image1, image2, iters, flow_init, remat,
                                         net_init, net_warm, return_net, early_exit_tol,
                                         return_exec_iters)
        if self.training and (early_exit_tol is not None or return_exec_iters or return_net):
            raise ValueError("early_exit_tol, return_exec_iters and return_net require "
                             "test_mode (eval mode)")
        if return_exec_iters and early_exit_tol is None:
            raise ValueError("return_exec_iters requires early_exit_tol (without detection "
                             "every row runs the full budget)")
        if self.training:
            return self._forward_train(image1, image2, iters, flow_init, remat,
                                       net_init, net_warm)
        with torch.no_grad():
            carry = self.encode(image1, image2, flow_init, net_init, net_warm,
                                early_exit=early_exit_tol is not None)
            corr_fn = self._build_corr_fn(carry["fmap1"], carry["fmap2"])
            carry = self._advance(carry, iters, corr_fn, early_exit_tol, stop_early=True)
            result = self.finalize(carry, return_net=return_net)
            if return_exec_iters:
                result = result + (carry["exec_iters"],)
            return result

    def _forward_spatial(self, mesh, image1, image2, iters, flow_init, remat, net_init,
                         net_warm, return_net, early_exit_tol, return_exec_iters):
        """The forward split by rows over this rank's spatial group of
        ``mesh`` (``parallel/halo.py``): this rank takes its band of the
        whole images (and of ``flow_init``, ``net_init``), runs the forward
        on it with halo exchanges at every convolution that reads across
        the band's edges, instance norm over the whole image and the lookup
        on the gathered fmap2. In test mode it gathers the outputs, so every
        rank returns the whole flow (JAX's replicated outputs); the executed
        iterations of early exit are every rank's already. In training mode
        it returns its band of every iteration's prediction (iters, B, H/S,
        W, 2), which the loss reads against its band of the ground truth.
        The height must divide by 8 times the group's size."""
        group = spatial_group(mesh)
        H = image1.shape[1]
        if H % (8 * group.size):
            raise ValueError(f"image height {H} must divide by 8 * spatial = "
                             f"{8 * group.size}; pad with InputPadder(divisor=...) first")
        with halo.spatial(group):
            out = self.forward(halo.band(image1), halo.band(image2), iters,
                               flow_init=halo.band(flow_init), remat=remat,
                               net_init=halo.band(net_init), net_warm=net_warm,
                               return_net=return_net, early_exit_tol=early_exit_tol,
                               return_exec_iters=return_exec_iters)
            if self.training:
                return out
            return tuple(halo.all_gather_rows(t.contiguous(), dim=1) if t.dim() > 1 else t
                         for t in out)

    def _forward_train(self, image1, image2, iters, flow_init, remat, net_init, net_warm):
        fmap1, fmap2, net, inp, coords1 = self._encode(image1, image2, flow_init,
                                                       net_init, net_warm)
        corr_fn = self._build_corr_fn(fmap1, fmap2)
        B, h8, w8, _ = coords1.shape
        coords0 = coords_grid(B, h8, w8, device=coords1.device, y0=halo.first_row(h8))
        group = halo.current()

        def step(net, coords1):
            net, coords1, _ = self._step(corr_fn, coords0, inp, net, coords1.detach())
            return net, coords1, self._upsample(coords1 - coords0, net)

        preds = []
        for _ in range(int(iters)):
            if remat:
                net, coords1, flow_up = checkpoint(
                    step, net, coords1, use_reentrant=False,
                    context_fn=lambda: _remat_contexts(group),
                )
            else:
                net, coords1, flow_up = step(net, coords1)
            preds.append(flow_up)
        return torch.stack(preds)

    # ------------------------------------------------------------ stages

    @f32_precision()
    @torch.no_grad()
    def encode(self, image1, image2, flow_init=None, net_init=None, net_warm=None,
               early_exit: bool = False) -> dict:
        """The test-mode forward before its first iteration, as a segment
        carry with JAX's keys: the state an iteration changes (``net``,
        NCHW, and ``coords1``), the pair's context (``inp``, NCHW, and
        ``fmap1``/``fmap2``, NHWC), and with ``early_exit`` the (B,)
        ``converged`` mask (all False) and ``exec_iters`` (zeros)."""
        fmap1, fmap2, net, inp, coords1 = self._encode(image1, image2, flow_init,
                                                       net_init, net_warm)
        carry = {"net": net, "coords1": coords1, "inp": inp, "fmap1": fmap1, "fmap2": fmap2}
        if early_exit:
            B = net.shape[0]
            carry["converged"] = torch.zeros(B, dtype=torch.bool, device=net.device)
            carry["exec_iters"] = torch.zeros(B, dtype=torch.int32, device=net.device)
        return carry

    @f32_precision()
    @torch.no_grad()
    def refine_segment(self, carry: dict, iters: int, early_exit_tol=None) -> dict:
        """Advance a carry by ``iters`` iterations and return the new carry.
        The lookup is rebuilt from the carry's own feature maps (bit for
        bit the same pyramid every segment). With ``early_exit_tol`` (a
        carry from ``encode(..., early_exit=True)``) the freeze acts per
        iteration, as in the forward, but a row active at the segment's
        entry pays the whole segment, JAX's rule: ``exec_iters`` is
        ``ceil(exec / iters) * iters`` of the forward's."""
        if early_exit_tol is not None and "converged" not in carry:
            raise ValueError("early_exit_tol requires a carry seeded with "
                             "encode(..., early_exit=True)")
        corr_fn = self._build_corr_fn(carry["fmap1"], carry["fmap2"])
        out = self._advance(carry, iters, corr_fn, early_exit_tol)
        if early_exit_tol is not None:
            active = (~carry["converged"]).to(torch.int32)
            out["exec_iters"] = carry["exec_iters"] + int(iters) * active
        return out

    @f32_precision()
    @torch.no_grad()
    def finalize(self, carry: dict, return_net: bool = False):
        """Upsample a finished carry: ``(flow_lr, flow_up)``, plus the GRU
        state (B, H/8, W/8, hidden), NHWC, with ``return_net`` (the warm
        start's hand-off to the next frame)."""
        net, coords1 = carry["net"], carry["coords1"]
        B, h8, w8, _ = coords1.shape
        flow_lr = coords1 - coords_grid(B, h8, w8, device=coords1.device,
                                        y0=halo.first_row(h8))
        flow_up = self._upsample(flow_lr, net).to(self.policy.output)
        if return_net:
            return flow_lr, flow_up, net.permute(0, 2, 3, 1)
        return flow_lr, flow_up


def _remat_contexts(group=None):
    """(forward, recompute) contexts of a checkpointed iteration: the
    recompute leaves BatchNorm's running statistics alone and, on a band of
    rows, runs under the forward's spatial ``group`` (the thread-local
    context is not autograd's thread's), so it exchanges as the forward
    did."""
    return contextlib.nullcontext(), _recompute_context(group)


@contextlib.contextmanager
def _recompute_context(group):
    with frozen_batch_stats(), halo.spatial(group):
        yield
