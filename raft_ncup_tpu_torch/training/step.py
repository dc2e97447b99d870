"""One training step (port of ``make_train_step`` and ``make_eval_step`` in
``raft_ncup_tpu/parallel/step.py``), on one card or data-parallel across
processes, one per card (``mesh=``, ``parallel.mesh.make_mesh``).

The step runs three phases, each under a ``torch.profiler`` label as the
JAX step's ``jax.named_scope`` labels it:

- ``train.forward`` (:func:`forward_loss`): with ``add_noise`` Gaussian
  noise on both frames (its stddev drawn from U(0, 5) per step), the
  model in training mode (BatchNorm frozen for every stage but chairs,
  encoder dropout when configured) and the sequence loss at the
  configuration's ``max_flow``;
- ``train.backward`` (:func:`gradients`): the gradient of every
  parameter by ``torch.autograd.grad``;
- ``train.optimizer`` (:func:`apply_update`): the global norm, the
  optimizer's candidate update and, with ``anomaly_sentinel``, the
  sentinel's select on the device, which keeps the old parameters,
  moments, count and BatchNorm statistics on a bad step.

The noise and the dropout masks draw from generators on the model's
device seeded from ``(seed, step)`` (:func:`step_generators`), so a
resumed run draws what an uninterrupted one would. Under ``freeze_raft``
the backward still computes every parameter's gradient: the ``grad_norm``
metric and the sentinel read the norm of all of them, as the JAX step's
``optax.global_norm(grads)`` does, while the clip reads the trainable
(upsampler) gradients' norm only.

With a mesh, each rank runs its rows of the global batch (the rows
``rank::data``, ``parallel.mesh.batch_sharding``) through the forward and
the backward, then ``train.allreduce`` (:func:`reduce_across_ranks`) sums
in one collective a flat buffer of the gradients, the loss and the
metrics' sums and valid-pixel count: the gradients and the loss are
averaged over the ranks (each rank's loss is a mean over the same number
of elements), the metrics divided by the global count, so every rank
holds the values JAX's step computes on the global batch, and the
gradient norm, the clip, AdamW and the sentinel read those on every rank
alike: the ranks' parameters stay equal, and a bad step is bad on all of
them. The noise and the dropout masks are drawn at the global batch's
shape and the rank's rows taken, as JAX's sharded
``jax.random.normal(k1, img1.shape)`` does, and BatchNorm, while it
trains (stage chairs), takes its statistics over the global batch
(``nn.layers.synced_batch_stats``), with a differentiable sum over the
ranks; the recompute of a checkpointed iteration issues the same
collectives on every rank, in the same order.

With a spatial axis above 1 (a mesh ``(data, spatial)``) every rank of a
data index holds the same rows of the global batch, whole images, and
draws the same noise; the model runs on its band of rows
(``RAFT.forward(..., mesh=...)``, the halo exchanges differentiable), the
loss and the metrics' sums read its band of the ground truth (the loss as
the band's share of the whole image's mean), and BatchNorm's statistics
span the global batch's pixels (the sync-BN sum runs over the world,
data times spatial). Each rank's gradient is then its part of the
gradient of the group's summed loss, and the one reduction over the world
sums them over the spatial group and averages them over the data indices.

The forward and the backward (with the recompute that remat runs
inside it) keep TF32 off (``utils.device.f32_precision``), as the
model's forward does: cuDNN's convolutions would otherwise take TF32 in
the backward. Both run with cuDNN's autotuner on
(``utils.device.cudnn_autotune``). The metrics come back as 0-d tensors
on the device: the step reads nothing back to the host (under gloo with
card tensors, the reduction's round trip through the host is the one
named read, ``analysis.guards.collective_read``).

Under ``bf16_train`` (``TrainConfig.precision``, which the train entry sets
from the same ``--precision`` flag as the model's configuration) the model computes in bf16 with f32
master weights, as the JAX package's preset does: its convolutions cast
their f32 parameters at use, so the gradients autograd returns, the
optimizer's moments, the loss (from the f32 flow), the gradient norm and
the sentinel's arithmetic all stay f32 with no cast here.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from raft_ncup_tpu_torch.config import TrainConfig
from raft_ncup_tpu_torch.nn.layers import synced_batch_stats
from raft_ncup_tpu_torch.parallel import multihost
from raft_ncup_tpu_torch.parallel import halo
from raft_ncup_tpu_torch.parallel.mesh import Mesh, data_group, spatial_group
from raft_ncup_tpu_torch.training import sentinel as sentinel_mod
from raft_ncup_tpu_torch.training.loss import finalize_metrics, sequence_loss_sums
from raft_ncup_tpu_torch.training.optim import global_norm, select_into
from raft_ncup_tpu_torch.training.state import TrainState
from raft_ncup_tpu_torch.utils.device import cudnn_autotune, f32_precision

PHASES = ("train.forward", "train.backward", "train.optimizer")
ALLREDUCE_PHASE = "train.allreduce"


def bn_buffers(model: torch.nn.Module) -> list[torch.Tensor]:
    """Every BatchNorm statistic of ``model``: running mean, variance and
    count."""
    return [
        buf for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)
        for buf in (m.running_mean, m.running_var, m.num_batches_tracked)
    ]


def step_generators(seed: int, step: int, device) -> tuple[torch.Generator, torch.Generator]:
    """The (noise, dropout) generators of step ``step``, on ``device``,
    seeded from ``(seed, step)`` only."""
    seeds = np.random.SeedSequence([int(seed), int(step)]).generate_state(2, np.uint64)
    return tuple(torch.Generator(device=device).manual_seed(int(s) & 0x7FFF_FFFF_FFFF_FFFF)
                 for s in seeds)


def noisy(img: torch.Tensor, stdv: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """``clip(img + stdv * noise, 0, 255)``: the JAX step's ``add_noise``
    arithmetic, given its draws."""
    return torch.clamp(img + stdv * noise, 0.0, 255.0)


def global_rows(shape, gen: torch.Generator, device, mesh: Optional[Mesh]) -> torch.Tensor:
    """Standard normal draws of ``shape``; with a mesh, drawn at the global
    batch's shape (``shape[0] * data`` rows) and the data index's rows
    ``data_index::data`` taken (every spatial rank of a data index draws
    the same)."""
    if mesh is None:
        return torch.randn(shape, generator=gen, device=device)
    full = torch.randn((shape[0] * mesh.data,) + tuple(shape[1:]), generator=gen, device=device)
    return full.view(shape[0], mesh.data, *shape[1:])[:, mesh.data_index]


def add_noise(img1: torch.Tensor, img2: torch.Tensor, gen: torch.Generator,
              mesh: Optional[Mesh] = None):
    """Both frames with Gaussian noise of one stddev drawn from U(0, 5)
    (reference: train.py:210-213), drawn from ``gen`` (with a mesh, the
    rank's rows of the global batch's draws)."""
    stdv = 5.0 * torch.rand((), generator=gen, device=img1.device)
    n1 = global_rows(img1.shape, gen, img1.device, mesh)
    n2 = global_rows(img2.shape, gen, img2.device, mesh)
    return noisy(img1, stdv, n1), noisy(img2, stdv, n2)


@f32_precision()
@cudnn_autotune()
def forward_loss_sums(
    state: TrainState, batch: dict, cfg: TrainConfig, remat: bool = True,
    step: Optional[int] = None, mesh: Optional[Mesh] = None,
) -> tuple[torch.Tensor, dict]:
    """The training-mode forward, the sequence loss and the metrics' sums
    and valid count (``training.loss.sequence_loss_sums``). Updates the
    BatchNorm statistics when they train. The noise and the dropout masks
    draw from :func:`step_generators` of ``step`` (default:
    ``state.step``), with a mesh at the global batch's shape. With a
    spatial axis above 1 the model runs on this rank's band of rows and the
    loss and the sums read its band of the ground truth: the loss is the
    band's share of the whole image's mean, so the group's sum is the one-
    process loss."""
    model = state.model
    model.train()
    if cfg.freeze_bn:
        model.freeze_bn()
    img1 = batch["image1"].to(torch.float32)
    img2 = batch["image2"].to(torch.float32)
    noise_gen, drop_gen = step_generators(cfg.seed, state.step if step is None else step,
                                          img1.device)
    if cfg.add_noise:
        img1, img2 = add_noise(img1, img2, noise_gen, mesh)
    model.dropout_generator = drop_gen
    model.dropout_rows = None if mesh is None else (mesh.data_index, mesh.data)
    try:
        preds = model(img1, img2, iters=cfg.iters, remat=remat, mesh=mesh)
    finally:
        model.dropout_generator = None
        model.dropout_rows = None
    flow, valid = batch["flow"], batch["valid"]
    shards = 1
    if mesh is not None and mesh.spatial > 1:
        with halo.spatial(spatial_group(mesh)):
            flow, valid = halo.band(flow), halo.band(valid)
        shards = mesh.spatial
    return sequence_loss_sums(preds, flow, valid, cfg.gamma, cfg.max_flow, shards=shards)


def forward_loss(
    state: TrainState, batch: dict, cfg: TrainConfig, remat: bool = True,
    step: Optional[int] = None,
) -> tuple[torch.Tensor, dict]:
    """The training-mode forward and the sequence loss (and its metrics):
    :func:`forward_loss_sums` on one card, its sums divided."""
    loss, sums = forward_loss_sums(state, batch, cfg, remat, step)
    return loss, finalize_metrics(sums)


@f32_precision()
@cudnn_autotune()
def gradients(state: TrainState, loss: torch.Tensor) -> list[torch.Tensor]:
    """The gradient of ``loss`` for every parameter, in
    ``state.named_params`` order (zeros for one the loss does not reach)."""
    params = [p for _, p in state.named_params]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def apply_update(
    state: TrainState, loss: torch.Tensor, grads: list[torch.Tensor],
    bn_old: list[torch.Tensor], cfg: TrainConfig,
) -> dict[str, torch.Tensor]:
    """Clip, update, and (with ``cfg.anomaly_sentinel``) guard the update
    with the sentinel: on a bad step the parameters, moments and count
    keep their old values, and the BatchNorm statistics go back to
    ``bn_old`` (theirs from before the forward). ``grad_norm`` is the norm
    of every gradient; the clip reads the trainable ones'. Returns the
    metrics it adds."""
    opt = state.optimizer
    gnorm = global_norm(grads)
    clip_norm = gnorm if len(opt.params) == len(grads) else opt.clip_norm(grads)
    candidate = opt.update(grads, clip_norm)
    if cfg.anomaly_sentinel:
        bad, state.sentinel = sentinel_mod.judge(state.sentinel, loss, gnorm, cfg)
    else:
        bad = torch.zeros((), dtype=torch.bool, device=loss.device)
    opt.commit(*candidate, keep_old=bad)
    buffers = bn_buffers(state.model)
    if buffers:
        select_into(buffers, bn_old, ~bad)  # the old statistics where bad
    return {"loss": loss, "grad_norm": gnorm, "bad_step": bad.to(torch.float32)}


@torch.no_grad()
def reduce_across_ranks(
    loss: torch.Tensor, sums: dict, grads: list[torch.Tensor], mesh: Mesh,
) -> tuple[torch.Tensor, dict, list[torch.Tensor]]:
    """One all-reduce over the world of a flat buffer of the gradients, the
    loss and the metrics' sums and count: (the loss and gradients summed
    over the spatial group and averaged over the data indices, the global
    metrics, the gradients in their shapes)."""
    keys = sorted(sums)
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [loss.reshape(1).to(torch.float32)]
                     + [sums[k].reshape(1).to(torch.float32) for k in keys])
    multihost.all_reduce_(flat)
    n = sum(g.numel() for g in grads)
    flat[:n + 1].div_(mesh.data)
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view_as(g))
        i += g.numel()
    total = dict(zip(keys, flat[n + 1:]))
    return flat[n], finalize_metrics(total), out


def loss_and_grads(
    state: TrainState, batch: dict, cfg: TrainConfig, remat: bool = True
) -> tuple[torch.Tensor, dict, list[torch.Tensor]]:
    """Forward and backward: (loss, metrics, gradients)."""
    loss, metrics = forward_loss(state, batch, cfg, remat)
    return loss.detach(), metrics, gradients(state, loss)


def make_train_step(
    cfg: TrainConfig, remat: bool = True, mesh: Optional[Mesh] = None,
) -> Callable[[TrainState, dict], dict[str, torch.Tensor]]:
    """``step(state, batch) -> metrics``. ``batch``: image1 / image2
    (B, H, W, 3) uint8 or float32 in [0, 255], flow (B, H, W, 2), valid
    (B, H, W), on the model's device: with ``mesh``, the data index's rows
    of the global batch, the whole images on every spatial rank of it.
    Updates ``state`` in place; with a mesh every rank returns the global
    metrics."""

    def step(state: TrainState, batch: dict) -> dict[str, torch.Tensor]:
        bn_old = [b.clone() for b in bn_buffers(state.model)]
        synced = (synced_batch_stats(state.model, multihost.all_reduce_grad)
                  if mesh is not None else contextlib.nullcontext())
        with synced:
            with record_function(PHASES[0]):
                loss, sums = forward_loss_sums(state, batch, cfg, remat, mesh=mesh)
            with record_function(PHASES[1]):
                grads = gradients(state, loss)
        loss = loss.detach()
        if mesh is None:
            metrics = finalize_metrics(sums)
        else:
            with record_function(ALLREDUCE_PHASE):
                loss, metrics, grads = reduce_across_ranks(loss, sums, grads, mesh)
        with record_function(PHASES[2]):
            metrics.update(apply_update(state, loss, grads, bn_old, cfg))
        state.step += 1
        return metrics

    return step


def make_eval_step(model, iters: int, mesh: Optional[Mesh] = None):
    """``eval_step(image1, image2) -> (flow_lr, flow_up)``: the test-mode
    forward of ``model`` (JAX ``make_eval_step``). With ``mesh`` each data
    index passes its rows of the global batch and gets the global batch's
    outputs back, in its row order, on every rank (JAX's replicated
    outputs), gathered by one sum over the data indices of zero-filled
    buffers; the spatial ranks of a data index split its forward by rows
    (``RAFT.forward(..., mesh=...)``)."""

    @torch.no_grad()
    def eval_step(image1: torch.Tensor, image2: torch.Tensor):
        model.eval()
        flow_lr, flow_up = model(image1, image2, iters=iters, mesh=mesh)
        if mesh is None:
            return flow_lr, flow_up
        return tuple(_gather_rows(t, mesh) for t in (flow_lr, flow_up))

    return eval_step


def _gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    full = t.new_zeros((t.shape[0] * mesh.data,) + tuple(t.shape[1:]))
    full.view(t.shape[0], mesh.data, *t.shape[1:])[:, mesh.data_index] = t
    return multihost.all_reduce_(full, group=data_group(mesh))
