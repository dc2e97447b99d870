"""One training step on one card (port of ``make_train_step`` in
``raft_ncup_tpu/parallel/step.py``, without the mesh).

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

The forward and the backward (with the recompute that remat runs
inside it) keep TF32 off (``utils.device.f32_precision``), as the
model's forward does: cuDNN's convolutions would otherwise take TF32 in
the backward. Both run with cuDNN's autotuner on
(``utils.device.cudnn_autotune``). The metrics come back as 0-d tensors
on the device: the step reads nothing back to the host.

Under ``bf16_train`` (``TrainConfig.precision``, which the train entry sets
from the same ``--precision`` flag as the model's configuration) the model computes in bf16 with f32
master weights, as the JAX package's preset does: its convolutions cast
their f32 parameters at use, so the gradients autograd returns, the
optimizer's moments, the loss (from the f32 flow), the gradient norm and
the sentinel's arithmetic all stay f32 with no cast here.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from raft_ncup_tpu_torch.config import TrainConfig
from raft_ncup_tpu_torch.training import sentinel as sentinel_mod
from raft_ncup_tpu_torch.training.loss import sequence_loss
from raft_ncup_tpu_torch.training.optim import global_norm, select_into
from raft_ncup_tpu_torch.training.state import TrainState
from raft_ncup_tpu_torch.utils.device import cudnn_autotune, f32_precision

PHASES = ("train.forward", "train.backward", "train.optimizer")


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


def add_noise(img1: torch.Tensor, img2: torch.Tensor, gen: torch.Generator):
    """Both frames with Gaussian noise of one stddev drawn from U(0, 5)
    (reference: train.py:210-213), drawn from ``gen``."""
    stdv = 5.0 * torch.rand((), generator=gen, device=img1.device)
    n1 = torch.randn(img1.shape, generator=gen, device=img1.device)
    n2 = torch.randn(img2.shape, generator=gen, device=img2.device)
    return noisy(img1, stdv, n1), noisy(img2, stdv, n2)


@f32_precision()
@cudnn_autotune()
def forward_loss(
    state: TrainState, batch: dict, cfg: TrainConfig, remat: bool = True,
    step: Optional[int] = None,
) -> tuple[torch.Tensor, dict]:
    """The training-mode forward and the sequence loss (and its metrics).
    Updates the BatchNorm statistics when they train. The noise and the
    dropout masks draw from :func:`step_generators` of ``step`` (default:
    ``state.step``)."""
    model = state.model
    model.train()
    if cfg.freeze_bn:
        model.freeze_bn()
    img1 = batch["image1"].to(torch.float32)
    img2 = batch["image2"].to(torch.float32)
    noise_gen, drop_gen = step_generators(cfg.seed, state.step if step is None else step,
                                          img1.device)
    if cfg.add_noise:
        img1, img2 = add_noise(img1, img2, noise_gen)
    model.dropout_generator = drop_gen
    try:
        preds = model(img1, img2, iters=cfg.iters, remat=remat)
    finally:
        model.dropout_generator = None
    return sequence_loss(preds, batch["flow"], batch["valid"], cfg.gamma, cfg.max_flow)


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


def loss_and_grads(
    state: TrainState, batch: dict, cfg: TrainConfig, remat: bool = True
) -> tuple[torch.Tensor, dict, list[torch.Tensor]]:
    """Forward and backward: (loss, metrics, gradients)."""
    loss, metrics = forward_loss(state, batch, cfg, remat)
    return loss.detach(), metrics, gradients(state, loss)


def make_train_step(
    cfg: TrainConfig, remat: bool = True
) -> Callable[[TrainState, dict], dict[str, torch.Tensor]]:
    """``step(state, batch) -> metrics``. ``batch``: image1 / image2
    (B, H, W, 3) uint8 or float32 in [0, 255], flow (B, H, W, 2), valid
    (B, H, W), on the model's device. Updates ``state`` in place."""

    def step(state: TrainState, batch: dict) -> dict[str, torch.Tensor]:
        bn_old = [b.clone() for b in bn_buffers(state.model)]
        with record_function(PHASES[0]):
            loss, metrics = forward_loss(state, batch, cfg, remat)
        with record_function(PHASES[1]):
            grads = gradients(state, loss)
        with record_function(PHASES[2]):
            metrics.update(apply_update(state, loss.detach(), grads, bn_old, cfg))
        state.step += 1
        return metrics

    return step
