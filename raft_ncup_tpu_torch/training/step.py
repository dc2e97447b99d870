"""One training step on one card (port of ``make_train_step`` in
``raft_ncup_tpu/parallel/step.py``, without the mesh).

The step runs three phases, each under a ``torch.profiler`` label as the
JAX step's ``jax.named_scope`` labels it:

- ``train.forward`` (:func:`forward_loss`): the model in training mode
  (BatchNorm frozen for every stage but chairs) and the sequence loss;
- ``train.backward`` (:func:`gradients`): the gradient of every
  parameter by ``torch.autograd.grad``;
- ``train.optimizer`` (:func:`apply_update`): the global norm, the
  optimizer's candidate update and the sentinel's select on the device,
  which keeps the old parameters, moments, count and BatchNorm statistics
  on a bad step.

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

from typing import Callable

import torch
from torch.profiler import record_function

from raft_ncup_tpu_torch.config import TrainConfig
from raft_ncup_tpu_torch.training import sentinel as sentinel_mod
from raft_ncup_tpu_torch.training.loss import sequence_loss
from raft_ncup_tpu_torch.training.optim import global_norm
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


@f32_precision()
@cudnn_autotune()
def forward_loss(
    state: TrainState, batch: dict, cfg: TrainConfig, remat: bool = True
) -> tuple[torch.Tensor, dict]:
    """The training-mode forward and the sequence loss (and its metrics).
    Updates the BatchNorm statistics when they train."""
    model = state.model
    model.train()
    if cfg.freeze_bn:
        model.freeze_bn()
    img1 = batch["image1"].to(torch.float32)
    img2 = batch["image2"].to(torch.float32)
    preds = model(img1, img2, iters=cfg.iters, remat=remat)
    return sequence_loss(preds, batch["flow"], batch["valid"], cfg.gamma)


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
    bn_old: list[torch.Tensor],
) -> dict[str, torch.Tensor]:
    """Clip, update, and guard the update with the sentinel: on a bad
    step the parameters, moments and count keep their old values, and the
    BatchNorm statistics go back to ``bn_old`` (theirs from before the
    forward). Returns the metrics it adds."""
    gnorm = global_norm(grads)
    candidate = state.optimizer.update(grads, gnorm)
    bad, state.sentinel = sentinel_mod.judge(state.sentinel, loss, gnorm)
    state.optimizer.commit(*candidate, keep_old=bad)
    with torch.no_grad():
        for buf, old in zip(bn_buffers(state.model), bn_old):
            buf.copy_(torch.where(bad, old, buf))
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
            metrics.update(apply_update(state, loss.detach(), grads, bn_old))
        state.step += 1
        return metrics

    return step
