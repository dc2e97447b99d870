"""The train state (port of ``raft_ncup_tpu/training/state.py``): the
model (parameters and BatchNorm statistics), the optimizer (moments and
update count; under ``freeze_raft`` the upsampler's parameters only),
the step counter and the sentinel's counters. PyTorch
updates them in place; :mod:`training.checkpoint` saves and restores the
whole state, so a resumed run continues exactly."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from raft_ncup_tpu_torch.config import ModelConfig, TrainConfig
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.training.optim import Optimizer
from raft_ncup_tpu_torch.training.sentinel import init_sentinel


@dataclass
class TrainState:
    model: RAFT
    optimizer: Optimizer
    sentinel: dict[str, torch.Tensor]
    # Attempted steps, skipped ones included: the data position.
    step: int = 0

    @property
    def named_params(self) -> list[tuple[str, torch.nn.Parameter]]:
        return list(self.model.named_parameters())


def create_train_state(
    model_cfg: ModelConfig, train_cfg: TrainConfig, device=None
) -> TrainState:
    """The model with weights drawn from ``train_cfg.seed``, a fresh
    optimizer over its parameters, step 0 and a fresh sentinel."""
    model = RAFT(model_cfg, device=device, seed=train_cfg.seed)
    return state_for(model, train_cfg)


def state_for(model: RAFT, train_cfg: TrainConfig) -> TrainState:
    """A step-0 train state around an existing ``model``. Raises when the
    model's precision preset is not ``train_cfg.precision``: the step
    would run one preset while the run's configuration names another."""
    if model.policy.name != train_cfg.precision:
        raise ValueError(
            f"the model's precision preset is {model.policy.name!r} but the train "
            f"configuration's is {train_cfg.precision!r}; they must agree")
    named = list(model.named_parameters())
    trainable = None
    if model.cfg.freeze_raft:
        # Only the upsampler trains (reference: core/raft_nc_dbl.py:70-75).
        trainable = [name.startswith("upsampler.") for name, _ in named]
    opt = Optimizer([p for _, p in named], train_cfg, trainable)
    return TrainState(model=model, optimizer=opt, sentinel=init_sentinel(model.device))
