"""Save and restore the whole train state (port of
``raft_ncup_tpu/training/checkpoint.py``'s resume path).

One ``torch.save`` file per save, ``<checkpoint_dir>/<name>/step_<N>.pt``:
the step, the model's state dict (parameters and BatchNorm statistics),
the optimizer's moments and count, the sentinel's counters and both
configurations. :func:`restore` rebuilds the model from the saved
configuration, so a resumed run continues exactly where the saved one
stood. The file is read with ``weights_only=True``: tensors, numbers,
strings and containers only.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re

import torch

from raft_ncup_tpu_torch.config import ModelConfig, TrainConfig, UpsamplerConfig
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.training.state import TrainState, state_for


def checkpoint_path(cfg: TrainConfig, step: int) -> str:
    return os.path.join(cfg.checkpoint_dir, cfg.name, f"step_{step}.pt")


def save(state: TrainState, cfg: TrainConfig, path: str | None = None) -> str:
    """Write ``state`` (atomically: a temporary file, then a rename) and
    return the path."""
    path = path or checkpoint_path(cfg, state.step)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "step": int(state.step),
        "model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
        "optimizer": {
            k: ([t.cpu() for t in v] if isinstance(v, list) else v.cpu())
            for k, v in state.optimizer.state_dict().items()
        },
        "sentinel": {k: v.cpu() for k, v in state.sentinel.items()},
        "model_cfg": dataclasses.asdict(state.model.cfg),
        "train_cfg": dataclasses.asdict(cfg),
    }
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def latest(path: str) -> str:
    """``path`` itself when it is a file, else the ``step_<N>.pt`` with the
    largest N in the directory ``path``."""
    if os.path.isfile(path):
        return path
    found = []
    for f in glob.glob(os.path.join(path, "step_*.pt")):
        m = re.fullmatch(r"step_(\d+)\.pt", os.path.basename(f))
        if m:
            found.append((int(m.group(1)), f))
    if not found:
        raise FileNotFoundError(f"no step_<N>.pt checkpoint under {path!r}")
    return max(found)[1]


def _model_cfg(d: dict) -> ModelConfig:
    ups = {k: tuple(v) if isinstance(v, list) else v for k, v in d["upsampler"].items()}
    return ModelConfig(**{**d, "upsampler": UpsamplerConfig(**ups)})


def _load(path: str) -> dict:
    return torch.load(latest(path), map_location="cpu", weights_only=True)


def saved_model_config(path: str) -> ModelConfig:
    """The model configuration saved at ``path`` (a file or a run
    directory)."""
    return _model_cfg(_load(path)["model_cfg"])


def restore(path: str, cfg: TrainConfig, device=None) -> TrainState:
    """The train state saved at ``path`` (a file or a run directory), on
    ``device``, with ``cfg``'s optimizer and schedule. Raises when
    ``cfg.precision`` is not the saved model's preset."""
    payload = _load(path)
    model = RAFT(_model_cfg(payload["model_cfg"]), device=device)
    model.load_state_dict(payload["model"], strict=True)
    state = state_for(model, cfg)
    opt = payload["optimizer"]
    state.optimizer.load_state_dict({
        "mu": [t.to(model.device) for t in opt["mu"]],
        "nu": [t.to(model.device) for t in opt["nu"]],
        "count": opt["count"].to(model.device),
    })
    state.step = int(payload["step"])
    state.sentinel = {k: v.to(model.device) for k, v in payload["sentinel"].items()}
    return state
