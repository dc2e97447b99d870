"""Save and restore the whole train state (port of
``raft_ncup_tpu/training/checkpoint.py``'s resume path), and load or
write model weights for evaluation.

One ``torch.save`` file per save, ``<checkpoint_dir>/<name>/step_<N>.pt``:
the step, the model's state dict (parameters and BatchNorm statistics),
the optimizer's moments and count, the sentinel's counters and both
configurations. :func:`restore` rebuilds the model from the saved
configuration, so a resumed run continues exactly where the saved one
stood. The file is read with ``weights_only=True``: tensors, numbers,
strings and containers only. :func:`load_model_weights` takes only the
model's weights from such a file.

The reference's ``.pth`` (what the JAX package's ``--export_pth`` and
``utils/torch_export.save_torch_checkpoint`` write) holds a
``DataParallel`` state dict: keys prefixed ``module.``, and some tensors
under two names each, as the reference's modules register them: a
residual block's downsample norm also as ``norm<N>`` (N one past the
block's last conv), and the NConv U-Net's shared encoder stages as
``encoder.0.0`` (``nconv_in``), ``encoder.0.1.<j>`` (``nconv_x2.<j>``) and
``encoder.<s>`` (``nconv_x2.0``, for each of its downsamplings). The
port holds each tensor once; :func:`reference_aliases` names the second
names, :func:`load_reference_pth` accepts exactly the reference's key
set and :func:`save_reference_pth` writes it.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re

import torch
from torch import nn

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


def load_model_weights(model: RAFT, path: str) -> RAFT:
    """Load the model weights of a train state saved by :func:`save` (a
    ``step_<N>.pt`` file or a run directory) into ``model``, strictly;
    returns ``model``."""
    model.load_state_dict(_load(path)["model"], strict=True)
    return model


def reference_aliases(model: nn.Module) -> dict[str, str]:
    """The reference's second names of the port's tensors: ``{alias key:
    port key}``, for ``model``'s state dict."""
    keys = list(model.state_dict())
    aliases = {}
    for key in keys:
        m = re.fullmatch(r"(.+)\.downsample\.1\.(\w+)", key)
        if m is None:
            continue
        block, leaf = m.groups()
        convs = [int(c.group(1)) for k in keys
                 if (c := re.fullmatch(re.escape(block) + r"\.conv(\d+)\.weight", k))]
        aliases[f"{block}.norm{max(convs) + 1}.{leaf}"] = key
    nets = sorted({k[:k.index("interpolation_net") + len("interpolation_net")]
                   for k in keys if "interpolation_net." in k})
    for net in nets:
        sub = [k[len(net) + 1:] for k in keys if k.startswith(net + ".")]
        x2 = sorted({int(m.group(1)) for k in sub if (m := re.match(r"nconv_x2\.(\d+)\.", k))})
        n_down = len({m.group(1) for k in sub if (m := re.match(r"decoder\.(\d+)\.", k))})
        pairs = [("encoder.0.0", "nconv_in")]
        pairs += [(f"encoder.0.1.{j}", f"nconv_x2.{j}") for j in x2]
        pairs += [(f"encoder.{s}", "nconv_x2.0") for s in range(1, n_down + 1)
                  if not any(k.startswith(f"encoder.{s}.") for k in sub)]
        for dst, src in pairs:
            for k in sub:
                if k.startswith(src + "."):
                    aliases[f"{net}.{dst}{k[len(src):]}"] = f"{net}.{k}"
    return aliases


def load_reference_pth(model: RAFT, path: str) -> RAFT:
    """Load a reference ``.pth`` into ``model`` strictly: strip the
    ``module.`` prefix, then the keys must be exactly the port's keys and
    their reference aliases (:func:`reference_aliases`), and each alias must
    equal its original. A missing or a stray key raises, as the
    reference's strict load does. Returns ``model``."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    state = {k.removeprefix("module."): v for k, v in state.items()}
    aliases = reference_aliases(model)
    want = set(model.state_dict()) | set(aliases)
    missing, stray = sorted(want - set(state)), sorted(set(state) - want)
    if missing or stray:
        raise KeyError(f"{path}: not this model's reference state dict; missing keys "
                       f"{missing[:8]}{'...' if len(missing) > 8 else ''}, unexpected keys "
                       f"{stray[:8]}{'...' if len(stray) > 8 else ''}")
    for alias, key in aliases.items():
        if not torch.equal(state[alias], state[key]):
            raise ValueError(f"{path}: {alias} differs from {key}, which it names again")
    model.load_state_dict({k: v for k, v in state.items() if k not in aliases}, strict=True)
    return model


def save_reference_pth(model: nn.Module, path: str, data_parallel: bool = True) -> str:
    """Write ``model``'s weights as a reference ``.pth``: every key the
    reference's strict load expects, aliases included, prefixed
    ``module.`` when ``data_parallel``. Returns ``path``."""
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    state.update({alias: state[key] for alias, key in reference_aliases(model).items()})
    prefix = "module." if data_parallel else ""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({prefix + k: v for k, v in state.items()}, path)
    return path
