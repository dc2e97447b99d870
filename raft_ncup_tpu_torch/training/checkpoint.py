"""Save and restore the whole train state (port of
``raft_ncup_tpu/training/checkpoint.py``), warm-start a model's trunk,
and load or write model weights for evaluation.

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

:class:`CheckpointManager` keeps a run directory's ``step_<N>.pt`` files
(the latest five), each written to a temporary file and renamed into
place, with retried writes and a ``resume_meta.json`` that every restore
checks first. Its :meth:`CheckpointManager.restore` writes into the live
state in place (``copy_``), so the tensors that CUDA graphs and the
optimizer hold stay the same objects. :func:`load_pretrained_trunk`
warm-starts the RAFT trunk from a reference ``.pth`` or a port run
directory, as ``--load_pretrained`` does.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import sys
from typing import Optional

import torch
from torch import nn

from raft_ncup_tpu_torch.config import ModelConfig, TrainConfig, UpsamplerConfig
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.resilience.retry import RetryStats, retry_io
from raft_ncup_tpu_torch.training.state import TrainState, state_for

METADATA_FILE = "resume_meta.json"


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
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):  # a failed write leaves no partial file
            os.remove(tmp)
    return path


def _steps(directory: str) -> list[tuple[int, str]]:
    """The ``(N, path)`` of every ``step_<N>.pt`` in ``directory``, by N."""
    found = []
    for f in glob.glob(os.path.join(directory, "step_*.pt")):
        m = re.fullmatch(r"step_(\d+)\.pt", os.path.basename(f))
        if m:
            found.append((int(m.group(1)), f))
    return sorted(found)


def latest(path: str) -> str:
    """``path`` itself when it is a file, else the ``step_<N>.pt`` with the
    largest N in the directory ``path``."""
    if os.path.isfile(path):
        return path
    found = _steps(path)
    if not found:
        raise FileNotFoundError(f"no step_<N>.pt checkpoint under {path!r}")
    return found[-1][1]


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
    return restore_into(state_for(RAFT(saved_model_config(path), device=device), cfg), path)


@torch.no_grad()
def restore_into(state: TrainState, path: str) -> TrainState:
    """Write the train state saved at ``path`` (a file or a run directory)
    into ``state`` in place: the model's parameters and buffers, the
    optimizer's moments and count and the sentinel's counters take the
    saved values by ``copy_``, so every tensor stays the object it was.
    The saved model configuration must be ``state``'s."""
    payload = _load(path)
    saved = _model_cfg(payload["model_cfg"])
    if saved != state.model.cfg:
        raise ValueError(f"{latest(path)} holds another model ({saved}) than the one "
                         f"it is restored into ({state.model.cfg})")
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    for k, v in payload["sentinel"].items():
        state.sentinel[k].copy_(v)
    state.step = int(payload["step"])
    return state


class CheckpointManager:
    """The ``step_<N>.pt`` files of one run directory.

    ``metadata`` (``resilience.preemption.resume_metadata``: variant,
    configuration fingerprint, seed) is written beside the files at every
    save and checked before every restore, so a resume with another
    architecture or seed fails with a clear message. A save writes a
    temporary file and renames it into place; the write retries on
    ``OSError`` with bounded backoff, counted in ``retry_stats``. Only the
    latest ``max_to_keep`` files stay."""

    def __init__(self, directory: str, max_to_keep: int = 5,
                 metadata: Optional[dict] = None, save_retries: int = 2):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._metadata = dict(metadata) if metadata else None
        self._save_retries = save_retries
        self.retry_stats = RetryStats()

    def _retry(self, fn, desc: str):
        return retry_io(fn, attempts=self._save_retries, base_delay_s=0.2,
                        stats=self.retry_stats, desc=desc, log=self._log_retry)

    @staticmethod
    def _log_retry(msg: str) -> None:
        print(f"CheckpointManager {msg}", file=sys.stderr)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def save(self, state: TrainState, cfg: TrainConfig) -> str:
        """Write ``state`` as ``step_<state.step>.pt``, the metadata beside
        it, and drop the files beyond the latest ``max_to_keep``."""
        path = self.path(state.step)
        self._retry(lambda: save(state, cfg, path), f"checkpoint save @{state.step}")
        self._write_metadata()
        for _, old in _steps(self.directory)[:-self.max_to_keep]:
            os.remove(old)
        return path

    def _write_metadata(self) -> None:
        if self._metadata is None:
            return
        path = os.path.join(self.directory, METADATA_FILE)

        def write() -> None:
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(self._metadata, f, indent=2, sort_keys=True)
                f.write("\n")
            os.replace(tmp, path)

        self._retry(write, "resume-metadata write")

    def saved_metadata(self) -> Optional[dict]:
        path = os.path.join(self.directory, METADATA_FILE)
        if not os.path.exists(path):
            return None
        with open(path, encoding="utf-8") as f:
            return json.load(f)

    def verify_metadata(self) -> None:
        """Raise, naming each field, when the directory's metadata differs
        from this run's."""
        saved = self.saved_metadata()
        if self._metadata is None or saved is None:
            return
        mismatch = {k: (saved[k], v) for k, v in self._metadata.items()
                    if k in saved and saved[k] != v}
        if mismatch:
            detail = "; ".join(f"{k}: checkpoint has {a!r}, this run expects {b!r}"
                               for k, (a, b) in sorted(mismatch.items()))
            raise ValueError(
                f"refusing to restore from {self.directory}: resume metadata mismatch "
                f"({detail}); restore with the checkpointed run's model flags and seed")

    @property
    def latest_step(self) -> Optional[int]:
        found = _steps(self.directory)
        return found[-1][0] if found else None

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Check the metadata, then write the latest (or ``step``'s) saved
        state into ``state`` in place (:func:`restore_into`)."""
        self.verify_metadata()
        step = self.latest_step if step is None else step
        if step is None:
            raise FileNotFoundError(f"no step_<N>.pt checkpoint under {self.directory!r}")
        return restore_into(state, self.path(step))


def _allowed_source_keys(model: RAFT) -> list[str]:
    """Patterns of source keys a warm start may leave unmatched: the
    upsampler (the trunk only is loaded) and, when ``model`` has no mask
    head, a stock RAFT's (the reference loads it, then deletes it)."""
    allow = [r"^upsampler\."]
    if not any(k.startswith("update_block.mask.") for k in model.state_dict()):
        allow.append(r"^update_block\.mask\.")
    return allow


@torch.no_grad()
def load_pretrained_trunk(path: str, model: RAFT) -> RAFT:
    """Warm-start ``model``'s RAFT trunk from ``path``, as ``--load_pretrained``
    does (reference: core/raft_nc_dbl.py:57-66); the upsampler keeps its
    initial values either way, and ``num_batches_tracked`` its own.

    - A reference ``.pth`` file (JAX ``checkpoint.py:248-269``): every key
      but the reference's second names of a tensor must name a tensor of
      the trunk; a stock RAFT's mask head may go unmatched only when
      ``model`` has none.
    - A port run directory or ``step_<N>.pt`` (JAX ``_merge_trunk``): its
      model's tensors are merged by name; keys with no destination are
      allowed, but a top-level component (``fnet``, ``cnet``, ...) that
      matches nothing raises.

    A shape mismatch raises. The values are copied into the model's
    tensors. Returns ``model``."""
    dest = model.state_dict()
    merged = dict(dest)
    if os.path.isdir(path) or path.endswith(".pt"):
        source = _load(path)["model"]
        matched, seen = set(), set()
        for key, val in source.items():
            top = key.split(".")[0]
            if top == "upsampler" or key.endswith("num_batches_tracked"):
                continue
            seen.add(top)
            if key in dest:
                _check_shape(key, val, dest[key])
                merged[key] = val
                matched.add(top)
        if seen - matched:
            raise ValueError(f"{path}: pretrained components matched nothing in the "
                             f"destination model: {sorted(seen - matched)}")
    else:
        source = torch.load(path, map_location="cpu", weights_only=True)
        source = {k.removeprefix("module."): v for k, v in source.items()}
        aliases = reference_aliases(model)
        allow = [re.compile(p) for p in _allowed_source_keys(model)]
        unmatched = []
        for key, val in source.items():
            if key in aliases or key.endswith("num_batches_tracked"):
                continue
            if key in dest and not key.startswith("upsampler."):
                _check_shape(key, val, dest[key])
                merged[key] = val
            elif not any(p.search(key) for p in allow):
                unmatched.append(key)
        if unmatched:
            raise KeyError(f"{path}: {len(unmatched)} keys name nothing in the model, "
                           f"e.g. {unmatched[:5]}")
    model.load_state_dict(merged, strict=True)
    return model


def _check_shape(key: str, val: torch.Tensor, want: torch.Tensor) -> None:
    if tuple(val.shape) != tuple(want.shape):
        raise ValueError(f"shape mismatch for {key}: {tuple(val.shape)} in the checkpoint, "
                         f"{tuple(want.shape)} in the model")


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
