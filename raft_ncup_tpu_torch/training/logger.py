"""Training metrics to stdout and ``<run_dir>/log.txt`` (port of
``raft_ncup_tpu/training/logger.py``, without TensorBoard).

Metrics are summed on the device as they arrive and read back once per
``sum_freq`` steps, with the learning rate, through the sanctioned
``analysis.guards.host_read``, so the steps between two summaries read
nothing back to the host (``--strict_guards`` holds the loop to that). The window means, the steps per second and the learning rate
of that one read also land as telemetry gauges (``train_<metric>``,
``train_steps_per_sec``, ``train_lr``): host floats, no further read.

Under data parallelism only the main process logs (``active``, JAX's
``Logger(active=is_main_process())``): every rank holds the same global
metrics, and an inactive logger reads, prints and writes nothing."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping, Optional

import torch

from raft_ncup_tpu_torch.analysis.guards import host_read
from raft_ncup_tpu_torch.observability import get_telemetry


class Logger:
    def __init__(self, run_dir: str, config: Any = None, sum_freq: int = 100,
                 active: bool = True):
        self.run_dir = run_dir
        self.sum_freq = sum_freq
        self.active = active
        if not active:
            return
        os.makedirs(run_dir, exist_ok=True)
        self._txt = open(os.path.join(run_dir, "log.txt"), "a")
        self._acc: dict[str, torch.Tensor] = {}
        self._n = 0
        self._t_last = time.perf_counter()
        self._steps_last: Optional[int] = None
        if config is not None:
            self.write_text(json.dumps(config, sort_keys=True, default=str))

    def write_text(self, text: str) -> None:
        if not self.active:
            return
        self._txt.write(text + "\n")
        self._txt.flush()

    def push(self, step: int, metrics: Mapping[str, torch.Tensor],
             lr: Optional[torch.Tensor] = None) -> None:
        """Add one step's metrics (``step`` counted from 0); every
        ``sum_freq`` steps print and log their means."""
        if not self.active:
            return
        for k, v in metrics.items():
            v = v.detach().to(torch.float32)
            self._acc[k] = v if k not in self._acc else self._acc[k] + v
        self._n += 1
        if self._steps_last is None:
            self._steps_last = step
        if (step + 1) % self.sum_freq:
            return
        keys = sorted(self._acc)
        window = [self._acc[k] for k in keys]
        lr_on_device = isinstance(lr, torch.Tensor)
        if lr_on_device:
            window.append(lr.detach().to(torch.float32).reshape(()))
        vals = [float(v) for v in host_read(torch.stack(window))]  # the window's one read
        lr = vals.pop() if lr_on_device else (None if lr is None else float(lr))
        means = {k: v / self._n for k, v in zip(keys, vals)}
        now = time.perf_counter()
        sps = (step + 1 - self._steps_last) / max(now - self._t_last, 1e-9)
        self._acc, self._n = {}, 0
        self._t_last, self._steps_last = now, step + 1
        tel = get_telemetry()
        for k, v in means.items():
            tel.gauge_set(f"train_{k}", v)
        tel.gauge_set("train_steps_per_sec", sps)
        if lr is not None:
            tel.gauge_set("train_lr", lr)
        parts = [f"[{step + 1:6d}"]
        if lr is not None:
            parts.append(f"lr {lr:.2e}")
        parts.append(f"{sps:5.2f} it/s]")
        parts += [f"{k} {v:.4f}" for k, v in means.items()]
        line = " ".join(parts)
        print(line, flush=True)
        self.write_text(line)

    def write_dict(self, step: int, results: Mapping[str, float]) -> None:
        """Print and log one validation's results (reference:
        train.py:151-161)."""
        if not self.active:
            return
        line = f"[val @ {step}] " + json.dumps(
            {k: round(float(v), 5) for k, v in results.items()})
        print(line, flush=True)
        self.write_text(line)

    def close(self) -> None:
        if self.active:
            self._txt.close()
