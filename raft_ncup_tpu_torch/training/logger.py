"""Training metrics to stdout and ``<run_dir>/log.txt`` (port of
``raft_ncup_tpu/training/logger.py``, without TensorBoard).

Metrics are summed on the device as they arrive and read back once per
``sum_freq`` steps, so the steps between two summaries read nothing back
to the host."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping, Optional

import torch


class Logger:
    def __init__(self, run_dir: str, config: Any = None, sum_freq: int = 100):
        self.run_dir = run_dir
        self.sum_freq = sum_freq
        os.makedirs(run_dir, exist_ok=True)
        self._txt = open(os.path.join(run_dir, "log.txt"), "a")
        self._acc: dict[str, torch.Tensor] = {}
        self._n = 0
        self._t_last = time.perf_counter()
        self._steps_last: Optional[int] = None
        if config is not None:
            self.write_text(json.dumps(config, sort_keys=True, default=str))

    def write_text(self, text: str) -> None:
        self._txt.write(text + "\n")
        self._txt.flush()

    def push(self, step: int, metrics: Mapping[str, torch.Tensor],
             lr: Optional[torch.Tensor] = None) -> None:
        """Add one step's metrics (``step`` counted from 0); every
        ``sum_freq`` steps print and log their means."""
        for k, v in metrics.items():
            v = v.detach().to(torch.float32)
            self._acc[k] = v if k not in self._acc else self._acc[k] + v
        self._n += 1
        if self._steps_last is None:
            self._steps_last = step
        if (step + 1) % self.sum_freq:
            return
        keys = sorted(self._acc)
        vals = torch.stack([self._acc[k] for k in keys]).tolist()  # one read
        means = {k: v / self._n for k, v in zip(keys, vals)}
        now = time.perf_counter()
        sps = (step + 1 - self._steps_last) / max(now - self._t_last, 1e-9)
        self._acc, self._n = {}, 0
        self._t_last, self._steps_last = now, step + 1
        parts = [f"[{step + 1:6d}"]
        if lr is not None:
            parts.append(f"lr {float(lr):.2e}")
        parts.append(f"{sps:5.2f} it/s]")
        parts += [f"{k} {v:.4f}" for k, v in means.items()]
        line = " ".join(parts)
        print(line, flush=True)
        self.write_text(line)

    def write_dict(self, step: int, results: Mapping[str, float]) -> None:
        """Print and log one validation's results (reference:
        train.py:151-161)."""
        line = f"[val @ {step}] " + json.dumps(
            {k: round(float(v), 5) for k, v in results.items()})
        print(line, flush=True)
        self.write_text(line)

    def close(self) -> None:
        self._txt.close()
