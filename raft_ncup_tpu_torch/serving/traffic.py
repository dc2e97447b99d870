"""Deterministic open-loop request traffic for the serve entry (port of
``raft_ncup_tpu/serving/traffic.py``).

A schedule is fixed by ``(seed, n_requests, interval_s, chaos)``:

- ``burst@N``: request ``N`` arrives as ``burst_size`` requests due at
  the same instant (the overload that must shed, not queue without
  bound);
- ``poison@N``: request ``N``'s first frame is all-NaN float32 (the
  server quarantines it away from its batch-mates);
- ``sigterm@N``: :func:`replay` sends the process a real SIGTERM right
  after submitting ``N`` requests (the drain contract, mid-flight).

Frames come from the port's ``data/synthetic.SyntheticFlowDataset``
(content keyed on ``(seed, index)``), as uint8 host arrays.
"""

from __future__ import annotations

import os
import signal as signal_mod
import time
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

from raft_ncup_tpu_torch.data.synthetic import SyntheticFlowDataset
from raft_ncup_tpu_torch.resilience.chaos import ChaosSpec


def host_pair(dataset, index: int) -> tuple:
    """Sample ``index`` of a synthetic dataset as two (H, W, 3) uint8
    numpy frames."""
    sample = dataset.sample(index)
    return sample["image1"].numpy(), sample["image2"].numpy()


class SyntheticTraffic:
    """Deterministic open-loop request schedule: iterating yields
    ``(due_s, image1, image2)`` ordered by due time; ``interval_s`` is the
    steady gap between arrivals."""

    def __init__(
        self,
        size_hw: Tuple[int, int],
        n_requests: int,
        *,
        seed: int = 0,
        interval_s: float = 0.0,
        burst_size: int = 8,
        chaos: Optional[ChaosSpec] = None,
        style: str = "smooth",
    ):
        self.size_hw = tuple(size_hw)
        self.n_requests = int(n_requests)
        self.interval_s = float(interval_s)
        self.burst_size = max(1, int(burst_size))
        self.chaos = chaos or ChaosSpec()
        # The steady stream plus every burst expansion that fires.
        live_bursts = sum(1 for i in self.chaos.burst_requests if i < self.n_requests)
        self._total = self.n_requests + live_bursts * (self.burst_size - 1)
        self._ds = SyntheticFlowDataset(self.size_hw, length=max(1, self._total), seed=seed,
                                        style=style)

    def __len__(self) -> int:
        return self._total

    def __iter__(self) -> Iterator[Tuple[float, np.ndarray, np.ndarray]]:
        emitted = 0
        for i in range(self.n_requests):
            due = i * self.interval_s
            copies = self.burst_size if i in self.chaos.burst_requests else 1
            for _ in range(copies):
                img1, img2 = host_pair(self._ds, emitted)
                if i in self.chaos.poison_requests:
                    img1 = np.full(img1.shape, np.nan, np.float32)
                emitted += 1
                yield due, img1, img2


def replay(
    server,
    traffic,
    *,
    deadline_s: Optional[float] = None,
    preempt=None,
    sigterm_after: Optional[int] = None,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
) -> Tuple[List, bool]:
    """Drive ``server`` with ``traffic`` open-loop (submissions at their
    due times whatever the completions); returns ``(handles,
    interrupted)``. Once the installed ``PreemptionHandler``'s flag is
    set it stops submitting, and the caller drains the server."""
    handles: List = []
    t0 = clock()
    for due, img1, img2 in traffic:
        if preempt is not None and preempt.requested:
            return handles, True
        delay = due - (clock() - t0)
        if delay > 0:
            sleep(delay)
        handles.append(server.submit(img1, img2, deadline_s=deadline_s))
        if sigterm_after is not None and len(handles) == sigterm_after:
            os.kill(os.getpid(), signal_mod.SIGTERM)
    return handles, bool(preempt is not None and preempt.requested)
