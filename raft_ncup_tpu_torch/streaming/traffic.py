"""Deterministic multi-stream frame schedule for the stream engine (port of
``raft_ncup_tpu/streaming/traffic.py``).

A schedule is fixed by ``(seed, n_streams, frames_per_stream,
interval_s, chaos)``. Frames go round-robin across streams (frame f of
every stream before frame f + 1 of any), so co-batched streams stay
co-batched. Chaos events address schedule slots: stream ``s``'s frame
``f`` is slot ``f * n_streams + s`` whether or not it is emitted, so an
``abandon`` does not renumber later events:

- ``corruptframe@N``: frame ``N``'s first image is all-NaN float32; the
  engine's anomaly check must reset only its stream;
- ``abandon@N``: the stream owning frame ``N`` emits nothing after it
  (no close), and idle eviction must clean up;
- ``burst@N``: at frame ``N``'s due time ``burst_size`` extra one-frame
  streams (``burst-k``) arrive, and stream admission must shed the
  overflow;
- ``sigterm@N``: :func:`replay_streams` sends a real SIGTERM after
  submitting ``N`` frames.

Each stream's frames come from the port's ``SyntheticFlowDataset`` seeded
by ``(seed, stream)``.
"""

from __future__ import annotations

import os
import signal as signal_mod
import time
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

from raft_ncup_tpu_torch.data.synthetic import SyntheticFlowDataset
from raft_ncup_tpu_torch.resilience.chaos import ChaosSpec
from raft_ncup_tpu_torch.serving.traffic import host_pair


class StreamTraffic:
    """Deterministic open-loop multi-stream schedule: iterating yields
    ``(due_s, stream_id, frame_index, image1, image2)`` ordered by due
    time; ``interval_s`` is the gap between consecutive frames (across
    all streams)."""

    def __init__(
        self,
        size_hw: Tuple[int, int],
        n_streams: int,
        frames_per_stream: int,
        *,
        seed: int = 0,
        interval_s: float = 0.0,
        burst_size: int = 4,
        chaos: Optional[ChaosSpec] = None,
        style: str = "smooth",
    ):
        self.size_hw = tuple(size_hw)
        self.n_streams = int(n_streams)
        self.frames_per_stream = int(frames_per_stream)
        self.interval_s = float(interval_s)
        self.burst_size = max(1, int(burst_size))
        self.chaos = chaos or ChaosSpec()
        # Dataset n_streams feeds the burst streams.
        self._ds = [
            SyntheticFlowDataset(self.size_hw, length=max(1, self.frames_per_stream),
                                 seed=seed * 1000 + s, style=style)
            for s in range(self.n_streams + 1)
        ]

    def stream_id(self, s: int) -> str:
        return f"stream-{s}"

    def __iter__(self) -> Iterator[Tuple[float, str, int, np.ndarray, np.ndarray]]:
        abandoned: set = set()
        burst_emitted = 0
        g = -1
        for f in range(self.frames_per_stream):
            for s in range(self.n_streams):
                g += 1
                due = g * self.interval_s
                if s not in abandoned:
                    img1, img2 = host_pair(self._ds[s], f)
                    if g in self.chaos.corrupt_frames:
                        img1 = np.full(img1.shape, np.nan, np.float32)
                    if g in self.chaos.abandon_frames:
                        abandoned.add(s)
                    yield due, self.stream_id(s), f, img1, img2
                if g in self.chaos.burst_requests:
                    # New one-frame streams on top of the steady schedule,
                    # after its frame, so established streams keep their
                    # slots and the overflow sheds.
                    for _ in range(self.burst_size):
                        img1, img2 = host_pair(self._ds[self.n_streams],
                                               burst_emitted % self.frames_per_stream)
                        burst_emitted += 1
                        yield due, f"burst-{burst_emitted - 1}", 0, img1, img2


def replay_streams(
    engine,
    traffic,
    *,
    preempt=None,
    sigterm_after: Optional[int] = None,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
) -> Tuple[List, bool]:
    """Drive ``engine`` with ``traffic`` open-loop; returns ``(handles,
    interrupted)``. Once the installed ``PreemptionHandler``'s flag is set
    it stops submitting, and the caller drains the engine."""
    handles: List = []
    t0 = clock()
    for due, stream_id, frame_index, img1, img2 in traffic:
        if preempt is not None and preempt.requested:
            return handles, True
        delay = due - (clock() - t0)
        if delay > 0:
            sleep(delay)
        handles.append(engine.submit(stream_id, img1, img2, frame_index=frame_index))
        if sigterm_after is not None and len(handles) == sigterm_after:
            os.kill(os.getpid(), signal_mod.SIGTERM)
    return handles, bool(preempt is not None and preempt.requested)
