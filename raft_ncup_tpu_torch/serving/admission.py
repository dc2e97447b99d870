"""Bounded admission queue with load shedding (port of
``raft_ncup_tpu/serving/admission.py``).

With open-loop arrivals an unbounded queue turns overload into unbounded
latency; a bounded queue turns it into a fast ``shed`` with a retry hint
for the marginal request while the admitted ones keep their latency.
``offer`` never blocks; ``pop_batch`` blocks for the first request, then
pops FIFO-adjacent requests sharing its shape key, never reordering
across shapes; the stream engine's rule (``distinct_fn``) takes at most
one frame of a stream into a batch. With ``telemetry`` bound, every
``offer``, ``pop_batch`` and ``close`` publishes the depth as the gauge
``{name}_queue_depth`` (value and peak).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, List, Optional


class AdmissionQueue:
    """Thread-safe bounded FIFO of admitted requests (``FlowRequest`` or
    the stream engine's ``FrameRequest``)."""

    def __init__(self, capacity: int, *, telemetry=None, name: str = "queue"):
        self.capacity = max(1, int(capacity))
        self._q: deque = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._paused = False
        self._tel = telemetry
        self._depth_gauge = f"{name}_queue_depth"

    def _publish_depth(self) -> None:
        # Callers hold self._cond: len() is the depth at this instant.
        if self._tel is not None:
            self._tel.gauge_set(self._depth_gauge, len(self._q))

    def __len__(self) -> int:
        with self._cond:
            return len(self._q)

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def offer(self, request) -> bool:
        """Admit ``request`` (True) or refuse it at once when full or
        closed (False)."""
        with self._cond:
            if self._closed or len(self._q) >= self.capacity:
                return False
            self._q.append(request)
            self._publish_depth()
            self._cond.notify()
            return True

    def close(self) -> None:
        """Stop admitting; queued requests stay poppable (drain)."""
        with self._cond:
            self._closed = True
            self._paused = False
            self._publish_depth()
            self._cond.notify_all()

    def set_paused(self, paused: bool) -> None:
        """While paused, ``pop_batch`` yields nothing; admission goes on."""
        with self._cond:
            self._paused = bool(paused)
            self._cond.notify_all()

    def pop_batch(
        self,
        max_n: int,
        timeout: Optional[float] = None,
        distinct_fn: Optional[Callable] = None,
    ) -> List:
        """Pop the head plus up to ``max_n - 1`` FIFO-adjacent requests
        with the same ``shape_key``. Returns ``[]`` on timeout or when
        closed and empty.

        ``distinct_fn``: at most one popped request per value. A second
        frame of a stream must read the state its predecessor writes, so
        a duplicate is skipped in place (it keeps its position and its
        stream's order) and the scan goes on to later requests of the same
        key; it still stops at the first request of another key."""
        with self._cond:
            while self._paused or not self._q:
                if self._closed and not self._q:
                    return []
                if not self._cond.wait(timeout):
                    return []
            head = self._q.popleft()
            batch = [head]
            if distinct_fn is None:
                while (
                    self._q and len(batch) < max_n
                    and self._q[0].shape_key == head.shape_key
                ):
                    batch.append(self._q.popleft())
                self._publish_depth()
                return batch
            seen = {distinct_fn(head)}
            i = 0
            while i < len(self._q) and len(batch) < max_n:
                req = self._q[i]
                if req.shape_key != head.shape_key:
                    break  # never reorder across shape keys
                d = distinct_fn(req)
                if d in seen:
                    i += 1  # same stream: keeps its position and order
                    continue
                del self._q[i]
                batch.append(req)
                seen.add(d)
            self._publish_depth()
            return batch
