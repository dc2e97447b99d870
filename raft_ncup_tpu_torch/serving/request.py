"""Serving request/response protocol and per-run accounting (port of
``raft_ncup_tpu/serving/request.py``).

Every request submitted to the server terminates in exactly ONE of five
explicit statuses:

- ``ok``       -- flow computed; ``flow`` holds the (H, W, 2) field and
  ``iters`` the budget level it was computed at;
- ``shed``     -- admission refused (queue at capacity, or the server is
  draining); ``retry_after_s`` carries the backpressure hint;
- ``timeout``  -- the deadline expired while the request waited in the
  queue; no compute was spent on it;
- ``rejected`` -- the request itself is poison (bad shape or dtype at
  admission, non-finite pixels at dispatch); ``detail`` says why;
- ``error``    -- the server failed while processing the batch.

``ServeStats`` is thread-safe and mutated only through its ``note_*``
methods (submitters and the dispatcher write concurrently). Each ``note_*``
also mirrors into the telemetry registry under the canonical counter name
(``observability.telemetry.LEGACY_KEY_ALIASES["serve"]``); the summary's
keys never change.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence

from raft_ncup_tpu_torch.observability.telemetry import LEGACY_KEY_ALIASES

_SERVE_CANON = LEGACY_KEY_ALIASES["serve"]


def nearest_rank_ms(latencies_s: Sequence[float], p: float) -> Optional[float]:
    """Nearest-rank percentile of a latency sample, in milliseconds: the
    value at index ``ceil(p*n) - 1`` of the sorted sample. ``None`` on an
    empty sample."""
    if not latencies_s:
        return None
    xs = sorted(latencies_s)
    idx = max(0, math.ceil(p * len(xs)) - 1)
    return round(xs[min(idx, len(xs) - 1)] * 1000.0, 1)


STATUS_OK = "ok"
STATUS_SHED = "shed"
STATUS_TIMEOUT = "timeout"
STATUS_REJECTED = "rejected"
STATUS_ERROR = "error"


@dataclass
class FlowRequest:
    """One frame pair awaiting flow. ``deadline`` is an absolute time on
    the server's clock (``None`` = no deadline); ``shape_key`` is the
    padded (H, W) the request batches under, filled at admission."""

    request_id: int
    image1: Any
    image2: Any
    deadline: Optional[float] = None
    submit_time: float = 0.0
    shape_key: Optional[tuple] = None
    pad_spec: Optional[tuple] = None
    # A fleet router's trace id, adopted from the wire: every span this
    # request touches carries it, so one trace_id reassembles the journey
    # across the process boundary.
    trace_id: Optional[str] = None


@dataclass
class FlowResponse:
    """Terminal answer for one request (see module docstring)."""

    request_id: int
    status: str
    flow: Optional[Any] = None  # (H, W, 2) numpy, native shape; ok only
    iters: Optional[int] = None
    latency_s: Optional[float] = None  # submit -> completion
    retry_after_s: Optional[float] = None  # shed only
    detail: str = ""

    @property
    def ok(self) -> bool:
        return self.status == STATUS_OK


def trace_attr(req) -> dict:
    """``{"trace_id": ...}`` for a request that carries one, else ``{}``:
    the span attribute of one request's adopted trace."""
    return {} if req.trace_id is None else {"trace_id": req.trace_id}


def trace_ids_attr(reqs) -> dict:
    """``{"trace_ids": [...]}`` over a batch's requests that carry a trace
    id, else ``{}``: the batch spans' attribute."""
    ids = [r.trace_id for r in reqs if r.trace_id is not None]
    return {"trace_ids": ids} if ids else {}


class ServeHandle:
    """Thread-safe completion handle returned by ``submit``; completed
    exactly once (a second completion is a server bug and raises)."""

    __slots__ = ("_event", "_response")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._response: Optional[FlowResponse] = None

    def complete(self, response: FlowResponse) -> None:
        if self._event.is_set():
            raise RuntimeError(
                f"handle for request {response.request_id} completed twice"
            )
        self._response = response
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> FlowResponse:
        if not self._event.wait(timeout):
            raise TimeoutError("serve handle not completed in time")
        return self._response


@dataclass(eq=False)
class ServeStats:
    """Per-run serving accounting; mutate through ``note_*`` only."""

    submitted: int = 0
    accepted: int = 0
    completed: int = 0
    shed: int = 0
    timeouts: int = 0
    rejected: int = 0
    errors: int = 0
    batches: int = 0
    padded_rows: int = 0  # zero rows added to reach an allowed batch size
    quarantined: List[int] = field(default_factory=list)
    # The telemetry hub to mirror into (None: no mirror). The fields stay
    # the summary's source.
    telemetry: Optional[Any] = field(default=None, repr=False, compare=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def _mirror(self, name: str, delta: int = 1) -> None:
        # Outside the stats lock: the registry has its own.
        if self.telemetry is not None and delta:
            self.telemetry.inc(_SERVE_CANON[name], delta)

    def _inc(self, name: str) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + 1)
        self._mirror(name)

    def note_submitted(self) -> None:
        self._inc("submitted")

    def note_accepted(self) -> None:
        self._inc("accepted")

    def note_completed(self) -> None:
        self._inc("completed")

    def note_shed(self) -> None:
        self._inc("shed")

    def note_timeout(self) -> None:
        self._inc("timeouts")

    def note_error(self) -> None:
        self._inc("errors")

    def note_batch(self, padded_rows: int) -> None:
        with self._lock:
            self.batches += 1
            self.padded_rows += padded_rows
        self._mirror("batches")
        self._mirror("padded_rows", padded_rows)

    def note_rejected(self, request_id: int, *, quarantine: bool = False) -> None:
        """``quarantine=True`` marks a dispatch-time poison quarantine (the
        request reached a batch and was isolated there); admission-time
        rejects count as ``rejected`` only."""
        with self._lock:
            self.rejected += 1
            if quarantine and request_id not in self.quarantined:
                self.quarantined.append(request_id)
        self._mirror("rejected")

    def summary(self) -> str:
        q = ",".join(str(i) for i in self.quarantined) or "-"
        return (
            f"submitted={self.submitted} accepted={self.accepted} "
            f"completed={self.completed} shed={self.shed} "
            f"timeouts={self.timeouts} rejected={self.rejected} "
            f"errors={self.errors} batches={self.batches} "
            f"padded_rows={self.padded_rows} quarantined=[{q}]"
        )
