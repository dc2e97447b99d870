"""Per-subsystem health state machine (port of
``raft_ncup_tpu/observability/health.py``; docs/OBSERVABILITY.md "Health
states").

A fleet router asking "is this replica healthy, draining or degraded"
needs one machine-readable answer, not a registry dump to interpret.
:class:`HealthTracker` is that answer, a small validated state machine

    STARTING -> WARMING -> READY <-> DEGRADED -> DRAINING -> HALTED

driven by two kinds of input:

- **lifecycle calls** from the subsystem that owns the tracker
  (``FlowServer``/``StreamEngine`` construction: STARTING; warm-up:
  WARMING then READY; ``drain()``: DRAINING; the trainer's sentinel halt:
  HALTED);
- **SLO verdicts** from the registry (``slo.SloEngine``): a paging burn
  rate flips READY to DEGRADED, a clean evaluation flips it back. No
  transition reads a device tensor.

READY <-> DEGRADED is the only cycle: DEGRADED still serves (at a coarser
iteration budget); DRAINING is the SIGTERM / exit-75 contract (stop
routing here) and HALTED the sentinel / exit-76 one.

An illegal transition is a counted no-op, never an exception: the
tracker reports on the server and must never take it down. A same-state
call is a silent no-op (drain is idempotent, SLO evaluations repeat).
Pure stdlib, host-only; the clock is injectable.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

# Canonical state names (lowercase: they travel through JSON reports and
# healthz files the fleet router string-matches on).
STARTING = "starting"
WARMING = "warming"
READY = "ready"
DEGRADED = "degraded"
DRAINING = "draining"
HALTED = "halted"

# Numeric codes for the `{subsystem}_health_state` gauge (a Prometheus
# scraper can alert on `>= DEGRADED` without string labels). Order is
# severity-ish: the healthz "overall" field is the max across subsystems.
STATE_CODES: Dict[str, int] = {
    STARTING: 0,
    WARMING: 1,
    READY: 2,
    DEGRADED: 3,
    DRAINING: 4,
    HALTED: 5,
}

# The legal edges. STARTING → READY exists for subsystems that serve
# without an explicit warmup (the first completed batch marks readiness);
# every state may drain or halt except the two terminals themselves.
ALLOWED_TRANSITIONS: Dict[str, frozenset] = {
    STARTING: frozenset({WARMING, READY, DRAINING, HALTED}),
    WARMING: frozenset({READY, DRAINING, HALTED}),
    READY: frozenset({DEGRADED, DRAINING, HALTED}),
    DEGRADED: frozenset({READY, DRAINING, HALTED}),
    DRAINING: frozenset({HALTED}),
    HALTED: frozenset(),
}

_HISTORY_CAP = 64  # bounded like every other telemetry structure


class HealthTracker:
    """One subsystem's health state, thread-safe, telemetry-publishing.

    ``telemetry`` is the hub the tracker publishes through (gauge
    ``{name}_health_state`` + event ``{name}_health_transition``); the
    STATE itself is tracked even when the hub is disabled — health is
    product logic (it gates the budget controller and the healthz file),
    not just an exported number.
    """

    def __init__(
        self,
        name: str,
        telemetry=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.name = name
        self._tel = telemetry
        self._clock = clock
        self._state = STARTING
        self._reason = "created"
        self._since = clock()
        self._history: deque = deque(maxlen=_HISTORY_CAP)
        self._transitions = 0
        self._invalid = 0
        self._lock = threading.Lock()
        self._publish(STARTING)

    # ------------------------------------------------------------ queries

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def reason(self) -> str:
        with self._lock:
            return self._reason

    def history(self) -> List[dict]:
        with self._lock:
            return list(self._history)

    def snapshot(self) -> dict:
        """JSON-able view for report()/healthz/flight dumps."""
        with self._lock:
            return {
                "state": self._state,
                "code": STATE_CODES[self._state],
                "reason": self._reason,
                "since_s": round(self._clock() - self._since, 3),
                "transitions": self._transitions,
                "invalid_transitions": self._invalid,
            }

    # -------------------------------------------------------- transitions

    def to(self, state: str, reason: str = "") -> bool:
        """Attempt a transition; True when the state actually changed.

        Same-state is a silent no-op (False). An illegal edge is a
        COUNTED no-op (False; ``{name}_health_invalid_transition_total``)
        — the tracker must never raise into the serving hot path.
        """
        if state not in STATE_CODES:
            raise ValueError(f"unknown health state {state!r}")
        with self._lock:
            prev = self._state
            if state == prev:
                return False
            if state not in ALLOWED_TRANSITIONS[prev]:
                self._invalid += 1
                if self._tel is not None:
                    self._tel.inc(
                        f"{self.name}_health_invalid_transition_total"
                    )
                return False
            self._state = state
            self._reason = reason
            self._since = self._clock()
            self._transitions += 1
            self._history.append(
                {"from": prev, "to": state, "reason": reason}
            )
        self._publish(state, prev, reason)
        return True

    def _publish(self, state: str, prev: Optional[str] = None,
                 reason: str = "") -> None:
        if self._tel is None:
            return
        self._tel.gauge_set(
            f"{self.name}_health_state", STATE_CODES[state]
        )
        if prev is not None:
            self._tel.event(
                f"{self.name}_health_transition",
                from_state=prev, to_state=state, reason=reason,
            )

    # ------------------------------------------------ convenience helpers

    def warming(self, reason: str = "warmup") -> bool:
        return self.to(WARMING, reason)

    def ready(self, reason: str = "") -> bool:
        """Mark READY from STARTING/WARMING/DEGRADED (the SLO-recovery
        edge shares this helper)."""
        return self.to(READY, reason)

    def degrade(self, reason: str) -> bool:
        return self.to(DEGRADED, reason)

    def draining(self, reason: str = "drain") -> bool:
        return self.to(DRAINING, reason)

    def halted(self, reason: str) -> bool:
        return self.to(HALTED, reason)


def overall_state(snapshots: Dict[str, dict]) -> str:
    """The fleet-router headline across subsystems: the worst (highest-
    code) state among them, READY when nothing is tracked yet."""
    states = [
        s.get("state") for s in snapshots.values()
        if s.get("state") in STATE_CODES
    ]
    if not states:
        return READY
    return max(states, key=lambda s: STATE_CODES[s])
