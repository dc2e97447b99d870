"""Telemetry export: the process-wide hub, a bounded JSONL event sink,
periodic snapshots, a Prometheus text dump, the healthz file and the one
``telemetry_report()`` dict the serve entry's ``--report`` prints (port of
``raft_ncup_tpu/observability/export.py``).

The :class:`Telemetry` hub bundles one :class:`MetricsRegistry` and one
:class:`SpanTracer` behind facade methods that do nothing when the hub is
disabled: every producer calls ``tel.inc(...)`` / ``with tel.span(...)``
unconditionally, and a disabled hub reduces each to a bool check. That is
also how the telemetry's own cost is measured: the same served requests
with the hub on and off (``chip_smoke.py``'s
``serve_telemetry_overhead_pct``; the JAX package's budget is 3% of p50).

One process-wide default hub (:func:`get_telemetry`) is what the serving
and streaming constructors bind when not handed one; tests pass their own
for isolation. ``RAFT_TORCH_TELEMETRY=0`` disables the default hub at
creation, and ``RAFT_TORCH_FLIGHT_DIR`` arms its flight recorder (the
port's own knobs, read through ``utils/knobs.py``).

Pure stdlib: the sink writes host dicts, the snapshot thread reads host
counters, and nothing here touches a device tensor or synchronises.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Optional

from raft_ncup_tpu_torch.observability.flight import FLIGHT_ENV, FlightRecorder
from raft_ncup_tpu_torch.utils.knobs import knob_enabled, knob_raw
from raft_ncup_tpu_torch.observability.health import HealthTracker, overall_state
from raft_ncup_tpu_torch.observability.spans import (
    NOOP_SPAN,
    SpanTracer,
)
from raft_ncup_tpu_torch.observability.telemetry import MetricsRegistry

TELEMETRY_ENV = "RAFT_TORCH_TELEMETRY"

# Process start (unix wall clock), for the healthz replica-identity
# block: a router distinguishing "same replica, later" from "restarted
# replica reusing the pid" needs the start time, not just the pid.
_PROCESS_START_UNIX_S = round(time.time(), 3)


class Telemetry:
    """Registry + tracer behind one enable flag, plus the consumer half
    (docs/OBSERVABILITY.md): per-subsystem :class:`HealthTracker`s, an
    optional attached :class:`~raft_ncup_tpu_torch.observability.slo.SloEngine`
    (``slo``), and an optional :class:`FlightRecorder` (``flight``). The
    facade methods are the ONLY producer API the rest of the codebase
    uses, so flipping ``enabled`` turns the entire telemetry surface
    on/off at once — health STATE keeps tracking even when disabled (it
    gates the budget controller and the healthz file: product logic,
    not just an exported number), but its gauges/events are suppressed
    like every other producer call."""

    def __init__(
        self,
        enabled: bool = True,
        span_capacity: int = 2048,
        clock: Callable[[], float] = time.monotonic,
        flight_dir: Optional[str] = None,
    ):
        self.registry = MetricsRegistry()
        self.tracer = SpanTracer(
            self.registry, capacity=span_capacity, clock=clock
        )
        self.enabled = bool(enabled)
        self.clock = clock
        # Consumer half: health trackers are get-or-create per
        # subsystem; the SLO engine and flight recorder are attached by
        # the entry (serve.py/train.py) that knows the specs and the dir.
        self._health: dict = {}
        self._health_lock = threading.Lock()
        self.slo = None
        # Identity the healthz file advertises: producers deposit host
        # facts here (the serve entry puts the warmed (shape, batch,
        # iters) set and the preset there after warm-up). Host values
        # only; merged verbatim into every write_healthz payload.
        self.identity: dict = {}
        self.flight = (
            FlightRecorder(flight_dir) if flight_dir else None
        )

    # ---------------------------------------------------------- producers

    def inc(self, name: str, n=1) -> None:
        if self.enabled:
            self.registry.counter(name).inc(n)

    def gauge_set(self, name: str, value) -> None:
        if self.enabled:
            self.registry.gauge(name).set(value)

    def observe_ms(self, name: str, ms, **attrs) -> None:
        if self.enabled:
            self.tracer.observe_ms(name, ms, **attrs)

    def hist_observe(self, name: str, ms) -> None:
        """Registry-histogram-only observation (no ring record): the
        per-request end-to-end latency feed — one histogram append per
        request would be fine, one ring record per request would crowd
        the batch-level spans out of the flight recorder's window."""
        if self.enabled:
            self.registry.histogram(name).observe_ms(ms)

    def event(self, name: str, **attrs) -> None:
        if self.enabled:
            self.tracer.event(name, **attrs)

    def span(self, name: str, **attrs):
        if self.enabled:
            return self.tracer.span(name, **attrs)
        return NOOP_SPAN

    # ------------------------------------------------------ consumer half

    def health(self, subsystem: str, fresh: bool = False) -> HealthTracker:
        """The subsystem's health tracker (created STARTING on first
        use). One tracker per subsystem per hub — the process's answer
        to "is this replica healthy". ``fresh=True`` replaces any
        existing tracker (a re-entrant entry run must start STARTING,
        not inherit a previous run's terminal HALTED)."""
        with self._health_lock:
            tr = self._health.get(subsystem)
            if tr is None or fresh:
                tr = HealthTracker(subsystem, telemetry=self,
                                   clock=self.clock)
                self._health[subsystem] = tr
            return tr

    def health_snapshot(self) -> dict:
        with self._health_lock:
            trackers = dict(self._health)
        return {name: tr.snapshot() for name, tr in sorted(
            trackers.items()
        )}

    def slo_paging(self, subsystem: Optional[str] = None) -> bool:
        """Is an attached SLO engine currently paging (for
        ``subsystem``)? False with no engine — the budget controller's
        second degrade input degrades to pure queue-depth behavior."""
        eng = self.slo
        return False if eng is None else eng.paging(subsystem)

    def flight_dump(self, trigger: str, **context) -> Optional[str]:
        """Trigger a flight-recorder dump (no-op without a recorder or
        when the hub is disabled); returns the dump path or None."""
        rec = self.flight
        if rec is None or not self.enabled:
            return None
        return rec.record(trigger, self, **context)

    def counter_value(self, name: str) -> float:
        m = self.registry.get(name)
        return 0.0 if m is None else m.value

    def report(self) -> dict:
        return telemetry_report(self)

    def reset(self) -> None:
        self.registry.reset()
        self.tracer.reset()


_default_lock = threading.Lock()
_default: Optional[Telemetry] = None


def get_telemetry() -> Telemetry:
    """The process-wide default hub (created on first use; honors
    ``RAFT_TORCH_TELEMETRY=0`` and arms the flight recorder when
    ``RAFT_TORCH_FLIGHT_DIR`` names a directory; the entries attach one
    explicitly either way)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = Telemetry(
                enabled=knob_enabled(TELEMETRY_ENV),
                flight_dir=knob_raw(FLIGHT_ENV) or None,
            )
        return _default


def set_telemetry(tel: Optional[Telemetry]) -> Optional[Telemetry]:
    """Swap the process default (test isolation); returns the
    previous hub so callers can restore it."""
    global _default
    with _default_lock:
        prev, _default = _default, tel
        return prev


def telemetry_report(tel: Optional[Telemetry] = None) -> dict:
    """The one snapshot dict every consumer reads: full registry
    snapshot, per-stage latency breakdown, ring accounting — and the
    consumer half's verdicts: per-subsystem health states and (when an
    engine is attached) the SLO verdict block."""
    tel = tel or get_telemetry()
    report = {
        "enabled": tel.enabled,
        "metrics": tel.registry.snapshot(),
        "stages": tel.tracer.stage_summary(),
        "spans_recorded": len(tel.tracer.records()),
        "spans_dropped": tel.tracer.dropped,
        "health": tel.health_snapshot(),
        "slo": tel.slo.snapshot() if tel.slo is not None else None,
    }
    if tel.flight is not None:
        report["flight"] = tel.flight.snapshot()
    return report


def write_healthz(
    path: str,
    tel: Optional[Telemetry] = None,
    interval_s: Optional[float] = None,
) -> None:
    """Atomically rewrite the machine-readable health file a fleet
    router polls (serve.py ``--healthz_file``): per-subsystem health
    snapshots, the worst-state headline, the SLO verdict block, the
    drain/halt exit contract (DRAINING rides the existing SIGTERM →
    exit-75 path; HALTED the sentinel → exit-76 one), and the identity
    a router routes on — ``pid``, process start time, plus whatever the
    producers deposited in ``Telemetry.identity`` (the serve entry puts
    the warmed ``(shape, batch, iters)`` set there after warm-up; in
    ``--replica_socket`` mode also the replica's index, its mesh and the
    stream engine's ``stream_warmed`` set, which the fleet router reads).

    **Staleness contract**: ``interval_s`` is the rewrite cadence the
    writer promises; consumers MUST treat a payload whose
    ``time_unix_s`` is older than ``stale_after_s`` (2x the cadence) as
    a dead replica even if the process lingers — a wedged or SIGSTOPped
    replica keeps its pid but stops heartbeating
    (``fleet/replica.healthz_fresh`` is the consumer).

    tmp + ``os.replace`` — a poller never reads a torn file."""
    tel = tel or get_telemetry()
    health = tel.health_snapshot()
    payload = {
        "time_unix_s": round(time.time(), 3),
        "overall": overall_state(health),
        "health": health,
        "slo": tel.slo.snapshot() if tel.slo is not None else None,
        "draining": any(
            s["state"] == "draining" for s in health.values()
        ),
        "exit_contract": {"draining": 75, "halted": 76},
        "pid": os.getpid(),
        "start_time_unix_s": _PROCESS_START_UNIX_S,
        **dict(tel.identity),
    }
    if interval_s is not None:
        payload["interval_s"] = round(float(interval_s), 3)
        payload["stale_after_s"] = round(2.0 * float(interval_s), 3)
    parent = os.path.dirname(path)
    if parent:
        # Same courtesy as the flight recorder: a healthz path in a
        # not-yet-created run dir must not crash the server at startup.
        os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(payload, fh)
        fh.write("\n")
    os.replace(tmp, path)


def prometheus_text(tel: Optional[Telemetry] = None) -> str:
    """Prometheus text exposition of the hub's registry."""
    return (tel or get_telemetry()).registry.prometheus_text()


class JsonlSink:
    """Bounded JSONL event sink: one JSON object per line, hard-capped
    at ``max_events`` lines — beyond the cap events are DROPPED and
    counted (``dropped``), never buffered or grown: an event sink that
    can fill a disk is an outage amplifier, and the span ring upstream
    already keeps the recent past. Thread-safe; ``close()`` appends a
    final ``jsonl_sink_closed`` record carrying the drop count."""

    def __init__(self, path: str, max_events: int = 100_000):
        self._path = path
        self._max = max(1, int(max_events))
        self._written = 0
        self.dropped = 0
        self._lock = threading.Lock()
        self._fh = open(path, "a", encoding="utf-8")

    def write(self, record: dict) -> bool:
        """Append one event; False (and counted) once the cap is hit."""
        with self._lock:
            if self._fh.closed:
                return False
            if self._written >= self._max:
                self.dropped += 1
                return False
            self._fh.write(json.dumps(record) + "\n")
            self._written += 1
            return True

    def flush(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh.closed:
                return
            if self.dropped:
                self._fh.write(json.dumps({
                    "name": "jsonl_sink_closed",
                    "dropped": self.dropped,
                }) + "\n")
            self._fh.close()

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class PeriodicSnapshot:
    """Background thread driving the telemetry cadence every
    ``interval_s``: evaluate the hub's attached SLO engine (so burn
    rates stay fresh without a second timer), write a
    ``telemetry_report`` snapshot to the :class:`JsonlSink`, and rewrite
    the ``healthz_path`` file when configured — plus one final tick at
    ``stop()``. The long-running-server export path (serve.py
    ``--telemetry_jsonl`` / ``--healthz_file``).

    ``sink`` may be None (healthz-only cadence). ``stop()`` before
    ``start()`` is a no-op: a monitor that never ran has nothing final
    to report, and writing a "final" snapshot from it would stamp a
    phantom observation into the sink.
    """

    def __init__(
        self,
        tel: Telemetry,
        sink: Optional[JsonlSink],
        interval_s: float = 10.0,
        healthz_path: Optional[str] = None,
    ):
        self._tel = tel
        self._sink = sink
        self._interval = max(0.05, float(interval_s))
        self._healthz = healthz_path
        self._started = False
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="telemetry-snapshot", daemon=True
        )

    def start(self) -> "PeriodicSnapshot":
        self._started = True
        # First tick immediately: the healthz file must exist before the
        # first interval elapses (a router polling a just-started
        # replica reads STARTING/WARMING, not ENOENT).
        self._write_one()
        self._thread.start()
        return self

    def _write_one(self) -> None:
        if self._tel.slo is not None:
            self._tel.slo.evaluate()
        if self._sink is not None:
            self._sink.write({
                "name": "telemetry_snapshot",
                "time_unix_s": round(time.time(), 3),
                "report": telemetry_report(self._tel),
            })
            self._sink.flush()
        if self._healthz:
            write_healthz(self._healthz, self._tel,
                          interval_s=self._interval)

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self._write_one()

    def stop(self) -> None:
        """Final tick + teardown. No-op before ``start()`` or after a
        previous ``stop()``. Callers owning a sink must close it AFTER
        this returns (final-snapshot → sink-close ordering): the final
        report of a drained run is the one the postmortem reads."""
        if not self._started or self._stop.is_set():
            return
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join()
        self._write_one()

    def __enter__(self) -> "PeriodicSnapshot":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
