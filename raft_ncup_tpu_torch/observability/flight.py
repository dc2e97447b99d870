"""Fault flight recorder: one atomic JSON dump of the recent past on every
fault trigger (port of ``raft_ncup_tpu/observability/flight.py``;
docs/OBSERVABILITY.md "Flight recorder").

The span ring holds exactly the evidence a postmortem needs, and that
evidence is gone once the process exits 75 or 76. On a fault trigger the
recorder snapshots

- the span and event ring (the recent timeline, correlation attrs intact),
- the registry snapshot (counters, gauges, histograms),
- the health states and SLO verdicts,
- the mesh and precision fingerprints of the latest dispatch span (the
  port has no mesh yet: its spans say ``"nomesh"``, as JAX's do without one),

into one ``flight_<trigger>_<ts>_<seq>.json``, written atomically (a
temporary file and ``os.replace``: a poller never sees a torn file). The
format is the JAX package's (``flight_recorder_version`` 1), so its
``scripts/postmortem.py`` reads the port's dumps.

Triggers (the producers call ``Telemetry.flight_dump``):

| trigger | site |
|---|---|
| ``poison_quarantine``   | ``FlowServer``: a request with non-finite pixels quarantined at dispatch |
| ``stream_anomaly_reset``| ``StreamEngine``: a flagged row's stream reset to a cold start |
| ``sentinel_halt``       | the train entry's divergence halt (exit 76) |
| ``preemption_drain``    | the serve and train entries' SIGTERM drain (exit 75) |
| ``slo_page``            | ``SloEngine``: a page edge |
| ``guard_violation``     | ``analysis/guards.py``: an implicit host read intercepted in a guarded window |

Bounded by construction: per-trigger rate limiting (``min_interval_s``: a
poison storm leaves the first dump and a suppression count) and a cap on
dump files (``max_dumps``: the oldest are deleted). A failed dump is
counted (``flight_dump_failed_total``), never raised. The port arms the
default hub's recorder from ``RAFT_TORCH_FLIGHT_DIR``. Pure stdlib:
everything dumped is already host data.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

DEFAULT_MAX_DUMPS = 16
DEFAULT_MIN_INTERVAL_S = 5.0

FLIGHT_ENV = "RAFT_TORCH_FLIGHT_DIR"


def match_records(records: List[dict], **match) -> List[dict]:
    """Correlation query over dumped (or live) ring records — the
    ``SpanTracer.for_attr`` semantics, shared with scripts/postmortem.py:
    a record matches when every given key equals the record's attr, is
    contained in a list-valued attr, or is contained in the PLURAL form
    of the attr (``request_id=12`` matches a batch span's
    ``request_ids`` list)."""
    out = []
    for r in records:
        attrs = r.get("attrs", {})
        ok = True
        for k, v in match.items():
            got = attrs.get(k)
            if got == v:
                continue
            if isinstance(got, list) and v in got:
                continue
            plural = attrs.get(k + "s")
            if isinstance(plural, list) and v in plural:
                continue
            ok = False
            break
        if ok:
            out.append(r)
    return out


def harvest_fingerprints(records: List[dict]) -> Dict[str, object]:
    """The mesh/policy fingerprints of the most recent dispatch: scan
    the ring backwards for the last record carrying both attrs (the
    serve/stream dispatch spans always do)."""
    for r in reversed(records):
        attrs = r.get("attrs", {})
        if "mesh" in attrs and "policy" in attrs:
            return {"mesh": attrs["mesh"], "policy": attrs["policy"]}
    return {}


class FlightRecorder:
    """Bounded, rate-limited fault dump writer for one telemetry hub."""

    def __init__(
        self,
        directory: str,
        max_dumps: int = DEFAULT_MAX_DUMPS,
        min_interval_s: float = DEFAULT_MIN_INTERVAL_S,
        clock: Callable[[], float] = time.monotonic,
        walltime: Callable[[], float] = time.time,
    ):
        self.directory = directory
        self.max_dumps = max(1, int(max_dumps))
        self.min_interval_s = float(min_interval_s)
        self._clock = clock
        self._walltime = walltime
        self._last_by_trigger: Dict[str, float] = {}
        self._seq = 0
        self.dumps = 0
        self.suppressed = 0
        self.failed = 0
        self._lock = threading.Lock()

    def record(self, trigger: str, tel, **context) -> Optional[str]:
        """Write one dump for ``trigger``; returns the path, or None
        when rate-limited or the write failed (both counted, both also
        visible as registry counters through the hub)."""
        trigger = str(trigger)
        now = self._clock()
        with self._lock:
            last = self._last_by_trigger.get(trigger)
            if last is not None and now - last < self.min_interval_s:
                self.suppressed += 1
                if tel is not None:
                    tel.inc("flight_dump_suppressed_total")
                return None
            self._last_by_trigger[trigger] = now
            self._seq += 1
            seq = self._seq
        path = None
        try:
            path = self._write(trigger, seq, tel, context)
        except OSError as e:
            with self._lock:
                self.failed += 1
                # Re-open the rate-limit window: a transient write
                # failure must not suppress the NEXT fault's dump for
                # min_interval_s — writing dumps is the recorder's one
                # job, the limiter only throttles successes.
                if self._last_by_trigger.get(trigger) == now:
                    if last is None:
                        del self._last_by_trigger[trigger]
                    else:
                        self._last_by_trigger[trigger] = last
            if tel is not None:
                # The point event auto-feeds flight_dump_failed_total.
                tel.event("flight_dump_failed", trigger=trigger,
                          error=repr(e))
            return None
        with self._lock:
            self.dumps += 1
        if tel is not None:
            # The point event auto-feeds flight_dump_total.
            tel.event("flight_dump", trigger=trigger, path=path)
        return path

    def _write(self, trigger: str, seq: int, tel, context: dict) -> str:
        os.makedirs(self.directory, exist_ok=True)
        wall = self._walltime()
        ts = time.strftime("%Y%m%dT%H%M%S", time.gmtime(wall))
        safe = "".join(
            c if c.isalnum() or c in "-_" else "_" for c in trigger
        )
        fname = f"flight_{safe}_{ts}_{seq:04d}.json"
        path = os.path.join(self.directory, fname)
        records = tel.tracer.records() if tel is not None else []
        # Import here, not at module top: export.py imports this module
        # (hub construction), and telemetry_report lives there.
        from raft_ncup_tpu_torch.observability.export import telemetry_report

        dump = {
            "flight_recorder_version": 1,
            "trigger": trigger,
            "time_unix_s": round(wall, 3),
            "context": {k: context[k] for k in sorted(context)},
            "fingerprints": harvest_fingerprints(records),
            "report": (
                telemetry_report(tel) if tel is not None else None
            ),
            "spans": records,
        }
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(dump, fh)
            fh.write("\n")
        os.replace(tmp, path)  # atomic: a poller never sees a torn dump
        self._enforce_cap()
        return path

    def _enforce_cap(self) -> None:
        try:
            names = sorted(
                n for n in os.listdir(self.directory)
                if n.startswith("flight_") and n.endswith(".json")
            )
        except OSError:
            return
        # Names sort by (trigger, timestamp, seq); age order needs mtime.
        if len(names) <= self.max_dumps:
            return
        paths = [os.path.join(self.directory, n) for n in names]
        paths.sort(key=lambda p: (os.path.getmtime(p), p))
        for p in paths[: len(paths) - self.max_dumps]:
            try:
                os.remove(p)
            except OSError:
                pass  # racing pollers/cleaners; the cap is best-effort

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "directory": self.directory,
                "dumps": self.dumps,
                "suppressed": self.suppressed,
                "failed": self.failed,
            }


def load_dump(path: str) -> dict:
    """Read one flight dump (postmortem entry point; validates the
    version field so a truncated/foreign file fails loudly)."""
    with open(path, encoding="utf-8") as fh:
        dump = json.load(fh)
    if dump.get("flight_recorder_version") != 1:
        raise ValueError(
            f"{path}: not a flight-recorder dump (version "
            f"{dump.get('flight_recorder_version')!r})"
        )
    return dump
