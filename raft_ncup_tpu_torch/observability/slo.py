"""Declarative SLOs evaluated on the host with multi-window burn-rate
alerting (port of ``raft_ncup_tpu/observability/slo.py``;
docs/OBSERVABILITY.md "SLO burn rate"). The objectives, windows and burn
thresholds are the JAX package's.

An :class:`SloSpec` is declared once (frozen, pure data), and the
server's degrade decisions, the healthz file and the serve entry's report
all read the same verdicts.

Burn rate: an SLO with objective ``o`` (good fraction, e.g. 0.99) has an
error budget ``1 - o``; the **burn rate** over a window is

    burn(w) = bad_fraction(w) / (1 - o)

1.0 spends the budget at exactly the sustainable rate; 14.4 spends a
30-day budget in 2 days. A spec **pages** only when both its fast window
(default 5 min) and its slow window (default 1 h) burn at or above
``page_burn``: the fast window makes the page responsive, the slow one
keeps a single bad batch from paging. Windows scale (``SloSpec.scaled``,
the serve entry's ``--slo_window_scale``) so tests and short runs take
the same code path in seconds, on an injectable clock.

Three SLI shapes:

- ``ratio``: a bad-event counter over a total-event counter (shed rate,
  error rate), windowed by cumulative-counter deltas;
- ``latency``: the share of a ``*_ms`` histogram's observations above
  ``threshold_ms`` ("at most 1% over the threshold" is "p99 at most the
  threshold"), windowed by bucket-count deltas;
- ``gauge``: the share of evaluations where a gauge exceeds
  ``max_value`` (slot occupancy).

A page edge flips the subsystem's :mod:`health` tracker READY to
DEGRADED, becomes the iteration budget's second degrade input
(``IterationBudgetController.decide(..., slo_degraded=...)``), triggers a
flight-recorder dump and lands as an ``slo_page`` event; a clean
evaluation clears the page and restores READY. Pure stdlib, host-only:
it reads host counters the producers already keep.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from raft_ncup_tpu_torch.observability.health import READY

DEFAULT_FAST_WINDOW_S = 300.0  # the classic 5m fast window
DEFAULT_SLOW_WINDOW_S = 3600.0  # the classic 1h slow window
DEFAULT_PAGE_BURN = 14.4  # 30-day budget in ~2 days

_SLI_KINDS = ("ratio", "latency", "gauge")


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One frozen service-level objective. Pure data: the engine does
    all the reading; specs can be declared at import time and shared by
    the server, the serve entry and the tests."""

    name: str
    subsystem: str  # health-tracker key: "serve" | "stream" | "train"
    sli: str  # "ratio" | "latency" | "gauge"
    objective: float  # good fraction target in [0, 1)
    # sli == "ratio": bad/total cumulative counters.
    bad: str = ""
    total: str = ""
    # sli == "latency": histogram ({stage}_ms) + threshold.
    histogram: str = ""
    threshold_ms: float = 0.0
    # sli == "gauge": gauge name + max healthy value.
    gauge: str = ""
    max_value: float = 0.0
    fast_window_s: float = DEFAULT_FAST_WINDOW_S
    slow_window_s: float = DEFAULT_SLOW_WINDOW_S
    page_burn: float = DEFAULT_PAGE_BURN
    # Minimum events (ratio/latency: total-counter delta; gauge: samples)
    # in the FAST window before a verdict can page: a single bad request
    # in an otherwise idle window is noise, not an outage.
    min_events: int = 4

    def __post_init__(self) -> None:
        if self.sli not in _SLI_KINDS:
            raise ValueError(
                f"slo {self.name}: sli must be one of {_SLI_KINDS}, "
                f"got {self.sli!r}"
            )
        if not 0.0 <= self.objective < 1.0:
            raise ValueError(
                f"slo {self.name}: objective must be in [0, 1), got "
                f"{self.objective} (1.0 leaves a zero error budget — "
                "burn rate would be undefined)"
            )
        if not 0.0 < self.fast_window_s < self.slow_window_s:
            raise ValueError(
                f"slo {self.name}: want 0 < fast_window_s < "
                f"slow_window_s, got {self.fast_window_s}/"
                f"{self.slow_window_s}"
            )
        needed = {
            "ratio": (self.bad, self.total),
            "latency": (self.histogram, self.threshold_ms),
            "gauge": (self.gauge,),
        }[self.sli]
        if not all(needed):
            raise ValueError(
                f"slo {self.name}: sli {self.sli!r} requires "
                "its metric fields to be set"
            )

    @property
    def budget(self) -> float:
        return 1.0 - self.objective

    def scaled(self, window_scale: float) -> "SloSpec":
        """The same objective over proportionally shrunk windows (tests
        and short runs; 1.0 returns self)."""
        if window_scale == 1.0:
            return self
        return dataclasses.replace(
            self,
            fast_window_s=self.fast_window_s * window_scale,
            slow_window_s=self.slow_window_s * window_scale,
        )


def serve_slos(
    window_scale: float = 1.0,
    p99_ms: float = 2000.0,
) -> Tuple[SloSpec, ...]:
    """The serving tier's declared objectives: 99% of requests neither
    shed nor over the latency threshold, 99.9% not errored server-side.
    Declared once; FlowServer and the serve entry read the verdicts."""
    specs = (
        SloSpec(
            name="serve_shed_rate", subsystem="serve", sli="ratio",
            objective=0.99,
            bad="serve_requests_shed_total",
            total="serve_requests_submitted_total",
        ),
        SloSpec(
            name="serve_error_rate", subsystem="serve", sli="ratio",
            objective=0.999,
            bad="serve_requests_error_total",
            total="serve_requests_submitted_total",
        ),
        SloSpec(
            name="serve_p99_latency", subsystem="serve", sli="latency",
            objective=0.99,
            histogram="serve_e2e_ms", threshold_ms=p99_ms,
        ),
    )
    return tuple(s.scaled(window_scale) for s in specs)


def stream_slos(
    capacity: int,
    window_scale: float = 1.0,
    p99_ms: float = 2000.0,
) -> Tuple[SloSpec, ...]:
    """The streaming tier's declared objectives; ``capacity`` sizes the
    slot-occupancy bound (sustained ≥ 90% occupancy means stream
    admission is about to shed — the router should spread load)."""
    specs = (
        SloSpec(
            name="stream_shed_rate", subsystem="stream", sli="ratio",
            objective=0.99,
            bad="stream_frames_shed_total",
            total="stream_frames_submitted_total",
        ),
        SloSpec(
            name="stream_error_rate", subsystem="stream", sli="ratio",
            objective=0.999,
            bad="stream_frames_error_total",
            total="stream_frames_submitted_total",
        ),
        SloSpec(
            name="stream_p99_latency", subsystem="stream", sli="latency",
            objective=0.99,
            histogram="stream_e2e_ms", threshold_ms=p99_ms,
        ),
        SloSpec(
            name="stream_slot_occupancy", subsystem="stream", sli="gauge",
            # Gauge SLIs saturate at bad_fraction 1.0, so the page must
            # be reachable: objective 0.95 caps burn at 1.0/0.05 = 20
            # (> page_burn 14.4 — a table pinned near-full for both
            # windows pages; objective 0.9 would cap at 10 and could
            # NEVER page, silently).
            objective=0.95,
            gauge="stream_slot_occupancy",
            max_value=max(1.0, 0.9 * capacity),
        ),
    )
    return tuple(s.scaled(window_scale) for s in specs)


class SloVerdict:
    """One spec's evaluation result (immutable snapshot)."""

    __slots__ = (
        "name", "subsystem", "page", "burn_fast", "burn_slow",
        "bad_fraction_fast", "events_fast", "objective",
    )

    def __init__(self, name, subsystem, page, burn_fast, burn_slow,
                 bad_fraction_fast, events_fast, objective):
        self.name = name
        self.subsystem = subsystem
        self.page = page
        self.burn_fast = burn_fast
        self.burn_slow = burn_slow
        self.bad_fraction_fast = bad_fraction_fast
        self.events_fast = events_fast
        self.objective = objective

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "subsystem": self.subsystem,
            "page": self.page,
            "burn_fast": round(self.burn_fast, 3),
            "burn_slow": round(self.burn_slow, 3),
            "bad_fraction_fast": round(self.bad_fraction_fast, 5),
            "events_fast": self.events_fast,
            "objective": self.objective,
        }


# Sample-ring size at which resolution halves (see SloEngine.__init__).
_RING_CAP = 4096


class SloEngine:
    """Evaluate a fixed spec set against a hub's registry on a cadence.

    ``evaluate()`` is the ONLY mutation: it samples the registry (host
    counters — never a device value), appends to bounded per-spec sample
    rings, computes fast/slow burn rates, publishes
    ``slo_{name}_burn_fast``/``_burn_slow`` gauges, and on page EDGES
    emits ``slo_page``/``slo_clear`` events, flips the subsystem's
    health tracker, and triggers a flight dump. It is called by
    ``PeriodicSnapshot`` on its cadence in production and directly (with
    a fake clock) in tests — same code path, deterministic.
    """

    def __init__(
        self,
        specs: Sequence[SloSpec],
        telemetry,
        clock: Callable[[], float] = time.monotonic,
    ):
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate slo names: {names}")
        self.specs = tuple(specs)
        self._tel = telemetry
        self._clock = clock
        # Per-spec ring of (t, bad_cumulative, total_cumulative) — for
        # gauges, (t, bad01, 1). Pruned to the slow window each
        # evaluate(); beyond _RING_CAP samples the ring HALVES its
        # resolution instead of evicting its oldest entry — a blind cap
        # at a sub-second cadence (fleet replicas tick at 0.25 s) would
        # silently shrink the declared 1 h slow window to
        # cap x cadence seconds, and burn_slow would page on a horizon
        # the declared window damps.
        self._samples: Dict[str, deque] = {
            s.name: deque() for s in self.specs
        }
        self._paging: Dict[str, bool] = {s.name: False for s in self.specs}
        self._verdicts: Dict[str, SloVerdict] = {}
        self._pages_total = 0
        self._lock = threading.Lock()

    # ------------------------------------------------------------ sampling

    def _sample(self, spec: SloSpec) -> Tuple[float, float]:
        """Current (bad_cumulative, total_cumulative) for one spec."""
        reg = self._tel.registry
        if spec.sli == "ratio":
            bad = reg.get(spec.bad)
            total = reg.get(spec.total)
            return (
                float(bad.value) if bad is not None else 0.0,
                float(total.value) if total is not None else 0.0,
            )
        if spec.sli == "latency":
            hist = reg.get(spec.histogram)
            if hist is None or not hasattr(hist, "buckets_ms"):
                return 0.0, 0.0
            snap = hist.snapshot()
            total = float(snap["count"])
            # Observations at or under the smallest bucket bound >= the
            # threshold count as good (bucket resolution is the
            # measurement resolution; DEFAULT_BUCKETS_MS straddles the
            # serving latencies).
            good = 0.0
            for upper, c in zip(hist.buckets_ms, snap["buckets"].values()):
                if upper <= spec.threshold_ms:
                    good += c
            return total - good, total
        # gauge: one 0/1 sample per evaluation tick.
        g = reg.get(spec.gauge)
        value = float(g.value) if g is not None else 0.0
        return (1.0 if value > spec.max_value else 0.0), 1.0

    @staticmethod
    def _window_burn(
        samples: List[Tuple[float, float, float]],
        now: float,
        window_s: float,
        spec: SloSpec,
        is_gauge: bool,
    ) -> Tuple[float, float, float]:
        """(burn, bad_fraction, events) over [now - window_s, now]."""
        in_window = [s for s in samples if s[0] >= now - window_s]
        if not in_window:
            return 0.0, 0.0, 0.0
        if is_gauge:
            # Each evaluation contributed one 0/1 observation.
            events = float(len(in_window))
            bad = float(sum(s[1] for s in in_window))
        else:
            # Cumulative counters: delta from the window's oldest sample
            # to its newest (the current one).
            base, cur = in_window[0], in_window[-1]
            bad = cur[1] - base[1]
            events = cur[2] - base[2]
        if events <= 0:
            return 0.0, 0.0, 0.0
        frac = max(0.0, bad) / events
        return frac / spec.budget, frac, events

    # ---------------------------------------------------------- evaluation

    def evaluate(self, now: Optional[float] = None) -> Dict[str, SloVerdict]:
        """One evaluation pass; returns the fresh verdicts by name."""
        now = self._clock() if now is None else float(now)
        edges: List[Tuple[SloSpec, bool, SloVerdict]] = []
        with self._lock:
            for spec in self.specs:
                bad_cum, total_cum = self._sample(spec)
                ring = self._samples[spec.name]
                ring.append((now, bad_cum, total_cum))
                # Prune beyond the slow window (keep the ring tight; the
                # oldest in-window sample is the delta base).
                while ring and ring[0][0] < now - spec.slow_window_s:
                    ring.popleft()
                if len(ring) > _RING_CAP:
                    # Memory bound WITHOUT shrinking the window: drop
                    # every other sample, keeping the oldest (the slow
                    # delta base) and the newest. Counter SLIs are
                    # cumulative so deltas are exact at any resolution;
                    # gauge SLIs keep a representative 0/1 sample mix.
                    kept = list(ring)[::2]
                    if kept[-1] != ring[-1]:
                        kept.append(ring[-1])
                    ring.clear()
                    ring.extend(kept)
                samples = list(ring)
                is_gauge = spec.sli == "gauge"
                burn_f, frac_f, events_f = self._window_burn(
                    samples, now, spec.fast_window_s, spec, is_gauge
                )
                burn_s, _, _ = self._window_burn(
                    samples, now, spec.slow_window_s, spec, is_gauge
                )
                page = (
                    events_f >= spec.min_events
                    and burn_f >= spec.page_burn
                    and burn_s >= spec.page_burn
                )
                verdict = SloVerdict(
                    spec.name, spec.subsystem, page, burn_f, burn_s,
                    frac_f, int(events_f), spec.objective,
                )
                self._verdicts[spec.name] = verdict
                was = self._paging[spec.name]
                self._paging[spec.name] = page
                if page != was:
                    edges.append((spec, page, verdict))
                    if page:
                        self._pages_total += 1
            paging_subsystems = {
                s.subsystem for s in self.specs if self._paging[s.name]
            }
            verdicts_now = dict(self._verdicts)
        # Publish outside the lock (the hub takes its own locks).
        for spec in self.specs:
            v = verdicts_now[spec.name]
            self._tel.gauge_set(f"slo_{spec.name}_burn_fast",
                                round(v.burn_fast, 3))
            self._tel.gauge_set(f"slo_{spec.name}_burn_slow",
                                round(v.burn_slow, 3))
        for spec, page, v in edges:
            if page:
                self._tel.event(
                    "slo_page", slo=spec.name, subsystem=spec.subsystem,
                    burn_fast=round(v.burn_fast, 3),
                    burn_slow=round(v.burn_slow, 3),
                )
                self._tel.flight_dump(
                    "slo_page", slo=spec.name,
                    subsystem=spec.subsystem,
                    burn_fast=round(v.burn_fast, 3),
                )
            else:
                self._tel.event(
                    "slo_clear", slo=spec.name, subsystem=spec.subsystem,
                )
                if spec.subsystem not in paging_subsystems:
                    self._tel.health(spec.subsystem).ready(
                        f"slo {spec.name} recovered"
                    )
        # Health degrade is RE-ASSERTED every evaluation, not only on
        # page edges: a page that fires while the tracker is still
        # STARTING/WARMING (or while a fresh tracker replaced the old
        # one — re-entrant entries) is an illegal-edge no-op then, and
        # an edge-only degrade would leave health READY for the whole
        # ongoing page. Idempotent when already DEGRADED.
        for sub in paging_subsystems:
            tr = self._tel.health(sub)
            if tr.state == READY:
                worst = max(
                    (
                        verdicts_now[s.name]
                        for s in self.specs
                        if s.subsystem == sub
                        and verdicts_now[s.name].page
                    ),
                    key=lambda v: v.burn_fast,
                    default=None,
                )
                if worst is not None:
                    tr.degrade(
                        f"slo {worst.name} burning "
                        f"{worst.burn_fast:.1f}x fast / "
                        f"{worst.burn_slow:.1f}x slow"
                    )
        return verdicts_now

    # ------------------------------------------------------------ queries

    def paging(self, subsystem: Optional[str] = None) -> bool:
        """Is any spec (of ``subsystem``, or at all) currently paging?
        The budget controller's second degrade input — one lock, one
        dict scan, no device work."""
        with self._lock:
            for spec in self.specs:
                if subsystem is not None and spec.subsystem != subsystem:
                    continue
                if self._paging[spec.name]:
                    return True
            return False

    @property
    def pages_total(self) -> int:
        with self._lock:
            return self._pages_total

    def verdicts(self) -> Dict[str, SloVerdict]:
        with self._lock:
            return dict(self._verdicts)

    def snapshot(self) -> dict:
        """JSON-able view for telemetry_report() and the healthz file."""
        with self._lock:
            return {
                "specs": [s.name for s in self.specs],
                "verdicts": {
                    k: v.to_dict() for k, v in sorted(
                        self._verdicts.items()
                    )
                },
                "paging": sorted({
                    s.subsystem for s in self.specs
                    if self._paging[s.name]
                }),
                "pages_total": self._pages_total,
            }
