"""Host-only, thread-safe metrics registry: counters, gauges and
fixed-bucket latency histograms (port of
``raft_ncup_tpu/observability/telemetry.py``).

One registry holds every subsystem's counters. Producers (``ServeStats``,
``StreamStats``, the retry layer, the span tracer, the admission queue,
the graph cache) mirror into it; consumers (``export.telemetry_report``,
the Prometheus dump, the SLO engine, the serve entry's ``--report``) read
it.

**Recording a metric never touches a device tensor or synchronises.**
This module is pure stdlib: it imports neither torch nor jax (an AST scan
in ``tests/test_torch_telemetry.py`` holds the whole package to that), and
:func:`host_number` rejects a ``torch.Tensor`` on any device *without*
converting it, because ``float()`` of a CUDA tensor is the
synchronisation telemetry must never add.

Names, the JAX package's scheme letter for letter (docs/OBSERVABILITY.md
has the table):

- counters: ``{subsystem}_{object}_{event}_total``, e.g.
  ``serve_requests_shed_total``, ``stream_slots_reset_total``;
- gauges: ``{subsystem}_{quantity}``, e.g. ``serve_queue_depth``;
- histograms: ``{subsystem}_{stage}_ms``, always milliseconds.

Every legacy ``report()``/``summary()`` key keeps its name:
:data:`LEGACY_KEY_ALIASES` maps each legacy stats field to its canonical
registry counter, and the stats classes mirror through it.

Percentiles are nearest-rank (the value at index ``ceil(p*n) - 1`` of the
sorted sample, rounded to 0.1 ms), as ``serving.nearest_rank_ms``
computes them; the function is repeated here so that this module imports
nothing of the serving stack. A histogram keeps fixed bucket counts for
the Prometheus dump and a bounded window of raw samples for exact
percentiles.
"""

from __future__ import annotations

import math
import re
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

# Default latency buckets (ms upper bounds). Chosen to straddle the
# measured serving stages: sub-ms queue pops up to multi-second compiles.
DEFAULT_BUCKETS_MS: Tuple[float, ...] = (
    1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
    1000.0, 2000.0, 5000.0, 10000.0, float("inf"),
)

# Bounded raw-sample window per histogram: nearest-rank percentiles are
# exact while a window fits (every serve window does), sliding
# (most recent) beyond it. Bounds memory: 8 KB/histogram at the default.
DEFAULT_SAMPLE_CAP = 4096


# Top-level packages whose values live on a device (torch tensors on any
# device, jax arrays and tracers).
_DEVICE_ROOTS = ("torch", "jax", "jaxlib")


def host_number(value, what: str = "metric value") -> float:
    """Return ``value`` as a host float, REJECTING device values.

    ``float()`` of a CUDA tensor blocks until the card is done: the
    synchronisation telemetry must never add. The check reads the modules
    of the type and its bases and raises *before* any conversion, so a
    ``torch.Tensor`` on any device, a subclass of it, and a ``jax`` or
    ``jaxlib`` array are refused without being touched; this module never
    imports torch."""
    for cls in type(value).__mro__:
        mod = cls.__module__ or ""
        if mod.partition(".")[0] in _DEVICE_ROOTS:
            raise TypeError(
                f"telemetry {what} is a device value ({type(value).__name__}, a "
                f"{mod}.{cls.__name__}): recording it would synchronise with the "
                "device. Copy it to the host where the caller already reads "
                "results, and record the host number."
            )
    return float(value)


_PROM_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")
_PROM_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_:]")


def prometheus_name(name: str) -> str:
    """Sanitize a registry name into the exposition-format charset
    (``[a-zA-Z_:][a-zA-Z0-9_:]*``): invalid characters become ``_``, a
    leading digit gets a ``_`` prefix. Registry names follow the
    snake_case convention and pass through untouched; the sanitizer
    exists so a free-form span name can never emit a line a real
    scraper rejects (scrapers fail the WHOLE scrape on one bad line)."""
    if _PROM_NAME_OK.match(name):
        return name
    safe = _PROM_BAD_CHARS.sub("_", name)
    if not safe or not (safe[0].isalpha() or safe[0] in "_:"):
        safe = "_" + safe
    return safe


def prometheus_help(text: str) -> str:
    """Escape HELP text per the exposition format (backslash and
    newline are the two escaped characters on HELP lines)."""
    return text.replace("\\", r"\\").replace("\n", r"\n")


def nearest_rank_ms(latencies_ms: Sequence[float], p: float) -> Optional[float]:
    """Nearest-rank percentile of an ms sample (``serving.nearest_rank_ms``
    discipline, already-in-ms variant): sorted value at index
    ``ceil(p*n) - 1``, rounded to 0.1 ms; ``None`` on empty."""
    if not latencies_ms:
        return None
    xs = sorted(latencies_ms)
    idx = max(0, math.ceil(p * len(xs)) - 1)
    return round(xs[min(idx, len(xs) - 1)], 1)


class Counter:
    """Monotonic event counter. ``inc`` is the only mutation."""

    __slots__ = ("name", "help", "_value", "_lock")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n=1) -> None:
        n = host_number(n, f"counter {self.name} increment")
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins instantaneous value, with a high-water mark
    (``peak``) so a burst that is gone by snapshot time still shows."""

    __slots__ = ("name", "help", "_value", "_peak", "_lock")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._peak = 0.0
        self._lock = threading.Lock()

    def set(self, value) -> None:
        value = host_number(value, f"gauge {self.name}")
        with self._lock:
            self._value = value
            if value > self._peak:
                self._peak = value

    def add(self, delta) -> None:
        delta = host_number(delta, f"gauge {self.name} delta")
        with self._lock:
            self._value += delta
            if self._value > self._peak:
                self._peak = self._value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    @property
    def peak(self) -> float:
        with self._lock:
            return self._peak


class Histogram:
    """Fixed-bucket latency histogram (milliseconds) with exact
    nearest-rank percentiles over a bounded sliding sample window."""

    __slots__ = (
        "name", "help", "buckets_ms", "_counts", "_count", "_sum_ms",
        "_samples", "_lock",
    )

    def __init__(
        self,
        name: str,
        help: str = "",
        buckets_ms: Sequence[float] = DEFAULT_BUCKETS_MS,
        sample_cap: int = DEFAULT_SAMPLE_CAP,
    ):
        bs = tuple(sorted(float(b) for b in buckets_ms))
        if not bs or bs[-1] != float("inf"):
            bs = bs + (float("inf"),)
        self.name = name
        self.help = help
        self.buckets_ms = bs
        self._counts = [0] * len(bs)
        self._count = 0
        self._sum_ms = 0.0
        # deque(maxlen): O(1) append-with-evict on the hot path (a list
        # pop(0) would memmove sample_cap floats per observation once
        # full); percentile/snapshot copy before sorting anyway.
        self._samples: deque = deque(maxlen=max(1, int(sample_cap)))
        self._lock = threading.Lock()

    def observe_ms(self, ms) -> None:
        ms = host_number(ms, f"histogram {self.name} observation")
        with self._lock:
            for i, upper in enumerate(self.buckets_ms):
                if ms <= upper:
                    self._counts[i] += 1
                    break
            self._count += 1
            self._sum_ms += ms
            self._samples.append(ms)  # maxlen evicts the oldest

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum_ms(self) -> float:
        with self._lock:
            return self._sum_ms

    def percentile_ms(self, p: float) -> Optional[float]:
        """Exact nearest-rank percentile over the (windowed) raw sample —
        the ``serving.nearest_rank_ms`` discipline; parity test-pinned."""
        with self._lock:
            samples = list(self._samples)
        return nearest_rank_ms(samples, p)

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            count, total = self._count, self._sum_ms
            samples = list(self._samples)
        return {
            "count": count,
            "sum_ms": round(total, 3),
            "p50_ms": nearest_rank_ms(samples, 0.50),
            "p99_ms": nearest_rank_ms(samples, 0.99),
            "buckets": {
                ("+Inf" if math.isinf(u) else f"{u:g}"): c
                for u, c in zip(self.buckets_ms, counts)
            },
        }


class MetricsRegistry:
    """Thread-safe name -> metric map with get-or-create accessors.

    A name is permanently bound to its first-registered kind — asking for
    ``counter(x)`` after ``gauge(x)`` is a programming error and raises
    (two subsystems silently sharing one name across kinds is exactly the
    accounting corruption a registry exists to prevent).
    """

    def __init__(self, sample_cap: int = DEFAULT_SAMPLE_CAP):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()
        self._sample_cap = sample_cap

    def _get_or_create(self, name: str, kind, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, kind):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {kind.__name__}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(
            name, Counter, lambda: Counter(name, help)
        )

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, lambda: Gauge(name, help))

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets_ms: Sequence[float] = DEFAULT_BUCKETS_MS,
    ) -> Histogram:
        return self._get_or_create(
            name,
            Histogram,
            lambda: Histogram(name, help, buckets_ms, self._sample_cap),
        )

    def get(self, name: str):
        """The metric or None — readers must not create phantom zeros."""
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> list:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> dict:
        """One JSON-able view: {counters: {...}, gauges: {...},
        histograms: {name: {count, sum_ms, p50_ms, p99_ms, buckets}}}."""
        with self._lock:
            items = sorted(self._metrics.items())
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in items:
            if isinstance(m, Counter):
                v = m.value
                out["counters"][name] = int(v) if v == int(v) else v
            elif isinstance(m, Gauge):
                out["gauges"][name] = {"value": m.value, "peak": m.peak}
            elif isinstance(m, Histogram):
                out["histograms"][name] = m.snapshot()
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition of every metric, compliant with
        the text format a real scraper parses unmodified (pinned by
        tests/test_torch_telemetry.py):

        - metric names sanitized to ``[a-zA-Z_:][a-zA-Z0-9_:]*``
          (:func:`prometheus_name`) — registry names are free-form
          strings, exposition names are not;
        - ``# HELP`` text escaped (backslash, newline);
        - every exposed metric family gets its own ``# TYPE`` line — in
          particular the gauge's ``_peak`` companion is its own gauge
          family, not an untyped stray sample;
        - histograms expose the full ``_bucket{le=...}`` (cumulative,
          ending at ``le="+Inf"`` == ``_count``) + ``_sum`` + ``_count``
          triplet.
        """
        with self._lock:
            items = sorted(self._metrics.items())
        lines: List[str] = []
        for raw_name, m in items:
            name = prometheus_name(raw_name)
            if m.help:
                lines.append(f"# HELP {name} {prometheus_help(m.help)}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {m.value:g}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {m.value:g}")
                lines.append(f"# TYPE {name}_peak gauge")
                lines.append(f"{name}_peak {m.peak:g}")
            elif isinstance(m, Histogram):
                snap = m.snapshot()
                lines.append(f"# TYPE {name} histogram")
                cum = 0
                for upper, c in snap["buckets"].items():
                    cum += c
                    lines.append(
                        f'{name}_bucket{{le="{upper}"}} {cum}'
                    )
                lines.append(f"{name}_sum {snap['sum_ms']:g}")
                lines.append(f"{name}_count {snap['count']}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        """Drop every metric (test isolation)."""
        with self._lock:
            self._metrics.clear()


# --------------------------------------------------------- alias tables
#
# The pinned legacy-alias map: every ``report()``/``summary()`` field of
# the stats classes, keyed by subsystem prefix, mapped to its canonical
# registry counter (the JAX package's names, letter for letter, since the
# fleet's readers and ``aggregate_registry`` read them). The stats classes
# mirror through THIS table, and tests/test_torch_telemetry_wiring.py pins
# that every field has an alias and that the mirrored counters equal the
# fields after a run.

LEGACY_KEY_ALIASES: Dict[str, Dict[str, str]] = {
    "serve": {
        "submitted": "serve_requests_submitted_total",
        "accepted": "serve_requests_accepted_total",
        "completed": "serve_requests_completed_total",
        "shed": "serve_requests_shed_total",
        "timeouts": "serve_requests_timeout_total",
        "rejected": "serve_requests_rejected_total",
        "errors": "serve_requests_error_total",
        "batches": "serve_batches_total",
        "padded_rows": "serve_batch_padded_rows_total",
    },
    "stream": {
        "submitted": "stream_frames_submitted_total",
        "accepted": "stream_frames_accepted_total",
        "completed": "stream_frames_completed_total",
        "shed_streams": "stream_streams_shed_total",
        "shed_frames": "stream_frames_shed_total",
        "rejected": "stream_frames_rejected_total",
        "resets": "stream_slots_reset_total",
        "errors": "stream_frames_error_total",
        "batches": "stream_batches_total",
        "padded_rows": "stream_batch_padded_rows_total",
        "streams_opened": "stream_streams_opened_total",
        "streams_closed": "stream_streams_closed_total",
        "streams_evicted": "stream_streams_evicted_total",
        "cold_starts": "stream_frames_cold_start_total",
    },
    # RetryStats fields: counted via the retry layer's ring events
    # (`io_retry`/`io_giveup`), whose auto-counters carry the canonical
    # names below.
    "retry": {
        "retries": "io_retry_total",
        "giveups": "io_giveup_total",
    },
    # ShapeCachedForward's stats. The port's cache keeps the JAX key
    # "compiles" for what is on the card a CUDA graph capture (on the CPU
    # the first eager call of a key): a capture is the port's counterpart
    # of an executable's compile, so it maps onto the same counter.
    "inference": {
        "compiles": "inference_executable_compiles_total",
        "hits": "inference_executable_hits_total",
        "evictions": "inference_executable_evictions_total",
    },
}
