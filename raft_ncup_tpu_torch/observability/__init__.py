"""Telemetry for the port (port of ``raft_ncup_tpu/observability/``):
metrics registry, span tracer and export, and the consumer half that
closes the loop: health state machine, SLO burn-rate engine and fault
flight recorder (docs/OBSERVABILITY.md describes the JAX package's, which
this mirrors name for name).

One registry, one event stream, every subsystem a producer: serving,
streaming, the graph cache and the resilience layer mirror their
accounting here without changing a legacy ``report()`` key
(``telemetry.LEGACY_KEY_ALIASES``). Declared SLOs burn against the
registry, paging verdicts flip per-subsystem health READY <-> DEGRADED
and degrade the server's iteration budget, and every fault trigger banks
one bounded atomic flight-recorder dump.

Host-only by construction: this package imports neither torch nor jax
(an AST scan in ``tests/test_torch_telemetry.py`` holds it to that),
``telemetry.host_number`` refuses a tensor at run time, and
``chip_smoke.py`` checks on the card that no primitive synchronises.
"""

from raft_ncup_tpu_torch.observability.aggregate import (
    aggregate_registry,
    collect_fleet_records,
    fleet_traces,
    hop_attribution,
    read_jsonl_tolerant,
    render_trace,
)
from raft_ncup_tpu_torch.observability.export import (
    JsonlSink,
    PeriodicSnapshot,
    Telemetry,
    get_telemetry,
    prometheus_text,
    set_telemetry,
    telemetry_report,
    write_healthz,
)
from raft_ncup_tpu_torch.observability.flight import (
    FlightRecorder,
    load_dump,
    match_records,
)
from raft_ncup_tpu_torch.observability.health import (
    DEGRADED,
    DRAINING,
    HALTED,
    READY,
    STARTING,
    STATE_CODES,
    WARMING,
    HealthTracker,
    overall_state,
)
from raft_ncup_tpu_torch.observability.slo import (
    SloEngine,
    SloSpec,
    serve_slos,
    stream_slos,
)
from raft_ncup_tpu_torch.observability.spans import (
    NOOP_SPAN,
    Span,
    SpanTracer,
    TraceContext,
    new_span_id,
    new_trace_id,
)
from raft_ncup_tpu_torch.observability.telemetry import (
    DEFAULT_BUCKETS_MS,
    LEGACY_KEY_ALIASES,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    host_number,
)

__all__ = [
    "Counter",
    "DEFAULT_BUCKETS_MS",
    "DEGRADED",
    "DRAINING",
    "FlightRecorder",
    "Gauge",
    "HALTED",
    "HealthTracker",
    "Histogram",
    "JsonlSink",
    "LEGACY_KEY_ALIASES",
    "MetricsRegistry",
    "NOOP_SPAN",
    "PeriodicSnapshot",
    "READY",
    "STARTING",
    "STATE_CODES",
    "SloEngine",
    "SloSpec",
    "Span",
    "SpanTracer",
    "Telemetry",
    "TraceContext",
    "WARMING",
    "aggregate_registry",
    "collect_fleet_records",
    "fleet_traces",
    "get_telemetry",
    "hop_attribution",
    "host_number",
    "load_dump",
    "match_records",
    "new_span_id",
    "new_trace_id",
    "overall_state",
    "prometheus_text",
    "read_jsonl_tolerant",
    "render_trace",
    "serve_slos",
    "set_telemetry",
    "stream_slos",
    "telemetry_report",
    "write_healthz",
]
