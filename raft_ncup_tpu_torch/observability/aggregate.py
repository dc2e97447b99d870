"""Fleet telemetry aggregation: stitch per-process exports into one trace
tree and one registry view (port of
``raft_ncup_tpu/observability/aggregate.py``; docs/OBSERVABILITY.md
"Trace propagation and aggregation").

A fleet run leaves one export tree: the router's flight dumps (its span
ring and the clock-handshake offsets), each replica's
``replica_<i>_flight/`` dumps and optionally each replica's
``replica_<i>_telemetry.jsonl`` snapshots. This module merges them
offline, and reads the port's files and the JAX package's alike (one
format):

- :func:`collect_fleet_records` reads the latest parsable dump per
  process and the handshake's clock offsets;
- :func:`fleet_traces` groups every record by ``trace_id`` (a batch
  span's plural ``trace_ids`` matches too), translates replica-side
  times onto the router's clock and orders each trace into one timeline;
- :func:`hop_attribution` derives the per-hop latency breakdown (router
  queue, wire, replica queue, device, return), clamped at zero;
- :func:`aggregate_registry` merges the replicas' registry snapshots
  (counters summed, gauges maxed) and lists replicas whose exports are
  missing or unreadable in ``gaps``.

Everything is tolerant: a replica that died mid-write leaves a truncated
JSONL line or a torn dump, and those are skipped and counted, never
raised. Pure stdlib, no torch, no device.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Tuple

from raft_ncup_tpu_torch.observability.flight import match_records

ROUTER_ORIGIN = "router"

_REPLICA_FLIGHT_RE = re.compile(r"^replica_(\d+)_flight$")
_REPLICA_ANY_RE = re.compile(r"^replica_(\d+)[._]")

# Replica-side span/event names that belong to a request's journey, in
# rough pipeline order (used only for display ordering fallbacks).
QUEUE_WAIT_NAMES = ("serve_queue_wait", "stream_queue_wait")
DRAIN_NAMES = ("serve_drain", "stream_drain")
DISPATCH_NAMES = ("serve_dispatch", "stream_dispatch")


# --------------------------------------------------------------- readers


def read_jsonl_tolerant(path: str) -> Tuple[List[dict], int]:
    """Read a JSONL export, skipping (and counting) unparsable lines —
    the truncated-mid-write tail a killed replica leaves behind.
    Returns ``(records, skipped)``; a missing file is ``([], 0)``."""
    records: List[dict] = []
    skipped = 0
    try:
        fh = open(path, encoding="utf-8")
    except OSError:
        return records, skipped
    with fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                skipped += 1
                continue
            if isinstance(rec, dict):
                records.append(rec)
            else:
                skipped += 1
    return records, skipped


def dump_sort_key(path: str):
    """Deterministic recency order for ``flight_<trigger>_<ts>_<seq>``
    names (the scripts/postmortem.py rule: embedded (timestamp, seq),
    never mtime). Unparsable names sort oldest."""
    stem = os.path.basename(path)
    if stem.endswith(".json"):
        stem = stem[: -len(".json")]
    parts = stem.split("_")
    if len(parts) >= 3 and parts[-1].isdigit():
        return (1, parts[-2], int(parts[-1]), stem)
    return (0, "", 0, stem)


def load_dump_tolerant(path: str) -> Optional[dict]:
    """One flight dump, or ``None`` when torn/foreign (counted by the
    caller) — the aggregator must survive the evidence of a crash."""
    try:
        with open(path, encoding="utf-8") as fh:
            dump = json.load(fh)
    except (OSError, ValueError):
        return None
    if not isinstance(dump, dict) or "spans" not in dump:
        return None
    return dump


def _latest_parsable_dump(paths: List[str]) -> Tuple[Optional[dict], int]:
    """The newest dump that parses, walking backwards through older
    ones when the newest is torn. Returns ``(dump, skipped)``."""
    skipped = 0
    for p in sorted(paths, key=dump_sort_key, reverse=True):
        dump = load_dump_tolerant(p)
        if dump is not None:
            return dump, skipped
        skipped += 1
    return None, skipped


def _dumps_under(root: str) -> List[str]:
    out = []
    for dirpath, _, files in os.walk(root):
        out.extend(
            os.path.join(dirpath, f)
            for f in files
            if f.startswith("flight_") and f.endswith(".json")
        )
    return out


# ------------------------------------------------------------ collection


def collect_fleet_records(base_dir: str) -> dict:
    """Read a fleet export tree into one host-side structure::

        {"origins":       {"router": [records...], "replica_0": [...]},
         "clock_offsets": {0: replica0_mono - router_mono, ...},
         "replicas":      [0, 1, ...],   # replicas with records
         "expected":      [0, 1, 2],     # replicas the tree names at all
         "gaps":          [2],           # expected but no parsable dump
         "skipped_dumps": 1}

    Per process the LATEST parsable dump wins (a drain dump holds the
    fullest ring; older dumps of the same process overlap it). Router
    records are every ``flight_*.json`` outside the
    ``replica_<i>_flight/`` subtrees; clock offsets come from router
    dump contexts (``router_drain``) plus any ``fleet_clock_handshake``
    events in the router's ring.
    """
    origins: Dict[str, List[dict]] = {}
    offsets: Dict[int, float] = {}
    expected: set = set()
    gaps: List[int] = []
    skipped = 0

    replica_dirs: Dict[int, str] = {}
    router_dump_paths: List[str] = []
    try:
        entries = sorted(os.listdir(base_dir))
    except OSError:
        entries = []
    for name in entries:
        full = os.path.join(base_dir, name)
        m = _REPLICA_FLIGHT_RE.match(name)
        if m and os.path.isdir(full):
            idx = int(m.group(1))
            replica_dirs[idx] = full
            expected.add(idx)
            continue
        m = _REPLICA_ANY_RE.match(name)
        if m:
            # Sockets/healthz/telemetry files name the replica even when
            # it never dumped — that is how a dead replica becomes a
            # GAP instead of silently absent.
            expected.add(int(m.group(1)))
        if os.path.isdir(full):
            router_dump_paths.extend(_dumps_under(full))
        elif name.startswith("flight_") and name.endswith(".json"):
            router_dump_paths.append(full)

    router_dump, s = _latest_parsable_dump(router_dump_paths)
    skipped += s
    if router_dump is not None:
        origins[ROUTER_ORIGIN] = list(router_dump.get("spans") or [])
        ctx_offsets = (router_dump.get("context") or {}).get(
            "clock_offsets"
        ) or {}
        for k, v in ctx_offsets.items():
            try:
                offsets[int(k)] = float(v)
            except (TypeError, ValueError):
                continue
        for rec in origins[ROUTER_ORIGIN]:
            if rec.get("name") == "fleet_clock_handshake":
                attrs = rec.get("attrs") or {}
                try:
                    offsets[int(attrs["replica"])] = float(
                        attrs["offset_s"]
                    )
                except (KeyError, TypeError, ValueError):
                    continue

    for idx in sorted(expected):
        paths = (
            _dumps_under(replica_dirs[idx]) if idx in replica_dirs else []
        )
        dump, s = _latest_parsable_dump(paths)
        skipped += s
        if dump is None:
            gaps.append(idx)
            continue
        origins[f"replica_{idx}"] = list(dump.get("spans") or [])

    return {
        "origins": origins,
        "clock_offsets": offsets,
        "replicas": sorted(
            int(o.split("_", 1)[1]) for o in origins
            if o != ROUTER_ORIGIN
        ),
        "expected": sorted(expected),
        "gaps": gaps,
        "skipped_dumps": skipped,
    }


# ----------------------------------------------------------- trace trees


def _record_trace_ids(record: dict) -> List[str]:
    attrs = record.get("attrs") or {}
    out = []
    tid = attrs.get("trace_id")
    if isinstance(tid, str):
        out.append(tid)
    tids = attrs.get("trace_ids")
    if isinstance(tids, list):
        out.extend(t for t in tids if isinstance(t, str))
    return out


def _origin_offset(origin: str, offsets: Dict[int, float]) -> float:
    if origin == ROUTER_ORIGIN:
        return 0.0
    try:
        return float(offsets.get(int(origin.split("_", 1)[1]), 0.0))
    except (ValueError, IndexError):
        return 0.0


def fleet_traces(
    collected: dict,
    trace_id: Optional[str] = None,
    request_id: Optional[int] = None,
) -> List[dict]:
    """Group the collected records into per-trace timelines.

    Each trace is::

        {"trace_id": ..., "request_id": ..., "origins": ["router",
         "replica_1"], "records": [tagged records, time-ordered],
         "hops": hop_attribution(...), "total_ms": float | None}

    A tagged record is the ring record plus ``origin`` and ``t`` — its
    start translated onto the ROUTER's monotonic clock (``t_s -
    offset``), which is what makes one cross-process timeline orderable
    at all. Filters narrow to one ``trace_id`` or ``request_id``.
    Traces sort slowest-first by ``total_ms`` (unknown durations last).
    """
    offsets = collected.get("clock_offsets") or {}
    by_trace: Dict[str, List[dict]] = {}
    for origin, records in (collected.get("origins") or {}).items():
        off = _origin_offset(origin, offsets)
        for rec in records:
            tids = _record_trace_ids(rec)
            if not tids:
                continue
            t = rec.get("t_s")
            tagged = dict(rec)
            tagged["origin"] = origin
            tagged["t"] = None if t is None else round(float(t) - off, 6)
            for tid in tids:
                by_trace.setdefault(tid, []).append(tagged)
    traces = []
    for tid, records in by_trace.items():
        if trace_id is not None and tid != trace_id:
            continue
        if request_id is not None and not match_records(
            records, request_id=request_id
        ):
            continue
        records.sort(
            key=lambda r: (r["t"] is None, r["t"] or 0.0)
        )
        root = next(
            (r for r in records if r.get("name") == "fleet_request"),
            None,
        )
        rid = None
        for r in records:
            attrs = r.get("attrs") or {}
            if isinstance(attrs.get("request_id"), int):
                rid = attrs["request_id"]
                break
        traces.append({
            "trace_id": tid,
            "request_id": rid,
            "origins": sorted({r["origin"] for r in records}),
            "records": records,
            "hops": hop_attribution(records),
            "total_ms": None if root is None else root.get("duration_ms"),
        })
    traces.sort(
        key=lambda tr: (
            tr["total_ms"] is None, -(tr["total_ms"] or 0.0)
        )
    )
    return traces


def _first(records: List[dict], *names: str) -> Optional[dict]:
    for r in records:
        if r.get("name") in names:
            return r
    return None


def hop_attribution(records: List[dict]) -> dict:
    """Per-hop latency breakdown of one trace's tagged records:
    ``router_queue_ms`` (submit → wire send), ``wire_ms`` (send →
    replica receive, the replica-measured ``fleet_wire_hop`` when
    present), ``replica_queue_ms`` (replica admission → batch
    assembly), ``device_ms`` (dispatch → delivered, compute + the
    sanctioned pull), ``return_ms`` (the residual: response wire +
    router completion). Every value is clamped at 0 — the clock-offset
    estimate carries up to rtt/2 of error and a hop must never read
    negative. Keys are absent when the evidence for them is (a dead
    replica's ring never exported)."""
    hops: Dict[str, float] = {}
    root = _first(records, "fleet_request")
    dispatch_ev = _first(records, "fleet_dispatch")
    wire = _first(records, "fleet_wire_hop")
    queue = _first(records, *QUEUE_WAIT_NAMES)
    drain = _first(records, *DRAIN_NAMES)
    if root is not None and root.get("t") is not None \
            and dispatch_ev is not None and dispatch_ev.get("t") is not None:
        hops["router_queue_ms"] = round(
            max(0.0, (dispatch_ev["t"] - root["t"]) * 1e3), 3
        )
    if wire is not None and wire.get("duration_ms") is not None:
        hops["wire_ms"] = max(0.0, wire["duration_ms"])
    elif (
        dispatch_ev is not None and dispatch_ev.get("t") is not None
        and queue is not None and queue.get("t") is not None
    ):
        hops["wire_ms"] = round(
            max(0.0, (queue["t"] - dispatch_ev["t"]) * 1e3), 3
        )
    if queue is not None and queue.get("duration_ms") is not None:
        hops["replica_queue_ms"] = max(0.0, queue["duration_ms"])
    if drain is not None and drain.get("duration_ms") is not None:
        hops["device_ms"] = max(0.0, drain["duration_ms"])
    total = None if root is None else root.get("duration_ms")
    if total is not None and hops:
        hops["return_ms"] = round(
            max(0.0, total - sum(hops.values())), 3
        )
    return hops


def render_trace(trace: dict) -> List[str]:
    """Human-readable lines for one stitched trace (the postmortem /
    trace_report view): the cross-process timeline indented under the
    root, then the per-hop breakdown."""
    head = (
        f"trace {trace['trace_id']}  request_id="
        f"{trace['request_id']}  total "
        + (
            f"{trace['total_ms']:.1f} ms"
            if trace["total_ms"] is not None else "?"
        )
        + f"  [{', '.join(trace['origins'])}]"
    )
    lines = [head]
    t0 = next(
        (r["t"] for r in trace["records"] if r["t"] is not None), None
    )
    for r in trace["records"]:
        dt = (
            "      --"
            if r["t"] is None or t0 is None
            else f"{(r['t'] - t0) * 1e3:+8.1f}"
        )
        dur = r.get("duration_ms")
        dur_s = f"{dur:9.3f} ms" if dur is not None else "         --"
        kind = "event" if r.get("event") else "span "
        lines.append(
            f"  {dt}  {r['origin']:<10} {kind} {dur_s}  {r['name']}"
        )
    hops = trace.get("hops") or {}
    if hops:
        lines.append(
            "  hops: " + " | ".join(
                f"{k[:-3]} {v:.1f} ms" for k, v in hops.items()
            )
        )
    return lines


# ------------------------------------------------------- registry merge


def latest_snapshot_report(path: str) -> Tuple[Optional[dict], int]:
    """The newest ``telemetry_snapshot`` report in a replica's periodic
    JSONL export, skipping truncated lines. ``(report, skipped)``."""
    records, skipped = read_jsonl_tolerant(path)
    for rec in reversed(records):
        if rec.get("name") == "telemetry_snapshot" and isinstance(
            rec.get("report"), dict
        ):
            return rec["report"], skipped
    return None, skipped


def aggregate_registry(
    base_dir: str, n_replicas: Optional[int] = None
) -> dict:
    """One fleet-wide registry view from the per-replica exports:
    counters SUMMED (fleet totals), gauges MAXED on value and peak (the
    worst replica is the capacity question), with the per-replica
    sources kept alongside. A replica with no readable export lands in
    ``gaps`` — the merge SKIPS it and says so, never averages around it
    silently. Prefers the periodic ``replica_<i>_telemetry.jsonl``
    snapshot (fresher than a fault dump); falls back to the latest
    flight dump's embedded report."""
    collected_idx: set = set()
    try:
        for name in os.listdir(base_dir):
            m = _REPLICA_ANY_RE.match(name)
            if m:
                collected_idx.add(int(m.group(1)))
    except OSError:
        pass
    if n_replicas is not None:
        collected_idx |= set(range(int(n_replicas)))
    counters: Dict[str, float] = {}
    gauges: Dict[str, dict] = {}
    per_replica: Dict[int, Optional[dict]] = {}
    gaps: List[int] = []
    skipped_lines = 0
    for idx in sorted(collected_idx):
        report, skipped = latest_snapshot_report(
            os.path.join(base_dir, f"replica_{idx}_telemetry.jsonl")
        )
        skipped_lines += skipped
        if report is None:
            dump, _ = _latest_parsable_dump(_dumps_under(
                os.path.join(base_dir, f"replica_{idx}_flight")
            ))
            if dump is not None and isinstance(dump.get("report"), dict):
                report = dump["report"]
        if report is None:
            gaps.append(idx)
            per_replica[idx] = None
            continue
        metrics = report.get("metrics") or {}
        per_replica[idx] = metrics
        for name, v in (metrics.get("counters") or {}).items():
            try:
                counters[name] = counters.get(name, 0) + float(v)
            except (TypeError, ValueError):
                continue
        for name, g in (metrics.get("gauges") or {}).items():
            if not isinstance(g, dict):
                continue
            cur = gauges.setdefault(
                name, {"value": float("-inf"), "peak": float("-inf")}
            )
            for k in ("value", "peak"):
                try:
                    cur[k] = max(cur[k], float(g.get(k)))
                except (TypeError, ValueError):
                    continue
    gauges = {
        k: {
            kk: (None if vv == float("-inf") else vv)
            for kk, vv in g.items()
        }
        for k, g in gauges.items()
    }
    counters = {
        k: int(v) if v == int(v) else v for k, v in counters.items()
    }
    return {
        "counters": counters,
        "gauges": gauges,
        "per_replica": per_replica,
        "replicas": sorted(i for i in per_replica if per_replica[i]),
        "gaps": gaps,
        "skipped_lines": skipped_lines,
    }
