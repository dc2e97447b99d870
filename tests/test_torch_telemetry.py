"""The port's telemetry (``raft_ncup_tpu_torch/observability/``, its knobs,
``utils/flops.py`` and the cost ledger's arithmetic) against the JAX
package's ``raft_ncup_tpu.observability`` on the same inputs, on the CPU.

Both packages are fed the same sequences, drawn from numpy seeds, on the
same injected clocks, and their results are compared exactly: tolerance 0
for counts, states, codes, verdicts and file contents, and 1e-9 (relative)
for float sums.

- the registry (counters, gauges, histograms: ``snapshot`` and the
  Prometheus text), ``host_number`` refusing a tensor without converting
  it, the span tracer's ring and stage summaries, the health machine, the
  SLO engine's verdicts, burn rates and page edges (``serve_slos`` and
  ``stream_slos``) and the budget's ``slo_degraded`` input;
- the flight recorder: a port dump loads with JAX's ``load_dump`` and the
  reverse, and rate limit and cap behave alike;
- files written by both packages' sinks read alike by both packages'
  ``read_jsonl_tolerant``, ``aggregate_registry`` and ``fleet_traces``;
- ``forward_flops`` / ``train_step_flops`` for every variant, small and
  full, both correlation settings; ``mfu``; the peak table;
- the port's ``observability/`` imports neither torch nor jax (AST scan).
"""

import ast
import json
import os

import jax  # noqa: F401  (the test process keeps JAX on the CPU)
import numpy as np
import pytest
import torch

import raft_ncup_tpu.config as jax_config
import raft_ncup_tpu.inference.costs as jax_costs
import raft_ncup_tpu.observability as jobs
import raft_ncup_tpu.utils.flops as jax_flops
import raft_ncup_tpu_torch.config as port_config
import raft_ncup_tpu_torch.inference.costs as port_costs
import raft_ncup_tpu_torch.observability as pobs
import raft_ncup_tpu_torch.utils.flops as port_flops
from raft_ncup_tpu.serving.budget import IterationBudgetController as JaxBudget
from raft_ncup_tpu_torch.serving.budget import IterationBudgetController as PortBudget
from raft_ncup_tpu_torch.utils import knobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS = os.path.join(REPO, "raft_ncup_tpu_torch", "observability")
FLOAT_RTOL = 1e-9
PACKAGES = (jobs, pobs)


class Clock:
    """A monotonic fake clock both packages' objects read."""

    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _feed_registry(reg, seed):
    g = np.random.default_rng(seed)
    for _ in range(300):
        kind = g.integers(3)
        name = f"m{g.integers(6)}"
        if kind == 0:
            reg.counter(f"c_{name}_total").inc(int(g.integers(1, 4)))
            reg.counter(f"f_{name}_total").inc(float(g.uniform(0, 2)))
        elif kind == 1:
            reg.gauge(f"g_{name}").set(float(g.normal(0, 5)))
            reg.gauge(f"g_{name}").add(float(g.normal()))
        else:
            reg.histogram(f"h_{name}_ms").observe_ms(float(g.lognormal(2.0, 1.5)))
    reg.counter("odd name-with.dots", help="a\\help\nline").inc()
    reg.gauge("9starts_with_digit").set(3)


def test_registry_snapshot_and_prometheus_text_match_jax():
    regs = [pkg.MetricsRegistry(sample_cap=64) for pkg in PACKAGES]
    for reg in regs:
        _feed_registry(reg, seed=0)
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].prometheus_text() == regs[1].prometheus_text()
    # Float sums: the same to a relative 1e-9 (they are in fact equal).
    a, b = (r.get("f_m0_total").value for r in regs)
    assert a == pytest.approx(b, rel=FLOAT_RTOL)
    # A name stays bound to its first kind, in both packages.
    for reg in regs:
        with pytest.raises(TypeError):
            reg.gauge("c_m0_total")


def test_nearest_rank_and_name_sanitizing_match_jax():
    g = np.random.default_rng(1)
    for n in (1, 2, 7, 100):
        xs = list(g.uniform(0, 1000, n))
        for p in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert (pobs.telemetry.nearest_rank_ms(xs, p)
                    == jobs.telemetry.nearest_rank_ms(xs, p))
    for name in ("ok_name", "9lead", "a-b.c d", "", ":colon"):
        assert pobs.telemetry.prometheus_name(name) == jobs.telemetry.prometheus_name(name)


class _NoFloat(torch.Tensor):
    """A tensor that fails the test if anything converts it to a float."""

    def __float__(self):
        raise AssertionError("host_number converted a tensor")

    def item(self):
        raise AssertionError("host_number read a tensor")


def test_host_number_rejects_a_tensor_without_converting_it():
    bad = torch.tensor(2.5).as_subclass(_NoFloat)
    reg = pobs.MetricsRegistry()
    tel = pobs.Telemetry()
    for record in (pobs.host_number, reg.counter("c_total").inc, reg.gauge("g").set,
                   reg.histogram("h_ms").observe_ms, lambda v: tel.observe_ms("s", v),
                   lambda v: tel.event("e", attr=v), lambda v: tel.span("s", attr=v)):
        with pytest.raises(TypeError, match="device value"):
            record(bad)
    for plain in (torch.tensor(1.0), torch.nn.Parameter(torch.ones(()))):
        with pytest.raises(TypeError, match="device value"):
            pobs.host_number(plain)
    # Host numbers pass, numpy scalars included, as in JAX's.
    for v in (3, 2.5, np.float32(1.5), np.int64(7), True):
        assert pobs.host_number(v) == jobs.host_number(v)
    assert reg.snapshot()["counters"] == {"c_total": 0}  # created, never moved


def _drive_tracer(tel, clock):
    g = np.random.default_rng(2)
    for batch in range(6):
        with tel.span("serve_batch_assembly", batch_id=batch, batch_size=2):
            clock.t += float(g.uniform(0, 0.002))
            for rid in (2 * batch, 2 * batch + 1):
                tel.observe_ms("serve_queue_wait", float(g.uniform(0, 40)), request_id=rid,
                               batch_id=batch)
        with tel.span("serve_dispatch", batch_id=batch, request_ids=[2 * batch, 2 * batch + 1],
                      mesh="nomesh", policy="f32") as sp:
            clock.t += float(g.uniform(0.01, 0.06))
            sp.set(iters=12)
        tel.event("inference_executable_compile", key=f"k{batch}")
        tel.hist_observe("serve_e2e_ms", float(g.uniform(10, 90)))


def test_span_ring_and_stage_summary_match_jax():
    clocks = [Clock(), Clock()]
    tels = [pkg.Telemetry(clock=c, span_capacity=16) for pkg, c in zip(PACKAGES, clocks)]
    for tel, clock in zip(tels, clocks):
        _drive_tracer(tel, clock)
    j, p = tels
    assert p.tracer.records() == j.tracer.records()
    assert p.tracer.dropped == j.tracer.dropped > 0  # the ring is bounded
    assert p.tracer.stage_summary() == j.tracer.stage_summary()
    assert p.tracer.for_attr(request_id=5) == j.tracer.for_attr(request_id=5)
    assert p.registry.snapshot() == j.registry.snapshot()
    # A trace context crosses the wire the same way.
    ctx = pobs.TraceContext("abcd", "ef", 0.25, 1.5)
    assert ctx.to_wire() == jobs.TraceContext("abcd", "ef", 0.25, 1.5).to_wire()
    assert jobs.TraceContext.from_wire(ctx.to_wire()) == jobs.TraceContext(
        "abcd", "ef", 0.25, 1.5)
    assert pobs.TraceContext.from_wire({"trace_id": 3}) is None


def test_a_disabled_hub_records_nothing_but_keeps_health():
    tel = pobs.Telemetry(enabled=False)
    tel.inc("x_total")
    tel.gauge_set("g", 1)
    tel.observe_ms("s", 1.0)
    with tel.span("s2") as sp:
        sp.set(a=1)
    tel.event("e")
    assert tel.registry.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    assert tel.tracer.records() == []
    h = tel.health("serve")
    h.warming()
    h.ready()
    assert h.state == pobs.READY


def test_health_transitions_match_jax():
    steps = ["warming", "ready", "degraded", "degraded", "ready", "starting", "draining",
             "ready", "halted", "draining", "halted"]
    snaps = []
    for pkg in PACKAGES:
        clock = Clock()
        tel = pkg.Telemetry(clock=clock)
        tr = tel.health("serve")
        results = []
        for i, state in enumerate(steps):
            clock.t += 0.5
            results.append(tr.to(state, reason=f"step {i}"))
        snaps.append((results, tr.snapshot(), tr.history(), tel.registry.snapshot(),
                      tel.tracer.records(), pkg.overall_state(tel.health_snapshot())))
    assert snaps[0] == snaps[1]
    assert pobs.STATE_CODES == jobs.STATE_CODES
    assert pobs.health.ALLOWED_TRANSITIONS == jobs.health.ALLOWED_TRANSITIONS
    with pytest.raises(ValueError):
        pobs.HealthTracker("x").to("sideways")


def _slo_run(pkg, specs_fn, feed, seed, ticks=120):
    clock = Clock(0.0)
    tel = pkg.Telemetry(clock=clock)
    specs = specs_fn(pkg)
    tel.slo = pkg.SloEngine(specs, tel, clock=clock)
    for sub in {s.subsystem for s in specs}:
        tr = tel.health(sub)
        tr.warming()
        tr.ready()
    g = np.random.default_rng(seed)
    out = []
    for tick in range(ticks):
        clock.t += 0.5
        feed(tel, g, tick)
        verdicts = tel.slo.evaluate()
        out.append(({k: v.to_dict() for k, v in verdicts.items()}, tel.slo.paging(),
                    tel.slo.paging("serve"), tel.slo.paging("stream"),
                    tel.health_snapshot()))
    return out, tel.slo.snapshot(), tel.tracer.records(), tel.registry.snapshot()


def _feed_serve(tel, g, tick):
    storm = 30 <= tick < 60  # a burst of sheds, errors and slow requests
    for _ in range(int(g.integers(2, 6))):
        tel.inc("serve_requests_submitted_total")
        if storm and g.random() < 0.5:
            tel.inc("serve_requests_shed_total")
        if storm and g.random() < 0.1:
            tel.inc("serve_requests_error_total")
        tel.hist_observe("serve_e2e_ms", float(g.uniform(2500, 6000) if storm and g.random() < 0.5
                                               else g.uniform(5, 400)))


def _feed_stream(tel, g, tick):
    for _ in range(int(g.integers(1, 5))):
        tel.inc("stream_frames_submitted_total")
        if 20 <= tick < 50 and g.random() < 0.4:
            tel.inc("stream_frames_shed_total")
        tel.hist_observe("stream_e2e_ms", float(g.uniform(5, 300)))
    tel.gauge_set("stream_slot_occupancy", 8 if 60 <= tick < 100 else int(g.integers(0, 6)))


@pytest.mark.parametrize("kind", ["serve", "stream"])
def test_slo_verdicts_burn_rates_and_pages_match_jax(kind):
    if kind == "serve":
        specs_fn, feed = (lambda pkg: pkg.serve_slos(window_scale=0.01)), _feed_serve
    else:
        specs_fn, feed = (lambda pkg: pkg.stream_slos(8, window_scale=0.01)), _feed_stream
    j = _slo_run(jobs, specs_fn, feed, seed=3)
    p = _slo_run(pobs, specs_fn, feed, seed=3)
    assert p == j
    # The run pages and clears at least once, and health follows the page.
    _, snap, records, _ = p
    names = [r["name"] for r in records]
    assert snap["pages_total"] >= 1 and "slo_page" in names and "slo_clear" in names
    assert any(h[kind]["state"] == "degraded" for *_, h in p[0])
    # Float burn rates to 1e-9 (they are equal).
    for (vp, *_), (vj, *_) in zip(p[0], j[0]):
        for name in vp:
            assert vp[name]["burn_fast"] == pytest.approx(vj[name]["burn_fast"],
                                                          rel=FLOAT_RTOL)
    assert [s.name for s in specs_fn(pobs)] == [s.name for s in specs_fn(jobs)]
    for a, b in zip(specs_fn(pobs), specs_fn(jobs)):
        assert {k: getattr(a, k) for k in a.__dataclass_fields__} == {
            k: getattr(b, k) for k in b.__dataclass_fields__}


def test_budget_slo_degraded_input_moves_levels_as_jax():
    g = np.random.default_rng(4)
    kw = dict(capacity=16, high_water=0.75, low_water=0.25, recover_patience=3)
    port, jaxb = PortBudget((12, 8, 4, 2), **kw), JaxBudget((12, 8, 4, 2), **kw)
    for i in range(400):
        depth = int(g.integers(0, 17))
        slo = bool(g.random() < (0.6 if 100 <= i < 180 else 0.05))
        if g.random() < 0.2:
            executed = float(g.uniform(0, 14))
            port.note_executed(executed)
            jaxb.note_executed(executed)
        assert port.decide(depth, slo_degraded=slo) == jaxb.decide(depth, slo_degraded=slo)
    assert (port.drops, port.recoveries, port.slo_drops, port.decisions) == (
        jaxb.drops, jaxb.recoveries, jaxb.slo_drops, jaxb.decisions)
    assert port.slo_drops > 0 and port.summary() == jaxb.summary()


def _scrub(obj, root):
    """``obj`` with the directory ``root`` in every string replaced: the
    two packages write the same files into two directories."""
    return json.loads(json.dumps(obj).replace(str(root), "<dir>"))


def _dump_hub(pkg, clock):
    tel = pkg.Telemetry(clock=clock)
    tel.inc("serve_requests_submitted_total", 3)
    with tel.span("serve_dispatch", batch_id=0, request_ids=[0, 1], mesh="nomesh",
                  policy="f32"):
        clock.t += 0.01
    tel.health("serve").warming()
    return tel


def test_flight_dumps_load_across_packages_and_limit_alike(tmp_path):
    results = []
    for pkg in PACKAGES:
        clock = Clock()
        tel = _dump_hub(pkg, clock)
        d = tmp_path / pkg.__name__
        tel.flight = pkg.FlightRecorder(str(d), max_dumps=3, min_interval_s=5.0,
                                        clock=clock, walltime=lambda: 1.7e9)
        paths = []
        for trigger in ("poison_quarantine", "poison_quarantine", "preemption_drain",
                        "slo_page", "sentinel_halt", "stream_anomaly_reset"):
            clock.t += 1.0
            paths.append(tel.flight_dump(trigger, request_id=7))
        clock.t += 10.0
        paths.append(tel.flight_dump("poison_quarantine", request_id=8))
        names = [None if p is None else os.path.basename(p) for p in paths]
        results.append((names, tel.flight.snapshot()["dumps"], tel.flight.suppressed,
                        sorted(os.listdir(d)), tel.registry.snapshot()["counters"]))
    assert results[0] == results[1]
    assert results[1][2] == 1 and len(results[1][3]) == 3  # one suppressed; capped at 3
    # Each package loads the other's dumps, and the dumps say the same.
    jdir, pdir = (tmp_path / pkg.__name__ for pkg in PACKAGES)
    for name in results[0][3]:
        from_port = _scrub(jobs.load_dump(str(pdir / name)), pdir)
        from_jax = _scrub(pobs.load_dump(str(jdir / name)), jdir)
        assert from_port == from_jax
        assert from_port["fingerprints"] == {"mesh": "nomesh", "policy": "f32"}
    bad = tmp_path / "foreign.json"
    bad.write_text(json.dumps({"flight_recorder_version": 2}))
    for pkg in PACKAGES:
        with pytest.raises(ValueError):
            pkg.load_dump(str(bad))


def test_healthz_payload_and_periodic_snapshot_match_jax(tmp_path, monkeypatch):
    payloads = []
    for pkg in PACKAGES:
        clock = Clock()
        tel = _dump_hub(pkg, clock)
        tel.slo = pkg.SloEngine(pkg.serve_slos(window_scale=0.01), tel, clock=clock)
        tel.identity.update({"warmed": [[440, 1024, 2, 12]], "mesh": "nomesh"})
        path = tmp_path / f"{pkg.__name__}.healthz.json"
        sink_path = tmp_path / f"{pkg.__name__}.jsonl"
        with pkg.JsonlSink(str(sink_path), max_events=2) as sink:
            snap = pkg.PeriodicSnapshot(tel, sink, interval_s=60.0, healthz_path=str(path))
            snap.stop()  # before start: a no-op
            snap.start()
            tel.health("serve").ready()
            snap.stop()
            assert not sink.write({"name": "over the cap"})
            assert sink.dropped == 1
        payload = json.loads(path.read_text())
        for k in ("time_unix_s", "pid", "start_time_unix_s"):
            payload.pop(k)
        records, skipped = pkg.read_jsonl_tolerant(str(sink_path))
        payloads.append((payload, [r["report"]["health"] for r in records[:2]],
                         records[2], skipped, os.path.exists(str(path) + ".tmp")))
    assert payloads[0] == payloads[1]
    assert payloads[1][0]["overall"] == "ready" and payloads[1][4] is False


def _fleet_tree(base, pkg_for):
    """A fleet export tree: the router's dump and each replica's dump and
    JSONL, replica i written by ``pkg_for(i)``."""
    rclock = Clock(50.0)
    router = jobs.Telemetry(clock=rclock)
    for rid in range(3):
        with router.span("fleet_request", trace_id=f"t{rid}", request_id=rid):
            rclock.t += 0.001
            router.event("fleet_dispatch", trace_id=f"t{rid}", replica=rid % 2)
            rclock.t += 0.05
    router.flight = jobs.FlightRecorder(str(base), walltime=lambda: 1.7e9)
    router.flight_dump("router_drain", clock_offsets={"0": 10.0, "1": 20.0})
    for i in range(3):
        pkg = pkg_for(i)
        clock = Clock(60.0 + 10 * i)
        tel = pkg.Telemetry(clock=clock)
        for rid in range(i % 2, 3, 2):
            tel.observe_ms("serve_queue_wait", 3.0 + rid, trace_id=f"t{rid}", request_id=rid)
            with tel.span("serve_dispatch", trace_ids=[f"t{rid}"], request_ids=[rid]):
                clock.t += 0.02
            tel.observe_ms("serve_drain", 20.0 + rid, trace_ids=[f"t{rid}"])
            tel.inc("serve_requests_completed_total")
        tel.gauge_set("serve_queue_depth", 2 + i)
        if i < 2:  # replica 2 never dumped: a gap
            tel.flight = pkg.FlightRecorder(str(base / f"replica_{i}_flight"),
                                            walltime=lambda: 1.7e9)
            tel.flight_dump("preemption_drain")
            with pkg.JsonlSink(str(base / f"replica_{i}_telemetry.jsonl")) as sink:
                sink.write({"name": "telemetry_snapshot", "report": tel.report()})
        else:
            (base / "replica_2.sock").write_text("")
    with open(base / "replica_0_telemetry.jsonl", "a") as fh:
        fh.write('{"name": "telemetry_snapsh')  # a tail cut mid-write


def test_fleet_files_from_both_packages_read_alike(tmp_path):
    outs = []
    for pkg in PACKAGES:
        base = tmp_path / pkg.__name__
        base.mkdir()
        # Replica 0 from the port, replica 1 from JAX, in both trees.
        _fleet_tree(base, lambda i: pobs if i == 0 else jobs)
        coll = pkg.collect_fleet_records(str(base))
        traces = pkg.fleet_traces(coll)
        outs.append(_scrub((pkg.read_jsonl_tolerant(str(base / "replica_0_telemetry.jsonl")),
                            pkg.aggregate_registry(str(base)),
                            {k: v for k, v in coll.items() if k != "origins"},
                            [(t["trace_id"], t["request_id"], t["origins"], t["hops"])
                             for t in traces],
                            [pkg.render_trace(t)[0] for t in traces]), base))
    a, b = outs
    assert a == b
    (records, skipped), agg, coll, traces, _ = a
    assert skipped == 1 and len(records) == 1
    assert agg["gaps"] == [2] and agg["counters"]["serve_requests_completed_total"] == 3
    assert agg["gauges"]["serve_queue_depth"]["value"] == 3.0
    assert coll["clock_offsets"] == {"0": 10.0, "1": 20.0} and len(traces) == 3


def _model_configs(pkg):
    for variant in ("raft", "raft_nc_dbl"):
        for small in (False, True):
            for corr in ("volume", "onthefly"):
                yield pkg.ModelConfig(variant=variant, small=small, corr_impl=corr)
    up = pkg.UpsamplerConfig(weights_est_num_ch=(32, 16, 8),
                             weights_est_filter_sz=(5, 3, 3, 1), channels_multiplier=4)
    yield pkg.ModelConfig(variant="raft_nc_dbl", upsampler=up, corr_impl="onthefly")


def test_analytic_flops_match_jax_for_every_configuration():
    shapes = [(1, 128, 160, 12), (2, 440, 1024, 12), (6, 400, 720, 12), (3, 96, 128, 32)]
    pairs = list(zip(_model_configs(port_config), _model_configs(jax_config)))
    assert len(pairs) == 9
    for pcfg, jcfg in pairs:
        for shape in shapes:
            assert port_flops.forward_flops(pcfg, *shape) == jax_flops.forward_flops(jcfg, *shape)
            assert (port_flops.train_step_flops(pcfg, *shape)
                    == jax_flops.train_step_flops(jcfg, *shape))


def test_mfu_and_peaks():
    for args in ((1e12, 10.0, 67e12), (None, 1.0, 1.0), (1.0, 0.0, 1.0), (1.0, 1.0, None)):
        assert port_costs.mfu(*args) == jax_costs.mfu(*args)
    assert port_costs.peak_flops("cuda", "NVIDIA H100 80GB HBM3") == 67e12
    assert port_costs.peak_flops("cuda", "NVIDIA H100 80GB HBM3", "bf16") == 989e12
    assert port_costs.peak_flops("cuda", "NVIDIA A100-SXM4-80GB") is None
    assert port_costs.peak_flops("cuda", None) is None
    assert port_costs.peak_flops("cpu") == jax_costs.peak_flops("cpu")


def test_cpu_peak_and_telemetry_knobs(monkeypatch):
    monkeypatch.setenv("RAFT_TORCH_CPU_PEAK_FLOPS", "1.5e11")
    assert port_costs.peak_flops("cpu") == 1.5e11
    monkeypatch.setenv("RAFT_TORCH_TELEMETRY", "0")
    monkeypatch.setenv("RAFT_TORCH_FLIGHT_DIR", "/nonexistent/flight")
    prev = pobs.set_telemetry(None)
    try:
        tel = pobs.get_telemetry()
        assert tel.enabled is False and tel.flight.directory == "/nonexistent/flight"
        assert tel.flight_dump("x") is None  # disabled: nothing written
    finally:
        pobs.set_telemetry(prev)
    with pytest.raises(KeyError):
        knobs.knob_raw("RAFT_NCUP_TELEMETRY")
    assert set(knobs.KNOBS) == {"RAFT_TORCH_TELEMETRY", "RAFT_TORCH_FLIGHT_DIR",
                                "RAFT_TORCH_CPU_PEAK_FLOPS", "RAFT_TORCH_DIST_BACKEND",
                                "RAFT_TORCH_EARLYEXIT", "RAFT_TORCH_EARLYEXIT_TOL"}


def test_legacy_alias_table_is_jaxs():
    assert pobs.LEGACY_KEY_ALIASES == jobs.LEGACY_KEY_ALIASES


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield ("." * node.level) + node.module


def test_observability_imports_neither_torch_nor_jax():
    files = sorted(os.path.join(OBS, n) for n in os.listdir(OBS) if n.endswith(".py"))
    assert {os.path.basename(f) for f in files} == {
        "__init__.py", "aggregate.py", "export.py", "flight.py", "health.py", "slo.py",
        "spans.py", "telemetry.py"}
    allowed_port = ("raft_ncup_tpu_torch.observability", "raft_ncup_tpu_torch.utils.knobs")
    for f in files + [os.path.join(REPO, "raft_ncup_tpu_torch", "utils", "knobs.py")]:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root not in ("torch", "jax", "jaxlib", "numpy", "raft_ncup_tpu"), (f, mod)
            if root == "raft_ncup_tpu_torch":
                assert mod.startswith(allowed_port), (f, mod)
