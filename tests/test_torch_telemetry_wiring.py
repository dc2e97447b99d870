"""The port's telemetry wired through serving, streaming, the graph cache,
the cost ledger, the serve entry and the train entry, on the CPU.

Small ``raft`` at 32x48, 2 iterations. Counts, states and file contents
are compared exactly (tolerance 0); served flows with telemetry off and on
bit for bit.

- every ``ServeStats`` / ``StreamStats`` field has a pinned alias, and the
  registry's mirrored counters equal the fields after a ``FlowServer`` and
  a ``StreamEngine`` run (timeouts, sheds, rejects, a quarantine, an
  anomaly reset included); the cache's counters equal its ``stats``;
  health runs STARTING, WARMING, READY, DRAINING; the fault triggers bank
  dumps JAX's ``load_dump`` reads;
- the cost ledger's counting run leaves the forward's outputs bit for bit
  equal, records each key once, and an early-exit entry records three;
- the serve entry with ``--report --healthz_file --flight_dir
  --telemetry_jsonl --chaos poison@2,sigterm@4`` exits 75 with both dumps
  and the report's ``telemetry``, ``cost_ledger`` and ``slo``; with
  ``RAFT_TORCH_TELEMETRY=0`` it serves the same flows bit for bit;
- the train entry's ``--profile_steps 1`` writes a Chrome trace under
  ``<run_dir>/profile``; its sentinel halt (exit 76) and preemption
  (exit 75) bank ``sentinel_halt`` and ``preemption_drain`` dumps in
  ``<run_dir>/flight``.
"""

import dataclasses
import glob
import json

import jax  # noqa: F401  (the test process keeps JAX on the CPU)
import numpy as np
import pytest
import torch

import raft_ncup_tpu.observability as jobs
import raft_ncup_tpu_torch.observability as pobs
from raft_ncup_tpu_torch import serve as serve_mod
from raft_ncup_tpu_torch import train
from raft_ncup_tpu_torch.config import ServeConfig, StreamConfig, small_model_config
from raft_ncup_tpu_torch.inference.costs import CostLedger, counting_flops
from raft_ncup_tpu_torch.inference.pipeline import ShapeCachedForward
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.resilience import EXIT_DIVERGED, EXIT_PREEMPTED
from raft_ncup_tpu_torch.serving import FlowServer
from raft_ncup_tpu_torch.serving.request import ServeStats
from raft_ncup_tpu_torch.streaming import StreamEngine
from raft_ncup_tpu_torch.streaming.engine import StreamStats

HW = (32, 48)
SMALL = ["--device", "cpu", "--small", "--size", "32", "48", "--seed", "1"]
_NOT_COUNTERS = {"quarantined", "telemetry", "_lock"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small CPU runs launch many tiny ops, and
    with the test workers sharing the cores a parallel region per op waits
    on threads that are not scheduled."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    return RAFT(small_model_config("raft", corr_impl="pallas", nconv_impl="pallas"),
                device="cpu", seed=5)


def _frame(g):
    return g.uniform(0, 255, (*HW, 3)).astype(np.float32)


def _counter(tel, name):
    m = tel.registry.get(name)
    return 0 if m is None else m.value


def _stats_fields(cls):
    return [f.name for f in dataclasses.fields(cls) if f.name not in _NOT_COUNTERS]


def test_every_stats_field_has_a_pinned_alias():
    assert set(_stats_fields(ServeStats)) == set(pobs.LEGACY_KEY_ALIASES["serve"])
    assert set(_stats_fields(StreamStats)) == set(pobs.LEGACY_KEY_ALIASES["stream"])


def test_server_mirrors_its_stats_and_walks_its_health(model, tmp_path):
    tel = pobs.Telemetry()
    tel.flight = pobs.FlightRecorder(str(tmp_path / "flight"))
    now = [0.0]
    cfg = ServeConfig(batch_sizes=(1, 2), iter_levels=(2,), queue_capacity=3)
    server = FlowServer(model, cfg, clock=lambda: now[0], telemetry=tel)
    assert server.health.state == pobs.STARTING
    server.warmup(HW)
    assert server.health.state == pobs.READY
    g = np.random.default_rng(0)
    server.pause()
    handles = [server.submit(_frame(g), _frame(g), deadline_s=1.0)]  # times out
    nan = np.full((*HW, 3), np.nan, np.float32)
    handles.append(server.submit(nan, nan))  # quarantined at dispatch
    handles.append(server.submit(_frame(g), _frame(g)))
    handles.append(server.submit(_frame(g), _frame(g)))  # the queue is full: shed
    handles.append(server.submit(np.zeros(HW, np.float32), np.zeros(HW, np.float32)))
    now[0] = 5.0
    server.resume()
    stats = server.drain()
    assert [h.result(60).status for h in handles] == [
        "timeout", "rejected", "ok", "shed", "rejected"]
    assert server.health.state == pobs.DRAINING
    assert [h["to"] for h in server.health.history()] == ["warming", "ready", "draining"]
    for field, name in pobs.LEGACY_KEY_ALIASES["serve"].items():
        assert _counter(tel, name) == getattr(stats, field), field
    assert stats.timeouts == stats.shed == stats.completed == 1 and stats.rejected == 2
    for field, name in pobs.LEGACY_KEY_ALIASES["inference"].items():
        assert _counter(tel, name) == server.report()["executables"][field], field
    report = server.report()
    assert report["health"]["state"] == "draining" and report["budget_slo_drops"] == 0
    assert {"serve_batch_assembly", "serve_pad_stage", "serve_dispatch", "serve_drain",
            "serve_queue_wait", "serve_e2e"} <= set(report["stages"])
    dispatch = tel.tracer.records("serve_dispatch")[-1]
    assert dispatch["attrs"]["mesh"] == "nomesh" and dispatch["attrs"]["policy"] == "f32"
    # The quarantine banked one dump, which the JAX package's reader loads.
    dumps = glob.glob(str(tmp_path / "flight" / "flight_poison_quarantine_*.json"))
    assert len(dumps) == 1
    dump = jobs.load_dump(dumps[0])
    assert dump["context"]["request_id"] == 1
    assert tel.registry.get("serve_queue_depth").peak == 3


def test_engine_mirrors_its_stats_gauges_occupancy_and_dumps_a_reset(model, tmp_path):
    tel = pobs.Telemetry()
    tel.flight = pobs.FlightRecorder(str(tmp_path / "flight"))
    cfg = StreamConfig(capacity=2, frame_hw=HW, iters=2, batch_sizes=(1, 2),
                       queue_capacity=8)
    g = np.random.default_rng(1)
    with StreamEngine(model, cfg, telemetry=tel) as engine:
        engine.warmup()
        assert engine.health.state == pobs.READY
        hs = []
        for i in range(2):
            engine.pause()
            hs.append(engine.submit("a", _frame(g), _frame(g)))
            bad = np.full((*HW, 3), np.nan, np.float32) if i == 1 else _frame(g)
            hs.append(engine.submit("b", bad, bad))
            hs.append(engine.submit("c", _frame(g), _frame(g)))  # the table is full
            engine.resume()
            [h.result(60) for h in hs]
        engine.close_stream("a")
    stats = engine.stats
    assert stats.resets == 1 and stats.shed_streams == 2 and stats.streams_closed == 1
    for field, name in pobs.LEGACY_KEY_ALIASES["stream"].items():
        assert _counter(tel, name) == getattr(stats, field), field
    assert tel.registry.get("stream_slot_occupancy").peak == 2
    assert engine.health.state == pobs.DRAINING
    assert [h["to"] for h in engine.health.history()] == ["warming", "ready", "draining"]
    names = [r["name"] for r in tel.tracer.records()]
    for name in ("stream_slot_admitted", "stream_slot_shed", "stream_anomaly_reset",
                 "stream_slot_released", "stream_dispatch", "stream_drain"):
        assert name in names
    dumps = glob.glob(str(tmp_path / "flight" / "flight_stream_anomaly_reset_*.json"))
    assert len(dumps) == 1 and jobs.load_dump(dumps[0])["context"]["stream_id"] == "b"
    assert "stream_e2e" in engine.report()["stages"]


def test_counting_leaves_the_forward_bit_for_bit(model):
    g = np.random.default_rng(2)
    i1, i2 = (torch.from_numpy(np.stack([_frame(g), _frame(g)])) for _ in range(2))
    with torch.no_grad():
        plain = model(i1, i2, iters=2)
        with counting_flops() as flops:
            counted = model(i1, i2, iters=2)
    assert all(torch.equal(a, b) for a, b in zip(plain, counted))
    assert flops["aten"] > 0 and flops["total"] == flops["aten"]  # CPU: no kernel launched


def test_the_ledger_records_each_key_once_and_three_for_early_exit(model):
    ledger, tel = CostLedger(), pobs.Telemetry()
    fwd = ShapeCachedForward(model, cache_size=1, telemetry=tel, cost_ledger=ledger)
    g = np.random.default_rng(3)
    x1, x2 = (np.stack([_frame(g)]) for _ in range(2))
    first = fwd.forward(x1, x2, 2)  # the counted run
    again = fwd.forward(x1, x2, 2)  # a replay of the same key
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert len(ledger) == 1
    (entry,) = ledger.snapshot()["entries"].values()
    assert entry["flops"] > 0 and entry["bytes_accessed"] is None
    assert entry["meta"] == {"kind": "forward", "shape": [1, 32, 48, 3], "iters": 2,
                             "policy": "f32"}
    assert entry["memory_stats"] == {"graph_pool_reserved_bytes": 0}
    fwd.forward(x1, x2, 2, early_exit_tol=0.05)  # evicts the first key (cache of 1)
    stages = [e["meta"].get("stage") for e in ledger.snapshot()["entries"].values()]
    assert sorted(map(str, stages)) == ["None", "encode", "finalize", "segment"]
    assert _counter(tel, "inference_executable_evictions_total") == 1
    assert _counter(tel, "inference_executable_hits_total") == 1
    assert [r["name"] for r in tel.tracer.records()] == [
        "inference_executable_compile", "inference_executable_compile",
        "inference_executable_evict"]


def _run_entry(argv, capsys):
    rc, report, responses, _ = serve_mod.run(argv)
    capsys.readouterr()
    return rc, report, responses


def test_serve_entry_reports_telemetry_and_dumps_under_chaos(tmp_path, capsys):
    argv = SMALL + ["--num_requests", "6", "--iter_levels", "2", "--serve_batch_sizes", "1,2",
                    "--chaos", "poison@2,sigterm@4", "--report",
                    "--healthz_file", str(tmp_path / "healthz.json"),
                    "--flight_dir", str(tmp_path / "flight"),
                    "--telemetry_jsonl", str(tmp_path / "t.jsonl"),
                    "--telemetry_interval_s", "0.05", "--slo_window_scale", "0.01"]
    rc, report, _ = _run_entry(argv, capsys)
    assert rc == EXIT_PREEMPTED
    dumps = {d["trigger"]: d for d in map(jobs.load_dump,
                                          glob.glob(str(tmp_path / "flight" / "*.json")))}
    assert sorted(dumps) == ["poison_quarantine", "preemption_drain"]
    # The drain dump names the preset of the latest dispatch.
    assert dumps["preemption_drain"]["fingerprints"] == {"mesh": "nomesh", "policy": "f32"}
    assert report["slo"]["specs"] == ["serve_shed_rate", "serve_error_rate",
                                      "serve_p99_latency"]
    counters = report["telemetry"]["metrics"]["counters"]
    for field, name in pobs.LEGACY_KEY_ALIASES["serve"].items():
        if field in report:
            assert counters.get(name, 0) == report[field], field
    entries = report["cost_ledger"]["entries"]
    assert len(entries) == report["executables"]["compiles"] == 2
    assert all(e["flops"] > 0 and e["capture_ms"] > 0 for e in entries.values())
    healthz = json.loads((tmp_path / "healthz.json").read_text())
    assert healthz["overall"] == "draining" and healthz["warmed"] == [
        [32, 48, 1, 2], [32, 48, 2, 2]]
    records, skipped = jobs.read_jsonl_tolerant(str(tmp_path / "t.jsonl"))
    assert skipped == 0 and records[-1]["report"]["health"]["serve"]["state"] == "draining"
    assert records[0]["report"]["health"]["serve"]["state"] == "ready"


def test_telemetry_off_serves_the_same_flows(monkeypatch, tmp_path, capsys):
    argv = SMALL + ["--num_requests", "3", "--iter_levels", "2", "--serve_batch_sizes", "1",
                    "--report", "--flight_dir", str(tmp_path)]
    _, on, on_resp = _run_entry(argv, capsys)
    monkeypatch.setenv("RAFT_TORCH_TELEMETRY", "0")
    _, off, off_resp = _run_entry(argv, capsys)
    assert on["telemetry"]["enabled"] and not off["telemetry"]["enabled"]
    assert off["telemetry"]["metrics"]["counters"] == {}
    assert on["completed"] == off["completed"] == 3
    for a, b in zip(on_resp, off_resp):
        assert np.array_equal(a.flow, b.flow)


def _train_argv(tmp_path, *extra):
    return ["--device", "cpu", "--name", "t", "--stage", "chairs", "--model", "raft",
            "--small", "--synthetic_ok", "--batch_size", "1", "--image_size", "64", "96",
            "--iters", "1", "--sum_freq", "1", "--num_workers", "1",
            "--checkpoint_dir", str(tmp_path), *extra]


def test_train_entry_profiles_and_dumps_its_faults(tmp_path, capsys):
    run_dir = tmp_path / "t"
    assert train.main(_train_argv(tmp_path, "--num_steps", "3", "--profile_steps", "1")) == 0
    traces = glob.glob(str(run_dir / "profile" / "*.json"))
    assert len(traces) == 1
    events = json.load(open(traces[0]))["traceEvents"]
    assert any(e.get("name") == "train.forward" for e in events)
    assert "profile trace written to" in (run_dir / "log.txt").read_text()
    assert pobs.get_telemetry().health("train").state == "ready"
    # A halt: two bad steps in a row (exit 76), one dump.
    assert train.main(_train_argv(tmp_path, "--num_steps", "4", "--name", "h",
                                  "--chaos", "nan@1,nan@2",
                                  "--sentinel_halt_after", "2")) == EXIT_DIVERGED
    (dump,) = glob.glob(str(tmp_path / "h" / "flight" / "flight_sentinel_halt_*.json"))
    assert jobs.load_dump(dump)["context"]["consecutive"] == 2
    assert pobs.get_telemetry().health("train").state == "halted"
    # A preemption (exit 75), one dump naming the saved step.
    assert train.main(_train_argv(tmp_path, "--num_steps", "4", "--name", "p",
                                  "--chaos", "sigterm@1")) == EXIT_PREEMPTED
    (dump,) = glob.glob(str(tmp_path / "p" / "flight" / "flight_preemption_drain_*.json"))
    assert jobs.load_dump(dump)["context"]["checkpoint_step"] == 1
    assert pobs.get_telemetry().flight is None or "p" not in pobs.get_telemetry().flight.directory
    capsys.readouterr()
