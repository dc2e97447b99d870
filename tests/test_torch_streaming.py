"""The port's streaming engine on the CPU: the slot registry, the
distinct-stream batching and the chaos schedule against the JAX
package's, the engine against JAX's ``StreamEngine`` under
``corruptframe`` (with and without ``carry_net``), and the isolation
contract bit for bit.

Model: small ``raft`` at 32x48, 2 iterations, with the port's seeded
weights carried into JAX (``import_torch_state``) and back
(``load_jax_variables``). The engines are driven in rounds (pause, one
frame of each stream, resume), so a batch holds the same streams in both
packages. Flows are held against JAX at the port's standing tolerances,
flow_up atol 5e-3, rtol 1e-3 (each frame warm-starts from the engine's
own previous frame); statuses and resets exactly; the isolation checks,
port against port, bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

import raft_ncup_tpu.streaming.traffic as jax_traffic_mod
import raft_ncup_tpu_torch.streaming.traffic as traffic_mod
from raft_ncup_tpu.config import StreamConfig as JaxStreamConfig
from raft_ncup_tpu.config import small_model_config as jax_small_config
from raft_ncup_tpu.models.raft import RAFT as JaxRAFT
from raft_ncup_tpu.resilience.chaos import ChaosSpec as JaxChaosSpec
from raft_ncup_tpu.serving.admission import AdmissionQueue as JaxAdmissionQueue
from raft_ncup_tpu.streaming import SlotRegistry as JaxSlotRegistry
from raft_ncup_tpu.streaming import StreamEngine as JaxStreamEngine
from raft_ncup_tpu.streaming.engine import FrameRequest as JaxFrameRequest
from raft_ncup_tpu.utils.torch_import import import_torch_state
from raft_ncup_tpu_torch.config import StreamConfig, small_model_config
from raft_ncup_tpu_torch.inference.pipeline import ShapeCachedForward
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.resilience import ChaosSpec
from raft_ncup_tpu_torch.serving import AdmissionQueue
from raft_ncup_tpu_torch.streaming import (
    FrameRequest,
    SlotRegistry,
    StreamEngine,
    StreamTraffic,
    init_slot_table,
)
from raft_ncup_tpu_torch.utils.jax_weights import load_jax_variables

HW = (32, 48)
ITERS = 2
FLOW_UP_TOL = dict(atol=5e-3, rtol=1e-3)
CORRUPT = ("stream-1", 1)  # schedule slot 4 of 3 streams


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
def models():
    cfg = small_model_config("raft", dataset="chairs", corr_impl="pallas", nconv_impl="pallas")
    seeded = RAFT(cfg, device="cpu", seed=0)
    jmodel = JaxRAFT(jax_small_config("raft", dataset="chairs"))
    template = jax.eval_shape(lambda k: jmodel.init(k, (1, *HW, 3)), jax.random.key(0))
    variables = import_torch_state(
        {k: v.numpy() for k, v in seeded.state_dict().items()}, template, strict=True)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return load_jax_variables(RAFT(cfg, device="cpu", seed=1), variables), jmodel, variables


@pytest.fixture(scope="module")
def frames():
    return {(sid, f): (i1, i2) for _, sid, f, i1, i2 in StreamTraffic(HW, 3, 3, seed=5)}


def _cfg(cls, **kw):
    base = dict(capacity=4, frame_hw=HW, iters=ITERS, batch_sizes=(4,), queue_capacity=8,
                idle_timeout_s=100.0)
    base.update(kw)
    return cls(**base)


def _run_rounds(engine, frames, *, corrupt=None, skip=None):
    """Drive an engine in rounds (pause, one frame per stream, resume);
    returns ``({(stream, frame): response}, stats)``. ``corrupt``: the
    (stream, frame) whose first image is NaN; ``skip``: (stream, frame) at
    which that stream joins."""
    out = {}
    try:
        engine.warmup()
        n_frames = max(f for _, f in frames) + 1
        streams = sorted({s for s, _ in frames})
        for f in range(n_frames):
            engine.pause()
            handles = []
            for sid in streams:
                if skip and sid == skip[0] and f < skip[1]:
                    continue
                i1, i2 = frames[(sid, f)]
                if (sid, f) == corrupt:
                    i1 = np.full(i1.shape, np.nan, np.float32)
                handles.append(((sid, f), engine.submit(sid, i1, i2, frame_index=f)))
            engine.resume()
            for k, h in handles:
                out[k] = h.result(120)
    finally:
        stats = engine.drain()
    return out, stats


# ------------------------------------------------- host pieces against JAX


def test_slot_registry_follows_jax():
    def script(reg):
        log = [reg.admit(s, (32, 48), 0.0).slot for s in ("a", "b", "c")]
        log.append(reg.admit("d", (32, 48), 1.0))
        log.append(reg.release("b"))
        log.append(reg.admit("d", (32, 48), 2.0).slot)
        reg.get("c").pending = 1
        log.append(reg.soonest_expiry_s(3.0, 10.0))
        log.append([s.stream_id for s in reg.evict_expired(11.5, 10.0)])
        log.append(reg.admit("e", (32, 48), 12.0).slot)
        log.append((reg.occupancy, reg.peak_occupancy, reg.evicted_total))
        return [x.slot if hasattr(x, "slot") else x for x in log]

    assert script(SlotRegistry(3)) == script(JaxSlotRegistry(3))


def test_distinct_stream_batching_follows_jax():
    keys = [("a", 1), ("a", 1), ("b", 1), ("c", 2), ("c", 1), ("d", 1), ("b", 1)]

    def pops(queue, cls):
        for i, (sid, k) in enumerate(keys):
            queue.offer(cls(i, sid, 0, i, None, None, False, 0.0, (), (k, k)))
        return [[r.request_id for r in queue.pop_batch(3, timeout=0.01,
                                                        distinct_fn=lambda r: r.stream_id)]
                for _ in range(5)]

    assert pops(AdmissionQueue(8), FrameRequest) == pops(JaxAdmissionQueue(8), JaxFrameRequest)


class _Frames:
    """Frames keyed by (seed, index) only, for both packages' schedules."""

    torch_out = False

    def __init__(self, size_hw, length=1, seed=0, style="smooth"):
        self.size_hw, self.seed = tuple(size_hw), seed

    def sample(self, index):
        g = np.random.default_rng([self.seed, index])
        imgs = {k: g.integers(0, 256, (*self.size_hw, 3), dtype=np.uint8)
                for k in ("image1", "image2")}
        return {k: torch.from_numpy(v) for k, v in imgs.items()} if self.torch_out else imgs


class _TorchFrames(_Frames):
    torch_out = True


@pytest.mark.parametrize("chaos", ["", "corruptframe@4,abandon@7", "burst@2,abandon@0",
                                   "corruptframe@1,burst@5,sigterm@3"])
def test_stream_schedule_follows_jax(monkeypatch, chaos):
    """The same frame source in both: the schedule (order, due times, ids,
    frame indices, corruption, abandonment and bursts) is JAX's."""
    monkeypatch.setattr(traffic_mod, "SyntheticFlowDataset", _TorchFrames)
    monkeypatch.setattr(jax_traffic_mod, "SyntheticFlowDataset", _Frames)
    kw = dict(seed=2, interval_s=0.01, burst_size=3)
    ours = list(StreamTraffic(HW, 3, 4, chaos=ChaosSpec.parse(chaos), **kw))
    ref = list(jax_traffic_mod.StreamTraffic(HW, 3, 4, chaos=JaxChaosSpec.parse(chaos), **kw))
    assert [x[:3] for x in ours] == [x[:3] for x in ref] and len(ref) > 0
    for a, b in zip(ours, ref):
        for x, y in zip(a[3:], b[3:]):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_slot_table_is_allocated_at_the_state_dtype():
    table = init_slot_table(3, 4, 6, hidden_dim=5, dtype=torch.bfloat16)
    assert table["flow"].shape == (4, 4, 6, 2) and table["flow"].dtype == torch.bfloat16
    assert table["net"].shape == (4, 4, 6, 5) and table["net"].dtype == torch.bfloat16
    assert table["warm"].shape == (4,) and table["warm"].dtype == torch.float32
    assert not any(t.any() for t in table.values())  # all cold
    assert "net" not in init_slot_table(3, 4, 6)


# ------------------------------------------------- the engine against JAX


@pytest.mark.parametrize("carry_net", [False, True])
def test_engine_follows_jax_under_corruptframe(models, frames, carry_net):
    port, jmodel, variables = models
    ours, ostats = _run_rounds(StreamEngine(port, _cfg(StreamConfig, carry_net=carry_net)),
                               frames, corrupt=CORRUPT)
    ref, rstats = _run_rounds(
        JaxStreamEngine(jmodel, variables, _cfg(JaxStreamConfig, carry_net=carry_net)),
        frames, corrupt=CORRUPT)
    assert {k: r.status for k, r in ours.items()} == {k: r.status for k, r in ref.items()}
    assert ours[CORRUPT].status == "rejected" and "anomaly" in ours[CORRUPT].detail
    assert (ostats.resets, ostats.completed, ostats.errors) == (
        rstats.resets, rstats.completed, rstats.errors) == (1, 8, 0)
    for k, r in ref.items():
        if r.ok:
            assert ours[k].iters == r.iters == ITERS
            np.testing.assert_allclose(ours[k].flow, np.asarray(r.flow), **FLOW_UP_TOL,
                                       err_msg=str(k))


# ----------------------------------------------- isolation, port against port


def test_corrupt_frame_isolation_bitwise(models, frames):
    port = models[0]
    base, _ = _run_rounds(StreamEngine(port, _cfg(StreamConfig)), frames)
    hit, stats = _run_rounds(StreamEngine(port, _cfg(StreamConfig)), frames, corrupt=CORRUPT)
    assert stats.resets == 1 and hit[CORRUPT].status == "rejected"
    for (sid, f), r in base.items():
        if sid != CORRUPT[0]:  # every batch-mate, in that batch and after it
            assert np.array_equal(r.flow, hit[(sid, f)].flow), (sid, f)
    # The reset stream's next frame is a cold start: the same batches, with
    # that stream joining at that frame.
    cold, _ = _run_rounds(StreamEngine(port, _cfg(StreamConfig)), frames,
                          skip=(CORRUPT[0], CORRUPT[1] + 1))
    nxt = (CORRUPT[0], CORRUPT[1] + 1)
    assert np.array_equal(hit[nxt].flow, cold[nxt].flow)
    assert not np.array_equal(hit[nxt].flow, base[nxt].flow)  # base was warm there


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("carry_net", [False, True])
def test_evicted_slot_new_owner_starts_cold(models, frames, carry_net):
    port = models[0]
    clock = _Clock()
    cfg = _cfg(StreamConfig, capacity=1, batch_sizes=(1,), idle_timeout_s=5.0,
               carry_net=carry_net)
    b1, b2 = frames[("stream-1", 1)]
    with StreamEngine(port, cfg, clock=clock) as engine:
        engine.warmup()
        for f in range(2):  # stream a leaves warm state in slot 0
            assert engine.submit("a", *frames[("stream-0", f)]).result(60).ok
        assert engine.submit("b", b1, b2).result(60).status == "shed"  # table full
        clock.t += 10.0
        got = engine.submit("b", b1, b2).result(60)
        assert engine.registry.get("b").slot == 0 and engine.stats.streams_evicted == 1
    with StreamEngine(port, cfg) as fresh:
        want = fresh.submit("b", b1, b2).result(60)
    assert got.ok and np.array_equal(got.flow, want.flow)


class _PreRunEntry:
    """A captured step's shape on the CPU: ``fn`` runs once when the entry
    is built, as a capture's eager run does, and once a call."""

    pool_bytes = 0

    def __init__(self, fn, args):
        fn(*args)
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)


def test_a_step_built_without_warmup_leaves_warm_rows_alone(models, frames, monkeypatch):
    """No warmup: batch size 2 is first used by a batch holding a warm row.
    Its entry's eager run must not write that row's new flow into the slot
    the step then reads as the previous state."""
    port = models[0]

    def drive():
        with StreamEngine(port, _cfg(StreamConfig, batch_sizes=(1, 2))) as engine:
            assert engine.submit("stream-0", *frames[("stream-0", 0)], frame_index=0).result(60).ok
            engine.pause()
            handles = [engine.submit(sid, *frames[(sid, 1)], frame_index=1)
                       for sid in ("stream-0", "stream-1")]
            engine.resume()
            out = [h.result(60) for h in handles]
            assert engine.stats.batches == 2 and engine.report()["executables"]["compiles"] == 2
            return out

    want = drive()
    monkeypatch.setattr(ShapeCachedForward, "_graph_or_eager",
                        lambda self, key, fn, args: _PreRunEntry(fn, args))
    got = drive()
    for a, b in zip(want, got):
        assert a.ok and b.ok and np.array_equal(a.flow, b.flow)


def test_stream_config_keeps_every_step_entry_cached():
    StreamConfig(batch_sizes=(1, 2, 4), cache_size=3)
    with pytest.raises(ValueError, match="cache_size 2 must be >= len"):
        StreamConfig(batch_sizes=(1, 2, 4), cache_size=2)


def test_drain_answers_everything_admitted_and_captures_only_at_warmup(models, frames):
    port = models[0]
    engine = StreamEngine(port, _cfg(StreamConfig, batch_sizes=(1, 2, 4)))
    assert engine.warmup() == 3
    engine.pause()
    handles = [engine.submit(sid, *frames[(sid, f)], frame_index=f)
               for f in range(3) for sid in ("stream-0", "stream-1")]
    stats = engine.drain()  # clears the pause, answers every admitted frame
    assert all(h.done() for h in handles)
    assert stats.completed == stats.accepted == len(handles) and stats.errors == 0
    assert stats.batches == 3  # a batch never holds two frames of one stream
    assert engine.report()["executables"] == {"compiles": 3, "hits": 3, "evictions": 0}
    late = engine.submit("stream-0", *frames[("stream-0", 0)]).result(1)
    assert late.status == "shed" and late.detail == "draining"


def test_admission_sheds_and_rejects_like_jax(models, frames):
    port = models[0]
    i1, i2 = frames[("stream-0", 0)]
    with StreamEngine(port, _cfg(StreamConfig, capacity=2, queue_capacity=2)) as engine:
        engine.pause()
        hs = [engine.submit(s, i1, i2) for s in ("a", "b", "c")]
        assert hs[2].result(1).status == "shed"
        assert hs[2].result(1).detail == "stream table full"
        assert hs[2].result(1).retry_after_s == pytest.approx(100.0, abs=0.5)
        assert engine.submit("a", i1, i2).result(1).detail == "frame queue full"
        assert engine.submit("a", i1, i2, frame_index=0).result(1).status == "rejected"
        small = np.zeros((24, 32, 3), np.float32)
        assert "slot table" in engine.submit("a", small, small).result(1).detail
        engine.resume()
        assert all(h.result(60).ok for h in hs[:2])
    assert engine.stats.shed_streams == 1 and engine.stats.shed_frames == 1
    assert engine.stats.rejected == 2 and engine.close_stream("a")
