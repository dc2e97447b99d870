"""The pipelined ``FlowServer`` and ``StreamEngine`` of the port on the CPU:
the dispatch throttle (``inflight``), the asynchronous drain and the
in-flight registry, as JAX's ``serving/server.py`` and
``streaming/engine.py`` run them.

- A paused burst through the pipelined server (the default ``inflight``
  and 2) answers bit for bit as the waiting server (``inflight=1``), for
  the flagship and ``raft``; one pair through the port's pipelined server
  agrees with JAX's ``FlowServer`` on the same weights within the served
  tolerances (flow_up atol 5e-3, rtol 1e-3).
- A failed drain (the read, or a delivery midway) answers that batch's
  still-pending requests with ``error`` at once; the next batch is served
  and no handle hangs. The engine's failed frames release their stream.
- ``sigterm`` mid-burst drains the pipelined server and engine with every
  admitted request answered ``ok``.
- The engine, fed all frames of three streams at once (so step n+1 is
  staged and launched while step n runs), answers bit for bit as the
  waiting engine, and under ``corruptframe`` its batch-mates equal a run
  without the fault bit for bit and the reset stream's next frame equals a
  cold start bit for bit, though the host admitted that frame warm.

Models: small ``raft`` (and the flagship) at 40x48, 2 iterations, seeded;
one torch thread.
"""

import jax
import numpy as np
import pytest
import torch

from raft_ncup_tpu.config import ServeConfig as JaxServeConfig
from raft_ncup_tpu.config import small_model_config as jax_small_config
from raft_ncup_tpu.models.raft import RAFT as JaxRAFT
from raft_ncup_tpu.serving import FlowServer as JaxFlowServer
from raft_ncup_tpu.utils.torch_import import import_torch_state
from raft_ncup_tpu_torch.config import (
    ServeConfig,
    StreamConfig,
    flagship_config,
    small_model_config,
)
from raft_ncup_tpu_torch.inference import pipeline
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.resilience import PreemptionHandler
from raft_ncup_tpu_torch.serving import FlowServer, SyntheticTraffic, replay
from raft_ncup_tpu_torch.streaming import StreamEngine, StreamTraffic, replay_streams
from raft_ncup_tpu_torch.utils.jax_weights import load_jax_variables

HW = (40, 48)
FLOW_UP_TOL = dict(atol=5e-3, rtol=1e-3)


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
def small():
    return RAFT(small_model_config("raft", dataset="chairs"), device="cpu", seed=0)


@pytest.fixture(scope="module")
def flagship():
    return RAFT(flagship_config(), device="cpu", seed=3)


def _img(seed: int, hw=HW) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 255, (*hw, 3)).astype(np.float32)


def _serve_burst(model, inflight, n=5):
    """``n`` requests submitted while the server is paused (batches 2, 2,
    1), answered by a server with ``inflight``."""
    cfg = ServeConfig(batch_sizes=(1, 2), iter_levels=(2,), queue_capacity=16,
                      inflight=inflight)
    with FlowServer(model, cfg) as srv:
        srv.pause()
        handles = [srv.submit(_img(2 * i), _img(2 * i + 1)) for i in range(n)]
        srv.resume()
        rs = [h.result(60) for h in handles]
    return rs, srv.stats


@pytest.mark.parametrize("variant", ["raft_nc_dbl", "raft"])
def test_pipelined_server_answers_as_the_waiting_one(variant, small, flagship):
    model = flagship if variant == "raft_nc_dbl" else small
    waiting, _ = _serve_burst(model, inflight=1)
    assert [r.status for r in waiting] == ["ok"] * 5
    for inflight in (None, 2):
        piped, stats = _serve_burst(model, inflight)
        assert stats.batches == 3 and stats.completed == 5
        for a, b in zip(piped, waiting):
            assert a.status == "ok" and a.flow.shape == (*HW, 2)
            assert a.flow.tobytes() == b.flow.tobytes()


def test_pipelined_server_follows_jax_flow_server(small):
    """One pair through both servers, the port's weights carried into JAX."""
    jmodel = JaxRAFT(jax_small_config("raft", dataset="chairs"))
    template = jax.eval_shape(lambda k: jmodel.init(k, (1, *HW, 3)), jax.random.key(0))
    variables = import_torch_state({k: v.numpy() for k, v in small.state_dict().items()},
                                   template, strict=True)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = load_jax_variables(RAFT(small_model_config("raft", dataset="chairs"), device="cpu",
                                   seed=1), variables)
    img1, img2 = _img(70), _img(71)
    with FlowServer(port, ServeConfig(batch_sizes=(1,), iter_levels=(2,))) as srv:
        ours = srv.submit(img1, img2).result(60)
    with JaxFlowServer(jmodel, variables,
                       JaxServeConfig(batch_sizes=(1,), iter_levels=(2,))) as jsrv:
        ref = jsrv.submit(img1, img2).result(120)
    assert ours.status == ref.status == "ok" and ours.iters == ref.iters == 2
    np.testing.assert_allclose(ours.flow, np.asarray(ref.flow), **FLOW_UP_TOL)


def test_a_failed_drain_answers_its_batch_with_error(small, monkeypatch):
    """The first batch's read fails, the second batch's delivery fails
    after its first request: the failed requests answer ``error``, the
    others ``ok``, the third batch is served, and no handle hangs."""
    real = pipeline.host_read
    reads = []

    def failing_read(tree, ready=None):
        reads.append(1)
        if len(reads) == 1:
            raise RuntimeError("planted read failure")
        return real(tree, ready=ready)

    monkeypatch.setattr(pipeline, "host_read", failing_read)
    cfg = ServeConfig(batch_sizes=(1, 2), iter_levels=(2,), queue_capacity=16, inflight=2)
    srv = FlowServer(small, cfg)
    completions = []
    real_note = srv.stats.note_completed

    def note_completed():
        completions.append(1)
        if len(completions) == 2:  # the second batch's second request
            raise RuntimeError("planted delivery failure")
        real_note()

    srv.stats.note_completed = note_completed
    srv.pause()
    handles = [srv.submit(_img(2 * i), _img(2 * i + 1)) for i in range(6)]
    srv.resume()
    rs = [h.result(60) for h in handles]
    stats = srv.drain()
    assert [r.status for r in rs] == ["error", "error", "ok", "error", "ok", "ok"]
    assert "planted read failure" in rs[0].detail
    assert "planted delivery failure" in rs[3].detail
    assert (stats.errors, stats.completed) == (3, 3)


def test_a_failed_stream_drain_answers_error_and_frees_the_slot(small, monkeypatch):
    real = pipeline.host_read
    reads = []

    def failing_read(tree, ready=None):
        reads.append(1)
        if len(reads) == 1:
            raise RuntimeError("planted read failure")
        return real(tree, ready=ready)

    monkeypatch.setattr(pipeline, "host_read", failing_read)
    eng = StreamEngine(small, StreamConfig(capacity=2, frame_hw=HW, iters=2, batch_sizes=(2,),
                                           inflight=2))
    first = eng.submit("a", _img(1), _img(2))
    assert first.result(60).status == "error"
    assert eng.close_stream("a")
    second = eng.submit("b", _img(3), _img(4))
    assert second.result(60).status == "ok"
    stats = eng.drain()
    assert (stats.errors, stats.completed, stats.streams_closed) == (1, 1, 1)
    assert eng.registry.get("a") is None


def test_sigterm_drains_the_pipelined_server_and_engine(small):
    cfg = ServeConfig(batch_sizes=(1, 2), iter_levels=(2,), queue_capacity=16, inflight=2)
    srv = FlowServer(small, cfg)
    with PreemptionHandler() as preempt:
        handles, interrupted = replay(srv, SyntheticTraffic(HW, 8, seed=3), preempt=preempt,
                                      sigterm_after=3)
    stats = srv.drain()
    assert interrupted and len(handles) == 3
    assert [h.result(60).status for h in handles] == ["ok"] * 3
    assert stats.completed == stats.accepted == 3

    eng = StreamEngine(small, StreamConfig(capacity=4, frame_hw=HW, iters=2,
                                           batch_sizes=(1, 2), inflight=2))
    with PreemptionHandler() as preempt:
        handles, interrupted = replay_streams(eng, StreamTraffic(HW, 2, 4, seed=6),
                                              preempt=preempt, sigterm_after=3)
    stats = eng.drain()
    assert interrupted and len(handles) == 3
    assert [h.result(60).status for h in handles] == ["ok"] * 3
    assert stats.completed == stats.accepted == 3


def _stream_burst(model, inflight, corrupt=None, join=None):
    """Three streams of three frames, all submitted while the engine is
    paused, so its batches are the rounds and step n+1 is launched while
    step n runs. ``corrupt``: the (stream, frame) whose first image is
    NaN; ``join``: (stream, frame) at which that stream starts."""
    cfg = StreamConfig(capacity=4, frame_hw=HW, iters=2, batch_sizes=(4,), queue_capacity=16,
                       inflight=inflight)
    out = {}
    with StreamEngine(model, cfg) as eng:
        eng.warmup()
        eng.pause()
        handles = []
        for f in range(3):
            for sid in ("a", "b", "c"):
                if join and sid == join[0] and f < join[1]:
                    continue
                i1, i2 = _img(100 + 10 * f + ord(sid)), _img(200 + 10 * f + ord(sid))
                if (sid, f) == corrupt:
                    i1 = np.full(i1.shape, np.nan, np.float32)
                handles.append(((sid, f), eng.submit(sid, i1, i2, frame_index=f)))
        eng.resume()
        for k, h in handles:
            out[k] = h.result(60)
    return out, eng.stats


def test_pipelined_engine_keeps_isolation_bit_for_bit(small):
    waiting, _ = _stream_burst(small, inflight=1)
    piped, stats = _stream_burst(small, inflight=2)
    assert stats.batches == 3
    for k, r in waiting.items():
        assert r.status == piped[k].status == "ok"
        assert r.flow.tobytes() == piped[k].flow.tobytes(), k

    hit, stats = _stream_burst(small, inflight=2, corrupt=("b", 1))
    assert stats.resets == 1 and hit[("b", 1)].status == "rejected"
    for k, r in piped.items():
        if k != ("b", 1) and k != ("b", 2):  # batch-mates and other frames
            assert hit[k].flow.tobytes() == r.flow.tobytes(), k
    # Frame 2 of b was admitted warm on the host; the card's table made it
    # cold: it equals b starting at frame 2.
    cold, _ = _stream_burst(small, inflight=2, join=("b", 2))
    assert hit[("b", 2)].status == "ok"
    assert hit[("b", 2)].flow.tobytes() == cold[("b", 2)].flow.tobytes()
    assert hit[("b", 2)].flow.tobytes() != piped[("b", 2)].flow.tobytes()
