"""The port's serving tier on the CPU: FlowServer answers, quarantine,
shedding, deadlines, drain, the serve entry, and parity of its pure-host
pieces (padder, budget controller, admission queue) with the JAX
package's."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_ncup_tpu.ops.padding import InputPadder as JaxInputPadder
from raft_ncup_tpu.serving.admission import AdmissionQueue as JaxAdmissionQueue
from raft_ncup_tpu.serving.budget import IterationBudgetController as JaxBudget
from raft_ncup_tpu.serving.request import FlowRequest as JaxFlowRequest
from raft_ncup_tpu.serving.request import nearest_rank_ms as jax_nearest_rank_ms
from raft_ncup_tpu_torch import serve as serve_mod
from raft_ncup_tpu_torch.config import ServeConfig, flagship_config
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.ops.padding import InputPadder
from raft_ncup_tpu_torch.serving import (
    AdmissionQueue,
    FlowRequest,
    FlowServer,
    IterationBudgetController,
    nearest_rank_ms,
)

NATIVE = (60, 90)  # not a multiple of 8: pads to 64x96


@pytest.fixture(scope="module")
def model():
    return RAFT(
        flagship_config(corr_impl="pallas", nconv_impl="pallas"), device="cpu",
        seed=3,
    )


def _pair(g, h, w):
    img1 = g.uniform(0, 255, (h, w, 3)).astype(np.float32)
    return img1, np.roll(img1, (1, 2), axis=(0, 1)).copy()


def test_server_answers_quarantines_and_drains(model):
    g = np.random.default_rng(0)
    pairs = [_pair(g, *NATIVE) for _ in range(3)]
    nan1 = np.full((*NATIVE, 3), np.nan, np.float32)
    cfg = ServeConfig(batch_sizes=(1, 2), iter_levels=(2,), queue_capacity=8)
    server = FlowServer(model, cfg)
    server.pause()  # queue everything first: batches [0, 1] and [2, nan]
    handles = [server.submit(a, b) for a, b in pairs]
    handles.append(server.submit(nan1, nan1))
    server.resume()
    stats = server.drain()
    responses = [h.result(timeout=60) for h in handles]
    assert [r.status for r in responses] == ["ok", "ok", "ok", "rejected"]
    assert stats.completed == 3 and stats.rejected == 1 and stats.errors == 0
    assert stats.quarantined == [3]
    assert stats.accepted == 4 and stats.batches == 2
    # drain() answered everything admitted: nothing is left pending.
    assert stats.completed + stats.rejected == stats.accepted
    assert all(h.done() for h in handles)
    padder = InputPadder((*NATIVE, 3), mode="sintel")
    for (a, b), resp in zip(pairs, responses):
        assert resp.flow.shape == (*NATIVE, 2) and resp.iters == 2
        p1, p2 = padder.pad(torch.from_numpy(a)[None], torch.from_numpy(b)[None])
        _, flow_up = model(p1, p2, iters=2)
        want = padder.unpad(flow_up)[0].numpy()
        # The served row ran in a batch of two or of one; batch size
        # changes the summation order of the CPU convolutions, so allow
        # f32 noise, far below the parity tolerances.
        np.testing.assert_allclose(resp.flow, want, atol=1e-4, rtol=1e-5)
    # Drained: a new submit sheds with a retry hint.
    late = server.submit(*pairs[0]).result(timeout=1)
    assert late.status == "shed" and late.detail == "draining"
    assert late.retry_after_s > 0


def test_full_queue_sheds_and_deadline_times_out(model):
    now = [0.0]
    cfg = ServeConfig(batch_sizes=(1,), iter_levels=(1,), queue_capacity=2,
                      default_retry_after_s=0.5)
    server = FlowServer(model, cfg, clock=lambda: now[0])
    g = np.random.default_rng(1)
    a, b = _pair(g, 40, 48)
    server.pause()
    h_deadline = server.submit(a, b, deadline_s=1.0)
    h_ok = server.submit(a, b)
    h_shed = server.submit(a, b)
    bad = server.submit(np.zeros((40, 48), np.float32), np.zeros((40, 48), np.float32))
    now[0] = 5.0  # past the first request's deadline
    server.resume()
    stats = server.drain()
    assert h_shed.result(1).status == "shed"
    assert h_shed.result(1).retry_after_s == 0.5
    assert bad.result(1).status == "rejected"
    assert h_deadline.result(60).status == "timeout"
    assert h_ok.result(60).status == "ok"
    assert (stats.shed, stats.timeouts, stats.completed, stats.rejected) == (1, 1, 1, 1)


def test_server_turns_a_model_fault_into_error_status(model, monkeypatch):
    server = FlowServer(model, ServeConfig(batch_sizes=(1,), iter_levels=(1,)))

    def broken(*_args, **_kw):
        raise RuntimeError("kernel fault")

    monkeypatch.setattr(server, "_forward", broken)
    g = np.random.default_rng(2)
    resp = server.submit(*_pair(g, 40, 48)).result(timeout=60)
    stats = server.drain()
    assert resp.status == "error" and "kernel fault" in resp.detail
    assert stats.errors == 1


def test_server_is_a_context_manager_that_drains_on_exit(model):
    """``with FlowServer(...) as server`` returns the server and drains it
    on exit, as the JAX server does; ``draining`` says so."""
    g = np.random.default_rng(6)
    cfg = ServeConfig(batch_sizes=(1,), iter_levels=(1,), queue_capacity=4)
    with FlowServer(model, cfg) as server:
        assert isinstance(server, FlowServer) and not server.draining
        handle = server.submit(*_pair(g, 40, 48))
    assert server.draining
    assert handle.done() and handle.result(0).status == "ok"
    late = server.submit(*_pair(g, 40, 48)).result(timeout=1)
    assert late.status == "shed" and late.detail == "draining"


class _Abort(BaseException):
    """Not an ``Exception``: what a ``KeyboardInterrupt`` or a
    ``SystemExit`` raised inside a batch looks like to the dispatcher."""


def test_server_answers_a_base_exception_and_keeps_serving(model, monkeypatch):
    """A ``BaseException`` in one batch answers that batch's requests with
    ``error`` and the dispatcher goes on with the queue behind it."""
    server = FlowServer(model, ServeConfig(batch_sizes=(1,), iter_levels=(1,)))
    real = server._forward
    calls = []

    def abort_once(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise _Abort("batch aborted")
        return real(*args, **kwargs)

    monkeypatch.setattr(server, "_forward", abort_once)
    g = np.random.default_rng(7)
    server.pause()  # two batches of one, queued before the first runs
    first = server.submit(*_pair(g, 40, 48))
    second = server.submit(*_pair(g, 40, 48))
    server.resume()
    stats = server.drain()
    r1, r2 = first.result(timeout=1), second.result(timeout=1)
    assert r1.status == "error" and "batch aborted" in r1.detail
    assert r2.status == "ok" and r2.flow.shape == (40, 48, 2)
    assert (stats.errors, stats.completed) == (1, 1)


def test_serve_entry_prints_one_report_line(capsys):
    rc = serve_mod.main([
        "--device", "cpu", "--size", "40", "48", "--num_requests", "2",
        "--iter_levels", "1", "--serve_batch_sizes", "1,2", "--seed", "1",
    ])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(lines) == 1
    report = json.loads(lines[0])
    assert report["serve_ok"] == 2 and report["errors"] == 0
    assert report["corr_kernel_launches"] == 0  # CPU: plain versions
    assert report["device"] == "cpu"


@pytest.mark.parametrize("mode", ["sintel", "kitti"])
@pytest.mark.parametrize("bucket", [0, 32])
def test_input_padder_matches_jax(mode, bucket):
    g = np.random.default_rng(4)
    x = g.normal(size=(2, 37, 51, 3)).astype(np.float32)
    jp = JaxInputPadder(x.shape, mode=mode, bucket=bucket)
    pp = InputPadder(x.shape, mode=mode, bucket=bucket)
    assert pp.pad_spec == jp.pad_spec
    (ours,) = pp.pad(torch.from_numpy(x))
    (ref,) = jp.pad(jnp.asarray(x))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        pp.unpad(ours).numpy(), np.asarray(jp.unpad(ref))
    )


def test_budget_controller_follows_the_jax_trajectory():
    depths = [0, 7, 8, 8, 1, 1, 1, 1, 1, 5, 0, 0, 0, 0, 0, 8, 2, 0, 0, 0, 0]
    ours = IterationBudgetController((24, 16, 8), capacity=8, recover_patience=3)
    ref = JaxBudget((24, 16, 8), capacity=8, recover_patience=3)
    assert [ours.decide(d) for d in depths] == [ref.decide(d) for d in depths]
    assert (ours.drops, ours.recoveries) == (ref.drops, ref.recoveries)
    assert ours.decisions == ref.decisions


def test_admission_queue_batches_like_jax():
    keys = [(64, 96), (64, 96), (32, 48), (64, 96), (64, 96), (64, 96)]
    ours, ref = AdmissionQueue(5), JaxAdmissionQueue(5)
    got_ours = [ours.offer(FlowRequest(i, None, None, shape_key=k))
                for i, k in enumerate(keys)]
    got_ref = [ref.offer(JaxFlowRequest(i, None, None, shape_key=k))
               for i, k in enumerate(keys)]
    assert got_ours == got_ref == [True] * 5 + [False]
    for _ in range(4):
        a = [r.request_id for r in ours.pop_batch(2, timeout=0.01)]
        b = [r.request_id for r in ref.pop_batch(2, timeout=0.01)]
        assert a == b
    assert ours.pop_batch(2, timeout=0.01) == []


def test_nearest_rank_matches_jax():
    lat = list(np.random.default_rng(5).uniform(0.01, 0.2, 17))
    for p in (0.5, 0.9, 0.99, 1.0):
        assert nearest_rank_ms(lat, p) == jax_nearest_rank_ms(lat, p)
    assert nearest_rank_ms([], 0.5) is None
