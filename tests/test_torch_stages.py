"""The port's model stages, warm-started GRU state and early exit against
the JAX package, on the CPU, and the budget's early-exit cost model.

Models: small ``raft`` and small ``raft_nc_dbl`` at 32x48, batch 3, 4
iterations; the JAX variables come from the port's seeded weights
(``import_torch_state``) and are carried back with ``load_jax_variables``.
JAX runs its default ``volume`` correlation and XLA NConv2d; the port runs
both kernels' wrappers, which take their plain versions on the CPU.

Tolerances: flow_lr atol 2e-3 and flow_up atol 5e-3 (rtol 1e-3) against
JAX, the port's standing ones; the port against itself bit for bit (the
same step body on the same inputs); ``exec_iters`` exactly, under a
tolerance taken between the rows' first-iteration norms (JAX's
``_splitting_tol``) so that no row sits on the threshold; the early-exit
flow within ``EARLYEXIT_EPE_BUDGET`` mean EPE of its full-budget twin.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_ncup_tpu.config import small_model_config as jax_small_config
from raft_ncup_tpu.models.raft import RAFT as JaxRAFT
from raft_ncup_tpu.serving.budget import IterationBudgetController as JaxBudget
from raft_ncup_tpu.utils.torch_import import import_torch_state
from raft_ncup_tpu_torch.config import ServeConfig, small_model_config
from raft_ncup_tpu_torch.inference.pipe_schedule import split_iters, validate_segment_levels
from raft_ncup_tpu_torch.inference.pipeline import (
    ShapeCachedForward,
    env_earlyexit_tol,
    segment_length,
)
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.precision import EARLYEXIT_EPE_BUDGET
from raft_ncup_tpu_torch.serving import FlowServer, IterationBudgetController
from raft_ncup_tpu_torch.utils.jax_weights import load_jax_variables

B, H, W, ITERS = 3, 32, 48, 4
FLOW_LR_TOL = dict(atol=2e-3, rtol=1e-3)
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


def _pair(variant):
    cfg = small_model_config(variant, dataset="chairs", corr_impl="pallas", nconv_impl="pallas")
    seeded = RAFT(cfg, device="cpu", seed=0)
    jmodel = JaxRAFT(jax_small_config(variant, dataset="chairs"))
    template = jax.eval_shape(lambda k: jmodel.init(k, (1, H, W, 3)), jax.random.key(0))
    variables = import_torch_state(
        {k: v.numpy() for k, v in seeded.state_dict().items()}, template, strict=True)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return load_jax_variables(RAFT(cfg, device="cpu", seed=1), variables), jmodel, variables


@pytest.fixture(scope="module")
def models():
    return {v: _pair(v) for v in ("raft", "raft_nc_dbl")}


@pytest.fixture(scope="module")
def images():
    g = np.random.default_rng(7)
    return tuple((g.random((B, H, W, 3)) * 255.0).astype(np.float32) for _ in range(2))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(port, ref, tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **tol)


def _splitting_tol(model, i1, i2) -> float:
    """A tolerance between the rows' first-iteration norms: the flow starts
    at zero, so the mean |flow_lr| after one iteration is the detector's
    first norm."""
    lr, _ = model(_t(i1), _t(i2), iters=1)
    d1 = lr.abs().mean(dim=(1, 2, 3))
    lo, hi = float(d1.min()), float(d1.max())
    assert lo < hi, f"degenerate probe: all rows at {lo}"
    return (lo + hi) / 2.0


# ---------------------------------------------------------------- stages


@pytest.mark.parametrize("variant", ["raft", "raft_nc_dbl"])
@pytest.mark.parametrize("segments", [1, 2, 4])
def test_stages_equal_the_forward_and_jax(models, images, variant, segments):
    port, jmodel, variables = models[variant]
    i1, i2 = images
    seg = split_iters(ITERS, segments)
    carry = port.encode(_t(i1), _t(i2))
    for _ in range(segments):
        carry = port.refine_segment(carry, seg)
    lr, up = port.finalize(carry)
    want_lr, want_up = port(_t(i1), _t(i2), iters=ITERS)
    assert torch.equal(lr, want_lr) and torch.equal(up, want_up)
    if segments != 2:
        return  # the port's stages equal its forward; JAX's are held at one split
    jcarry = jmodel.encode(variables, jnp.asarray(i1), jnp.asarray(i2))
    for _ in range(segments):
        jcarry = jmodel.refine_segment(variables, jcarry, seg)
    jlr, jup = jmodel.finalize(variables, jcarry)
    _close(lr, jlr, FLOW_LR_TOL)
    _close(up, jup, FLOW_UP_TOL)


# ------------------------------------------------------------ warm start


@pytest.mark.parametrize("variant", ["raft", "raft_nc_dbl"])
def test_warm_start_matches_jax_and_keeps_cold_rows_bitwise(models, images, variant):
    port, jmodel, variables = models[variant]
    i1, i2 = images
    g = np.random.default_rng(3)
    net_init = np.tanh(g.normal(size=(B, H // 8, W // 8, port.cfg.hidden_dim))).astype(
        np.float32)
    warm = np.array([True, False, True])
    lr, up, net = port(_t(i1), _t(i2), iters=2, net_init=_t(net_init), net_warm=_t(warm),
                       return_net=True)
    jlr, jup, jnet = jmodel.apply(variables, jnp.asarray(i1), jnp.asarray(i2), iters=2,
                                  test_mode=True, net_init=jnp.asarray(net_init),
                                  net_warm=jnp.asarray(warm), return_net=True)
    _close(lr, jlr, FLOW_LR_TOL)
    _close(up, jup, FLOW_UP_TOL)
    assert net.shape == (B, H // 8, W // 8, port.cfg.hidden_dim)
    _close(net, jnet, FLOW_LR_TOL)
    cold_lr, cold_up, cold_net = port(_t(i1), _t(i2), iters=2, return_net=True)
    assert torch.equal(lr[1], cold_lr[1]) and torch.equal(up[1], cold_up[1])
    assert torch.equal(net[1], cold_net[1])
    assert not torch.equal(lr[0], cold_lr[0])  # the carry did act on a warm row
    # net_warm None: every row starts from the carry.
    all_lr, _ = port(_t(i1), _t(i2), iters=2, net_init=_t(net_init))
    assert torch.equal(all_lr[0], lr[0]) and not torch.equal(all_lr[1], lr[1])


# ------------------------------------------------------------ early exit


@pytest.fixture(scope="module")
def early(models, images):
    """The small raft_nc_dbl's early-exit forward under a splitting
    tolerance, and JAX's."""
    port, jmodel, variables = models["raft_nc_dbl"]
    i1, i2 = images
    tol = _splitting_tol(port, i1, i2)
    out = port(_t(i1), _t(i2), iters=ITERS, early_exit_tol=tol, return_exec_iters=True)
    jout = jmodel.apply(variables, jnp.asarray(i1), jnp.asarray(i2), iters=ITERS,
                        test_mode=True, early_exit_tol=tol, return_exec_iters=True)
    return tol, out, jout


def test_early_exit_matches_jax(early):
    tol, (lr, up, ex), (jlr, jup, jex) = early
    assert ex.dtype == torch.int32 and ex.tolist() == np.asarray(jex).tolist()
    assert 1 <= ex.min() < ex.max() <= ITERS  # the tolerance split the batch
    _close(lr, jlr, FLOW_LR_TOL)
    _close(up, jup, FLOW_UP_TOL)


def test_converged_row_is_the_truncated_run(models, images, early):
    port = models["raft_nc_dbl"][0]
    i1, i2 = images
    tol, (lr, up, ex), _ = early
    for i, k in enumerate(ex.tolist()):
        ref_lr, ref_up = port(_t(i1), _t(i2), iters=k)
        assert torch.equal(lr[i], ref_lr[i]) and torch.equal(up[i], ref_up[i])


def test_tiny_tolerance_runs_the_full_budget(models, images):
    port = models["raft_nc_dbl"][0]
    i1, i2 = images
    lr, up, ex = port(_t(i1), _t(i2), iters=ITERS, early_exit_tol=1e-9,
                      return_exec_iters=True)
    full_lr, full_up = port(_t(i1), _t(i2), iters=ITERS)
    assert (ex == ITERS).all()
    assert torch.equal(lr, full_lr) and torch.equal(up, full_up)


def test_early_exit_stays_within_the_epe_budget(models, images, early):
    """A budget of 2, as JAX's test: each converged row skips one step, the
    granularity the EPE budget is written against."""
    port = models["raft_nc_dbl"][0]
    i1, i2 = images
    tol = early[0]
    _, up, ex = port(_t(i1), _t(i2), iters=2, early_exit_tol=tol, return_exec_iters=True)
    _, full_up = port(_t(i1), _t(i2), iters=2)
    assert ex.min() == 1  # detection fired
    epe = float((up - full_up).norm(dim=-1).mean())
    assert epe <= EARLYEXIT_EPE_BUDGET, f"{epe:.4f} px against {EARLYEXIT_EPE_BUDGET}"


@pytest.mark.parametrize("segments", [1, 2, 4])
def test_refine_segment_bills_whole_segments(models, images, early, segments):
    port = models["raft_nc_dbl"][0]
    i1, i2 = images
    tol, (lr, up, ex), _ = early
    seg = split_iters(ITERS, segments)
    carry = port.encode(_t(i1), _t(i2), early_exit=True)
    for _ in range(segments):
        carry = port.refine_segment(carry, seg, early_exit_tol=tol)
    got_lr, got_up = port.finalize(carry)
    assert carry["exec_iters"].tolist() == [math.ceil(k / seg) * seg for k in ex.tolist()]
    assert torch.equal(got_lr, lr) and torch.equal(got_up, up)


def test_early_exit_entry_replays_segments_until_every_row_converged(models, images, early):
    """The cache's early-exit entry (encode, segments with a flag read
    between them, finalize) equals the model's early-exit forward and
    counts its segments and host reads."""
    port = models["raft_nc_dbl"][0]
    i1, i2 = images
    tol, want, _ = early
    fwd = ShapeCachedForward(port)
    for iters in (ITERS, 2 * ITERS):
        got = fwd.forward(i1, i2, iters, early_exit_tol=tol)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        seg = segment_length(iters)
        n = -(-int(want[2].max()) // seg)  # segments until every row converged
        assert fwd.last_earlyexit == {"segments": n, "syncs": min(n, iters // seg - 1),
                                      "iters_run": n * seg}
    assert fwd.stats["compiles"] == 2 and fwd.earlyexit["forwards"] == 2
    assert len(fwd.forward(i1, i2, ITERS)) == 2  # detection off: its own key, 2 results
    assert fwd.stats["compiles"] == 3


def test_argument_errors_follow_jax(models, images):
    port = models["raft"][0]
    i1, i2 = (_t(x) for x in images)
    with pytest.raises(ValueError, match="early_exit_tol"):
        port(i1, i2, iters=2, return_exec_iters=True)
    port.train()
    try:
        with pytest.raises(ValueError, match="test_mode"):
            port(i1, i2, iters=2, early_exit_tol=0.1)
    finally:
        port.eval()
    with pytest.raises(ValueError, match="encode"):
        port.refine_segment(port.encode(i1, i2), 1, early_exit_tol=0.1)


def test_env_knobs(monkeypatch):
    monkeypatch.delenv("RAFT_TORCH_EARLYEXIT", raising=False)
    assert env_earlyexit_tol() is None
    monkeypatch.setenv("RAFT_TORCH_EARLYEXIT", "1")
    assert env_earlyexit_tol() == 0.05
    monkeypatch.setenv("RAFT_TORCH_EARLYEXIT_TOL", "0.125")
    assert env_earlyexit_tol() == 0.125


# ------------------------------------------------- the budget's cost model


def _budgets(**kw):
    args = dict(capacity=10, high_water=0.75, low_water=0.25, recover_patience=2, **kw)
    return IterationBudgetController((8, 4), **args), JaxBudget((8, 4), **args)


def _same(ours, ref):
    assert ours.expected_iters == pytest.approx(ref.expected_iters, abs=1e-12)
    assert ours.expected_scale() == pytest.approx(ref.expected_scale(), abs=1e-12)
    assert (ours.drops, ours.recoveries, ours.decisions) == (ref.drops, ref.recoveries,
                                                             ref.decisions)
    assert ours.summary() == ref.summary()


@pytest.mark.parametrize("case", ["unfed", "fed_low", "clamps", "recovery"])
def test_budget_ewma_follows_jax(case):
    ours, ref = _budgets()
    feed = {"unfed": [], "fed_low": [2.0] * 32, "clamps": [0.0, 99.0],
            "recovery": [1.0]}[case]
    depths = {"unfed": [8], "fed_low": [8], "clamps": [8, 0],
              "recovery": [8, 8, 1, 1]}[case]
    for x in feed:
        ours.note_executed(x)
        ref.note_executed(x)
    got = [ours.decide(d) for d in depths]
    assert got == [ref.decide(d) for d in depths]
    _same(ours, ref)
    if case == "unfed":
        assert ours.expected_iters == 8.0 and got == [4]
    if case == "fed_low":  # the same depth holds full quality once cheap
        assert ours.expected_scale() == pytest.approx(0.25, abs=1e-3) and got == [8]
    if case == "clamps":
        assert ours.expected_iters == pytest.approx(0.25 * 8.0 + 0.75 * 1.0)


def test_budget_segments_are_validated_at_construction():
    IterationBudgetController((24, 12), capacity=8, segments=2)
    with pytest.raises(ValueError, match="segment"):
        IterationBudgetController((24, 16, 8), capacity=8, segments=2)
    with pytest.raises(ValueError, match="segment"):
        validate_segment_levels((24, 16), 5)


def test_served_burst_with_detection_feeds_the_budget(models, images, early, monkeypatch):
    port = models["raft_nc_dbl"][0]
    i1, i2 = images
    tol, _, _ = early
    monkeypatch.setenv("RAFT_TORCH_EARLYEXIT", "1")
    monkeypatch.setenv("RAFT_TORCH_EARLYEXIT_TOL", repr(tol))
    cfg = ServeConfig(queue_capacity=8, batch_sizes=(1,), iter_levels=(ITERS, 2),
                      recover_patience=2)
    with FlowServer(port, cfg) as server:
        assert server._earlyexit_tol == tol
        assert server.warmup((H, W)) == 2
        server.pause()
        handles = [server.submit(i1[k], i2[k]) for k in range(B)]
        server.resume()
        responses = [h.result(60) for h in handles]
    assert [r.status for r in responses] == ["ok"] * B
    report = server.report()
    assert report["executables"]["compiles"] == 2  # warm-up captured every entry
    assert report["earlyexit"]["forwards"] == 2 + B
    execs = []
    for k, r in enumerate(responses):
        _, up, ex = port(_t(i1[k:k + 1]), _t(i2[k:k + 1]), iters=r.iters,
                         early_exit_tol=tol, return_exec_iters=True)
        np.testing.assert_allclose(r.flow, up[0].numpy(), atol=1e-4, rtol=1e-5)
        execs.append(int(ex[0]))
    ref = JaxBudget((ITERS, 2), capacity=8, recover_patience=2)
    for x in execs:
        ref.note_executed(x)
    assert report["budget_expected_iters"] == round(ref.expected_iters, 3)
    assert report["budget_expected_iters"] < ITERS  # the model moved off the worst case
