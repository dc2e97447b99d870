"""The port's runtime guards (``raft_ncup_tpu_torch/analysis/guards.py``)
against the JAX package's (``raft_ncup_tpu/analysis/guards.py``), and the
port's hot paths held to JAX's guard contract on the CPU.

- Primitives: the same planted sequence of implicit reads, sanctioned
  reads, armed and disarmed scopes, compiles and ``StepGuard`` scopes,
  with ``raise_on_violation`` both ways, gives equal ``GuardStats`` and
  the same raises in both packages. The one difference is pinned on its
  own: JAX's ``Array.item`` reads through ``np.asarray``, which its guard
  intercepts a second time, so JAX counts two where the port counts one.
- Windows, as JAX's guard tests hold them (``tests/test_serving.py``,
  ``test_streaming.py``, ``test_inference_pipeline.py``,
  ``test_warmstart.py``, ``test_observability.py``, ``test_earlyexit.py``,
  ``test_guards.py``): after warm-up, a serve window, a stream window, a
  validation pass, a warm-start pass, a fully traced serve window and an
  early-exit window read nothing implicitly (``host_transfers == 0``),
  capture nothing (``max_recompiles(0)``) and read once a batch or pass
  (``sanctioned_gets``); the early-exit entry's flag reads are counted
  apart and equal its own ``syncs`` counter (JAX's ``lax.while_loop``
  reads none: the port's one remaining difference).
- The train loop: steady steps through the loader, the prefetcher, the
  step and the logger are read-free and build nothing under the guards;
  a planted per-step ``float(loss)`` raises under ``StepGuard``; the train
  entry's ``--strict_guards`` writes JAX's ``strict_guards:`` line, and a
  planted per-step ``.item()`` fails the run.

Counts are compared exactly; there is no numeric tolerance here, except
the validation pass against its unguarded run (rtol 1e-6, as JAX's). The
models are the small ``raft`` at 40x48, 2 iterations, one torch thread.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_ncup_tpu.analysis import guards as jguards
from raft_ncup_tpu_torch import train as train_mod
from raft_ncup_tpu_torch.analysis import guards
from raft_ncup_tpu_torch.analysis.guards import (
    GuardStats,
    GuardViolation,
    RecompileWatchdog,
    StepGuard,
    forbid_host_transfers,
    host_read,
    max_recompiles,
)
from raft_ncup_tpu_torch.config import (
    ServeConfig,
    StreamConfig,
    TrainConfig,
    small_model_config,
)
from raft_ncup_tpu_torch.data.device_prefetch import DevicePrefetcher
from raft_ncup_tpu_torch.data.loader import FlowLoader
from raft_ncup_tpu_torch.data.synthetic import SyntheticFlowDataset
from raft_ncup_tpu_torch.evaluation import _run_metric_pass, _run_warmstart_metric_pass
from raft_ncup_tpu_torch.inference.pipeline import ShapeCachedForward
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.observability import Telemetry, get_telemetry
from raft_ncup_tpu_torch.serving import FlowServer
from raft_ncup_tpu_torch.streaming import StreamEngine
from raft_ncup_tpu_torch.training.logger import Logger
from raft_ncup_tpu_torch.training.state import create_train_state
from raft_ncup_tpu_torch.training.step import make_train_step

HW = (40, 48)


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
    return RAFT(small_model_config("raft"), device="cpu", seed=0)


def _img(seed: int, hw=HW) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 255, (*hw, 3)).astype(np.float32)


# ------------------------------------------------------------ primitives


def _planted(pkg):
    """One planted sequence in either package's terms: ``(name, call)``
    steps, eight implicit reads and two sanctioned ones."""
    if pkg == "jax":
        x, v = jnp.ones(()) * 2.0, jnp.arange(4.0)
        # Looked up at the call: the guard installs its sanctioned
        # device_get in the jax module while a scope is active.
        get = lambda t: jax.device_get(t)  # noqa: E731
    else:
        x, v = torch.ones(()) * 2.0, torch.arange(4.0)
        get = host_read
    return [
        ("float", lambda: float(x)),
        ("int", lambda: int(x)),
        ("bool", lambda: bool(x > 0)),
        ("complex", lambda: complex(x)),
        ("tolist", lambda: v.tolist()),
        ("np.asarray", lambda: np.asarray(v)),
        ("np.array", lambda: np.array(v)),
        ("__array__", lambda: v.__array__()),
        ("sanctioned", lambda: get(v)),
        ("sanctioned tree", lambda: get((v, {"a": x}))),
    ]


def _run_planted(pkg, raise_on_violation: bool):
    """The planted sequence: each step inside an armed scope, then outside
    any scope (nothing counts), then nested scopes (the innermost counts).
    Returns the stats as tuples and which steps raised."""
    g = jguards if pkg == "jax" else guards
    steps = _planted(pkg)
    outer, inner = g.GuardStats(), g.GuardStats()
    raised = []

    def run(tag):
        for name, call in steps:
            try:
                call()
            except g.GuardViolation:
                raised.append(f"{tag}:{name}")

    native = {} if pkg == "jax" else {"native_guard": False}
    with g.forbid_host_transfers(outer, raise_on_violation=raise_on_violation, **native):
        run("armed")
        with g.forbid_host_transfers(inner, raise_on_violation=raise_on_violation, **native):
            run("nested")
    run("outside")
    fields = lambda s: (s.host_transfers, s.sanctioned_gets, s.recompiles,  # noqa: E731
                        s.warmup_compiles, len(s.violations))
    return fields(outer), fields(inner), raised


@pytest.mark.parametrize("raise_on_violation", [True, False])
def test_guard_stats_match_jax_on_a_planted_sequence(raise_on_violation):
    """Equal ``GuardStats`` and the same raises, step for step."""
    want = _run_planted("jax", raise_on_violation)
    got = _run_planted("torch", raise_on_violation)
    assert got == want
    outer, inner, raised = got
    assert outer[:2] == (8, 2) and inner[:2] == (8, 2)
    assert len(raised) == (16 if raise_on_violation else 0)


def test_item_counts_once_where_jax_counts_twice():
    """JAX's ``Array.item`` goes through ``np.asarray``, which its guard
    intercepts again; the port judges one read once."""
    sj, st = jguards.GuardStats(), GuardStats()
    with jguards.forbid_host_transfers(sj, raise_on_violation=False):
        (jnp.ones(()) * 2).item()
    with forbid_host_transfers(st, raise_on_violation=False):
        (torch.ones(()) * 2).item()
    assert (sj.host_transfers, st.host_transfers) == (2, 1)
    assert st.violations == ["torch.Tensor.item on cpu tensor of shape ()"]


def test_step_guard_matches_jax_across_armed_and_disarmed_scopes(model):
    """StepGuard in both packages: reads between scopes do not count,
    compiles of the first two scopes are warm-up, a later one is a
    recompile and fails ``check``; a read in a scope raises."""

    def drive(pkg):
        g = jguards if pkg == "jax" else guards
        if pkg == "jax":
            x = jnp.ones(())
            # Inputs made outside the scopes: jnp.ones compiles a program
            # of its own.
            arrays = iter([jnp.ones(n) for n in (3, 4, 5)])
            double = jax.jit(lambda a: a * 2)
            compile_new = lambda: double(next(arrays))  # noqa: E731
            read = lambda: float(x)  # noqa: E731
            get = lambda t: jax.device_get(t)  # noqa: E731
        else:
            x = torch.ones(())
            fwd = ShapeCachedForward(model)
            sizes = iter((3, 4, 5))
            compile_new = lambda: fwd.custom(  # noqa: E731
                ("planted", next(sizes)), lambda: (lambda a: a * 2), (torch.ones(1),))
            read = lambda: float(x)  # noqa: E731
            get = host_read
        raised = []
        with g.StepGuard() as guard:
            for step in range(4):
                read()  # between scopes: not counted
                try:
                    with guard.scope():
                        if step < 3:
                            compile_new()
                        get(x)
                        if step == 3:
                            read()
                except g.GuardViolation:
                    raised.append(step)
            try:
                guard.check()
            except g.GuardViolation:
                raised.append("check")
        s = guard.stats
        return (s.host_transfers, s.sanctioned_gets, s.recompiles, s.warmup_compiles), raised

    assert drive("torch") == drive("jax") == ((1, 4, 1, 2), [3, "check"])


def test_recompile_watchdog_counts_new_keys_and_kernel_loads(model):
    """A new cache key is a compile event, a hit is not (JAX's
    ``test_counts_compiles_and_cache_hits``); a kernel library's load is
    one too; ``max_recompiles`` raises over budget; a disarmed watchdog
    counts nothing."""
    fwd = ShapeCachedForward(model)
    one = torch.ones(1)
    with max_recompiles(2) as wd:
        fwd.custom(("k", 3), lambda: (lambda a: a * 2), (one,))
        fwd.custom(("k", 3), lambda: (lambda a: a * 2), (one,))  # a hit
        fwd.custom(("k", 4), lambda: (lambda a: a * 2), (one,))
    assert wd.count == 2 and fwd.stats == {"compiles": 2, "hits": 1, "evictions": 0}
    with RecompileWatchdog() as wd:
        guards.note_compile("kernel_load", "corr_lookup")
        wd.disarm()
        guards.note_compile("kernel_load", "nconv")
    assert wd.events == [("kernel_load", "corr_lookup")]
    with pytest.raises(GuardViolation, match="drifting"):
        with max_recompiles(0):
            fwd.custom(("k", 5), lambda: (lambda a: a * 2), (one,))


def test_uninstalls_cleanly_and_spares_host_data_threads():
    """Outside every scope nothing is intercepted and no patch is left on
    ``torch.Tensor`` or numpy; a host-to-device copy is never a read; a
    thread marked as a host data thread reads its host tensors freely."""
    import threading

    names = ("item", "numpy", "__bool__", "cpu", "to")
    own_before = {n: n in vars(torch.Tensor) for n in names}
    asarray = np.asarray
    with forbid_host_transfers():
        torch.from_numpy(np.ones(3, np.float32)).to("cpu", torch.float64)
        seen = []

        def worker():
            guards.mark_host_thread()
            seen.append(float(torch.ones(()) * 3))

        t = threading.Thread(target=worker)
        t.start()
        t.join()
        assert seen == [3.0]
    assert {n: n in vars(torch.Tensor) for n in names} == own_before
    assert np.asarray is asarray
    assert float(torch.ones(())) == 1.0


def test_a_violation_mirrors_into_telemetry():
    """The ``guard_host_transfer_violation`` event and the counted reads
    land in the process hub (JAX ``guards.py:131-157``)."""
    tel = get_telemetry()
    before = tel.counter_value("guard_sanctioned_gets_total")
    with forbid_host_transfers(raise_on_violation=False):
        float(torch.ones(()))
        host_read(torch.ones(2))
    assert tel.counter_value("guard_sanctioned_gets_total") - before == 1
    events = [r for r in tel.tracer.records("guard_host_transfer_violation")]
    assert events and "torch.Tensor.__float__" in events[-1]["attrs"]["desc"]


# ------------------------------------------------------------ the windows


def _serve_cfg(**kw):
    return ServeConfig(batch_sizes=(1,), iter_levels=(2, 1), queue_capacity=16, **kw)


def test_serve_window_is_sync_free_and_capture_free(model):
    """JAX ``tests/test_serving.py:585``: three warm requests, one
    sanctioned read a batch, nothing else."""
    srv = FlowServer(model, _serve_cfg())
    try:
        srv.warmup(HW)
        assert srv.submit(_img(30), _img(31)).result(60).ok
        with forbid_host_transfers() as stats, max_recompiles(0):
            handles = [srv.submit(_img(40 + i), _img(50 + i)) for i in range(3)]
            rs = [h.result(60) for h in handles]
    finally:
        srv.drain()
    assert [r.status for r in rs] == ["ok"] * 3
    assert stats.host_transfers == 0 and stats.sanctioned_gets == 3


def test_traced_serve_window_stays_sync_free(model):
    """JAX ``tests/test_observability.py:526``: with telemetry fully on,
    still no implicit read and one sanctioned read a batch, and the
    tracing was live."""
    tel = Telemetry()
    srv = FlowServer(model, _serve_cfg(), telemetry=tel)
    try:
        srv.warmup(HW)
        assert srv.submit(_img(30), _img(31)).result(60).ok
        pulls = tel.counter_value("serve_drain_pulls_total")
        with forbid_host_transfers() as stats, max_recompiles(0):
            handles = [srv.submit(_img(40 + i), _img(50 + i)) for i in range(3)]
            rs = [h.result(60) for h in handles]
    finally:
        srv.drain()
    assert [r.status for r in rs] == ["ok"] * 3
    assert stats.host_transfers == 0 and stats.sanctioned_gets == 3
    assert tel.counter_value("serve_drain_pulls_total") - pulls == 3
    assert tel.registry.histogram("serve_queue_wait_ms").count >= 3
    assert tel.tracer.records("serve_dispatch")


def test_stream_window_is_sync_free_and_capture_free(model):
    """JAX ``tests/test_streaming.py:586``: two rounds of two streams, warm
    starts and slot writes on the same entries, one read a batch."""
    eng = StreamEngine(model, StreamConfig(capacity=2, frame_hw=HW, iters=2,
                                           batch_sizes=(1, 2)))
    try:
        eng.warmup()
        eng.pause()
        hs = [eng.submit(s, _img(7), _img(8)) for s in ("a", "b")]
        eng.resume()
        assert all(h.result(60).ok for h in hs)
        with forbid_host_transfers() as stats, max_recompiles(0):
            for _ in range(2):
                eng.pause()
                hs = [eng.submit(s, _img(9), _img(10)) for s in ("a", "b")]
                eng.resume()
                assert [h.result(60).status for h in hs] == ["ok"] * 2
    finally:
        eng.drain()
    assert stats.host_transfers == 0 and stats.sanctioned_gets == 2


def test_validation_pass_is_sync_free_and_capture_free(model):
    """JAX ``tests/test_inference_pipeline.py:477``: a warm metric pass
    reads once, at its end, and equals the unguarded pass."""
    fwd = ShapeCachedForward(model)
    ds = SyntheticFlowDataset(HW, length=4, seed=11, style="smooth")
    warm = _run_metric_pass(fwd, ds, kind="epe", iters=2, batch_size=2, num_workers=2)
    with forbid_host_transfers() as stats, max_recompiles(0):
        guarded = _run_metric_pass(fwd, ds, kind="epe", iters=2, batch_size=2, num_workers=2)
    assert stats.host_transfers == 0 and stats.sanctioned_gets == 1
    np.testing.assert_allclose(guarded, warm, rtol=1e-6)


class _SeqDataset:
    """Three frames of one sequence, numpy on the host (JAX
    ``tests/test_warmstart.py``'s ``_SeqDataset``)."""

    def __init__(self, n: int):
        g = np.random.default_rng(4)
        self._s = [{"image1": g.uniform(0, 255, (*HW, 3)).astype(np.float32),
                    "image2": g.uniform(0, 255, (*HW, 3)).astype(np.float32),
                    "flow": g.normal(0, 1, (*HW, 2)).astype(np.float32),
                    "extra_info": ("seq", i)} for i in range(n)]

    def __len__(self):
        return len(self._s)

    def sample(self, i):
        return self._s[i]


def test_warmstart_pass_is_pull_free(model):
    """JAX ``tests/test_warmstart.py:211``: the splat stays on the device,
    one read for the pass."""
    fwd = ShapeCachedForward(model)
    ds = _SeqDataset(3)
    _run_warmstart_metric_pass(fwd, ds, kind="epe", iters=1, num_workers=1)
    with forbid_host_transfers() as stats, max_recompiles(0):
        _run_warmstart_metric_pass(fwd, ds, kind="epe", iters=1, num_workers=1)
    assert stats.host_transfers == 0 and stats.sanctioned_gets == 1


def test_early_exit_window_counts_flag_reads_apart(model, monkeypatch):
    """JAX ``tests/test_earlyexit.py:168`` with the port's one exception:
    the early-exit entry reads one flag a segment but the last, a named
    read counted as ``guard_flag_reads_total`` (equal to the entry's
    ``syncs``), never an implicit transfer. Level 8 replays two segments
    of 4, so an unconverged batch reads one flag."""
    monkeypatch.setenv("RAFT_TORCH_EARLYEXIT", "1")
    monkeypatch.setenv("RAFT_TORCH_EARLYEXIT_TOL", "1e-9")  # no row converges
    tel = get_telemetry()
    srv = FlowServer(model, ServeConfig(batch_sizes=(1,), iter_levels=(8,)))
    try:
        srv.warmup(HW)
        assert srv.submit(_img(30), _img(31)).result(60).ok
        syncs, flags = srv._fwd.earlyexit["syncs"], tel.counter_value("guard_flag_reads_total")
        with forbid_host_transfers() as stats, max_recompiles(0):
            hs = [srv.submit(_img(40 + i), _img(50 + i)) for i in range(3)]
            rs = [h.result(60) for h in hs]
    finally:
        srv.drain()
    assert [(r.status, r.iters) for r in rs] == [("ok", 8)] * 3
    assert stats.host_transfers == 0 and stats.sanctioned_gets == 3
    assert srv._fwd.earlyexit["syncs"] - syncs == 3
    assert tel.counter_value("guard_flag_reads_total") - flags == 3


# ------------------------------------------------------------ the train loop


def _train_parts(tmp_path, n=8):
    cfg = TrainConfig(stage="chairs", lr=1e-4, num_steps=50, batch_size=1, image_size=(32, 48),
                      iters=2, sum_freq=2)
    state = create_train_state(small_model_config("raft"), cfg, torch.device("cpu"))
    loader = FlowLoader(SyntheticFlowDataset((32, 48), length=n, seed=3), batch_size=1,
                        seed=11, num_workers=1)
    return cfg, state, make_train_step(cfg), loader


def test_steady_train_loop_is_sync_free_and_builds_nothing(tmp_path):
    """JAX ``tests/test_guards.py:120``: two warm steps, then four under
    the guards with the logger's window read at every second step."""
    cfg, state, step, loader = _train_parts(tmp_path)
    logger = Logger(str(tmp_path), sum_freq=2)
    with DevicePrefetcher(loader.batches(), depth=2, device="cpu") as pf:
        for i in range(2):
            logger.push(i, step(state, next(pf)), state.optimizer.lr())
        with forbid_host_transfers() as stats, max_recompiles(0):
            for i in range(2, 6):
                lr = state.optimizer.lr()
                logger.push(i, step(state, next(pf)), lr)
    logger.close()
    assert stats.host_transfers == 0, stats.violations
    assert stats.sanctioned_gets == 2
    assert state.step == 6


def test_step_guard_catches_a_planted_per_step_read(tmp_path):
    """JAX ``tests/test_guards.py:172``: a per-step ``float`` of the loss
    trips the guard at once."""
    cfg, state, step, loader = _train_parts(tmp_path, n=2)
    with DevicePrefetcher(loader.batches(), depth=1, device="cpu") as pf:
        with StepGuard() as guard:
            with pytest.raises(GuardViolation, match="device->host"):
                with guard.scope():
                    metrics = step(state, next(pf))
                    float(metrics["loss"])  # the planted per-step read
    assert guard.stats.host_transfers == 1


def _entry_args(tmp_path, *extra):
    return ["--device", "cpu", "--name", "guarded", "--stage", "chairs", "--model", "raft",
            "--small", "--synthetic_ok", "--num_steps", "4", "--batch_size", "1",
            "--image_size", "64", "96", "--iters", "2", "--sum_freq", "2", "--num_workers", "1",
            "--checkpoint_dir", str(tmp_path), "--strict_guards", *extra]


def test_train_entry_strict_guards_line_and_a_planted_read(tmp_path, monkeypatch, capsys):
    """``--strict_guards`` runs clean and writes JAX's line; the same run
    with a per-step ``.item()`` planted in the step fails."""
    assert train_mod.main(_entry_args(tmp_path / "clean")) == 0
    log = open(os.path.join(tmp_path, "clean", "guarded", "log.txt")).read()
    assert ("strict_guards: warmup_compiles=0 steady_recompiles=0 host_transfers=0 "
            "sanctioned_gets=2") in log
    summary = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"strict_guards": {"warmup_compiles": 0, "steady_recompiles": 0' in summary

    real = train_mod.make_train_step

    def planted(cfg, *a, **kw):
        step = real(cfg, *a, **kw)

        def read_each_step(state, batch):
            metrics = step(state, batch)
            metrics["loss"].item()  # the planted per-step read
            return metrics

        return read_each_step

    monkeypatch.setattr(train_mod, "make_train_step", planted)
    with pytest.raises(GuardViolation, match="torch.Tensor.item"):
        train_mod.main(_entry_args(tmp_path / "planted"))
    cfg_fields = {f.name for f in dataclasses.fields(GuardStats)}
    assert cfg_fields == {f.name for f in dataclasses.fields(jguards.GuardStats)}
