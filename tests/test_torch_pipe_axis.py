"""The port's pipe axis (``parallel/mesh.py``, ``inference/pipe_schedule.py``)
against the JAX package's, on the CPU.

JAX's ``PipelinedForward(segments=S)`` runs on the CPU's virtual devices
(``tests/conftest.py``); the port's runs over an S-process gloo world, each
rank ``tests/_torch_pipe_child.py`` in its own interpreter with one torch
thread, one world per S, started once for the module and run while the
JAX references are computed here. Both sides hold the port's seeded
weights (carried into JAX by ``import_torch_state``) and the same seeded
micro-batches, at JAX's ``tests/test_pipe_schedule.py`` sizes (32x32, 4
iterations, 3 micro-batches of batch 1).

- Every rank's flows equal JAX's pipelined flows: small ``raft`` and small
  ``raft_nc_dbl`` at S = 2 in f32 (the flagship tolerances: flow_lr atol
  2e-3, flow_up atol 5e-3, rtol 1e-3) and under ``bf16_infer`` (mean EPE
  against JAX's bf16 flow no larger than JAX's bf16-to-f32 distance, both
  within ``FORWARD_EPE_BUDGET``, as ``test_torch_precision.py`` holds
  bf16), small ``raft`` at S = 4 in f32; and the port's one-process forward
  within 1e-5.
- Early exit quantizes to segment boundaries: ``exec_pipe ==
  ceil(exec_mono / seg_len) * seg_len`` at S = 2 and 4 and JAX's pipelined
  count; at S = 1 the monolithic count itself.
- S = 1 is exactly the monolithic path; a segment count that disagrees
  with the mesh, a mixed mesh and an unsplittable budget raise.
- The schedule: each rank refines every micro-batch's segment (kernel A's
  wrapper called ``seg_len`` times a micro-batch), rank 0 alone encodes,
  the last rank alone finalizes (kernel B's wrapper 4 times a micro-batch
  for ``raft_nc_dbl``); each hand-off is one ``collective-permute`` of the
  carry's bytes, S - 1 a micro-batch over the ranks; each micro-batch's
  flows reach every rank in one broadcast.
- A second stream of the same shape under the runtime guards captures
  nothing, reads nothing implicitly, replays hits and receives into the
  same buffers.
- The stage programs' cost-ledger entries carry JAX's structured meta and
  the segment's split.
- The mesh's rank layout and fingerprint are JAX's ``make_mesh(1, 1, S)``;
  the serve entry and the evaluate entry over ``--mesh 1,1,2`` answer as
  one process does, and a server's levels off the segment boundaries
  raise JAX's message at construction.
"""

import math
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_ncup_tpu.config import small_model_config as jax_small_model_config
from raft_ncup_tpu.inference.pipe_schedule import PipelinedForward as JaxPipelinedForward
from raft_ncup_tpu.models.raft import RAFT as JaxRAFT
from raft_ncup_tpu.parallel.mesh import make_mesh as jax_make_mesh
from raft_ncup_tpu.parallel.mesh import mesh_fingerprint as jax_mesh_fingerprint
from raft_ncup_tpu.serving.budget import IterationBudgetController as JaxBudget
from raft_ncup_tpu.utils.torch_import import import_torch_state
from raft_ncup_tpu_torch import evaluate as eval_entry
from raft_ncup_tpu_torch import precision
from raft_ncup_tpu_torch import serve as serve_entry
from raft_ncup_tpu_torch.inference import pipeline as pipeline_mod
from raft_ncup_tpu_torch.inference.costs import CostLedger
from raft_ncup_tpu_torch.inference.pipe_schedule import PipelinedForward
from raft_ncup_tpu_torch.inference.pipeline import ShapeCachedForward
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.parallel import mesh as mesh_mod

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _torch_pipe_child as child  # noqa: E402

WORLDS = (2, 4)
SPAWN_TIMEOUT_S = 240
LR_ATOL, UP_ATOL, RTOL = 2e-3, 5e-3, 1e-3
ONE_PROCESS_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _variables(variant):
    """The port's seeded weights carried into JAX's variables."""
    seeded = RAFT(child.model_cfg(variant), device="cpu", seed=0)
    jmodel = JaxRAFT(jax_small_model_config(variant, dataset=child.MODELS[variant],
                                            corr_impl="onthefly"))
    template = jax.eval_shape(lambda k: jmodel.init(k, (1, *child.HW, 3)), jax.random.key(0))
    variables = import_torch_state({k: v.numpy() for k, v in seeded.state_dict().items()},
                                   template, strict=True)
    return jmodel, jax.tree_util.tree_map(np.asarray, variables)


def _pairs():
    g = np.random.default_rng(0)
    return [tuple((g.random((1, *child.HW, 3)) * 255.0).astype(np.float32) for _ in range(2))
            for _ in range(child.PAIRS)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(world, work):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE), OMP_NUM_THREADS="1")
    env.pop("RAFT_TORCH_FLIGHT_DIR", None)
    return [subprocess.Popen([sys.executable, os.path.join(HERE, "_torch_pipe_child.py"),
                              str(port), str(r), str(world), str(work)],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, cwd=str(work))
            for r in range(world)]


def _jax_refs(pairs, jmodels, variables):
    """JAX's pipelined streams of every case, by (S, variant, precision),
    and their early-exit twins by S."""
    refs = {}
    for world in WORLDS:
        for variant, prec in child.CASES[world] + ((("raft_nc_dbl", "f32"),) if world == 2
                                                   else ()):
            if (world, variant, prec) in refs:
                continue
            pf = JaxPipelinedForward(jmodels[variant], variables[variant], segments=world)
            outs = pf.forward_many([(jnp.asarray(a), jnp.asarray(b)) for a, b in pairs],
                                   child.ITERS, policy=None if prec == "f32" else prec)
            refs[(world, variant, prec)] = [tuple(np.asarray(t) for t in o) for o in outs]
        pf = JaxPipelinedForward(jmodels["raft"], variables["raft"], segments=world)
        outs = pf.forward_many([(jnp.asarray(a), jnp.asarray(b)) for a, b in pairs],
                               child.ITERS, early_exit_tol=child.EARLY_EXIT_TOL)
        refs[(world, "early_exit")] = [tuple(np.asarray(t) for t in o) for o in outs]
    return refs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world's ranks' outputs, after one run of the child in each
    rank; the JAX references and the one-process runs are computed here
    while the ranks run."""
    jmodels, variables = {}, {}
    for variant in child.MODELS:
        jmodels[variant], variables[variant] = _variables(variant)
    pairs = _pairs()
    works, procs = {}, {}
    for world in WORLDS:
        works[world] = tmp_path_factory.mktemp(f"pipe{world}")
        torch.save({"pairs": pairs, "variables": variables}, works[world] / "inputs.pt")
        procs[world] = _start(world, works[world])
    logs = []
    try:
        refs = _jax_refs(pairs, jmodels, variables)
        refs["serve"] = serve_entry.run(child.SERVE_ARGV)
        refs["evaluate"] = child.entry_json(eval_entry.main, child.EVAL_ARGV)
        for world in WORLDS:
            for p in procs[world]:
                out, _ = p.communicate(timeout=SPAWN_TIMEOUT_S)
                logs.append(out)
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    assert all(p.returncode == 0 for ps in procs.values() for p in ps), "\n".join(logs)
    ranks = {world: [torch.load(works[world] / f"rank{r}.pt", weights_only=False)
                     for r in range(world)] for world in WORLDS}
    return {"ranks": ranks, "refs": refs, "pairs": pairs, "variables": variables}


def _one_process(variant, variables, prec, pairs, **kw):
    m = child.model(variant, variables[variant]).with_policy(prec)
    return [m(torch.from_numpy(a), torch.from_numpy(b), iters=child.ITERS, **kw)
            for a, b in pairs]


def _epe(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b), axis=-1).mean())


# ---------------------------------------------------------------- the mesh


@pytest.mark.parametrize("S", WORLDS)
def test_rank_layout_and_fingerprint_are_jaxs(S):
    """Rank r of the (1, 1, S) mesh is pipe index r, where JAX's
    make_mesh(1, 1, S) puts device r; the fingerprint is JAX's."""
    jmesh = jax_make_mesh(data=1, spatial=1, pipe=S, devices=jax.devices()[:S])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r in range(S):
        m = mesh_mod.Mesh(data=1, rank=r, platform="cpu", pipe=S)
        assert tuple(int(v) for v in np.argwhere(ids == r)[0]) == (
            m.data_index, m.spatial_index, m.pipe_index) == (0, 0, r)
        assert m.processes == S and m.shape == dict(jmesh.shape)
    assert mesh_mod.mesh_fingerprint(mesh_mod.Mesh(1, 0, "cpu", pipe=S)) == \
        jax_mesh_fingerprint(jmesh) == f"mesh(data=1,spatial=1,pipe={S}:cpu)"
    # pipe=1 keeps the two-axis identity, as JAX's does.
    assert mesh_mod.mesh_fingerprint(mesh_mod.Mesh(1, 0, "cpu", pipe=1)) == \
        "mesh(data=1,spatial=1:cpu)"


def test_mixed_pipe_meshes_raise_for_the_served_paths():
    # The served and evaluated paths take a pipe axis beside a data or
    # spatial axis (JAX replicates the (data, spatial) work over pipe):
    # such a mesh passes the world rule when its sizes make the world, and
    # what still raises is a world of the wrong size, the train and highres
    # entries and the pipelined forward (JAX's v1 rule).
    assert mesh_mod.check_axes(1, 1, 2, world=2) == 1
    assert mesh_mod.check_axes(None, 1, 4, world=4) == 1
    assert mesh_mod.check_axes(1, 2, 2, world=4) == 1
    assert mesh_mod.check_axes(None, 1, 2, world=4) == 2
    for data, spatial in ((2, 1), (1, 2)):
        with pytest.raises(ValueError, match="times pipe size 2 must equal the world size 2"):
            mesh_mod.check_axes(data, spatial, 2, world=2)
        m = mesh_mod.Mesh(data, 0, "cpu", spatial=spatial, pipe=2)
        with pytest.raises(ValueError, match="the pipelined forward's v1 rule"):
            PipelinedForward(RAFT(child.model_cfg("raft"), device="cpu"), mesh=m)
    for entry in ("train", "highres"):
        with pytest.raises(ValueError, match=f"the {entry} entry has no pipe axis"):
            mesh_mod.check_no_pipe(2, entry)


@pytest.mark.parametrize("S", WORLDS)
def test_the_worlds_are_pipe_meshes(worlds, S):
    for r, rank in enumerate(worlds["ranks"][S]):
        assert rank["fingerprint"] == f"mesh(data=1,spatial=1,pipe={S}:cpu)"
        assert rank["backend"] == "gloo" and rank["layout"] == (0, 0, r)
        assert rank["barrier"]


# ------------------------------------------------------------------ parity


@pytest.mark.parametrize("S,variant,prec", [
    (S, v, p) for S in WORLDS for v, p in child.CASES[S]])
def test_stream_matches_jax_and_one_process(worlds, S, variant, prec):
    ref = worlds["refs"][(S, variant, prec)]
    mono = _one_process(variant, worlds["variables"], prec, worlds["pairs"])
    for rank in worlds["ranks"][S]:
        outs = rank["cases"][(variant, prec)]["outs"]
        assert len(outs) == len(ref) == child.PAIRS
        for (lr, up), (jlr, jup), (mlr, mup) in zip(outs, ref, mono):
            assert lr.dtype == up.dtype == torch.float32
            assert up.shape == (1, *child.HW, 2)
            torch.testing.assert_close(lr, mlr, atol=ONE_PROCESS_TOL, rtol=0)
            torch.testing.assert_close(up, mup, atol=ONE_PROCESS_TOL, rtol=0)
            if prec == "f32":
                np.testing.assert_allclose(lr.numpy(), jlr, atol=LR_ATOL, rtol=RTOL)
                np.testing.assert_allclose(up.numpy(), jup, atol=UP_ATOL, rtol=RTOL)
        if prec != "f32":
            jf32 = worlds["refs"][(S, variant, "f32")]
            for (lr, up), (_, jup), (_, j32up) in zip(outs, ref, jf32):
                port_vs_jax = _epe(up.numpy(), jup)
                bf16_vs_f32 = _epe(jup, j32up)
                assert port_vs_jax <= bf16_vs_f32
                assert max(port_vs_jax, bf16_vs_f32) <= precision.FORWARD_EPE_BUDGET


@pytest.mark.parametrize("S", (1,) + WORLDS)
def test_early_exit_quantizes_to_segment_boundaries(worlds, S):
    """exec_pipe == ceil(exec_mono / seg_len) * seg_len, JAX's rule and
    JAX's pipelined count; the flows equal JAX's. S = 1 is the monolithic
    early exit itself."""
    mono = _one_process("raft", worlds["variables"], "f32", worlds["pairs"],
                        early_exit_tol=child.EARLY_EXIT_TOL, return_exec_iters=True)
    if S == 1:
        m = child.model("raft", worlds["variables"]["raft"])
        outs = PipelinedForward(m, segments=1).forward_many(
            worlds["pairs"], child.ITERS, early_exit_tol=child.EARLY_EXIT_TOL)
        for (lr, up, ex), (mlr, mup, mex) in zip(outs, mono):
            assert torch.equal(ex, mex) and torch.equal(up, mup) and torch.equal(lr, mlr)
        return
    seg_len = child.ITERS // S
    ref = worlds["refs"][(S, "early_exit")]
    execs = [int(x[2][0]) for x in mono]
    assert len(set(execs)) > 1 or execs[0] < child.ITERS, \
        f"the tolerance must stop a row early for this check to bite: {execs}"
    for rank in worlds["ranks"][S]:
        outs = rank["cases"]["early_exit"]["outs"]
        for (lr, up, ex), (jlr, jup, jex), mex in zip(outs, ref, execs):
            assert ex.tolist() == [math.ceil(mex / seg_len) * seg_len] == np.asarray(
                jex).tolist()
            np.testing.assert_allclose(lr.numpy(), jlr, atol=LR_ATOL, rtol=RTOL)
            np.testing.assert_allclose(up.numpy(), jup, atol=UP_ATOL, rtol=RTOL)


def test_s1_is_exactly_the_monolithic_path(worlds):
    m = child.model("raft", worlds["variables"]["raft"])
    pf = PipelinedForward(m, segments=1)
    assert not pf.is_pipelined and pf.mesh is None
    outs = pf.forward_many(worlds["pairs"], child.ITERS)
    ref = ShapeCachedForward(m)
    for (lr, up), (a, b) in zip(outs, worlds["pairs"]):
        rlr, rup = ref.forward(a, b, child.ITERS)
        assert torch.equal(lr, rlr) and torch.equal(up, rup)
    keys = list(pf.cache._entries)
    assert keys and all("pipe" not in str(k) for k in keys)
    assert keys[0][0] == "nomesh"


def test_constructor_rejects_mismatch_mixed_mesh_and_unsplittable_iters(monkeypatch):
    m = RAFT(child.model_cfg("raft"), device="cpu", seed=1)
    with pytest.raises(ValueError, match="disagrees with mesh"):
        PipelinedForward(m, mesh=mesh_mod.Mesh(1, 0, "cpu", pipe=2), segments=4)
    with pytest.raises(ValueError, match="data/spatial sizes of 1"):
        PipelinedForward(m, mesh=mesh_mod.Mesh(2, 0, "cpu", pipe=2))
    with pytest.raises(ValueError, match="data/spatial sizes of 1"):
        PipelinedForward(m, mesh=mesh_mod.Mesh(1, 0, "cpu", spatial=2, pipe=2))
    # The budget is checked before any work (no world needed to see it).
    monkeypatch.setattr(mesh_mod, "pipe_group", lambda mesh: None)
    pf = PipelinedForward(m, mesh=mesh_mod.Mesh(1, 0, "cpu", pipe=2))
    with pytest.raises(ValueError, match="does not split"):
        pf.forward_many(_pairs()[:1], 5)
    assert pf.cache.stats["compiles"] == 0 and pf.stats["segments"] == 0


# ---------------------------------------------------------------- schedule


def _carry_bytes(variant, prec, ee=False):
    m = RAFT(child.model_cfg(variant), device="cpu").with_policy(prec)
    specs = PipelinedForward(m)._carry_specs(m, (1, *child.HW, 3), ee)
    return sum(int(np.prod(s)) * torch.empty((), dtype=d).element_size() for s, d in specs)


@pytest.mark.parametrize("S", WORLDS)
def test_launches_and_handoffs_follow_the_schedule(worlds, S):
    M, seg_len = child.PAIRS, child.ITERS // S
    permutes = 0
    for r, rank in enumerate(worlds["ranks"][S]):
        for (variant, prec) in child.CASES[S]:
            got = rank["cases"][(variant, prec)]
            last = r == S - 1
            assert got["calls"] == {"corr_lookup": M * seg_len,
                                    "nconv": 4 * M if last and variant == "raft_nc_dbl"
                                    else 0}
            st = got["stats"]
            assert (st["encodes"], st["segments"], st["finalizes"]) == (
                M if r == 0 else 0, M, M if last else 0)
            cp = got["collectives"]["by_op"]["collective-permute"]
            assert cp == {"count": 0 if last else M,
                          "bytes": 0 if last else M * _carry_bytes(variant, prec)}
            assert got["collectives"]["collectives"] == cp["count"]
            assert got["outputs"]["broadcasts"] == M and st["outputs"] == M
            if (variant, prec) == ("raft", "f32"):
                permutes += cp["count"]
        ee = rank["cases"]["early_exit"]["collectives"]["by_op"]["collective-permute"]
        assert ee["bytes"] == (0 if r == S - 1 else M * _carry_bytes("raft", "f32", True))
    assert permutes == (S - 1) * M


@pytest.mark.parametrize("S", WORLDS)
def test_second_stream_is_guard_clean_and_reuses_the_buffers(worlds, S):
    for rank in worlds["ranks"][S]:
        st = rank["cases"]["steady"]
        assert (st["recompiles"], st["host_transfers"], st["compiles"]) == (0, 0, 0)
        assert st["hits"] > 0 and st["same_buffers"]


@pytest.mark.parametrize("S", WORLDS)
def test_stage_programs_land_in_the_ledger_with_jaxs_meta(worlds, S):
    shape = (1, *child.HW, 3)
    for r, rank in enumerate(worlds["ranks"][S]):
        led = rank["cases"]["ledger"]
        seg = led["segment"]
        assert seg["meta"] == {"kind": "pipe_segment", "shape": shape, "iters": child.ITERS,
                               "segments": S, "policy": "f32"}
        assert seg["flops"] > 0 and seg["flops_per_segment"] == seg["flops"]
        assert seg["flops_per_tick"] == S * seg["flops"]
        assert (led["encode"] is not None) == (r == 0)
        assert (led["finalize"] is not None) == (r == S - 1)
        if r == 0:
            assert led["encode"]["meta"] == {"kind": "pipe_encode", "shape": shape,
                                             "policy": "f32"}
        for key in rank["cases"]["keys"]:
            assert key.startswith(f"('mesh(data=1,spatial=1,pipe={S}:cpu)', 'custom', 'pipe_")


def test_ledger_meta_parse_and_segment_split():
    meta = pipeline_mod._ledger_meta(("custom", "pipe_segment", (1, 32, 32, 3), 8, 4, "f32"))
    assert meta == {"kind": "pipe_segment", "shape": (1, 32, 32, 3), "iters": 8,
                    "segments": 4, "policy": "f32"}
    meta = pipeline_mod._ledger_meta(("custom", "pipe_finalize", (1, 32, 32, 3), 8, 4, "f32",
                                      ("earlyexit", 0.05)))
    assert meta["kind"] == "pipe_finalize" and meta["earlyexit_tol"] == 0.05
    assert pipeline_mod._ledger_meta(("custom", "pipe_encode", (1, 32, 32, 3), "f32")) == {
        "kind": "pipe_encode", "shape": (1, 32, 32, 3), "policy": "f32"}
    assert pipeline_mod._ledger_meta(("custom", "stream", 2))["kind"] == "custom"
    ledger = CostLedger()
    flops = {"total": 120.0, "aten": 100.0, "corr_lookup": 20.0, "nconv": 0.0}
    entry = ledger.record("k", flops=flops, capture_ms=1.0, pool_bytes=0, backend="cpu",
                          kind="pipe_segment", segments=4)
    assert entry["flops_per_segment"] == 120.0 and entry["flops_per_tick"] == 480.0
    assert entry["bytes_per_segment"] is None
    entry = ledger.record("k2", flops=flops, capture_ms=1.0, pool_bytes=0, backend="cpu",
                          kind="forward")
    assert "flops_per_segment" not in entry
    assert ledger.lookup(kind="pipe_segment", segments=4)["key"] == "k"


# ------------------------------------------------------------------ entries


def test_serve_entry_over_a_pipe_mesh_answers_as_one_process(worlds):
    rc, report, responses, _ = worlds["refs"]["serve"]
    want = [r.flow for r in responses if r.flow is not None]
    lead, follow = (rank["entries"] for rank in worlds["ranks"][2])
    assert lead["serve"]["rc"] == rc == 0 and follow["serve"]["rc"] == 0
    assert lead["serve"]["mesh"] == "mesh(data=1,spatial=1,pipe=2:cpu)"
    assert lead["serve"]["completed"] == report["completed"] == 4
    assert len(lead["serve"]["flows"]) == len(want) == 4
    for got, ref in zip(lead["serve"]["flows"], want):
        np.testing.assert_allclose(got, ref, atol=ONE_PROCESS_TOL, rtol=0)


def test_serve_refuses_levels_off_the_segment_boundaries_at_construction(worlds):
    with pytest.raises(ValueError) as jax_error:
        JaxBudget((3, 1), capacity=16, segments=2)
    for rank in worlds["ranks"][2]:
        assert rank["entries"]["bad_levels"] == str(jax_error.value)


def test_evaluate_entry_over_a_pipe_mesh_equals_one_process(worlds):
    rc, ref = worlds["refs"]["evaluate"]
    for r, rank in enumerate(worlds["ranks"][2]):
        code, got = rank["entries"]["evaluate"]
        assert code == rc == 0
        assert got["mesh"] == "mesh(data=1,spatial=1,pipe=2:cpu)" and got["rank"] == r
        assert got["results"] == pytest.approx(ref["results"], rel=1e-6)
