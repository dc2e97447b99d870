"""A pipe axis beside a data or spatial axis (``parallel/mesh.py``): the
served and evaluated paths over the meshes ``(1, 2, 2)`` and ``(2, 1, 2)``
of processes, against the JAX package's ``make_mesh`` counterparts, on
the CPU.

JAX replicates the ``(data, spatial)`` program over ``pipe``, an axis
that shards nothing; the port runs that forward on each pipe index's own
ranks ``(d * S + s) * P + p``, rank 0 of the world leading. One four-rank
gloo world for the module (``tests/_torch_mixed_mesh_child.py``, each rank
in its own interpreter with one torch thread) runs both meshes while the
references are computed here. Both sides hold the port's seeded weights
(carried into JAX by ``import_torch_state``, read back by
``load_jax_variables``), small ``raft`` and small ``raft_nc_dbl`` at 64x96
(the spatial pair's bands hold 4 rows at 1/8 resolution), 4 iterations, a
batch of 2.

- The server's flows (both models), the stream engine's (the flagship,
  two warm-chained frames) on every rank against JAX's ``FlowServer`` and
  ``StreamEngine`` on ``make_mesh(1, 2, 2)`` / ``make_mesh(2, 1, 2)`` over
  the CPU's virtual devices at the flagship tolerances (flow_lr atol
  2e-3, flow_up atol 5e-3, rtol 1e-3; the stream's answers are flow_up),
  and against the port's one-process server and engine within
  ``ONE_PROCESS``; the two pipe indices of a ``(data, spatial)``
  place compute equal bits.
- Early exit at three tolerances: every rank's executed iterations equal
  one process's, and its flows are within ``ONE_PROCESS`` of one
  process's.
- The evaluate entry over each mesh: every rank's metric sums equal one
  process's (rtol 1e-6), not twice them, and so do its metrics.
- The serve entry over ``--mesh 1,2,2`` answers as one process does
  (atol 1e-4, ``tests/test_torch_spatial_serving.py``'s for its entry:
  its seeded frames moved by 1.4e-5 once split into bands).
- The rank layout, the groups and the fingerprint are JAX's
  ``make_mesh``'s; each pipe index's halo exchanges go to ``rank - P``
  and ``rank + P``, and its gathers stay among its own ranks.

``ONE_PROCESS`` is atol 1e-5 and rtol 1e-5: a band's float32 differs from
the whole image's by the rounding of the instance norm's group sums, and
a data index's block of one row from the batch of two by the rounding of
the CPU's batched convolutions.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from raft_ncup_tpu.config import ServeConfig as JaxServeConfig
from raft_ncup_tpu.config import StreamConfig as JaxStreamConfig
from raft_ncup_tpu.config import small_model_config as jax_small_model_config
from raft_ncup_tpu.models.raft import RAFT as JaxRAFT
from raft_ncup_tpu.parallel.mesh import make_mesh as jax_make_mesh
from raft_ncup_tpu.parallel.mesh import mesh_fingerprint as jax_mesh_fingerprint
from raft_ncup_tpu.serving import FlowServer as JaxFlowServer
from raft_ncup_tpu.streaming import StreamEngine as JaxStreamEngine
from raft_ncup_tpu.utils.torch_import import import_torch_state
from raft_ncup_tpu_torch import evaluate as eval_entry
from raft_ncup_tpu_torch import serve as serve_entry
from raft_ncup_tpu_torch.inference.pipeline import ShapeCachedForward
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.parallel import mesh as mesh_mod
from raft_ncup_tpu_torch.serving import FlowServer
from raft_ncup_tpu_torch.streaming import StreamEngine

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import _torch_mixed_mesh_child as child  # noqa: E402

WORLD = 4
SPAWN_TIMEOUT_S = 240
FLOW_UP_TOL = dict(atol=5e-3, rtol=1e-3)
ONE_PROCESS = dict(atol=1e-5, rtol=1e-5)
ENTRY_ATOL = 1e-4  # tests/test_torch_spatial_serving.py's, for the serve entry
MESH_IDS = [",".join(map(str, m)) for m in child.MESHES]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _variables(variant):
    """The port's seeded weights carried into JAX's variables."""
    seeded = RAFT(child.model_cfg(variant), device="cpu", seed=0)
    jmodel = JaxRAFT(jax_small_model_config(variant, dataset=child.MODELS[variant],
                                            corr_impl="onthefly"))
    template = jax.eval_shape(lambda k: jmodel.init(k, (1, child.H, child.W, 3)),
                              jax.random.key(0))
    variables = import_torch_state({k: v.numpy() for k, v in seeded.state_dict().items()},
                                   template, strict=True)
    return jmodel, jax.tree_util.tree_map(np.asarray, variables)


def _inputs():
    g = np.random.default_rng(19)
    img1 = g.uniform(0, 255, (child.BATCH, child.H, child.W, 3)).astype(np.float32)
    img2 = np.roll(img1, (2, 3), axis=(1, 2)).copy()
    img2[1] = np.roll(img1[1], (-3, 1), axis=(0, 1))
    seq = [g.uniform(0, 255, (child.H, child.W, 3)).astype(np.float32) for _ in range(3)]
    return {"image1": torch.from_numpy(img1), "image2": torch.from_numpy(img2),
            "frames": [(seq[0], seq[1]), (seq[1], seq[2])]}


def _jax_mesh(axes):
    data, spatial, pipe = axes
    return jax_make_mesh(data=data, spatial=spatial, pipe=pipe,
                         devices=jax.devices()[:data * spatial * pipe])


def _port_served(m, pairs):
    with FlowServer(m, child.serve_cfg(None)) as server:
        server.pause()
        handles = [server.submit(a, b) for a, b in pairs]
        server.resume()
        return [h.result(child.WAIT_S).flow for h in handles]


def _references(inputs, jmodels, variables):
    pairs = [(inputs["image1"][k].numpy(), inputs["image2"][k].numpy())
             for k in range(child.BATCH)]
    refs = {}
    for axes in child.MESHES:
        jmesh = _jax_mesh(axes)
        for variant in child.MODELS:
            jcfg = JaxServeConfig(batch_sizes=(child.BATCH,), iter_levels=(child.ITERS,))
            with JaxFlowServer(jmodels[variant], variables[variant], jcfg, mesh=jmesh) as js:
                js.pause()
                handles = [js.submit(a, b) for a, b in pairs]
                js.resume()
                rs = [h.result(timeout=child.WAIT_S) for h in handles]
                assert all(r.ok for r in rs), [r.detail for r in rs]
                refs[(axes, "server", variant)] = [r.flow for r in rs]
                refs[(axes, "jax mesh")] = js.report()["mesh"]
        jeng = JaxStreamEngine(
            jmodels["raft_nc_dbl"], variables["raft_nc_dbl"],
            JaxStreamConfig(capacity=1, frame_hw=(child.H, child.W), iters=child.ITERS,
                            batch_sizes=(child.BATCH,), queue_capacity=8), mesh=jmesh)
        try:
            refs[(axes, "stream")] = [jeng.submit("s", a, b).result(timeout=child.WAIT_S).flow
                                      for a, b in inputs["frames"]]
        finally:
            jeng.drain()
    for variant in child.MODELS:
        refs[("one", "server", variant)] = _port_served(
            child.model(variant, variables[variant]), pairs)
    flagship = child.model("raft_nc_dbl", variables["raft_nc_dbl"])
    engine = StreamEngine(flagship, child.stream_cfg(None))
    try:
        refs[("one", "stream")] = [engine.submit("s", a, b).result(child.WAIT_S).flow
                                   for a, b in inputs["frames"]]
    finally:
        engine.drain()
    fwd = ShapeCachedForward(flagship)
    refs[("one", "early exit")] = {
        tol: fwd.forward(inputs["image1"], inputs["image2"], child.ITERS,
                         early_exit_tol=tol)[2:0:-1] for tol in child.EE_TOLS}
    with child.metric_sums() as sums:
        refs[("one", "evaluate")] = child.entry_json(eval_entry.main, child.EVAL_ARGV)
    refs[("one", "eval_sums")] = sums
    refs[("one", "serve entry")] = serve_entry.run(child.SERVE_ARGV)
    return refs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's outputs, after one run of the child in each; the
    references are computed here while the ranks run."""
    work = tmp_path_factory.mktemp("mixed_mesh")
    jmodels, variables = {}, {}
    for variant in child.MODELS:
        jmodels[variant], variables[variant] = _variables(variant)
    inputs = _inputs()
    torch.save({**inputs, "variables": variables}, work / "inputs.pt")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("RAFT_TORCH_FLIGHT_DIR", None)
    script = os.path.join(HERE, "_torch_mixed_mesh_child.py")
    procs = [subprocess.Popen([sys.executable, script, str(port), str(r), str(WORLD), str(work)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, cwd=str(work))
             for r in range(WORLD)]
    logs = []
    try:
        refs = _references(inputs, jmodels, variables)
        for p in procs:
            out, _ = p.communicate(timeout=SPAWN_TIMEOUT_S)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"ranks": ranks, "refs": refs}


def _replicas(ranks, axes):
    """The ranks of each (data, spatial) place, one per pipe index."""
    P = axes[2]
    return [ranks[g * P:(g + 1) * P] for g in range(len(ranks) // P)]


# ---------------------------------------------------------------- the mesh


@pytest.mark.parametrize("axes", child.MESHES, ids=MESH_IDS)
def test_rank_layout_groups_and_fingerprint_are_jaxs(world, axes):
    """Rank r sits where JAX's make_mesh puts device r; its spatial group
    is its data and pipe index's spatial ranks, its data group its spatial
    and pipe index's data ranks; the fingerprint is JAX's."""
    jmesh = _jax_mesh(axes)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r, rank in enumerate(world["ranks"]):
        got = rank[axes]
        d, s, p = (int(v) for v in np.argwhere(ids == r)[0])
        assert got["layout"] == (d, s, p)
        m = mesh_mod.Mesh(axes[0], r, "cpu", spatial=axes[1], pipe=axes[2])
        assert (m.data_index, m.spatial_index, m.pipe_index) == (d, s, p)
        assert m.shape == dict(jmesh.shape)
        want_spatial = tuple(int(x) for x in ids[d, :, p])
        assert got["spatial_ranks"] == (want_spatial if axes[1] > 1 else None)
        assert got["data_ranks"] == tuple(int(x) for x in ids[:, s, p])
        assert got["fingerprint"] == jax_mesh_fingerprint(jmesh) == \
            world["refs"][(axes, "jax mesh")]
        assert rank["backend"] == "gloo" and rank["barrier"]


@pytest.mark.parametrize("axes", child.MESHES, ids=MESH_IDS)
def test_halo_exchanges_go_to_the_pipe_stride(world, axes):
    """A spatial neighbour is rank - P or rank + P, never a rank of
    another pipe index; a mesh without a spatial axis has no halo."""
    P = axes[2]
    for r, rank in enumerate(world["ranks"]):
        peers = rank[axes]["halo_peers"]
        by_op = rank[axes]["collectives"]["by_op"]
        if axes[1] > 1:
            assert peers == [q for q in (r - P, r + P) if 0 <= q < WORLD]
            assert by_op["collective-permute"]["count"] > 0
        else:
            assert peers == [] and by_op["collective-permute"]["count"] == 0
        assert by_op["all-gather"]["count"] > 0


@pytest.mark.parametrize("axes", child.MESHES, ids=MESH_IDS)
def test_the_leader_broadcasts_each_dispatch_to_every_rank(world, axes):
    """One header and the frames a dispatch, to all four ranks: every rank
    counts the same broadcasts, and the replicas issue equal collectives."""
    ranks = [rank[axes] for rank in world["ranks"]]
    # Per server: the batch's dispatch (a header and two frames), then the
    # stop's header.
    assert all(r["lockstep"] == ranks[0]["lockstep"] for r in ranks)
    assert ranks[0]["lockstep"]["broadcasts"] == 2 * (3 + 1)
    for group in _replicas(ranks, axes):
        assert all(r["collectives"] == group[0]["collectives"] for r in group)


# ------------------------------------------------------------------ parity


@pytest.mark.parametrize("axes,variant", [(a, v) for a in child.MESHES for v in child.MODELS],
                         ids=[f"{m}-{v}" for m in MESH_IDS for v in child.MODELS])
def test_server_matches_jax_and_one_process(world, axes, variant):
    refs = world["refs"]
    ranks = [rank[axes][f"server {variant}"] for rank in world["ranks"]]
    lead = ranks[0]
    assert lead["status"] == ["ok"] * child.BATCH
    assert all(r["rc"] == 0 for r in ranks[1:])
    assert lead["report"]["mesh"] == refs[(axes, "jax mesh")]
    for k, flow in enumerate(lead["flows"]):
        assert flow.shape == (child.H, child.W, 2)
        np.testing.assert_allclose(flow, refs[(axes, "server", variant)][k], **FLOW_UP_TOL)
        np.testing.assert_allclose(flow, refs[("one", "server", variant)][k],
                                   **ONE_PROCESS)
    one = np.stack(refs[("one", "server", variant)])
    for r in ranks:  # what every rank computed: the whole batch, gathered
        np.testing.assert_allclose(r["computed"].numpy(), one, **ONE_PROCESS)
    for group in _replicas(ranks, axes):
        assert all(torch.equal(r["computed"], group[0]["computed"]) for r in group)


@pytest.mark.parametrize("axes", child.MESHES, ids=MESH_IDS)
def test_stream_engine_matches_jax_and_one_process(world, axes):
    refs = world["refs"]
    ranks = [rank[axes]["stream"] for rank in world["ranks"]]
    lead = ranks[0]
    assert lead["status"] == ["ok", "ok"] and all(r["rc"] == 0 for r in ranks[1:])
    assert lead["report"]["mesh"] == refs[(axes, "jax mesh")]
    for k, got in enumerate(lead["flows"]):  # k=1 is the warm-started frame
        np.testing.assert_allclose(got, refs[(axes, "stream")][k], **FLOW_UP_TOL,
                                   err_msg=f"frame {k}")
        np.testing.assert_allclose(got, refs[("one", "stream")][k], **ONE_PROCESS,
                                   err_msg=f"frame {k}")
    for r in ranks:  # row 0 of each step is the stream's, row 1 a pad row
        for k, step in enumerate(r["computed"]):
            np.testing.assert_allclose(step[0].numpy(), refs[("one", "stream")][k],
                                       **ONE_PROCESS)
    for group in _replicas(ranks, axes):
        for r in group:
            assert all(torch.equal(a, b) for a, b in zip(r["computed"], group[0]["computed"]))


@pytest.mark.parametrize("axes,tol", [(a, t) for a in child.MESHES for t in child.EE_TOLS],
                         ids=[f"{m}-{t}" for m in MESH_IDS for t in child.EE_TOLS])
def test_early_exit_runs_the_iterations_of_one_process(world, axes, tol):
    ex1, up1 = world["refs"][("one", "early exit")][tol]
    for rank in world["ranks"]:
        ex, up = rank[axes]["early exit"][tol]
        assert torch.equal(ex, ex1), (ex, ex1)
        torch.testing.assert_close(up, up1, **ONE_PROCESS)


@pytest.mark.parametrize("axes", child.MESHES, ids=MESH_IDS)
def test_evaluation_sums_count_each_frame_once(world, axes):
    """Each pipe index sums over its own data group: every rank holds the
    one-process sums (its frame count among them), not twice them."""
    code1, rep1 = world["refs"][("one", "evaluate")]
    (want,) = world["refs"][("one", "eval_sums")]
    for r, rank in enumerate(world["ranks"]):
        code, rep = rank[axes]["evaluate"]
        (got,) = rank[axes]["eval_sums"]
        assert code == code1 == 0
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        assert rep["mesh"] == world["refs"][(axes, "jax mesh")] and rep["rank"] == r
        assert rep["results"] == pytest.approx(rep1["results"], rel=1e-5)


# ------------------------------------------------------------------ entries


def test_serve_entry_over_a_mixed_mesh_answers_as_one_process(world):
    rc, report, responses, _ = world["refs"][("one", "serve entry")]
    want = [r.flow for r in responses if r.flow is not None]
    lead, *follow = (rank["serve entry"] for rank in world["ranks"])
    assert lead["rc"] == rc == 0 and all(f["rc"] == 0 for f in follow)
    assert lead["mesh"] == "mesh(data=1,spatial=2,pipe=2:cpu)"
    assert lead["completed"] == report["completed"] == 4
    assert len(lead["flows"]) == len(want) == 4
    for got, ref in zip(lead["flows"], want):
        np.testing.assert_allclose(got, ref, atol=ENTRY_ATOL, rtol=0)
