"""The served paths over a mesh of processes (``parallel/lockstep.py``):
the server, the stream engine, early exit, the serve entry's ``--mesh``
and a fleet slot of two ranks, on the CPU.

One two-rank gloo world for the module
(``tests/_torch_spatial_serving_child.py``, each rank in its own
interpreter with its own timeout), rank 0 leading and rank 1 following:

- one request through ``FlowServer`` with ``ServeConfig(mesh=(1, 2))``,
  for the small ``raft_nc_dbl`` and the small ``raft`` at 64x96, 2
  iterations, from carried JAX weights, against JAX's ``FlowServer`` on
  ``make_mesh(1, 2)`` at the flagship's tolerances (flow_lr atol 2e-3,
  flow_up atol 5e-3, rtol 1e-3) and against the port's one-process
  server at atol 1e-4; the leader's report names the mesh, and the
  follower returns the leader's exit code;
- a batch of 2 under ``mesh=(2, 1)`` (one row a data index) against one
  process;
- two warm-chained frames through ``StreamEngine`` with
  ``StreamConfig(mesh=(1, 2))`` against JAX's engine on the mesh and the
  port's one-process engine, both frames; no implicit host read and no
  capture after the warm-up;
- early exit under ``(1, 2)``: both ranks' executed iterations equal one
  process's, through the cache and the model;
- the flagship with the U-Net weights net at 80x96, whose bands pool to an
  odd row, against one process.

Without a world: the configurations' mesh rules (JAX's cases); the serve
entry with ``--mesh 1,2`` as two rank processes (exit 0 and one report
line, from the leader; ``sigterm`` to the leader ends both with 75); the
fleet's replica argv and pad divisors against JAX's; a supervised (1, 2)
slot answering a router request as the in-process server does, and no
rank process left after ``stop()``.
"""

import json
import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from raft_ncup_tpu.config import ServeConfig as JaxServeConfig
from raft_ncup_tpu.config import StreamConfig as JaxStreamConfig
from raft_ncup_tpu.config import small_model_config as jax_small_model_config
from raft_ncup_tpu.fleet.topology import FleetConfig as JaxFleetConfig
from raft_ncup_tpu.models.raft import RAFT as JaxRAFT
from raft_ncup_tpu.parallel import make_mesh as jax_make_mesh
from raft_ncup_tpu.serving import FlowServer as JaxFlowServer
from raft_ncup_tpu.streaming import StreamEngine as JaxStreamEngine
from raft_ncup_tpu.utils.torch_import import import_torch_state
from raft_ncup_tpu_torch import serve as serve_mod
from raft_ncup_tpu_torch.cli import model_config_from_args, serve_config_from_args
from raft_ncup_tpu_torch.config import ServeConfig, StreamConfig
from raft_ncup_tpu_torch.fleet import FleetConfig, FleetRouter, ReplicaSupervisor, read_healthz
from raft_ncup_tpu_torch.fleet.replica import RankGroup
from raft_ncup_tpu_torch.inference.pipeline import ShapeCachedForward
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.observability import Telemetry
from raft_ncup_tpu_torch.serving import FlowServer
from raft_ncup_tpu_torch.streaming import StreamEngine

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import _torch_spatial_serving_child as child  # noqa: E402

WORLD = 2
SPAWN_TIMEOUT_S = 240
FLOW_LR_TOL = dict(atol=2e-3, rtol=1e-3)
FLOW_UP_TOL = dict(atol=5e-3, rtol=1e-3)
SELF_ATOL = 1e-4
MESH_12 = "mesh(data=1,spatial=2:cpu)"
ENTRY_ARGV = ["--device", "cpu", "--small", "--model", "raft_nc_dbl", "--size", "64", "96",
              "--iter_levels", "2", "--serve_batch_sizes", "1", "--flight_dir", "",
              "--interval_ms", "100"]


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


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **extra)
    env.pop("RAFT_TORCH_FLIGHT_DIR", None)
    return env


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
    g = np.random.default_rng(31)
    img1 = g.uniform(0, 255, (2, child.H, child.W, 3)).astype(np.float32)
    img2 = np.roll(img1, (2, 3), axis=(1, 2)).copy()
    img2[1] = np.roll(img1[1], (-3, 1), axis=(0, 1))
    seq = [g.uniform(0, 255, (child.H, child.W, 3)).astype(np.float32) for _ in range(3)]
    u1 = g.uniform(0, 255, (1, *child.UNET_HW, 3)).astype(np.float32)
    return {"image1": torch.from_numpy(img1), "image2": torch.from_numpy(img2),
            "frames": [(seq[0], seq[1]), (seq[1], seq[2])],
            "unet1": torch.from_numpy(u1),
            "unet2": torch.from_numpy(np.roll(u1, (1, 2), axis=(1, 2)).copy())}


def _port_served(m, cfg, pairs):
    with FlowServer(m, cfg) as server:
        server.pause()
        handles = [server.submit(a, b) for a, b in pairs]
        server.resume()
        return [h.result(child.WAIT_S).flow for h in handles]


def _port_streamed(m, frames):
    engine = StreamEngine(m, child.stream_cfg(None))
    try:
        return [engine.submit("s", a, b).result(child.WAIT_S).flow for a, b in frames]
    finally:
        engine.drain()


def _references(inputs, jmodels, variables):
    jax_mesh = jax_make_mesh(data=1, spatial=2, devices=jax.devices()[:2])
    a, b = inputs["image1"][0].numpy(), inputs["image2"][0].numpy()
    refs = {}
    for variant in child.MODELS:
        jcfg = JaxServeConfig(batch_sizes=(1,), iter_levels=(child.ITERS,))
        with JaxFlowServer(jmodels[variant], variables[variant], jcfg, mesh=jax_mesh) as js:
            r = js.submit(a, b).result(timeout=child.WAIT_S)
            assert r.ok, r.detail
            jax_flow, jax_mesh_fp = r.flow, js.report()["mesh"]
        m = child.model(variant, variables[variant])
        (one,) = _port_served(m, child.serve_cfg(None), [(a, b)])
        refs[variant] = {"jax": jax_flow, "jax_mesh": jax_mesh_fp, "port": one}
    flagship = child.model("raft_nc_dbl", variables["raft_nc_dbl"])
    two = [(inputs["image1"][k].numpy(), inputs["image2"][k].numpy()) for k in range(2)]
    refs["batch of 2"] = _port_served(flagship, child.serve_cfg(None, batch=2), two)
    jeng = JaxStreamEngine(jmodels["raft_nc_dbl"], variables["raft_nc_dbl"],
                           JaxStreamConfig(capacity=1, frame_hw=(child.H, child.W),
                                           iters=child.ITERS, batch_sizes=(1,),
                                           queue_capacity=8), mesh=jax_mesh)
    try:
        refs["stream jax"] = [jeng.submit("s", x, y).result(timeout=child.WAIT_S).flow
                              for x, y in inputs["frames"]]
    finally:
        jeng.drain()
    refs["stream port"] = _port_streamed(flagship, inputs["frames"])
    fwd = ShapeCachedForward(flagship)
    refs["early exit"] = {tol: fwd.forward(inputs["image1"], inputs["image2"], child.EE_ITERS,
                                           early_exit_tol=tol)[2] for tol in child.EE_TOLS}
    refs["unet"] = child.unet_model()(inputs["unet1"], inputs["unet2"], iters=child.ITERS)
    return refs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both ranks' outputs, after one run of the child in each; the
    references are computed here while the ranks run."""
    work = tmp_path_factory.mktemp("spatial_serving")
    jmodels, variables = {}, {}
    for variant in child.MODELS:
        jmodels[variant], variables[variant] = _variables(variant)
    inputs = _inputs()
    torch.save({**inputs, "variables": variables}, work / "inputs.pt")
    port = _free_port()
    script = os.path.join(HERE, "_torch_spatial_serving_child.py")
    procs = [subprocess.Popen([sys.executable, script, str(port), str(r), str(WORLD), str(work)],
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
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
    out = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"ranks": out, "refs": refs}


# --------------------------------------------------------- two ranks


@pytest.mark.parametrize("variant", list(child.MODELS))
def test_server_on_a_spatial_mesh_matches_jax_and_one_process(world, variant):
    ref = world["refs"][variant]
    lead, follow = (r[f"server {variant}"] for r in world["ranks"])
    assert lead["status"] == ["ok"] and follow == {"rc": 0}
    (flow,) = lead["flows"]
    assert flow.shape == (child.H, child.W, 2) == ref["jax"].shape
    np.testing.assert_allclose(flow, ref["jax"], **FLOW_UP_TOL)
    np.testing.assert_allclose(flow, ref["port"], atol=SELF_ATOL, rtol=0)
    assert lead["report"]["mesh"] == ref["jax_mesh"] == MESH_12


def test_the_leader_broadcasts_and_both_ranks_exchange_halos(world):
    lead, follow = world["ranks"]
    # Per server: the request's dispatch (a header and two frames), then the
    # stop's header.
    assert lead["lockstep"] == follow["lockstep"]
    assert lead["lockstep"]["broadcasts"] == 2 * (3 + 1)
    for rank in world["ranks"]:
        by_op = rank["collectives"]["by_op"]
        assert by_op["collective-permute"]["count"] > 0 and by_op["all-gather"]["count"] > 0
    assert lead["collectives"] == follow["collectives"]


def test_server_on_a_data_mesh_splits_the_batch(world):
    lead, follow = (r["server (2, 1)"] for r in world["ranks"])
    assert lead["status"] == ["ok", "ok"] and follow == {"rc": 0}
    assert lead["report"]["mesh"] == "mesh(data=2,spatial=1:cpu)"
    for got, want in zip(lead["flows"], world["refs"]["batch of 2"]):
        np.testing.assert_allclose(got, want, atol=SELF_ATOL, rtol=0)
    # The outputs' all-gather over the data axis, no halo.
    for rank in world["ranks"]:
        by_op = rank["data collectives"]["by_op"]
        assert by_op["all-gather"]["count"] > 0 and by_op["collective-permute"]["count"] == 0


def test_stream_engine_on_a_spatial_mesh_matches_jax_and_one_process(world):
    lead, follow = (r["stream"] for r in world["ranks"])
    assert lead["status"] == ["ok", "ok"] and follow == {"rc": 0}
    for k, got in enumerate(lead["flows"]):  # k=1 is the warm-started frame
        np.testing.assert_allclose(got, world["refs"]["stream jax"][k], **FLOW_UP_TOL,
                                   err_msg=f"frame {k}")
        np.testing.assert_allclose(got, world["refs"]["stream port"][k], atol=SELF_ATOL,
                                   rtol=0, err_msg=f"frame {k}")
    assert lead["report"]["mesh"] == MESH_12


def test_stream_engine_on_a_mesh_is_guard_clean_after_warmup(world):
    lead = world["ranks"][0]["stream"]
    assert lead["recompiles"] == 0 and lead["host_transfers"] == 0
    assert lead["report"]["executables"]["compiles"] == 1


@pytest.mark.parametrize("tol", child.EE_TOLS)
def test_early_exit_on_a_spatial_mesh_runs_the_iterations_of_one_process(world, tol):
    want = world["refs"]["early exit"][tol]
    got = [r["early exit"][tol] for r in world["ranks"]]
    for rank in got:
        for path in ("cache", "model"):
            ex, up = rank[path]
            assert torch.equal(ex, want), (path, ex, want)
        torch.testing.assert_close(rank["cache"][1], rank["model"][1], atol=SELF_ATOL, rtol=0)
    assert torch.equal(got[0]["cache"][1], got[1]["cache"][1])
    assert got[0]["last"] == got[1]["last"]


def test_unet_weights_net_on_bands_that_pool_to_an_odd_row(world):
    lr1, up1 = world["refs"]["unet"]
    for rank in world["ranks"]:
        lr, up = rank["unet"]
        torch.testing.assert_close(lr, lr1, atol=SELF_ATOL, rtol=0)
        torch.testing.assert_close(up, up1, atol=SELF_ATOL, rtol=0)


# ------------------------------------------------------ configuration


def test_config_rejects_batch_not_divisible_by_data_axis():
    with pytest.raises(ValueError, match="not divisible by mesh"):
        ServeConfig(batch_sizes=(1, 2), mesh=(2, 1))
    with pytest.raises(ValueError, match="not divisible by mesh"):
        StreamConfig(batch_sizes=(1, 2, 4), mesh=(4, 2))
    assert ServeConfig(mesh=(1, 2)).mesh == (1, 2)


def test_config_rejects_pad_bucket_off_the_mesh_divisor():
    with pytest.raises(ValueError, match="pad divisor 8\\*spatial"):
        ServeConfig(mesh=(1, 3), pad_bucket=64)
    with pytest.raises(ValueError, match="pad divisor 8\\*spatial"):
        StreamConfig(mesh=(1, 3), pad_bucket=64)
    assert ServeConfig(mesh=(1, 2), pad_bucket=32).pad_bucket == 32


@pytest.mark.parametrize("mesh", [(0, 1), (1,), (1, 2, 3, 4)])
def test_config_rejects_a_malformed_mesh(mesh):
    with pytest.raises(ValueError, match="positive sizes"):
        ServeConfig(mesh=mesh)


def test_a_pipe_axis_still_refuses():
    # A pipe axis is the server's beside a data or spatial axis too
    # (tests/test_torch_mixed_mesh.py serves (1, 2, 2) and (2, 1, 2) over
    # four ranks): the configurations take the triple, and only a world
    # of the wrong size refuses it, by the world rule.
    model = RAFT(child.model_cfg("raft"), device="cpu")
    for mesh in ((1, 2, 2), (2, 1, 2), (1, 1, 2)):
        assert ServeConfig(mesh=mesh, batch_sizes=(2,)).mesh == mesh
        assert StreamConfig(mesh=mesh, batch_sizes=(2,)).mesh == mesh
        with pytest.raises(ValueError, match="times pipe size 2 must equal the world size 1"):
            FlowServer(model, ServeConfig(mesh=mesh, batch_sizes=(2,)))
        with pytest.raises(ValueError, match="times pipe size 2 must equal the world size 1"):
            StreamEngine(model, StreamConfig(mesh=mesh, batch_sizes=(2,)))


# ------------------------------------------------------- the serve entry


def _ranks(argv, world=WORLD, timeout=SPAWN_TIMEOUT_S):
    """The serve entry as ``world`` rank processes with the launcher's
    environment: each one's exit code, stdout and stderr."""
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-m", "raft_ncup_tpu_torch.serve", *argv],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True,
                              env=_env(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)))
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


@pytest.fixture(scope="module")
def entry_runs():
    """The plain branch (3 requests) and one with ``sigterm@2`` to the
    leader, each as two ranks on the mesh (1, 2), both at once."""
    runs = {}

    def run(name, extra):
        runs[name] = _ranks(ENTRY_ARGV + ["--mesh", "1,2", *extra])

    import threading

    threads = [threading.Thread(target=run, args=args) for args in (
        ("plain", ["--num_requests", "3"]),
        ("sigterm", ["--num_requests", "6", "--chaos", "sigterm@2"]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return runs


def test_serve_entry_on_a_mesh_prints_one_report_from_the_leader(entry_runs):
    codes, outs = entry_runs["plain"]
    assert codes == [0, 0], outs
    lines = [ln for ln in outs[0][0].splitlines() if ln.strip()]
    assert len(lines) == 1 and outs[1][0].strip() == ""
    rep = json.loads(lines[0])
    assert rep["serve_ok"] == 3 and rep["errors"] == 0 and rep["mesh"] == MESH_12
    assert (rep["rank"], rep["world"]) == (0, 2)
    follower = json.loads(outs[1][1].split("lockstep follower: ")[-1].splitlines()[0])
    assert follower["mesh"] == MESH_12 and follower["rank"] == 1
    assert follower["lockstep_ops"] == rep["lockstep_ops"] == {
        "serve_warmup": 1, "serve": rep["serve_batches"]}
    assert follower["collectives"] == rep["collectives"]


def test_sigterm_to_the_leader_ends_every_rank_with_75(entry_runs):
    codes, outs = entry_runs["sigterm"]
    assert codes == [75, 75], outs
    rep = json.loads(outs[0][0].strip().splitlines()[-1])
    assert rep["interrupted"] is True and rep["errors"] == 0
    assert rep["completed"] == rep["accepted"]


# ------------------------------------------------------------- the fleet


def test_replica_argv_carries_the_mesh(tmp_path):
    kw = dict(base_dir=str(tmp_path), n_replicas=2, size_hw=(48, 64),
              meshes=((1, 1), (2, 1)))
    argv = FleetConfig(serve=ServeConfig(batch_sizes=(2, 4), iter_levels=(4, 2)), **kw,
                       stream=None).replica_argv(1)
    jargv = JaxFleetConfig(serve=JaxServeConfig(batch_sizes=(2, 4), iter_levels=(4, 2)),
                           **kw, stream=None).replica_argv(1)
    assert "--mesh 2,1" in " ".join(argv)
    assert argv[argv.index("--mesh"):argv.index("--mesh") + 2] == \
        jargv[jargv.index("--mesh"):jargv.index("--mesh") + 2]


def test_shape_key_uses_replica_mesh_divisor(tmp_path):
    kw = dict(base_dir=str(tmp_path), n_replicas=2, meshes=(None, (1, 2)))
    cfg, jcfg = FleetConfig(**kw), JaxFleetConfig(**kw)
    assert [cfg.pad_divisor(i) for i in (0, 1)] == [jcfg.pad_divisor(i) for i in (0, 1)] \
        == [8, 16]
    assert [cfg.shape_key(97, 130, i) for i in (0, 1)] == \
        [jcfg.shape_key(97, 130, i) for i in (0, 1)] == [(104, 136), (112, 136)]
    assert cfg.replica(1).ranks == 2 and cfg.replica(0).ranks == 1


def test_a_host_agent_reads_a_slots_mesh_from_its_argv(tmp_path):
    from raft_ncup_tpu_torch.fleet.host_supervisor import ManifestConfig

    cfg = FleetConfig(base_dir=str(tmp_path), n_replicas=2, hosts=("a",),
                      placement=("a", "a"), meshes=(None, (1, 2)))
    agent = ManifestConfig(cfg.host_manifest("a"))
    assert [agent.replica(i).mesh for i in (0, 1)] == [None, (1, 2)]
    assert [agent.replica(i).ranks for i in (0, 1)] == [1, 2]


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().split()[2] != "Z"
    except OSError:
        return False


def test_a_spatial_fleet_slot_serves_as_one_process_and_leaves_no_rank(tmp_path):
    cfg = FleetConfig(
        base_dir=str(tmp_path / "fleet"), n_replicas=1, size_hw=(64, 96),
        serve=ServeConfig(batch_sizes=(1,), iter_levels=(2,), queue_capacity=8), stream=None,
        meshes=((1, 2),), extra_args=("--small", "--model", "raft_nc_dbl", "--device", "cpu",
                                      "--seed", "0"),
        snapshot_interval_s=0.25, poll_interval_s=0.05, spawn_timeout_s=120.0,
        stale_after_factor=8.0, max_restarts=0)
    args = serve_mod.build_parser().parse_args(cfg.replica_argv(0))
    model = serve_mod.load_model(model_config_from_args(args, dataset="sintel"), None,
                                 args.device, args.seed)
    a, b = (np.random.default_rng(9).uniform(0, 255, (64, 96, 3)).astype(np.float32)
            for _ in range(2))
    assert serve_config_from_args(args).mesh == (1, 2)
    with FlowServer(model, ServeConfig(batch_sizes=(1,), iter_levels=(2,))) as server:
        want = server.submit(a, b).result(child.WAIT_S)
    tel = Telemetry(flight_dir="")
    sup = ReplicaSupervisor(cfg, env=_env(), telemetry=tel).start()
    router = FleetRouter(cfg, sup, telemetry=tel)
    group = sup.replicas[0].child
    try:
        assert isinstance(group, RankGroup) and len(group.pids) == 2
        hz = read_healthz(cfg.replica(0).healthz_path)
        assert hz["overall"] == "ready" and hz["mesh"] == MESH_12 and hz["pid"] == group.pid
        r = router.submit(a, b).result(child.WAIT_S)
        assert r.status == want.status == "ok"
        np.testing.assert_allclose(r.flow, want.flow, atol=SELF_ATOL, rtol=0)
        router.drain()
        out = sup.drain(0)
    finally:
        router.drain()
        sup.stop(drain=False)
    assert out["observed_draining"] and out["returncode"] == 75
    assert out["report"]["mesh"] == MESH_12 and out["report"]["lockstep_ops"]["serve"] == 1
    t0 = time.monotonic()
    while any(_alive(p) for p in group.pids) and time.monotonic() - t0 < 10:
        time.sleep(0.05)
    assert not any(_alive(p) for p in group.pids)
