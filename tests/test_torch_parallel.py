"""The port's mesh and process world (``raft_ncup_tpu_torch/parallel/``)
against the JAX package's (``tests/test_mesh_sharding.py``,
``tests/test_multihost.py``), in one process on the CPU: the mesh's
refusals and fingerprints, the config mesh rule, the CLI's ``--mesh`` and
``--data_parallel`` rules and the configuration's divisibility checks
against the world a launcher names, the backend rule, the one-process
no-ops, a failed join, and the loader's shards, whose union at each step
is the one-process batch. The two-rank world itself runs in
``tests/test_torch_data_parallel.py``."""

import argparse
import hashlib

import jax
import numpy as np
import pytest
import torch

from raft_ncup_tpu.cli import str2mesh as jax_str2mesh
from raft_ncup_tpu.parallel import make_mesh as jax_make_mesh
from raft_ncup_tpu.parallel import mesh_fingerprint as jax_mesh_fingerprint
from raft_ncup_tpu.parallel.mesh import collective_stats as jax_collective_stats
from raft_ncup_tpu.parallel.mesh import resolve_config_mesh as jax_resolve_config_mesh
from raft_ncup_tpu.resilience.preemption import PreemptionHandler as JaxPreemptionHandler
from raft_ncup_tpu_torch import cli
from raft_ncup_tpu_torch.config import TrainConfig
from raft_ncup_tpu_torch.data.loader import FlowLoader
from raft_ncup_tpu_torch.parallel import mesh as mesh_mod
from raft_ncup_tpu_torch.parallel import multihost
from raft_ncup_tpu_torch.resilience import PreemptionHandler, preemption
from raft_ncup_tpu_torch.training.checkpoint import CheckpointManager
from raft_ncup_tpu_torch.training.logger import Logger


@pytest.fixture
def launched_world(monkeypatch):
    """The environment a launcher gives the ranks of a world of ``n`` (no
    process group is joined)."""

    def set_world(n, rank=0):
        for k, v in dict(WORLD_SIZE=n, RANK=rank, LOCAL_RANK=rank, MASTER_ADDR="127.0.0.1",
                         MASTER_PORT=29500).items():
            monkeypatch.setenv(k, str(v))

    return set_world


def test_one_process_mesh_and_fingerprints_are_jaxs():
    mesh = mesh_mod.make_mesh(device="cpu")
    assert (mesh.data, mesh.rank, mesh.shape) == (1, 0, {"data": 1, "spatial": 1})
    jax_one = jax_make_mesh(data=1, spatial=1, devices=jax.devices()[:1])
    assert mesh_mod.mesh_fingerprint(mesh) == jax_mesh_fingerprint(jax_one)
    assert mesh_mod.mesh_fingerprint(None) == jax_mesh_fingerprint(None) == "nomesh"
    two = mesh_mod.Mesh(data=2, rank=1, platform="cpu")
    jax_two = jax_make_mesh(data=2, spatial=1, devices=jax.devices()[:2])
    assert mesh_mod.mesh_fingerprint(two) == jax_mesh_fingerprint(jax_two)
    assert mesh_mod.mesh_fingerprint(mesh_mod.Mesh(2, 0, "gpu")) == "mesh(data=2,spatial=1:gpu)"
    assert mesh_mod.make_mesh(device="cuda:0").platform == "gpu"


@pytest.mark.parametrize("kw,match", [
    (dict(spatial=2), "times spatial size 2 must equal the world size 1"),
    (dict(data=1, spatial=2), "times spatial size 2 must equal the world size 1"),
    (dict(pipe=2), "times spatial size 1 times pipe size 2 must equal the world size 1"),
    (dict(data=1, spatial=2, pipe=4),
     "times spatial size 2 times pipe size 4 must equal the world size 1")])
def test_make_mesh_refuses_the_later_axes(kw, match):
    # A spatial or pipe axis is one process per card: a world of one has
    # neither (tests/test_torch_pipe_axis.py builds pipe meshes in worlds).
    with pytest.raises(ValueError, match=match):
        mesh_mod.make_mesh(**kw)


def test_rank_layout_is_jaxs_device_order():
    """The (2, 2) grid: rank r is data index r // 2 and spatial index
    r % 2, where JAX's make_mesh(data=2, spatial=2) puts device r."""
    jmesh = jax_make_mesh(data=2, spatial=2, devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    jax_layout = [tuple(int(v) for v in np.argwhere(ids == r)[0]) for r in range(4)]
    assert jax_layout == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r, (d, s) in enumerate(jax_layout):
        m = mesh_mod.Mesh(data=2, rank=r, platform="cpu", spatial=2)
        assert (m.data_index, m.spatial_index) == (d, s)
        assert mesh_mod.batch_sharding(m) == slice(d, None, 2)
    assert mesh_mod.mesh_fingerprint(mesh_mod.Mesh(2, 3, "cpu", spatial=2)) == \
        jax_mesh_fingerprint(jmesh) == "mesh(data=2,spatial=2:cpu)"


def test_check_axes_takes_the_spatial_axis_against_the_world():
    assert mesh_mod.check_axes(None, 2, 1, world=4) == 2
    assert mesh_mod.check_axes(1, 2, 1, world=2) == 1
    assert mesh_mod.check_axes(2, 2, 1, world=4) == 2
    for data, spatial, world in ((2, 2, 2), (1, 2, 4), (None, 3, 4)):
        with pytest.raises(ValueError, match=f"must equal the world size {world}"):
            mesh_mod.check_axes(data, spatial, 1, world=world)
    # The pipe axis is accepted against the world, as JAX's make_mesh(1, 1, P).
    assert mesh_mod.check_axes(1, 1, 2, world=2) == 1
    with pytest.raises(ValueError, match="times pipe size 2 must equal the world size 4"):
        mesh_mod.check_axes(1, 1, 2, world=4)


def test_make_mesh_data_must_be_the_world():
    with pytest.raises(ValueError, match="world size 1"):
        mesh_mod.make_mesh(data=2)
    with pytest.raises(ValueError, match=">= 1"):
        mesh_mod.make_mesh(pipe=0)


def test_resolve_config_mesh_follows_jaxs_rule():
    for cfg_mesh in (None, (1, 1), (1, 1, 1)):
        mesh, div = mesh_mod.resolve_config_mesh(None, cfg_mesh)
        jmesh, jdiv = jax_resolve_config_mesh(None, cfg_mesh)
        assert div == jdiv == 8
        assert (mesh is None) == (jmesh is None)
        if mesh is not None:
            assert mesh_mod.mesh_fingerprint(mesh) == "mesh(data=1,spatial=1:" + mesh.platform + ")"
    explicit = mesh_mod.Mesh(2, 0, "cpu")
    assert mesh_mod.resolve_config_mesh(explicit, (1, 1)) == (explicit, 8)
    # A spatial mesh pads to 8 * spatial, as JAX's does.
    spatial = mesh_mod.Mesh(1, 0, "cpu", spatial=2)
    assert mesh_mod.resolve_config_mesh(spatial, None) == (spatial, 16)
    assert jax_resolve_config_mesh(None, (1, 2))[1] == 16 == mesh_mod.pad_divisor(spatial)
    with pytest.raises(ValueError, match="world size 1"):  # two processes, not one
        mesh_mod.resolve_config_mesh(None, (1, 2))


def test_batch_sharding_takes_every_data_th_row():
    mesh = mesh_mod.Mesh(3, 1, "cpu")
    batch = {"a": np.arange(6), "extra_info": list("abcdef")}
    got = mesh_mod.shard_batch(batch, mesh)
    assert got["a"].tolist() == [1, 4] and got["extra_info"] == ["b", "e"]


def test_collective_stats_has_jaxs_format():
    mesh_mod.reset_collective_stats()
    ours, theirs = mesh_mod.collective_stats(), jax_collective_stats("")
    assert ours == theirs
    t = torch.ones(5)
    assert multihost.all_reduce_(t) is t  # one process: t itself, nothing issued
    assert mesh_mod.collective_stats()["collectives"] == 0


def test_cli_mesh_flags_follow_the_world(launched_world):
    base = ["--stage", "things", "--batch_size", "6"]
    assert cli.parse_train(base)[2].data_parallel == 1
    assert cli.parse_train(base + ["--data_parallel", "1"])[2].data_parallel == 1
    with pytest.raises(ValueError, match="world size 1"):
        cli.parse_train(base + ["--data_parallel", "2"])
    with pytest.raises(ValueError, match="world size 1"):
        cli.parse_train(base + ["--spatial_parallel", "2"])
    # --gpus is accepted and ignored, as in JAX.
    assert cli.parse_train(base + ["--gpus", "0", "1"])[2].data_parallel == 1
    launched_world(2)
    assert cli.parse_train(base)[2].data_parallel == 2
    assert cli.parse_train(base + ["--data_parallel", "2"])[2].data_parallel == 2
    with pytest.raises(ValueError, match="world size 2"):
        cli.parse_train(base + ["--data_parallel", "3"])
    # The train entry has no pipe axis (nor has JAX's trainer).
    with pytest.raises(ValueError, match="the train entry has no pipe axis"):
        cli.parse_train(base + ["--mesh", "1,1,2"])
    with pytest.raises(ValueError, match="not divisible by --data_parallel 4"):
        launched_world(4)
        cli.parse_train(base)


def test_eval_mesh_flag_is_jaxs_spec_and_follows_the_world(launched_world):
    for spec in ("1,2", "1,1,2", "2,1"):
        assert cli.str2mesh(spec) == jax_str2mesh(spec)
    for bad in ("2", "0,2", "1,1,0", "1,1,2,2"):
        with pytest.raises(argparse.ArgumentTypeError):
            cli.str2mesh(bad)
        with pytest.raises(argparse.ArgumentTypeError):
            jax_str2mesh(bad)
    args = ["--dataset", "sintel", "--device", "cpu"]
    assert cli.parse_eval(args + ["--mesh", "1,1"])[0].mesh == (1, 1)
    for bad, match in ((["--mesh", "2,1"], "world size 1"), (["--mesh", "1,2"], "world size 1"),
                       (["--mesh", "1,1,2"], "times pipe size 2 must equal the world size 1"),
                       (["--spatial_parallel", "2"], "world size 1")):
        with pytest.raises(ValueError, match=match):
            cli.parse_eval(args + bad)
    launched_world(2, rank=1)
    assert cli.parse_eval(args + ["--mesh", "2,1"])[0].mesh_axes == (2, 1)
    # Two ranks split each forward by rows: --mesh 1,2, or its shorthand.
    assert cli.parse_eval(args + ["--mesh", "1,2"])[0].mesh_axes == (1, 2)
    assert cli.parse_eval(args + ["--spatial_parallel", "2"])[0].mesh_axes == (1, 2)
    for bad, match in ((["--mesh", "2,2"], "world size 2"),
                       (["--mesh", "1,2,2"], "times pipe size 2 must equal the world size 2")):
        with pytest.raises(ValueError, match=match):
            cli.parse_eval(args + bad)
    # A pipe axis over the world: each pipe index evaluates the (data,
    # spatial) pass (JAX replicates the forward over pipe), beside a data or
    # spatial axis too, when the three sizes make the world.
    parsed = cli.parse_eval(args + ["--mesh", "1,1,2"])[0]
    assert (parsed.mesh_axes, parsed.mesh_pipe) == ((1, 1), 2)
    launched_world(4, rank=1)
    for mesh, axes in (("1,2,2", (1, 2)), ("2,1,2", (2, 1)), ("1,1,4", (1, 1))):
        parsed = cli.parse_eval(args + ["--mesh", mesh])[0]
        assert (parsed.mesh_axes, parsed.mesh_pipe) == (axes, int(mesh[-1]))
    with pytest.raises(ValueError, match="times pipe size 2 must equal the world size 4"):
        cli.parse_eval(args + ["--mesh", "2,2,2"])


def test_highres_mesh_flags_follow_the_world(launched_world):
    from raft_ncup_tpu_torch import highres_forward

    def axes(argv):
        return highres_forward.mesh_axes(highres_forward.build_parser().parse_args(argv))

    assert axes([]) == (1, 1)
    for bad, match in ((["--spatial", "2"], "world size 1"), (["--mesh", "1,2"], "world size 1"),
                       (["--mesh", "1,1,2"], "the highres entry has no pipe axis")):
        with pytest.raises(ValueError, match=match):
            axes(bad)
    launched_world(2)
    for spelling in (["--spatial", "2"], ["--spatial_parallel", "2"], ["--mesh", "1,2"]):
        assert axes(spelling) == (1, 2)
    launched_world(4)
    assert axes(["--spatial", "2"]) == axes(["--mesh", "2,2"]) == (2, 2)


@pytest.mark.parametrize("batch,data,ok", [(6, 1, True), (6, 2, True), (6, 3, True),
                                           (6, 4, False), (4, 8, False), (8, 8, True)])
def test_train_config_divisibility_is_jaxs(batch, data, ok):
    # JAX's trainer (train.py:111-116, 184-190): the global batch must
    # divide over the data axis and over the processes.
    assert ok == (batch % data == 0)
    if ok:
        assert TrainConfig(batch_size=batch, data_parallel=data).data_parallel == data
    else:
        with pytest.raises(ValueError, match=f"--batch_size {batch} not divisible"):
            TrainConfig(batch_size=batch, data_parallel=data)


def test_train_config_takes_the_spatial_axis():
    cfg = TrainConfig(spatial_parallel=2, data_parallel=1, image_size=(48, 64))
    assert (cfg.data_parallel, cfg.spatial_parallel) == (1, 2)
    with pytest.raises(ValueError, match="must divide by 8 \\* --spatial_parallel = 16"):
        TrainConfig(spatial_parallel=2, image_size=(40, 64))
    with pytest.raises(ValueError, match=">= 1"):
        TrainConfig(data_parallel=0)


def test_backend_rule_and_knob(monkeypatch):
    monkeypatch.delenv("RAFT_TORCH_DIST_BACKEND", raising=False)
    assert multihost.resolve_backend(None, "cpu") == "gloo"
    assert multihost.resolve_backend(None, "cuda:1") == "nccl"
    assert multihost.resolve_backend("gloo", "cuda:0") == "gloo"
    with pytest.raises(ValueError, match="nccl backend needs a rank on a card"):
        multihost.resolve_backend("nccl", "cpu")
    with pytest.raises(ValueError, match="unknown process-group backend"):
        multihost.resolve_backend("mpi", "cpu")
    monkeypatch.setenv("RAFT_TORCH_DIST_BACKEND", "gloo")
    assert multihost.resolve_backend(None, "cuda:0") == "gloo"


def test_one_process_is_a_no_op(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize_distributed(device="cpu") is False
    assert multihost.initialize_distributed(num_processes=1) is False
    assert not multihost.initialized() and not multihost.is_multihost()
    assert multihost.is_main_process() and multihost.process_count() == 1
    x = np.array([1.5, 2.0])
    assert multihost.allreduce_sum_across_hosts(x).tolist() == [1.5, 2.0]
    assert multihost.agreed_min(7) == 7 and multihost.agreed_any(True)
    assert multihost.barrier("anything", timeout_s=0.0)
    assert multihost.local_device("cpu") == torch.device("cpu")
    # A one-process poll reads the flag at every boundary.
    handler = PreemptionHandler(check_every=16)
    handler._requested = True
    assert handler.poll(3)


def test_a_failed_join_raises_and_never_carries_on(monkeypatch):
    monkeypatch.setattr(multihost, "COLLECTIVE_TIMEOUT_S", 2.0)
    with pytest.raises(RuntimeError, match="joining the process world failed"):
        multihost.initialize_distributed("127.0.0.1:9", 2, 1, device="cpu")
    assert not multihost.initialized()


def test_check_every_knob(monkeypatch):
    # A constant, the JAX package's constructor default.
    assert PreemptionHandler().check_every == JaxPreemptionHandler().check_every == 16
    assert PreemptionHandler(check_every=0).check_every == 1
    monkeypatch.setattr(preemption, "CHECK_EVERY", 3)
    assert PreemptionHandler().check_every == 3


def test_inactive_logger_and_writer_roles(tmp_path):
    log = Logger(str(tmp_path / "run"), {"a": 1}, sum_freq=1, active=False)
    log.write_text("x")
    log.push(0, {"loss": torch.tensor(1.0)})
    log.close()
    assert not (tmp_path / "run").exists()
    assert CheckpointManager(str(tmp_path / "ck")).writer  # one process: rank 0 writes


def _digest(batch):
    h = hashlib.sha256()
    for k in ("image1", "image2", "flow", "valid"):
        h.update(np.ascontiguousarray(batch[k]).tobytes())
    return h.hexdigest()


class _Samples:
    """A dataset whose sample ``i`` is a function of ``i`` and the rng."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def sample(self, index, rng):
        v = np.full((4, 4, 3), index, np.uint8)
        return {"image1": v, "image2": v + 1, "flow": rng.normal(size=(4, 4, 2)).astype(
            np.float32), "valid": np.ones((4, 4), np.float32)}


@pytest.mark.parametrize("n,world,global_batch", [(11, 2, 4), (23, 3, 6), (16, 4, 4)])
def test_ranks_batches_together_are_the_one_process_batch(n, world, global_batch):
    """At every step (across epochs too), the rows of the ranks' batches,
    rank ``r``'s row ``j`` at global row ``j * world + r``, are the
    one-process batch of that step; every rank makes the one-process
    count of batches an epoch."""
    ds = _Samples(n)
    one = FlowLoader(ds, global_batch, seed=3, num_workers=1, shard_index=0, num_shards=1)
    shards = [FlowLoader(ds, global_batch // world, seed=3, num_workers=1, shard_index=r,
                         num_shards=world) for r in range(world)]
    assert {len(s) for s in shards} == {len(one)} == {n // global_batch}
    steps = 2 * len(one) + 1
    streams = [s.batches() for s in [one] + shards]
    for _ in range(steps):
        whole, *parts = [next(it) for it in streams]
        for r, part in enumerate(parts):
            rows = {k: whole[k][r::world] for k in ("image1", "image2", "flow", "valid")}
            assert _digest(part) == _digest(rows)


def test_collective_read_is_a_named_counted_read():
    """gloo's round trip of a card tensor through the host is
    ``guards.collective_read``: inside a guarded window it is no implicit
    transfer, and it counts ``guard_collective_reads_total``."""
    from raft_ncup_tpu_torch.analysis import guards
    from raft_ncup_tpu_torch.observability import Telemetry, set_telemetry

    tel = Telemetry(enabled=True)
    prev = set_telemetry(tel)
    try:
        t = torch.arange(4.0)
        with guards.forbid_host_transfers() as stats:
            host = guards.collective_read(t)
        assert stats.host_transfers == 0 and stats.sanctioned_gets == 0
        assert torch.equal(host, t) and host.data_ptr() != t.data_ptr()
        assert tel.counter_value("guard_collective_reads_total") == 1
    finally:
        set_telemetry(prev)


def _spatial_mesh():
    return mesh_mod.Mesh(data=1, rank=0, platform="cpu", spatial=2)


def _spatial_path(path, launched_world, monkeypatch):
    """Drive one training path with a spatial size of 2; returns what it
    gave."""
    from raft_ncup_tpu_torch.config import small_model_config
    from raft_ncup_tpu_torch.models import raft as raft_mod
    from raft_ncup_tpu_torch.models.raft import RAFT
    from raft_ncup_tpu_torch.parallel import halo
    from raft_ncup_tpu_torch.training import step as step_mod

    if path == "train entry":
        launched_world(2)
        cfg = cli.parse_train(["--stage", "things", "--batch_size", "2", "--image_size",
                               "48", "64", "--spatial_parallel", "2"])[2]
        return cfg.data_parallel, cfg.spatial_parallel
    if path == "train step":
        return callable(step_mod.make_train_step(
            TrainConfig(batch_size=2, spatial_parallel=2, data_parallel=1,
                        image_size=(48, 64)), mesh=_spatial_mesh()))
    # The train-mode forward on band 0 of 2 with no second process: the
    # exchanges return zeros and the sums their input, so it runs, with
    # band shapes (tests/test_torch_spatial_train.py holds its values).
    monkeypatch.setattr(raft_mod, "spatial_group", lambda mesh: halo.SpatialGroup(
        size=2, index=0, ranks=(0, 1)))
    monkeypatch.setattr(halo, "_exchange", lambda *args: (None, None))
    monkeypatch.setattr(halo, "all_gather_rows", lambda x, dim=1, group=None: torch.cat(
        [x, torch.zeros_like(x)], dim=dim))
    monkeypatch.setattr(halo, "group_sum", lambda t: t)
    model = RAFT(small_model_config("raft"), device="cpu", seed=0)
    frames = torch.zeros((1, 48, 64, 3))
    model.train()
    return tuple(model(frames, frames, iters=1, mesh=_spatial_mesh()).shape)


@pytest.mark.parametrize("path,took", [
    ("train entry", (1, 2)), ("train step", True), ("train-mode forward", (1, 1, 24, 64, 2))])
def test_training_paths_take_a_spatial_axis(path, took, launched_world, monkeypatch):
    assert _spatial_path(path, launched_world, monkeypatch) == took
