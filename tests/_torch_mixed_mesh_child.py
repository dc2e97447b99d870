"""One rank of the four-rank gloo world of ``tests/test_torch_mixed_mesh.py``.

``python tests/_torch_mixed_mesh_child.py PORT RANK WORLD WORKDIR``: joins
the world at ``127.0.0.1:PORT`` with explicit arguments, reads the frames
and each model's carried JAX variables from ``WORKDIR/inputs.pt``, runs
every task over the meshes ``(1, 2, 2)`` and ``(2, 1, 2)`` on the CPU (rank
0 leads the served ones, the others follow) and saves what each produced,
on every rank, to ``WORKDIR/rank<RANK>.pt``. Imports torch and the port
only.
"""

import contextlib
import io
import json
import os
import sys

import torch

from raft_ncup_tpu_torch import evaluate as eval_entry
from raft_ncup_tpu_torch import serve as serve_entry
from raft_ncup_tpu_torch.config import ServeConfig, StreamConfig, small_model_config
from raft_ncup_tpu_torch.inference import metrics as metrics_mod
from raft_ncup_tpu_torch.inference.pipeline import ShapeCachedForward
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.parallel import halo, multihost
from raft_ncup_tpu_torch.parallel import mesh as mesh_mod
from raft_ncup_tpu_torch.parallel.lockstep import data_rows, gather_data, lockstep_stats
from raft_ncup_tpu_torch.serving import FlowServer
from raft_ncup_tpu_torch.streaming import StreamEngine
from raft_ncup_tpu_torch.utils.jax_weights import load_jax_variables

# Shared with the test (which imports this module for them). 64 rows: each
# band of a spatial pair holds 4 rows at 1/8 resolution, as in
# tests/test_torch_spatial_serving.py. At 48 rows (3-row bands, the least
# the motion encoder's 7x7 reads) JAX's own make_mesh(1, 2, 2) forward
# differs from its unsharded forward by 1.1e-2 on the CPU, so it is no
# reference there.
H, W, ITERS, BATCH = 64, 96, 4, 2
MESHES = ((1, 2, 2), (2, 1, 2))
MODELS = {"raft_nc_dbl": "sintel", "raft": "chairs"}
EE_TOLS = (1e9, 0.5, 0.0)  # every row converges at once, some rows, none
SERVE_ARGV = ["--device", "cpu", "--model", "raft", "--small", "--size", str(H), str(W),
              "--num_requests", "4", "--iter_levels", "4,2", "--serve_batch_sizes", "2",
              "--queue_capacity", "16", "--seed", "3", "--flight_dir", ""]
EVAL_ARGV = ["--dataset", "synthetic", "--device", "cpu", "--model", "raft", "--small",
             "--iters", "2", "--batch_size", "2", "--num_workers", "1"]
WAIT_S = 120.0
COLLECTIVE_TIMEOUT_S = 120.0


def model_cfg(variant):
    return small_model_config(variant, dataset=MODELS[variant], corr_impl="pallas",
                              nconv_impl="pallas")


def model(variant, variables):
    return load_jax_variables(RAFT(model_cfg(variant), device="cpu", seed=1), variables)


def serve_cfg(mesh):
    return ServeConfig(batch_sizes=(BATCH,), iter_levels=(ITERS,), mesh=mesh)


def stream_cfg(mesh):
    return StreamConfig(capacity=1, frame_hw=(H, W), iters=ITERS, batch_sizes=(BATCH,),
                        queue_capacity=8, mesh=mesh)


@contextlib.contextmanager
def recorded(obj):
    """Every output of ``obj._run`` (the server's forward or the engine's
    step, the leader's and a follower's alike), cloned, while inside."""
    outs, run = [], obj._run

    def wrapped(*a, **kw):
        out = run(*a, **kw)
        outs.append(out[0].detach().clone())
        return out

    obj._run = wrapped
    try:
        yield outs
    finally:
        obj._run = run


def served(m, mesh, pairs, leader):
    """The pairs through a server on ``mesh`` (one batch): the flows this
    rank computed, and the leader's answers and report or the follower's
    exit code."""
    server = FlowServer(m, serve_cfg(mesh))
    with recorded(server) as outs:
        if not leader:
            out = {"rc": server.follow()}
            server.drain()
        else:
            with server:
                server.pause()
                handles = [server.submit(a, b) for a, b in pairs]
                server.resume()
                rs = [h.result(WAIT_S) for h in handles]
            out = {"status": [r.status for r in rs], "flows": [r.flow for r in rs],
                   "report": server.report()}
    out["computed"] = outs[-1]
    return out


def streamed(m, mesh, frames, leader):
    """Two warm-chained frames of one stream through an engine on
    ``mesh``: the flows each step computed on this rank, and the leader's
    answers or the follower's exit code."""
    engine = StreamEngine(m, stream_cfg(mesh))
    with recorded(engine) as outs:
        if not leader:
            out = {"rc": engine.follow()}
            engine.drain()
        else:
            rs = [engine.submit("s", a, b).result(WAIT_S) for a, b in frames]
            engine.drain()
            out = {"status": [r.status for r in rs], "flows": [r.flow for r in rs],
                   "report": engine.report()}
    out["computed"] = outs[-len(frames):]
    return out


def early_exit(m, mesh, img1, img2):
    """The early-exit forward of the cache at each tolerance on this rank's
    rows, gathered over the data axis: its executed iterations and flow."""
    fwd = ShapeCachedForward(m, mesh=mesh)
    out = {}
    for tol in EE_TOLS:
        _, up, ex = fwd.forward(data_rows(img1, mesh), data_rows(img2, mesh), ITERS,
                                early_exit_tol=tol)
        out[tol] = (gather_data(ex, mesh), gather_data(up, mesh))
    return out


@contextlib.contextmanager
def halo_peers():
    """The global ranks each halo exchange of this rank talks to."""
    peers, exchange = set(), halo._exchange

    def wrapped(sp, *a, **kw):
        s = sp.index
        peers.update(sp.ranks[i] for i in (s - 1, s + 1) if 0 <= i < sp.size)
        return exchange(sp, *a, **kw)

    halo._exchange = wrapped
    try:
        yield peers
    finally:
        halo._exchange = exchange


@contextlib.contextmanager
def metric_sums():
    """The metric sums each validation pass finalizes, as numpy arrays."""
    sums, finalize = [], metrics_mod.finalize

    def wrapped(kind, acc):
        sums.append(acc.copy())
        return finalize(kind, acc)

    metrics_mod.finalize = wrapped
    try:
        yield sums
    finally:
        metrics_mod.finalize = finalize


def entry_json(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = main(argv)
    lines = buf.getvalue().strip().splitlines()
    return code, json.loads(lines[-1]) if lines else None


def run_mesh(inputs, mesh_axes, leader):
    mesh = mesh_mod.make_mesh(*mesh_axes, device="cpu")
    out = {"fingerprint": mesh_mod.mesh_fingerprint(mesh),
           "layout": (mesh.data_index, mesh.spatial_index, mesh.pipe_index),
           "spatial_ranks": (mesh_mod.spatial_group(mesh).ranks if mesh.spatial > 1
                             else None),
           "data_ranks": mesh_mod.data_ranks(mesh)}
    pairs = [(inputs["image1"][k].numpy(), inputs["image2"][k].numpy()) for k in range(BATCH)]
    mesh_mod.reset_collective_stats()
    with halo_peers() as peers:
        for variant in MODELS:
            out[f"server {variant}"] = served(model(variant, inputs["variables"][variant]),
                                              mesh_axes, pairs, leader)
    out["halo_peers"] = sorted(peers)
    out["collectives"] = mesh_mod.collective_stats()
    out["lockstep"] = lockstep_stats()
    flagship = model("raft_nc_dbl", inputs["variables"]["raft_nc_dbl"])
    out["stream"] = streamed(flagship, mesh_axes, inputs["frames"], leader)
    out["early exit"] = early_exit(flagship, mesh, inputs["image1"], inputs["image2"])
    with metric_sums() as sums:
        out["evaluate"] = entry_json(eval_entry.main,
                                     EVAL_ARGV + ["--mesh", ",".join(map(str, mesh_axes))])
    out["eval_sums"] = sums
    return out


def main():
    port, rank, world, workdir = sys.argv[1:5]
    rank, world = int(rank), int(world)
    leader = rank == 0
    torch.set_num_threads(1)
    multihost.COLLECTIVE_TIMEOUT_S = COLLECTIVE_TIMEOUT_S
    assert multihost.initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = {"rank": rank, "backend": multihost.backend()}
    for mesh_axes in MESHES:
        out[mesh_axes] = run_mesh(inputs, mesh_axes, leader)
    rc, report, responses, _ = serve_entry.run(SERVE_ARGV + ["--mesh", "1,2,2"])
    out["serve entry"] = {"rc": rc, "mesh": report.get("mesh"),
                          "completed": report.get("completed"),
                          "flows": [r.flow for r in responses
                                    if getattr(r, "flow", None) is not None]}
    out["barrier"] = multihost.barrier("child_end", timeout_s=60)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    multihost.shutdown()


if __name__ == "__main__":
    main()
