"""One rank of the two-rank gloo world of ``tests/test_torch_spatial_serving.py``.

``python tests/_torch_spatial_serving_child.py PORT RANK WORLD WORKDIR``:
joins the world at ``127.0.0.1:PORT`` with explicit arguments, reads the
frames and each model's carried JAX variables from ``WORKDIR/inputs.pt``,
runs every task on the CPU (rank 0 leads the served ones, rank 1 follows)
and saves what each produced to ``WORKDIR/rank<RANK>.pt``. Imports torch
and the port only.
"""

import os
import sys

import torch

from raft_ncup_tpu_torch.analysis import guards
from raft_ncup_tpu_torch.config import (
    ServeConfig,
    StreamConfig,
    UpsamplerConfig,
    small_model_config,
)
from raft_ncup_tpu_torch.inference.pipeline import ShapeCachedForward
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.parallel import mesh as mesh_mod
from raft_ncup_tpu_torch.parallel import multihost
from raft_ncup_tpu_torch.parallel.lockstep import lockstep_stats
from raft_ncup_tpu_torch.serving import FlowServer
from raft_ncup_tpu_torch.streaming import StreamEngine
from raft_ncup_tpu_torch.utils.jax_weights import load_jax_variables

# Shared with the test (which imports this module for them).
H, W, ITERS = 64, 96, 2
MODELS = {"raft_nc_dbl": "sintel", "raft": "chairs"}
EE_ITERS = 4
EE_TOLS = (1e9, 0.5, 0.0)  # every row converges at once, some rows, none
# The flagship with the U-Net weights net (two poolings) at a height whose
# bands pool to an odd row: 80 / 4 / 2 = 10 rows at the net's resolution.
UNET_HW = (80, 96)
UNET_KW = dict(upsampler=UpsamplerConfig(weights_est_net="unet",
                                         weights_est_num_ch=(16, 32, 64)))
WAIT_S = 120.0
COLLECTIVE_TIMEOUT_S = 120.0  # a hung collective fails well inside the test's own limit


def model_cfg(variant, **kw):
    return small_model_config(variant, dataset=MODELS[variant], corr_impl="pallas",
                              nconv_impl="pallas", **kw)


def model(variant, variables):
    return load_jax_variables(RAFT(model_cfg(variant), device="cpu", seed=1), variables)


def unet_model():
    return RAFT(model_cfg("raft_nc_dbl", **UNET_KW), device="cpu", seed=2)


def serve_cfg(mesh, batch=1):
    return ServeConfig(batch_sizes=(batch,), iter_levels=(ITERS,), mesh=mesh)


def stream_cfg(mesh):
    return StreamConfig(capacity=1, frame_hw=(H, W), iters=ITERS, batch_sizes=(1,),
                        queue_capacity=8, mesh=mesh)


def served(m, cfg, pairs, leader):
    """The pairs through a server of ``cfg`` (one batch): the leader's
    answers and report, or the follower's exit code."""
    server = FlowServer(m, cfg)
    if not leader:
        rc = server.follow()
        server.drain()
        return {"rc": rc}
    with server:
        server.pause()
        handles = [server.submit(a, b) for a, b in pairs]
        server.resume()
        rs = [h.result(WAIT_S) for h in handles]
    return {"status": [r.status for r in rs], "flows": [r.flow for r in rs],
            "report": server.report()}


def streamed(m, frames, leader):
    """Two warm-chained frames of one stream through an engine on the mesh
    (1, 2), the leader's under the runtime guards after the warm-up."""
    engine = StreamEngine(m, stream_cfg((1, 2)))
    if not leader:
        rc = engine.follow()
        engine.drain()
        return {"rc": rc}
    engine.warmup()
    stats = guards.GuardStats()
    out = []
    with guards.RecompileWatchdog() as wd, guards.forbid_host_transfers(
            stats, raise_on_violation=False):
        for i1, i2 in frames:
            out.append(engine.submit("s", i1, i2).result(WAIT_S))
    engine.drain()
    return {"status": [r.status for r in out], "flows": [r.flow for r in out],
            "recompiles": wd.count, "host_transfers": stats.host_transfers,
            "report": engine.report()}


def early_exit(m, img1, img2, mesh):
    """The early-exit forward of the cache and of the model at each
    tolerance: each's executed iterations and flow."""
    out = {}
    fwd = ShapeCachedForward(m, mesh=mesh)
    for tol in EE_TOLS:
        _, up, ex = fwd.forward(img1, img2, EE_ITERS, early_exit_tol=tol)
        _, up_m, ex_m = m(img1, img2, iters=EE_ITERS, early_exit_tol=tol,
                          return_exec_iters=True, mesh=mesh)
        out[tol] = {"cache": (ex, up), "model": (ex_m, up_m), "last": dict(fwd.last_earlyexit)}
    return out


def main():
    port, rank, world, workdir = sys.argv[1:5]
    rank, world = int(rank), int(world)
    leader = rank == 0
    torch.set_num_threads(1)
    multihost.COLLECTIVE_TIMEOUT_S = COLLECTIVE_TIMEOUT_S
    assert multihost.initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    pair = [(inputs["image1"][0].numpy(), inputs["image2"][0].numpy())]
    out = {"rank": rank}
    mesh_mod.reset_collective_stats()
    for variant in MODELS:
        out[f"server {variant}"] = served(model(variant, inputs["variables"][variant]),
                                          serve_cfg((1, 2)), pair, leader)
    out["collectives"] = mesh_mod.collective_stats()
    out["lockstep"] = lockstep_stats()
    flagship = model("raft_nc_dbl", inputs["variables"]["raft_nc_dbl"])
    two = [(inputs["image1"][k].numpy(), inputs["image2"][k].numpy()) for k in range(2)]
    mesh_mod.reset_collective_stats()
    out["server (2, 1)"] = served(flagship, serve_cfg((2, 1), batch=2), two, leader)
    out["data collectives"] = mesh_mod.collective_stats()
    out["stream"] = streamed(flagship, inputs["frames"], leader)
    out["early exit"] = early_exit(flagship, inputs["image1"], inputs["image2"],
                                   mesh_mod.make_mesh(1, 2, device="cpu"))
    out["unet"] = unet_model()(inputs["unet1"], inputs["unet2"], iters=ITERS,
                               mesh=mesh_mod.make_mesh(1, 2, device="cpu"))
    out["barrier"] = multihost.barrier("child_end", timeout_s=60)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    multihost.shutdown()


if __name__ == "__main__":
    main()
