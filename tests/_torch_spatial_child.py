"""One rank of the two-rank gloo world of ``tests/test_torch_spatial.py``.

``python tests/_torch_spatial_child.py PORT RANK WORLD WORKDIR``: joins the
world at ``127.0.0.1:PORT`` with explicit arguments, builds the mesh
``(data=1, spatial=2)``, reads the frames and each model's carried JAX
variables from ``WORKDIR/inputs.pt``, runs every task on the CPU and saves
what each produced to ``WORKDIR/rank<RANK>.pt``. Imports torch and the port
only.
"""

import contextlib
import io
import json
import os
import sys

import torch

from raft_ncup_tpu_torch import evaluate as eval_entry
from raft_ncup_tpu_torch import evaluation
from raft_ncup_tpu_torch import highres_forward
from raft_ncup_tpu_torch.analysis import guards
from raft_ncup_tpu_torch.config import small_model_config
from raft_ncup_tpu_torch.evaluation import validate_synthetic
from raft_ncup_tpu_torch.inference.pipeline import ShapeCachedForward
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.nn.layers import InstanceNorm2d
from raft_ncup_tpu_torch.parallel import halo
from raft_ncup_tpu_torch.parallel import mesh as mesh_mod
from raft_ncup_tpu_torch.parallel import multihost
from raft_ncup_tpu_torch.utils.jax_weights import load_jax_variables

# Shared with the test (which imports this module for them).
H, W, ITERS = 64, 96, 4
MODELS = {"raft_nc_dbl": "sintel", "raft": "chairs"}
VAL = dict(size_hw=(64, 96), length=5, iters=2, batch_size=2)
EVAL_ARGV = ["--dataset", "synthetic", "--device", "cpu", "--model", "raft", "--small",
             "--iters", "2", "--batch_size", "2", "--num_workers", "1"]
HIGHRES_ARGV = ["--device", "cpu", "--size", "48", "64", "--iters", "2", "--small"]
COLLECTIVE_TIMEOUT_S = 120.0  # a hung collective fails well inside the test's own limit


def model_cfg(variant):
    return small_model_config(variant, dataset=MODELS[variant], corr_impl="pallas",
                              nconv_impl="pallas")


def model(variant, variables):
    return load_jax_variables(RAFT(model_cfg(variant), device="cpu", seed=1), variables)


def forwards(inputs, mesh):
    """Each model's sharded forward, its collectives and, for the flagship
    variant, the same forward inside a guarded window."""
    out = {}
    for variant in MODELS:
        m = model(variant, inputs["variables"][variant])
        mesh_mod.reset_collective_stats()
        flow_lr, flow_up = m(inputs["image1"], inputs["image2"], iters=ITERS, mesh=mesh)
        out[variant] = {"flow_lr": flow_lr, "flow_up": flow_up,
                        "collectives": mesh_mod.collective_stats()}
    with guards.forbid_host_transfers() as stats:
        m(inputs["image1"], inputs["image2"], iters=ITERS, mesh=mesh)
    out["guarded"] = {"host_transfers": stats.host_transfers,
                      "sanctioned_gets": stats.sanctioned_gets}
    return out


def instance_norm(x, mesh):
    """Instance norm of this rank's band of ``x``, the bands gathered."""
    with halo.spatial(mesh_mod.spatial_group(mesh)):
        return halo.all_gather_rows(InstanceNorm2d(x.shape[1])(halo.band(x, dim=2)), dim=2)


def entry_json(main, argv):
    """An entry's exit code and its last stdout line as JSON."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = main(argv)
    return code, json.loads(buf.getvalue().strip().splitlines()[-1])


def main():
    port, rank, world, workdir = sys.argv[1:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    multihost.COLLECTIVE_TIMEOUT_S = COLLECTIVE_TIMEOUT_S
    assert multihost.initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    mesh = mesh_mod.make_mesh(data=1, spatial=world, device="cpu")
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = {"fingerprint": mesh_mod.mesh_fingerprint(mesh), "backend": multihost.backend(),
           "layout": (mesh.data_index, mesh.spatial_index)}
    out["forwards"] = forwards(inputs, mesh)
    out["instance_norm"] = instance_norm(inputs["norm_input"], mesh)

    m = model("raft", inputs["variables"]["raft"])
    mesh_mod.reset_collective_stats()
    reduce, out["validation_acc"] = evaluation._reduce, []

    def recorded(acc, fwd):
        out["validation_acc"].append(reduce(acc, fwd))
        return out["validation_acc"][-1]

    evaluation._reduce = recorded
    try:
        out["validation"] = validate_synthetic(m, fwd=ShapeCachedForward(m, mesh=mesh), **VAL)
    finally:
        evaluation._reduce = reduce
    out["validation_collectives"] = mesh_mod.collective_stats()
    out["evaluate"] = entry_json(eval_entry.main, EVAL_ARGV + ["--mesh", f"1,{world}"])
    out["highres"] = entry_json(highres_forward.main, HIGHRES_ARGV + [
        "--mesh", f"1,{world}", "--save", os.path.join(workdir, "highres")])
    out["barrier"] = multihost.barrier("child_end", timeout_s=60)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    multihost.shutdown()


if __name__ == "__main__":
    main()
