"""One rank of an S-rank gloo world of ``tests/test_torch_pipe_axis.py``.

``python tests/_torch_pipe_child.py PORT RANK WORLD WORKDIR``: joins the
world at ``127.0.0.1:PORT`` with explicit arguments, builds the mesh
``(data=1, spatial=1, pipe=WORLD)``, reads the micro-batches and each
model's carried JAX variables from ``WORKDIR/inputs.pt``, runs every case
of this world's size on the CPU and saves what each produced to
``WORKDIR/rank<RANK>.pt``. Imports torch and the port only.
"""

import contextlib
import io
import json
import os
import sys

import torch

from raft_ncup_tpu_torch import evaluate as eval_entry
from raft_ncup_tpu_torch import serve as serve_entry
from raft_ncup_tpu_torch.analysis import guards
from raft_ncup_tpu_torch.config import ServeConfig, small_model_config
from raft_ncup_tpu_torch.inference import pipe_schedule
from raft_ncup_tpu_torch.inference.costs import CostLedger
from raft_ncup_tpu_torch.models import raft as raft_mod
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.ops import nconv as nconv_mod
from raft_ncup_tpu_torch.parallel import mesh as mesh_mod
from raft_ncup_tpu_torch.parallel import multihost
from raft_ncup_tpu_torch.serving.server import FlowServer
from raft_ncup_tpu_torch.utils.jax_weights import load_jax_variables

# Shared with the test (which imports this module for them): JAX's
# tests/test_pipe_schedule.py sizes.
HW, ITERS, PAIRS = (32, 32), 4, 3
MODELS = {"raft": "chairs", "raft_nc_dbl": "chairs"}
# (variant, precision preset) per world size.
CASES = {2: (("raft", "f32"), ("raft_nc_dbl", "f32"), ("raft", "bf16_infer"),
             ("raft_nc_dbl", "bf16_infer")),
         4: (("raft", "f32"),)}
EARLY_EXIT_TOL = 0.074  # splits the seeded pairs: 1, 2 and 1 iterations alone
SERVE_ARGV = ["--device", "cpu", "--model", "raft", "--small", "--size", "32", "48",
              "--num_requests", "4", "--iter_levels", "4,2", "--serve_batch_sizes", "1,2",
              "--queue_capacity", "16", "--seed", "3"]
EVAL_ARGV = ["--dataset", "synthetic", "--device", "cpu", "--model", "raft", "--small",
             "--iters", "2", "--batch_size", "2", "--num_workers", "1"]
COLLECTIVE_TIMEOUT_S = 120.0


def model_cfg(variant):
    return small_model_config(variant, dataset=MODELS[variant], corr_impl="pallas",
                              nconv_impl="pallas")


def model(variant, variables):
    return load_jax_variables(RAFT(model_cfg(variant), device="cpu", seed=1), variables)


@contextlib.contextmanager
def counted_kernels():
    """Calls of the two forward kernels' wrappers (on the CPU they run
    their plain versions and count no launch) while inside."""
    counts = {"corr_lookup": 0, "nconv": 0}
    lookup, fused = raft_mod.lookup_levels, nconv_mod.nconv2d_fused

    def lookup_counted(*a, **kw):
        counts["corr_lookup"] += 1
        return lookup(*a, **kw)

    def fused_counted(*a, **kw):
        counts["nconv"] += 1
        return fused(*a, **kw)

    raft_mod.lookup_levels, nconv_mod.nconv2d_fused = lookup_counted, fused_counted
    try:
        yield counts
    finally:
        raft_mod.lookup_levels, nconv_mod.nconv2d_fused = lookup, fused


def stream(pf, pairs, **kw):
    """One stream through ``pf``: its outputs, this rank's counts."""
    mesh_mod.reset_collective_stats()
    before = dict(pf.stats)
    with counted_kernels() as calls:
        outs = pf.forward_many(pairs, ITERS, **kw)
    return {"outs": [tuple(t.clone() for t in o) for o in outs], "calls": calls,
            "collectives": mesh_mod.collective_stats(),
            "outputs": pipe_schedule.output_stats(),
            "stats": {k: pf.stats[k] - before[k] for k in before}}


def cases(inputs, mesh, world):
    out = {}
    pairs = inputs["pairs"]
    for variant, precision in CASES[world]:
        m = model(variant, inputs["variables"][variant])
        pf = pipe_schedule.PipelinedForward(m, mesh=mesh, cost_ledger=CostLedger())
        out[(variant, precision)] = stream(pf, pairs, policy=precision)
        if (variant, precision) == ("raft", "f32"):
            out["early_exit"] = stream(pf, pairs, early_exit_tol=EARLY_EXIT_TOL)
            out["steady"] = steady(pf, pairs)
            entry = pf.cache.costs.lookup(kind="pipe_segment", segments=world)
            out["ledger"] = {"segment": entry,
                             "encode": pf.cache.costs.lookup(kind="pipe_encode"),
                             "finalize": pf.cache.costs.lookup(kind="pipe_finalize")}
            out["keys"] = [str(k) for k in pf.cache._entries]
    return out


def steady(pf, pairs):
    """A second stream of the same shape under the runtime guards: its
    captures, implicit transfers, hits and the receive buffers."""
    key = next(k for k in pf._inputs)
    ptrs = [t.data_ptr() for t in pf._inputs[key]]
    compiles, hits = pf.cache.stats["compiles"], pf.cache.stats["hits"]
    with guards.RecompileWatchdog() as wd, guards.forbid_host_transfers() as st:
        pf.forward_many(pairs, ITERS)
    return {"recompiles": wd.count, "host_transfers": st.host_transfers,
            "compiles": pf.cache.stats["compiles"] - compiles,
            "hits": pf.cache.stats["hits"] - hits,
            "same_buffers": [t.data_ptr() for t in pf._inputs[key]] == ptrs,
            "buffer_keys": len(pf._inputs)}


def entry_json(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = main(argv)
    return code, json.loads(buf.getvalue().strip().splitlines()[-1])


def entries(inputs, world):
    """The serve entry and the evaluate entry over the mesh (1, 1, 2), and
    a server whose levels do not split into the segments."""
    out = {}
    rc, report, responses, _ = serve_entry.run(SERVE_ARGV + ["--mesh", f"1,1,{world}"])
    out["serve"] = {"rc": rc, "mesh": report.get("mesh"),
                    "completed": report.get("completed"),
                    "flows": [r.flow for r in responses if getattr(r, "flow", None) is not None]}
    out["evaluate"] = entry_json(eval_entry.main, EVAL_ARGV + ["--mesh", f"1,1,{world}"])
    try:
        FlowServer(model("raft", inputs["variables"]["raft"]),
                   ServeConfig(mesh=(1, 1, world), iter_levels=(3, 1)))
        out["bad_levels"] = None
    except ValueError as e:
        out["bad_levels"] = str(e)
    return out


def main():
    port, rank, world, workdir = sys.argv[1:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    multihost.COLLECTIVE_TIMEOUT_S = COLLECTIVE_TIMEOUT_S
    assert multihost.initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    mesh = mesh_mod.make_mesh(data=1, spatial=1, pipe=world, device="cpu")
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = {"fingerprint": mesh_mod.mesh_fingerprint(mesh), "backend": multihost.backend(),
           "layout": (mesh.data_index, mesh.spatial_index, mesh.pipe_index)}
    out["cases"] = cases(inputs, mesh, world)
    if world == 2:
        out["entries"] = entries(inputs, world)
    out["barrier"] = multihost.barrier("child_end", timeout_s=60)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    multihost.shutdown()


if __name__ == "__main__":
    main()
