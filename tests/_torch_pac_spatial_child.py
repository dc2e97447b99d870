"""One rank of the two-rank gloo worlds of ``tests/test_torch_pac_spatial.py``
(``forward``), ``tests/test_torch_pac_spatial_train.py`` (``train``) and
``tests/test_torch_bf16_spatial.py`` (``bf16``).

``python tests/_torch_pac_spatial_child.py PORT RANK WORLD WORKDIR MODE``:
joins the world at ``127.0.0.1:PORT`` with explicit arguments, builds the
mesh ``(data=1, spatial=2)``, reads the inputs and each model's carried JAX
variables from ``WORKDIR/inputs.pt``, runs the tasks of ``MODE`` on the CPU
and saves what each produced to ``WORKDIR/rank<RANK>.pt``. Imports torch and
the port only.
"""

import contextlib
import io
import json
import os
import sys

import torch

from raft_ncup_tpu_torch import evaluate as eval_entry
from raft_ncup_tpu_torch import highres_forward
from raft_ncup_tpu_torch import serve as serve_entry
from raft_ncup_tpu_torch.config import ModelConfig, TrainConfig, UpsamplerConfig
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.parallel import mesh as mesh_mod
from raft_ncup_tpu_torch.parallel import multihost
from raft_ncup_tpu_torch.training import step as step_mod
from raft_ncup_tpu_torch.training.state import state_for
from raft_ncup_tpu_torch.utils.jax_weights import load_jax_variables

# Shared with the tests (which import this module for them).
HEADS = ("pac", "djif")
H, W, ITERS = 64, 96, 3  # the test-mode forwards
TRAIN_HW, TRAIN_BATCH, TRAIN_ITERS = (64, 64), 2, 2  # the train steps
BF16_TRAIN_STAGE = "things"  # BatchNorm frozen, as the flagship trains past chairs
HIGHRES_ARGV = ["--device", "cpu", "--size", "48", "64", "--iters", "2", "--small",
                "--final_upsampling", "PacJointUpsampleFull"]
EVAL_ARGV = ["--dataset", "synthetic", "--device", "cpu", "--model", "raft_nc_dbl", "--small",
             "--final_upsampling", "DjifOriginal", "--iters", "2", "--batch_size", "2",
             "--num_workers", "1"]
SERVE_ARGV = {  # the serve entry with a head, and the flagship under bf16_infer
    "pac": ["--device", "cpu", "--model", "raft_nc_dbl", "--small", "--final_upsampling",
            "PacJointUpsampleFull", "--size", str(H), str(W), "--iter_levels", "2",
            "--serve_batch_sizes", "1,2", "--num_requests", "3", "--flight_dir", ""],
    "bf16_infer": ["--device", "cpu", "--model", "raft_nc_dbl", "--size", str(H), str(W),
                   "--iter_levels", "2", "--serve_batch_sizes", "2", "--num_requests", "2",
                   "--serve_precision", "bf16_infer", "--flight_dir", ""],
}
COLLECTIVE_TIMEOUT_S = 120.0  # a hung collective fails well inside the test's own limit


def head_cfg(kind: str, dataset: str = "sintel") -> ModelConfig:
    """The small ``raft_nc_dbl`` with the ``kind`` head."""
    return ModelConfig(variant="raft_nc_dbl", small=True, corr_impl="pallas",
                       nconv_impl="pallas", dataset=dataset,
                       upsampler=UpsamplerConfig(kind=kind))


def flagship_cfg(precision: str, dataset: str = "sintel") -> ModelConfig:
    return ModelConfig(dataset=dataset, corr_impl="pallas", nconv_impl="pallas",
                       precision=precision)


def train_cfg(stage: str, precision: str = "f32") -> TrainConfig:
    return TrainConfig(stage=stage, lr=1e-4, num_steps=50, batch_size=TRAIN_BATCH,
                       image_size=TRAIN_HW, iters=TRAIN_ITERS, precision=precision)


def carried(cfg: ModelConfig, variables) -> RAFT:
    return load_jax_variables(RAFT(cfg, device="cpu", seed=1), variables)


def entry_json(main, argv):
    """An entry's exit code and its last stdout line as JSON."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = main(argv)
    return code, json.loads(buf.getvalue().strip().splitlines()[-1])


def served(argv):
    """The serve entry's exit code, report and answers (status, flow)."""
    with contextlib.redirect_stdout(io.StringIO()):
        rc, report, responses, _ = serve_entry.run(argv)
    return rc, report, [(r.status, r.flow) for r in responses]


def forward_tasks(inputs, mesh, workdir):
    out = {}
    for kind in HEADS:
        m = carried(head_cfg(kind), inputs["variables"][kind])
        mesh_mod.reset_collective_stats()
        flow_lr, flow_up = m(inputs["image1"], inputs["image2"], iters=ITERS, mesh=mesh)
        out[kind] = {"flow_lr": flow_lr, "flow_up": flow_up,
                     "collectives": mesh_mod.collective_stats()}
    out["highres"] = entry_json(highres_forward.main, HIGHRES_ARGV + [
        "--mesh", "1,2", "--save", os.path.join(workdir, "highres")])
    out["evaluate"] = entry_json(eval_entry.main, EVAL_ARGV + ["--mesh", "1,2"])
    out["serve"] = served(SERVE_ARGV["pac"] + ["--mesh", "1,2"])
    return out


def step_outputs(cfg: ModelConfig, variables, tcfg: TrainConfig, batch, mesh):
    """One train step from the carried weights: the loss, the reduced
    gradients it applied, the metrics and the collectives it issued."""
    state = state_for(carried(cfg, variables), tcfg)
    seen = {}
    apply_update = step_mod.apply_update

    def capture(state_, loss, grads, bn_old, cfg_):
        seen["loss"], seen["grads"] = loss.clone(), [g.clone() for g in grads]
        return apply_update(state_, loss, grads, bn_old, cfg_)

    step_mod.apply_update = capture
    mesh_mod.reset_collective_stats()
    try:
        metrics = step_mod.make_train_step(tcfg, mesh=mesh)(state, batch)
    finally:
        step_mod.apply_update = apply_update
    names = [n for n, _ in state.named_params]
    return {"loss": seen["loss"], "grads": dict(zip(names, seen["grads"])),
            "metrics": {k: v.clone() for k, v in metrics.items()},
            "collectives": mesh_mod.collective_stats()}


def train_tasks(inputs, mesh, workdir):
    return {kind: step_outputs(head_cfg(kind, "chairs"), inputs["variables"][kind],
                               train_cfg("chairs"), inputs["batch"], mesh)
            for kind in HEADS}


def bf16_tasks(inputs, mesh, workdir):
    """The flagship's bf16 presets on the mesh: the test-mode forward under
    ``bf16_infer`` from the carried f32 weights, the serve entry under
    ``--serve_precision bf16_infer``, and one ``bf16_train`` step."""
    m = carried(flagship_cfg("bf16_infer"), inputs["variables"]["flagship"])
    out = {"bf16_infer": dict(zip(("flow_lr", "flow_up"), m(
        inputs["image1"], inputs["image2"], iters=ITERS, mesh=mesh)))}
    out["serve"] = served(SERVE_ARGV["bf16_infer"] + ["--mesh", "1,2"])
    out["bf16_train"] = step_outputs(
        flagship_cfg("bf16_train", BF16_TRAIN_STAGE), inputs["variables"]["train"],
        train_cfg(BF16_TRAIN_STAGE, "bf16_train"), inputs["batch"], mesh)
    return out


def main():
    port, rank, world, workdir, mode = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    multihost.COLLECTIVE_TIMEOUT_S = COLLECTIVE_TIMEOUT_S
    assert multihost.initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    mesh = mesh_mod.make_mesh(data=1, spatial=world, device="cpu")
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = {"fingerprint": mesh_mod.mesh_fingerprint(mesh),
           "layout": (mesh.data_index, mesh.spatial_index)}
    tasks = {"forward": forward_tasks, "train": train_tasks, "bf16": bf16_tasks}[mode]
    out.update(tasks(inputs, mesh, workdir))
    out["barrier"] = multihost.barrier("child_end", timeout_s=60)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    multihost.shutdown()


if __name__ == "__main__":
    main()
