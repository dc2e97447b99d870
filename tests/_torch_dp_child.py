"""One rank of the two-rank gloo world of ``tests/test_torch_data_parallel.py``.

``python tests/_torch_dp_child.py PORT RANK WORLD WORKDIR``: joins the world
at ``127.0.0.1:PORT`` with explicit arguments, reads the global batch from
``WORKDIR/inputs.npz``, runs every task on the CPU and saves what each
produced to ``WORKDIR/rank<RANK>.pt``. Imports torch and the port only.
"""

import os
import signal
import sys
import time

import numpy as np
import torch

from raft_ncup_tpu_torch import train as train_entry
from raft_ncup_tpu_torch.config import TrainConfig, small_model_config
from raft_ncup_tpu_torch.evaluation import validate_synthetic
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.nn.extractor import channel_dropout
from raft_ncup_tpu_torch.parallel import mesh as mesh_mod
from raft_ncup_tpu_torch.parallel import multihost
from raft_ncup_tpu_torch.resilience import PreemptionHandler
from raft_ncup_tpu_torch.resilience import preemption
from raft_ncup_tpu_torch.training import checkpoint
from raft_ncup_tpu_torch.training import step as step_mod
from raft_ncup_tpu_torch.training.state import state_for

# Shared with the test (which imports this module for them).
H, W = 16, 32
ITERS = 1
VAL = dict(size_hw=(32, 48), length=5, iters=2, batch_size=2)
PREEMPT_SIGNAL_STEP = 3  # rank 1 signals itself after this step of the poll loop
PREEMPT_CHECK_EVERY = 2
COLLECTIVE_TIMEOUT_S = 120.0  # a hung collective fails well inside the test's own limit


def model_cfg():
    return small_model_config("raft_nc_dbl", dataset="sintel")


def train_cfg(batch_size):
    return TrainConfig(stage="chairs", batch_size=batch_size, image_size=(H, W), iters=ITERS,
                       num_steps=10)


def step_outputs(state, batch, cfg, mesh):
    """One train step: the loss, the reduced gradients it applied, the
    metrics, the parameters and BatchNorm statistics after it."""
    seen = {}
    apply_update = step_mod.apply_update

    def capture(state_, loss, grads, bn_old, cfg_):
        seen["loss"], seen["grads"] = loss.clone(), [g.clone() for g in grads]
        return apply_update(state_, loss, grads, bn_old, cfg_)

    step_mod.apply_update = capture
    try:
        metrics = step_mod.make_train_step(cfg, mesh=mesh)(state, batch)
    finally:
        step_mod.apply_update = apply_update
    names = [n for n, _ in state.named_params]
    return {
        "loss": seen["loss"], "grads": dict(zip(names, seen["grads"])),
        "metrics": {k: v.clone() for k, v in metrics.items()},
        "after": {k: v.clone() for k, v in state.model.state_dict().items()},
    }


def draws(mesh, local_b):
    """The noise of both frames and a dropout mask of a rank's rows."""
    gen = step_mod.step_generators(7, 3, "cpu")[0]
    zeros = torch.zeros((local_b, H, W, 3))
    n1, n2 = step_mod.add_noise(zeros + 128.0, zeros + 128.0, gen, mesh)
    drop = torch.Generator().manual_seed(5)
    ones = torch.ones((2 * local_b, 6, 2, 2))
    rows = None if mesh is None else (mesh.rank, mesh.data, 2)
    return {"noise1": n1, "noise2": n2, "dropout": channel_dropout(ones, 0.5, drop, rows)}


def preemption_poll(rank):
    """The first step of a 10-step poll loop at which the ranks agree to
    stop; rank 1 signals itself after step ``PREEMPT_SIGNAL_STEP``."""
    with PreemptionHandler(check_every=PREEMPT_CHECK_EVERY) as handler:
        for step in range(10):
            if handler.poll(step):
                return step
            if rank == 1 and step == PREEMPT_SIGNAL_STEP:
                os.kill(os.getpid(), signal.SIGTERM)
    return None


def late_after_the_stop(directory, seen):
    """``PreemptionHandler.poll`` that, once the ranks agree to stop,
    returns only after rank 0 has written that step's checkpoint: the
    order in which a rank that read the directory to decide on its save
    would skip the save that rank 0 waits for. ``seen`` records the steps
    it waited for."""
    poll = PreemptionHandler.poll

    def late(self, step):
        stop = poll(self, step)
        if stop:
            path = os.path.join(directory, f"step_{step}.pt")
            limit = time.monotonic() + 60
            while not os.path.exists(path) and time.monotonic() < limit:
                time.sleep(0.01)
            seen.append((step, os.path.exists(path)))
        return stop

    return poll, late


def train_entry_run(workdir, extra, late_seen=None):
    """The train entry in this world: its exit code and how many
    checkpoints this process wrote. With ``late_seen`` (a list), this rank
    reaches the save after a stop only once rank 0 has written it."""
    calls = []
    save = checkpoint.save

    def counting(*a, **kw):
        calls.append(1)
        return save(*a, **kw)

    checkpoint.save = counting
    if late_seen is not None:
        poll, PreemptionHandler.poll = late_after_the_stop(
            os.path.join(workdir, "ck", "run"), late_seen)
    try:
        status = train_entry.main([
            "--device", "cpu", "--name", "run", "--stage", "chairs", "--model", "raft",
            "--small", "--synthetic_ok", "--batch_size", "4", "--image_size", str(H), str(W),
            "--iters", str(ITERS), "--num_workers", "1", "--sum_freq", "1",
            "--checkpoint_dir", os.path.join(workdir, "ck"), *extra])
    finally:
        checkpoint.save = save
        if late_seen is not None:
            PreemptionHandler.poll = poll
    return status, len(calls)


def main():
    port, rank, world, workdir = sys.argv[1:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    multihost.COLLECTIVE_TIMEOUT_S = COLLECTIVE_TIMEOUT_S
    assert multihost.initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    mesh = mesh_mod.make_mesh(device="cpu")
    inputs = dict(np.load(os.path.join(workdir, "inputs.npz")))
    batch = {k: torch.from_numpy(v) for k, v in mesh_mod.shard_batch(inputs, mesh).items()}
    out = {"backend": multihost.backend(), "fingerprint": mesh_mod.mesh_fingerprint(mesh)}

    mesh_mod.reset_collective_stats()
    state = state_for(RAFT(model_cfg(), device="cpu", seed=0), train_cfg(4))
    out["step"] = step_outputs(state, batch, train_cfg(4), mesh)
    out["step_collectives"] = mesh_mod.collective_stats()
    out["draws"] = draws(mesh, 4 // world)

    model = RAFT(model_cfg(), device="cpu", seed=0)
    out["validation"] = validate_synthetic(model, **VAL)
    eval_step = step_mod.make_eval_step(model, iters=2, mesh=mesh)
    out["eval_step"] = eval_step(batch["image1"], batch["image2"])

    out["poll_stop"] = preemption_poll(rank)
    preemption.CHECK_EVERY = 1  # the entry's ranks agree at every step
    out["late_seen"] = [] if rank == 1 else None
    out["entry_preempted"] = train_entry_run(
        workdir, ["--num_steps", "4", "--chaos", "sigterm@2", "--chaos_rank", "1"],
        out["late_seen"])
    out["entry_resumed"] = train_entry_run(
        workdir, ["--num_steps", "4", "--restore_ckpt", os.path.join(workdir, "ck", "run")])
    out["barrier"] = multihost.barrier("child_end", timeout_s=60)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    multihost.shutdown()


if __name__ == "__main__":
    main()
