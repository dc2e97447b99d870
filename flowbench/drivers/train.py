"""Training driver: the program's train step (``training.step.
make_train_step``, remat on as the train entry runs it, the sentinel on)
on one card, fed ``distinct_batches`` batches of frames, flow and valid
masks made on the card from the seed and cycled.

Set-up builds the train state once and drives it through its first
``checked_steps`` steps, on batches 0, 1, 2, with the window's own step
and feed; the window then goes on with the same object, from batch 3,
until ``seconds`` have passed, and waits for the card.

End-to-end: pairs trained (batch x steps) over the window, the window
ending when the card has finished its last step; the peak of reserved
device memory over the window (``common.reset_peak``); set-up.

``correct``: once the window has closed and the program is freed, the
plain reference trains the same weights on the same first batches. Held
to the cell's limits: each checked step's loss (relative gap), the norm
of each tensor's first gradient as the optimizer took it (after the
clip; read from the first moment after one step), and the norm of each
tensor's change over the checked steps. The two norms are compared leaf
by leaf as the gap of the program's norm to the reference's over the
larger of the reference's and the median leaf's; a leaf whose reference
gradient is under a thousandth of the median leaf's moves by round-off
alone and is left out of the change. With the mix's ``control`` the
reference in TF32 trains in the program's place and its numbers are the
ones held to the limits (the run should come out not correct); the
program's own are kept beside them.
"""

from __future__ import annotations

import statistics
import time

import torch

from flowbench import harness, work
from flowbench import trace as tracing
from flowbench.drivers import common
from flowbench.reference import model as ref
from flowbench.reference import train as ref_train
from flowbench.traffic import make_pairs
from flowbench.weights import make_weights

B1 = 0.9
ROUNDOFF = 1e-3  # leaves below this share of the median gradient norm


def train_config(mix: dict):
    from raft_ncup_tpu_torch.config import TrainConfig

    return TrainConfig(stage=mix["stage"], lr=mix["lr"], num_steps=int(mix["num_steps"]),
                       batch_size=int(mix["batch"]), image_size=tuple(mix["crop"]),
                       iters=int(mix["iters"]), wdecay=mix["wdecay"], epsilon=mix["epsilon"],
                       clip=mix["clip"], gamma=mix["gamma"], max_flow=mix["max_flow"],
                       optimizer=mix["optimizer"], scheduler=mix["scheduler"],
                       add_noise=bool(mix["add_noise"]), precision="f32",
                       anomaly_sentinel=True)


def make_batches(cell, device) -> list:
    mix = cell.mix
    n, b = int(mix["distinct_batches"]), int(mix["batch"])
    pairs = make_pairs(cell.seed, n * b, tuple(mix["crop"]), device)
    return [{k: v[i * b:(i + 1) * b] for k, v in pairs.items()} for i in range(n)]


def leaf_gap(prog: dict, want: dict, names: list) -> float:
    """The worst leaf's |prog - want| over max(want, the median of want)."""
    floor = statistics.median(want[k] for k in names)
    return max(abs(prog[k] - want[k]) / max(want[k], floor, 1e-30) for k in names)


def compare(program: dict, reference: dict) -> dict:
    """The three numbers ``correct`` reads, from the program's and the
    reference's readings of the same steps."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(program["loss"], reference["loss"]))
    names = sorted(reference["grad_norm"])
    grad = leaf_gap(program["clipped_norm"], reference["clipped_norm"], names)
    gmed = statistics.median(reference["grad_norm"][k] for k in names)
    moved = [k for k in names if reference["grad_norm"][k] >= ROUNDOFF * gmed]
    change = leaf_gap(program["change_norm"], reference["change_norm"], moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
            "left_out": len(names) - len(moved)}


def program_readings(losses, mu1, p3, named, weights) -> dict:
    out = {"loss": [float(v) for v in losses], "clipped_norm": {}, "change_norm": {}}
    for (name, _), m, p in zip(named, mu1, p3):
        out["clipped_norm"][name] = float(m.double().norm()) / (1 - B1)
        out["change_norm"][name] = float((p.double() - weights[name].double()).norm())
    return out


def run(cell) -> harness.Outcome:
    from raft_ncup_tpu_torch.training.state import state_for
    from raft_ncup_tpu_torch.training.step import make_train_step

    device = common.device_of(cell)
    mix, cfg = cell.mix, cell.config
    checked = int(mix["checked_steps"])
    weights = make_weights(ref.param_spec(cfg), cell.seed, device)
    model = common.port_model(cfg, weights, device)
    tcfg = train_config(mix)
    state = state_for(model, tcfg)
    step = make_train_step(tcfg)
    batches = make_batches(cell, device)
    losses, mu1, p3 = [], None, None
    for i in range(checked):
        metrics = step(state, batches[i])
        losses.append(metrics["loss"])
        if i == 0:
            mu1 = [t.detach().clone() for t in state.optimizer.mu]
    named = state.named_params
    p3 = [p.detach().clone() for _, p in named]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.monotonic() - cell.started_s
    common.reset_peak(device)
    steps = 0
    with tracing.Trace(cell.trace) as tr:
        t0 = time.monotonic()
        while time.monotonic() - t0 < cell.seconds:
            with tracing.label("flowbench.train_step"):
                step(state, batches[(checked + steps) % len(batches)])
            steps += 1
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.monotonic()
    peak = common.peak_bytes(device)
    program = program_readings(losses, mu1, p3, named, weights)
    del state, model, step, named, mu1, p3, metrics, losses
    common.free(device)
    coords: list = []
    with common.reference_precision(False):
        reference = ref_train.train(weights, cfg, mix, batches[:checked], checked,
                                    on_coords=coords.append if cell.trace else None)
    found = compare(program, reference)
    context = {"kind": "train", "config": cfg, "mix": mix, "steps": steps,
               "trace": tr, "device": device, "readings": found}
    if cell.trace and coords:
        context["lookup_bwd_iter_work"] = [
            work.lookup_bwd_work(c, cfg["corr_levels"], cfg["corr_radius"], cfg["fnet_dim"])
            for c in coords]
    e2e = {"train_pairs_per_s": steps * int(mix["batch"]) / (t1 - t0),
           "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    checks = [(k, found[k], cell.limits[k]) for k in ("loss_gap", "grad_gap", "change_gap")]
    program_checks = None
    if mix.get("control"):
        with common.reference_precision(True):
            lower = compare(ref_train.train(weights, cfg, mix, batches[:checked], checked),
                            reference)
        program_checks, checks = checks, [(k, lower[k], lim) for k, _, lim in checks]
    info = common.device_info(device, int(cell.workload["chips"]), peak)
    if cell.trace:
        info["busy_s"] = tracing.busy_s(tr.ops)
        info["window_s"] = tr.window_s
    return harness.Outcome(attempted=steps + checked, failed=0, e2e=e2e, context=context,
                           checks=checks, device=info,
                           breakdown=tracing.breakdown(tr.ops, tr.host) if cell.trace else None,
                           program_checks=program_checks)
