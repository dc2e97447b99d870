"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run on the CPU at a small size (the
harness's look for a card skipped), with one fault planted in the
program, and reads ``correct``: for the served cells an answer altered
where it is produced, half of each batch's rows answered with the other
half's flows, and a refinement step that returns its state unchanged;
for the train cell a step that leaves the state unchanged and half of the
batch left out, the loss the mean over the rest. The same runs without a
fault come out correct. A control run holds the control's numbers to the
limits in the program's place, the program's kept beside them: on the
CPU, which has no TF32, the control is made to differ by scaling the
reference's answers while TF32 is switched on."""

import pytest
import torch

from flowbench import harness

SERVE = {"frame_hw": [44, 60], "distinct_pairs": 6, "clients": 8, "batch_sizes": [2],
         "iter_levels": [4], "warm_requests": 4, "keep_every": 1, "check_answers": 8}
TRAIN = {"crop": [48, 64], "batch": 2, "distinct_batches": 4, "iters": 3}


def _run(workload, overrides):
    outcome, result = harness.run_cell(workload, 2 ** 32 + 17, 4.0, False, device="cpu",
                                       overrides=overrides)
    return result


def _scaled(orig):
    def run(self, img1, img2, iters, tol):
        flow, ex = orig(self, img1, img2, iters, tol)
        return flow * 1.05, ex
    return run


def _half_rows(orig):
    def run(self, img1, img2, iters, tol):
        flow, ex = orig(self, img1, img2, iters, tol)
        n = flow.shape[0]
        keep = n - n // 2
        return torch.cat([flow[:keep], flow[:n - keep]]), ex
    return run


def _stuck_step(self, corr_fn, coords0, inp, net, coords1, converged=None, tol=None):
    return net, coords1, converged


@pytest.mark.parametrize("workload", ["ncup.sintel.serve12", "raft.sintel.serve12"])
@pytest.mark.parametrize("fault", [None, "altered", "half_rows", "stuck_step"])
def test_serve_faults(monkeypatch, workload, fault):
    from raft_ncup_tpu_torch.models.raft import RAFT
    from raft_ncup_tpu_torch.serving.server import FlowServer

    if fault == "altered":
        monkeypatch.setattr(FlowServer, "_run", _scaled(FlowServer._run))
    elif fault == "half_rows":
        monkeypatch.setattr(FlowServer, "_run", _half_rows(FlowServer._run))
    elif fault == "stuck_step":
        monkeypatch.setattr(RAFT, "_step", _stuck_step)
    result = _run(workload, SERVE)
    assert result["compared"]["answers_unchecked"]["value"] == 0
    assert result["correct"] is (fault is None), result["compared"]


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch"])
def test_train_faults(monkeypatch, fault):
    from raft_ncup_tpu_torch.training import step as step_mod
    from raft_ncup_tpu_torch.training.optim import Optimizer

    if fault == "unchanged":
        monkeypatch.setattr(Optimizer, "commit", lambda self, *a, **k: None)
    elif fault == "half_batch":
        orig = step_mod.forward_loss_sums

        def half(state, batch, cfg, remat=True, step=None, mesh=None):
            n = batch["image1"].shape[0] // 2
            return orig(state, {k: v[:n] for k, v in batch.items()}, cfg, remat, step, mesh)

        monkeypatch.setattr(step_mod, "forward_loss_sums", half)
    result = _run("ncup.things.train6", TRAIN)
    assert result["correct"] is (fault is None), result["compared"]


def _scaled_under_tf32(orig, scale_out):
    def wrapped(*args, **kwargs):
        out = orig(*args, **kwargs)
        return scale_out(out) if torch.backends.cuda.matmul.allow_tf32 else out
    return wrapped


@pytest.mark.parametrize("workload", ["ncup.sintel.serve12", "ncup.things.train6"])
def test_control_run_is_judged_in_the_programs_place(monkeypatch, workload):
    from flowbench.reference import model as ref_model
    from flowbench.reference import train as ref_train

    if workload == "ncup.things.train6":
        monkeypatch.setattr(ref_train, "train", _scaled_under_tf32(
            ref_train.train, lambda r: {**r, "loss": [v * 1.01 for v in r["loss"]]}))
        overrides = dict(TRAIN, control=True)
    else:
        monkeypatch.setattr(ref_model, "serve", _scaled_under_tf32(
            ref_model.serve, lambda flow: flow * 1.01))
        overrides = dict(SERVE, control=True)
    result = _run(workload, overrides)
    limits = harness.load_limits(workload)
    assert all(c["value"] <= c["limit"] for c in result["program_compared"].values())
    assert set(result["program_compared"]) == set(result["compared"])
    assert any(result["compared"][k]["value"] > lim for k, lim in limits.items())
    assert result["correct"] is False
    assert list(result)[-1] == "compared"
