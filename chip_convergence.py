"""Train the small models to convergence on the card and record it.

``python3 chip_convergence.py [--stages S,...] [--export DIR]`` runs, in
order, each stage named in ``--stages`` (default: all but ``timing``):

- ``timing``: the first 50 steps of the convergence recipe and 50 steps of
  the NCUP twin on that trunk, each stage's ms a step (scratch runs);
- ``convergence``: ``python -m raft_ncup_tpu_torch.synth_convergence``,
  small ``raft`` 4000 steps on the procedural pairs (``torch_synth_r4``);
- ``twin1``: ``python -m raft_ncup_tpu_torch.ncup_vs_bilinear --seed
  1234`` (``torch_rigid_trunk``, ``torch_rigid_ncup``, the record
  ``checkpoints/torch_ncup_vs_bilinear.json``);
- ``twin2``: the same at ``--seed 4321`` (``torch_rigid_trunk_s2``,
  ``torch_rigid_ncup_s2``, ``..._s2.json``);
- ``early_exit``: the trained NCUP twin of seed 1234 on the held-out rigid
  split 999 (64 pairs at 96x128, batch 4), at 12 iterations and through
  ``ShapeCachedForward`` with early exit at the port's default tolerance
  (0.05): executed iterations, EPE (whole, boundary band, interior) and
  pairs/s of each;
- ``save``: the two trained models, the convergence trunk and the NCUP
  twin of seed 1234, as reference ``.pth`` files beside their logs
  (``checkpoints/<run>/<run>.pth``), so later work loads trained weights
  without training again.

Every stage is resumable: a trained run is skipped, a cut one resumes
from its newest checkpoint. With ``--export DIR`` each finished stage
copies the logs, the records, the ``.pth`` files and the newest
checkpoint of every run to ``DIR`` under their paths in the repository;
copied back into place, they let a later run resume. It prints the
card's name and power limit, each stage's wall seconds and ms a step, the
held-out EPE lines and one JSON line a stage; it exits nonzero when a stage fails or a run misses its
target (convergence at least 5x below its untrained EPE; a twin whose
boundary-band interval lies wholly below 0). It needs CUDA: there is no
CPU fallback.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
STAGES = ("timing", "convergence", "twin1", "twin2", "early_exit", "save")
TWINS = {
    "twin1": dict(seed=1234, trunk="torch_rigid_trunk", ncup="torch_rigid_ncup",
                  out="torch_ncup_vs_bilinear.json"),
    "twin2": dict(seed=4321, trunk="torch_rigid_trunk_s2", ncup="torch_rigid_ncup_s2",
                  out="torch_ncup_vs_bilinear_s2.json"),
}
SYNTH_RUN = "torch_synth_r4"
EARLY_EXIT_TOL = 0.05


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0]


def run_module(module: str, argv: list) -> dict:
    """``python -m module argv`` in the repository, its output passed
    through; its last stdout line as JSON. Raises when it fails."""
    cmd = [sys.executable, "-m", module, *argv]
    print("+ " + " ".join(cmd[1:]), flush=True)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE, text=True)
    last = ""
    for line in proc.stdout:
        sys.stdout.write(line)
        if line.strip():
            last = line.strip()
    sys.stdout.flush()
    if proc.wait() != 0:
        raise RuntimeError(f"{module} exited {proc.returncode}")
    try:
        return json.loads(last)
    except ValueError:
        return {"last_line": last}


def stage_timing(ckpt_dir: str) -> dict:
    """50 steps of the convergence recipe, then 50 of the NCUP twin on its
    trunk, in scratch run directories (removed first)."""
    from raft_ncup_tpu_torch import ncup_vs_bilinear, synth_convergence

    for name in ("timing_trunk", "timing_ncup"):
        shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
    trunk = synth_convergence.run_train(
        synth_convergence.train_argv("timing_trunk", ckpt_dir, "cuda", 50))
    args = ncup_vs_bilinear.build_parser().parse_args([
        "--trunk_name", "timing_trunk", "--ncup_name", "timing_ncup", "--ncup_steps", "50",
        "--device", "cuda"])
    args.ckpt_dir = ckpt_dir
    ncup = synth_convergence.run_train(ncup_vs_bilinear.train_argv(args, "ncup"))
    return {"trunk": {k: trunk[k] for k in ("steps", "median_iteration_ms", "wall_seconds")},
            "ncup": {k: ncup[k] for k in ("steps", "median_iteration_ms", "wall_seconds")}}


def stage_convergence(ckpt_dir: str) -> dict:
    rel = os.path.relpath(ckpt_dir, REPO)
    out = run_module("raft_ncup_tpu_torch.synth_convergence",
                     ["--device", "cuda", "--ckpt_dir", rel, "--name", SYNTH_RUN])
    out["ok"] = bool(out.get("met"))
    return out


def stage_twin(ckpt_dir: str, name: str) -> dict:
    t = TWINS[name]
    rel = os.path.relpath(ckpt_dir, REPO)
    run_module("raft_ncup_tpu_torch.ncup_vs_bilinear", [
        "--device", "cuda", "--ckpt_dir", rel, "--seed", str(t["seed"]),
        "--trunk_name", t["trunk"], "--ncup_name", t["ncup"],
        "--out", os.path.join(rel, t["out"])])
    with open(os.path.join(ckpt_dir, t["out"])) as f:
        rec = json.load(f)
    bnd = rec["bootstrap_ci"]["delta_bnd"]
    return {"seed": t["seed"], "delta_bnd": bnd, "results": rec["results"],
            "trained": rec["trained"], "ok": not bnd["ci_hi"] < 0.0}


def stage_early_exit(ckpt_dir: str) -> dict:
    """The trained NCUP twin (seed 1234) on held-out split 999 at 12
    iterations, without and with early exit: mean executed iterations, the
    boundary-band EPE metrics and pairs/s (the forwards after one warm-up
    batch, the results read back after the last)."""
    import numpy as np
    import torch

    from raft_ncup_tpu_torch.data.synthetic import SyntheticFlowDataset, flow_boundary_mask
    from raft_ncup_tpu_torch.inference import metrics as metrics_mod
    from raft_ncup_tpu_torch.inference.pipeline import ShapeCachedForward
    from raft_ncup_tpu_torch.models.raft import RAFT
    from raft_ncup_tpu_torch.training.checkpoint import load_model_weights, saved_model_config

    run_dir = os.path.join(ckpt_dir, TWINS["twin1"]["ncup"])
    model = load_model_weights(RAFT(saved_model_config(run_dir), device="cuda"), run_dir)
    ds = SyntheticFlowDataset((96, 128), length=64, seed=999, style="rigid")
    samples = [ds.sample(i) for i in range(len(ds))]
    batches = []
    for i in range(0, len(samples), 4):
        group = samples[i:i + 4]
        batches.append({
            "image1": np.stack([np.asarray(s["image1"]) for s in group]).astype(np.float32),
            "image2": np.stack([np.asarray(s["image2"]) for s in group]).astype(np.float32),
            "flow": torch.stack([s["flow"] for s in group]).cuda(),
            "band": torch.from_numpy(np.stack([flow_boundary_mask(s["flow"]) for s in group])
                                     .astype(np.float32)).cuda(),
        })
    fwd = ShapeCachedForward(model)
    out = {"model": run_dir, "pairs": len(samples), "iters": 12, "tol": EARLY_EXIT_TOL}
    for mode, tol in (("full", None), ("early_exit", EARLY_EXIT_TOL)):
        fwd.forward(batches[0]["image1"], batches[0]["image2"], 12, early_exit_tol=tol)
        torch.cuda.synchronize()
        acc = metrics_mod.init_acc("epe_band", "cuda")
        execs = []
        t0 = time.perf_counter()
        for b in batches:
            res = fwd.forward(b["image1"], b["image2"], 12, early_exit_tol=tol)
            acc = metrics_mod.accumulate("epe_band", acc, res[1], b["flow"], band=b["band"])
            execs.append(res[2] if tol is not None else torch.full((4,), 12, device="cuda"))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        sums = acc.cpu().numpy()
        out[mode] = {
            "exec_iters_mean": float(torch.cat(execs).float().mean()),
            "epe": float(sums[0] / sums[1]), "epe_bnd": float(sums[2] / sums[3]),
            "epe_interior": float(sums[4] / sums[5]), "pairs_per_s": len(samples) / seconds,
        }
        print(f"early exit {mode}: " + json.dumps(out[mode]), flush=True)
    out["ok"] = True
    return out


def stage_save(ckpt_dir: str) -> dict:
    from raft_ncup_tpu_torch.models.raft import RAFT
    from raft_ncup_tpu_torch.training.checkpoint import (
        load_model_weights,
        save_reference_pth,
        saved_model_config,
    )

    out = {}
    for run in (SYNTH_RUN, TWINS["twin1"]["ncup"]):
        run_dir = os.path.join(ckpt_dir, run)
        model = load_model_weights(RAFT(saved_model_config(run_dir), device="cpu"), run_dir)
        path = save_reference_pth(model, os.path.join(run_dir, f"{run}.pth"))
        out[run] = {"path": os.path.relpath(path, REPO), "bytes": os.path.getsize(path)}
    out["ok"] = True
    return out


def export(ckpt_dir: str, dest: str) -> None:
    """Copy the logs, the records, the ``.pth`` files and each run's newest
    checkpoint to ``dest``, under their paths in the repository."""
    from raft_ncup_tpu_torch.training.checkpoint import CheckpointManager

    files = glob.glob(os.path.join(ckpt_dir, "torch_*", "log.txt"))
    files += glob.glob(os.path.join(ckpt_dir, "torch_*", "*.pth"))
    files += glob.glob(os.path.join(ckpt_dir, "torch_*", "resume_meta.json"))
    files += glob.glob(os.path.join(ckpt_dir, "torch_*.json"))
    for run_dir in glob.glob(os.path.join(ckpt_dir, "torch_*", "")):
        mgr = CheckpointManager(run_dir)
        if mgr.latest_step is not None:
            files.append(mgr.path(mgr.latest_step))
    for f in files:
        target = os.path.join(dest, os.path.relpath(f, REPO))
        os.makedirs(os.path.dirname(target), exist_ok=True)
        shutil.copy2(f, target)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--stages", default=",".join(STAGES[1:]),
                   help=f"comma-joined stages, run in this order: {', '.join(STAGES)}")
    p.add_argument("--ckpt_dir", default="checkpoints")
    p.add_argument("--export", default=None, metavar="DIR",
                   help="copy each finished stage's outputs here")
    a = p.parse_args(argv)
    stages = [s for s in a.stages.split(",") if s]
    unknown = sorted(set(stages) - set(STAGES))
    if unknown:
        p.error(f"unknown stages {unknown}")
    import torch

    if not torch.cuda.is_available():
        print("chip_convergence: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "raft_ncup_tpu_torch")):
        print("chip_convergence: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    print(card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    ckpt_dir = os.path.join(REPO, a.ckpt_dir)
    run = {"timing": stage_timing, "convergence": stage_convergence,
           "twin1": lambda d: stage_twin(d, "twin1"), "twin2": lambda d: stage_twin(d, "twin2"),
           "early_exit": stage_early_exit, "save": stage_save}
    ok = True
    for name in [s for s in STAGES if s in stages]:
        t0 = time.perf_counter()
        try:
            out = run[name](ckpt_dir)
        except Exception as e:  # a failed stage fails the run; the next ones still try
            out = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        out["stage"], out["seconds"] = name, time.perf_counter() - t0
        ok = ok and out.get("ok", True)
        print("stage: " + json.dumps(out), flush=True)
        if a.export:
            export(ckpt_dir, os.path.join(REPO, a.export))
    print(json.dumps({"ok": ok, "stages": stages}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
