"""The synthetic convergence run of the small model:
``python -m raft_ncup_tpu_torch.synth_convergence``.

The counterpart of the JAX package's ``scripts/synth_convergence.sh``: a
data-free training run that shows the trainer *learns*, not just that it
runs. Small ``raft`` trains on the procedural pairs at the chairs
recipe (AdamW, OneCycle over 4000 + 100 steps, lr 4e-4, weight decay
1e-5, a 64x96 crop, batch 2, 4 GRU iterations) through the train entry
(``python -m raft_ncup_tpu_torch.train``, one child process, with the
script's flags unchanged and ``--device`` in place of ``--platform``),
and validates on the held-out procedural split every 200 steps
(``evaluation.validate_synthetic``: 96x128, batch 4, 12 iterations, split
seed 999). Before training, the untrained model (the train entry's seeded
weights) is validated once at the same settings and logged as ``[val @
0]``, the first row of the curve. The target is the JAX run's: the
held-out EPE at the last step at least 5x below ``[val @ 0]``.

The run is resumable: a run directory that holds the last step's
checkpoint is skipped, and one that holds an earlier step resumes from it
(``--restore_ckpt``; the schedule spans the same ``num_steps``, so the
resumed run equals an uninterrupted one). It runs on the card unless
``--device cpu`` is given. The last stdout line is JSON: the curve, the
ratio and whether the target was met.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from typing import Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_NAME = "torch_synth_r4"
TARGET_RATIO = 5.0
_VAL_LINE = re.compile(r"^\[val @ (\d+)\] (\{.*\})$")


def train_argv(name: str, ckpt_dir: str, device: str, num_steps: int = 4000) -> list[str]:
    """The train entry's flags: ``scripts/synth_convergence.sh``'s, with
    ``--device`` for ``--platform``."""
    return [
        "--name", name, "--stage", "chairs", "--model", "raft", "--small", "--synthetic_ok",
        "--device", device, "--num_steps", str(num_steps), "--image_size", "64", "96",
        "--batch_size", "2", "--iters", "4", "--lr", "4e-4", "--wdecay", "1e-5",
        "--val_freq", "200", "--sum_freq", "50", "--validation", "synthetic",
        "--checkpoint_dir", ckpt_dir,
    ]


def latest_step(run_dir: str) -> Optional[int]:
    """The newest saved step of a run directory (``CheckpointManager``'s
    layout), None without one."""
    from raft_ncup_tpu_torch.training.checkpoint import CheckpointManager

    return CheckpointManager(run_dir).latest_step


def run_train(argv: Sequence[str], resume_dir: Optional[str] = None) -> dict:
    """The train entry in a child process, its output passed through;
    resumes from ``resume_dir`` when given. Returns the entry's JSON
    summary (its last stdout line) with the wall seconds of the child;
    raises when the child fails."""
    cmd = [sys.executable, "-m", "raft_ncup_tpu_torch.train", *argv]
    if resume_dir is not None:
        cmd += ["--restore_ckpt", resume_dir]
    print("+ " + " ".join(cmd[1:]), flush=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE, text=True)
    last = ""
    for line in proc.stdout:
        sys.stdout.write(line)
        if line.strip():
            last = line.strip()
    sys.stdout.flush()
    if proc.wait() != 0:
        raise subprocess.CalledProcessError(proc.returncode, cmd)
    summary = json.loads(last)
    summary["wall_seconds"] = time.perf_counter() - t0
    return summary


def validation_curve(run_dir: str) -> dict[int, dict]:
    """``{step: results}`` of every ``[val @ N]`` line of the run's log."""
    path = os.path.join(run_dir, "log.txt")
    curve: dict[int, dict] = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                m = _VAL_LINE.match(line.strip())
                if m:
                    curve[int(m.group(1))] = json.loads(m.group(2))
    return curve


def initial_validation(argv: Sequence[str], validator: str) -> dict:
    """``validator`` on the untrained model the train entry would build
    from ``argv`` (its ``--seed``), at the validator's own settings."""
    from raft_ncup_tpu_torch import cli
    from raft_ncup_tpu_torch.evaluation import VALIDATORS
    from raft_ncup_tpu_torch.models.raft import RAFT

    args, model_cfg, cfg, data_cfg = cli.parse_train(list(argv))
    model = RAFT(model_cfg, device=args.device, seed=cfg.seed)
    return VALIDATORS[validator](model, data_cfg)


def log_initial_validation(run_dir: str, argv: Sequence[str], validator: str) -> dict:
    """Validate the untrained model and append ``[val @ 0]`` to the run's
    log, once: a log that has the line keeps it."""
    curve = validation_curve(run_dir)
    if 0 in curve:
        return curve[0]
    results = initial_validation(argv, validator)
    os.makedirs(run_dir, exist_ok=True)
    line = "[val @ 0] " + json.dumps({k: round(float(v), 5) for k, v in results.items()})
    print(line, flush=True)
    with open(os.path.join(run_dir, "log.txt"), "a") as f:
        f.write(line + "\n")
    return results


def train_resumable(argv: Sequence[str], run_dir: str, num_steps: int) -> Optional[dict]:
    """Train unless the run directory holds step ``num_steps`` already;
    resume from its newest checkpoint when it holds an earlier one.
    Returns the train entry's summary, None when skipped."""
    done = latest_step(run_dir)
    if done == num_steps:
        print(f"{run_dir}: step {num_steps} saved, skipping", flush=True)
        return None
    return run_train(argv, resume_dir=run_dir if done is not None else None)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--name", default=RUN_NAME)
    p.add_argument("--ckpt_dir", default="checkpoints")
    p.add_argument("--num_steps", type=int, default=4000)
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device; cpu to run there)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    a = build_parser().parse_args(argv)
    from raft_ncup_tpu_torch.utils.device import resolve_device

    device = str(resolve_device(a.device))
    ckpt_dir = os.path.join(REPO, a.ckpt_dir)
    run_dir = os.path.join(ckpt_dir, a.name)
    targv = train_argv(a.name, ckpt_dir, device, a.num_steps)
    log_initial_validation(run_dir, targv, "synthetic")
    summary = train_resumable(targv, run_dir, a.num_steps)
    curve = {s: r["synthetic"] for s, r in sorted(validation_curve(run_dir).items())}
    first, last = curve.get(0), curve.get(a.num_steps)
    ratio = first / last if first is not None and last else None
    print(json.dumps({
        "run": run_dir, "curve": curve, "ratio": ratio, "target_ratio": TARGET_RATIO,
        "met": ratio is not None and ratio >= TARGET_RATIO,
        "trained": summary is not None,
        "median_iteration_ms": None if summary is None else summary["median_iteration_ms"],
        "steps": None if summary is None else summary["steps"],
        "wall_seconds": None if summary is None else summary["wall_seconds"],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
