"""Twin experiment: NCUP against bilinear upsampling on discontinuity-rich
data, ``python -m raft_ncup_tpu_torch.ncup_vs_bilinear``.

The counterpart of the JAX package's ``scripts/ncup_vs_bilinear.py``,
function by function. The paper's claim is that normalized-convolution
guided upsampling refines flow at motion boundaries better than naive
interpolation. With no dataset on disk the test is data-free:

1. Train a small RAFT trunk on the piecewise-rigid procedural split
   (``--synthetic_style rigid``: sharp flow boundaries and occlusion).
2. Train one twin on that frozen trunk: ``raft_nc_dbl`` with the NCUP
   upsampler (``--freeze_raft --load_pretrained``), the reference's
   flagship stage-2 workflow.
3. Evaluate both twins, the trained NCUP head and the parameter-free
   bilinear head on the same frozen trunk, on the held-out rigid split
   with the boundary-band EPE, once per split seed (``--eval_seeds``).
   The trunk is bit for bit the same in both, so a delta belongs to the
   upsampler alone; :func:`bootstrap_ci` puts a percentile bootstrap
   interval on the mean of the per-seed deltas.

Both trainings run the train entry (``python -m raft_ncup_tpu_torch.train``)
in a child process with the JAX script's flags, ``--device`` in place of
``--platform``. A stage whose run directory holds its last step
(``CheckpointManager.latest_step``) is skipped, and one that holds an
earlier step resumes from it, so a cut run goes on where it stood. The
record (``--out``) has the JAX record's keys plus the device's name and
power limit and the torch version; a markdown table and the verdict line
go to stdout. It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Optional, Sequence

import numpy as np

from raft_ncup_tpu_torch.synth_convergence import REPO, latest_step, train_resumable


def bootstrap_ci(
    values: list[float],
    n_resamples: int = 10_000,
    seed: int = 0,
    alpha: float = 0.05,
) -> dict:
    """Percentile bootstrap CI for the mean of ``values``, deterministic
    given ``seed``. With few seeds the interval is coarse by construction:
    a claim whose interval straddles zero is not established."""
    vals = np.asarray(values, np.float64)
    if vals.size == 0:
        raise ValueError("bootstrap_ci needs at least one value")
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, vals.size, size=(int(n_resamples), vals.size))
    means = vals[idx].mean(axis=1)
    lo, hi = np.quantile(means, [alpha / 2.0, 1.0 - alpha / 2.0])
    return {
        "mean": float(vals.mean()),
        "ci_lo": float(lo),
        "ci_hi": float(hi),
        "alpha": alpha,
        "n_values": int(vals.size),
        "n_resamples": int(n_resamples),
    }


def train_argv(a: argparse.Namespace, twin: str) -> list[str]:
    """The train entry's flags for ``twin`` (``trunk``, ``ncup`` or
    ``bilinear``); also parsed again at evaluation, so the evaluated model
    configuration is the trained one."""
    if twin not in ("trunk", "ncup", "bilinear"):
        raise ValueError(f"unknown twin: {twin!r}")
    common = [
        "--stage", "chairs", "--small",
        "--synthetic_ok", "--synthetic_style", "rigid",
        "--device", a.device,
        "--image_size", "64", "96", "--batch_size", "2", "--iters", "4",
        "--wdecay", "1e-5", "--validation", "synthetic_rigid",
        "--checkpoint_dir", a.ckpt_dir, "--seed", str(a.seed),
    ]
    if twin == "trunk":
        return [
            "--name", a.trunk_name, "--model", "raft",
            "--num_steps", str(a.trunk_steps), "--lr", "4e-4",
            "--val_freq", "400", "--sum_freq", "100",
        ] + common
    argv = [
        "--name", a.ncup_name, "--model", "raft_nc_dbl",
        "--freeze_raft",
        "--load_pretrained", os.path.join(a.ckpt_dir, a.trunk_name),
        "--num_steps", str(a.ncup_steps), "--lr", "2e-4",
        "--val_freq", "250", "--sum_freq", "100",
    ] + common
    if twin == "bilinear":
        argv.append("--upsampler_bi")
    return argv


def twin_model(a: argparse.Namespace, twin: str):
    """The evaluated model of ``twin``: the NCUP twin restored from its run
    directory; the bilinear twin the frozen trunk in ``raft_nc_dbl`` with
    the bilinear head (the trunk is the whole model)."""
    from raft_ncup_tpu_torch import cli
    from raft_ncup_tpu_torch.models.raft import RAFT
    from raft_ncup_tpu_torch.training.checkpoint import (
        load_model_weights,
        load_pretrained_trunk,
        saved_model_config,
    )

    if twin == "ncup":
        run_dir = os.path.join(a.ckpt_dir, a.ncup_name)
        return load_model_weights(RAFT(saved_model_config(run_dir), device=a.device), run_dir)
    _, model_cfg, _, _ = cli.parse_train(train_argv(a, twin))
    model = RAFT(model_cfg, device=a.device, seed=0)
    return load_pretrained_trunk(os.path.join(a.ckpt_dir, a.trunk_name), model)


def device_record(device: str) -> dict:
    """The device's name and power limit (``nvidia-smi``'s line on a card)
    and the torch version, for the record."""
    import torch

    rec = {"device": device, "torch": torch.__version__, "name": None, "power_limit": None}
    if device.startswith("cuda"):
        idx = torch.device(device).index or 0
        rec["name"] = torch.cuda.get_device_name(idx)
        try:
            out = subprocess.run(
                ["nvidia-smi", f"--id={idx}", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
            rec["nvidia_smi"] = out.stdout.strip()
            rec["power_limit"] = out.stdout.strip().split(",")[-1].strip() or None
        except (OSError, subprocess.SubprocessError) as e:
            rec["nvidia_smi"] = f"unavailable: {e}"
    return rec


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trunk_steps", type=int, default=4000)
    p.add_argument("--ncup_steps", type=int, default=2000)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--ckpt_dir", default="checkpoints")
    p.add_argument("--trunk_name", default="torch_rigid_trunk")
    p.add_argument("--ncup_name", default="torch_rigid_ncup")
    p.add_argument("--val_length", type=int, default=64,
                   help="held-out pairs per evaluation")
    p.add_argument("--eval_seeds", default="999,1000,1001",
                   help="comma-joined held-out split seeds; both twins are evaluated once "
                   "per seed and the boundary-band delta gets a bootstrap CI over the "
                   "per-seed values")
    p.add_argument("--out", default="checkpoints/torch_ncup_vs_bilinear.json")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device; cpu to run there)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = build_parser()
    a = p.parse_args(argv)
    eval_seeds = [int(s) for s in a.eval_seeds.split(",") if s.strip()]
    if not eval_seeds:
        p.error("--eval_seeds must name at least one seed")
    from raft_ncup_tpu_torch.evaluation import validate_synthetic_rigid
    from raft_ncup_tpu_torch.utils.device import resolve_device

    a.device = str(resolve_device(a.device))
    # The children run in the repository; relative paths are anchored there.
    a.ckpt_dir = os.path.join(REPO, a.ckpt_dir)
    trunk_dir = os.path.join(a.ckpt_dir, a.trunk_name)
    ncup_dir = os.path.join(a.ckpt_dir, a.ncup_name)
    trained = {}
    for twin, run_dir, steps in (("trunk", trunk_dir, a.trunk_steps),
                                 ("ncup", ncup_dir, a.ncup_steps)):
        summary = train_resumable(train_argv(a, twin), run_dir, steps)
        trained[twin] = None if summary is None else {
            k: summary[k] for k in ("steps", "median_iteration_ms", "wall_seconds")}

    # ---- evaluation: both twins on the same held-out rigid split.
    eval_kw = dict(iters=12, batch_size=4, size_hw=(96, 128), length=a.val_length)
    results: dict[str, dict[int, dict]] = {}
    for twin in ("bilinear", "ncup"):
        model = twin_model(a, twin)
        results[twin] = {}
        for es in eval_seeds:
            print(f"== evaluating twin: {twin} (split seed {es})", flush=True)
            results[twin][es] = validate_synthetic_rigid(model, seed=es, **eval_kw)

    # Per-seed deltas (bilinear - ncup; positive: NCUP wins) and the
    # bootstrap CI over the seed dimension for each metric.
    per_seed_delta = {
        k.replace("synthetic_rigid", "delta"): [
            results["bilinear"][es][k] - results["ncup"][es][k] for es in eval_seeds
        ]
        for k in results["ncup"][eval_seeds[0]]
    }
    ci = {k: bootstrap_ci(v, seed=a.seed) for k, v in per_seed_delta.items()}
    mean = {
        twin: {
            k: float(np.mean([results[twin][es][k] for es in eval_seeds]))
            for k in results[twin][eval_seeds[0]]
        }
        for twin in results
    }
    record = {
        "experiment": "ncup_vs_bilinear",
        "trunk": {"dir": os.path.relpath(trunk_dir, REPO), "steps": a.trunk_steps},
        "ncup_steps": a.ncup_steps,
        "seed": a.seed,
        "eval": {
            "split": f"synthetic_rigid(seeds={eval_seeds})",
            "seeds": eval_seeds,
            **eval_kw,
        },
        "results": mean,
        "results_per_seed": {
            t: {str(es): r for es, r in results[t].items()} for t in results
        },
        "bilinear_minus_ncup": {k: v["mean"] for k, v in ci.items()},
        "bilinear_minus_ncup_per_seed": per_seed_delta,
        "bootstrap_ci": ci,
        "device": device_record(a.device),
        "trained": trained,
        "latest_steps": {"trunk": latest_step(trunk_dir), "ncup": latest_step(ncup_dir)},
    }
    out = os.path.join(REPO, a.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=2)
    print(json.dumps(record["bilinear_minus_ncup"]))

    rows = [
        ("bilinear (frozen trunk)", mean["bilinear"]),
        ("NCUP (trained on frozen trunk)", mean["ncup"]),
    ]
    print(f"\n(means over {len(eval_seeds)} held-out split seeds)")
    print("| upsampler | EPE | boundary EPE | interior EPE |")
    print("|---|---|---|---|")
    for name, r in rows:
        print(
            f"| {name} | {r['synthetic_rigid']:.3f} "
            f"| {r['synthetic_rigid_bnd']:.3f} "
            f"| {r['synthetic_rigid_interior']:.3f} |"
        )
    bnd = ci["delta_bnd"]
    print(
        f"\nboundary-band delta (bilinear - ncup): {bnd['mean']:.4f} "
        f"[{bnd['ci_lo']:.4f}, {bnd['ci_hi']:.4f}] "
        f"({100 * (1 - bnd['alpha']):.0f}% bootstrap CI over "
        f"{bnd['n_values']} seeds; claim established only if the "
        "interval excludes 0)"
    )
    print(f"record written to {a.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
