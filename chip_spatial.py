#!/usr/bin/env python3
"""The spatial axis across cards under NCCL: one process per card.

Run from the root of the repository on a machine with four cards:
``python3 chip_spatial.py``. It

1. builds the kernels, then runs the highres entry
   (``python -m raft_ncup_tpu_torch.highres_forward``, the flagship's f32
   forward, batch 1, 32 iterations, seeded weights and frames) at 1088x1920
   with the height split over 1, 2 and 4 cards and at 2176x3840 over 1 and
   4, each rank on its own card (NCCL), and holds every rank's flows
   against the one-card forward's at the flagship's tolerances (flow_lr atol
   2e-3, flow_up atol 5e-3, rtol 1e-3);
2. runs the evaluate entry (``validate_synthetic``, 12 iterations, batch 2)
   on one card and on four with ``--mesh 2,2`` and ``--mesh 1,4``, and holds
   the four-card results within 1e-5 of the one card's;
3. serves the flagship f32 at 436x1024 (448x1024 padded, a pad bucket of
   32 in every run), batch sizes 1 and 2, level 12, a burst of 16
   requests, through the serve entry on one card and with ``--mesh 1,2``
   and ``--mesh 1,4`` (``parallel/lockstep.py``; each rank is
   ``chip_smoke.py --serve_worker``, the entry's ``run``, which saves its
   report and answers), and holds every answer against the one card's at
   the flagship's flow_up tolerance; each run's pairs/s, p50 and p99.

4. trains the flagship (stage chairs, BatchNorm training, procedural
   pairs) at 1088x1920, batch 1, 12 iterations, remat on, 2 steps, through
   the train entry on one card and with ``--mesh 1,2`` and ``--mesh 1,4``
   (each rank ``chip_smoke.py --dp_worker``), and holds every rank's losses
   and step-1 gradients against the one card's; each rank's ms a step and
   peak bytes.

5. pipelines the flagship's test-mode forward over the pipe axis
   (``inference/pipe_schedule.PipelinedForward``): f32 at 440x1024, 32
   iterations, a stream of 16 micro-batches of batch 1 on one card (one
   stage, the monolithic forward) and over 2 and 4 cards (``--mesh 1,1,S``
   under NCCL, each rank ``chip_smoke.py --pipe_worker``): each run's
   pairs/s over the whole second stream (fill and flush included) beside
   one card's, each rank's device ms per stage program, host ms waiting on
   hand-offs, hand-offs with their bytes and peak bytes, and every rank's
   flows against one card's at the flagship's tolerances; the one-card run
   also times the encode, one iteration and the finalize alone.

6. serves the flagship f32 at 436x1024 (448x1024 padded, a pad bucket of
   32), batch size 2, level 12, a burst of 16 requests over a pipe axis
   beside a data or spatial axis (``mixed``): on one card, with ``--mesh
   1,2`` and ``--mesh 2,1`` on two cards and with ``--mesh 1,2,2`` and
   ``--mesh 2,1,2`` on four (each rank ``chip_smoke.py --mixed_worker``,
   which records every forward the rank ran): each run's pairs/s, p50 and
   p99, and every rank's answers (cut from its own forwards) against the
   one card's at the flagship's flow_up tolerance.

7. runs the highres entry with the PAC head (``pac``: ``--final_upsampling
   PacJointUpsampleFull``, the flagship's trunk at 32 iterations) at
   1088x1920 and 2176x3840 over 1, 2 and 4 cards: each rank's peak bytes
   and wall and device ms, every rank's flows against the run on the
   fewest cards that held it. A run whose ranks run out of card memory is
   a finding, printed as ``out_of_memory``, and not a failure; its other
   ranks are stopped at once.

``python3 chip_spatial.py [PART ...]`` runs only the named parts
(``highres``, ``evaluate``, ``serving``, ``train``, ``pipe``, ``mixed``,
``pac``; all by default).

Every rank is a process started with the launcher's environment, so each
rank's report (its last JSON line) and exit code show. It prints one
``spatial cards:`` JSON line per run (each rank's wall and device ms, peak
bytes, collectives and launches, and its largest difference from one
card), then the cards' names and power limits, and exits non-zero when a
run fails or disagrees.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SIZES = (((1088, 1920), (1, 2, 4)), ((2176, 3840), (1, 4)))
MESHES = ("2,2", "1,4")
CARDS = 4
TIMEOUT_S = 900
FLOW_TOL = {"flow_lr": (2e-3, 1e-3), "flow_up": (5e-3, 1e-3)}  # (atol, rtol)
EVAL_RTOL = 1e-5
EVAL_ARGV = ["-m", "raft_ncup_tpu_torch.evaluate", "--model", "raft_nc_dbl", "--dataset",
             "synthetic", "--iters", "12", "--batch_size", "2"]
SERVE_ENTRY = ["--model", "raft_nc_dbl", "--size", "436", "1024", "--seed", "0",
               "--serve_batch_sizes", "1,2", "--iter_levels", "12", "--serve_pad_bucket", "32",
               "--num_requests", "16", "--queue_capacity", "32", "--flight_dir", ""]
SERVE_MESHES = ("1,2", "1,4")
TRAIN_FLAGS = ["--untimed", "--name", "exp", "--model", "raft_nc_dbl", "--stage", "chairs",
               "--synthetic_ok", "--image_size", "1088", "1920", "--batch_size", "1",
               "--num_steps", "2", "--iters", "12", "--sum_freq", "1", "--num_workers", "2"]
TRAIN_SPLITS = (1, 2, 4)
PIPE_SPLITS = (1, 2, 4)
PIPE_FLAGS = ["--micro", "16", "--iters", "32"]
MIXED_ENTRY = ["--model", "raft_nc_dbl", "--size", "436", "1024", "--seed", "0",
               "--serve_batch_sizes", "2", "--iter_levels", "12", "--serve_pad_bucket", "32",
               "--num_requests", "16", "--burst_size", "16", "--queue_capacity", "32",
               "--flight_dir", ""]
MIXED_MESHES = ("1,2", "2,1", "1,2,2", "2,1,2")
PAC_SIZES = (((1088, 1920), (1, 2, 4)), ((2176, 3840), (1, 2, 4)))
PAC_FLAGS = ["--final_upsampling", "PacJointUpsampleFull"]
OOM = ("OutOfMemoryError", "CUDA out of memory")
PARTS = ("highres", "evaluate", "serving", "train", "pipe", "mixed", "pac")


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _last_json(text: str):
    lines = [x for x in text.splitlines() if x.startswith("{")]
    return json.loads(lines[-1]) if lines else None


def ranks(argv: list, world: int, fail_fast: bool = False) -> tuple:
    """``world`` processes of ``python argv``, rank r on card r (one process
    on card 0 for a world of one): (exit codes, reports, stderr tails,
    seconds). With ``fail_fast`` the others are stopped as soon as one
    exits non-zero (they would wait in a collective for the one gone)."""
    env = dict(os.environ, PYTHONPATH=HERE)
    env.pop("RAFT_TORCH_DIST_BACKEND", None)
    if world == 1:
        cmds = [([sys.executable, *argv, "--device", "cuda:0"], env)]
    else:
        port = _port()
        cmds = [([sys.executable, *argv], dict(env, WORLD_SIZE=str(world), RANK=str(r),
                                                LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                                                MASTER_PORT=str(port)))
                for r in range(world)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, cwd=HERE, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c, e in cmds]
    outs = []
    try:
        if fail_fast:
            _stop_on_first_failure(procs, t0)
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return ([p.returncode for p in procs], [_last_json(o) for o, _ in outs],
            [e[-3000:] for _, e in outs], time.perf_counter() - t0)


def _diff(torch, got: dict, want: dict) -> tuple:
    """Largest |got - want| of each flow, and whether both are within
    tolerance."""
    out, ok = {}, True
    for k, (atol, rtol) in FLOW_TOL.items():
        d = (got[k] - want[k]).abs()
        out[k] = float(d.max())
        ok = ok and bool((d <= atol + rtol * want[k].abs()).all())
    return out, ok


def _stop_on_first_failure(procs: list, t0: float, grace_s: float = 20.0) -> None:
    """Wait until every process has exited, or one has exited non-zero;
    then give the rest ``grace_s`` seconds and kill those still running.
    The processes' pipes are read later: the reports are short, and an
    out-of-memory trace fits the pipe."""
    while time.perf_counter() - t0 < TIMEOUT_S:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes):
            return
        if any(c not in (None, 0) for c in codes):
            break
        time.sleep(1.0)
    deadline = time.perf_counter() + grace_s
    while time.perf_counter() < deadline and any(p.poll() is None for p in procs):
        time.sleep(0.5)
    for p in procs:
        if p.poll() is None:
            p.kill()


def highres(torch, tmp: str, sizes=SIZES, extra: tuple = (), label: str = "",
            oom_ok: bool = False) -> bool:
    """The highres entry (with the flags ``extra``) at each size over each
    split, every rank's flows against the first run of the size that
    completed; with ``oom_ok`` a run that ran out of card memory is printed
    as such and is no failure."""
    ok = True
    for (h, w), splits in sizes:
        want = None
        for s in splits:
            out = os.path.join(tmp, f"{label}{h}x{w}_{s}")
            argv = ["-m", "raft_ncup_tpu_torch.highres_forward", "--size", str(h), str(w),
                    "--iters", "32", "--spatial", str(s), "--save", out, *extra]
            codes, reps, errs, secs = ranks(argv, s, fail_fast=oom_ok)
            row = {"size": [h, w], "spatial": s, "exits": codes, "seconds": secs}
            if label:
                row["run"] = label.strip("_")
            good = codes == [0] * s and all(r is not None and r["finite"] for r in reps)
            if not good and oom_ok and any(m in e for e in errs for m in OOM):
                row.update(out_of_memory=True, stderr=[e[-600:] for e in errs])
                print(f"spatial cards: {json.dumps(row)}", flush=True)
                continue
            if good:
                flows = [torch.load(os.path.join(out, f"flows_rank{r}.pt"), weights_only=True)
                         for r in range(s)]
                if want is None:
                    want = flows[0]
                    row["reference"] = True
                diffs = [_diff(torch, f, want) for f in flows]
                row["max_abs_diff_vs_one_card"] = [d for d, _ in diffs]
                good = all(g for _, g in diffs)
                row["ranks"] = [{k: r[k] for k in ("rank", "mesh", "wall_ms", "device_ms",
                                                   "peak_bytes", "collectives",
                                                   "collective_bytes", "by_op", "launches",
                                                   "first_s")} for r in reps]
            else:
                row["stderr"] = errs
            print(f"spatial cards: {json.dumps(row)}", flush=True)
            ok = ok and good
    return ok


def evaluation() -> bool:
    codes, reps, errs, secs = ranks(EVAL_ARGV, 1)
    one = reps[0]["results"] if codes == [0] and reps[0] else None
    print(f"spatial cards: {json.dumps({'evaluate': 'one card', 'exits': codes, 'seconds': secs, 'results': one})}",
          flush=True)
    ok = one is not None
    for mesh in MESHES:
        codes, reps, errs, secs = ranks(EVAL_ARGV + ["--mesh", mesh], CARDS)
        good = ok and codes == [0] * CARDS and all(r is not None for r in reps)
        row = {"evaluate": f"--mesh {mesh}", "exits": codes, "seconds": secs}
        if good:
            row["ranks"] = [{"rank": r["rank"], "mesh": r["mesh"], "results": r["results"],
                             "collectives": r["collectives"]["by_op"]} for r in reps]
            rel = max(abs(r["results"][k] - v) / abs(v) for r in reps for k, v in one.items())
            row["max_rel_diff_vs_one_card"] = rel
            good = rel <= EVAL_RTOL
        else:
            row["stderr"] = errs
        print(f"spatial cards: {json.dumps(row)}", flush=True)
        ok = ok and good
    return ok


def serving(torch, tmp: str) -> bool:
    """The served burst on one card and over ``SERVE_MESHES``: each run's
    rate and latency (the leader's report), each rank's collectives, and
    every answer against the one card's."""
    ok, want = True, None
    for mesh in (None, *SERVE_MESHES):
        world = 1 if mesh is None else int(mesh.split(",")[1])
        out = os.path.join(tmp, f"serve_{world}")
        os.makedirs(out)
        argv = [os.path.join(HERE, "chip_smoke.py"), "--serve_worker", out, *SERVE_ENTRY,
                *(["--mesh", mesh] if mesh else [])]
        codes, _, errs, secs = ranks(argv, world)
        row = {"serve": f"--mesh {mesh}" if mesh else "one card", "exits": codes,
               "seconds": secs}
        good = codes == [0] * world
        if good:
            recs = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                    for r in range(world)]
            rep = recs[0]["report"]
            flows = [a["flow"] for a in recs[0]["answers"]]
            row.update({k: rep[k] for k in ("serve_ok", "serve_batches", "serve_pairs_per_sec",
                                            "serve_p50_ms", "serve_p99_ms", "warmup_s",
                                            "mesh")})
            row["ranks"] = [{k: r["report"].get(k) for k in ("rank", "mesh", "collectives",
                                                              "lockstep")} for r in recs]
            good = rep["serve_ok"] == len(flows) == 16
            if want is None:
                want = flows
            elif good:
                atol, rtol = FLOW_TOL["flow_up"]
                diffs = [torch.from_numpy(a - b).abs() for a, b in zip(flows, want)]
                row["max_abs_diff_vs_one_card"] = max(float(d.max()) for d in diffs)
                good = all(bool((d <= atol + rtol * torch.from_numpy(b).abs()).all())
                           for d, b in zip(diffs, want))
        else:
            row["stderr"] = errs
        print(f"spatial cards: {json.dumps(row)}", flush=True)
        ok = ok and good
    return ok


def train(torch, tmp: str) -> bool:
    """The train entry at 1088x1920 on one card and split over
    ``TRAIN_SPLITS`` cards: each rank's losses and step-1 (reduced)
    gradients against the one card's, at ``chip_smoke.py``'s spatial
    training bounds."""
    import chip_smoke

    ok, want = True, None
    for s in TRAIN_SPLITS:
        out = os.path.join(tmp, f"train_{s}")
        os.makedirs(out)
        argv = [os.path.join(HERE, "chip_smoke.py"), "--dp_worker", out, *TRAIN_FLAGS,
                "--checkpoint_dir", out, *(["--mesh", f"1,{s}"] if s > 1 else [])]
        codes, _, errs, secs = ranks(argv, s)
        row = {"train": "one card" if s == 1 else f"--mesh 1,{s}", "exits": codes,
               "seconds": secs}
        good = codes == [0] * s
        if good:
            recs = []
            for r in range(s):
                with open(os.path.join(out, f"rank{r}.json")) as fh:
                    recs.append(json.load(fh))
            grads = torch.load(recs[0]["grads"], weights_only=True)
            losses = [st["loss"] for st in recs[0]["steps"]]
            row["ranks"] = [{"rank": rec["rank"], "mesh": rec["summary"]["mesh"],
                             "losses": [st["loss"] for st in rec["steps"]],
                             "step_ms": [st["ms"] for st in rec["steps"]],
                             "peak_gib": max(st["peak_gib"] or 0.0 for st in rec["steps"]),
                             "launches": [st["launches"] for st in rec["steps"]],
                             "collectives": rec["summary"]["collectives"]["by_op"]}
                            for rec in recs]
            if want is None:
                want = (losses, grads)
            else:
                worst, failures = chip_smoke._dp_grad_errs(
                    torch, grads, want[1], chip_smoke.SPATIAL_TRAIN_GRAD_TOL,
                    chip_smoke.SPATIAL_TRAIN_FLIPPED, chip_smoke.SPATIAL_TRAIN_ENCODER_TOL,
                    chip_smoke.SPATIAL_TRAIN_CENTRED, chip_smoke.SPATIAL_TRAIN_UPSAMPLER,
                    chip_smoke.SPATIAL_TRAIN_UPSAMPLER_TOL)
                rel = [abs(a - b) / abs(b) for a, b in zip(losses, want[0])]
                row.update(loss_rel_diff_vs_one_card=rel, grad_rel_diff_step1=worst,
                           grad_failures=failures)
                good = (not failures and max(rel) <= chip_smoke.SPATIAL_TRAIN_LOSS_RTOL
                        and all([st["loss"] for st in rec["steps"]] == losses for rec in recs))
        else:
            row["stderr"] = errs
        print(f"spatial cards: {json.dumps(row)}", flush=True)
        ok = ok and good
    return ok


def _summed(timing: dict) -> dict:
    """A rank's per-program device ms over the stream: sum and median."""
    out = {}
    for k, v in timing.items():
        if isinstance(v, list) and v:
            out[k] = {"sum": sum(v), "median": sorted(v)[len(v) // 2], "n": len(v)}
        else:
            out[k] = v
    return out


def pipe(torch, tmp: str) -> bool:
    """The pipelined forward on one card and over ``PIPE_SPLITS`` cards:
    pairs/s of the timed (second) stream beside one card's, each rank's
    stage programs, waits, hand-offs and peak bytes, and every rank's flows
    against one card's."""
    ok, want, one = True, None, None
    for s in PIPE_SPLITS:
        out = os.path.join(tmp, f"pipe_{s}")
        os.makedirs(out)
        argv = [os.path.join(HERE, "chip_smoke.py"), "--pipe_worker", out, *PIPE_FLAGS,
                *(["--stage_timing"] if s == 1 else [])]
        codes, _, errs, secs = ranks(argv, s)
        row = {"pipe": "one card" if s == 1 else f"--mesh 1,1,{s}", "exits": codes,
               "seconds": secs}
        good = codes == [0] * s
        if good:
            recs = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                    for r in range(s)]
            micro = recs[0]["micro"]
            wall = max(r["second"]["seconds"] for r in recs)
            row.update(micro_batches=micro, iters=recs[0]["iters"], stream_seconds=wall,
                       pairs_per_sec=micro / wall, pairs_per_sec_one_card=one)
            if s == 1:
                one = row["pairs_per_sec"]
                row["stage_ms"] = recs[0]["stage_ms"]
            row["ranks"] = [{"rank": r["rank"], "mesh": r["mesh"], "backend": r["backend"],
                             "timing": _summed(r["second"]["timing"]),
                             "handoffs": r["second"]["collectives"]["by_op"][
                                 "collective-permute"],
                             "outputs": r["second"]["outputs"],
                             "launches": r["second"]["launches"],
                             "captures": [r["first"]["captures"], r["second"]["captures"]],
                             "host_transfers": r["second"]["host_transfers"],
                             "same_buffers": r["second"]["same_buffers"],
                             "peak_bytes": r["peak_bytes"]} for r in recs]
            if want is None:
                want = recs[0]["flows"]
            diffs = [_diff(torch, {"flow_lr": lr, "flow_up": up},
                           {"flow_lr": wlr, "flow_up": wup})
                     for r in recs for (lr, up), (wlr, wup) in zip(r["flows"], want)]
            row["max_abs_diff_vs_one_card"] = {
                k: max(d[k] for d, _ in diffs) for k in FLOW_TOL}
            good = all(g for _, g in diffs) and all(
                r["second"]["captures"] == 0 and r["second"]["host_transfers"] == 0
                for r in recs)
        else:
            row["stderr"] = errs
        print(f"spatial cards: {json.dumps(row)}", flush=True)
        ok = ok and good
    return ok


def mixed(torch, tmp: str) -> bool:
    """The served burst on one card and over ``MIXED_MESHES``: each run's
    rate and latency (the leader's report), each rank's collectives and
    lockstep broadcasts, and every rank's answers, cut from the forwards
    it ran, against the one card's."""
    import types

    import chip_smoke

    ok, want = True, None
    for mesh in (None, *MIXED_MESHES):
        world = 1
        for size in (mesh or "1").split(","):
            world *= int(size)
        out = os.path.join(tmp, f"mixed_{(mesh or 'one').replace(',', '')}")
        os.makedirs(out)
        argv = [os.path.join(HERE, "chip_smoke.py"), "--mixed_worker", out, *MIXED_ENTRY,
                *(["--mesh", mesh] if mesh else ["--device", "cuda:0"])]
        codes, _, _, secs = ranks(argv, world)
        row = {"mixed": f"--mesh {mesh}" if mesh else "one card", "exits": codes,
               "seconds": secs}
        good = codes == [0] * world
        if good:
            recs = [torch.load(os.path.join(out, f"rank{r}_0.pt"), weights_only=False)
                    for r in range(world)]
            rep = recs[0]["report"]
            row.update({k: rep[k] for k in ("serve_ok", "serve_batches", "serve_pairs_per_sec",
                                            "serve_p50_ms", "serve_p99_ms", "warmup_s",
                                            "mesh")})
            row["ranks"] = [{k: r["report"].get(k) for k in ("rank", "mesh", "collectives",
                                                              "lockstep")} for r in recs]
            good = rep["serve_ok"] == 16
            if want is None:  # one level: every answer ran the one card's iterations
                one = sorted(recs[0]["answers"], key=lambda a: a["request_id"])
                want = {a["iters"]: [types.SimpleNamespace(**b) for b in one] for a in one}
            elif good:
                try:
                    row["answers_vs_one_card"] = chip_smoke._mixed_answers(
                        torch, recs, want, f"mixed {mesh}", n=16)
                    row["pipe_max_abs_diff"] = (chip_smoke._pipe_spread(recs)
                                                if mesh.count(",") == 2 else None)
                except chip_smoke.CheckFailed as e:
                    row["failed"], good = str(e), False
        else:
            logs = []
            for r in range(world):
                path = os.path.join(out, f"rank{r}.log")
                if os.path.exists(path):
                    with open(path) as fh:
                        logs.append(fh.read()[-3000:])
            row["logs"] = logs
        print(f"spatial cards: {json.dumps(row)}", flush=True)
        ok = ok and good
    return ok


def main() -> int:
    import torch

    parts = sys.argv[1:] or list(PARTS)
    if set(parts) - set(PARTS):
        print(f"chip_spatial: parts are {PARTS}, got {parts}", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < CARDS:
        print(f"chip_spatial: {torch.cuda.device_count()} cards, {CARDS} needed",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from raft_ncup_tpu_torch.ops import cuda_build

    print(f"build: {cuda_build.build()}", flush=True)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        if "highres" in parts:
            ok = highres(torch, tmp) and ok
        if "serving" in parts:
            ok = serving(torch, tmp) and ok
        if "train" in parts:
            ok = train(torch, tmp) and ok
        if "pipe" in parts:
            ok = pipe(torch, tmp) and ok
        if "mixed" in parts:
            ok = mixed(torch, tmp) and ok
        if "pac" in parts:
            ok = highres(torch, tmp, PAC_SIZES, tuple(PAC_FLAGS), "pac_", oom_ok=True) and ok
    if "evaluate" in parts:
        ok = evaluation() and ok
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout,
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
