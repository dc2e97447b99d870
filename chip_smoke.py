#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of the repository: ``python3 chip_smoke.py``. It

1. prints the card's name and power limit (under f32 the model's
   forward, the train step and the plain versions keep TF32 off
   themselves);
2. builds the four hand-written kernels from ``raft_ncup_tpu_torch/csrc``,
   all ``nvcc`` processes at once;
3. holds the correlation-lookup kernel (A) against its plain PyTorch
   version at the served shape (batch 2, 55x128 level 0, C=256, 4 levels,
   r=4) with random and with smooth flow, at 1088x1920 (136x240 level 0)
   and at 2176x3840 (272x480), with CUDA-event times, the bound of each row
   and the tiles that took each of the kernel's two paths (checked against
   ``corr_cuda.tile_paths``), and at the small model's served shape (C=128,
   r=3) with both mixes; then at edge cases (C 4 to 512, radius 0 to 8,
   odd levels down to 1x1, windows off every side);
4. holds the fused NConv2d kernel (B) against its plain version at the
   four NCUP layer shapes of one served batch of two (4 folded planes of
   440x1024) and at edge cases (every k, Cout 8, bias, ragged, tiny and
   misaligned planes);
5. holds the lookup (A) and its backward kernel (A') against the plain
   lookup and its autograd at the training shape (batch 6, 50x90, C=256,
   4 levels, r=4) and at the small model's (C=128, r=3), each with random
   and smooth flow (d f1s, each d f2 level, d coords, against the plain
   autograd in float64), with A''s device counts (tiles per path, d f2 row
   adds) against ``corr_cuda.backward_work``, then A' at edge cases with
   and without d coords; and the NConv2d (B) and its backward kernel (B')
   against their plain versions at the four NCUP layers of a training
   batch (12 planes of 400x720), B' also at edge cases, with the NaN
   places of windows without confidence, and twice on the same inputs
   with bit-equal d weight and d bias; then checks
   that the wrappers raise on CUDA inputs their kernels do not take (other
   dtypes, strided layouts), with or without a gradient;
6. serves 8 Sintel-size (436x1024) requests through ``FlowServer`` with
   each of the flagship, ``raft`` and small ``raft`` on the card, every
   kernel count set to 0 just before each and read just after; checks
   every answer, that exactly the path's forward kernels ran (A, and B
   for the flagship; 12 lookups a batch), and holds one served pair
   against the same model run through the plain versions;
7. traces forwards of the served flagship and ``raft`` at batch 2 with
   ``torch.profiler`` and prints where the device time goes (wall and
   device ms per forward, idle share, time per kernel group, the top
   kernels);
8. trains the flagship 5 steps at ``scripts/train_raft_nc_things.sh``'s
   configuration (batch 6 at 400x720, 12 iterations, remat on) through
   all four kernels: finite losses, no step skipped, no plain version
   called, each kernel launched as often as the step's structure says
   (A 24, A' 12, B 96, B' 48 a step); ms per step, peak memory with remat on
   and off, and a trace of one step split by its forward, backward and
   optimizer ranges (its ``train:`` line);
9. holds one train step through the kernels against the same step
   through the plain versions at batch 2, 400x720: the loss and every
   gradient; then trains ``raft`` and small ``raft`` 3 steps each at the
   same configuration (A 24 and A' 12 a step, no B or B'), each with
   its own launch counts, and holds a kernel step of each against a
   plain-version step;
10. runs the bf16 presets: kernel A on bf16 features (its
    ``corr_lookup_bf16`` entry) at the served shape with both mixes, at
    1088x1920 and at the small model's served shape with both mixes, each
    against its plain version on the same bf16 values (atol 1e-4), with
    its bound at 2 bytes a feature and the f32 kernel's time on the same
    values; at the flagship's training shape with both mixes, the
    lookup's autograd on bf16 features (kernel A on bf16, A' on f32
    copies, bf16 cotangents) against the float64 plain autograd of the
    same bf16 values; serves the flagship, ``raft`` and small ``raft``
    under ``bf16_infer`` (``ServeConfig.precision`` over the f32-built
    models: every lookup on bf16, NCUP's 4 NConv2d launches a batch at
    f32, one served pair within ``FORWARD_EPE_BUDGET`` of the f32 forward
    and within ``BF16_PLAIN_SHARE`` of that distance of the bf16
    plain-version forward); traces the flagship's bf16 forward; and trains the flagship
    3 steps under ``bf16_train`` (the f32 path's launches, lookups on
    bf16, A', B and B' on f32, parameters and moments f32, a traced step);
11. runs the evaluate paths, each forward a replay of a CUDA graph
    (``inference/pipeline.ShapeCachedForward``): the flagship's
    ``validate_synthetic`` and ``validate_synthetic_rigid`` at 436x1024,
    32 iterations, batch 2, 8 pairs each, in f32 and under ``bf16_infer``
    (one capture per key, A 32 and B 4 launches every forward, the metrics
    against a float64 host fold of eager forwards, a replay against the
    eager forward, in f32 the plain-version forward); ``validate_sintel_warm``
    over synthetic Sintel-layout sequences written with the port's PNG and
    ``.flo`` codecs, against the same warm chain run eagerly; a traced
    replayed forward beside each eager one (its ``profile ... graph:``
    line, with the graph pool's bytes); and the evaluate entry on a
    ``.pth`` written by ``save_reference_pth`` and the demo entry on PNG
    frames, each in its own process;
12. trains the flagship from files in-process through the train entry
    (``train.main``) with ``scripts/train_raft_nc_things.sh``'s flag lines
    minus ``--compressed_ft``: a FlyingThings3D-layout tree at 540x960
    (PNG frames warped by their PFM flows, both directions, clean and
    final), read and augmented by the loader's threads and copied ahead by
    the device prefetcher, validated on a Sintel-layout tree, warm-started
    from a ``raft`` .pth written by ``save_reference_pth``: (a) f32, 8 steps
    validating every 4; (b) ``sigterm@3`` (exit 75) and a resume to step 8
    (its batch stream equal to (a)'s by hash, its restored state equal to
    ``step_3.pt``, its losses within ``RESUME_LOSS_RTOL`` of (a)'s); (c)
    ``nan@5,nan@6,nan@7`` with ``--sentinel_halt_after 3`` (exit 76, the
    live parameters equal to ``step_4.pt``); (d) ``bf16_train``, 5 steps;
    (e) ``--freeze_raft --add_noise --dropout 0.1``, 2 steps (the trunk
    unchanged). Every step launches A 24, A' 12, B 96 and B' 48 times, every
    prefetched batch equals its host batch, and no plain version runs; per
    run it prints step and iteration walls beside the synthetic step, the
    host ms per sample, the prefetcher's waits, tile paths (and a synthetic
    step's), and peak memory per step;
13. runs the stages, early exit and streaming of the flagship: ``encode ->
    refine_segment x S -> finalize`` at batch 2, 440x1024, 12 iterations,
    against the forward for S in 1, 2, 4 (A 12 and B 4 launches each); the
    serve entry's plain branch (8 requests at 436x1024, batch sizes 1 and 2,
    level 12) with early exit off and then on at a tolerance taken between
    the pairs' first-iteration norms (per batch: executed iterations,
    segments replayed, A 4 a segment, flag reads; every row against the
    eager run truncated at its executed iterations; the EPE budget at a
    level of 2, also on the serve entry's answers at that level, detection
    on against off; a traced early-exit forward); the serve entry's ``--stream``
    branch (4 streams of 8 frames, batch sizes 1, 2, 4, 12 iterations) in
    f32, under ``bf16_infer`` and with ``--carry_net`` (3 captures, all at
    warm-up; A 12 and B 4 a step; every frame against the plain-version
    forward fed the engine's own previous state; ``bf16_infer`` frames as
    a served bf16 pair, against the f32 and bf16 plain versions), and
    under chaos
    (``corruptframe@4,abandon@7``: one reset; ``sigterm@5``: exit 75 with
    everything admitted answered; in rounds, the corrupt frame's
    batch-mates bit for bit those of a run without it and the reset
    stream's next frame bit for bit a cold start);
14. runs the telemetry of the flagship through the serve entry with every
    output on (``--report --telemetry_jsonl --healthz_file --flight_dir``,
    cadence 0.1 s, SLO windows scaled by 0.01): the plain branch's 8
    requests under ``poison@3,sigterm@6`` (exit 75; every registry counter
    equal to its legacy report key through the alias table; A 12 and B 4 a
    batch; the healthz file READY before the replay and DRAINING after,
    polled every 5 ms and never torn; one ``poison_quarantine`` and one
    ``preemption_drain`` dump, each loaded; a cost-ledger entry of positive
    FLOPs, capture ms and pool bytes for every captured key; the ``slo``
    block; the JSONL tolerant to a cut tail) and the ``--stream`` branch's 4
    streams of 8 frames under ``corruptframe@4`` (one
    ``stream_anomaly_reset`` dump, the stream counters equal to their legacy
    keys, the slot-occupancy gauge, health READY then DRAINING); every
    telemetry primitive called while a spin kernel runs, the spin's event
    still pending after them, and ``host_number`` refusing a CUDA scalar;
    the same 8 requests with telemetry on and off, 3 times each, in turns
    (``serve_telemetry_overhead_pct``, reported beside the JAX package's 3%
    budget, not held); the ledger's MFU of the replayed f32 and
    ``bf16_infer`` forwards at batch 2, beside the analytic count; and the
    train entry's ``--profile_steps 2`` on synthetic pairs at the shipped
    configuration (the Chrome trace holds A, A', B and B' by kernel name,
    each as often as the two traced steps launched it); phase 12's runs (b)
    and (c) each bank one flight dump (``preemption_drain``,
    ``sentinel_halt``);
15. serves the flagship pipelined (``ServeConfig.inflight`` default, 2 on
    the card: the dispatcher stages and launches batch n+1 while the card
    runs batch n, and a drain worker delivers batch n) and waiting
    (``inflight=1``) in one process, f32 and ``bf16_infer``: a paused burst
    of 16 pairs at 436x1024 (8 batches of 2, level 12) through each, the
    answers bit for bit equal; one burst of each under the runtime guards
    (``analysis/guards.py``) with the native layer on
    (``torch.cuda.set_sync_debug_mode("error")``): 0 implicit reads, 0
    captures after warm-up, 8 sanctioned reads; two timed bursts of each in
    turns (pairs/s, p50, p99) and one traced (the card's busy share over the
    window); A 12 and B 4 launches a batch; a ``.item()`` planted in the
    launch, counted by the Python layer and stopped by the native one. The
    same for the stream engine, 4 streams of 4 frames in one paused burst
    (4 steps of 4, one capture each): bit-equal answers, frames/s, p50, p99,
    busy share, 4 sanctioned reads under the guards. Then 3 synthetic steps
    of the train entry at the shipped configuration under
    ``--strict_guards`` (JAX's ``strict_guards:`` line with 0 implicit reads
    and 0 steady recompiles, 3 sanctioned reads), and a per-step ``.item()``
    planted in the step, which must fail the run;
16. runs fleet replicas (``fleet/``): two flagship replica processes of
    the serve entry (``--replica_socket``, f32, 436x1024, batch sizes 1
    and 2 at level 12, streams on) on the one card behind the port's
    supervisor and router, held against an in-process server and stream
    engine built from replica 0's argv (seed 0): both READY with their
    identity in healthz; a burst of 16 pairs and 2 streams of 4 frames,
    every answer ok and within ``FLEET_TOL`` of the in-process one (how
    many are bit for bit equal is printed: cuDNN's autotuning may pick
    other algorithms in another process); two timed fleet bursts against
    two in-process pipelined bursts, in turns (pairs/s); the router's hop
    medians; ``fleet_telemetry_overhead_pct`` from ``set_telemetry`` off
    and on windows on the same warm fleet, in turns; ``killreplica@3`` in a burst of
    8 (the stranded requests fail over within their deadline and answer
    ok, a ``replica_failover`` dump, the dead replica's streams re-home
    cold, held against a cold start in-process) and its restart;
    ``drainreplica`` on the survivor with work in flight (DRAINING in
    healthz, every admitted request answered, exit 75); each replica's
    report with 0 recompiles, 0 host transfers and A 12 and B 4 launches a
    batch it served, and its graph pools' bytes. Before the main paths,
    kernels A and A' run on the small raft's pyramid at 32x48, whose
    fourth level is 0x0, against their plain versions;
17. prints one JSON line describing the kernels, the card's name and
    power limit, and, last, the JSON result line.

Any failed check exits non-zero before the last line. With no CUDA
device it exits non-zero at once; it never falls back to the CPU.

Every process it starts ends before it does: it adopts its orphaned
descendants (Linux's child subreaper), and on the way out stops and reaps
any that is still there, naming each on standard error; the fleet phase
also checks that no replica process outlives its supervisor's ``stop``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Card peaks for the bound (H100 SXM data sheet, dense, at 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores
CORR_TOL = dict(atol=1e-4, rtol=0.0)
NCONV_TOL = dict(atol=1e-5, rtol=1e-4)
FLOW_LR_TOL = dict(atol=2e-3, rtol=1e-3)
FLOW_UP_TOL = dict(atol=5e-3, rtol=1e-3)
NCUP_LAYERS = [  # (name, k, Cin, Cout)
    ("nconv_in", 5, 1, 2), ("nconv_x2_0", 5, 2, 2),
    ("decoder_0", 3, 4, 2), ("nconv_out", 1, 2, 1),
]
SERVE_SIZE = (436, 1024)
SERVE_REQUESTS = 8
# A bf16 served pair against the same preset's plain-version forward: the
# kernel and the plain version sum the same bf16 products in another f32
# order, so their lookups differ by about 1e-6 relative; in a bf16 forward
# such a difference flips roundings that the 12 iterations amplify. On the
# CPU, a 1e-6 relative perturbation of every lookup moves a 128x256 bf16
# forward by 0.177 (flagship), 0.097 (raft) and 0.145 (small raft) of the
# mean EPE that bf16 itself moves it from f32
# (tests/test_torch_precision.py::
# test_lookup_rounding_moves_a_bf16_forward_less_than_the_card_allows).
# So the pair must lie within half that distance.
BF16_PLAIN_SHARE = 0.5
BF16_SERVED = (("raft_nc_dbl", False), ("raft", False), ("raft", True))  # (variant, small)
# One rounding to bf16 (8 significant bits) moves a value by at most this
# share of it: half a unit in the last place, 2^-8 of the leading power of 2.
BF16_ROUNDING = 2.0 ** -8


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def adopt_orphans() -> None:
    """Make this process the reaper of its orphaned descendants (Linux's
    ``PR_SET_CHILD_SUBREAPER``), so a process that a phase starts stays in
    this process's tree, for ``stop_leftovers``, when its parent ends
    first."""
    try:
        import ctypes

        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)
    except (OSError, AttributeError):
        pass


def _proc_stat(pid: int) -> tuple:
    """(parent pid, state letter) of a process from ``/proc``, or None."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            stat = fh.read()
        fields = stat[stat.rindex(")") + 2:].split()
        return int(fields[1]), fields[0]
    except (OSError, ValueError, IndexError):
        return None


def _cmdline(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as fh:
            return fh.read().replace(b"\0", b" ").decode(errors="replace").strip()[:200]
    except OSError:
        return "?"


def descendants() -> dict:
    """Every process below this one: pid -> (state letter, command line)."""
    children = {}
    for name in os.listdir("/proc"):
        if name.isdigit():
            st = _proc_stat(int(name))
            if st is not None:
                children.setdefault(st[0], []).append((int(name), st[1]))
    found, todo = {}, [os.getpid()]
    while todo:
        for pid, state in children.get(todo.pop(), []):
            found[pid] = (state, _cmdline(pid))
            todo.append(pid)
    return found


def stop_leftovers(timeout_s: float = 10.0) -> dict:
    """Stop every process below this one that is still there (SIGKILL),
    then reap this process's ended children, adopted ones included, for up
    to ``timeout_s``. Returns what was running: pid -> command line."""
    import signal

    running = {pid: cmd for pid, (state, cmd) in descendants().items() if state != "Z"}
    for pid in running:
        with contextlib.suppress(OSError):
            os.kill(pid, signal.SIGKILL)
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            break
        if pid == 0:
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    return running


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, flush) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` runs, each timed
    with its own CUDA events after writing ``flush`` (larger than the
    50 MB L2), so every run starts with a cold cache, as in the model
    where other layers run between two calls. A spin kernel first keeps
    the card busy while the host queues every run, so the events measure
    device time and not the host's launch overhead."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s of device time
    events = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def max_err(torch, a, b, atol, rtol) -> tuple[float, bool]:
    diff = (a - b).abs()
    ok = bool((diff <= atol + rtol * b.abs()).all()) and bool(torch.isfinite(a).all())
    return float(diff.max()), ok


# ---------------------------------------------------------------- kernel A

def random_flow(torch, gen, B, H, W):
    """A seeded flow of up to +-20 px with fractional offsets, independent
    per pixel, with about 5% of the windows pushed fully out of bounds
    (1000 px in a random direction): the worst case for window reuse."""
    flow = (torch.rand(B, H, W, 2, generator=gen) * 2 - 1) * 20
    far = (torch.rand(B, H, W, 1, generator=gen) < 0.05).float()
    away = torch.sign(torch.rand(B, H, W, 2, generator=gen) - 0.5) * 1000
    return flow + far * away


def smooth_flow(torch, gen, B, H, W, coarse=(4, 8)):
    """A seeded coarse field of +-20 px (``coarse`` values per axis),
    bilinearly upsampled to H x W, plus fractional offsets below 1 px:
    smooth like the flow the model produces."""
    field = (torch.rand(B, 2, *coarse, generator=gen) * 2 - 1) * 20
    field = torch.nn.functional.interpolate(
        field, size=(H, W), mode="bilinear", align_corners=True)
    frac = torch.rand(B, H, W, 2, generator=gen) - 0.5
    return field.permute(0, 2, 3, 1) + frac


def corr_inputs(torch, gen, B, H, W, C, levels, mix="random", dtype=None):
    """Feature maps prepared at ``dtype`` (default f32), and coords = grid +
    a ``random_flow`` or a ``smooth_flow``."""
    from raft_ncup_tpu_torch.ops.corr_cuda import prepare_levels

    f1 = torch.randn(B, H, W, C, generator=gen)
    f2 = torch.randn(B, H, W, C, generator=gen)
    y, x = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    grid = torch.stack([x, y], -1).float()[None].expand(B, H, W, 2)
    flow = (smooth_flow if mix == "smooth" else random_flow)(torch, gen, B, H, W)
    coords = (grid + flow).contiguous().cuda()
    f1s, lv = prepare_levels(f1.cuda(), f2.cuda(), levels, dtype)
    return f1s, lv, coords


def corr_work(torch, f1s, lv, coords, radius):
    """(bytes, flops) the lookup needs for these inputs
    (``corr_cuda.lookup_work``, which the cost ledger also counts with)."""
    from raft_ncup_tpu_torch.ops.corr_cuda import lookup_work

    return lookup_work(f1s, lv, coords, radius)


def corr_paths(torch, f1s, lv, coords, radius):
    """One launch of the lookup on these inputs: its output and the tiles
    that took each path, checked against the paths ``tile_paths``
    predicts from the coords."""
    from raft_ncup_tpu_torch.ops import corr_cuda

    corr_cuda.reset_path_tiles()
    out = corr_cuda.lookup_levels(f1s, lv, coords, radius)
    paths = corr_cuda.path_tiles()
    tiled, per_query = corr_cuda.tile_paths(
        coords, [(t.shape[1], t.shape[2]) for t in lv], radius, f1s.shape[-1])
    check(paths == {"tiled": tiled, "per_query": per_query},
          f"corr lookup path tiles {paths} differ from the predicted "
          f"{tiled} tiled / {per_query} per-query")
    return out, paths


def check_corr(torch, gen, flush, name, B, H, W, C=256, levels=4, radius=4,
               mix="random", plain_reps=3, dtype=None):
    """One row of kernel A: its output against the plain version on the
    same inputs, its paths, its time, the plain version's and its bound.
    With bf16 features (``dtype``) the plain version upcasts the same bf16
    values, and the f32 kernel is also timed on those values in f32."""
    from raft_ncup_tpu_torch.ops.corr_cuda import lookup_levels, lookup_pyramid

    f1s, lv, coords = corr_inputs(torch, gen, B, H, W, C, levels, mix, dtype)
    launches0 = lookup_levels.launches
    out, paths = corr_paths(torch, f1s, lv, coords, radius)
    ref = lookup_pyramid(f1s, lv, coords, radius)
    err, ok = max_err(torch, out, ref, **CORR_TOL)
    del ref
    nbytes, flops = corr_work(torch, f1s, lv, coords, radius)
    ms = cuda_ms(torch, lambda: lookup_levels(f1s, lv, coords, radius), 20, flush)
    plain_ms = cuda_ms(torch, lambda: lookup_pyramid(f1s, lv, coords, radius),
                       plain_reps, flush)
    t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * flops / PEAK_F32_FLOPS
    features = str(f1s.dtype).removeprefix("torch.")
    row = dict(
        shape=f"B={B} level0={H}x{W} C={C} L={levels} r={radius} {features} {mix} flow",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes, flops=flops,
        bound_ms=max(t_bytes, t_ops),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        check_launches=lookup_levels.launches - launches0,
        path_tiles=paths,
    )
    if f1s.dtype != torch.float32:
        f1w, lvw = f1s.float(), [t.float() for t in lv]
        row["f32_kernel_ms_same_values"] = cuda_ms(
            torch, lambda: lookup_levels(f1w, lvw, coords, radius), 20, flush)
        del f1w, lvw
    print(f"kernel A {name}: {row['shape']}: max|kernel-plain| {err:.3e} "
          f"(atol {CORR_TOL['atol']}) kernel {ms:.4f} ms"
          + (f" (f32 kernel on the same values {row['f32_kernel_ms_same_values']:.4f} ms)"
             if "f32_kernel_ms_same_values" in row else "")
          + f", plain {plain_ms:.3f} ms, "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, {flops / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB); tiles {paths['tiled']} tiled, "
          f"{paths['per_query']} per-query", flush=True)
    check(ok, f"corr lookup kernel disagrees with its plain version at {row['shape']}")
    return row


def edge_coords(torch, gen, B, H, W):
    """Batch element 0 near the grid (fractional offsets below 1 px),
    element 1 with a third of its windows thrown up to 1.5 sizes away,
    and every further element with each quadrant's windows pushed fully
    out of bounds on another side (right, left, below, above)."""
    y, x = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    grid = torch.stack([x, y], -1).float()[None].expand(B, H, W, 2).clone()
    coords = grid + torch.rand(B, H, W, 2, generator=gen) * 2 - 1
    size = float(max(H, W))
    big = (torch.rand(H, W, 2, generator=gen) * 3 - 1.5) * size
    coords[1] += big * (torch.rand(H, W, 1, generator=gen) < 0.33)
    # 100 sizes: beyond the widest window (18 pixels of a level 8x coarser)
    sides = torch.tensor([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]]) * 100 * size
    quad = (2 * (y >= H // 2) + (x >= W // 2)).reshape(-1)
    for b in range(2, B):
        coords[b] += sides[(quad + b) % 4].reshape(H, W, 2)
    return coords.contiguous()


def check_corr_edges(torch, gen):
    """Kernel A against its plain version at B=3 on 9x11 queries (levels
    9x11, 4x5, 2x2, 1x1) for every C in {4, 8, 260, 512} and radius in
    {0, 3, 8}, with fully out-of-bounds windows on every side, and on
    smooth 32x48 coords, where the tiled path runs, at C=252 (a lane
    without channels in the last chunk) r=4, C=4 r=8 and C=128 r=0."""
    from raft_ncup_tpu_torch.ops.corr_cuda import lookup_pyramid, prepare_levels

    cases = [(3, 9, 11, C, r, "edge") for C in (4, 8, 260, 512) for r in (0, 3, 8)]
    cases += [(2, 32, 48, 252, 4, "smooth"), (1, 32, 48, 4, 8, "smooth"),
              (1, 32, 48, 128, 0, "smooth")]
    worst, paths = 0.0, {"tiled": 0, "per_query": 0}
    for B, H, W, C, r, kind in cases:
        f1 = torch.randn(B, H, W, C, generator=gen)
        f2 = torch.randn(B, H, W, C, generator=gen)
        if kind == "edge":
            coords = edge_coords(torch, gen, B, H, W)
        else:
            y, x = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
            grid = torch.stack([x, y], -1).float()[None].expand(B, H, W, 2)
            coords = grid + smooth_flow(torch, gen, B, H, W, coarse=(2, 3)) / 4
        f1s, lv = prepare_levels(f1.cuda(), f2.cuda(), 4)
        coords = coords.contiguous().cuda()
        out, p = corr_paths(torch, f1s, lv, coords, r)
        ref = lookup_pyramid(f1s, lv, coords, r)
        err, ok = max_err(torch, out, ref, **CORR_TOL)
        check(ok, f"corr lookup kernel disagrees at B={B} {H}x{W} C={C} r={r} ({kind}): "
                  f"{err:.3e}")
        if kind == "edge":
            for b in range(2, B):  # every window outside the level
                check(not bool(out[b].any()), f"far windows not zero at C={C} r={r}")
        worst = max(worst, err)
        paths = {k: paths[k] + p[k] for k in paths}
    check(paths["tiled"] > 0 and paths["per_query"] > 0,
          f"corr edge cases did not take both paths: {paths}")
    print(f"kernel A edge cases: {len(cases)} shapes (C in 4/8/260/512, r in 0/3/8, "
          f"odd levels down to 1x1, far windows on every side, smooth r=0/4/8): "
          f"max|kernel-plain| {worst:.3e} (atol {CORR_TOL['atol']}); tiles {paths}",
          flush=True)
    return worst


# ---------------------------------------------------------------- kernel B

def nconv_work(B, H, W, k, cin, cout):
    """(bytes, flops) of one fused NConv2d (``nconv_cuda.nconv_work``,
    which the cost ledger also counts with)."""
    from raft_ncup_tpu_torch.ops.nconv_cuda import nconv_work as work

    return work(B, H, W, k, cin, cout)


def nconv_inputs(torch, gen, B, H, W, k, cin, cout, stuffed):
    data = torch.randn(B, cin, H, W, generator=gen) * 3
    if stuffed:  # nconv_in sees zero-stuffed data and confidence
        conf = torch.zeros(B, cin, H, W)
        conf[:, :, 2::4, 2::4] = torch.rand(B, cin, H // 4, W // 4, generator=gen)
        data = data * (conf > 0)
    else:
        conf = torch.rand(B, cin, H, W, generator=gen)
    raw = 2.0 + math.sqrt(2.0 / (k * k * cout)) * torch.randn(cout, cin, k, k, generator=gen)
    weight = torch.nn.functional.softplus(10 * raw) / 10
    return data.cuda(), conf.cuda(), weight.cuda()


def check_nconv(torch, gen, flush, B=4, H=440, W=1024):
    from raft_ncup_tpu_torch.ops.nconv_cuda import nconv2d_fused, nconv2d_plain

    rows = []
    for name, k, cin, cout in NCUP_LAYERS:
        d, c, w = nconv_inputs(torch, gen, B, H, W, k, cin, cout, name == "nconv_in")
        out = nconv2d_fused(d, c, w)
        torch.cuda.synchronize()
        ref = nconv2d_plain(d, c, w)
        errs = [max_err(torch, a, b, **NCONV_TOL) for a, b in zip(out, ref)]
        err = max(e for e, _ in errs)
        nbytes, flops = nconv_work(B, H, W, k, cin, cout)
        ms = cuda_ms(torch, lambda: nconv2d_fused(d, c, w), 20, flush)
        plain_ms = cuda_ms(torch, lambda: nconv2d_plain(d, c, w), 20, flush)
        t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * flops / PEAK_F32_FLOPS
        row = dict(layer=name, shape=f"({B}, {cin}->{cout}, {H}, {W}) k={k}",
                   max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes,
                   flops=flops, bound_ms=max(t_bytes, t_ops),
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        print(f"kernel B {name}: {row['shape']}: max|kernel-plain| {err:.3e} "
              f"(atol {NCONV_TOL['atol']}, rtol {NCONV_TOL['rtol']}) kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})", flush=True)
        check(all(ok for _, ok in errs),
              f"nconv kernel disagrees with its plain version for {name}")
        rows.append(row)
    # The biased variant of the function, once (NCUP's layers have none).
    d, c, w = nconv_inputs(torch, gen, 2, 64, 96, 3, 2, 2, False)
    bias = torch.randn(2, generator=gen).cuda()
    for a, b in zip(nconv2d_fused(d, c, w, bias), nconv2d_plain(d, c, w, bias)):
        check(max_err(torch, a, b, **NCONV_TOL)[1], "nconv kernel with bias disagrees")
    return rows


NCONV_EDGES = [  # (k, Cin, Cout, B, H, W, bias, aligned)
    (1, 3, 8, 2, 5, 7, False, True),
    (1, 2, 1, 3, 7, 9, False, True),     # the nconv_out kernel, W % 4 != 0
    (3, 2, 8, 1, 17, 70, True, True),
    (3, 4, 2, 2, 16, 64, False, True),   # decoder_0, exactly one tile
    (3, 4, 2, 1, 19, 67, True, True),
    (5, 1, 2, 2, 3, 3, False, True),     # nconv_in, a plane inside the halo
    (5, 2, 2, 1, 33, 130, False, True),  # nconv_x2_0, ragged tiles
    (5, 2, 2, 1, 20, 64, False, False),  # misaligned rows: scalar loads
    (5, 3, 4, 2, 40, 100, True, True),
    (7, 1, 8, 2, 1, 1, False, True),
    (7, 2, 3, 1, 20, 131, True, True),
    (7, 4, 8, 1, 64, 128, False, False),
]


def check_nconv_edges(torch, gen):
    """Kernel B against its plain version for every k in {1, 3, 5, 7},
    Cout = 8, with and without bias, on planes that are not multiples of
    the 64x16 tile, smaller than one tile or its halo, and rows that are
    not 16-byte aligned (a contiguous view one float into its storage)."""
    from raft_ncup_tpu_torch.ops.nconv_cuda import nconv2d_fused, nconv2d_plain

    worst = 0.0
    for k, cin, cout, B, H, W, with_bias, aligned in NCONV_EDGES:
        d, c, w = nconv_inputs(torch, gen, B, H, W, k, cin, cout, False)
        if not aligned:
            d, c = (torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(x.shape)
                    for x in (d, c))
        bias = torch.randn(cout, generator=gen).cuda() if with_bias else None
        for a, b in zip(nconv2d_fused(d, c, w, bias), nconv2d_plain(d, c, w, bias)):
            err, ok = max_err(torch, a, b, **NCONV_TOL)
            check(ok, f"nconv kernel disagrees at k={k} {cin}->{cout} "
                      f"({B}, {H}, {W}) bias={with_bias} aligned={aligned}: {err:.3e}")
            worst = max(worst, err)
    print(f"kernel B edge cases: {len(NCONV_EDGES)} shapes (k in 1/3/5/7, Cout 8, bias, "
          f"ragged and tiny planes, misaligned rows): max|kernel-plain| {worst:.3e} "
          f"(atol {NCONV_TOL['atol']}, rtol {NCONV_TOL['rtol']})", flush=True)
    return worst


# ------------------------------------------------------ backward kernels

TRAIN_CORR = dict(B=6, H=50, W=90, C=256, levels=4, radius=4)  # a batch of 6 at 400x720
SMALL_TRAIN_CORR = dict(TRAIN_CORR, C=128, radius=3)  # the small model's fnet and radius
TRAIN_PLANES = (12, 400, 720)  # NCUP folds the 2 flow channels of 6 pairs
# Gradients against their plain versions, relative to the largest value of
# each plain gradient: sums in another order, and with float atomics in an
# order that changes from run to run. Kernel A' is held against its plain
# version run in float64: in float32 the plain version rounds each window
# tap's position on its own, and a query within float32 rounding of an
# integer (x = 59.999996 in the small model's smooth-flow row) gets taps on
# both sides of it, where the bilinear weights' derivative jumps: its d
# coords there were off by 3.4e-3 of the largest value against float64,
# while the kernel takes one fraction per query and level. Kernel B' is
# held against its plain version run in float64 too (its NaN and infinite
# places against the float32 run): cuDNN's float32 weight gradient on small
# planes is itself off by up to 2.1e-3 of its largest value, while the
# kernel stays within 1e-6. On
# B''s edge planes, smaller than the kernel's window, d conf = Gdc * data +
# Gc is a difference of two nearly equal terms (about 300 times the
# result for a 1x1 plane and k=7), hence the looser bound there.
GRAD_TOL = 1e-4
GRAD_EDGE_TOL = 1e-3


def backward_generator(torch):
    """The generator kernel A''s rows at the training shape (both mixes,
    in turn) and kernel B''s rows (the four layers, in turn) each draw from:
    seed 0 of their own, so chip_compare.py draws the same inputs without
    replaying this script's earlier phases."""
    return torch.Generator().manual_seed(0)


def corr_bwd_inputs(torch, gen, mix, s=None, dtype=None):
    """Kernel A''s inputs at the training shape ``s`` (default
    ``TRAIN_CORR``): f1s, the pyramid (features at ``dtype``, default f32),
    coords with ``mix`` flow, and the upstream gradient of the lookup."""
    s = s or TRAIN_CORR
    f1s, lv, coords = corr_inputs(torch, gen, s["B"], s["H"], s["W"], s["C"],
                                  s["levels"], mix, dtype)
    K = 2 * s["radius"] + 1
    g = torch.randn(*coords.shape[:3], s["levels"] * K * K, generator=gen).cuda()
    return f1s, lv, coords, g


def nconv_bwd_inputs(torch, gen, name, k, cin, cout):
    """Kernel B''s arguments at one NCUP layer of a training batch: data,
    conf, weight, no bias, kernel B's outputs, and the upstream gradients
    the model gives (none of nconv_out's conf_out)."""
    from raft_ncup_tpu_torch.ops.nconv_cuda import nconv2d_fused

    B, H, W = TRAIN_PLANES
    d, c, w = nconv_inputs(torch, gen, B, H, W, k, cin, cout, name == "nconv_in")
    out, conf_out = nconv2d_fused(d, c, w)
    go = torch.randn(out.shape, generator=gen).cuda()
    gc = None if name == "nconv_out" else torch.randn(out.shape, generator=gen).cuda()
    return d, c, w, None, out, conf_out, go, gc


def nconv_bwd_errs(torch, got, args):
    """(max |kernel - plain in float64| / max |plain in float64| over the
    places where the float32 plain version is finite, whether the NaN and
    infinite places equal the float32 plain version's, the max absolute
    difference there) for each of B''s outputs."""
    from raft_ncup_tpu_torch.ops.nconv_cuda import nconv2d_backward_plain

    ref = nconv2d_backward_plain(*args)
    ref64 = nconv2d_backward_plain(*(None if x is None else x.double() for x in args))
    errs = []
    for a, r, r64 in zip(got, ref, ref64):
        if r is None:
            continue
        same = grad_err(torch, a, r)[1]
        fin = torch.isfinite(r)
        scale = float(r64[fin].abs().max()) if bool(fin.any()) else 0.0
        diff = float((a[fin].double() - r64[fin]).abs().max()) if bool(fin.any()) else 0.0
        errs.append((diff / scale if scale > 0 else diff, same, diff))
    return errs


def bit_equal(torch, a, b) -> bool:
    """Whether two float32 tensors hold the same bits (NaN places too)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def grad_err(torch, a, b):
    """(max |a - b| / max |b| over the finite values, whether a and b are
    NaN or infinite at the same places and equal there, max |a - b| over
    the finite values)."""
    same_nonfinite = bool((torch.isfinite(a) == torch.isfinite(b)).all()) and bool(
        (a[~torch.isfinite(b)].nan_to_num(0.0, 1.0, -1.0)
         == b[~torch.isfinite(b)].nan_to_num(0.0, 1.0, -1.0)).all())
    fin = torch.isfinite(b)
    scale = float(b[fin].abs().max()) if bool(fin.any()) else 0.0
    diff = float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0
    return (diff / scale if scale > 0 else diff), same_nonfinite, diff


def corr_bwd_work(torch, f1s, lv, coords, radius, with_coords):
    """(bytes, flops, atomics) of the lookup's backward on these inputs:
    f1s, the levels, coords and the upstream gradient read once, d f1s and
    each d level written once (and d coords); per in-level window position
    2C flops into d f1s, 2C to scale f1 and add it into d f2 (C atomic adds),
    plus 2C for the patch's dot product with d coords; per tap 8 flops for
    the patch gradient (and 12 more for d coords)."""
    B, H, W, C = f1s.shape
    K = 2 * radius + 1
    n_taps = B * H * W * len(lv) * K * K
    # The forward's bytes (with g in place of its output), plus the writes.
    nbytes, fwd_flops = corr_work(torch, f1s, lv, coords, radius)
    positions = (fwd_flops - 7 * n_taps) // (2 * C)
    nbytes += 4 * (f1s.numel() + sum(t.numel() for t in lv))
    if with_coords:
        nbytes += 4 * coords.numel()
    flops = 4 * C * positions + 8 * n_taps
    if with_coords:
        flops += 2 * C * positions + 12 * n_taps
    return nbytes, flops, C * positions


def corr_bwd_ref(torch, f1s, lv, coords, radius, g, needs=(True, True, True)):
    """The plain version of kernel A' run in float64: what A' is held
    against."""
    from raft_ncup_tpu_torch.ops.corr_cuda import lookup_pyramid_backward

    return lookup_pyramid_backward(f1s.double(), [t.double() for t in lv], coords.double(),
                                   radius, g.double(), needs)


def corr_bwd_counts(torch, f1s, lv, coords, radius, g, needs):
    """One launch of kernel A' on these inputs: its gradients and its device
    counts (tiles per path, d f2 row adds), checked against the counts
    ``backward_work`` states from the coords."""
    from raft_ncup_tpu_torch.ops import corr_cuda

    corr_cuda.reset_backward_counts()
    got = corr_cuda.lookup_levels_backward(f1s, lv, coords, radius, g, needs)
    counts = corr_cuda.backward_counts()
    want = corr_cuda.backward_work(
        coords, [(t.shape[1], t.shape[2]) for t in lv], radius, f1s.shape[-1], needs)
    check(counts == want, f"corr lookup backward counts {counts} differ from the "
                          f"predicted {want} (needs {needs})")
    return got, counts


def check_corr_bwd(torch, gen, flush, mix, plain_reps=1, s=None):
    """Kernel A (the forward) and A' at the training shape ``s`` (default
    ``TRAIN_CORR``) against their plain versions, on the card: the lookup,
    then d f1s, every d f2 level and d coords against the autograd of the
    plain lookup in float64, and the model's launch (d f1s and d f2) again
    with its device counts. Times the model's launch, with the bound, and
    the float32 plain version."""
    from raft_ncup_tpu_torch.ops.corr_cuda import (
        lookup_levels, lookup_levels_backward, lookup_pyramid, lookup_pyramid_backward)

    s = s or TRAIN_CORR
    f1s, lv, coords, g = corr_bwd_inputs(torch, gen, mix, s)
    r = s["radius"]
    fwd_err, fwd_ok = max_err(torch, lookup_levels(f1s, lv, coords, r),
                              lookup_pyramid(f1s, lv, coords, r), **CORR_TOL)
    check(fwd_ok, f"corr lookup kernel disagrees with its plain version at the training "
                  f"shape ({mix} flow): {fwd_err:.3e}")
    model_path = (True, True, False)
    got = lookup_levels_backward(f1s, lv, coords, r, g)
    model, counts = corr_bwd_counts(torch, f1s, lv, coords, r, g, model_path)
    ref = corr_bwd_ref(torch, f1s, lv, coords, r, g)
    errs = {"d_f1s": grad_err(torch, got[0], ref[0]),
            "d_coords": grad_err(torch, got[2], ref[2]),
            "model_d_f1s": grad_err(torch, model[0], ref[0])}
    for l, (a, m, b) in enumerate(zip(got[1], model[1], ref[1])):
        errs[f"d_f2_level{l}"] = grad_err(torch, a, b)
        errs[f"model_d_f2_level{l}"] = grad_err(torch, m, b)
    del got, model, ref
    ms = cuda_ms(torch, lambda: lookup_levels_backward(f1s, lv, coords, r, g, model_path),
                 10, flush)
    ms_no_atomics = cuda_ms(
        torch, lambda: lookup_levels_backward(f1s, lv, coords, r, g, (True, False, False)),
        10, flush)
    plain_ms = cuda_ms(
        torch, lambda: lookup_pyramid_backward(f1s, lv, coords, r, g, model_path),
        plain_reps, flush)
    nbytes, flops, atomics = corr_bwd_work(torch, f1s, lv, coords, r, False)
    t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * flops / PEAK_F32_FLOPS
    row = dict(
        shape=f"B={s['B']} level0={s['H']}x{s['W']} C={s['C']} L={s['levels']} r={r} "
              f"{mix} flow", max_abs_err=max(a for _, _, a in errs.values()),
        max_rel_err=max(e for e, _, _ in errs.values()), ms=ms, ms_without_d_f2=ms_no_atomics,
        plain_ms=plain_ms, bytes=nbytes, flops=flops, atomics=atomics,
        atomics_issued=s["C"] * counts["d_f2_row_adds"], counts=counts,
        bound_ms=max(t_bytes, t_ops), bound_by="operations" if t_ops >= t_bytes else "bytes",
        errors={k: e for k, (e, _, _) in errs.items()}, forward_max_abs_err=fwd_err)
    print(f"kernel A at the training shape, {mix} flow: max|kernel-plain| {fwd_err:.3e} "
          f"(atol {CORR_TOL['atol']})", flush=True)
    print(f"kernel A' {row['shape']}: max |kernel-plain| / max |plain| "
          f"{json.dumps(row['errors'])} (tolerance {GRAD_TOL}); kernel {ms:.4f} ms "
          f"(without d f2 {ms_no_atomics:.4f} ms), plain {plain_ms:.2f} ms, "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, {flops / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB); (tile, level) pairs {counts['tiled']} tiled / "
          f"{counts['per_query']} per-query, {counts['d_f2_row_adds']} d f2 row adds: "
          f"{row['atomics_issued'] / 1e9:.3f} G scalar atomic adds where one per window "
          f"position would be {atomics / 1e9:.3f} G", flush=True)
    for name, (e, same, _) in errs.items():
        check(same and e <= GRAD_TOL,
              f"corr lookup backward kernel disagrees for {name} ({mix}): {e:.3e}")
    return row


def bf16_grad_err(torch, a, ref):
    """(max over the values of (|a - ref| - BF16_ROUNDING |ref|) / max |ref|,
    whether a is finite where ref is) for a bf16 gradient ``a`` against its
    float64 reference: what is left of the difference once the one
    rounding to bf16 is allowed for."""
    a, ref = a.double(), ref.double()
    scale = float(ref.abs().max())
    excess = float(((a - ref).abs() - BF16_ROUNDING * ref.abs()).clamp(min=0).max())
    same = bool((torch.isfinite(a) == torch.isfinite(ref)).all())
    return (excess / scale if scale > 0 else excess), same


def check_corr_bwd_bf16(torch, gen, mix):
    """The lookup as ``bf16_train`` runs it, at the training shape, on the
    card: kernel A on bf16 features against its plain version on the same
    bf16 values (CORR_TOL); then the lookup's autograd on those operands
    (``lookup_levels`` with bf16 features that need a gradient: kernel A
    forward, kernel A' on f32 copies of the saved bf16 operands, the
    cotangents cast back to bf16), with the model's gradients (d f1s, d
    f2) and with d coords too, against the float64 autograd of the plain
    lookup on the same bf16 values. d coords (f32) within GRAD_TOL of its
    largest value; d f1s and each d f2 level are bf16, so within GRAD_TOL
    of their largest value (times 1 + BF16_ROUNDING) once one rounding to
    bf16 (BF16_ROUNDING of each value) is allowed for."""
    from raft_ncup_tpu_torch.ops.corr_cuda import (
        lookup_levels, lookup_levels_backward, lookup_pyramid)

    bf16, s = torch.bfloat16, TRAIN_CORR
    f1s, lv, coords, g = corr_bwd_inputs(torch, gen, mix, s, bf16)
    r = s["radius"]
    fwd_err, fwd_ok = max_err(torch, lookup_levels(f1s, lv, coords, r),
                              lookup_pyramid(f1s, lv, coords, r), **CORR_TOL)
    check(fwd_ok, f"corr lookup kernel disagrees with its plain version on bf16 features "
                  f"at the training shape ({mix} flow): {fwd_err:.3e}")
    ref = corr_bwd_ref(torch, f1s, lv, coords, r, g)
    errs = {}
    for with_coords in (False, True):
        tag = "with d coords, " if with_coords else ""
        x1 = f1s.detach().requires_grad_()
        xl = [t.detach().requires_grad_() for t in lv]
        xc = coords.detach().requires_grad_(with_coords)
        before = (dict(lookup_levels.launches_by_dtype), lookup_levels_backward.launches)
        out = lookup_levels(x1, xl, xc, r)
        grads = torch.autograd.grad(out, [x1, *xl] + ([xc] if with_coords else []), g)
        fwd = {k: n - before[0].get(k, 0) for k, n in lookup_levels.launches_by_dtype.items()}
        check({k: n for k, n in fwd.items() if n} == {"bfloat16": 1}
              and lookup_levels_backward.launches - before[1] == 1,
              f"the bf16 lookup's autograd launched kernel A {fwd} and A' "
              f"{lookup_levels_backward.launches - before[1]} times, want once each")
        d1, dl = grads[0], grads[1:1 + len(lv)]
        check(d1.dtype == bf16 and all(d.dtype == bf16 for d in dl),
              f"the bf16 lookup's cotangents are {d1.dtype} / {[d.dtype for d in dl]}, "
              f"want the operands' bf16")
        e, same = bf16_grad_err(torch, d1, ref[0])
        errs[f"{tag}d_f1s"] = (e, same)
        for l, (a, b) in enumerate(zip(dl, ref[1])):
            errs[f"{tag}d_f2_level{l}"] = bf16_grad_err(torch, a, b)
        if with_coords:
            dc = grads[-1]
            check(dc.dtype == torch.float32, f"d coords is {dc.dtype}, want float32")
            e, same, _ = grad_err(torch, dc, ref[2])
            errs["with d coords, d_coords"] = (e, same)
        del out, grads
    bf16_tol = GRAD_TOL * (1 + BF16_ROUNDING)
    print(f"kernel A on bf16 features at the training shape, {mix} flow: max|kernel-plain| "
          f"{fwd_err:.3e} (atol {CORR_TOL['atol']}); its autograd (A' on f32 copies, "
          f"cotangents back to bf16) against the float64 plain autograd, max excess over "
          f"one bf16 rounding / max |plain| {json.dumps({k: e for k, (e, _) in errs.items()})} "
          f"(tolerance {bf16_tol:.6g}; d coords {GRAD_TOL})", flush=True)
    for name, (e, same) in errs.items():
        tol = GRAD_TOL if name.endswith("d_coords") else bf16_tol
        check(same and e <= tol,
              f"the bf16 lookup's autograd disagrees for {name} ({mix}): {e:.3e}")
    return dict(shape=f"B={s['B']} level0={s['H']}x{s['W']} C={s['C']} L={s['levels']} "
                      f"r={r} bfloat16 {mix} flow",
                forward_max_abs_err=fwd_err, errors={k: e for k, (e, _) in errs.items()})


def check_corr_bwd_edges(torch, gen):
    """Kernel A' against the autograd of the plain lookup, with and without
    d coords, at the forward's edge coords on 9x11 queries (not multiples
    of the 2x4 tile; levels 9x11, 4x5, 2x2, 1x1; windows fully off every
    side) for C in {4, 512} and radius in {0, 8}, and on smooth 33x47
    coords, where the tiled path runs, at C=252 (a lane without channels
    in the second slice) r=4, C=4 r=8 and C=128 r=0; each launch's device
    counts against ``backward_work``. Every gradient within GRAD_TOL of its
    largest value."""
    from raft_ncup_tpu_torch.ops.corr_cuda import prepare_levels

    cases = [(3, 9, 11, C, r, "edge") for C in (4, 512) for r in (0, 8)]
    cases += [(2, 33, 47, 252, 4, "smooth"), (1, 33, 47, 4, 8, "smooth"),
              (1, 33, 47, 128, 0, "smooth")]
    worst = {"d_f1s": 0.0, "d_f2": 0.0, "d_coords": 0.0}
    totals = {"tiled": 0, "per_query": 0, "d_f2_row_adds": 0}
    for B, H, W, C, r, kind in cases:
        f1 = torch.randn(B, H, W, C, generator=gen)
        f2 = torch.randn(B, H, W, C, generator=gen)
        if kind == "edge":
            coords = edge_coords(torch, gen, B, H, W)
        else:
            y, x = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
            grid = torch.stack([x, y], -1).float()[None].expand(B, H, W, 2)
            coords = grid + smooth_flow(torch, gen, B, H, W, coarse=(2, 3)) / 4
        f1s, lv = prepare_levels(f1.cuda(), f2.cuda(), 4)
        coords = coords.contiguous().cuda()
        K = 2 * r + 1
        g = torch.randn(B, H, W, 4 * K * K, generator=gen).cuda()
        ref = corr_bwd_ref(torch, f1s, lv, coords, r, g)
        for needs in ((True, True, False), (True, True, True)):
            got, counts = corr_bwd_counts(torch, f1s, lv, coords, r, g, needs)
            errs = {"d_f1s": grad_err(torch, got[0], ref[0])}
            errs["d_f2"] = max((grad_err(torch, a, b) for a, b in zip(got[1], ref[1])),
                               key=lambda e: e[0])
            if needs[2]:
                errs["d_coords"] = grad_err(torch, got[2], ref[2])
            for name, (e, same, _) in errs.items():
                check(same and e <= GRAD_TOL,
                      f"corr lookup backward kernel disagrees for {name} at B={B} {H}x{W} "
                      f"C={C} r={r} ({kind}, needs {needs}): {e:.3e}")
                worst[name] = max(worst[name], e)
            if kind == "edge":  # every window of elements 2.. outside every level
                check(not bool(got[0][2:].any()), f"far windows gave d f1s at C={C} r={r}")
                if needs[2]:
                    check(not bool(got[2][2:].any()), f"far windows gave d coords at C={C}")
            totals = {k: totals[k] + counts[k] for k in totals}
    check(totals["tiled"] > 0 and totals["per_query"] > 0,
          f"kernel A' edge cases did not take both paths: {totals}")
    print(f"kernel A' edge cases: {len(cases)} shapes x (without, with d coords) (C in "
          f"4/252/128/512, r in 0/4/8, 9x11 and 33x47 queries, levels down to 1x1, far "
          f"windows on every side): max |kernel-plain| / max |plain| {json.dumps(worst)} "
          f"(tolerance {GRAD_TOL}); counts {totals}", flush=True)
    return worst


def nconv_bwd_work(B, H, W, k, cin, cout, bias, with_gc=True):
    """(bytes, flops) of the NConv2d backward: data, conf, weight, out,
    conf_out, go (and gc, bias) read once, d data, d conf, d weight (and
    d bias) written once; per in-bounds tap and input channel 8 flops per
    output channel (two transposed convolutions and two weight-gradient
    sums) and one multiply (data*conf); 12 flops per output pixel for gN,
    gD and the reductions, 3 per input pixel for d data and d conf."""
    p = k // 2

    def along(n):
        return sum(max(0, n - abs(d)) for d in range(-p, p + 1))

    taps = along(H) * along(W)
    n_in, n_out = B * cin * H * W, B * cout * H * W
    nw = cout * cin * k * k
    nbytes = 4 * (2 * n_in + nw + (3 + with_gc) * n_out + 2 * n_in + nw)
    if bias:
        nbytes += 4 * 2 * cout
    flops = B * cin * taps * (1 + 8 * cout) + 12 * n_out + 3 * n_in
    return nbytes, flops


def check_backward(torch, gen, flush):
    """Kernels A' and B' on the card: A' at the flagship's training shape
    and at the small model's (random, then smooth flow, each shape from
    its own ``backward_generator``), B' at the NCUP layers (from its own),
    and A''s edge phase from ``gen``. Returns A''s rows at each shape and
    B''s rows."""
    rows_gen = backward_generator(torch)
    corr_bwd = [check_corr_bwd(torch, rows_gen, flush, mix) for mix in ("random", "smooth")]
    rows_gen = backward_generator(torch)
    corr_bwd_small = [check_corr_bwd(torch, rows_gen, flush, mix, s=SMALL_TRAIN_CORR)
                      for mix in ("random", "smooth")]
    check_corr_bwd_edges(torch, gen)
    return corr_bwd, corr_bwd_small, check_nconv_bwd(torch, backward_generator(torch), flush)


def check_nconv_bwd(torch, gen, flush):
    """Kernels B (the forward) and B' against their plain versions at the
    four NCUP layers of a training batch (12 planes of 400x720), B' with
    the upstream gradients the model gives them (no gradient of
    nconv_out's conf_out) and timed with its bound; then B' at the edge
    shapes of kernel B, with bias, and with a zero-confidence region,
    where both must give NaN at the same places."""
    from raft_ncup_tpu_torch.ops.nconv_cuda import (
        nconv2d_backward, nconv2d_backward_plain, nconv2d_fused, nconv2d_plain)

    B, H, W = TRAIN_PLANES
    rows = []
    for name, k, cin, cout in NCUP_LAYERS:
        args = nconv_bwd_inputs(torch, gen, name, k, cin, cout)
        d, c, w, _, out, conf_out, _, gc = args
        fwd = [max_err(torch, a, b, **NCONV_TOL)
               for a, b in zip((out, conf_out), nconv2d_plain(d, c, w))]
        check(all(ok for _, ok in fwd), f"nconv kernel disagrees with its plain version "
                                        f"for {name} at the training planes")
        got = nconv2d_backward(*args)
        again = nconv2d_backward(*args)
        torch.cuda.synchronize()
        check(bit_equal(torch, got[2], again[2]),
              f"nconv backward kernel's d weight differs between two runs for {name}")
        errs = nconv_bwd_errs(torch, got, args)
        ms = cuda_ms(torch, lambda: nconv2d_backward(*args), 20, flush)
        plain_ms = cuda_ms(torch, lambda: nconv2d_backward_plain(*args), 20, flush)
        nbytes, flops = nconv_bwd_work(B, H, W, k, cin, cout, False, gc is not None)
        t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * flops / PEAK_F32_FLOPS
        row = dict(layer=name, shape=f"({B}, {cin}->{cout}, {H}, {W}) k={k}",
                   max_abs_err=max(a for _, _, a in errs),
                   max_rel_err=max(e for e, _, _ in errs), ms=ms, plain_ms=plain_ms,
                   bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   forward_max_abs_err=max(e for e, _ in fwd))
        print(f"kernel B {name} at the training planes: max|kernel-plain| "
              f"{row['forward_max_abs_err']:.3e} (atol {NCONV_TOL['atol']}, "
              f"rtol {NCONV_TOL['rtol']})", flush=True)
        print(f"kernel B' {name}: {row['shape']}: max |kernel-plain| / max |plain| "
              f"d data {errs[0][0]:.3e}, d conf {errs[1][0]:.3e}, d weight {errs[2][0]:.3e} "
              f"(tolerance {GRAD_TOL}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
        check(all(same and e <= GRAD_TOL for e, same, _ in errs),
              f"nconv backward kernel disagrees with its plain version for {name}")
        rows.append(row)
    worst = 0.0
    cases = [(k, cin, cout, b, h, w, bias, aligned, False)
             for k, cin, cout, b, h, w, bias, aligned in NCONV_EDGES]
    cases += [(3, 1, 2, 2, 40, 64, True, True, True), (5, 2, 2, 1, 33, 70, False, True, True)]
    for k, cin, cout, b, h, w, with_bias, aligned, stuffed in cases:
        d, c, wt = nconv_inputs(torch, gen, b, h, w, k, cin, cout, stuffed)
        if stuffed:  # a corner with no confidence at all: D = 0 there
            c[:, :, : h // 2, : w // 2] = 0
        if not aligned:
            d, c = (torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(x.shape)
                    for x in (d, c))
        bias = torch.randn(cout, generator=gen).cuda() if with_bias else None
        out, conf_out = nconv2d_fused(d, c, wt, bias)
        go = torch.randn(out.shape, generator=gen).cuda()
        gc = torch.randn(out.shape, generator=gen).cuda()
        args = (d, c, wt, bias, out, conf_out, go, gc)
        got = nconv2d_backward(*args)
        again = nconv2d_backward(*args)
        check(all(a is None or bit_equal(torch, a, b) for a, b in zip(got[2:], again[2:])),
              f"nconv backward kernel's d weight or d bias differs between two runs at "
              f"k={k} {cin}->{cout} ({b}, {h}, {w})")
        for i, (e, same, _) in enumerate(nconv_bwd_errs(torch, got, args)):
            check(same and e <= GRAD_EDGE_TOL,
                  f"nconv backward kernel disagrees at k={k} {cin}->{cout} ({b}, {h}, {w}) "
                  f"bias={with_bias} aligned={aligned} stuffed={stuffed}, output {i}: "
                  f"{e:.3e} (same NaN/inf places: {same})")
            worst = max(worst, e)
        if stuffed:
            check(not bool(torch.isfinite(got[1]).all()),
                  "the zero-confidence case gave no NaN, so it tests nothing")
    print(f"kernel B' edge cases: {len(cases)} shapes (k in 1/3/5/7, Cout 8, bias, ragged, "
          f"tiny and misaligned planes, two with a zero-confidence corner whose NaN "
          f"places agree): max |kernel-plain| / max |plain| {worst:.3e} "
          f"(tolerance {GRAD_EDGE_TOL})", flush=True)
    return rows


def check_wrappers_refuse(torch):
    """On a CUDA tensor a wrapper launches its kernel or raises: inputs
    of another dtype or a non-contiguous layout raise instead of falling
    back to the plain version, with or without a gradient. Kernel A takes
    f32 or bf16 features, one dtype for all; A', B and B' take f32 only."""
    from raft_ncup_tpu_torch.ops.corr_cuda import lookup_levels, lookup_levels_backward
    from raft_ncup_tpu_torch.ops.nconv_cuda import nconv2d_backward, nconv2d_fused

    f1 = torch.randn(1, 8, 8, 16, device="cuda")
    lv = [torch.randn(1, 8, 8, 16, device="cuda")]
    co = torch.zeros(1, 8, 8, 2, device="cuda")
    g = torch.zeros(1, 8, 8, 25, device="cuda")
    d = torch.randn(1, 1, 8, 8, device="cuda")
    w = torch.rand(2, 1, 3, 3, device="cuda")
    o = torch.zeros(1, 2, 8, 8, device="cuda")
    half = [t.bfloat16() for t in lv]
    cases = [
        ("corr, float64", TypeError, lambda: lookup_levels(f1.double(), lv, co, 2)),
        ("corr, float16", TypeError,
         lambda: lookup_levels(f1.half(), [t.half() for t in lv], co, 2)),
        ("corr, bf16 f1 with f32 levels", TypeError,
         lambda: lookup_levels(f1.bfloat16(), lv, co, 2)),
        ("corr, f32 f1 with bf16 levels", TypeError, lambda: lookup_levels(f1, half, co, 2)),
        ("corr, non-contiguous", ValueError,
         lambda: lookup_levels(f1.transpose(1, 2), lv, co, 2)),
        ("corr, bf16 non-contiguous", ValueError,
         lambda: lookup_levels(f1.bfloat16().transpose(1, 2), half, co, 2)),
        ("corr, float64 with a gradient", TypeError,
         lambda: lookup_levels(f1.double().requires_grad_(), lv, co, 2)),
        ("corr backward, bf16", TypeError,
         lambda: lookup_levels_backward(f1.bfloat16(), half, co, 2, g)),
        ("nconv, float64", TypeError, lambda: nconv2d_fused(d.double(), d.double(), w)),
        ("nconv, bf16", TypeError,
         lambda: nconv2d_fused(d.bfloat16(), d.bfloat16(), w.bfloat16())),
        ("nconv, non-contiguous", ValueError,
         lambda: nconv2d_fused(d.transpose(2, 3), d, w)),
        ("nconv, non-contiguous with a gradient", ValueError,
         lambda: nconv2d_fused(d.transpose(2, 3), d, w.clone().requires_grad_())),
        ("nconv backward, bf16", TypeError,
         lambda: nconv2d_backward(d.bfloat16(), d.bfloat16(), w.bfloat16(), None,
                                  o, o, o, None)),
    ]
    for what, exc, call in cases:
        try:
            call()
        except exc:
            continue
        raise CheckFailed(f"wrapper accepted an unsupported input: {what}")
    print(f"wrappers: {len(cases)} unsupported CUDA inputs refused", flush=True)


# ------------------------------------------------------------------- serve

def model_config(variant, small, **kw):
    from raft_ncup_tpu_torch.config import ModelConfig

    return ModelConfig(variant=variant, small=small, **kw)


def model_label(variant, small, precision="f32") -> str:
    return variant + (" small" if small else "") + (
        "" if precision == "f32" else f" {precision}")


def line_name(phase, label) -> str:
    """The name of a phase's JSON line: the flagship's keeps the bare
    phase name (``train:``, ``profile:``), another model's adds its label."""
    return phase if label == "raft_nc_dbl" else f"{phase} {label}"


def on_path(variant, train) -> set:
    """The kernels a model of ``variant`` launches: the lookup (A) always,
    NConv2d (B) with NCUP, and in training their backward kernels."""
    fwd = {"corr_lookup"} | ({"nconv"} if variant == "raft_nc_dbl" else set())
    bwd = {"corr_lookup_bwd"} | ({"nconv_bwd"} if variant == "raft_nc_dbl" else set())
    return fwd | bwd if train else fwd


def check_launches(launches, variant, train, what) -> None:
    """Every kernel of the path launched at least once, and no other."""
    want = on_path(variant, train)
    check(all(launches[k] > 0 for k in want) and not any(
        n for k, n in launches.items() if k not in want),
        f"{what}: launches {launches}, want at least one of each of {sorted(want)} only")


def check_serve(torch, card, variant="raft_nc_dbl", small=False, precision=None):
    """Serve ``SERVE_REQUESTS`` requests at ``SERVE_SIZE`` with one model
    (seeded weights, both kernels, f32), every kernel count set to 0 just
    before and read just after; check every answer, the kernels of the
    path (one lookup per GRU iteration of each batch) and one served pair
    against the same weights through the plain versions. With a
    ``precision`` preset the server runs the same f32-built model under it
    (``ServeConfig.precision``): every lookup on bf16 features, NCUP's 4
    NConv2d launches a batch at f32, and one served pair within
    ``FORWARD_EPE_BUDGET`` of the f32 forward and within ``BF16_PLAIN_SHARE``
    of that distance of the same preset's plain-version forward."""
    from raft_ncup_tpu_torch.models.raft import RAFT
    from raft_ncup_tpu_torch.ops import corr_cuda
    from raft_ncup_tpu_torch.ops.padding import InputPadder
    from raft_ncup_tpu_torch.serve import make_pairs, serve_pairs
    from raft_ncup_tpu_torch.config import ServeConfig

    label = model_label(variant, small, precision or "f32")
    cfg = ServeConfig(batch_sizes=(1, 2), iter_levels=(12,), queue_capacity=16,
                      precision=precision)
    model = RAFT(model_config(variant, small, corr_impl="pallas", nconv_impl="pallas"),
                 device="cuda", seed=0)
    pairs = make_pairs(SERVE_SIZE, SERVE_REQUESTS, seed=0)
    reset_launches()
    corr_cuda.reset_path_tiles()
    report, responses = serve_pairs(model, cfg, pairs, SERVE_SIZE)
    torch.cuda.synchronize()
    launches = read_launches()
    by_dtype = read_corr_launches_by_dtype()
    served_paths = corr_cuda.path_tiles()
    per_batch = report["corr_kernel_launches"] / report["serve_batches"]
    print(f"serve {label}: {report['serve_ok']}/{report['serve_requests']} ok at "
          f"{SERVE_SIZE[0]}x{SERVE_SIZE[1]}, batch sizes {cfg.batch_sizes}, "
          f"{cfg.iter_levels[0]} iterations; p50 {report['serve_p50_ms']} ms, "
          f"p99 {report['serve_p99_ms']} ms, {report['serve_pairs_per_sec']:.3f} pairs/s "
          f"on {card}; {report['stats']}; launches while serving "
          f"(warm-up included) {launches}, corr lookups per served batch {per_batch}; "
          f"corr lookup tiles by path {served_paths}; corr launches by feature dtype "
          f"{by_dtype}; report precision {report['precision']}", flush=True)
    check(report["errors"] == 0, f"serve errors: {[r.detail for r in responses if not r.ok]}")
    for r in responses:
        check(r.ok, f"request {r.request_id} answered {r.status}: {r.detail}")
        check(r.flow.shape == (*SERVE_SIZE, 2), f"flow shape {r.flow.shape}")
        check(bool(torch.isfinite(torch.from_numpy(r.flow)).all()), "non-finite flow")
    check_launches(launches, variant, False, f"serve {label}")
    check(per_batch == cfg.iter_levels[0],
          f"serve {label}: {per_batch} corr lookups per batch, want {cfg.iter_levels[0]}")
    if precision is not None:
        return check_served_preset(torch, model, variant, small, precision, pairs, responses,
                                   report, by_dtype, launches, label)

    # One served pair against the same weights through the plain versions.
    plain = RAFT(model_config(variant, small, corr_impl="onthefly", nconv_impl="xla"),
                 device="cuda", seed=0)
    plain.load_state_dict(model.state_dict(), strict=True)
    padder = InputPadder((*SERVE_SIZE, 3), mode="sintel")
    a, b = (torch.from_numpy(x)[None].cuda() for x in pairs[0])
    p1, p2 = padder.pad(a, b)
    lr_k, _ = model(p1, p2, iters=12)
    lr_p, up_p = plain(p1, p2, iters=12)
    served_up = torch.from_numpy(responses[0].flow).cuda()
    up_p = padder.unpad(up_p)[0]
    e_lr, ok_lr = max_err(torch, lr_k, lr_p, **FLOW_LR_TOL)
    e_up, ok_up = max_err(torch, served_up, up_p, **FLOW_UP_TOL)
    print(f"served {label} pair vs plain versions: max|flow_lr diff| {e_lr:.3e} "
          f"(atol {FLOW_LR_TOL['atol']}), max|flow_up diff| {e_up:.3e} "
          f"(atol {FLOW_UP_TOL['atol']}), max|flow_up| {float(up_p.abs().max()):.3f}",
          flush=True)
    check(ok_lr and ok_up, f"served {label} flow disagrees with the plain-version model")
    report.update(flow_lr_err=e_lr, flow_up_err=e_up, corr_path_tiles=served_paths,
                  corr_launches_per_batch=per_batch)
    del plain
    return model, report, launches


def check_served_preset(torch, model, variant, small, precision, pairs, responses, report,
                        by_dtype, launches, label):
    """The checks of a served preset (see ``check_serve``)."""
    from raft_ncup_tpu_torch.models.raft import RAFT
    from raft_ncup_tpu_torch.ops.padding import InputPadder
    from raft_ncup_tpu_torch.precision import FORWARD_EPE_BUDGET

    check(report["precision"] == precision, f"serve {label}: report names "
                                            f"{report['precision']}")
    check(by_dtype == {"bfloat16": launches["corr_lookup"]},
          f"serve {label}: corr launches by feature dtype {by_dtype}, want every one of "
          f"the {launches['corr_lookup']} on bfloat16")
    nconv_per_batch = report["nconv_kernel_launches"] / report["serve_batches"]
    want_nconv = 4 if variant == "raft_nc_dbl" else 0
    check(nconv_per_batch == want_nconv,
          f"serve {label}: {nconv_per_batch} NConv2d launches per batch, want {want_nconv}")
    plain = RAFT(model_config(variant, small, corr_impl="onthefly", nconv_impl="xla",
                              precision=precision), device="cuda", seed=0)
    plain.load_state_dict(model.state_dict(), strict=True)
    padder = InputPadder((*SERVE_SIZE, 3), mode="sintel")
    a, b = (torch.from_numpy(x)[None].cuda() for x in pairs[0])
    p1, p2 = padder.pad(a, b)
    served = torch.from_numpy(responses[0].flow).cuda()
    _, up_f32 = model(p1, p2, iters=12)
    _, up_plain = plain(p1, p2, iters=12)
    up_f32, up_plain = padder.unpad(up_f32)[0], padder.unpad(up_plain)[0]

    def epe(x, y):
        return float((x - y).norm(dim=-1).mean())

    e_f32, e_plain = epe(served, up_f32), epe(served, up_plain)
    print(f"served {label} pair: mean EPE against the f32 forward {e_f32:.4e} px (budget "
          f"{FORWARD_EPE_BUDGET}), against the {precision} plain-version forward "
          f"{e_plain:.4e} px (tolerance {BF16_PLAIN_SHARE} x {e_f32:.4e}); max|diff| "
          f"{float((served - up_f32).abs().max()):.3e} / "
          f"{float((served - up_plain).abs().max()):.3e}; max|flow_up| "
          f"{float(up_f32.abs().max()):.3f}; output {responses[0].flow.dtype}", flush=True)
    check(responses[0].flow.dtype.name == "float32", f"served {label} flow is not f32")
    check(e_f32 <= FORWARD_EPE_BUDGET, f"served {label} pair: mean EPE {e_f32} against "
                                       f"the f32 forward, budget {FORWARD_EPE_BUDGET}")
    check(e_plain <= BF16_PLAIN_SHARE * e_f32,
          f"served {label} pair: mean EPE {e_plain} against the plain-version forward, "
          f"tolerance {BF16_PLAIN_SHARE} x {e_f32}")
    report.update(epe_vs_f32=e_f32, epe_vs_plain=e_plain, corr_launches_by_dtype=by_dtype,
                  nconv_launches_per_batch=nconv_per_batch)
    del plain
    return model, report, launches


# ------------------------------------------------------------------- train

# scripts/train_raft_nc_things.sh: raft_nc_dbl, stage things (BatchNorm
# frozen; no BatchNorm in the upsampler), batch 6 at 400x720, 12 iterations,
# AdamW at lr 1.25e-4 with wdecay 5e-5 and eps 1e-8, clip 1.0, gamma 0.8,
# the cyclic schedule over num_steps + 100; the sentinel on. Seeded weights
# and synthetic pairs: the pretrained trunk and FlyingThings3D are not in
# the repository.
TRAIN_CFG = dict(name="chip_smoke", stage="things", lr=1.25e-4, num_steps=100_000,
                 batch_size=6, image_size=(400, 720), iters=12, wdecay=5e-5,
                 epsilon=1e-8, clip=1.0, gamma=0.8)
TRAIN_STEPS = 5
VARIANT_TRAIN_STEPS = 3  # the other trained models: fewer steps, the same width
SERVED_MODELS = (("raft_nc_dbl", False), ("raft", False), ("raft", True))  # (variant, small)
TRAINED_MODELS = (("raft", False), ("raft", True))  # besides the flagship
PLAIN_VERSIONS = (  # (module, function): every plain version of the four kernels
    ("ops.corr_cuda", "lookup_pyramid"), ("ops.corr_cuda", "lookup_pyramid_backward"),
    ("ops.nconv_cuda", "nconv2d_plain"), ("ops.nconv_cuda", "nconv2d_backward_plain"),
    ("ops.nconv", "nconv2d_plain"),
)
# One step through the kernels against the same step through the plain
# versions: the loss within STEP_LOSS_RTOL and each gradient within
# STEP_GRAD_TOL of its largest value, but for two kinds. Gradients below
# NEGLIGIBLE of the step's largest are rounding noise (the biases ahead of
# an instance norm: exactly zero) and are held by size. The upsampler's,
# within UPSAMPLER_TOL: they reach it through NConv's d conf = sum w go
# (d - out) / D, a difference of nearly equal terms while the flow it
# averages is smooth (near zero at initialization), and its U-Net's
# weights are near 2 in every layer, so their gradients are differences
# of nearly equal channels (2.8e-3 and 3.4e-3 in two runs on an H100).
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_TOL = 1e-3
NEGLIGIBLE = 1e-6
UPSAMPLER_TOL = 1e-2


def kernel_counters():
    from raft_ncup_tpu_torch.ops.corr_cuda import lookup_levels, lookup_levels_backward
    from raft_ncup_tpu_torch.ops.nconv_cuda import nconv2d_backward, nconv2d_fused

    return {"corr_lookup": lookup_levels, "corr_lookup_bwd": lookup_levels_backward,
            "nconv": nconv2d_fused, "nconv_bwd": nconv2d_backward}


def reset_launches() -> None:
    """Every kernel's launch count to 0, kernel A's by feature dtype too."""
    for fn in kernel_counters().values():
        fn.launches = 0
    kernel_counters()["corr_lookup"].launches_by_dtype.clear()


def read_launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in kernel_counters().items()}


def read_corr_launches_by_dtype() -> dict[str, int]:
    """Kernel A's launches since ``reset_launches``, by the features' dtype."""
    return dict(kernel_counters()["corr_lookup"].launches_by_dtype)


@contextlib.contextmanager
def counting_plain_versions():
    """Count every call of a kernel's plain version while inside (the
    calls still run)."""
    import importlib

    counts: dict[str, int] = {}
    saved = []
    for mod_name, fn_name in PLAIN_VERSIONS:
        mod = importlib.import_module(f"raft_ncup_tpu_torch.{mod_name}")
        fn = getattr(mod, fn_name)

        def counted(*args, _fn=fn, _name=f"{mod_name}.{fn_name}", **kwargs):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*args, **kwargs)

        saved.append((mod, fn_name, fn))
        setattr(mod, fn_name, counted)
    try:
        yield counts
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)


def profile_train_step(torch, step, state, batch) -> dict:
    """One call of the train step ``step`` in a ``torch.profiler`` trace,
    ended by a synchronise: its wall time, its kernel time and idle share,
    and for each of the step's own ``record_function`` ranges (forward,
    backward, optimizer) the host time of the range and the device time
    of the kernels launched inside it, from any thread (autograd runs the
    backward on its device thread), by kernel group, with the top kernels;
    the synchronising calls inside the step; and the host ops that take
    the most time."""
    from raft_ncup_tpu_torch.training.step import PHASES

    cpu = torch.autograd.DeviceType.CPU
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = prof.events()
    ranges = {e.name: (e.time_range.start, e.time_range.end) for e in events
              if e.name in PHASES and e.device_type == cpu}
    check(set(ranges) == set(PHASES), f"the trace lacks a phase of the step: {sorted(ranges)}")
    kernels: dict[str, dict[str, list]] = {p: {} for p in PHASES}
    for e in events:
        if e.device_type != cpu or not e.kernels:
            continue
        phase = next((p for p, (a, b) in ranges.items() if a <= e.time_range.start <= b), None)
        if phase is None:
            continue
        for k in e.kernels:
            acc = kernels[phase].setdefault(k.name, [0.0, 0])
            acc[0] += k.duration / 1e3
            acc[1] += 1
    # Every kernel, copy and fill on the card once: not the device spans
    # that the profiler adds for the step's record_function ranges.
    device = sum(e.time_range.elapsed_us() for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)) / 1e3
    # Host waits inside the step (the step itself reads nothing back).
    syncs = sum(1 for e in events if e.device_type == cpu and "Synchronize" in e.name
                and any(a <= e.time_range.start <= b for a, b in ranges.values()))
    phases = {}
    for p in PHASES:
        groups: dict[str, float] = {}
        for name, (ms, _) in kernels[p].items():
            groups[_kernel_group(name)] = groups.get(_kernel_group(name), 0.0) + ms
        top = sorted(kernels[p].items(), key=lambda kv: -kv[1][0])[:8]
        phases[p] = {"host_ms": (ranges[p][1] - ranges[p][0]) / 1e3,
                     "device_ms": sum(ms for ms, _ in kernels[p].values()),
                     "by_group": groups,
                     "top": [{"kernel": k[:100], "ms": ms, "launches": n}
                             for k, (ms, n) in top]}
    host = sorted((e for e in prof.key_averages() if getattr(e, "device_type", None) == cpu),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    return {"wall_ms": wall, "device_ms": device, "idle_share": 1.0 - device / wall,
            "unattributed_device_ms": device - sum(v["device_ms"] for v in phases.values()),
            "host_syncs_in_step": syncs,
            "phases": phases,
            "top_host_ops": [{"op": e.key[:80], "self_cpu_ms": e.self_cpu_time_total / 1e3,
                              "calls": e.count} for e in host]}


def check_train(torch, card, variant="raft_nc_dbl", small=False, steps=TRAIN_STEPS,
                extras=True, precision="f32", profile=None) -> dict:
    """A main path: ``steps`` steps of one model's training at the full
    configuration above, through the lookup kernel and its backward (and,
    with NCUP, the NConv2d kernel and its backward), every kernel count set
    to 0 just before and read just after; finite losses, no skipped step,
    no plain version called, each kernel launched as often as the step's
    structure says. With ``extras``, then the peak memory of one step
    without remat; with ``profile`` (default: ``extras``) a profiled step.
    Under ``precision`` bf16_train the lookup takes bf16 features, and its
    backward, NConv2d and its backward take f32 (their wrappers raise on
    anything else), with the same launches as f32."""
    from raft_ncup_tpu_torch.config import TrainConfig
    from raft_ncup_tpu_torch.data.synthetic import SyntheticFlowDataset
    from raft_ncup_tpu_torch.training.state import create_train_state
    from raft_ncup_tpu_torch.training.step import make_train_step

    label = model_label(variant, small, precision)
    profile = extras if profile is None else profile
    cfg = TrainConfig(**TRAIN_CFG, precision=precision)
    model_cfg = model_config(variant, small, dataset=cfg.stage, corr_impl="pallas",
                             nconv_impl="pallas", precision=precision)
    state = create_train_state(model_cfg, cfg, "cuda")
    data = SyntheticFlowDataset(cfg.image_size, seed=cfg.seed)
    batches = [data.batch(i, cfg.batch_size, "cuda") for i in range(steps)]
    step = make_train_step(cfg)
    torch.cuda.synchronize()
    from raft_ncup_tpu_torch.ops import corr_cuda

    losses, step_ms = [], []
    reset_launches()
    corr_cuda.reset_backward_counts()
    with counting_plain_versions() as plain_calls:
        for i, batch in enumerate(batches):
            if i == 1:  # the first step's autotuning tries large workspaces
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            metrics = step(state, batch)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(metrics["loss"]))
    launches = read_launches()
    by_dtype = read_corr_launches_by_dtype()
    bwd_counts = corr_cuda.backward_counts()
    peak_remat = torch.cuda.max_memory_allocated()
    skipped = int(state.sentinel["skipped"])
    per_step = {k: v / steps for k, v in launches.items()}
    report = {
        "card": card,
        "config": f"{label} stage {cfg.stage}, batch {cfg.batch_size} at "
                  f"{cfg.image_size[0]}x{cfg.image_size[1]}, {cfg.iters} iterations, "
                  f"{precision}, remat on, sentinel on",
        "losses": losses, "skipped": skipped, "step_ms": step_ms,
        f"median_ms_steps_2_to_{steps}": statistics.median(step_ms[1:]),
        "peak_gib_remat": peak_remat / 2**30,
        "launches": launches, "launches_per_step": per_step,
        "corr_lookup_bwd_counts": bwd_counts,
        "plain_version_calls": plain_calls,
        "corr_launches_by_feature_dtype": by_dtype,
    }
    if extras:
        torch.cuda.reset_peak_memory_stats()
        make_train_step(cfg, remat=False)(state, batches[0])
        torch.cuda.synchronize()
        report["peak_gib_no_remat"] = torch.cuda.max_memory_allocated() / 2**30
    if profile:
        report["profile"] = profile_train_step(torch, step, state, batches[1])
    print(f"{line_name('train', label)}: {json.dumps(report)}", flush=True)
    check(not plain_calls, f"plain versions ran during the {label} train steps: {plain_calls}")
    check(all(math.isfinite(x) for x in losses), f"non-finite {label} train loss: {losses}")
    check(skipped == 0, f"the sentinel skipped {skipped} of {steps} {label} steps")
    check_launches(launches, variant, True, f"train {label}")
    # Per step: the lookup in each iteration's forward and in remat's
    # recompute, its backward once an iteration; the 4 NCUP layers likewise.
    ncup = variant == "raft_nc_dbl"
    want = {"corr_lookup": 2 * cfg.iters, "corr_lookup_bwd": cfg.iters,
            "nconv": 8 * cfg.iters if ncup else 0, "nconv_bwd": 4 * cfg.iters if ncup else 0}
    check(per_step == want, f"{label} launches per step {per_step}, want {want}")
    want_dtype = "float32" if precision == "f32" else "bfloat16"
    check(by_dtype == {want_dtype: launches["corr_lookup"]},
          f"{label}: corr launches by feature dtype {by_dtype}, want {want_dtype} only")
    check(all(p.dtype == torch.float32 for p in state.model.parameters())
          and all(t.dtype == torch.float32 for t in state.optimizer.mu + state.optimizer.nu),
          f"{label}: a parameter or an optimizer moment is not f32")
    del state, batches
    torch.cuda.empty_cache()
    return report


def _step_grads(torch, variant, small, corr_impl, nconv_impl, batch, cfg):
    from raft_ncup_tpu_torch.models.raft import RAFT
    from raft_ncup_tpu_torch.training.state import state_for
    from raft_ncup_tpu_torch.training.step import loss_and_grads

    model = RAFT(model_config(variant, small, dataset=cfg.stage, corr_impl=corr_impl,
                              nconv_impl=nconv_impl), device="cuda", seed=0)
    state = state_for(model, cfg)
    loss, _, grads = loss_and_grads(state, batch, cfg)
    out = float(loss), {n: g.detach() for (n, _), g in zip(state.named_params, grads)}
    del model, state, grads
    torch.cuda.empty_cache()
    return out


def check_train_vs_plain(torch, variant="raft_nc_dbl", small=False) -> dict:
    """One step at batch 2, 400x720, from the same seeded weights and
    batch, through the kernels and through the plain versions (the
    on-the-fly lookup and the two-convolution NConv2d, differentiated by
    autograd): the loss and every gradient tensor."""
    from raft_ncup_tpu_torch.config import TrainConfig
    from raft_ncup_tpu_torch.data.synthetic import SyntheticFlowDataset

    label = model_label(variant, small)
    cfg = TrainConfig(**{**TRAIN_CFG, "batch_size": 2})
    batch = SyntheticFlowDataset(cfg.image_size, seed=cfg.seed).batch(0, 2, "cuda")
    reset_launches()
    k_loss, k_grads = _step_grads(torch, variant, small, "pallas", "pallas", batch, cfg)
    check_launches(read_launches(), variant, True, f"the {label} kernel step")
    p_loss, p_grads = _step_grads(torch, variant, small, "onthefly", "xla", batch, cfg)
    gmax = max(float(g.abs().max()) for g in p_grads.values())
    tols = {"default": STEP_GRAD_TOL, "upsampler": UPSAMPLER_TOL}
    worst = {kind: (0.0, "") for kind in tols}
    negligible, failures = [], []
    for name, g in k_grads.items():
        r = p_grads[name]
        scale = float(r.abs().max())
        if scale < NEGLIGIBLE * gmax:
            negligible.append(name)
            if float(g.abs().max()) >= NEGLIGIBLE * gmax:
                failures.append(f"{name} is not negligible")
            continue
        kind = "upsampler" if name.startswith("upsampler.") else "default"
        err = float((g - r).abs().max()) / scale
        worst[kind] = max(worst[kind], (err, name))
        if err > tols[kind]:
            failures.append(f"{name}: {err:.3e} of its largest value (tolerance {tols[kind]})")
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    report = {"model": label, "loss_kernels": k_loss, "loss_plain": p_loss,
              "loss_rel_diff": loss_rel, "grad_rel_diff": worst, "tolerances": tols,
              "negligible_tensors": len(negligible), "tensors": len(k_grads)}
    print(f"train step, kernels vs plain versions (batch 2, 400x720): {json.dumps(report)}",
          flush=True)
    check(loss_rel <= STEP_LOSS_RTOL, f"{label} kernel step loss {k_loss} vs plain {p_loss}")
    check(not failures, f"{label} kernel step gradients differ from the plain step's: "
                        f"{failures}")
    return report


# ----------------------------------------------------------------- profile

PROFILE_BATCH = 2
PROFILE_REPS = 3
_CONV_MARKERS = ("conv", "gemm", "cudnn", "cutlass", "xmma", "implicit", "winograd", "fft")


def _kernel_group(name: str) -> str:
    low = name.lower()
    # A' launches corr_lookup_bwd_tile_kernel (or _query_kernel with d
    # coords); B' nconv_bwd_kernel and nconv_bwd_finalize.
    for marker, group in (("corr_lookup_bwd", "corr_lookup_bwd_kernel"),
                          ("corr_lookup_kernel", "corr_lookup_kernel"),
                          ("nconv_bwd", "nconv_bwd_kernel"), ("nconv_kernel", "nconv_kernel")):
        if marker in low:
            return group
    if any(m in low for m in _CONV_MARKERS):
        return "convolution"
    return "other"


def profile_forward(torch, model, card, replay=False) -> dict:
    """Where a served batch's time goes: ``PROFILE_REPS`` traced forwards
    of a served model at batch 2, 436x1024 (padded to 440x1024), 12
    iterations, on contiguous NHWC batches (as the server's), with cuDNN's
    autotuned algorithms; eager, or with ``replay`` replays of the
    forward's CUDA graph (``ShapeCachedForward``; its line adds ``graph``,
    and the pool's bytes). ``wall_ms`` is host time per forward ending in a synchronise,
    ``device_ms`` the summed kernel time per forward from the trace,
    ``idle_share`` 1 - device_ms / wall_ms. With no device time in the
    trace, ``device_ms`` is null rather than a host number."""
    import numpy as np
    from raft_ncup_tpu_torch.inference.pipeline import ShapeCachedForward
    from raft_ncup_tpu_torch.ops.padding import InputPadder
    from raft_ncup_tpu_torch.utils.device import cudnn_autotune

    h, w = SERVE_SIZE
    imgs = np.random.default_rng(1).uniform(0, 255, (2, PROFILE_BATCH, h, w, 3))
    padder = InputPadder((h, w, 3), mode="sintel")
    # Contiguous NHWC, as the server and the validators hand the model
    # their batches (the layout decides cuDNN's layout and algorithms).
    i1, i2 = (t.contiguous() for t in padder.pad(
        *(torch.from_numpy(x.astype(np.float32)).cuda() for x in imgs)))
    if replay:
        fwd = ShapeCachedForward(model)

        def run():
            return fwd.forward(i1, i2, iters=12)
    else:
        def run():
            return model(i1, i2, iters=12)
    # cuDNN keeps the algorithms it times under the autotuner, as every
    # capture does, so eager and replayed forwards run the same ones.
    with cudnn_autotune():
        for _ in range(2):
            run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_REPS):
            run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / PROFILE_REPS
    kernels: dict[str, float] = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", 0.0) or 0.0
        if us > 0:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us / 1e3 / PROFILE_REPS
    device_ms = sum(kernels.values()) if kernels else None
    groups: dict[str, float] = {}
    for name, ms in kernels.items():
        groups[_kernel_group(name)] = groups.get(_kernel_group(name), 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    label = model_label(model.cfg.variant, model.cfg.small, model.policy.name)
    prof_report = {
        "card": card,
        "model": label,
        "shape": f"batch {PROFILE_BATCH} at {h}x{w} (padded {i1.shape[1]}x{i1.shape[2]}), "
                 f"12 iterations, {model.policy.name}",
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "idle_share": None if device_ms is None else 1.0 - device_ms / wall_ms,
        "by_group": groups,
        "top": [{"kernel": k[:120], "ms": v} for k, v in top],
    }
    if replay:
        prof_report["graph"] = {"stats": dict(fwd.stats),
                                "pool_bytes": sum(fwd.pool_bytes.values())}
    name = line_name("profile", label) + (" graph" if replay else "")
    print(f"{name}: {json.dumps(prof_report)}", flush=True)
    return prof_report


# -------------------------------------------------------------- evaluation

# The evaluate paths: the flagship's synthetic validators at the Sintel
# size, 32 iterations (Sintel's), batch 2, 8 pairs each; the warm-start
# validator over synthetic Sintel-layout sequences of EVAL_FRAMES frames
# written with the port's codecs. Each forward replays a CUDA graph.
EVAL_ITERS = 32
EVAL_BATCH = 2
EVAL_PAIRS = 8
EVAL_SEQUENCES = 2
EVAL_FRAMES = 4
# A replay against an eager forward under the same flags runs the same
# kernels on the same inputs: equal bit for bit is expected, 1e-6 allowed.
REPLAY_TOL = 1e-6
# The card's float32 sums against a float64 fold of the same flows.
ACC_RTOL = 1e-5


def _host_metrics(kind, ups, gts, bands=None) -> dict:
    """``finalize`` of a float64 fold on the host of (B, H, W, 2) flows."""
    import numpy as np
    from raft_ncup_tpu_torch.inference import metrics

    acc = np.zeros(metrics.ACC_SIZES[kind])
    for k, (up, gt) in enumerate(zip(ups, gts)):
        epe = np.sqrt(((up.astype(np.float64) - gt) ** 2).sum(-1))
        acc[0] += epe.sum()
        acc[1] += epe.size
        if kind == "px":
            acc[2:5] += [(epe < t).sum() for t in (1.0, 3.0, 5.0)]
        if kind == "epe_band":
            band = bands[k].astype(np.float64)
            acc[2:6] += [(epe * band).sum(), band.sum(), (epe * (1 - band)).sum(),
                         (1 - band).sum()]
    return metrics.finalize(kind, acc)


def _close(got: dict, want: dict, rtol) -> float:
    """The largest relative difference of two metric dicts."""
    check(set(got) == set(want), f"metric keys {sorted(got)} against {sorted(want)}")
    return max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in want)


def eval_model(torch, precision="f32", dataset="sintel"):
    from raft_ncup_tpu_torch.models.raft import RAFT

    model = RAFT(model_config("raft_nc_dbl", False, corr_impl="pallas", nconv_impl="pallas",
                              dataset=dataset), device="cuda", seed=0)
    return model.with_policy(precision)


def check_eval(torch, card, precision="f32") -> tuple[dict, dict]:
    """The flagship's ``validate_synthetic`` and ``validate_synthetic_rigid``
    at 436x1024, 32 iterations, batch 2, 8 pairs each, under ``precision``,
    through one ``ShapeCachedForward``; the kernel counts set to 0 just
    before and read just after. Checks: one capture per key (2) and no
    eviction; A 32 and B 4 launches for every forward run (each capture's
    eager warm-up and every replay); every lookup on the preset's feature
    dtype; the metrics within ``ACC_RTOL`` of a float64 host fold of eager
    forwards of the same batches; every batch's replayed flows within
    ``REPLAY_TOL`` of the eager forward's; in f32, the first batch's also
    within the flow tolerances of the plain-version forward."""
    import numpy as np
    from raft_ncup_tpu_torch import evaluation
    from raft_ncup_tpu_torch.config import DataConfig
    from raft_ncup_tpu_torch.data.synthetic import SyntheticFlowDataset, flow_boundary_mask
    from raft_ncup_tpu_torch.inference.pipeline import ShapeCachedForward
    from raft_ncup_tpu_torch.ops.padding import InputPadder

    model = eval_model(torch, precision)
    label = model_label("raft_nc_dbl", False, precision)
    fwd = ShapeCachedForward(model)
    cfg = DataConfig(num_workers=4)
    kw = dict(iters=EVAL_ITERS, batch_size=EVAL_BATCH, size_hw=SERVE_SIZE, length=EVAL_PAIRS,
              fwd=fwd)
    reset_launches()
    t0 = time.perf_counter()
    results = {"smooth": evaluation.validate_synthetic(model, cfg, **kw),
               "rigid": evaluation.validate_synthetic_rigid(model, cfg, **kw)}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    by_dtype = read_corr_launches_by_dtype()
    stats = dict(fwd.stats)
    batches = 2 * EVAL_PAIRS // EVAL_BATCH
    forwards = 2 * stats["compiles"] + stats["hits"]  # a capture runs one eager warm-up
    check(stats == {"compiles": 2, "hits": batches - 2, "evictions": 0},
          f"evaluate {label}: cache stats {stats}, want 2 captures, {batches - 2} hits")
    check_launches(launches, "raft_nc_dbl", False, f"evaluate {label}")
    check(launches["corr_lookup"] == EVAL_ITERS * forwards and launches["nconv"] == 4 * forwards,
          f"evaluate {label}: launches {launches} for {forwards} forwards of "
          f"{EVAL_ITERS} iterations")
    feature = "float32" if precision == "f32" else "bfloat16"
    check(by_dtype == {feature: launches["corr_lookup"]},
          f"evaluate {label}: corr launches by feature dtype {by_dtype}")
    pool = sum(fwd.pool_bytes.values())

    replay_err, plain = 0.0, {}
    folds = {}
    padder = InputPadder((*SERVE_SIZE, 3), mode="sintel")
    for style, kind in (("smooth", "epe"), ("rigid", "epe_band")):
        ds = SyntheticFlowDataset(SERVE_SIZE, length=EVAL_PAIRS, seed=999, style=style)
        ups, gts, bands = [], [], []
        for b in range(0, EVAL_PAIRS, EVAL_BATCH):
            samples = [ds.sample(i) for i in range(b, b + EVAL_BATCH)]
            # Contiguous, as the validator's host-padded batches: under bf16
            # cuDNN picks its algorithms by the input's layout too.
            i1, i2 = (t.contiguous() for t in padder.pad(
                *(torch.stack([s[k] for s in samples]).cuda().float()
                  for k in ("image1", "image2"))))
            lr, up = model(i1, i2, iters=EVAL_ITERS)
            ups.append(padder.unpad(up).cpu().numpy())
            gts.append(np.stack([s["flow"].numpy() for s in samples]))
            bands.append(np.stack([flow_boundary_mask(s["flow"]) for s in samples]))
            g_lr, g_up = fwd.forward(i1, i2, EVAL_ITERS)
            replay_err = max(replay_err, float((g_lr - lr).abs().max()),
                             float((g_up - up).abs().max()))
            if precision == "f32" and not plain:
                plain = check_plain_forward(torch, model, i1, i2, lr, up, label)
        folds[style] = _host_metrics(kind, ups, gts, bands)
    prefixes = {"smooth": "synthetic", "rigid": "synthetic_rigid"}
    got = {style: {k.removeprefix(prefixes[style]).lstrip("_") or "epe": v
                   for k, v in results[style].items()} for style in results}
    acc_err = max(_close(got[s], folds[s], ACC_RTOL) for s in folds)
    report = {"card": card, "model": label, "results": results, "host_fold": folds,
              "wall_s": wall,
              "pairs_per_sec": 2 * EVAL_PAIRS / wall, "stats": stats, "launches": launches,
              "corr_launches_by_dtype": by_dtype, "graph_pool_bytes": pool,
              "replay_vs_eager_max_abs": replay_err, "metrics_vs_host_fold_max_rel": acc_err,
              **plain}
    print(f"{line_name('evaluate', label)}: {json.dumps(report)}", flush=True)
    check(replay_err <= REPLAY_TOL, f"evaluate {label}: a replay differs from the eager "
                                    f"forward by {replay_err}")
    check(acc_err <= ACC_RTOL, f"evaluate {label}: metrics differ from the host fold by "
                               f"{acc_err} relative")
    return report, launches


def check_plain_forward(torch, model, i1, i2, lr, up, label) -> dict:
    """One f32 batch's flows against the same weights through the plain
    versions (flow_lr atol 2e-3, flow_up atol 5e-3, rtol 1e-3)."""
    from raft_ncup_tpu_torch.models.raft import RAFT

    plain = RAFT(model_config("raft_nc_dbl", False, corr_impl="onthefly", nconv_impl="xla",
                              dataset=model.cfg.dataset), device="cuda", seed=0)
    plain.load_state_dict(model.state_dict(), strict=True)
    lr_p, up_p = plain(i1, i2, iters=EVAL_ITERS)
    e_lr, ok_lr = max_err(torch, lr, lr_p, **FLOW_LR_TOL)
    e_up, ok_up = max_err(torch, up, up_p, **FLOW_UP_TOL)
    check(ok_lr and ok_up, f"evaluate {label}: flows against the plain versions: "
                           f"flow_lr {e_lr}, flow_up {e_up}")
    return {"flow_lr_vs_plain": e_lr, "flow_up_vs_plain": e_up}


def write_sintel_sequences(root: str, seed: int = 0) -> None:
    """A Sintel-layout training split (clean and final) of
    ``EVAL_SEQUENCES`` scenes of ``EVAL_FRAMES`` frames at the Sintel size,
    written with the port's codecs: each scene a smooth random image
    shifted by a whole number of pixels per frame, its flow that shift."""
    import numpy as np
    from raft_ncup_tpu_torch.io import write_flo, write_png

    rng = np.random.default_rng(seed)
    h, w = SERVE_SIZE
    for s in range(EVAL_SEQUENCES):
        coarse = rng.uniform(0, 255, (h // 16 + 1, w // 16 + 1, 3))
        base = np.kron(coarse, np.ones((16, 16, 1)))[:h, :w]
        dy, dx = (int(v) for v in rng.integers(-6, 7, size=2))
        scene = f"scene_{s}"
        for dstype in ("clean", "final"):
            d = os.path.join(root, "training", dstype, scene)
            os.makedirs(d, exist_ok=True)
            for f in range(EVAL_FRAMES):
                frame = np.roll(base, (f * dy, f * dx), axis=(0, 1))
                if dstype == "final":
                    frame = frame + rng.normal(0, 4, frame.shape)
                write_png(os.path.join(d, f"frame_{f:04d}.png"),
                          np.clip(frame, 0, 255).astype(np.uint8))
        fd = os.path.join(root, "training", "flow", scene)
        os.makedirs(fd, exist_ok=True)
        for f in range(EVAL_FRAMES - 1):
            flow = np.broadcast_to(np.float32([dx, dy]), (h, w, 2))
            write_flo(os.path.join(fd, f"frame_{f:04d}.flo"), flow)


def check_eval_warm(torch, card, root: str) -> tuple[dict, dict]:
    """``validate_sintel_warm`` of the f32 flagship over the sequences of
    :func:`write_sintel_sequences` (PNG frames and ``.flo`` flows through
    the port's codecs and its Sintel reader), 32 iterations, each frame
    warm-started from the splat of the previous one on the card. Checks
    one capture and no eviction, A 32 and B 4 launches a forward run, and
    the metrics within ``ACC_RTOL`` of a float64 host fold of the same
    chain run eagerly (which also compares every replay with its eager
    forward)."""
    import numpy as np
    from raft_ncup_tpu_torch import evaluation
    from raft_ncup_tpu_torch.config import DataConfig
    from raft_ncup_tpu_torch.data.datasets import MpiSintel
    from raft_ncup_tpu_torch.inference.pipeline import ShapeCachedForward
    from raft_ncup_tpu_torch.ops.padding import InputPadder
    from raft_ncup_tpu_torch.ops.warmstart import forward_interpolate_batch

    model = eval_model(torch)
    fwd = ShapeCachedForward(model)
    cfg = DataConfig(root_sintel=root, num_workers=4)
    reset_launches()
    t0 = time.perf_counter()
    results = evaluation.validate_sintel_warm(model, cfg, iters=EVAL_ITERS, fwd=fwd)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    stats = dict(fwd.stats)
    frames = 2 * EVAL_SEQUENCES * (EVAL_FRAMES - 1)
    forwards = 2 * stats["compiles"] + stats["hits"]
    check(stats == {"compiles": 1, "hits": frames - 1, "evictions": 0},
          f"evaluate warm: cache stats {stats}")
    check_launches(launches, "raft_nc_dbl", False, "evaluate warm")
    check(launches["corr_lookup"] == EVAL_ITERS * forwards and launches["nconv"] == 4 * forwards,
          f"evaluate warm: launches {launches} for {forwards} forwards")
    err = 0.0
    for dstype in ("clean", "final"):
        ds = MpiSintel(split="training", root=root, dstype=dstype)
        ups, gts, prev, scene_prev = [], [], None, None
        for i in range(len(ds)):
            s = ds.sample(i)
            if ds.extra_info[i][0] != scene_prev:
                prev = None
            scene_prev = ds.extra_info[i][0]
            padder = InputPadder((1, *s["image1"].shape), mode="sintel")
            p1, p2 = (t.contiguous() for t in padder.pad(
                *(torch.from_numpy(s[k].astype(np.float32))[None].cuda()
                  for k in ("image1", "image2"))))
            if prev is None:
                prev = torch.zeros((1, p1.shape[1] // 8, p1.shape[2] // 8, 2), device="cuda")
            lr, up = model(p1, p2, iters=EVAL_ITERS, flow_init=prev)
            prev = forward_interpolate_batch(lr)
            ups.append(padder.unpad(up).cpu().numpy())
            gts.append(s["flow"][None])
        m = _host_metrics("px", ups, gts)
        got = {k: results[f"warm_{dstype}" + (f"_{k}" if k != "epe" else "")] for k in m}
        err = max(err, _close(got, m, ACC_RTOL))
    report = {"card": card, "results": results, "wall_s": wall, "frames": frames,
              "stats": stats, "launches": launches, "metrics_vs_eager_chain_max_rel": err,
              "graph_pool_bytes": sum(fwd.pool_bytes.values())}
    print(f"evaluate raft_nc_dbl sintel_warm: {json.dumps(report)}", flush=True)
    check(err <= ACC_RTOL, f"evaluate warm: metrics differ from the eager chain by {err}")
    return report, launches


def _run_entry(args: list, what: str) -> str:
    proc = subprocess.run([sys.executable, "-m", *args], cwd=HERE, capture_output=True,
                          text=True, timeout=900)
    check(proc.returncode == 0, f"{what} exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                                f"{proc.stderr[-3000:]}")
    return proc.stdout


def check_entries(torch, card, tmp: str) -> dict:
    """The evaluate and demo entries in their own processes on the card.
    A flagship's weights written by ``save_reference_pth`` go through
    ``python -m raft_ncup_tpu_torch.evaluate --dataset synthetic`` (12
    iterations, batch 4, 32 pairs at 96x128: the validator's defaults),
    whose results must equal the same validator run here within
    ``ACC_RTOL``; then the demo runs on PNG frames the port's codec wrote
    and its PNGs are read back."""
    import numpy as np
    from raft_ncup_tpu_torch import evaluation
    from raft_ncup_tpu_torch.io import read_png, write_png
    from raft_ncup_tpu_torch.training.checkpoint import save_reference_pth

    # The evaluate entry builds the model for its --dataset (no BatchNorm
    # in NCUP's weights net outside Sintel), the demo for Sintel.
    model = eval_model(torch, dataset="synthetic")
    pth = save_reference_pth(model, os.path.join(tmp, "synthetic.pth"))
    want = evaluation.validate_synthetic(model)
    out = _run_entry(["raft_ncup_tpu_torch.evaluate", "--model", "raft_nc_dbl", "--dataset",
                      "synthetic", "--restore_ckpt", pth], "the evaluate entry")
    got = json.loads(out.strip().splitlines()[-1])
    err = _close(got["results"], want, ACC_RTOL)
    check(err <= ACC_RTOL and got["cache"]["compiles"] == 1 and got["device"].startswith("cuda"),
          f"the evaluate entry gave {got}, want {want}")
    del model
    frames = os.path.join(tmp, "frames")
    os.makedirs(frames)
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (SERVE_SIZE[0] // 8 + 1, SERVE_SIZE[1] // 8 + 1, 3))
    img = np.kron(img, np.ones((8, 8, 1)))[:SERVE_SIZE[0], :SERVE_SIZE[1]]
    for f in range(3):
        write_png(os.path.join(frames, f"f{f}.png"),
                  np.roll(img, (f, 2 * f), axis=(0, 1)).astype(np.uint8))
    pth_sintel = save_reference_pth(eval_model(torch), os.path.join(tmp, "sintel.pth"))
    demo_out = os.path.join(tmp, "demo")
    _run_entry(["raft_ncup_tpu_torch.demo", "--model", "raft_nc_dbl", "--path", frames,
                "--output", demo_out,
                "--restore_ckpt", pth_sintel, "--iters", "12"], "the demo entry")
    written = sorted(os.listdir(demo_out))
    check(written == ["f0_flow.png", "f1_flow.png"], f"the demo wrote {written}")
    for name in written:
        vis = read_png(os.path.join(demo_out, name))
        check(vis.shape == (2 * SERVE_SIZE[0], *SERVE_SIZE[1:], 3), f"demo PNG {vis.shape}")
    report = {"card": card, "evaluate_results": got["results"], "in_process": want,
              "max_rel": err, "evaluate_cache": got["cache"],
              "evaluate_graph_pool_bytes": got.get("graph_pool_bytes"), "demo_pngs": written}
    print(f"entries: {json.dumps(report)}", flush=True)
    return report


# --------------------------------------------------- training from files

THINGS_SIZE = (540, 960)  # FlyingThings3D's native frame size
THINGS_SEQUENCES = 2
THINGS_FRAMES = 8
# A resumed run on the card: the batch stream and the restored state are
# held bit for bit; the losses after the resume within RESUME_LOSS_RTOL of
# the uninterrupted run's (kernel A' sums with atomics and cuDNN's autotuner
# may pick nondeterministic algorithms, so the states drift apart slowly).
RESUME_LOSS_RTOL = 2e-2


def write_things_tree(root: str, seed: int = 0) -> None:
    """A FlyingThings3D-layout training tree at the native 540x960: clean
    and final passes of ``THINGS_SEQUENCES`` sequences of ``THINGS_FRAMES``
    PNG frames (left camera) and PFM flows into the future and into the
    past, written with the port's codecs. Each sequence's frames are warped
    by one flow: a translation of up to 40 px plus a smooth part of up to
    8 px, so that the loss can fall."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from raft_ncup_tpu_torch.io import write_pfm, write_png

    g = np.random.default_rng(seed)
    h, w = THINGS_SIZE

    def smooth(channels, cell, scale):
        coarse = torch.from_numpy(g.normal(0, scale, (1, channels, h // cell + 2, w // cell + 2)))
        return F.interpolate(coarse, size=(h, w), mode="bicubic", align_corners=False)[0]

    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float64),
                            torch.arange(w, dtype=torch.float64), indexing="ij")
    for s in range(THINGS_SEQUENCES):
        seq = os.path.join("TRAIN", "A", f"{s:04d}")
        flow = smooth(2, 64, 4.0).clamp(-8, 8)
        flow[0] += float(g.uniform(-40, 40))
        flow[1] += float(g.uniform(-15, 15))
        grid = torch.stack([(xx - flow[0]) * 2 / (w - 1) - 1, (yy - flow[1]) * 2 / (h - 1) - 1],
                           dim=-1)[None]
        frame = (smooth(3, 8, 60.0) + 128.0)[None]
        frames = []
        for _ in range(THINGS_FRAMES):
            frames.append(frame[0].permute(1, 2, 0).clamp(0, 255).round().to(torch.uint8).numpy())
            # Backward warp: frame k+1 at x is frame k at x - flow(x).
            frame = F.grid_sample(frame, grid, mode="bilinear", padding_mode="reflection",
                                  align_corners=True)
        for dstype in ("frames_cleanpass", "frames_finalpass"):
            d = os.path.join(root, dstype, seq, "left")
            os.makedirs(d, exist_ok=True)
            for i, f in enumerate(frames):
                if dstype == "frames_finalpass":
                    f = np.clip(f + g.normal(0, 4, f.shape), 0, 255).astype(np.uint8)
                write_png(os.path.join(d, f"{6 + i:04d}.png"), f)
        f3 = np.zeros((h, w, 3), np.float32)
        for direction, sign in (("into_future", 1.0), ("into_past", -1.0)):
            d = os.path.join(root, "optical_flow", seq, direction, "left")
            os.makedirs(d, exist_ok=True)
            f3[..., :2] = sign * flow.permute(1, 2, 0).numpy()
            for i in range(THINGS_FRAMES):
                write_pfm(os.path.join(d, f"OpticalFlowInto_{6 + i:04d}_L.pfm"), f3)


def script_flags(script: str) -> list:
    """The flags of a shipped training script's ``python train.py`` line,
    its own ``$EXP`` name kept, ``"$@"`` left out."""
    import shlex

    text = open(os.path.join(HERE, "scripts", script)).read().replace("\\\n", " ")
    for line in text.splitlines():
        toks = shlex.split(line.strip()) if line.strip().startswith("python") else []
        if "train.py" in toks:
            toks = toks[toks.index("train.py") + 1:]
            return [t.replace("$EXP", "exp") for t in toks if t != "$@"]
    raise CheckFailed(f"no python train.py line in scripts/{script}")


def _same_bytes(a, b) -> bool:
    """Bit for bit: the same dtype, shape and bytes (tensors on the host)."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.contiguous().numpy().tobytes() == b.contiguous().numpy().tobytes())


def _digest(arrays: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(arrays[k].tobytes())
    return h.hexdigest()[:16]


class _Instruments:
    """What a train-from-files run records, hooked into the train entry:
    each consumed batch's digest on the host (as the loader made it) and
    on the card (after the prefetcher's stream wait), each step's wall,
    loss, peak memory, kernel launches and lookup tile paths, and the train
    state the entry builds."""

    def __init__(self, torch):
        self.torch = torch
        self.host, self.card, self.steps, self.states = [], [], [], []
        self.restored = None
        self._t_iter = None

    def install(self, stack):
        import collections

        from raft_ncup_tpu_torch import train as train_mod
        from raft_ncup_tpu_torch.data.device_prefetch import DevicePrefetcher
        from raft_ncup_tpu_torch.ops import corr_cuda

        torch, inst = self.torch, self

        class CheckedPrefetcher(DevicePrefetcher):
            """Each batch's host digest, taken on the worker in order, is
            held against its copy on the card when the consumer gets it."""

            def __init__(self, *a, **kw):
                self._digests = collections.deque()
                super().__init__(*a, **kw)

            def _transfer(self, batch):
                self._digests.append(_digest({k: v for k, v in batch.items()
                                              if k != "extra_info"}))
                return super()._transfer(batch)

            def __next__(self):
                inst._t_iter = time.perf_counter()
                batch = super().__next__()
                inst.host.append(self._digests.popleft())
                inst.card.append(_digest({k: v.cpu().numpy() for k, v in batch.items()}))
                return batch

        make_step, create, restore = (train_mod.make_train_step, train_mod.create_train_state,
                                      train_mod._restore)

        def timed_step_factory(cfg, *a, **kw):
            step = make_step(cfg, *a, **kw)

            def timed(state, batch):
                before = read_launches()
                corr_cuda.reset_path_tiles()
                corr_cuda.reset_backward_counts()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                metrics = step(state, batch)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                after = read_launches()
                inst.steps.append(dict(
                    step=state.step, ms=1e3 * (t1 - t0),
                    # From the call for its batch to the end of the step.
                    iteration_ms=1e3 * (t1 - inst._t_iter),
                    loss=float(metrics["loss"]), bad=float(metrics["bad_step"]),
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                    launches={k: after[k] - before[k] for k in after},
                    path_tiles=corr_cuda.path_tiles(),
                    bwd_counts=corr_cuda.backward_counts()))
                return metrics

            return timed

        def keep_state(*a, **kw):
            inst.states.append(create(*a, **kw))
            return inst.states[-1]

        def checked_restore(state, path, *a, **kw):
            restore(state, path, *a, **kw)
            from raft_ncup_tpu_torch.training import checkpoint as ckpt_mod

            saved = torch.load(ckpt_mod.latest(path), map_location="cpu", weights_only=True)
            live = state.model.state_dict()
            inst.restored = saved["step"] == state.step and all(
                _same_bytes(live[k].cpu(), v) for k, v in saved["model"].items()) and all(
                _same_bytes(a.cpu(), b) for a, b in zip(
                    state.optimizer.mu + state.optimizer.nu,
                    saved["optimizer"]["mu"] + saved["optimizer"]["nu"]))

        for name, fn in (("DevicePrefetcher", CheckedPrefetcher),
                         ("make_train_step", timed_step_factory),
                         ("create_train_state", keep_state), ("_restore", checked_restore)):
            stack.callback(setattr, train_mod, name, getattr(train_mod, name))
            setattr(train_mod, name, fn)


def _train_files_run(torch, label, argv, want_status):
    """One in-process run of the train entry with ``argv``, every kernel
    count set to 0 just before it and read just after, plain versions
    counted; returns its summary, launches and instruments."""
    import io

    from raft_ncup_tpu_torch import train as train_mod

    inst = _Instruments(torch)
    out = io.StringIO()
    reset_launches()
    with contextlib.ExitStack() as stack:
        inst.install(stack)
        with counting_plain_versions() as plain, contextlib.redirect_stdout(out):
            status = train_mod.main(argv)
    launches = read_launches()
    lines = out.getvalue().strip().splitlines()
    summary = json.loads(lines[-1])
    check(status == want_status == summary["status"],
          f"train from files {label}: exit {status}, want {want_status}")
    check(not plain, f"plain versions ran in train from files {label}: {plain}")
    check(all(v > 0 for k, v in launches.items()),
          f"train from files {label}: a kernel of the path did not launch: {launches}")
    return summary, launches, inst, [ln for ln in lines if ln.startswith("[val @")]


def flight_triggers(directory: str) -> list:
    """The triggers of the flight dumps in ``directory``, each loaded."""
    from raft_ncup_tpu_torch.observability import load_dump

    if not os.path.isdir(directory):
        return []
    return sorted(load_dump(os.path.join(directory, n))["trigger"]
                  for n in os.listdir(directory))


def check_train_files(torch, card, tmp: str, synthetic_ms: float) -> dict:
    """Train the flagship from files in-process through ``train.main`` with
    ``scripts/train_raft_nc_things.sh``'s flag lines minus ``--compressed_ft``:
    a FlyingThings3D-layout tree at 540x960 read and augmented on the host
    by the loader's threads and copied ahead by the device prefetcher,
    validated on a Sintel-layout tree, warm-started from a ``raft`` .pth.
    (a) f32, 8 steps, validating every 4; (b) ``sigterm@3``: exit 75, then
    a resume to step 8, its batch stream equal to (a)'s, its restored state
    equal to ``step_3.pt`` bit for bit, its losses within
    ``RESUME_LOSS_RTOL`` of (a)'s; (c) ``nan@5,nan@6,nan@7`` with
    ``--sentinel_halt_after 3 --sum_freq 1``: exit 76 and the live
    parameters equal to ``step_4.pt``; (b)'s first run and (c) each bank
    one flight dump under ``<run_dir>/flight`` (``preemption_drain``,
    ``sentinel_halt``); (d) ``bf16_train``, 5 steps; (e)
    ``--freeze_raft --add_noise --dropout 0.1``, 2 steps: the trunk
    unchanged bit for bit, A' launched. Every step launches A 24, A' 12,
    B 96 and B' 48 times; every prefetched batch equals its host batch."""
    from raft_ncup_tpu_torch.cli import parse_train
    from raft_ncup_tpu_torch.data.synthetic import SyntheticFlowDataset
    from raft_ncup_tpu_torch.models.raft import RAFT
    from raft_ncup_tpu_torch.ops import corr_cuda
    from raft_ncup_tpu_torch.training.checkpoint import save_reference_pth
    from raft_ncup_tpu_torch.training.step import make_train_step

    t_write = time.perf_counter()
    things, sintel = os.path.join(tmp, "FlyingThings3D"), os.path.join(tmp, "Sintel")
    write_things_tree(things)
    if not os.path.isdir(sintel):
        write_sintel_sequences(sintel)
    source = RAFT(model_config("raft", False), device="cuda", seed=3)
    pth = save_reference_pth(source, os.path.join(tmp, "raft-things.pth"))
    trunk = {k: v.detach().cpu() for k, v in source.state_dict().items()}
    del source
    t_write = time.perf_counter() - t_write
    base = [t for t in script_flags("train_raft_nc_things.sh") if t != "--compressed_ft"]
    i = base.index("--load_pretrained")
    base[i + 1] = pth
    base += ["--root_things", things, "--root_sintel", sintel]
    want = {"corr_lookup": 24, "corr_lookup_bwd": 12, "nconv": 96, "nconv_bwd": 48}

    def run(label, ckdir, steps, *extra, status=0):
        argv = base + ["--checkpoint_dir", os.path.join(tmp, ckdir), "--num_steps", str(steps),
                       *extra]
        t0 = time.perf_counter()
        summary, launches, inst, vals = _train_files_run(torch, label, argv, status)
        seconds = time.perf_counter() - t0
        for s in inst.steps:
            check(s["launches"] == want, f"{label}: step {s['step']} launched "
                                         f"{s['launches']}, want {want}")
        check(inst.host == inst.card, f"{label}: a prefetched batch differs from its host batch")
        ms = [s["ms"] for s in inst.steps]
        its = [s["iteration_ms"] for s in inst.steps]
        row = {
            "card": card, "exit": summary["status"], "steps": len(inst.steps),
            "seconds": seconds, "losses": [s["loss"] for s in inst.steps],
            "step_ms": ms, "median_step_ms": statistics.median(ms[1:]) if len(ms) > 1 else ms[0],
            "median_iteration_ms": statistics.median(its[1:]) if len(its) > 1 else None,
            "synthetic_median_step_ms_same_call": synthetic_ms,
            "loader_host_ms_per_sample": summary["loader"]["host_ms_per_sample"],
            "loader_samples": summary["loader"]["samples"],
            "prefetch_waits": summary["prefetch"]["waits"],
            "prefetch_wait_ms": summary["prefetch"]["wait_ms"],
            "launches_per_step": inst.steps[-1]["launches"], "launches_total": launches,
            "path_tiles_per_step": [s["path_tiles"] for s in inst.steps],
            "bwd_counts_last_step": inst.steps[-1]["bwd_counts"],
            "peak_gib_per_step": [s["peak_gib"] for s in inst.steps],
            "validations": vals, "skipped": summary["skipped"],
        }
        return row, inst, launches

    report, paths = {}, {}
    # (a) f32, 8 steps, validating at 4 and 8.
    a, inst_a, paths["a"] = run("(a) f32", "a", 8, "--val_freq", "4")
    check(all(math.isfinite(x) for x in a["losses"]) and a["skipped"] == 0,
          f"(a): losses {a['losses']}, skipped {a['skipped']}")
    check(len(a["validations"]) == 2, f"(a): validations {a['validations']}")
    state = inst_a.states[-1]
    peaks = a["peak_gib_per_step"]
    a["peak_gib_before_first_validation"] = max(peaks[1:4])
    a["peak_gib_after_first_validation"] = max(peaks[4:])
    # One synthetic batch through the same state, for the tile paths of a
    # synthetic step beside a loader-fed one.
    cfg = parse_train(base + ["--num_steps", "8"])[2]
    syn = SyntheticFlowDataset(cfg.image_size, seed=cfg.seed).batch(0, cfg.batch_size, "cuda")
    corr_cuda.reset_path_tiles()
    make_train_step(cfg)(state, syn)
    a["synthetic_step_path_tiles"] = corr_cuda.path_tiles()
    del state, syn
    inst_a.states.clear()
    torch.cuda.empty_cache()
    report["a"] = a
    # (b) sigterm@3: exit 75, then a resume to step 8.
    b1, inst_b1, _ = run("(b) sigterm@3", "b", 8, "--val_freq", "4", "--chaos", "sigterm@3",
                         status=75)
    b2, inst_b2, paths["b"] = run("(b) resumed", "b", 8, "--val_freq", "4", "--restore_ckpt",
                                  os.path.join(tmp, "b", "exp"))
    check(inst_b2.restored is True, "(b): the restored state differs from step_3.pt")
    b1["flight_dumps"] = flight_triggers(os.path.join(tmp, "b", "exp", "flight"))
    check(b1["flight_dumps"] == ["preemption_drain"], f"(b): flight dumps {b1['flight_dumps']}")
    stream = inst_b1.host + inst_b2.host
    check(stream == inst_a.host, "(b): the resumed batch stream differs from (a)'s")
    resumed = b1["losses"] + b2["losses"]
    rel = max(abs(x - y) / abs(y) for x, y in zip(resumed, a["losses"]))
    check(rel <= RESUME_LOSS_RTOL, f"(b): losses {resumed} against (a)'s {a['losses']}")
    report["b"] = {"interrupted": b1, "resumed": b2, "loss_max_rel_diff_vs_a": rel,
                   "batch_hashes_equal": True, "restored_bitwise": True}
    torch.cuda.empty_cache()
    # (c) three NaN batches in a row: exit 76, rolled back to step_4.pt.
    c, inst_c, paths["c"] = run("(c) nan@5,6,7", "c", 8, "--chaos", "nan@5,nan@6,nan@7",
                                "--sentinel_halt_after", "3", "--sum_freq", "1",
                                "--val_freq", "4", status=76)
    saved = torch.load(os.path.join(tmp, "c", "exp", "step_4.pt"), weights_only=True)
    live = inst_c.states[-1].model.state_dict()
    check(all(_same_bytes(live[k].cpu(), v) for k, v in saved["model"].items()),
          "(c): the rolled-back parameters differ from step_4.pt")
    check(all(math.isfinite(x) for x in c["losses"][:5]), f"(c): losses {c['losses']}")
    c["rolled_back_bitwise_to"] = "step_4.pt"
    c["flight_dumps"] = flight_triggers(os.path.join(tmp, "c", "exp", "flight"))
    check(c["flight_dumps"] == ["sentinel_halt"], f"(c): flight dumps {c['flight_dumps']}")
    inst_c.states.clear()
    report["c"] = c
    torch.cuda.empty_cache()
    # (d) bf16_train, 5 steps.
    d, _, paths["d"] = run("(d) bf16_train", "d", 5, "--precision", "bf16_train")
    check(all(math.isfinite(x) for x in d["losses"]), f"(d): losses {d['losses']}")
    report["d"] = d
    torch.cuda.empty_cache()
    # (e) freeze_raft with noise and dropout, 2 steps.
    e, inst_e, paths["e"] = run("(e) freeze_raft", "e", 2, "--freeze_raft", "--add_noise",
                                "--dropout", "0.1")
    live = inst_e.states[-1].model.state_dict()
    check(all(_same_bytes(live[k].cpu(), v) for k, v in trunk.items()
              if k in live and not k.endswith("num_batches_tracked")),
          "(e): a trunk tensor moved under --freeze_raft")
    check(all(math.isfinite(x) for x in e["losses"]), f"(e): losses {e['losses']}")
    e["trunk_unchanged_bitwise"] = True
    inst_e.states.clear()
    report["e"] = e
    torch.cuda.empty_cache()
    for key in ("a", "c", "d", "e"):
        print(f"train from files ({key}): {json.dumps(report[key])}", flush=True)
    for part in ("interrupted", "resumed"):
        print(f"train from files (b) {part}: {json.dumps(report['b'].pop(part))}", flush=True)
    print(f"train from files (b): {json.dumps(report['b'])}", flush=True)
    print(f"train from files: tree written in {t_write:.2f} s", flush=True)
    return {f"train from files ({k})": v for k, v in paths.items()}


# ------------------------------------------- stages, early exit, streaming

# The serve entry's flagship drives of this section: the plain branch with
# 8 requests at the Sintel size (batch sizes 1 and 2, level 12), and the
# stream branch with 4 streams of 8 frames (batch sizes 1, 2, 4; 12
# iterations; 8 slots). Weights and traffic from seed 0.
def serve_ee_args(level: int) -> list:
    return ["--model", "raft_nc_dbl", "--size", str(SERVE_SIZE[0]), str(SERVE_SIZE[1]),
            "--num_requests", str(SERVE_REQUESTS), "--iter_levels", str(level),
            "--serve_batch_sizes", "1,2", "--queue_capacity", "16"]


SERVE_EE_ARGS = serve_ee_args(12)
STREAM_CAPACITY = 8
STREAM_ARGS = ["--stream", "--model", "raft_nc_dbl", "--size", str(SERVE_SIZE[0]),
               str(SERVE_SIZE[1]), "--n_streams", "4", "--frames_per_stream", "8",
               "--stream_iters", "12", "--stream_batch_sizes", "1,2,4", "--stream_capacity",
               str(STREAM_CAPACITY)]
STREAM_CHAOS = "corruptframe@4,abandon@7"
STREAM_SIGTERM = "sigterm@5"
STAGE_SPLITS = (1, 2, 4)
EE_EPE_LEVEL = 2  # JAX's early-exit EPE test: a converged row skips one step


def flagship(torch):
    """The flagship on the card with both kernels, seeded weights."""
    from raft_ncup_tpu_torch.models.raft import RAFT

    return RAFT(model_config("raft_nc_dbl", False, corr_impl="pallas", nconv_impl="pallas"),
                device="cuda", seed=0)


def plain_flagship(torch, model, precision="f32"):
    """The same weights through the plain versions, at ``precision``."""
    from raft_ncup_tpu_torch.models.raft import RAFT

    plain = RAFT(model_config("raft_nc_dbl", False, corr_impl="onthefly", nconv_impl="xla",
                              precision=precision), device="cuda", seed=0)
    plain.load_state_dict(model.state_dict(), strict=True)
    return plain


def padded_batch(torch, pairs):
    """(B, 440, 1024, 3) contiguous batches of Sintel-size pairs, edge-padded
    as the server pads them."""
    import numpy as np
    from raft_ncup_tpu_torch.ops.padding import InputPadder

    (t, b), (le, r) = InputPadder((*SERVE_SIZE, 3), mode="sintel").pad_spec
    pad = ((0, 0), (t, b), (le, r), (0, 0))
    return tuple(torch.from_numpy(np.pad(np.stack(x).astype(np.float32), pad, mode="edge"))
                 .cuda().contiguous() for x in zip(*pairs))


def bit_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_stages(torch, card) -> dict:
    """``encode -> refine_segment x S -> finalize`` of the flagship at batch
    2, 440x1024, 12 iterations, against its forward on the same inputs,
    for S in ``STAGE_SPLITS``: bit for bit expected, ``REPLAY_TOL``
    allowed; each composition launches A 12 and B 4 times."""
    from raft_ncup_tpu_torch.serve import make_pairs
    from raft_ncup_tpu_torch.utils.device import cudnn_autotune

    model = flagship(torch)
    i1, i2 = padded_batch(torch, make_pairs(SERVE_SIZE, 2, seed=3))
    with cudnn_autotune():  # cuDNN keeps these algorithms for every run below
        want = model(i1, i2, iters=12)
    rows = []
    for segments in STAGE_SPLITS:
        reset_launches()
        carry = model.encode(i1, i2)
        for _ in range(segments):
            carry = model.refine_segment(carry, 12 // segments)
        got = model.finalize(carry)
        torch.cuda.synchronize()
        launches = read_launches()
        err = max(bit_err(torch, g, w) for g, w in zip(got, want))
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        rows.append({"segments": segments, "max_abs_err": err, "bitwise": same,
                     "launches": launches})
        check(err <= REPLAY_TOL, f"stages S={segments}: {err} from the forward")
        check(launches == {"corr_lookup": 12, "corr_lookup_bwd": 0, "nconv": 4,
                           "nconv_bwd": 0}, f"stages S={segments}: launches {launches}")
    print(f"stages: {json.dumps({'card': card, 'rows': rows})}", flush=True)
    del model
    torch.cuda.empty_cache()
    return rows[-1]["launches"]


@contextlib.contextmanager
def earlyexit_env(tol):
    """The serve entry's early-exit knobs: on at ``tol``, or off (None)."""
    saved = {k: os.environ.pop(k, None) for k in ("RAFT_TORCH_EARLYEXIT",
                                                 "RAFT_TORCH_EARLYEXIT_TOL")}
    if tol is not None:
        os.environ["RAFT_TORCH_EARLYEXIT"] = "1"
        os.environ["RAFT_TORCH_EARLYEXIT_TOL"] = repr(float(tol))
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


@contextlib.contextmanager
def recorded_forwards(torch):
    """Record every ``ShapeCachedForward.forward`` call while inside: its
    inputs, outputs, early-exit segments and flag reads, and the kernel
    launches it added."""
    from raft_ncup_tpu_torch.inference import pipeline

    orig = pipeline.ShapeCachedForward.forward
    records: list = []

    def forward(self, image1, image2, iters, flow_init=None, policy=None, early_exit_tol=None):
        before = read_launches()
        out = orig(self, image1, image2, iters, flow_init, policy, early_exit_tol)
        after = read_launches()
        records.append({"i1": image1, "i2": image2, "iters": iters, "out": out,
                        "ee": dict(self.last_earlyexit) if early_exit_tol is not None else None,
                        "launches": {k: after[k] - before[k] for k in after}})
        return out

    pipeline.ShapeCachedForward.forward = forward
    try:
        yield records
    finally:
        pipeline.ShapeCachedForward.forward = orig


def first_iteration_tol(torch, model, pairs) -> tuple[float, list]:
    """JAX's splitting tolerance: midway between the pairs' smallest and
    largest mean |flow_lr| after one iteration (the first delta)."""
    norms = []
    for k in range(0, len(pairs), 2):
        i1, i2 = padded_batch(torch, pairs[k:k + 2])
        lr, _ = model(i1, i2, iters=1)
        norms += lr.abs().mean(dim=(1, 2, 3)).tolist()
    return (min(norms) + max(norms)) / 2.0, norms


def trace_call(torch, fn) -> dict:
    """Wall and device ms of one traced call (ending in a synchronise), the
    device's idle share and its time by kernel group; ``device_ms`` null
    when the trace holds no device time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    groups: dict[str, float] = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0) or 0.0
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA and us > 0:
            groups[_kernel_group(e.key)] = groups.get(_kernel_group(e.key), 0.0) + us / 1e3
    device_ms = sum(groups.values()) or None
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": None if device_ms is None else 1.0 - device_ms / wall_ms,
            "by_group": groups}


def trace_step(torch, model, rec, precision) -> dict:
    """Where a stream step's time goes: one traced step of batch 4 (the
    recorded batch's frames, cold) in an engine of its own, after its
    capture and a replay; and the warm-start splat alone, by CUDA events."""
    from raft_ncup_tpu_torch.config import StreamConfig
    from raft_ncup_tpu_torch.ops.warmstart import forward_interpolate_batch
    from raft_ncup_tpu_torch.streaming import StreamEngine

    n = len(rec["slots"])
    engine = StreamEngine(model, StreamConfig(capacity=8, frame_hw=SERVE_SIZE, iters=12,
                                              batch_sizes=(n,), precision=precision))
    try:
        engine.warmup()
        args = (rec["img1"], rec["img2"], list(range(n)), [1.0] * n)
        engine._run_step(*args)
        out = trace_call(torch, lambda: engine._run_step(*args))
    finally:
        engine.drain()
    flush = torch.empty(64 * 2**20 // 4, device="cuda")
    prev = rec["prev"]["flow"].float()
    out["splat_ms"] = cuda_ms(torch, lambda: forward_interpolate_batch(prev, 1024), 10, flush)
    out["batch"] = n
    return out


def check_early_exit(torch, card) -> dict:
    """The flagship through the serve entry's plain branch, f32, 8 requests
    at 436x1024 (batch sizes 1 and 2, level 12), with early exit off and
    then on at JAX's splitting tolerance from the served pairs' first
    iteration. Per early-exit batch: its rows' executed iterations, the
    segments replayed, A launches (4 a segment), B 4, the flag reads on
    the host; each row against the eager run truncated at its executed
    iterations (bit for bit expected, ``REPLAY_TOL`` allowed). The EPE
    budget is held as JAX's test holds it, at a level of 2: on one batch
    of a cache of its own, and on the serve entry's answers at that level
    with detection on against off. The level-12 EPE against the
    detection-off run is reported."""
    import numpy as np
    from raft_ncup_tpu_torch import serve as serve_mod
    from raft_ncup_tpu_torch.inference.pipeline import EARLYEXIT_SEGMENT, ShapeCachedForward
    from raft_ncup_tpu_torch.precision import EARLYEXIT_EPE_BUDGET
    from raft_ncup_tpu_torch.serving import SyntheticTraffic

    pairs = [(a, b) for _, a, b in SyntheticTraffic(SERVE_SIZE, SERVE_REQUESTS, seed=0)]
    probe = flagship(torch)
    tol, norms = first_iteration_tol(torch, probe, pairs)
    del probe
    runs, paths = {}, {}
    for label, ee in (("off", None), ("on", tol)):
        with earlyexit_env(ee), recorded_forwards(torch) as records:
            reset_launches()
            rc, report, responses, model = serve_mod.run(SERVE_EE_ARGS)
            torch.cuda.synchronize()
            paths[label] = read_launches()
        check(rc == 0 and all(r.ok for r in responses), f"early exit {label}: rc {rc}")
        runs[label] = (report, responses, records[2:], model)  # 2 warm-up forwards
    report, responses, batches, model = runs["on"]
    rows, worst = [], 0.0
    for rec in batches:
        lr, up, ex = rec["out"]
        seg, n = rec["ee"]["segments"], rec["ee"]["syncs"]
        check(rec["launches"]["corr_lookup"] == EARLYEXIT_SEGMENT * seg
              and rec["launches"]["nconv"] == 4,
              f"early-exit batch: launches {rec['launches']} for {seg} segments")
        i1, i2 = (t.cuda().contiguous() for t in (rec["i1"], rec["i2"]))
        for k in sorted(set(ex.tolist())):
            want_lr, want_up = model(i1, i2, iters=k)
            for r in (ex == k).nonzero().flatten().tolist():
                worst = max(worst, bit_err(torch, up[r], want_up[r]),
                            bit_err(torch, lr[r], want_lr[r]))
        rows.append({"rows": len(ex), "exec_iters": ex.tolist(), "segments": seg,
                     "flag_reads": n, "result_copies": 1, "launches": rec["launches"]})
    check(worst <= REPLAY_TOL, f"early exit: a row is {worst} from its truncated run")
    off_flows = [r.flow for r in runs["off"][1]]
    epe12 = float(np.mean([np.linalg.norm(r.flow - f, axis=-1).mean()
                           for r, f in zip(responses, off_flows)]))
    fwd = ShapeCachedForward(model)
    i1, i2 = padded_batch(torch, pairs[:2])
    _, up_ee, ex2 = fwd.forward(i1, i2, EE_EPE_LEVEL, early_exit_tol=tol)
    _, up_full = fwd.forward(i1, i2, EE_EPE_LEVEL)
    epe2 = float((up_ee - up_full).norm(dim=-1).mean())
    check(epe2 <= EARLYEXIT_EPE_BUDGET, f"early exit at level {EE_EPE_LEVEL}: mean EPE "
                                        f"{epe2} against the budget {EARLYEXIT_EPE_BUDGET}")
    served2 = {}
    for label, ee in (("off", None), ("on", tol)):
        with earlyexit_env(ee):
            rc, rep2, resp2, _ = serve_mod.run(serve_ee_args(EE_EPE_LEVEL))
        check(rc == 0 and all(r.ok for r in resp2),
              f"early exit {label} at level {EE_EPE_LEVEL}: rc {rc}")
        served2[label] = (rep2, resp2)
    epe2_served = float(np.mean([np.linalg.norm(a.flow - b.flow, axis=-1).mean()
                                 for a, b in zip(served2["on"][1], served2["off"][1])]))
    check(epe2_served <= EARLYEXIT_EPE_BUDGET,
          f"served early exit at level {EE_EPE_LEVEL}: mean EPE {epe2_served} against the "
          f"detection-off run, budget {EARLYEXIT_EPE_BUDGET}")
    fwd.forward(i1, i2, 12, early_exit_tol=tol)  # captured before the trace
    trace = trace_call(torch, lambda: fwd.forward(i1, i2, 12, early_exit_tol=tol))
    trace.update(fwd.last_earlyexit)
    out = {
        "card": card, "tol": tol, "first_iteration_norms": norms,
        "pairs_per_sec": {k: runs[k][0]["serve_pairs_per_sec"] for k in runs},
        "p50_ms": {k: runs[k][0]["serve_p50_ms"] for k in runs},
        "p99_ms": {k: runs[k][0]["serve_p99_ms"] for k in runs},
        "batches": rows, "earlyexit": report["earlyexit"],
        "budget_expected_iters": report["budget_expected_iters"],
        "truncated_max_abs_err": worst, "epe_level12_vs_off": epe12,
        f"epe_level{EE_EPE_LEVEL}": epe2, f"exec_level{EE_EPE_LEVEL}": ex2.tolist(),
        f"served_epe_level{EE_EPE_LEVEL}": epe2_served,
        f"served_earlyexit_level{EE_EPE_LEVEL}": served2["on"][0]["earlyexit"],
        "traced_forward": trace, "launches": paths,
        "note": "untrained weights: the convergence pattern is an artefact of them",
    }
    print(f"early exit served: {json.dumps(out)}", flush=True)
    del runs, model, fwd
    torch.cuda.empty_cache()
    return paths["on"]


@contextlib.contextmanager
def recorded_steps(torch):
    """Record every stream step while inside: its inputs, the slot table's
    rows it read (cloned on the card before the step) and its outputs."""
    from raft_ncup_tpu_torch.streaming import engine as engine_mod

    orig = engine_mod.StreamEngine._run_step
    records: list = []

    def run_step(self, img1, img2, slot_idx, cold, *span):
        idx = torch.as_tensor(slot_idx, dtype=torch.int64, device=self.device)
        prev = {k: t.index_select(0, idx).clone() for k, t in self._table.items()}
        flow_up, bad = orig(self, img1, img2, slot_idx, cold, *span)
        records.append({"img1": img1, "img2": img2, "slots": list(slot_idx),
                        "cold": list(cold), "prev": prev, "flow_up": flow_up, "bad": bad,
                        "scratch": self.cfg.capacity, "chunk": self.cfg.splat_chunk})
        return flow_up, bad

    engine_mod.StreamEngine._run_step = run_step
    try:
        yield records
    finally:
        engine_mod.StreamEngine._run_step = orig


def check_stream_steps(torch, model, steps, precision, carry_net) -> dict:
    """Each answered frame of the recorded steps against the plain-version
    forward of its batch, fed the flow_init (and under ``carry_net`` the
    GRU state) the engine built from its own previous state: f32 within
    the served tolerance; under ``bf16_infer``, as a served bf16 pair is
    held, within ``FORWARD_EPE_BUDGET`` of the f32 plain-version forward
    fed the same state, and within ``BF16_PLAIN_SHARE`` of that distance
    of the bf16 plain-version forward."""
    from raft_ncup_tpu_torch.ops.warmstart import forward_interpolate_batch
    from raft_ncup_tpu_torch.precision import FORWARD_EPE_BUDGET

    plain = plain_flagship(torch, model, precision)
    plain_f32 = None if precision == "f32" else plain_flagship(torch, model)
    worst, epes, shares, frames = 0.0, [], [], 0
    for rec in steps:
        real = [k for k, s in enumerate(rec["slots"]) if s != rec["scratch"]]
        if not real:
            continue  # a warm-up step
        cold = torch.tensor(rec["cold"], device=rec["prev"]["warm"].device)
        warm = rec["prev"]["warm"] * (1.0 - cold) > 0.5
        splat = forward_interpolate_batch(rec["prev"]["flow"].float(), rec["chunk"])
        finit = torch.where(warm[:, None, None, None], splat, torch.zeros_like(splat))
        kw = {"net_init": rec["prev"]["net"], "net_warm": warm} if carry_net else {}
        i1, i2 = (torch.as_tensor(x).cuda() for x in (rec["img1"], rec["img2"]))
        _, up = plain(i1, i2, iters=12, flow_init=finit, **kw)
        if plain_f32 is not None:
            _, up_f32 = plain_f32(i1, i2, iters=12, flow_init=finit, **kw)
        served = rec["flow_up"]
        for k in real:
            if rec["bad"][k]:
                continue
            frames += 1
            if precision == "f32":
                e, ok = max_err(torch, served[k], up[k], **FLOW_UP_TOL)
                worst = max(worst, e)
                check(ok, f"stream frame against the plain versions: {e}")
            else:
                e_f32 = float((served[k] - up_f32[k]).norm(dim=-1).mean())
                e_plain = float((served[k] - up[k]).norm(dim=-1).mean())
                epes.append(e_f32)
                shares.append(e_plain / e_f32)
                check(e_f32 <= FORWARD_EPE_BUDGET,
                      f"stream frame: mean EPE {e_f32} against the f32 plain-version "
                      f"forward, budget {FORWARD_EPE_BUDGET}")
                check(e_plain <= BF16_PLAIN_SHARE * e_f32,
                      f"stream frame: mean EPE {e_plain} against the {precision} "
                      f"plain-version forward, tolerance {BF16_PLAIN_SHARE} x {e_f32}")
    del plain, plain_f32
    return {"frames_checked": frames, "flow_up_max_abs_err": worst,
            "max_epe_vs_f32": max(epes) if epes else None,
            "max_share_of_f32_epe_vs_plain": max(shares) if shares else None}


def run_stream_entry(torch, argv) -> tuple:
    """One run of the serve entry's stream branch, every kernel count set
    to 0 just before it; returns ``(rc, report, responses, model, steps,
    launches)``."""
    from raft_ncup_tpu_torch import serve as serve_mod

    with recorded_steps(torch) as steps:
        reset_launches()
        rc, report, responses, model = serve_mod.run(argv)
        torch.cuda.synchronize()
        launches = read_launches()
    return rc, report, responses, model, steps, launches


def check_stream(torch, card, precision="f32", carry_net=False) -> dict:
    """The serve entry's ``--stream`` drive (``STREAM_ARGS``): every frame
    answered, 3 captures (one a batch size, all at warm-up), A 12 and B 4
    launches a step, and every frame against the plain versions."""
    label = "stream" + ("" if precision == "f32" else f" {precision}") + (
        " carry_net" if carry_net else "")
    argv = STREAM_ARGS + (["--stream_precision", precision] if precision != "f32" else []) + (
        ["--carry_net"] if carry_net else [])
    rc, report, responses, model, steps, launches = run_stream_entry(torch, argv)
    check(rc == 0 and report["errors"] == 0 and len(responses) == 32
          and all(r.ok for r in responses), f"{label}: rc {rc}, {report['stats']}")
    check(report["executables"]["compiles"] == 3 and report["warmup_steps"] == 3,
          f"{label}: captures {report['executables']}, want 3, all at warm-up")
    per_step = {"corr_lookup": report["corr_kernel_launches"] / report["stream_batches"],
                "nconv": report["nconv_kernel_launches"] / report["stream_batches"]}
    check(per_step == {"corr_lookup": 12, "nconv": 4}, f"{label}: launches a step {per_step}")
    check_launches(launches, "raft_nc_dbl", False, label)
    held = check_stream_steps(torch, model, steps, precision, carry_net)
    full = [rec for rec in steps if rec["scratch"] not in rec["slots"] and len(rec["slots"]) == 4]
    step = trace_step(torch, model, full[-1], precision) if full and not carry_net else None
    out = {"card": card, "traced_step": step, "frames_per_sec": report["stream_frames_per_sec"],
           "p50_ms": report["stream_p50_ms"], "p99_ms": report["stream_p99_ms"],
           "batches": report["stream_batches"], "captures": report["executables"],
           "slot_table_bytes": report["slot_table_bytes"],
           "graph_pool_bytes": report["graph_pool_bytes"], "launches_per_step": per_step,
           "launches": launches, "precision": report["precision"], **held}
    print(f"{label}: {json.dumps(out)}", flush=True)
    del model, steps
    torch.cuda.empty_cache()
    return launches


def stream_rounds(torch, model, frames, corrupt=None, skip=None) -> dict:
    """The engine driven in rounds (pause, one frame of each stream,
    resume), as the CPU isolation test drives it, so that two runs batch
    the same frames: ``{(stream, frame): response}`` and the stats."""
    import numpy as np
    from raft_ncup_tpu_torch.config import StreamConfig
    from raft_ncup_tpu_torch.streaming import StreamEngine

    engine = StreamEngine(model, StreamConfig(capacity=8, frame_hw=SERVE_SIZE, iters=12,
                                              batch_sizes=(1, 2, 4)))
    out = {}
    try:
        engine.warmup()
        for f in sorted({f for _, f in frames}):
            engine.pause()
            handles = []
            for sid in sorted({s for s, _ in frames}):
                if (sid, f) not in frames or (skip and sid == skip[0] and f < skip[1]):
                    continue
                i1, i2 = frames[(sid, f)]
                if (sid, f) == corrupt:
                    i1 = np.full(i1.shape, np.nan, np.float32)
                handles.append(((sid, f), engine.submit(sid, i1, i2, frame_index=f)))
            engine.resume()
            out.update((k, h.result(300)) for k, h in handles)
    finally:
        stats = engine.drain()
    return out, stats, engine.report()["executables"]


def check_stream_chaos(torch, card) -> dict:
    """The serve entry's stream branch under ``STREAM_CHAOS`` (one reset, no
    error) and ``STREAM_SIGTERM`` (exit 75, everything admitted answered);
    then the isolation contract in rounds on the same schedule: the corrupt
    frame's batch-mates bit for bit those of the run without it, the reset
    stream's next frame bit for bit a cold start, and no capture after
    warm-up."""
    from raft_ncup_tpu_torch.resilience import EXIT_PREEMPTED, ChaosSpec
    from raft_ncup_tpu_torch.streaming import StreamTraffic

    rc, report, _, model, _, launches = run_stream_entry(
        torch, STREAM_ARGS + ["--chaos", STREAM_CHAOS])
    check(rc == 0 and (report["resets"], report["errors"]) == (1, 0),
          f"stream chaos: rc {rc}, {report['stats']}")
    rc_t, report_t, _, _, _, _ = run_stream_entry(
        torch, STREAM_ARGS + ["--chaos", STREAM_SIGTERM])
    check(rc_t == EXIT_PREEMPTED and report_t["interrupted"]
          and report_t["completed"] == report_t["accepted"] == 5 and report_t["errors"] == 0,
          f"stream sigterm: rc {rc_t}, {report_t['stats']}")
    sched = StreamTraffic(SERVE_SIZE, 4, 8, seed=0, chaos=ChaosSpec.parse("abandon@7"))
    frames = {(sid, f): (i1, i2) for _, sid, f, i1, i2 in sched}
    corrupt = ("stream-0", 1)  # schedule slot 4 of 4 streams
    base, _, _ = stream_rounds(torch, model, frames)
    hit, stats, captures = stream_rounds(torch, model, frames, corrupt=corrupt)
    cold, _, _ = stream_rounds(torch, model, frames, skip=(corrupt[0], corrupt[1] + 1))
    mates = [k for k in base if k[0] != corrupt[0]]
    check(stats.resets == 1 and hit[corrupt].status == "rejected",
          f"stream isolation: {stats.summary()}")
    differ = [k for k in mates if not (hit[k].ok and (hit[k].flow == base[k].flow).all())]
    check(not differ, f"stream isolation: batch-mates changed by the corrupt frame: {differ}")
    nxt = (corrupt[0], corrupt[1] + 1)
    check((hit[nxt].flow == cold[nxt].flow).all(),
          "stream isolation: the reset stream's next frame is not a cold start")
    check(captures == {"compiles": 3, "hits": stats.batches, "evictions": 0},
          f"stream isolation: captures {captures}")
    out = {"card": card, "chaos": STREAM_CHAOS, "resets": report["resets"],
           "errors": report["errors"], "frames_per_sec": report["stream_frames_per_sec"],
           "sigterm": {"rc": rc_t, "accepted": report_t["accepted"],
                       "completed": report_t["completed"]},
           "isolation": {"batch_mates_bitwise": len(mates), "reset_next_frame_cold": True,
                         "captures": captures},
           "launches": launches}
    print(f"stream chaos: {json.dumps(out)}", flush=True)
    del model
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------- telemetry

TELEMETRY_SERVE_CHAOS = "poison@3,sigterm@6"
TELEMETRY_STREAM_CHAOS = "corruptframe@4"
TELEMETRY_SLO_SCALE = 0.01  # the SLO windows shrunk to a run of seconds
OVERHEAD_RUNS = 3  # serve runs each with telemetry on and off, interleaved
OVERHEAD_BUDGET_PCT = 3.0  # the JAX package's budget (docs/OBSERVABILITY.md)
SPIN_CYCLES = 1_000_000_000  # about 0.5 s of device time


def _stats_fields(summary: str) -> dict:
    """A ``stats`` summary line as a dict of its integer fields (the stream
    engine abbreviates three of them)."""
    names = {"opened": "streams_opened", "closed": "streams_closed",
             "evicted": "streams_evicted"}
    out = {}
    for part in summary.split():
        key, _, value = part.partition("=")
        if value.lstrip("-").isdigit():
            out[names.get(key, key)] = int(value)
    return out


def check_mirrors(report: dict, subsystem: str, what: str) -> dict:
    """Every registry counter of ``subsystem`` equal to its legacy stats
    field through the alias table, and the cache's counters to its
    ``executables``; returns the pairs compared."""
    from raft_ncup_tpu_torch.observability import LEGACY_KEY_ALIASES

    counters = report["telemetry"]["metrics"]["counters"]
    legacy = _stats_fields(report["stats"])
    pairs = {}
    for field, name in LEGACY_KEY_ALIASES[subsystem].items():
        pairs[field] = (legacy[field], counters.get(name, 0))
    for field, name in LEGACY_KEY_ALIASES["inference"].items():
        pairs[f"executables.{field}"] = (report["executables"][field], counters.get(name, 0))
    bad = {k: v for k, v in pairs.items() if v[0] != v[1]}
    check(not bad, f"{what}: registry counters differ from the legacy keys: {bad}")
    return pairs


class HealthzPoller:
    """Read a healthz file every few ms on a thread while inside: every read
    that finds the file must parse (it is replaced atomically, never
    written in place); records the states read."""

    def __init__(self, path: str):
        import threading

        self.path, self.reads, self.torn, self.states = path, 0, 0, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self._stop.wait(0.005):
            try:
                with open(self.path, encoding="utf-8") as fh:
                    text = fh.read()
            except FileNotFoundError:
                continue
            self.reads += 1
            try:
                state = json.loads(text)["overall"]
            except (ValueError, KeyError):
                self.torn += 1
                continue
            if not self.states or self.states[-1] != state:
                self.states.append(state)

    def __enter__(self) -> "HealthzPoller":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=10)


@contextlib.contextmanager
def healthz_at_replay(path: str, seen: list):
    """Read the healthz file just before the serve entry replays its
    traffic (after the warm-up; the telemetry cadence has written it)."""
    from raft_ncup_tpu_torch import serve as serve_mod

    saved = serve_mod.replay, serve_mod.replay_streams

    def reading(fn):
        def wrapped(*args, **kwargs):
            with open(path, encoding="utf-8") as fh:
                seen.append(json.load(fh))
            return fn(*args, **kwargs)
        return wrapped

    serve_mod.replay, serve_mod.replay_streams = (reading(f) for f in saved)
    try:
        yield seen
    finally:
        serve_mod.replay, serve_mod.replay_streams = saved


def run_telemetry_entry(torch, argv, tmp: str, label: str) -> tuple:
    """The serve entry in process with every telemetry output on, kernel
    counts set to 0 just before and read just after, the healthz file
    polled and read back before the replay; returns ``(rc, report,
    responses, launches, files)``."""
    from raft_ncup_tpu_torch import serve as serve_mod

    files = {k: os.path.join(tmp, f"{label}_{k}") for k in ("healthz.json", "t.jsonl",
                                                            "flight")}
    argv = argv + ["--report", "--healthz_file", files["healthz.json"],
                   "--telemetry_jsonl", files["t.jsonl"], "--flight_dir", files["flight"],
                   "--telemetry_interval_s", "0.1",
                   "--slo_window_scale", str(TELEMETRY_SLO_SCALE)]
    seen: list = []
    with HealthzPoller(files["healthz.json"]) as poller, healthz_at_replay(
            files["healthz.json"], seen):
        reset_launches()
        rc, report, responses, _ = serve_mod.run(argv)
        torch.cuda.synchronize()
        launches = read_launches()
    files.update(poller=poller, at_replay=seen)
    return rc, report, responses, launches, files


def slo_breaches(report: dict, specs) -> dict:
    """For each declared SLO, the bad events the run's registry recorded
    against it, read from the report's metrics as the SLO engine reads the
    registry: a ratio's bad counter, a latency histogram's observations
    above the threshold's bucket, a gauge's peak over its bound (1 or 0)."""
    metrics = report["telemetry"]["metrics"]
    out = {}
    for spec in specs:
        if spec.sli == "ratio":
            out[spec.name] = metrics["counters"].get(spec.bad, 0)
        elif spec.sli == "latency":
            hist = metrics["histograms"].get(spec.histogram, {"count": 0, "buckets": {}})
            good = sum(c for u, c in hist["buckets"].items()
                       if u != "+Inf" and float(u) <= spec.threshold_ms)
            out[spec.name] = hist["count"] - good
        else:
            gauge = metrics["gauges"].get(spec.gauge)
            out[spec.name] = int(gauge is not None and gauge["peak"] > spec.max_value)
    return out


def check_telemetry_files(files: dict, report: dict, specs, triggers: list,
                          what: str) -> dict:
    """The healthz file (READY before the replay, DRAINING at the end, never
    torn), the flight dumps (each loadable: ``triggers`` once each, and
    beside them only ``slo_page`` dumps, one for each page the report's
    ``slo`` block counts unless the recorder's rate limit merged them, each
    naming a declared SLO that the run's own metrics breach) and the JSONL
    (tolerant to a tail cut mid-write). An SLO page depends on the run's
    latencies, so whether one fires is reported; that it is backed is held."""
    from raft_ncup_tpu_torch.observability import load_dump, read_jsonl_tolerant

    subsystem = specs[0].subsystem
    poller = files["poller"]
    (first,) = files["at_replay"]
    with open(files["healthz.json"], encoding="utf-8") as fh:
        last = json.load(fh)
    check(first["health"][subsystem]["state"] == "ready" and first["overall"] == "ready",
          f"{what}: healthz before the replay reads {first['health']}")
    check(last["health"][subsystem]["state"] == "draining" and last["draining"],
          f"{what}: healthz at the end reads {last['health']}")
    check(poller.reads > 0 and poller.torn == 0 and
          not os.path.exists(files["healthz.json"] + ".tmp"),
          f"{what}: healthz polled {poller.reads} times, {poller.torn} torn")
    loaded = [load_dump(os.path.join(files["flight"], n))
              for n in sorted(os.listdir(files["flight"]))]
    got = sorted(d["trigger"] for d in loaded)
    faults = [t for t in got if t != "slo_page"]
    check(faults == sorted(triggers), f"{what}: flight dumps {got}, want {sorted(triggers)} "
          "and slo_page dumps only beside them")
    slo = report["slo"]
    check(slo is not None and slo["specs"] == [s.name for s in specs],
          f"{what}: slo block {slo}, want the specs {[s.name for s in specs]}")
    breaches = slo_breaches(report, specs)
    paged = sorted(d["context"]["slo"] for d in loaded if d["trigger"] == "slo_page")
    check(len(paged) <= slo["pages_total"] and bool(paged) == (slo["pages_total"] > 0),
          f"{what}: {len(paged)} slo_page dumps for {slo['pages_total']} pages")
    check(all(breaches.get(name, 0) > 0 for name in paged),
          f"{what}: slo_page dumps for {paged}, bad events recorded {breaches}")
    records, skipped = read_jsonl_tolerant(files["t.jsonl"])
    with open(files["t.jsonl"], "a", encoding="utf-8") as fh:
        fh.write('{"name": "telemetry_snapshot", "repo')  # a tail cut mid-write
    again, skipped_after = read_jsonl_tolerant(files["t.jsonl"])
    check(skipped == 0 and skipped_after == 1 and again == records and records,
          f"{what}: JSONL {len(records)} records, skipped {skipped} then {skipped_after}")
    return {"healthz_states_polled": poller.states, "healthz_reads": poller.reads,
            "healthz_torn": poller.torn, "dumps": got, "slo_pages": slo["pages_total"],
            "slo_paged": paged, "slo_bad_events": breaches, "jsonl_snapshots": len(records),
            "jsonl_first_state": records[0]["report"]["health"][subsystem]["state"],
            "jsonl_last_state": records[-1]["report"]["health"][subsystem]["state"]}


def check_no_sync(torch, tmp: str) -> dict:
    """Call every telemetry primitive while a spin kernel runs: none may wait
    for the card (the spin's event still pending after them), and
    ``host_number`` refuses a CUDA scalar without reading it."""
    from raft_ncup_tpu_torch import observability as obs

    tel = obs.Telemetry()
    tel.flight = obs.FlightRecorder(os.path.join(tmp, "nosync_flight"))
    tel.slo = obs.SloEngine(obs.serve_slos(window_scale=0.01), tel)
    scalar = torch.ones((), device="cuda")
    torch.cuda.synchronize()
    done = torch.cuda.Event()
    torch.cuda._sleep(SPIN_CYCLES)
    done.record()
    t0 = time.perf_counter()
    timings = {}

    def timed(name, fn):
        t = time.perf_counter()
        fn()
        timings[name] = 1e6 * (time.perf_counter() - t)

    timed("inc", lambda: tel.inc("serve_requests_submitted_total"))
    timed("gauge_set", lambda: tel.gauge_set("serve_queue_depth", 3))
    timed("observe_ms", lambda: tel.observe_ms("serve_queue_wait", 1.5, request_id=1))
    timed("hist_observe", lambda: tel.hist_observe("serve_e2e_ms", 12.0))

    def span():
        with tel.span("serve_dispatch", batch_id=0, request_ids=[1], mesh="nomesh",
                      policy="f32") as sp:
            sp.set(iters=12)

    timed("span", span)
    timed("event", lambda: tel.event("inference_executable_compile", key="k"))
    timed("slo_evaluate", tel.slo.evaluate)
    timed("write_healthz", lambda: obs.write_healthz(os.path.join(tmp, "nosync.json"), tel))
    timed("flight_dump", lambda: tel.flight_dump("poison_quarantine", request_id=1))

    def refuse():
        try:
            obs.host_number(scalar)
        except TypeError:
            return
        raise CheckFailed("host_number accepted a CUDA scalar")

    timed("host_number_refuses_cuda_scalar", refuse)
    elapsed_ms = 1e3 * (time.perf_counter() - t0)
    pending = not done.query()
    check(pending, f"a telemetry primitive waited for the card ({elapsed_ms:.1f} ms of calls "
          "finished after the spin kernel)")
    torch.cuda.synchronize()
    check(tel.flight.dumps == 1, "the no-sync flight dump was not written")
    return {"spin_pending_after_calls": pending, "calls_ms": elapsed_ms, "host_us": timings}


def ledger_mfu(torch, model, card_kind: str, precision: str) -> dict:
    """The cost ledger of the flagship's batch-2 forward at 440x1024, 12
    iterations, under ``precision``: its counted FLOPs (aten and kernels)
    beside the analytic count, the replayed forward's device ms (CUDA
    events, 10 replays) and the MFU against the preset's peak."""
    from raft_ncup_tpu_torch.inference.costs import CostLedger, mfu, peak_flops
    from raft_ncup_tpu_torch.inference.pipeline import ShapeCachedForward
    from raft_ncup_tpu_torch.observability import Telemetry
    from raft_ncup_tpu_torch.utils.flops import _ncup_flops, forward_flops

    ledger = CostLedger()
    fwd = ShapeCachedForward(model, policy=precision, telemetry=Telemetry(enabled=False),
                             cost_ledger=ledger)
    gen = torch.Generator().manual_seed(0)
    shape = (PROFILE_BATCH, 440, 1024, 3)
    i1, i2 = (torch.rand(shape, generator=gen).mul(255).cuda() for _ in range(2))
    fwd.forward(i1, i2, 12)
    (entry,) = ledger.snapshot()["entries"].values()
    flush = torch.empty(64 * 2**20 // 4, device="cuda")
    ms = cuda_ms(torch, lambda: fwd.forward(i1, i2, 12), 10, flush)
    dtype = "bf16" if precision.startswith("bf16") else "f32"
    peak = peak_flops("cuda", card_kind, dtype)
    analytic = forward_flops(model.cfg, PROFILE_BATCH, 440, 1024, 12)
    ncup = PROFILE_BATCH * _ncup_flops(model.cfg, 440, 1024, batch_mult=2)
    row = {"precision": precision, "ledger_flops": entry["flops"],
           "flops_by_source": entry["flops_by_source"], "capture_ms": entry["capture_ms"],
           "graph_pool_reserved_bytes": entry["memory_stats"]["graph_pool_reserved_bytes"],
           "analytic_forward_flops": analytic,
           "analytic_with_ncup_once": analytic - 11 * ncup,
           "ledger_over_analytic": entry["flops"] / analytic,
           "replay_ms": ms, "peak_flops": peak, "mfu": mfu(entry["flops"], 1e3 / ms, peak)}
    check(entry["flops"] > 0 and row["mfu"] is not None,
          f"MFU of the {precision} forward: {row}")
    fwd.clear()
    return row


def check_telemetry(torch, card, tmp: str) -> dict:
    """The telemetry of the flagship at 436x1024, 12 iterations, through the
    serve entry with every output on: (a) 8 requests under
    ``poison@3,sigterm@6`` (exit 75; registry counters equal to the legacy
    keys; A 12 and B 4 a batch; healthz READY before the replay and
    DRAINING after, never torn; one poison_quarantine and one
    preemption_drain dump; a ledger entry of positive FLOPs, capture ms and
    pool bytes for every captured key; the ``slo`` block; the JSONL
    tolerant to a cut tail); (b) ``--stream`` with 4 streams of 8 frames
    under ``corruptframe@4`` (one stream_anomaly_reset dump, the stream
    counters equal to the legacy keys, the slot-occupancy gauge, health
    READY then DRAINING; A 12 and B 4 a step); (c) no telemetry primitive
    waits for the card; (d) the same 8 requests served with telemetry on and
    off, 3 times each, interleaved: ``serve_telemetry_overhead_pct``
    (reported, not held); and the ledger's MFU of the replayed f32 and
    ``bf16_infer`` forwards. Returns the launches of (a) and (b)."""
    from raft_ncup_tpu_torch import serve as serve_mod
    from raft_ncup_tpu_torch.config import ServeConfig
    from raft_ncup_tpu_torch.inference.costs import CostLedger, set_cost_ledger
    from raft_ncup_tpu_torch.observability import (Telemetry, serve_slos, set_telemetry,
                                                   stream_slos)

    kind = torch.cuda.get_device_name(0)
    paths = {}
    # (a) the plain branch under chaos.
    rc, rep, responses, paths["telemetry serve"], files = run_telemetry_entry(
        torch, SERVE_EE_ARGS + ["--chaos", TELEMETRY_SERVE_CHAOS], tmp, "serve")
    check(rc == 75, f"telemetry serve: exit {rc}, want 75")
    check_launches(paths["telemetry serve"], "raft_nc_dbl", False, "telemetry serve")
    per_batch = (rep["corr_kernel_launches"] / rep["serve_batches"],
                 rep["nconv_kernel_launches"] / rep["serve_batches"])
    check(per_batch == (12, 4), f"telemetry serve: launches per batch {per_batch}, want 12, 4")
    mirrors = check_mirrors(rep, "serve", "telemetry serve")
    held = check_telemetry_files(files, rep, serve_slos(window_scale=TELEMETRY_SLO_SCALE),
                                 ["poison_quarantine", "preemption_drain"], "telemetry serve")
    entries = rep["cost_ledger"]["entries"]
    check(len(entries) == rep["executables"]["compiles"] > 0 and all(
        e["flops"] > 0 and e["capture_ms"] > 0
        and e["memory_stats"]["graph_pool_reserved_bytes"] > 0 for e in entries.values()),
        f"telemetry serve: ledger {json.dumps(entries)[:400]}")
    check(rep["slo"] is not None and rep["slo"]["specs"], "telemetry serve: no slo block")
    check(all(r.status in ("ok", "rejected") for r in responses),
          f"telemetry serve: statuses {[r.status for r in responses]}")
    print(f"telemetry serve: exit {rc}, {rep['stats']}; launches {paths['telemetry serve']} "
          f"(A, B per batch {per_batch}); mirrors {mirrors}; files {json.dumps(held)}; "
          f"slo paging {rep['slo']['paging']}, pages {rep['slo']['pages_total']}; stages "
          f"{json.dumps(rep['stages'])}; ledger "
          f"{json.dumps({k: [e['flops'], e['capture_ms'], e['memory_stats']] for k, e in entries.items()})}; "
          f"on {card}", flush=True)
    # (b) the stream branch under chaos.
    rc, srep, _, paths["telemetry stream"], sfiles = run_telemetry_entry(
        torch, STREAM_ARGS + ["--chaos", TELEMETRY_STREAM_CHAOS], tmp, "stream")
    check(rc == 0 and srep["resets"] == 1, f"telemetry stream: exit {rc}, {srep['stats']}")
    check_launches(paths["telemetry stream"], "raft_nc_dbl", False, "telemetry stream")
    steps = srep["stream_batches"]
    per_step = (srep["corr_kernel_launches"] / steps, srep["nconv_kernel_launches"] / steps)
    check(per_step == (12, 4), f"telemetry stream: launches per step {per_step}")
    smirrors = check_mirrors(srep, "stream", "telemetry stream")
    sheld = check_telemetry_files(
        sfiles, srep, stream_slos(STREAM_CAPACITY, window_scale=TELEMETRY_SLO_SCALE),
        ["stream_anomaly_reset"], "telemetry stream")
    occ = srep["telemetry"]["metrics"]["gauges"].get("stream_slot_occupancy")
    check(occ is not None and occ["peak"] > 0, f"telemetry stream: occupancy gauge {occ}")
    check(srep["health"]["state"] == "draining", f"telemetry stream: {srep['health']}")
    print(f"telemetry stream: {srep['stats']}; p50 {srep['stream_p50_ms']} ms, p99 "
          f"{srep['stream_p99_ms']} ms; launches {paths['telemetry stream']} (A, B per "
          f"step {per_step}); mirrors {smirrors}; occupancy gauge {occ}; files "
          f"{json.dumps(sheld)}; on {card}", flush=True)
    # (c) no synchronisation.
    nosync = check_no_sync(torch, tmp)
    print(f"telemetry no sync: {json.dumps(nosync)}", flush=True)
    # (d) overhead: the same requests with telemetry on and off, in turns.
    model = flagship(torch)
    pairs = serve_mod.make_pairs(SERVE_SIZE, SERVE_REQUESTS, seed=0)
    cfg = ServeConfig(batch_sizes=(1, 2), iter_levels=(12,), queue_capacity=16)
    p50 = {True: [], False: []}
    for _ in range(OVERHEAD_RUNS):
        for on in (True, False):
            prev, prev_ledger = set_telemetry(Telemetry(enabled=on)), set_cost_ledger(
                CostLedger())
            try:
                orep, oresp = serve_mod.serve_pairs(model, cfg, pairs, SERVE_SIZE)
            finally:
                set_telemetry(prev)
                set_cost_ledger(prev_ledger)
            check(orep["serve_ok"] == SERVE_REQUESTS, f"overhead run: {orep['stats']}")
            p50[on].append(orep["serve_p50_ms"])
    on_ms, off_ms = statistics.median(p50[True]), statistics.median(p50[False])
    overhead = {"serve_p50_ms_runs_on": p50[True], "serve_p50_ms_runs_off": p50[False],
                "serve_p50_ms": on_ms, "serve_p50_ms_notelemetry": off_ms,
                "serve_telemetry_overhead_pct": round(100.0 * (on_ms - off_ms) / off_ms, 2),
                "budget_pct_jax": OVERHEAD_BUDGET_PCT}
    print(f"telemetry overhead: {json.dumps(overhead)} (reported, not held) on {card}",
          flush=True)
    # The ledger's MFU of the replayed forward, f32 and bf16_infer.
    mfus = [ledger_mfu(torch, model, kind, p) for p in ("f32", "bf16_infer")]
    for row in mfus:
        print(f"telemetry mfu {row['precision']}: {json.dumps(row)} on {card}", flush=True)
    del model
    torch.cuda.empty_cache()
    return paths


def check_profile_steps(torch, card, tmp: str, sintel: str) -> dict:
    """``--profile_steps 2`` on the train entry: the flagship at
    ``scripts/train_raft_nc_things.sh``'s configuration on synthetic pairs,
    3 steps (the first untraced). The Chrome trace under
    ``<run_dir>/profile`` holds kernels A, A', B and B' by their kernel
    names, each as often as the two traced steps launched it; every kernel
    count set to 0 before the run and read after it."""
    import re

    base = [t for t in script_flags("train_raft_nc_things.sh") if t != "--compressed_ft"]
    i = base.index("--load_pretrained")
    del base[i:i + 2]
    ckdir = os.path.join(tmp, "profiled")
    argv = base + ["--synthetic_ok", "--root_sintel", sintel, "--checkpoint_dir", ckdir,
                   "--num_steps", "3", "--profile_steps", "2"]
    t0 = time.perf_counter()
    summary, launches, inst, _ = _train_files_run(torch, "profile_steps", argv, 0)
    seconds = time.perf_counter() - t0
    run_dir = os.path.join(ckdir, "exp")
    traces = [os.path.join(run_dir, "profile", n)
              for n in os.listdir(os.path.join(run_dir, "profile"))]
    check(len(traces) == 1, f"profile_steps: traces {traces}")
    with open(os.path.join(run_dir, "log.txt")) as fh:
        check("profile trace written to" in fh.read(), "profile_steps: no log line")
    with open(traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    patterns = {"corr_lookup": r"\bcorr_lookup_kernel<", "corr_lookup_bwd":
                r"\bcorr_lookup_bwd_(tile|query)_kernel\b", "nconv": r"\bnconv_kernel<",
                "nconv_bwd": r"\bnconv_bwd_kernel<"}
    in_trace = {k: 0 for k in patterns}
    for e in events:
        if e.get("cat") == "kernel":
            for k, pat in patterns.items():
                if re.search(pat, e.get("name", "")):
                    in_trace[k] += 1
    traced = inst.steps[1:3]
    want = {k: sum(s["launches"][k] for s in traced) for k in patterns}
    check(in_trace == want and all(want.values()),
          f"profile_steps: kernels in the trace {in_trace}, the traced steps launched {want}")
    row = {"card": card, "seconds": seconds, "trace_bytes": os.path.getsize(traces[0]),
           "kernel_events_in_trace": in_trace, "launches_of_traced_steps": want,
           "launches_per_step": inst.steps[-1]["launches"], "status": summary["status"]}
    print(f"telemetry profile_steps: {json.dumps(row)}", flush=True)
    return launches


# ------------------------------------------------- pipelined serving, guards

PIPE_REQUESTS = 16  # a paused burst: 8 batches of 2 at SERVE_SIZE, level 12
PIPE_STREAMS, PIPE_FRAMES = 4, 4  # a paused burst: 4 batches of 4 streams
PIPE_MODES = (("pipelined", None), ("waiting", 1))  # (name, ServeConfig.inflight)


def device_busy(torch, fn) -> dict:
    """Wall ms of ``fn()`` (ending in a synchronise) under a trace of the
    card's activity only (no host-op recording that would slow a host-bound
    window), the device ms its kernels and copies took, and the busy share
    ``device / wall``."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    device_ms = sum((getattr(e, "self_device_time_total", 0.0) or 0.0) / 1e3
                    for e in prof.key_averages()
                    if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    check(device_ms > 0, "the pipelined window's trace holds no device time")
    return {"wall_ms": wall_ms, "device_ms": device_ms, "busy_share": device_ms / wall_ms}


def paused_burst(server, items, stream=False) -> tuple:
    """Every item submitted while ``server`` is paused, then released: the
    batches are the same for any dispatch timing. Returns ``(responses,
    wall seconds from the release to the last answer)``."""
    server.pause()
    if stream:
        handles = [server.submit(sid, a, b, frame_index=f) for sid, f, a, b in items]
    else:
        handles = [server.submit(a, b) for a, b in items]
    t0 = time.perf_counter()
    server.resume()
    rs = [h.result(300) for h in handles]
    return rs, time.perf_counter() - t0


def _burst_row(rs, wall, unit) -> dict:
    from raft_ncup_tpu_torch.serving.request import nearest_rank_ms

    lat = [r.latency_s for r in rs]
    return {f"{unit}_per_sec": len(rs) / wall, "p50_ms": nearest_rank_ms(lat, 0.5),
            "p99_ms": nearest_rank_ms(lat, 0.99), "wall_s": wall}


def _same_answers(rs, want, what) -> None:
    for a, b in zip(rs, want):
        check(a.status == b.status == "ok", f"{what}: {a.status} / {b.status}: {a.detail}")
        check(a.flow.tobytes() == b.flow.tobytes(), f"{what}: an answer differs from the "
              "waiting server's on the same paused burst")


def guarded_burst(server, items, n_batches, what, stream=False) -> dict:
    """A paused burst under the port's runtime guards with the native layer
    on (``torch.cuda.set_sync_debug_mode("error")``): no implicit read, no
    capture or kernel load, one sanctioned read a batch."""
    from raft_ncup_tpu_torch.analysis.guards import forbid_host_transfers, max_recompiles

    with forbid_host_transfers() as gs, max_recompiles(0) as wd:
        rs, _ = paused_burst(server, items, stream)
    check(all(r.ok for r in rs), f"{what} under the guards: {[r.detail for r in rs][:2]}")
    check(gs.host_transfers == 0 and wd.count == 0 and gs.sanctioned_gets == n_batches,
          f"{what} under the guards: {gs.host_transfers} implicit reads {gs.violations[:3]}, "
          f"{wd.count} captures, {gs.sanctioned_gets} sanctioned reads for {n_batches} batches")
    return {"host_transfers": gs.host_transfers, "captures_after_warmup": wd.count,
            "sanctioned_gets": gs.sanctioned_gets, "batches": n_batches}


def check_planted_read(torch, server, pairs) -> dict:
    """A ``.item()`` planted in the served batch's launch, in a guarded
    window that counts instead of raising: the Python layer counts it, the
    native layer stops it (the batch answers ``error``), and the next batch
    serves again. The guard cannot pass vacuously."""
    from raft_ncup_tpu_torch.analysis.guards import forbid_host_transfers

    real = server._forward

    def planted(*args, **kw):
        flow_up, exec_iters = real(*args, **kw)
        flow_up[0, 0, 0, 0].item()  # the planted per-batch read
        return flow_up, exec_iters

    server._forward = planted
    try:
        with forbid_host_transfers(raise_on_violation=False) as gs:
            rs, _ = paused_burst(server, pairs[:2])
    finally:
        server._forward = real
    after, _ = paused_burst(server, pairs[:2])
    check(gs.host_transfers == 1 and "torch.Tensor.item" in gs.violations[0],
          f"the planted read was not counted: {gs.violations}")
    check(all(r.status == "error" and "synchronizing" in r.detail for r in rs),
          f"the native layer did not stop the planted read: {[r.detail for r in rs]}")
    check(all(r.ok for r in after), "the server did not serve after the planted read")
    return {"python_layer_counted": gs.host_transfers, "native_layer_stopped": len(rs)}


def check_pipelined_serve(torch, card) -> dict:
    """The flagship served pipelined (``inflight`` default, 2 on the card)
    and waiting (``inflight=1``) in one process, f32 and ``bf16_infer``:
    a paused burst of ``PIPE_REQUESTS`` pairs through each, bit-equal
    answers; one burst of each under the guards; two timed bursts of each,
    in turns (pairs/s, p50, p99); one traced (the card's busy share); the
    launches of the first timed pipelined burst; a planted read (f32)."""
    from raft_ncup_tpu_torch.config import ServeConfig
    from raft_ncup_tpu_torch.serve import make_pairs
    from raft_ncup_tpu_torch.serving import FlowServer

    model = flagship(torch)
    pairs = make_pairs(SERVE_SIZE, PIPE_REQUESTS, seed=1)
    n_batches = PIPE_REQUESTS // 2
    out, paths = {}, {}
    for precision in ("f32", "bf16_infer"):
        servers = {name: FlowServer(model, ServeConfig(
            batch_sizes=(1, 2), iter_levels=(12,), queue_capacity=2 * PIPE_REQUESTS,
            precision=precision, inflight=inflight)) for name, inflight in PIPE_MODES}
        rows = {name: {"timed": []} for name in servers}
        try:
            for name, srv in servers.items():
                srv.warmup(SERVE_SIZE)
                rows[name]["inflight_bound"] = srv._throttle.inflight or 2
            want, _ = paused_burst(servers["waiting"], pairs)
            for name, srv in servers.items():
                rs, _ = paused_burst(srv, pairs)
                _same_answers(rs, want, f"serve {precision} {name}")
                rows[name]["guards"] = guarded_burst(srv, pairs, n_batches,
                                                     f"serve {precision} {name}")
            for rnd in range(2):
                for name, srv in servers.items():
                    if rnd == 0 and name == "pipelined":
                        reset_launches()
                    rs, wall = paused_burst(srv, pairs)
                    if rnd == 0 and name == "pipelined":
                        torch.cuda.synchronize()
                        paths[f"pipelined serve {precision}"] = launches = read_launches()
                        check(launches["corr_lookup"] == 12 * n_batches
                              and launches["nconv"] == 4 * n_batches
                              and launches["corr_lookup_bwd"] == 0
                              and launches["nconv_bwd"] == 0,
                              f"pipelined serve {precision}: launches {launches}")
                    _same_answers(rs, want, f"serve {precision} {name} timed")
                    rows[name]["timed"].append(_burst_row(rs, wall, "pairs"))
            for name, srv in servers.items():
                rows[name]["trace"] = device_busy(torch, lambda: paused_burst(srv, pairs))
            if precision == "f32":
                out["planted_read"] = check_planted_read(torch, servers["pipelined"], pairs)
        finally:
            for srv in servers.values():
                srv.drain()
        del servers
        torch.cuda.empty_cache()
        out[precision] = rows
        for name, row in rows.items():
            print(f"pipelined serve {precision} {name}: {json.dumps(row)} on {card}", flush=True)
    del model
    torch.cuda.empty_cache()
    return out, paths


def check_pipelined_stream(torch, card) -> dict:
    """The flagship's stream engine pipelined and waiting, f32 and
    ``bf16_infer``: ``PIPE_STREAMS`` streams of ``PIPE_FRAMES`` frames in
    one paused burst (so step n+1 is staged and launched while step n runs,
    every batch a round of 4), bit-equal answers, one burst of each under
    the guards, two timed bursts of each in turns (frames/s, p50, p99) and
    one traced (busy share)."""
    from raft_ncup_tpu_torch.config import StreamConfig
    from raft_ncup_tpu_torch.serve import make_pairs
    from raft_ncup_tpu_torch.streaming import StreamEngine

    model = flagship(torch)
    frames = make_pairs(SERVE_SIZE, PIPE_FRAMES + 1, seed=2)
    out, paths = {}, {}
    for precision in ("f32", "bf16_infer"):
        engines = {name: StreamEngine(model, StreamConfig(
            capacity=PIPE_STREAMS, frame_hw=SERVE_SIZE, iters=12, batch_sizes=(PIPE_STREAMS,),
            queue_capacity=PIPE_STREAMS * PIPE_FRAMES, precision=precision, inflight=inflight))
            for name, inflight in PIPE_MODES}
        rows = {name: {"timed": []} for name in engines}

        def burst(first):
            # Every stream's frames first .. first + PIPE_FRAMES - 1: each
            # burst continues the streams' indices, so its frames start warm.
            return [(f"s{s}", first + f, frames[(s + f) % len(frames)][0],
                     frames[(s + f + 1) % len(frames)][1])
                    for f in range(PIPE_FRAMES) for s in range(PIPE_STREAMS)]

        try:
            for eng in engines.values():
                eng.warmup()
            results = {name: paused_burst(eng, burst(0), stream=True)[0]
                       for name, eng in engines.items()}
            _same_answers(results["pipelined"], results["waiting"], f"stream {precision}")
            for name, eng in engines.items():
                rows[name]["guards"] = guarded_burst(eng, burst(PIPE_FRAMES), PIPE_FRAMES,
                                                     f"stream {precision} {name}", stream=True)
            for rnd in range(2):
                for name, eng in engines.items():
                    if rnd == 0 and name == "pipelined":
                        reset_launches()
                    rs, wall = paused_burst(eng, burst((2 + rnd) * PIPE_FRAMES), stream=True)
                    if rnd == 0 and name == "pipelined":
                        torch.cuda.synchronize()
                        paths[f"pipelined stream {precision}"] = launches = read_launches()
                        check(launches["corr_lookup"] == 12 * PIPE_FRAMES
                              and launches["nconv"] == 4 * PIPE_FRAMES,
                              f"pipelined stream {precision}: launches {launches}")
                    check(all(r.ok for r in rs), f"stream {precision} {name}: not all ok")
                    rows[name]["timed"].append(_burst_row(rs, wall, "frames"))
            for name, eng in engines.items():
                rows[name]["trace"] = device_busy(
                    torch, lambda: paused_burst(eng, burst(4 * PIPE_FRAMES), stream=True))
            for name, eng in engines.items():
                rows[name]["captures"] = eng.report()["executables"]["compiles"]
                check(rows[name]["captures"] == 1, f"stream {precision} {name}: captures "
                      f"{rows[name]['captures']}, want 1 (at warm-up)")
        finally:
            for eng in engines.values():
                eng.drain()
        del engines
        torch.cuda.empty_cache()
        out[precision] = rows
        for name, row in rows.items():
            print(f"pipelined stream {precision} {name}: {json.dumps(row)} on {card}", flush=True)
    del model
    torch.cuda.empty_cache()
    return out, paths


def check_strict_guards(torch, card, tmp: str) -> dict:
    """The train entry under ``--strict_guards``: the flagship at
    ``scripts/train_raft_nc_things.sh``'s configuration on synthetic pairs,
    3 steps, ``--sum_freq 1`` (the logger's read inside every step's
    scope), every kernel count set to 0 before and read after: JAX's
    ``strict_guards:`` line with no implicit read and no steady recompile;
    then one step with a per-step ``.item()`` planted in the step, which
    must fail the run with ``GuardViolation``."""
    import io

    from raft_ncup_tpu_torch import train as train_mod
    from raft_ncup_tpu_torch.analysis.guards import GuardViolation

    base = [t for t in script_flags("train_raft_nc_things.sh") if t != "--compressed_ft"]
    for flag, n in (("--load_pretrained", 1), ("--validation", 1)):
        i = base.index(flag)
        del base[i:i + 1 + n]
    argv = base + ["--synthetic_ok", "--num_steps", "3", "--sum_freq", "1", "--strict_guards"]
    buf = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with counting_plain_versions() as plain, contextlib.redirect_stdout(buf):
        status = train_mod.main(argv + ["--checkpoint_dir", os.path.join(tmp, "strict")])
    seconds = time.perf_counter() - t0
    launches = read_launches()
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    with open(os.path.join(tmp, "strict", "exp", "log.txt")) as fh:
        line = [ln for ln in fh.read().splitlines() if ln.startswith("strict_guards:")]
    sg = summary["strict_guards"]
    check(status == 0 and not plain and all(launches.values()),
          f"strict_guards: exit {status}, plain {plain}, launches {launches}")
    check(len(line) == 1 and sg["steady_recompiles"] == 0 and sg["host_transfers"] == 0
          and sg["sanctioned_gets"] == 3, f"strict_guards: {line} {sg}")

    real = train_mod.make_train_step

    def planted(cfg, *a, **kw):
        step = real(cfg, *a, **kw)

        def read_each_step(state, batch):
            metrics = step(state, batch)
            metrics["loss"].item()  # the planted per-step read
            return metrics

        return read_each_step

    train_mod.make_train_step = planted
    caught = None
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            train_mod.main(argv + ["--checkpoint_dir", os.path.join(tmp, "planted"),
                                   "--num_steps", "1"])
    except GuardViolation as e:
        caught = str(e)
    finally:
        train_mod.make_train_step = real
    check(caught is not None and "torch.Tensor.item" in caught,
          f"strict_guards: the planted per-step read did not fail the run ({caught})")
    row = {"card": card, "seconds": seconds, "line": line[0], "launches": launches,
           "planted_read_failed_the_run": True}
    print(f"strict_guards train: {json.dumps(row)}", flush=True)
    return launches


# ------------------------------------------------------------ empty level

def check_empty_level(torch, gen) -> dict:
    """Kernels A and A' on a pyramid with an empty level, the small raft's at
    32x48 (features 4x6: levels 4x6, 2x3, 1x1 and 0x0), against their plain
    versions: A within ``CORR_TOL`` and the empty level's taps zero; A',
    without and with d coords, and the lookup's autograd through its
    ``autograd.Function`` (both kernels), within ``GRAD_TOL`` of the float64
    plain autograd, the empty level's gradient zeros of its own shape."""
    from raft_ncup_tpu_torch.ops import corr_cuda

    B, H, W, C, r = 2, 4, 6, 128, 3
    K = 2 * r + 1
    f1 = torch.randn(B, H, W, C, generator=gen)
    f2 = torch.randn(B, H, W, C, generator=gen)
    f1s, lv = corr_cuda.prepare_levels(f1.cuda(), f2.cuda(), 4)
    shapes = [tuple(t.shape[1:3]) for t in lv]
    check(shapes == [(4, 6), (2, 3), (1, 1), (0, 0)], f"empty-level pyramid: {shapes}")
    y, x = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    grid = torch.stack([x, y], -1).float()[None].expand(B, H, W, 2)
    coords = (grid + (torch.rand(B, H, W, 2, generator=gen) * 2 - 1) * 3).contiguous().cuda()
    out = corr_cuda.lookup_levels(f1s, lv, coords, r)
    fwd_err, ok = max_err(torch, out, corr_cuda.lookup_pyramid(f1s, lv, coords, r), **CORR_TOL)
    check(ok and not bool(out[..., 3 * K * K:].any()),
          f"kernel A on an empty level: max |kernel-plain| {fwd_err:.3e}")
    g = torch.randn(B, H, W, 4 * K * K, generator=gen).cuda()
    ref = corr_bwd_ref(torch, f1s, lv, coords, r, g)
    worst = 0.0
    for needs in ((True, True, False), (True, True, True)):
        got = corr_cuda.lookup_levels_backward(f1s, lv, coords, r, g, needs)
        pairs = [(got[0], ref[0])] + list(zip(got[1], ref[1]))
        if needs[2]:
            pairs.append((got[2], ref[2]))
        check(tuple(got[1][3].shape) == tuple(lv[3].shape), "A' on an empty level: d level "
              f"{tuple(got[1][3].shape)}")
        for a, b in pairs:
            if b.numel():
                e, same, _ = grad_err(torch, a, b)
                check(same and e <= GRAD_TOL, f"kernel A' on an empty level (needs {needs}): "
                                              f"{e:.3e}")
                worst = max(worst, e)
    leaves = [f1s.clone().requires_grad_(), coords.clone().requires_grad_()] + [
        t.clone().requires_grad_() for t in lv]
    with torch.enable_grad():
        grads = torch.autograd.grad(corr_cuda.lookup_levels(leaves[0], leaves[2:], leaves[1], r),
                                    leaves, g)
    for a, b in zip([grads[0], *grads[2:], grads[1]], [ref[0], *ref[1], ref[2]]):
        check(tuple(a.shape) == tuple(b.shape), f"autograd on an empty level: {a.shape}")
        if b.numel():
            e, same, _ = grad_err(torch, a, b)
            check(same and e <= GRAD_TOL, f"the lookup's autograd on an empty level: {e:.3e}")
            worst = max(worst, e)
    row = {"levels": shapes, "fwd_max_abs_err": fwd_err, "bwd_max_rel_err": worst}
    print(f"kernels A and A' on an empty pyramid level (small raft at 32x48): {json.dumps(row)}",
          flush=True)
    return row


# ----------------------------------------------------------------- fleet

FLEET_PAIRS = 16  # the paused burst through the router
FLEET_STREAMS, FLEET_FRAMES = 2, 4
FLEET_KILL_AT = 3  # killreplica@3 in an 8-pair burst
# A replica's flow against the in-process server's for the same pair: the
# same weights and configuration in another process, whose cuDNN autotuning
# may pick other convolution algorithms, so the tolerance of a kernel
# forward against the plain-version forward.
FLEET_TOL = FLOW_UP_TOL


def fleet_config(tmp: str):
    """Two flagship replicas at the served shape on the one card, f32,
    batch sizes 1 and 2 at level 12, streams on (12 iterations, batch sizes
    1 and 2), UDS, weights from seed 0; one restart each."""
    from raft_ncup_tpu_torch.config import ServeConfig, StreamConfig
    from raft_ncup_tpu_torch.fleet import FleetConfig

    return FleetConfig(
        base_dir=os.path.join(tmp, "fleet"), n_replicas=2, size_hw=SERVE_SIZE,
        serve=ServeConfig(batch_sizes=(1, 2), iter_levels=(12,), queue_capacity=4 * FLEET_PAIRS),
        stream=StreamConfig(capacity=4, frame_hw=SERVE_SIZE, iters=12, batch_sizes=(1, 2),
                            queue_capacity=16, max_frame_gap=10, idle_timeout_s=600.0,
                            cache_size=2),
        extra_args=("--model", "raft_nc_dbl", "--seed", "0"),
        snapshot_interval_s=0.5, stale_after_factor=8.0, poll_interval_s=0.1,
        spawn_timeout_s=300.0, drain_timeout_s=120.0, max_restarts=1, restart_backoff_s=0.5,
        max_inflight_per_replica=2 * FLEET_PAIRS)


def _fleet_burst(router, pairs, **kw) -> tuple:
    """Every pair submitted to the router at once: (responses, wall seconds
    from the first submit to the last answer)."""
    t0 = time.perf_counter()
    handles = [router.submit(a, b, deadline_s=120.0, **kw) for a, b in pairs]
    rs = [h.result(300) for h in handles]
    return rs, time.perf_counter() - t0


def _against(torch, rs, want, what) -> dict:
    """Every answer ok and within ``FLEET_TOL`` of the in-process answer:
    the largest |diff| and how many are bit for bit equal."""
    worst, same = 0.0, 0
    for k, (a, b) in enumerate(zip(rs, want)):
        check(a.status == "ok" and b.status == "ok", f"{what} {k}: {a.status} {a.detail} / "
                                                   f"{b.status}")
        err, ok = max_err(torch, torch.tensor(a.flow), torch.tensor(b.flow), **FLEET_TOL)
        check(ok, f"{what} {k}: a replica's flow is {err:.3e} from the in-process server's")
        worst, same = max(worst, err), same + (a.flow.tobytes() == b.flow.tobytes())
    return {"n": len(rs), "max_abs_diff": worst, "bit_equal": same}


def _replica_launches(rep: dict, what: str) -> dict:
    """A replica's report: no recompile, no host transfer, and its kernel
    launches after warm-up those of the batches it served (A 12 and B 4 a
    batch of either tier)."""
    batches = rep["serve_batches"] + rep.get("stream_batches", 0)
    launches = {"corr_lookup": rep["corr_kernel_launches"], "nconv": rep["nconv_kernel_launches"],
                "corr_lookup_bwd": 0, "nconv_bwd": 0}
    check(rep["recompiles"] == 0 and rep["host_transfers"] == 0,
          f"{what}: {rep['recompiles']} recompiles, {rep['host_transfers']} host transfers")
    check(batches > 0 and launches["corr_lookup"] == 12 * batches
          and launches["nconv"] == 4 * batches,
          f"{what}: launches {launches} for {batches} batches")
    return launches


def check_fleet(torch, card, tmp: str) -> tuple:
    """Two flagship replicas of the serve entry (``--replica_socket``) on the
    one card behind the port's supervisor and router, against an in-process
    server and stream engine built from replica 0's argv (the same seed):
    both READY with their identity in healthz; a burst of ``FLEET_PAIRS``
    pairs and ``FLEET_STREAMS`` streams of ``FLEET_FRAMES`` frames, each
    answer ok and within ``FLEET_TOL`` of the in-process one (bit-equal
    answers counted); two timed fleet bursts against two of the in-process
    pipelined server in turns; the router's hop medians; the telemetry
    overhead from ``set_telemetry`` off and on windows; ``killreplica@3``
    mid-burst (failover within the deadline, a ``replica_failover`` dump,
    the dead replica's streams re-homed cold, checked against a cold start
    in-process), the replica's restart; ``drainreplica`` on the survivor with
    work in flight (DRAINING in healthz, every admitted request answered,
    exit 75); and each replica's report: 0 recompiles, 0 host transfers, A
    12 and B 4 launches a batch. Returns ``(row, paths)``."""
    from raft_ncup_tpu_torch import serve as serve_mod
    from raft_ncup_tpu_torch.cli import (
        model_config_from_args,
        serve_config_from_args,
        stream_config_from_args,
    )
    from raft_ncup_tpu_torch.fleet import ReplicaSupervisor, FleetRouter, read_healthz, \
        replay_fleet
    from raft_ncup_tpu_torch.fleet.replica import UP
    from raft_ncup_tpu_torch.fleet.router import rendezvous_choice
    from raft_ncup_tpu_torch.observability import Telemetry
    from raft_ncup_tpu_torch.resilience.chaos import ChaosSpec
    from raft_ncup_tpu_torch.serve import make_pairs
    from raft_ncup_tpu_torch.serving import FlowServer, nearest_rank_ms
    from raft_ncup_tpu_torch.streaming import StreamEngine

    cfg = fleet_config(tmp)
    tel = Telemetry(flight_dir=os.path.join(cfg.base_dir, "router_flight"))
    sup = ReplicaSupervisor(cfg, telemetry=tel)
    row, paths = {"card": card}, {}
    t0 = time.perf_counter()
    sup.start(wait_ready=False)  # the replicas warm up while this process builds its own
    model = server = engine = router = None
    try:
        args = serve_mod.build_parser().parse_args(cfg.replica_argv(0))
        model = serve_mod.load_model(model_config_from_args(args, dataset="sintel"), None,
                                     None, args.seed)
        server = FlowServer(model, serve_config_from_args(args))
        engine = StreamEngine(model, stream_config_from_args(args, SERVE_SIZE))
        server.warmup(SERVE_SIZE)
        engine.warmup()
        pairs = make_pairs(SERVE_SIZE, FLEET_PAIRS, seed=3)
        # One stream homed on each replica (the router's rendezvous hash over
        # both), so whichever replica the kill hits, a stream re-homes.
        sids = [next(f"s{k}" for k in range(100) if rendezvous_choice(f"s{k}", [0, 1]) == i)
                for i in range(FLEET_STREAMS)]
        seqs = {sid: [p[0] for p in make_pairs(SERVE_SIZE, FLEET_FRAMES + 2, seed=10 + k)]
                for k, sid in enumerate(sids)}
        want, _ = paused_burst(server, pairs)
        want_frames = {}
        for f in range(FLEET_FRAMES + 1):
            items = [(sid, f, seq[f], seq[f + 1]) for sid, seq in seqs.items()]
            for (sid, *_), r in zip(items, paused_burst(engine, items, stream=True)[0]):
                want_frames[(sid, f)] = r

        sup.wait_ready()
        row["ready_s"] = time.perf_counter() - t0
        for i in range(2):
            hz = read_healthz(cfg.replica(i).healthz_path) or {}
            check(hz.get("overall") == "ready" and hz.get("replica") == i and hz.get("warmed")
                  and hz.get("stream_warmed") and hz.get("pid") == sup.replicas[i].child.pid,
                  f"fleet replica {i}: healthz {json.dumps(hz)[:400]}")
        router = FleetRouter(cfg, sup, telemetry=tel)
        rs, _ = _fleet_burst(router, pairs)
        row["burst"] = _against(torch, rs, want, "fleet burst")
        got = {}
        for f in range(FLEET_FRAMES):
            for sid, seq in seqs.items():
                got[(sid, f)] = router.submit(seq[f], seq[f + 1], stream_id=sid, frame_index=f)
        keys = sorted(got)
        row["streams"] = _against(torch, [got[k].result(300) for k in keys],
                                  [want_frames[k] for k in keys], "fleet stream frame")
        dispatched = router.report()["per_replica_dispatched"]
        check(all(dispatched.get(i, 0) > 0 for i in (0, 1)),
              f"the burst did not reach both replicas: {dispatched}")
        timed = {"fleet": [], "in_process": []}
        for _ in range(2):
            rs, wall = _fleet_burst(router, pairs)
            _against(torch, rs, want, "timed fleet burst")
            timed["fleet"].append(_burst_row(rs, wall, "pairs"))
            rs, wall = paused_burst(server, pairs)
            timed["in_process"].append(_burst_row(rs, wall, "pairs"))
        row["timed"] = timed
        row["fleet_hops"] = {k: v for k, v in tel.tracer.stage_summary().items()
                             if k.startswith("fleet_hop_") or k == "fleet_request"}
        # The telemetry overhead: the same warm fleet with every hub off and
        # on (the replicas' over the wire, the router's here), in the turns
        # off, on, on, off; JAX's metric on the mean p50 of each side.
        p50 = {False: [], True: []}
        for on in (False, True, True, False):
            check(router.set_fleet_telemetry(on, timeout=15.0) == 2, "set_telemetry unacked")
            tel.enabled = on
            rs, _ = _fleet_burst(router, pairs)
            p50[on].append(nearest_rank_ms([r.latency_s for r in rs], 0.5))
        p50_on, p50_off = statistics.mean(p50[True]), statistics.mean(p50[False])
        row["telemetry"] = {"p50_ms_on": p50[True], "p50_ms_off": p50[False],
                            "fleet_telemetry_overhead_pct": 100.0 * (p50_on - p50_off) / p50_off}
        check(router.set_fleet_telemetry(True, timeout=15.0) == 2, "set_telemetry unacked")
        tel.enabled = True

        # killreplica mid-burst: the replica that carried submission 3 dies.
        homes = dict(router.report()["affinity"])
        items = [{"image1": a, "image2": b, "deadline_s": 120.0} for a, b in pairs[:8]]
        handles = replay_fleet(router, items, supervisor=sup,
                               chaos=ChaosSpec.parse(f"killreplica@{FLEET_KILL_AT}"))
        rs = [h.result(300) for h in handles]
        victim = next(h.index for h in sup.replicas if h.deaths)
        survivor = 1 - victim
        row["kill"] = {"victim": victim, **_against(torch, rs, want[:8], "failed-over burst"),
                       "failovers": router.stats["failovers"]}
        check(router.stats["failovers"] >= 1, f"no failover after the kill: {router.stats}")
        dumps = os.listdir(os.path.join(cfg.base_dir, "router_flight"))
        check(any(d.startswith("flight_replica_failover_") for d in dumps),
              f"no replica_failover dump: {dumps}")
        f = FLEET_FRAMES
        rs, want_rehome = [], []
        for sid, seq in seqs.items():
            rs.append(router.submit(seq[f], seq[f + 1], stream_id=sid,
                                    frame_index=f).result(300))
            if homes[sid] == victim:  # re-homed: a cold start on the survivor
                want_rehome.append(engine.submit(f"{sid}-cold", seq[f], seq[f + 1],
                                                 frame_index=f).result(300))
            else:
                want_rehome.append(want_frames[(sid, f)])
        row["rehomed_streams"] = {
            "moved": sorted(s for s in seqs if homes[s] == victim),
            **_against(torch, rs, want_rehome, "re-homed stream frame")}
        check(row["rehomed_streams"]["moved"] and set(
            router.report()["affinity"].values()) == {survivor},
              f"no stream re-homed on the survivor: {homes} -> {router.report()['affinity']}")
        t1 = time.perf_counter()
        while sup.replicas[victim].state != UP and time.perf_counter() - t1 < 300:
            time.sleep(0.1)
        check(sup.replicas[victim].state == UP and sup.replicas[victim].restarts == 1,
              f"the killed replica did not come back: {sup.report()}")
        row["restart_ready_s"] = time.perf_counter() - t1
        rs, _ = _fleet_burst(router, pairs[:4])
        row["after_restart"] = _against(torch, rs, want[:4], "burst after the restart")

        # drainreplica on the survivor with work in flight.
        handles = [router.submit(a, b, deadline_s=120.0) for a, b in pairs[:8]]
        time.sleep(0.2)
        out = sup.drain(survivor)
        rs = [h.result(300) for h in handles]
        check(out["observed_draining"] and out["returncode"] == 75,
              f"drainreplica: {out['observed_draining']} rc {out['returncode']}")
        row["drain"] = {"replica": survivor, "returncode": out["returncode"],
                        **_against(torch, rs, want[:8], "burst across the drain")}
        router.drain()
        router = None
        reports = sup.stop()
        left = [f"{pid} {state} {cmd}" for pid, (state, cmd) in descendants().items()
                if "--replica_socket" in cmd]
        check(not left, f"replica processes outlive the supervisor's stop: {left}")
        reps = {survivor: out["report"], victim: reports[victim]["report"]}
        check(all(reps.values()), f"a replica printed no report: {reps}")
        sup_report = sup.report()
        check(sup_report["contract_violations"] == [],
              f"fleet contract violations: {sup_report['contract_violations']}")
        row["replicas"] = {}
        for i in (0, 1):
            rep = reps[i]
            paths[f"fleet replica {i}"] = launches = _replica_launches(rep, f"fleet replica {i}")
            row["replicas"][i] = {
                "incarnation": "restarted" if i == victim else "first",
                "completed": rep["completed"], "stream_completed": rep.get("stream_completed"),
                "serve_batches": rep["serve_batches"], "stream_batches": rep.get("stream_batches"),
                "launches": launches, "recompiles": rep["recompiles"],
                "host_transfers": rep["host_transfers"],
                "graph_pool_bytes": rep["graph_pool_bytes"],
                "stream_graph_pool_bytes": rep["stream_report"]["graph_pool_bytes"],
                "warmup_s": rep["warmup_s"]}
    finally:
        if router is not None:
            router.drain(timeout=5.0)
        sup.stop(drain=False)
        for srv in (server, engine):
            if srv is not None:
                srv.drain()
    del model, server, engine
    torch.cuda.empty_cache()
    fleet = [r["pairs_per_sec"] for r in row["timed"]["fleet"]]
    local = [r["pairs_per_sec"] for r in row["timed"]["in_process"]]
    print(f"fleet: 2 replicas of raft_nc_dbl f32 at {SERVE_SIZE[0]}x{SERVE_SIZE[1]} on one card, "
          f"ready in {row['ready_s']:.1f} s; burst {json.dumps(row['burst'])}, streams "
          f"{json.dumps(row['streams'])} (tolerance {FLEET_TOL}) on {card}", flush=True)
    print(f"fleet pairs/s: fleet {fleet} vs in-process pipelined {local} (bursts of "
          f"{FLEET_PAIRS}) on {card}", flush=True)
    print(f"fleet hops: {json.dumps(row['fleet_hops'])} on {card}", flush=True)
    print(f"fleet telemetry: {json.dumps(row['telemetry'])} on {card}", flush=True)
    print(f"fleet chaos: kill {json.dumps(row['kill'])}, re-homed {json.dumps(row['rehomed_streams'])}"
          f", restart ready in {row['restart_ready_s']:.1f} s, drain {json.dumps(row['drain'])} "
          f"on {card}", flush=True)
    for i, rep in row["replicas"].items():
        print(f"fleet replica {i}: {json.dumps(rep)} on {card}", flush=True)
    return row, paths


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from raft_ncup_tpu_torch.ops import cuda_build
    except ImportError as e:
        print(f"chip_smoke: the port package is missing: {e}", file=sys.stderr)
        return 2

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}",
          flush=True)

    t0 = time.perf_counter()
    seconds = cuda_build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall, per kernel {seconds}", flush=True)
    for name in cuda_build.KERNELS:
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    gen = torch.Generator().manual_seed(0)
    flush = torch.empty(64 * 2**20 // 4, device="cuda")
    corr_served = check_corr(torch, gen, flush, "served shape", B=2, H=55, W=128)
    corr_smooth = check_corr(torch, gen, flush, "served shape", B=2, H=55, W=128,
                             mix="smooth")
    served_paths = {k: corr_served["path_tiles"][k] + corr_smooth["path_tiles"][k]
                    for k in ("tiled", "per_query")}
    check(served_paths["tiled"] > 0 and served_paths["per_query"] > 0,
          f"the served rows did not take both paths of the corr kernel: {served_paths}")
    corr_banded = check_corr(torch, gen, flush, "1080p shape", B=1, H=136, W=240)
    corr_4k = check_corr(torch, gen, flush, "4K shape", B=1, H=272, W=480, plain_reps=1)
    # The small model's served shape (fnet 128, radius 3), from a generator
    # of its own so the rows above and below keep their inputs.
    small_gen = torch.Generator().manual_seed(0)
    corr_small = [check_corr(torch, small_gen, flush, "small model's served shape", B=2,
                             H=55, W=128, C=128, radius=3, mix=mix)
                  for mix in ("random", "smooth")]
    # Kernel A on bf16 features (the bf16 presets), from a generator of its
    # own: the served shape with both mixes, 1088x1920 and the small model's
    # served shape with both mixes.
    bf16_gen = torch.Generator().manual_seed(0)
    bf16 = torch.bfloat16
    corr_bf16 = [check_corr(torch, bf16_gen, flush, "served shape, bf16", B=2, H=55, W=128,
                            mix=mix, dtype=bf16) for mix in ("random", "smooth")]
    corr_bf16.append(check_corr(torch, bf16_gen, flush, "1080p shape, bf16", B=1, H=136,
                                W=240, dtype=bf16))
    corr_bf16 += [check_corr(torch, bf16_gen, flush, "small model's served shape, bf16", B=2,
                             H=55, W=128, C=128, radius=3, mix=mix, dtype=bf16)
                  for mix in ("random", "smooth")]
    check_corr_edges(torch, gen)
    nconv_rows = check_nconv(torch, gen, flush)
    check_nconv_edges(torch, gen)
    corr_bwd, corr_bwd_small, nconv_bwd_rows = check_backward(torch, gen, flush)
    # The lookup's autograd on bf16 features, as bf16_train runs it, at the
    # flagship's training shape (both mixes from a generator of its own).
    bf16_bwd_gen = backward_generator(torch)
    for mix in ("random", "smooth"):
        check_corr_bwd_bf16(torch, bf16_bwd_gen, mix)
    check_wrappers_refuse(torch)
    # Kernels A and A' on a pyramid with an empty (0x0) level.
    check_empty_level(torch, torch.Generator().manual_seed(0))

    # The main paths, each with the kernel counts set to 0 just before it
    # and read just after: serving the flagship, raft and small raft, then
    # training them.
    paths = {}
    for variant, small in SERVED_MODELS:
        label = model_label(variant, small)
        model, _, paths[f"serve {label}"] = check_serve(torch, card, variant, small)
        if not small:
            profile = profile_forward(torch, model, card)
            check(profile["device_ms"] is not None, "the trace holds no device time")
        del model
        torch.cuda.empty_cache()
    launches = paths["serve raft_nc_dbl"]
    # The bf16 presets: the flagship, raft and small raft served under
    # bf16_infer (the f32-built models, ServeConfig.precision), the
    # flagship's bf16 forward traced, and the flagship trained under
    # bf16_train.
    for variant, small in BF16_SERVED:
        label = model_label(variant, small, "bf16_infer")
        model, _, paths[f"serve {label}"] = check_serve(torch, card, variant, small,
                                                        "bf16_infer")
        if variant == "raft_nc_dbl":
            profile = profile_forward(torch, model.with_policy("bf16_infer"), card)
            check(profile["device_ms"] is not None, "the bf16 trace holds no device time")
        del model
        torch.cuda.empty_cache()
    # The evaluate paths: the flagship's synthetic validators in f32 and
    # under bf16_infer, the warm-start validator over sequences written with
    # the port's codecs, replayed forwards traced beside the eager ones, and
    # the evaluate and demo entries in processes of their own.
    for precision in ("f32", "bf16_infer"):
        label = model_label("raft_nc_dbl", False, precision)
        _, paths[f"evaluate {label} synthetic"] = check_eval(torch, card, precision)
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        write_sintel_sequences(os.path.join(tmp, "Sintel"))
        _, paths["evaluate raft_nc_dbl sintel_warm"] = check_eval_warm(
            torch, card, os.path.join(tmp, "Sintel"))
        for precision in ("f32", "bf16_infer"):
            profile = profile_forward(torch, eval_model(torch, precision), card, replay=True)
            check(profile["device_ms"] is not None, "the replay's trace holds no device time")
            torch.cuda.empty_cache()
        check_entries(torch, card, tmp)
    # The stages, early exit and streaming: the flagship's stage composition
    # against its forward, the serve entry with early exit off and on, and
    # its --stream branch in f32, under bf16_infer, under chaos and with
    # carry_net.
    paths["stages raft_nc_dbl"] = check_stages(torch, card)
    paths["early exit served"] = check_early_exit(torch, card)
    paths["stream raft_nc_dbl"] = check_stream(torch, card)
    paths["stream raft_nc_dbl bf16_infer"] = check_stream(torch, card, "bf16_infer")
    paths["stream chaos"] = check_stream_chaos(torch, card)
    paths["stream carry_net"] = check_stream(torch, card, carry_net=True)
    # Telemetry: the serve entry with every output on (plain and --stream
    # branches, under chaos), no synchronisation, its overhead and the cost
    # ledger's MFU.
    with tempfile.TemporaryDirectory() as tmp:
        paths.update(check_telemetry(torch, card, tmp))
    train_bf16 = check_train(torch, card, steps=VARIANT_TRAIN_STEPS, extras=False,
                             precision="bf16_train", profile=True)
    paths["train raft_nc_dbl bf16_train"] = train_bf16["launches"]
    train = check_train(torch, card)
    check(all(p["device_ms"] > 0 for p in train["profile"]["phases"].values()),
          "a phase of the train trace holds no device time")
    paths["train raft_nc_dbl"] = train["launches"]
    check_train_vs_plain(torch)
    for variant, small in TRAINED_MODELS:
        label = model_label(variant, small)
        paths[f"train {label}"] = check_train(
            torch, card, variant, small, steps=VARIANT_TRAIN_STEPS, extras=False)["launches"]
        check_train_vs_plain(torch, variant, small)
    # The flagship trained from files through the train entry (loader,
    # augmentation, device prefetch, validation, checkpoints, chaos).
    with tempfile.TemporaryDirectory() as tmp:
        paths.update(check_train_files(torch, card, tmp,
                                       train[f"median_ms_steps_2_to_{TRAIN_STEPS}"]))
        paths["telemetry profile_steps"] = check_profile_steps(
            torch, card, tmp, os.path.join(tmp, "Sintel"))
    # Pipelined serving and streaming against the waiting server and engine,
    # each under the runtime guards, and the train entry's --strict_guards.
    for phase in (check_pipelined_serve, check_pipelined_stream):
        paths.update(phase(torch, card)[1])
    with tempfile.TemporaryDirectory() as tmp:
        paths["train strict_guards"] = check_strict_guards(torch, card, tmp)
    # Fleet replicas: two flagship replica processes of the serve entry on
    # the card behind the router, under chaos; each replica's launches come
    # from its own report.
    with tempfile.TemporaryDirectory() as tmp:
        paths.update(check_fleet(torch, card, tmp)[1])

    # One CUDA kernel replaces both TPU tiers, so both corr rows give its
    # main-path count as `launches`; `check_launches` is the row's own check.
    # `launches` is the serve run's count for the forward kernels and the
    # train run's for the backward kernels; `train_launches` the train run's
    # for all four.
    tl = train["launches"]
    small_served = paths["serve raft small"]["corr_lookup"]
    small_trained = paths["train raft small"]["corr_lookup_bwd"]

    def by_path(kernel):
        return {"launches_by_path": {p: l[kernel] for p, l in paths.items() if l[kernel]}}

    corr_src = "raft_ncup_tpu_torch/csrc/corr_lookup.cu"
    # The launches of this slice's paths beside the served ones.
    new_paths = {k: {"stream_launches": paths["stream raft_nc_dbl"][k],
                     "early_exit_launches": paths["early exit served"][k]}
                 for k in ("corr_lookup", "nconv")}
    kernels = [
        dict(name="corr_lookup at the served shape (the TPU's resident tier)", route="cuda",
             source=corr_src, replaces="raft_ncup_tpu/ops/corr_pallas.py:422",
             launches=launches["corr_lookup"], train_launches=tl["corr_lookup"],
             **new_paths["corr_lookup"],
             **_kernel_numbers(corr_served), **by_path("corr_lookup")),
        dict(name="corr_lookup at 1088x1920 (the TPU's banded tier; launches are the "
             "main-path count of the same kernel)", route="cuda",
             source=corr_src, replaces="raft_ncup_tpu/ops/corr_pallas.py:672",
             launches=launches["corr_lookup"], train_launches=tl["corr_lookup"],
             **_kernel_numbers(corr_banded), **by_path("corr_lookup")),
        dict(name="corr_lookup at the served shape with smooth flow (the same kernel)",
             route="cuda", source=corr_src,
             replaces="raft_ncup_tpu/ops/corr_pallas.py:422",
             launches=launches["corr_lookup"], train_launches=tl["corr_lookup"],
             **_kernel_numbers(corr_smooth), **by_path("corr_lookup")),
        dict(name="corr_lookup at 2176x3840 (the TPU's banded tier; the same kernel)",
             route="cuda", source=corr_src,
             replaces="raft_ncup_tpu/ops/corr_pallas.py:672",
             launches=launches["corr_lookup"], train_launches=tl["corr_lookup"],
             **_kernel_numbers(corr_4k), **by_path("corr_lookup")),
        dict(name="nconv2d_fused (4 NCUP layers of one served batch of 2)", route="cuda",
             source="raft_ncup_tpu_torch/csrc/nconv.cu",
             replaces="raft_ncup_tpu/ops/nconv_pallas.py:125",
             launches=launches["nconv"], train_launches=tl["nconv"],
             **new_paths["nconv"],
             **_summed_numbers(nconv_rows), **by_path("nconv")),
    ]
    # The bf16 rows at the flagship's shapes give the flagship's bf16_infer
    # serve and bf16_train runs; those at the small model's shape the small
    # raft's bf16_infer serve (no phase trains it under bf16).
    bf16_flagship = dict(
        launches=paths["serve raft_nc_dbl bf16_infer"]["corr_lookup"],
        train_launches=train_bf16["launches"]["corr_lookup"])
    bf16_small = dict(launches=paths["serve raft small bf16_infer"]["corr_lookup"])
    bf16_tiers = [(":422", bf16_flagship, "the flagship's bf16_infer serve's")] * 2 + [
        (":672", bf16_flagship, "the flagship's bf16_infer serve's")] + [
        (":422", bf16_small, "the small raft's bf16_infer serve's")] * 2
    for row, (tier, counts, whose) in zip(corr_bf16, bf16_tiers):
        kernels.append(dict(
            name=f"corr_lookup on bf16 features, {row['shape']} (the same kernel, its "
                 f"corr_lookup_bf16 entry; launches are {whose})",
            route="cuda", source=corr_src, replaces=f"raft_ncup_tpu/ops/corr_pallas.py{tier}",
            **counts, f32_kernel_ms_same_values=row["f32_kernel_ms_same_values"],
            **_kernel_numbers(row), **by_path("corr_lookup")))
    for row in corr_small:
        kernels.append(dict(
            name=f"corr_lookup at the small model's served shape (C=128, r=3), "
                 f"{row['shape'].split()[-2]} flow (the same kernel; launches are the small "
                 "raft serve's)", route="cuda", source=corr_src,
            replaces="raft_ncup_tpu/ops/corr_pallas.py:422", launches=small_served,
            **_kernel_numbers(row), **by_path("corr_lookup")))
    bwd_rows = [(row, "the training shape", tl["corr_lookup_bwd"], TRAIN_STEPS)
                for row in corr_bwd]
    bwd_rows += [(row, "the small model's training shape (C=128, r=3)", small_trained,
                  VARIANT_TRAIN_STEPS) for row in corr_bwd_small]
    for row, shape, n, steps in bwd_rows:
        kernels.append(dict(
            name=f"corr_lookup_bwd at {shape}, {row['shape'].split()[-2]} flow "
                 "(no TPU kernel: JAX differentiates the XLA path)",
            route="cuda", source="raft_ncup_tpu_torch/csrc/corr_lookup_bwd.cu",
            replaces="raft_ncup_tpu/ops/corr_pallas.py:816",
            launches=n, train_launches=n, launches_per_step=n / steps,
            **by_path("corr_lookup_bwd"),
            max_abs_err=row["max_abs_err"], max_rel_err=row["max_rel_err"],
            ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=None,
            ms_without_d_f2=row["ms_without_d_f2"], counts=row["counts"],
            atomics=row["atomics"], atomics_issued=row["atomics_issued"]))
    kernels.append(dict(
        name="nconv2d backward (4 NCUP layers of a training batch, 12 planes of 400x720; "
             "no TPU kernel: JAX differentiates the XLA path)",
        route="cuda", source="raft_ncup_tpu_torch/csrc/nconv_bwd.cu",
        replaces="raft_ncup_tpu/ops/nconv_pallas.py:179",
        launches=tl["nconv_bwd"], train_launches=tl["nconv_bwd"],
        launches_per_step=train["launches_per_step"]["nconv_bwd"],
        max_rel_err=max(r["max_rel_err"] for r in nconv_bwd_rows),
        layer_ms={r["layer"]: r["ms"] for r in nconv_bwd_rows},
        **_summed_numbers(nconv_bwd_rows), **by_path("nconv_bwd")))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _summed_numbers(rows: list) -> dict:
    """A kernel's numbers over its layer rows: times and bounds summed."""
    return dict(
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=sum(r["ms"] for r in rows), plain_ms=sum(r["plain_ms"] for r in rows),
        bound_ms=sum(r["bound_ms"] for r in rows),
        bound_by="bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations",
        library_ms=None)


def _kernel_numbers(row: dict) -> dict:
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "check_launches",
            "path_tiles")
    return {**{k: row[k] for k in keys}, "library_ms": None}


if __name__ == "__main__":
    adopt_orphans()
    try:
        code = main()
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        code = 1
    finally:
        for pid, cmd in stop_leftovers().items():
            print(f"chip_smoke: stopped a leftover process {pid}: {cmd}", file=sys.stderr)
    sys.exit(code)
