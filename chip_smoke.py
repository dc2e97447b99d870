#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of the repository: ``python3 chip_smoke.py``. It

1. prints the card's name and power limit (under f32 the model's
   forward, the train step and the plain versions keep TF32 off
   themselves);
2. builds the four hand-written kernels from ``raft_ncup_tpu_torch/csrc``,
   all ``nvcc`` processes at once, and beside them the host WebP and JPEG
   decoders (``csrc/*.cpp``, the system C++ compiler); decodes every
   committed fixture of ``tests/data/codecs`` and holds its RGB bytes'
   sha256 against the manifest's digest of Pillow's decode, and times the
   decode of the committed 540x960 lossy WebP frames with 1 and 4 host
   threads (its ``codecs:`` line); beside the build, on the host, it runs
   the port's static lint (``python -m raft_ncup_tpu_torch.analysis
   --strict-allowlist raft_ncup_tpu_torch/ chip_*.py``) in a process of its
   own and prints ``lint: files N findings 0 allowlisted K cpu_s X``; a
   finding, a stale allowlist entry or a parse error fails the run;
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
    frames, each in its own process, both at once;
12. trains the flagship from files in-process through the train entry
    (``train.main``) with ``scripts/train_raft_nc_things.sh``'s flag lines
    (minus ``--compressed_ft`` in (a)-(e)): a FlyingThings3D-layout tree at
    540x960 (PNG frames warped by their PFM flows, both directions, clean and
    final), read and augmented by the loader's threads and copied ahead by
    the device prefetcher, validated on a Sintel-layout tree, warm-started
    from a ``raft`` .pth written by ``save_reference_pth``: (a) f32, 8 steps
    validating every 4; (b) ``sigterm@3`` (exit 75) and a resume to step 8
    (its batch stream equal to (a)'s by hash, its restored state equal to
    ``step_3.pt``, its losses within ``RESUME_LOSS_RTOL`` of (a)'s); (c)
    ``nan@5,nan@6,nan@7`` with ``--sentinel_halt_after 3`` (exit 76, the
    live parameters equal to ``step_4.pt``); (d) ``bf16_train``, 5 steps;
    (e) ``--freeze_raft --add_noise --dropout 0.1``, 2 steps (the trunk
    unchanged); (f) the flag lines whole, ``--compressed_ft`` included, 3
    steps on WebP frames (the committed 540x960 frames, decoded by the
    port's C++ decoder) and npz flows, against a twin run without the flag
    on the same pixels as PNG and flows as PFM (batches equal by hash,
    losses within 1e-6 relative, the loader's host ms per sample of
    each). Every step launches A 24, A' 12, B 96 and B' 48 times, every
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
    identity in healthz; a burst of 8 pairs and 2 streams of 2 frames,
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
17. trains and validates the flagship data-parallel (``parallel/``) at
    ``scripts/train_raft_nc_things.sh``'s configuration on a
    FlyingThings3D-layout tree (global batch 6 at 400x720, 12 iterations,
    f32): (a) one process, 2 steps; (b) two ranks on the one card under
    gloo started by ``torch.distributed.run``, batch 3 each: losses,
    step-1 reduced gradients, the ranks' batches (together the one-process
    batch of each step, by hash) and each rank's launches (A 24, A' 12,
    B 96, B' 48 a step) against (a), with per-rank step ms and the
    all-reduce's ms and bytes a step (two ranks time-slice one card: not
    scaling); (c) ``sigterm@2`` to rank 1 only: both ranks exit 75 at step
    2, rank 0 wrote the one checkpoint, and a two-rank resume reads the
    uninterrupted batches; (d) a one-rank NCCL world under
    ``--strict_guards``, and two NCCL ranks on the one card, which raise
    before step 1 ((c) and (d) at a 200x360 crop); (e) ``validate_sintel``
    through the evaluate entry with two ranks against one process; (b)'s
    ranks and the spatial training phase's run beside (c)-(e), and (c)
    beside (d) and (e), so their step times are under that load;
17a. trains over the spatial axis (``spatial (f)``): the flagship's step
    at 400x720, batch 2, 12 iterations, remat, 2 steps, split by rows over
    two ranks sharing the card under gloo (``--mesh 1,2``, each rank this
    script's ``--spatial_train_worker``), at stage chairs (BatchNorm trains)
    and stage things (frozen), against one process: the losses, the step-1
    gradients, the batches by hash, each rank's launches (A 24, A' 12, B 96,
    B' 48 a step) and collectives (equal on both ranks, with bytes), each
    rank's step ms and peak bytes; and each encoder on two bands in float64
    against the whole image (exact) beside its float32 error;
17b. runs the PAC and DJIF heads (``pac``): the flagship with each
    (``UpsamplerConfig(kind=...)``) served through the serve entry's
    ``serve_pairs`` (4 requests at 436x1024, batch sizes 1 and 2, level
    12, graph replays: A 12 a batch and no B; every answer finite, one
    against the plain-version forward at the flagship tolerances) and
    trained 2 steps at 400x720, batch 2, 12 iterations, remat on, in a
    process of its own (``--pac_train_worker``) started beside phase 12
    (finite losses, A 24 and A' 12 a step, no B or B', ms a step, peak
    bytes);
17c. pipelines the flagship's test-mode forward over the pipe axis
    (``pipe (g)``, ``inference/pipe_schedule.py``): two ranks sharing the
    card under gloo (``--mesh 1,1,2``, each this script's
    ``--pipe_worker``, started beside phase 12), f32 at 440x1024, 12
    iterations, 6 micro-batches of batch 1, two streams: every rank's
    flows against this process's one-process forward at the flagship
    tolerances; each rank's launches of the second stream by the schedule
    (A 6 a micro-batch on both, B 4 a micro-batch on rank 1); rank 0's
    hand-offs (one ``collective-permute`` of 21,683,200 B a micro-batch),
    one output broadcast a micro-batch on both; the second stream under the
    runtime guards with no capture, no implicit read and the same receive
    buffers;
18. runs the spatial axis (``parallel/halo.py``): (a) the flagship's whole
    f32 forward, batch 1, 32 iterations, at 1088x1920 and at 2176x3840 in
    this process, captured and replayed 3 times (wall and device ms, the
    graph pool's and the peak bytes, A 32 and B 4 a forward), the
    1088x1920 one held against the plain versions at 4 iterations; (b) the
    1088x1920 forward split by image rows over two ranks sharing the card
    under gloo (``python -m raft_ncup_tpu_torch.highres_forward --spatial
    2``): each rank's flows against (a)'s at the flagship's tolerances,
    its launches (A 32, B 4), halo exchanges, gathers and their bytes, its
    peak bytes (time-sliced: not scaling); (c) ``validate_sintel`` through
    the evaluate entry with ``--mesh 1,2`` against one process, on a
    Sintel-layout tree at 432x1024 (no padding under either divisor);
19. serves over the mesh (1, 2) (``parallel/lockstep.py``), all started at
    once: (d) the serve entry ``--mesh 1,2`` as two ranks sharing the card
    under gloo (each rank this script's ``--serve_worker``, the entry's
    ``run``), the flagship f32 at 436x1024 (448 rows under the mesh),
    batch sizes 1 and 2, level 12: 4 requests, the ``--stream`` branch's 2
    streams of 2 frames, and 4 requests with early exit on at a tolerance
    between the pairs' first-iteration norms; every answer ok and within
    ``FLEET_TOL`` of this process's one-process server or engine on the
    same pairs and weights (padded with a bucket of 16 to the same rows),
    each rank's mesh, collectives and launches (A 12 and B 4 a batch), and
    under early exit both ranks' forwards, segments and flag reads equal;
    (e) a fleet of one (1, 2) slot behind the router: READY with the mesh
    in healthz, 4 pairs against the same answers, ``stop()`` with both
    ranks exiting 75, each rank's launches, and no ``--replica_socket``
    process left;
19b. serves over a pipe axis beside a data or spatial axis (``mixed
    (h)``, item 9b-v): one world of four gloo ranks sharing the card (each
    this script's ``--mixed_worker``, started beside phase 12) runs the
    serve entry three times: the flagship f32 at 436x1024 (448 rows, a pad
    bucket of 16), batch size 2, levels 12 and 6, a burst of 8 requests,
    over ``--mesh 1,2,2`` and then ``--mesh 2,1,2``, and 2 streams of 2
    frames over ``--mesh 2,1,2``. Every rank records each forward it ran;
    every pipe index's answers (cut from its forwards as the leader's
    are) within the flagship's flow_up tolerance of this process's
    one-process server at the level each request got, the stream's
    answers against the one-process engine's, the largest difference
    between the pipe indices of a place printed; each rank's mesh,
    lockstep operations, collectives and launches (B 4 a batch, A the
    batch's level; the same on all four ranks);
19c. runs the PAC and DJIF heads and the bf16 preset on a band of rows
    (``pac (i)``, item 9b-vi): one world of two gloo ranks sharing the card
    (each this script's ``--pac_mesh_worker``, started beside phase 12)
    runs the serve entry over ``--mesh 1,2`` with ``--final_upsampling
    PacJointUpsampleFull``, with ``DjifOriginal`` and with the flagship
    under ``--serve_precision bf16_infer`` (436x1024, 448 rows, batch size
    2, level 4, a burst of 4), every rank's answers (cut from its own
    forwards) within 1e-4 of this process's one-process server (the bf16
    run's within ``FORWARD_EPE_BUDGET`` in mean EPE), A 4 a batch on every
    rank (B 4 under NCUP, none with a head); then, once the PAC train worker
    has written its record, two PAC train steps over the mesh at 400x720,
    batch 2, 12 iterations, remat on:
    the losses within ``SPATIAL_TRAIN_LOSS_RTOL`` of the PAC phase's one
    process, A 24 and A' 12 a step, no B or B', no plain version called,
    each rank's peak bytes beside one process's;
20. prints each phase's seconds (``phase NAME: S s``, then a ``phases:``
    line), one JSON line describing the kernels (with each kernel's
    launches per rank on the data-parallel, spatial, spatial serving,
    spatial training, pipe, mixed-mesh and PAC-on-bands paths and on the
    PAC and DJIF runs), the card's name and power limit, and, last, the
    JSON result line.

Any failed check exits non-zero before the last line. With no CUDA
device it exits non-zero at once; it never falls back to the CPU.

Every process it starts ends before it does: it adopts its orphaned
descendants (Linux's child subreaper), and on the way out stops and reaps
any that is still there, naming each on standard error; the fleet phase
also checks that no replica process outlives its supervisor's ``stop``.
"""

from __future__ import annotations

import contextlib
import glob
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

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
CODEC_FIXTURES = os.path.join(HERE, "tests", "data", "codecs")
CODEC_ROUNDS = 5  # timed decodes of each committed 540x960 frame
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


def start_lint() -> tuple:
    """The port's static lint over this checkout (the package and the root
    ``chip_*.py``), started in a process of its own on the host; its output
    goes to unnamed files, read by :func:`check_lint`."""
    chips = sorted(os.path.basename(p) for p in glob.glob(os.path.join(HERE, "chip_*.py")))
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "raft_ncup_tpu_torch.analysis", "--strict-allowlist",
         "--format", "json", "raft_ncup_tpu_torch/", *chips],
        cwd=HERE, stdout=out, stderr=err)
    return proc, out, err


def check_lint(lint: tuple) -> dict:
    """Wait for the lint started by :func:`start_lint` and print its line:
    the files it read, its findings (0, or the run fails), the findings the
    allowlist holds, and the CPU seconds of its process (user and system,
    from ``wait4``)."""
    proc, out, err = lint
    _, status, usage = os.wait4(proc.pid, 0)
    proc.returncode = os.waitstatus_to_exitcode(status)
    out.seek(0)
    err.seek(0)
    text, errors = out.read(), err.read()
    check(proc.returncode == 0,
          f"the static lint failed (exit {proc.returncode}):\n{text[-4000:]}\n{errors[-2000:]}")
    doc = json.loads(text)
    row = dict(files=doc["files_checked"],
               findings=sum(not f["suppressed"] for f in doc["findings"]),
               allowlisted=sum(f["suppressed"] for f in doc["findings"]),
               cpu_s=round(usage.ru_utime + usage.ru_stime, 2))
    print("lint: " + " ".join(f"{k} {v}" for k, v in row.items()), flush=True)
    return row


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


def check_codecs(card) -> dict:
    """The host image decoders (``csrc/webp_decode.cpp``,
    ``csrc/jpeg_decode.cpp``): every committed fixture of
    ``tests/data/codecs`` decoded through ``read_image``, its RGB bytes'
    sha256 against the manifest's digest of Pillow's decode, and every
    fixture of a form Pillow refuses raising ``ValueError``; then the
    decode ms per 540x960 lossy frame with 1 thread (each call timed) and
    with 4 threads (wall over frames: throughput), on the host."""
    import concurrent.futures
    import hashlib

    import numpy as np
    from raft_ncup_tpu_torch.io import flow_io
    from raft_ncup_tpu_torch.io.codecs import decode_webp

    manifest = json.load(open(os.path.join(CODEC_FIXTURES, "manifest.json")))
    bad = []
    for name, entry in sorted(manifest["files"].items()):
        img = flow_io.read_image(os.path.join(CODEC_FIXTURES, name))
        digest = hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()
        if digest != entry["sha256_rgb"] or list(img.shape) != entry["shape"]:
            bad.append(name)
    check(not bad, f"codecs: decodes differ from Pillow's (manifest digests): {bad}")
    for name in sorted(manifest["refused_by_pillow"]):
        try:
            flow_io.read_image(os.path.join(CODEC_FIXTURES, name))
            bad.append(name)
        except ValueError:
            pass
    check(not bad, f"codecs: forms Pillow refuses decoded: {bad}")
    frames = [open(os.path.join(CODEC_FIXTURES, f"frame_540x960_{i}.webp"), "rb").read()
              for i in range(4)]
    for data in frames:
        decode_webp(data)  # warm
    one = []
    for _ in range(CODEC_ROUNDS):
        for data in frames:
            t0 = time.perf_counter()
            decode_webp(data)
            one.append(1e3 * (time.perf_counter() - t0))
    work = frames * CODEC_ROUNDS
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        t0 = time.perf_counter()
        list(pool.map(decode_webp, work))
        wall4 = time.perf_counter() - t0
    row = {"card": card, "fixtures": len(manifest["files"]), "digests_equal": True,
           "refused_raise": len(manifest["refused_by_pillow"]),
           "pillow_versions": manifest["versions"],
           "frame_bytes": [len(d) for d in frames],
           "webp_540x960_ms_1_thread_median": statistics.median(one),
           "webp_540x960_ms_1_thread_min": min(one),
           "webp_540x960_ms_per_frame_4_threads": 1e3 * wall4 / len(work),
           "decodes_timed": len(one), "cpu_count": os.cpu_count()}
    print(f"codecs: {json.dumps(row)}", flush=True)
    return row


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


def write_sintel_sequences(root: str, seed: int = 0, size=SERVE_SIZE) -> None:
    """A Sintel-layout training split (clean and final) of
    ``EVAL_SEQUENCES`` scenes of ``EVAL_FRAMES`` frames at ``size`` (the
    Sintel size by default), written with the port's codecs: each scene a
    smooth random image shifted by a whole number of pixels per frame, its
    flow that shift."""
    import numpy as np
    from raft_ncup_tpu_torch.io import write_flo, write_png

    rng = np.random.default_rng(seed)
    h, w = size
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


def _start_entry(args: list) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", *args], cwd=HERE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait_entry(proc: subprocess.Popen, what: str) -> str:
    try:
        out, err = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"{what} exited {proc.returncode}:\n{out[-3000:]}\n"
                                f"{err[-3000:]}")
    return out


def check_entries(torch, card, tmp: str) -> dict:
    """The evaluate and demo entries in their own processes on the card.
    A flagship's weights written by ``save_reference_pth`` go through
    ``python -m raft_ncup_tpu_torch.evaluate --dataset synthetic`` (12
    iterations, batch 4, 32 pairs at 96x128: the validator's defaults),
    whose results must equal the same validator run here within
    ``ACC_RTOL``; the demo runs at the same time on PNG frames the port's
    codec wrote, and its PNGs are read back."""
    import numpy as np
    from raft_ncup_tpu_torch import evaluation
    from raft_ncup_tpu_torch.io import read_png, write_png
    from raft_ncup_tpu_torch.training.checkpoint import save_reference_pth

    # The evaluate entry builds the model for its --dataset (no BatchNorm
    # in NCUP's weights net outside Sintel), the demo for Sintel.
    model = eval_model(torch, dataset="synthetic")
    pth = save_reference_pth(model, os.path.join(tmp, "synthetic.pth"))
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
    # Both entries start up at once, beside this process's own validation.
    evaluate = _start_entry(["raft_ncup_tpu_torch.evaluate", "--model", "raft_nc_dbl",
                             "--dataset", "synthetic", "--restore_ckpt", pth])
    demo = _start_entry(["raft_ncup_tpu_torch.demo", "--model", "raft_nc_dbl", "--path",
                         frames, "--output", demo_out, "--restore_ckpt", pth_sintel,
                         "--iters", "12"])
    want = evaluation.validate_synthetic(model)
    got = json.loads(_wait_entry(evaluate, "the evaluate entry").strip().splitlines()[-1])
    err = _close(got["results"], want, ACC_RTOL)
    check(err <= ACC_RTOL and got["cache"]["compiles"] == 1 and got["device"].startswith("cuda"),
          f"the evaluate entry gave {got}, want {want}")
    del model
    _wait_entry(demo, "the demo entry")
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


COMPRESSED_FRAMES = 4  # frames a sequence in run (f)'s trees
COMPRESSED_STEPS = 3
COMPRESSED_LOSS_RTOL = 1e-6


def write_compressed_things_tree(root: str, seed: int = 1) -> None:
    """FlyingThings3D's compressed layout (``--compressed_ft``) beside its
    PNG/PFM twin, in one tree: ``frames_{clean,final}pass_webp`` hold the
    committed 540x960 WebP frames (``tests/data/codecs/frame_540x960_*``,
    reused across sequences and passes), ``frames_{clean,final}pass`` the
    same pixels as PNG (decoded by the port's WebP decoder), and
    ``optical_flow`` each flow twice, as ``.npz`` (key ``optical_flow``,
    (2, H, W) float32, written with numpy) and as ``.pfm``. The frames do
    not follow the flows."""
    import shutil

    import numpy as np
    from raft_ncup_tpu_torch.io import write_pfm, write_png
    from raft_ncup_tpu_torch.io.codecs import decode_webp

    g = np.random.default_rng(seed)
    h, w = THINGS_SIZE
    webps = [os.path.join(CODEC_FIXTURES, f"frame_540x960_{i}.webp") for i in range(4)]
    pngs = []
    for i, path in enumerate(webps):
        pngs.append(os.path.join(root, f"decoded_{i}.png"))
        os.makedirs(root, exist_ok=True)
        write_png(pngs[-1], decode_webp(open(path, "rb").read(), path))
    for s in range(THINGS_SEQUENCES):
        seq = os.path.join("TRAIN", "A", f"{s:04d}")
        for dstype in ("frames_cleanpass", "frames_finalpass"):
            for form, files, ext in (("_webp", webps, "webp"), ("", pngs, "png")):
                d = os.path.join(root, dstype + form, seq, "left")
                os.makedirs(d, exist_ok=True)
                for i in range(COMPRESSED_FRAMES):
                    k = (i + s + (dstype == "frames_finalpass")) % len(files)
                    shutil.copyfile(files[k], os.path.join(d, f"{6 + i:04d}.{ext}"))
        for direction in ("into_future", "into_past"):
            d = os.path.join(root, "optical_flow", seq, direction, "left")
            os.makedirs(d, exist_ok=True)
            for i in range(COMPRESSED_FRAMES):
                flow = g.normal(0, 6, (2, h, w)).astype(np.float32)
                name = f"OpticalFlowInto_{6 + i:04d}_L"
                np.savez(os.path.join(d, name + ".npz"), optical_flow=flow)
                f3 = np.zeros((h, w, 3), np.float32)
                f3[..., :2] = flow.transpose(1, 2, 0)
                write_pfm(os.path.join(d, name + ".pfm"), f3)


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
    loss, peak memory, kernel launches and (with ``paths``) the lookup's
    tile paths, and the train state the entry builds. The tile counters
    are read from the card by plain reads, so a run under
    ``--strict_guards`` leaves them out."""

    def __init__(self, torch, paths: bool = True):
        self.torch = torch
        self.paths = paths
        self.host, self.card, self.steps, self.states = [], [], [], []
        self.restored = None
        self._t_iter = None

    def install(self, stack):
        import collections

        from raft_ncup_tpu_torch import train as train_mod
        from raft_ncup_tpu_torch.analysis.guards import host_read
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
                # The sanctioned read, so the digest holds under --strict_guards.
                inst.card.append(_digest(host_read(dict(batch))))
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
                loss, bad = (float(v) for v in host_read([metrics["loss"], metrics["bad_step"]]))
                inst.steps.append(dict(
                    step=state.step, ms=1e3 * (t1 - t0),
                    # From the call for its batch to the end of the step.
                    iteration_ms=1e3 * (t1 - inst._t_iter),
                    loss=loss, bad=bad,
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                    launches={k: after[k] - before[k] for k in after},
                    path_tiles=corr_cuda.path_tiles() if inst.paths else None,
                    bwd_counts=corr_cuda.backward_counts() if inst.paths else None))
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
    ``scripts/train_raft_nc_things.sh``'s flag lines (minus ``--compressed_ft``
    in (a)-(e)):
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
    unchanged bit for bit, A' launched; (f) the flag lines whole,
    ``--compressed_ft`` included, 3 steps on WebP frames and npz flows
    (``write_compressed_things_tree``) against a twin run without the flag
    on the same pixels as PNG and flows as PFM: batches equal by hash,
    losses within ``COMPRESSED_LOSS_RTOL``, the loader's host ms per sample
    of each. Every step launches A 24, A' 12, B 96 and B' 48 times; every
    prefetched batch equals its host batch."""
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

    def run(label, ckdir, steps, *extra, status=0, flags=None):
        argv = (base if flags is None else flags) + [
            "--checkpoint_dir", os.path.join(tmp, ckdir), "--num_steps", str(steps), *extra]
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
    # (f) the script's flag lines whole, --compressed_ft included: WebP
    # frames and npz flows, against a twin run on the same pixels and flows
    # as PNG and PFM.
    t_tree = time.perf_counter()
    compressed = os.path.join(tmp, "FlyingThings3D_compressed")
    write_compressed_things_tree(compressed)
    t_tree = time.perf_counter() - t_tree
    whole = script_flags("train_raft_nc_things.sh")
    check("--compressed_ft" in whole, "the things script no longer passes --compressed_ft")
    whole[whole.index("--load_pretrained") + 1] = pth
    whole += ["--root_things", compressed, "--root_sintel", sintel]
    twin_flags = [t for t in whole if t != "--compressed_ft"]
    f, inst_f, paths["f"] = run("(f) --compressed_ft", "f", COMPRESSED_STEPS, flags=whole)
    twin, inst_twin, _ = run("(f) PNG twin", "f_twin", COMPRESSED_STEPS, flags=twin_flags)
    check(len(inst_f.host) == COMPRESSED_STEPS and inst_f.host == inst_twin.host,
          "(f): the WebP run's batches differ from the PNG twin's")
    rel = max(abs(x - y) / abs(y) for x, y in zip(f["losses"], twin["losses"]))
    check(all(math.isfinite(x) for x in f["losses"]) and rel <= COMPRESSED_LOSS_RTOL,
          f"(f): losses {f['losses']} against the twin's {twin['losses']}")
    inst_f.states.clear()
    inst_twin.states.clear()
    report["f"] = {
        "webp": f, "png_twin": twin, "batch_hashes_equal": True,
        "loss_max_rel_diff_vs_twin": rel, "tree_seconds": t_tree,
        "loader_host_ms_per_sample_webp": f["loader_host_ms_per_sample"],
        "loader_host_ms_per_sample_png": twin["loader_host_ms_per_sample"]}
    torch.cuda.empty_cache()
    for part in ("webp", "png_twin"):
        print(f"train from files (f) {part}: {json.dumps(report['f'].pop(part))}", flush=True)
    print(f"train from files (f): {json.dumps(report['f'])}", flush=True)
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

FLEET_PAIRS = 8  # the paused burst through the router
FLEET_STREAMS, FLEET_FRAMES = 2, 2
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


# ---------------------------------------------------------- data parallel

# The data-parallel phase: the flagship at train_raft_nc_things.sh's
# configuration (stage things, a global batch of 6 at 400x720, 12
# iterations, f32) on the FlyingThings3D-layout tree, one process against
# ranks that share the one card. NCCL refuses two ranks on one card, so the
# two-rank worlds run under gloo (RAFT_TORCH_DIST_BACKEND) and a one-rank
# world checks NCCL. Two ranks on one card time-slice it: their step times
# measure the collectives' cost and the sharing, not scaling.
DP_WORKER = "--dp_worker"
DP_CARD = ["--device", "cuda:0"]  # every rank's card: the one card
# Cut from 3, 5 and 3 to keep the whole script inside its time with the
# spatial phase: fewer steps, the same checks.
DP_STEPS = 2
DP_RESUME_STEPS = 3  # (c): preempted after 2 steps, resumed to 3
DP_SIGTERM_STEP = 2
# (c) and (d) train at a smaller crop of the same tree, so that each of
# their rank processes' first step (cuDNN's autotuning) costs less; the
# model keeps its width. (d) ran at 400x720 before the spatial phase came.
DP_SMALL = ["--image_size", "200", "360"]
# A rank worker's flag before the train flags: the steps between the
# ranks' agreements on a SIGTERM (16 in the program), 1 in (c) for an
# exact stop step.
DP_CHECK_EVERY = "--preempt_check_every"
DP_UNTIMED = "--untimed"
DP_COLLECTIVE_TIMEOUT_S = 300.0  # a rank's collectives, inside DP_TIMEOUT_S
DP_TIMEOUT_S = 600
# Two ranks against one process: the first step's loss within
# DP_FIRST_LOSS_RTOL (the same batch in halves of 3: cuDNN may take other
# algorithms at batch 3, in another process), later steps within
# DP_LOSS_RTOL (AdamW's first steps move each parameter by about the
# learning rate in its gradient's sign, and a gradient near zero may take
# either sign); step-1 gradients within STEP_GRAD_TOL of each tensor's
# largest value, ROADMAP.md queue 3 entries 1-2 within
# tests/test_torch_train.py's bounds (DP_FLIPPED, DP_NCUP).
DP_FIRST_LOSS_RTOL = 1e-4
DP_LOSS_RTOL = 1e-3
DP_FLIPPED = ("fnet.conv1.weight", "fnet.layer1.0.conv1.weight")
DP_FLIP_TOL = 1e-1
DP_NCUP = "upsampler.interpolation_net."
DP_NCUP_TOL = 5e-2
DP_VAL_RTOL = 1e-6
DP_WANT = {"corr_lookup": 24, "corr_lookup_bwd": 12, "nconv": 96, "nconv_bwd": 48}


def _dp_capture(torch, stack, outdir: str, rank: int, timed: bool = True) -> dict:
    """Hooks of a data-parallel run: the first step's (reduced) gradients
    saved under ``outdir``, every all-reduce's ms (synchronised around it,
    with ``timed``) and bytes by step, and this process's checkpoint
    writes."""
    from raft_ncup_tpu_torch.analysis.guards import host_read
    from raft_ncup_tpu_torch.parallel import multihost
    from raft_ncup_tpu_torch.training import checkpoint as ckpt_mod
    from raft_ncup_tpu_torch.training import step as step_mod

    rec = {"collectives": [], "checkpoint_writes": 0, "grads": None}
    real_ar, real_apply, real_save = multihost.all_reduce_, step_mod.apply_update, ckpt_mod.save

    def timed_ar(t, op="sum", group=None):
        if t.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_ar(t, op, group=group)
        if t.is_cuda:
            torch.cuda.synchronize()
        rec["collectives"].append(dict(ms=1e3 * (time.perf_counter() - t0),
                                       bytes=t.numel() * t.element_size(),
                                       step=rec.get("step", 0)))
        return out

    def apply(state, loss, grads, bn_old, cfg):
        if rec["grads"] is None:
            rec["grads"] = os.path.join(outdir, f"grads_rank{rank}.pt")
            names = [n for n, _ in state.named_params]
            # The sanctioned read, so the capture holds under --strict_guards.
            host = host_read(dict(zip(names, grads)))
            torch.save({n: torch.from_numpy(v) for n, v in host.items()}, rec["grads"])
        rec["step"] = rec.get("step", 0) + 1
        return real_apply(state, loss, grads, bn_old, cfg)

    def save(*a, **kw):
        rec["checkpoint_writes"] += 1
        return real_save(*a, **kw)

    hooks = [(step_mod, "apply_update", apply), (ckpt_mod, "save", save)]
    if timed:
        hooks.append((multihost, "all_reduce_", timed_ar))
    for mod, name, fn in hooks:
        stack.callback(setattr, mod, name, getattr(mod, name))
        setattr(mod, name, fn)
    return rec


def _dp_run(torch, outdir: str, argv: list, timed: bool = True) -> tuple:
    """The train entry with ``argv`` in this process, instrumented: (exit
    code or None, error, summary, the instruments' record); ``timed`` times
    each all-reduce (a synchronisation around it)."""
    import io

    from raft_ncup_tpu_torch import train as train_mod

    rank = int(os.environ.get("RANK", "0"))
    inst = _Instruments(torch, paths=False)
    out = io.StringIO()
    status = error = summary = None
    reset_launches()
    with contextlib.ExitStack() as stack:
        inst.install(stack)
        rec = _dp_capture(torch, stack, outdir, rank, timed)
        try:
            with contextlib.redirect_stdout(out):
                status = train_mod.main(argv)
            summary = json.loads(out.getvalue().strip().splitlines()[-1])
        except Exception as e:  # recorded for the phase to judge
            error = f"{type(e).__name__}: {e}"
    record = dict(rank=rank, status=status, error=error, summary=summary, host=inst.host,
                  card_equal=inst.host == inst.card, restored=inst.restored,
                  steps=[{k: s[k] for k in ("step", "ms", "loss", "launches", "peak_gib")}
                         for s in inst.steps], **rec)
    return status, error, summary, record


def dp_worker(outdir: str, argv: list) -> int:
    """One rank of a data-parallel run (``chip_smoke.py --dp_worker OUTDIR
    [--preempt_check_every N] [--untimed] <train flags>``, started by the
    phase or by ``chip_spatial.py``): its record as
    ``OUTDIR/rank<RANK>.json``; exits with the train entry's code, 1 when
    it raised. ``--untimed`` leaves the all-reduces unsynchronised."""
    import torch

    sys.path.insert(0, HERE)
    from raft_ncup_tpu_torch.parallel import multihost
    from raft_ncup_tpu_torch.resilience import preemption

    multihost.COLLECTIVE_TIMEOUT_S = DP_COLLECTIVE_TIMEOUT_S
    if argv[:1] == [DP_CHECK_EVERY]:
        preemption.CHECK_EVERY, argv = int(argv[1]), argv[2:]
    timed = argv[:1] != [DP_UNTIMED]
    argv = argv if timed else argv[1:]
    status, error, _, record = _dp_run(torch, outdir, argv, timed)
    with open(os.path.join(outdir, f"rank{record['rank']}.json"), "w") as fh:
        json.dump(record, fh)
    if error:
        print(f"dp_worker rank {record['rank']}: {error}", file=sys.stderr)
    return 1 if status is None else status


def _dp_env(backend: str, world: int, rank=None, port=None, **extra) -> dict:
    env = dict(os.environ, PYTHONPATH=HERE, **extra)
    if backend:
        env["RAFT_TORCH_DIST_BACKEND"] = backend
    else:
        env.pop("RAFT_TORCH_DIST_BACKEND", None)
    if rank is not None:
        env.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    return env


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_ranks(outdir: str, argv: list, world: int, backend: str, torchrun: bool,
              module=None, worker: str = DP_WORKER, **extra) -> tuple:
    """``world`` ranks started at once, by ``torchrun`` or each by hand
    with the launcher's environment (so each rank's exit code shows):
    (exit codes, stdout and stderr of each process, wall seconds). Without
    ``module``, each rank is this script's ``--dp_worker``."""
    t0 = time.perf_counter()
    procs = _start_ranks(outdir, argv, world, backend, torchrun, module, worker, **extra)
    codes, outs = _wait_ranks(procs)
    return codes, outs, time.perf_counter() - t0


def _start_ranks(outdir: str, argv: list, world: int, backend: str, torchrun: bool = False,
                 module=None, worker: str = DP_WORKER, **extra) -> list:
    """The processes of :func:`_dp_ranks`, started and not waited for;
    without ``module`` each rank is this script's ``worker`` mode."""
    os.makedirs(outdir, exist_ok=True)
    port = _free_port()
    target = ["-m", module] if module else [os.path.join(HERE, "chip_smoke.py"), worker,
                                            outdir]
    if torchrun:
        cmds = [([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(world),
                  "--master_addr", "127.0.0.1", "--master_port", str(port), *target, *argv],
                 _dp_env(backend, world, **extra))]
    else:
        cmds = [([sys.executable, *target, *argv], _dp_env(backend, world, r, port, **extra))
                for r in range(world)]
    return [subprocess.Popen(c, cwd=HERE, env=e, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True) for c, e in cmds]


def _wait_ranks(procs: list) -> tuple:
    """Each process's exit code and (stdout, stderr), within ``DP_TIMEOUT_S``
    each; a process still there after it is killed."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DP_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def _dp_records(outdir: str, world: int) -> list:
    recs = []
    for r in range(world):
        path = os.path.join(outdir, f"rank{r}.json")
        check(os.path.exists(path), f"data parallel: rank {r} wrote no record in {outdir}")
        with open(path) as fh:
            recs.append(json.load(fh))
    return recs


def _dp_grad_errs(torch, got: dict, want: dict, default_tol: float = STEP_GRAD_TOL,
                  flipped: tuple = DP_FLIPPED, flip_tol: float = DP_FLIP_TOL,
                  centred: tuple = (), ncup: tuple = (DP_NCUP,),
                  ncup_tol: float = DP_NCUP_TOL) -> tuple:
    """(worst relative error by kind, failures) of step-1 gradients against
    the one-process run's. A conv bias of ``centred`` (a training
    BatchNorm follows it: a gradient of exactly zero) is held by its size
    on both sides against the step's largest gradient instead."""
    gmax = max(float(g.abs().max()) for g in want.values())
    worst = {"default": (0.0, ""), "flipped": (0.0, ""), "ncup": (0.0, "")}
    if centred:
        worst["centred"] = (0.0, "")
    failures = []
    for name, r in want.items():
        g = got[name]
        scale = float(r.abs().max())
        if name.startswith(centred) and name.endswith(".0.bias"):
            size = max(scale, float(g.abs().max())) / gmax
            worst["centred"] = max(worst["centred"], (size, name))
            if size > SPATIAL_TRAIN_CENTRED_TOL:
                failures.append(f"{name}: {size:.3e} of the largest gradient (centred by a "
                                f"training BatchNorm, tolerance {SPATIAL_TRAIN_CENTRED_TOL})")
            continue
        if scale < NEGLIGIBLE * gmax:
            if float(g.abs().max()) >= NEGLIGIBLE * gmax:
                failures.append(f"{name} is not negligible")
            continue
        kind = ("flipped" if name.startswith(flipped) else "ncup" if name.startswith(ncup)
                else "default")
        tol = {"flipped": flip_tol, "ncup": ncup_tol, "default": default_tol}[kind]
        err = float((g - r).abs().max()) / scale
        worst[kind] = max(worst[kind], (err, name))
        if err > tol:
            failures.append(f"{name}: {err:.3e} of its largest value (tolerance {tol})")
    return worst, failures


def _dp_stream(argv: list, steps: int) -> list:
    """The one-process batch stream of ``argv``'s configuration, read by the
    loader as the train entry reads it: each step's global batch (numpy)."""
    from raft_ncup_tpu_torch.cli import parse_train
    from raft_ncup_tpu_torch.data.datasets import fetch_training_set
    from raft_ncup_tpu_torch.data.loader import FlowLoader

    _, _, cfg, data_cfg = parse_train(argv)
    loader = FlowLoader(fetch_training_set(cfg.stage, cfg.image_size, data_cfg),
                        cfg.batch_size, seed=cfg.seed, num_workers=data_cfg.num_workers)
    it = loader.batches()
    try:
        return [{k: v for k, v in next(it).items() if k != "extra_info"} for _ in range(steps)]
    finally:
        it.close()


def _rows_digest(batch: dict, rank: int, world: int) -> str:
    return _digest({k: v[rank::world] for k, v in batch.items()})


def _median(xs: list):
    return statistics.median(xs) if xs else None


def _dp_print(part: str, row: dict) -> None:
    print(f"data parallel ({part}): {json.dumps(row)}", flush=True)


def _dp_launches(rec: dict) -> dict:
    return {k: sum(s["launches"][k] for s in rec["steps"]) for k in DP_WANT}


def _dp_one_process(torch, tmp: str, argv: list, stream: list) -> dict:
    """(a) One process, in this one: its record, step-1 gradients and
    seconds."""
    t0 = time.perf_counter()
    status, error, _, a = _dp_run(torch, os.path.join(tmp, "a"),
                                  argv + ["--checkpoint_dir", os.path.join(tmp, "a"),
                                          *DP_CARD])
    a["seconds"] = time.perf_counter() - t0
    check(status == 0 and error is None, f"data parallel (a): exit {status}, {error}")
    check(a["host"] == [_digest(b) for b in stream[:DP_STEPS]] and a["card_equal"],
          "data parallel (a): the batches are not the one-process stream")
    check(all(s["launches"] == DP_WANT for s in a["steps"]),
          f"data parallel (a): launches {[s['launches'] for s in a['steps']]}")
    a["grad_tensors"] = torch.load(a["grads"], weights_only=True)
    return a


def _dp_start_two_ranks(tmp: str, argv: list) -> tuple:
    """(b)'s two ranks on the one card under gloo, started by torchrun and
    not waited for: (processes, start time)."""
    outdir = os.path.join(tmp, "b")
    return (_start_ranks(outdir, argv + ["--checkpoint_dir", outdir, *DP_CARD], 2, "gloo",
                         torchrun=True), time.perf_counter())


def _dp_two_ranks(torch, card: str, tmp: str, a: dict, want_rows: list, started: tuple) -> dict:
    """(b) Two ranks on the one card under gloo (``started`` by
    :func:`_dp_start_two_ranks`), against (a). Returns each rank's
    launches."""
    outdir = os.path.join(tmp, "b")
    codes, outs = _wait_ranks(started[0])
    seconds = time.perf_counter() - started[1]
    check(codes == [0], f"data parallel (b): torchrun exited {codes}:\n"
                        f"{outs[0][0][-2000:]}\n{outs[0][1][-4000:]}")
    b = _dp_records(outdir, 2)
    grads = [torch.load(r["grads"], weights_only=True) for r in b]
    worst, failures = _dp_grad_errs(torch, grads[0], a["grad_tensors"])
    a_losses = [s["loss"] for s in a["steps"]]
    losses = [s["loss"] for s in b[0]["steps"]]
    loss_rel = [abs(x - y) / abs(y) for x, y in zip(losses, a_losses)]

    def per_step(rec, key):
        return [sum(c[key] for c in rec["collectives"] if c["step"] == s)
                for s in range(len(rec["steps"]))]

    _dp_print("b", {
        "card": card, "seconds": seconds, "one_process_seconds": a["seconds"],
        "losses": losses, "one_process_losses": a_losses, "loss_rel_diff": loss_rel,
        "grad_rel_diff_step1": worst, "launches_per_step": [[s["launches"] for s in r["steps"]]
                                                            for r in b],
        "per_rank": [{"rank": r["rank"], "step_ms": [s["ms"] for s in r["steps"]],
                      "allreduce_ms_per_step": per_step(r, "ms"),
                      "allreduce_bytes_per_step": per_step(r, "bytes"),
                      "collectives": r["summary"]["collectives"]["by_op"]["all-reduce"],
                      "peak_gib": max(s["peak_gib"] or 0.0 for s in r["steps"])} for r in b],
        "one_process_vs_two_ranks_time_slicing_one_card": {
            "one_process_step_ms": [s["ms"] for s in a["steps"]],
            "one_process_median_step_ms": _median([s["ms"] for s in a["steps"][1:]]),
            "two_ranks_median_step_ms": [_median([s["ms"] for s in r["steps"][1:]]) for r in b],
            "note": "two ranks time-slice one card beside (c)-(e) and spatial training's "
                    "ranks: not scaling, and their times are under that load"}})
    check(all(torch.equal(grads[0][k], grads[1][k]) for k in grads[0]),
          "data parallel (b): the ranks' reduced gradients differ")
    check(not failures, f"data parallel (b): step-1 gradients against (a): {failures}")
    check(len(losses) == DP_STEPS and [s["loss"] for s in b[1]["steps"]] == losses
          and loss_rel[0] <= DP_FIRST_LOSS_RTOL and max(loss_rel) <= DP_LOSS_RTOL,
          f"data parallel (b): losses {losses} against (a)'s {a_losses}")
    for r, rec in enumerate(b):
        check(rec["host"] == [w[r] for w in want_rows[:DP_STEPS]] and rec["card_equal"],
              f"data parallel (b): rank {r}'s batches are not its rows of the one-process "
              "batches")
        check(all(s["launches"] == DP_WANT for s in rec["steps"]),
              f"data parallel (b): rank {r} launched {[s['launches'] for s in rec['steps']]}")
        check(rec["summary"]["mesh"] == "mesh(data=2,spatial=1:gpu)",
              f"data parallel (b): rank {r}'s mesh {rec['summary']['mesh']}")
    return {f"data parallel (b) rank {r}": _dp_launches(rec) for r, rec in enumerate(b)}


def _dp_preemption(tmp: str, base: list) -> None:
    """(c) SIGTERM to rank 1 only: both stop at step 2 with exit 75 and one
    checkpoint (rank 0's), and a two-rank resume reads the uninterrupted
    batches (``DP_SMALL``)."""
    outdir = os.path.join(tmp, "c")
    base = base + DP_SMALL + ["--num_steps", str(DP_RESUME_STEPS)]
    want_rows = [[_rows_digest(b, r, 2) for r in range(2)]
                 for b in _dp_stream(base, DP_RESUME_STEPS)]
    cargv = [DP_CHECK_EVERY, "1", *base, "--checkpoint_dir", outdir, *DP_CARD]
    codes, outs, seconds = _dp_ranks(
        outdir, cargv + ["--chaos", f"sigterm@{DP_SIGTERM_STEP}", "--chaos_rank", "1"], 2,
        "gloo", torchrun=False)
    c1 = _dp_records(outdir, 2)
    run_dir = os.path.join(outdir, "exp")
    files = sorted(n for n in os.listdir(run_dir) if n.startswith("step_"))
    for r in range(2):
        os.replace(os.path.join(outdir, f"rank{r}.json"),
                   os.path.join(outdir, f"rank{r}.preempted.json"))
    codes2, outs2, seconds2 = _dp_ranks(
        outdir, cargv + ["--restore_ckpt", run_dir], 2, "gloo", torchrun=False)
    c2 = _dp_records(outdir, 2)
    same = [c1[r]["host"] + c2[r]["host"] == [w[r] for w in want_rows] for r in range(2)]
    _dp_print("c", {
        "exits": codes, "stopped_at_step": [(r["summary"] or {}).get("step") for r in c1],
        "checkpoint_writes_by_rank": [r["checkpoint_writes"] for r in c1],
        "checkpoints": files, "resumed_exits": codes2,
        "resumed_restored": [r["restored"] for r in c2],
        "batches_equal_by_hash_across_the_resume": same, "seconds": [seconds, seconds2]})
    check(codes == [75, 75] and [r["summary"]["step"] for r in c1] == [DP_SIGTERM_STEP] * 2,
          f"data parallel (c): exits {codes}:\n{outs[1][1][-3000:]}")
    check([r["checkpoint_writes"] for r in c1] == [1, 0]
          and files == [f"step_{DP_SIGTERM_STEP}.pt"],
          f"data parallel (c): checkpoint writes {[r['checkpoint_writes'] for r in c1]}, "
          f"files {files}")
    check(codes2 == [0, 0] and all(r["restored"] for r in c2),
          f"data parallel (c) resumed: exits {codes2}:\n{outs2[0][1][-3000:]}")
    check(all(same), "data parallel (c): a rank's batches across the resume are not its rows "
                     "of the uninterrupted one-process batches")


def _dp_nccl(tmp: str, argv: list) -> dict:
    """(d) A one-rank NCCL world through the entry under --strict_guards,
    then two NCCL ranks on the one card, which must raise before step 1."""
    outdir = os.path.join(tmp, "d")
    codes, outs, seconds = _dp_ranks(
        outdir, argv + ["--checkpoint_dir", outdir, "--strict_guards"], 1, "",
        torchrun=True)
    check(codes == [0], f"data parallel (d): exit {codes}:\n{outs[0][1][-4000:]}")
    (d,) = _dp_records(outdir, 1)
    sg, dsum = d["summary"]["strict_guards"], d["summary"]
    losses = [s["loss"] for s in d["steps"]]
    outdir = os.path.join(tmp, "d2")
    codes2, _, seconds2 = _dp_ranks(
        outdir, argv + ["--checkpoint_dir", outdir, *DP_CARD], 2, "",
        torchrun=False)
    d2 = _dp_records(outdir, 2)
    _dp_print("d", {
        "strict_guards": sg, "backend": dsum["backend"], "mesh": dsum["mesh"],
        "allreduce": dsum["collectives"]["by_op"]["all-reduce"],
        "allreduce_ms_per_step": [sum(c["ms"] for c in d["collectives"] if c["step"] == s)
                                  for s in range(len(d["steps"]))],
        "losses": losses, "step_ms": [s["ms"] for s in d["steps"]],
        "seconds": seconds,
        "two_nccl_ranks_one_card": {"exits": codes2, "errors": [r["error"] for r in d2],
                                    "steps": [len(r["steps"]) for r in d2],
                                    "seconds": seconds2}})
    check(sg["host_transfers"] == 0 and sg["steady_recompiles"] == 0
          and dsum["mesh"] == "mesh(data=1,spatial=1:gpu)" and dsum["backend"] == "nccl"
          and dsum["collectives"]["by_op"]["all-reduce"]["count"] >= DP_STEPS
          and len(losses) == DP_STEPS and all(math.isfinite(x) for x in losses)
          and all(s["launches"] == DP_WANT for s in d["steps"]),
          f"data parallel (d): {sg}, {dsum['mesh']}, {dsum['collectives']}, losses {losses}")
    check(codes2 == [1, 1] and all("two NCCL ranks on one card" in (r["error"] or "")
                                   and not r["steps"] for r in d2),
          f"data parallel (d): two NCCL ranks on one card: exits {codes2}, "
          f"{[r['error'] for r in d2]}")
    return {"data parallel (d) nccl": _dp_launches(d)}


def _dp_validation_argv(sintel: str) -> list:
    return ["--model", "raft_nc_dbl", "--dataset", "sintel", "--root_sintel", sintel,
            "--iters", "12", "--batch_size", "1", "--seed", "0", *DP_CARD]


def _dp_sharded_validation(tmp: str, sintel: str, started: tuple) -> None:
    """(e) ``validate_sintel`` through the evaluate entry: two ranks (started
    beside (d), ``started`` = their processes and start time) against one
    process (this one), the same seeded weights, each frame at batch 1."""
    import io

    from raft_ncup_tpu_torch import evaluate as eval_mod

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code1 = eval_mod.main(_dp_validation_argv(sintel))
    seconds1 = time.perf_counter() - t0
    procs, t_start = started
    codes, outs = _wait_ranks(procs)
    seconds = time.perf_counter() - t_start
    check(code1 == 0 and codes == [0, 0],
          f"data parallel (e): exits {code1} {codes}:\n{outs[0][1][-3000:]}")
    one = json.loads(buf.getvalue().strip().splitlines()[-1])
    ranks = [json.loads(o[0].strip().splitlines()[-1]) for o in outs]
    rel = max(abs(r["results"][k] - v) / max(abs(v), 1e-12)
              for r in ranks for k, v in one["results"].items())
    _dp_print("e", {"one_process": one["results"], "max_rel_diff": rel,
                    "caches": [r["cache"] for r in ranks], "seconds": [seconds1, seconds]})
    check(all(set(r["results"]) == set(one["results"]) and r["world"] == 2 for r in ranks)
          and one["results"] and rel <= DP_VAL_RTOL,
          f"data parallel (e): {[r['results'] for r in ranks]} against {one['results']}")


def check_data_parallel(torch, card: str, tmp: str, after_b=None) -> dict:
    """Train and validate the flagship data-parallel: (a) one process in
    this one, ``DP_STEPS`` steps; (b) two ranks on the one card under gloo,
    started by ``torch.distributed.run``, each with ``--device cuda:0`` and
    a batch of 3: their losses, step-1 gradients (reduced, equal on both),
    batches (together, each step's one-process batch, by hash) and launches
    against (a); (c) ``sigterm@2`` to rank 1 only: both exit 75 at step 2,
    rank 0 wrote the one checkpoint, and a two-rank resume to step 3 reads
    the one-process batches; (d) a one-rank NCCL world through the entry
    under ``--strict_guards`` (no implicit read, no steady recompile), then
    two NCCL ranks on the one card, which must raise before step 1 ((c) and
    (d) at the ``DP_SMALL`` crop); (e) ``validate_sintel`` through the evaluate entry
    with two ranks (run beside (d)) against one process; (c) runs beside
    (d) and (e), and (b)'s ranks beside (c)-(e). ``after_b()``, when given, is called once (b)'s ranks
    are started (the spatial training phase starts its ranks there, so
    they too run beside (c)-(e)). Returns each rank's launches."""
    t0 = time.perf_counter()
    things, sintel = os.path.join(tmp, "FlyingThings3D"), os.path.join(tmp, "Sintel")
    write_things_tree(things)
    write_sintel_sequences(sintel)
    base = [t for t in script_flags("train_raft_nc_things.sh") if t != "--compressed_ft"]
    for flag in ("--load_pretrained", "--validation"):
        i = base.index(flag)
        del base[i:i + 2]
    base += ["--root_things", things, "--sum_freq", "1"]
    argv = base + ["--num_steps", str(DP_STEPS)]
    stream = _dp_stream(base + ["--num_steps", str(DP_RESUME_STEPS)], DP_RESUME_STEPS)
    want_rows = [[_rows_digest(b, r, 2) for r in range(2)] for b in stream]
    a = _dp_one_process(torch, tmp, argv, stream)
    # (b)'s ranks, and the spatial training phase's, run beside (c)-(e);
    # (e)'s beside (d).
    b_ranks = _dp_start_two_ranks(tmp, argv)
    if after_b is not None:
        after_b()
    # (c) on a thread of its own, beside (d) and (e): their processes start
    # up and autotune at once.
    with ThreadPoolExecutor(1) as pool:
        preemption = pool.submit(_dp_preemption, tmp, base)
        e_ranks = (_start_ranks(os.path.join(tmp, "e"), _dp_validation_argv(sintel), 2,
                                "gloo", module="raft_ncup_tpu_torch.evaluate"),
                   time.perf_counter())
        paths = _dp_nccl(tmp, argv + DP_SMALL)
        _dp_sharded_validation(tmp, sintel, e_ranks)
        preemption.result()
    paths.update(_dp_two_ranks(torch, card, tmp, a, want_rows, b_ranks))
    print(f"data parallel: the phase took {time.perf_counter() - t0:.1f} s", flush=True)
    return paths


# ------------------------------------------------------------ spatial axis

# The spatial phase: the flagship's whole f32 forward, batch 1, at 1088x1920
# and 2176x3840 in this process (captured, then replayed), the 1088x1920
# one split by image rows over two ranks sharing the card under gloo
# (``highres_forward --spatial 2``), and the evaluate entry with ``--mesh
# 1,2`` against one process.
SPATIAL_SIZES = ((1088, 1920), (2176, 3840))
SPATIAL_ITERS = 32
SPATIAL_REPS = 3  # timed replays at each size
SPATIAL_PLAIN_ITERS = 4  # the plain-version forward at 1088x1920, against the kernels'
SPATIAL_WANT = {"corr_lookup": SPATIAL_ITERS, "corr_lookup_bwd": 0, "nconv": 4, "nconv_bwd": 0}
# A Sintel-layout tree at a height both pad divisors (8 and 16) leave
# unpadded, so one process and two spatial ranks validate the same pixels.
SPATIAL_EVAL_SIZE = (432, 1024)
# Two ranks against one process: the bands' convolutions and the instance
# norm's sums round in another order than the whole image's; EPE within
# 1e-4 of itself, the 1/3/5 px fractions within 1e-4.
SPATIAL_EPE_RTOL = 1e-4
SPATIAL_FRACTION_ATOL = 1e-4


def _spatial_print(part: str, row: dict) -> None:
    print(f"spatial ({part}): {json.dumps(row)}", flush=True)


def _spatial_one_process(torch, card, size) -> tuple:
    """(a) The flagship's whole forward at ``size`` in this process through
    ``ShapeCachedForward``: one capture, one eager forward (its peak bytes),
    then ``SPATIAL_REPS`` timed replays, every kernel count set to 0 before
    them. Returns the model, the cache, the frames, the last replay's flows
    and its row."""
    from raft_ncup_tpu_torch import highres_forward as hr
    from raft_ncup_tpu_torch.inference.pipeline import ShapeCachedForward
    from raft_ncup_tpu_torch.models.raft import RAFT
    from raft_ncup_tpu_torch.utils.device import cudnn_autotune

    h, w = size
    model = RAFT(hr.model_config(False, "f32"), device="cuda", seed=0)
    i1, i2 = (t.cuda() for t in hr.frames(h, w, 0))
    fwd = ShapeCachedForward(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fwd.forward(i1, i2, SPATIAL_ITERS)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    capture_peak = torch.cuda.max_memory_allocated()
    # One eager forward's working set (the algorithms already autotuned):
    # what a spatial rank's peak is set beside.
    torch.cuda.reset_peak_memory_stats()
    with cudnn_autotune():
        model(i1, i2, iters=SPATIAL_ITERS)
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    walls, devs = [], []
    for _ in range(SPATIAL_REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        lr, up = fwd.forward(i1, i2, SPATIAL_ITERS)
        end.record()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        devs.append(start.elapsed_time(end))
    replay_peak = torch.cuda.max_memory_allocated()
    launches = read_launches()
    label = f"spatial (a) {h}x{w}"
    check_launches(launches, "raft_nc_dbl", False, label)
    check(launches == {k: n * SPATIAL_REPS for k, n in SPATIAL_WANT.items()},
          f"{label}: launches {launches}, want {SPATIAL_WANT} a forward")
    finite = bool(torch.isfinite(up).all()) and bool(torch.isfinite(lr).all())
    check(finite and tuple(up.shape) == (1, h, w, 2), f"{label}: flow {tuple(up.shape)}, "
                                                     f"finite {finite}")
    row = {"card": card, "shape": f"batch 1 at {h}x{w}, {SPATIAL_ITERS} iterations, f32",
           "capture_s": capture_s, "replay_wall_ms": walls, "replay_device_ms": devs,
           "median_wall_ms": _median(walls), "median_device_ms": _median(devs),
           "pool_bytes": sum(fwd.pool_bytes.values()),
           "peak_bytes": {"capture": capture_peak, "eager": eager_peak, "replay": replay_peak},
           "launches": launches, "finite": finite}
    return model, fwd, (i1, i2), (lr, up), row


def _spatial_vs_plain(torch, model, fwd, frames, row) -> None:
    """(a) The kernels' forward at ``SPATIAL_PLAIN_ITERS`` iterations (its
    own graph) against the same weights through the plain versions,
    eagerly, at the flagship's tolerances."""
    from raft_ncup_tpu_torch.utils.device import cudnn_autotune

    lr, up = fwd.forward(*frames, SPATIAL_PLAIN_ITERS)
    plain = plain_flagship(torch, model)
    with cudnn_autotune():
        lr_p, up_p = plain(*frames, iters=SPATIAL_PLAIN_ITERS)
    e_lr, ok_lr = max_err(torch, lr, lr_p, **FLOW_LR_TOL)
    e_up, ok_up = max_err(torch, up, up_p, **FLOW_UP_TOL)
    row.update(plain_iters=SPATIAL_PLAIN_ITERS, flow_lr_vs_plain=e_lr, flow_up_vs_plain=e_up)
    check(ok_lr and ok_up, f"spatial (a): the kernels' forward against the plain versions at "
                           f"{SPATIAL_PLAIN_ITERS} iterations: flow_lr {e_lr}, flow_up {e_up}")


def _spatial_two_ranks(torch, card, tmp, want) -> dict:
    """(b) ``highres_forward --spatial 2`` at 1088x1920: two ranks on the
    one card under gloo, each rank's flows against (a)'s at the flagship's
    tolerances; each rank's launches, collectives and peak bytes."""
    h, w = SPATIAL_SIZES[0]
    outdir = os.path.join(tmp, "spatial_b")
    argv = ["--size", str(h), str(w), "--iters", str(SPATIAL_ITERS), "--spatial", "2",
            *DP_CARD, "--save", outdir]
    codes, outs, seconds = _dp_ranks(outdir, argv, 2, "gloo", torchrun=False,
                                     module="raft_ncup_tpu_torch.highres_forward")
    check(codes == [0, 0], f"spatial (b): exits {codes}:\n{outs[0][1][-3000:]}\n"
                           f"{outs[1][1][-3000:]}")
    reps = [json.loads(o[0].strip().splitlines()[-1]) for o in outs]
    f2_bytes = (h // 8) * (w // 8) * 256 * 4
    rows, paths = [], {}
    for r, rep in enumerate(reps):
        flows = torch.load(os.path.join(outdir, f"flows_rank{r}.pt"), weights_only=True)
        e_lr, ok_lr = max_err(torch, flows["flow_lr"], want[0], **FLOW_LR_TOL)
        e_up, ok_up = max_err(torch, flows["flow_up"], want[1], **FLOW_UP_TOL)
        launches = {k: rep["launches"].get(k, 0) for k in SPATIAL_WANT}
        by_op = rep["by_op"]
        rows.append({"rank": r, "mesh": rep["mesh"], "flow_lr_vs_one_process": e_lr,
                     "flow_up_vs_one_process": e_up, "launches": launches,
                     "collectives": rep["collectives"],
                     "collective_bytes": rep["collective_bytes"], "by_op": by_op,
                     "peak_bytes": rep["peak_bytes"], "first_s": rep["first_s"],
                     "wall_ms": rep["wall_ms"], "device_ms": rep["device_ms"]})
        check(ok_lr and ok_up, f"spatial (b): rank {r}'s flows against (a)'s: flow_lr {e_lr}, "
                               f"flow_up {e_up}")
        check(launches == SPATIAL_WANT, f"spatial (b): rank {r} launched {launches}")
        check(rep["mesh"] == "mesh(data=1,spatial=2:gpu)" and rep["finite"]
              and by_op["collective-permute"]["count"] > 0
              and by_op["all-gather"]["bytes"] > f2_bytes,
              f"spatial (b): rank {r}: {rep['mesh']}, {by_op}")
        paths[f"spatial (b) rank {r}"] = launches
    _spatial_print("b", {"card": card, "seconds": seconds, "per_rank": rows,
                         "gathered_f2_bytes": f2_bytes,
                         "note": "two ranks time-slice one card under gloo: memory per rank "
                                 "and answers, not scaling"})
    return paths


def _spatial_evaluation(tmp: str) -> None:
    """(c) ``validate_sintel`` through the evaluate entry with ``--mesh
    1,2`` (two ranks on the one card, gloo) against one process (this one)
    on a Sintel-layout tree at ``SPATIAL_EVAL_SIZE``."""
    import io

    from raft_ncup_tpu_torch import evaluate as eval_mod

    sintel = os.path.join(tmp, "SintelSpatial")
    write_sintel_sequences(sintel, size=SPATIAL_EVAL_SIZE)
    eargv = ["--model", "raft_nc_dbl", "--dataset", "sintel", "--root_sintel", sintel,
             "--iters", "12", "--batch_size", "1", "--seed", "0", *DP_CARD]
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code1 = eval_mod.main(eargv)
    seconds1 = time.perf_counter() - t0
    codes, outs, seconds = _dp_ranks(os.path.join(tmp, "spatial_c"), eargv + ["--mesh", "1,2"],
                                     2, "gloo", torchrun=False,
                                     module="raft_ncup_tpu_torch.evaluate")
    check(code1 == 0 and codes == [0, 0],
          f"spatial (c): exits {code1} {codes}:\n{outs[0][1][-3000:]}")
    one = json.loads(buf.getvalue().strip().splitlines()[-1])
    ranks = [json.loads(o[0].strip().splitlines()[-1]) for o in outs]

    def diff(k, v, got):
        if k.endswith("px"):
            return abs(got - v), abs(got - v) <= SPATIAL_FRACTION_ATOL
        rel = abs(got - v) / max(abs(v), 1e-12)
        return rel, rel <= SPATIAL_EPE_RTOL

    diffs = {k: max(diff(k, v, r["results"][k])[0] for r in ranks)
             for k, v in one["results"].items()}
    ok = all(diff(k, v, r["results"][k])[1] for r in ranks for k, v in one["results"].items())
    _spatial_print("c", {"one_process": one["results"], "two_ranks": ranks[0]["results"],
                         "diff (relative for EPE, absolute for px fractions)": diffs,
                         "meshes": [r["mesh"] for r in ranks],
                         "collectives": [r["collectives"]["by_op"] for r in ranks],
                         "seconds": [seconds1, seconds]})
    check(one["results"] and all(set(r["results"]) == set(one["results"]) for r in ranks)
          and ok and ranks[0]["results"] == ranks[1]["results"]
          and all(r["mesh"] == "mesh(data=1,spatial=2:gpu)" and r["world"] == 2
                  and r["collectives"]["by_op"]["collective-permute"]["count"] > 0
                  for r in ranks),
          f"spatial (c): {[r['results'] for r in ranks]} against {one['results']}")


# Spatial serving (d, e): the serve entry over the mesh (1, 2), two ranks
# sharing the card under gloo, against this process's one-process server
# and engine on the same pairs and weights; then a fleet slot of two such
# ranks behind the router. The mesh pads 436 rows to 448 (its divisor 16);
# the one-process references pad with a bucket of 16 to the same pixels.
SERVE_WORKER = "--serve_worker"
SPATIAL_MESH = "mesh(data=1,spatial=2:gpu)"
SPATIAL_BUCKET = 16
SPATIAL_REQUESTS = 4
SPATIAL_SERVE_ARGS = ["--model", "raft_nc_dbl", "--size", str(SERVE_SIZE[0]), str(SERVE_SIZE[1]),
                      "--seed", "0", "--serve_batch_sizes", "1,2", "--iter_levels", "12",
                      "--serve_pad_bucket", str(SPATIAL_BUCKET), "--flight_dir", "", *DP_CARD]
SPATIAL_RUNS = {  # (d)'s runs of the entry, all at once, each as two ranks
    "serve": ["--num_requests", str(SPATIAL_REQUESTS)],
    "stream": ["--stream", "--n_streams", "2", "--frames_per_stream", "2", "--stream_iters",
               "12", "--stream_batch_sizes", "1,2", "--stream_capacity", "4",
               "--stream_pad_bucket", str(SPATIAL_BUCKET)],
    "early exit": ["--num_requests", str(SPATIAL_REQUESTS)],
}
SPATIAL_FLEET_PAIRS = 4


def serve_worker(outdir: str, argv: list) -> int:
    """One rank of the serve entry over a mesh (``chip_smoke.py
    --serve_worker OUTDIR <serve flags>``, started by the spatial phase
    with the launcher's environment): the entry's exit code, report (the
    leader's, or a follower's summary) and answers as
    ``OUTDIR/rank<RANK>.pt``; exits with the entry's code."""
    import torch

    sys.path.insert(0, HERE)
    from raft_ncup_tpu_torch import serve as serve_mod
    from raft_ncup_tpu_torch.parallel import multihost

    multihost.COLLECTIVE_TIMEOUT_S = DP_COLLECTIVE_TIMEOUT_S
    rank = int(os.environ.get("RANK", "0"))
    t0 = time.perf_counter()
    rc, report, responses, _ = serve_mod.run(argv)
    torch.save({"rc": rc, "report": report, "seconds": time.perf_counter() - t0,
                "answers": [{"status": r.status, "flow": r.flow, "detail": r.detail}
                            for r in responses]},
               os.path.join(outdir, f"rank{rank}.pt"))
    return rc


def _spatial_serve_refs(torch, tmp: str) -> dict:
    """(d) and (e) started (the entry's three runs, each as two ranks, and
    the fleet slot's supervisor), then this process's one-process answers
    on the same pairs, stream frames and weights while they warm up."""
    from raft_ncup_tpu_torch import serve as serve_mod
    from raft_ncup_tpu_torch.cli import serve_config_from_args, stream_config_from_args
    from raft_ncup_tpu_torch.config import ServeConfig
    from raft_ncup_tpu_torch.fleet import FleetConfig, ReplicaSupervisor
    from raft_ncup_tpu_torch.observability import Telemetry
    from raft_ncup_tpu_torch.serving import FlowServer, SyntheticTraffic
    from raft_ncup_tpu_torch.streaming import StreamEngine, StreamTraffic, replay_streams

    model = flagship(torch)
    pairs = [(a, b) for _, a, b in SyntheticTraffic(SERVE_SIZE, SPATIAL_REQUESTS, seed=0)]
    tol, _ = first_iteration_tol(torch, model, pairs)
    t0 = time.perf_counter()
    runs = {}
    for name, extra in SPATIAL_RUNS.items():
        env = ({"RAFT_TORCH_EARLYEXIT": "1", "RAFT_TORCH_EARLYEXIT_TOL": repr(tol)}
               if name == "early exit" else {})
        runs[name] = _start_ranks(os.path.join(tmp, f"spatial_d_{name.replace(' ', '_')}"),
                                  [*SPATIAL_SERVE_ARGS, *extra, "--mesh", "1,2"], 2, "gloo",
                                  worker=SERVE_WORKER, **env)
    cfg = FleetConfig(
        base_dir=os.path.join(tmp, "spatial_fleet"), n_replicas=1, size_hw=SERVE_SIZE,
        serve=ServeConfig(batch_sizes=(1, 2), iter_levels=(12,), queue_capacity=16,
                          pad_bucket=SPATIAL_BUCKET),
        stream=None, meshes=((1, 2),), extra_args=("--model", "raft_nc_dbl", "--seed", "0",
                                                   *DP_CARD),
        snapshot_interval_s=0.5, stale_after_factor=8.0, poll_interval_s=0.1,
        spawn_timeout_s=DP_TIMEOUT_S, drain_timeout_s=120.0, max_restarts=0)
    tel = Telemetry(flight_dir=os.path.join(cfg.base_dir, "router_flight"))
    sup = ReplicaSupervisor(cfg, env=_dp_env("gloo", 2), telemetry=tel)
    sup.start(wait_ready=False)
    refs = {"runs": runs, "t0": t0, "fleet": (cfg, sup, tel), "tol": tol, "pairs": pairs}
    # The answers of one process: the entry's own configurations without
    # --mesh (its parser), the pad bucket giving the mesh's padded shape.
    args = serve_mod.build_parser().parse_args(SPATIAL_SERVE_ARGS + SPATIAL_RUNS["stream"])
    for name, tol_ in (("serve", None), ("early exit", tol)):
        with earlyexit_env(tol_):
            server = FlowServer(model, serve_config_from_args(args))
        server.warmup(SERVE_SIZE)
        refs[name] = paused_burst(server, pairs)[0]
        server.drain()
    engine = StreamEngine(model, stream_config_from_args(args, SERVE_SIZE))
    traffic = list(StreamTraffic(SERVE_SIZE, 2, 2, seed=0, burst_size=args.burst_size))
    handles, _ = replay_streams(engine, traffic)
    refs["stream"] = [h.result(300) for h in handles]
    engine.drain()
    del model
    torch.cuda.empty_cache()
    return refs


def _rank_launches(rep: dict, batches: int, what: str) -> dict:
    """A rank's kernel launches after the warm-up: A 12 and B 4 a batch."""
    launches = {"corr_lookup": rep["corr_kernel_launches"], "corr_lookup_bwd": 0,
                "nconv": rep["nconv_kernel_launches"], "nconv_bwd": 0}
    check(batches > 0 and launches["corr_lookup"] == 12 * batches
          and launches["nconv"] == 4 * batches,
          f"{what}: launches {launches} for {batches} batches")
    return launches


def _spatial_entry(torch, card, tmp, refs) -> dict:
    """(d) The serve entry's runs over the mesh (1, 2): both ranks exit 0,
    name the mesh and launch A 12 and B 4 a batch; every answer ok and
    within ``FLEET_TOL`` of one process's; under early exit both ranks ran
    the same forwards, segments and flag reads."""
    import types

    paths, rows = {}, {}
    for name, procs in refs["runs"].items():
        codes, outs = _wait_ranks(procs)
        check(codes == [0, 0], f"spatial (d) {name}: exits {codes}:\n{outs[0][1][-3000:]}\n"
                               f"{outs[1][1][-3000:]}")
        outdir = os.path.join(tmp, f"spatial_d_{name.replace(' ', '_')}")
        lead, follow = (torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False)
                        for r in range(2))
        rep, frep = lead["report"], follow["report"]
        check(outs[0][0].strip() == outs[1][0].strip() == "" and frep.get("follower")
              and rep["mesh"] == frep["mesh"] == SPATIAL_MESH and frep["rank"] == 1,
              f"spatial (d) {name}: meshes {rep.get('mesh')} / {frep.get('mesh')}")
        op = "stream" if name == "stream" else "serve"
        batches = rep[f"{op}_batches"]
        check(frep["lockstep_ops"].get(op) == batches == rep["lockstep_ops"].get(op),
              f"spatial (d) {name}: {batches} batches, ops {rep['lockstep_ops']} / "
              f"{frep['lockstep_ops']}")
        got = [types.SimpleNamespace(**a) for a in lead["answers"]]
        unit = "stream_frames_per_sec" if op == "stream" else "serve_pairs_per_sec"
        row = {"card": card, "answers": _against(torch, got, refs[name], f"spatial (d) {name}"),
               "batches": batches, "seconds": [lead["seconds"], follow["seconds"]],
               "warmup_s": rep["warmup_s"], unit: rep[unit],
               **{k: rep[f"{op}_{k}"] for k in ("wall_s", "p50_ms", "p99_ms")},
               "collectives": [rep["collectives"], frep["collectives"]],
               "lockstep": [rep["lockstep"], frep["lockstep"]]}
        if name == "early exit":
            check(rep["earlyexit"] == frep["earlyexit"] and rep["earlyexit"]["forwards"] > 0,
                  f"spatial (d) early exit: {rep['earlyexit']} / {frep['earlyexit']}")
            row.update(tol=refs["tol"], earlyexit=[rep["earlyexit"], frep["earlyexit"]])
        else:
            for r, rr in enumerate((rep, frep)):
                paths[f"spatial (d) {name} rank {r}"] = _rank_launches(
                    rr, batches, f"spatial (d) {name} rank {r}")
            row["launches"] = [paths[f"spatial (d) {name} rank {r}"] for r in range(2)]
        rows[name] = row
        _spatial_print(f"d, {name}", row)
    return paths


def _spatial_fleet(torch, card, refs) -> dict:
    """(e) The fleet slot of the mesh (1, 2): READY with the mesh in
    healthz, ``SPATIAL_FLEET_PAIRS`` pairs through the router against one
    process's answers, then ``stop()``: both ranks exit 75, the drain's
    contract holds, each rank launched A 12 and B 4 a batch, and no
    ``--replica_socket`` process is left."""
    from raft_ncup_tpu_torch.fleet import FleetRouter, read_healthz
    from raft_ncup_tpu_torch.fleet.replica import RankGroup

    cfg, sup, tel = refs["fleet"]
    router = None
    try:
        sup.wait_ready()
        ready_s = time.perf_counter() - refs["t0"]
        group = sup.replicas[0].child
        hz = read_healthz(cfg.replica(0).healthz_path) or {}
        check(isinstance(group, RankGroup) and hz.get("overall") == "ready"
              and hz.get("mesh") == SPATIAL_MESH and hz.get("pid") == group.pid,
              f"spatial (e): healthz {json.dumps(hz)[:400]}")
        router = FleetRouter(cfg, sup, telemetry=tel)
        n = SPATIAL_FLEET_PAIRS
        rs, wall = _fleet_burst(router, refs["pairs"][:n])
        answers = _against(torch, rs, refs["serve"][:n], "spatial (e) fleet")
        router.drain()
        router = None
        reports = sup.stop()
        codes = [c.returncode for c in group.children]
        left = [f"{pid} {state} {cmd}" for pid, (state, cmd) in descendants().items()
                if "--replica_socket" in cmd]
        check(not left, f"spatial (e): replica processes outlive the supervisor's stop: {left}")
        check(codes == [75, 75] and sup.report()["contract_violations"] == [],
              f"spatial (e): exits {codes}, {sup.report()['contract_violations']}")
        rep = reports[0]["report"]
        frep = json.loads(group.stderr_so_far().split("lockstep follower: ")[-1].splitlines()[0])
        check(rep["recompiles"] == 0 and rep["host_transfers"] == 0 and rep["mesh"] == SPATIAL_MESH
              and frep["mesh"] == SPATIAL_MESH, f"spatial (e): {rep['recompiles']} recompiles, "
              f"{rep['host_transfers']} host transfers, {rep['mesh']} / {frep['mesh']}")
        batches = rep["serve_batches"]
        check(frep["lockstep_ops"].get("serve") == batches,
              f"spatial (e): {batches} batches, the follower ran {frep['lockstep_ops']}")
        paths = {f"spatial (e) replica rank {r}": _rank_launches(
            rr, batches, f"spatial (e) rank {r}") for r, rr in enumerate((rep, frep))}
    finally:
        if router is not None:
            router.drain(timeout=5.0)
        sup.stop(drain=False)
    _spatial_print("e", {"card": card, "ready_s": ready_s, "answers": answers,
                         "burst_wall_s": wall, "exits": codes, "batches": batches,
                         "launches": list(paths.values()),
                         "collectives": [rep["collectives"], frep["collectives"]]})
    return paths


def check_spatial_serving(torch, card: str, tmp: str) -> dict:
    """(d) and (e): the serve entry's plain, ``--stream`` and early-exit
    runs over the mesh (1, 2) and a fleet slot of it, all started at once,
    against this process's one-process answers. Returns each rank's
    launches."""
    t0 = time.perf_counter()
    refs = _spatial_serve_refs(torch, tmp)
    try:
        paths = _spatial_entry(torch, card, tmp, refs)
        paths.update(_spatial_fleet(torch, card, refs))
    finally:
        for p in (p for procs in refs["runs"].values() for p in procs):
            if p.poll() is None:  # a check failed first: no rank outlives the phase
                p.kill()
                p.wait()
        refs["fleet"][1].stop(drain=False)
    print(f"spatial serving: (d) and (e) took {time.perf_counter() - t0:.1f} s", flush=True)
    return paths


# ----------------------------------------------------------- mixed mesh (h)
# A pipe axis beside a data or spatial axis (parallel/mesh.py): each pipe
# index runs the (data, spatial) forward on the same batch, as JAX
# replicates it over pipe. Four gloo ranks share the card; the serve entry
# runs three times in their one world.
MIXED_WORKER = "--mixed_worker"
MIXED_WORLD = 4
MIXED_REQUESTS = 8
MIXED_BUCKET = 16  # 436 rows pad to 448 under either mesh and in one process
MIXED_LEVELS = (12, 6)  # segment boundaries of the pipe axis of 2
MIXED_SERVE_ARGS = ["--model", "raft_nc_dbl", "--size", str(SERVE_SIZE[0]), str(SERVE_SIZE[1]),
                    "--seed", "0", "--serve_batch_sizes", "2", "--iter_levels",
                    ",".join(map(str, MIXED_LEVELS)), "--num_requests", str(MIXED_REQUESTS),
                    "--burst_size", str(MIXED_REQUESTS), "--queue_capacity", "16",
                    "--serve_pad_bucket", str(MIXED_BUCKET), "--flight_dir", "", *DP_CARD]
MIXED_STREAM_ITERS = 12
MIXED_STREAM_ARGS = ["--stream", "--n_streams", "2", "--frames_per_stream", "2",
                     "--stream_iters", str(MIXED_STREAM_ITERS), "--stream_batch_sizes", "2",
                     "--stream_capacity", "4", "--stream_pad_bucket", str(MIXED_BUCKET)]
MIXED_RUNS = {  # in this order, in one world
    "serve 1,2,2": [*MIXED_SERVE_ARGS, "--mesh", "1,2,2"],
    "serve 2,1,2": [*MIXED_SERVE_ARGS, "--mesh", "2,1,2"],
    "stream 2,1,2": [*MIXED_SERVE_ARGS, *MIXED_STREAM_ARGS, "--mesh", "2,1,2"],
}
MIXED_MESHES = {"1,2,2": "mesh(data=1,spatial=2,pipe=2:gpu)",
                "2,1,2": "mesh(data=2,spatial=1,pipe=2:gpu)"}


def mixed_worker(outdir: str, argv: list, after=None) -> int:
    """One rank of a world serving over a mesh with a pipe axis
    (``chip_smoke.py --mixed_worker OUTDIR <serve flags> [--then <serve
    flags> ...]``, under the launcher's environment): joins the world once,
    runs the serve entry's ``run`` for each flag list in order (then
    ``after(torch, outdir, rank, device)`` in the same world, if given), and
    records every forward this rank ran (the server's and the stream
    engine's ``_run``, their flows gathered over the data axis, cloned on
    the card and copied to the host after the run, so that recording adds
    no wait to a dispatch) and, on the leader, each batch's request ids. Writes
    ``OUTDIR/rank<RANK>_<k>.pt`` for run ``k`` (its exit code, report or
    follower summary, answers, forwards and batches); exits with the last
    run's code, or the first that is not 0."""
    import torch

    sys.path.insert(0, HERE)
    from raft_ncup_tpu_torch import serve as serve_mod
    from raft_ncup_tpu_torch.parallel import mesh as mesh_mod
    from raft_ncup_tpu_torch.parallel import multihost
    from raft_ncup_tpu_torch.serving import FlowServer
    from raft_ncup_tpu_torch.streaming import StreamEngine

    # Three entries' output would outgrow a pipe the script reads only at
    # the end: this rank writes it to OUTDIR/rank<RANK>.log.
    log = open(os.path.join(outdir, f"rank{os.environ.get('RANK', '0')}.log"), "w")
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    runs = [[]]
    for a in argv:
        if a == "--then":
            runs.append([])
        else:
            runs[-1].append(a)
    multihost.COLLECTIVE_TIMEOUT_S = DP_COLLECTIVE_TIMEOUT_S
    device = multihost.local_device(runs[0][runs[0].index("--device") + 1]
                                    if "--device" in runs[0] else None)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    joined = world > 1 and multihost.initialize_distributed(device=device)
    rank = multihost.process_index() if joined else 0
    rec = {"flows": [], "batches": []}

    def recording(run):
        def wrapped(self, *a, **kw):
            out = run(self, *a, **kw)
            rec["flows"].append(out[0].detach().clone())
            return out
        return wrapped

    process = FlowServer._process

    def batches(self, batch, depth):
        rec["batches"].append([r.request_id for r in batch])
        return process(self, batch, depth)

    FlowServer._run = recording(FlowServer._run)
    StreamEngine._run = recording(StreamEngine._run)
    FlowServer._process = batches
    code = 0
    try:
        for k, run_argv in enumerate(runs):
            rec["flows"], rec["batches"] = [], []
            mesh_mod.reset_collective_stats()  # each run's report counts its own
            t0 = time.perf_counter()
            rc, report, responses, _ = serve_mod.run(run_argv)
            torch.save({"rc": rc, "report": report, "seconds": time.perf_counter() - t0,
                        "answers": [{"request_id": r.request_id, "status": r.status,
                                     "flow": r.flow, "iters": r.iters, "detail": r.detail}
                                    for r in responses],
                        "flows": [f.cpu() for f in rec["flows"]], "batches": rec["batches"]},
                       os.path.join(outdir, f"rank{rank}_{k}.pt"))
            code = code or rc
        if after is not None:
            code = code or after(torch, outdir, rank, device)
    finally:
        if joined:
            multihost.shutdown()
    return code


def start_mixed(tmp: str) -> dict:
    """(h)'s four ranks sharing the card (gloo), started and not waited
    for: :func:`check_mixed` waits for them. The script starts them beside
    the train-from-files phase, so their times are under its load."""
    outdir = os.path.join(tmp, "h")
    argv = []
    for k, run in enumerate(MIXED_RUNS.values()):
        argv += (["--then"] if k else []) + run
    return {"t0": time.perf_counter(), "outdir": outdir,
            "procs": _start_ranks(outdir, argv, MIXED_WORLD, "gloo", worker=MIXED_WORKER)}


def _mixed_refs(torch, levels: set) -> dict:
    """This process's one-process answers: the burst's pairs through a
    server at each level in ``levels`` (batch size 2, the pad bucket of
    16), and the stream run's frames through an engine."""
    from raft_ncup_tpu_torch import serve as serve_mod
    from raft_ncup_tpu_torch.cli import stream_config_from_args
    from raft_ncup_tpu_torch.config import ServeConfig
    from raft_ncup_tpu_torch.serving import FlowServer, SyntheticTraffic
    from raft_ncup_tpu_torch.streaming import StreamEngine, StreamTraffic, replay_streams

    model = flagship(torch)
    pairs = [(a, b) for _, a, b in SyntheticTraffic(SERVE_SIZE, MIXED_REQUESTS, seed=0)]
    refs = {}
    for level in sorted(levels):
        server = FlowServer(model, ServeConfig(batch_sizes=(2,), iter_levels=(level,),
                                               queue_capacity=16, pad_bucket=MIXED_BUCKET))
        refs[level] = paused_burst(server, pairs)[0]
        server.drain()
    args = serve_mod.build_parser().parse_args(MIXED_SERVE_ARGS + MIXED_STREAM_ARGS)
    engine = StreamEngine(model, stream_config_from_args(args, SERVE_SIZE))
    traffic = list(StreamTraffic(SERVE_SIZE, 2, 2, seed=0, burst_size=args.burst_size))
    handles, _ = replay_streams(engine, traffic)
    refs["stream"] = [h.result(300) for h in handles]
    engine.drain()
    del model
    torch.cuda.empty_cache()
    return refs


def _mixed_launches(rep: dict, levels: list, what: str) -> dict:
    """A rank's kernel launches after the warm-up: B 4 a batch, A the
    batch's level (the iterations it ran)."""
    launches = {"corr_lookup": rep["corr_kernel_launches"], "corr_lookup_bwd": 0,
                "nconv": rep["nconv_kernel_launches"], "nconv_bwd": 0}
    check(levels and launches["corr_lookup"] == sum(levels)
          and launches["nconv"] == 4 * len(levels),
          f"{what}: launches {launches} for batches at levels {levels}")
    return launches


def _pipe_spread(recs: list, P: int = 2) -> float:
    """The largest |difference| between the forwards of the pipe indices
    of one (data, spatial) place, over every forward of the run."""
    worst = 0.0
    for g in range(len(recs) // P):
        base = recs[g * P]["flows"]
        for other in recs[g * P + 1:(g + 1) * P]:
            check(len(other["flows"]) == len(base), "mixed (h): the pipe indices ran "
                                                    f"{len(base)} and {len(other['flows'])} "
                                                    "forwards")
            for a, b in zip(base, other["flows"]):
                worst = max(worst, float((a - b).abs().max()))
    return worst


def _mixed_answers(torch, recs: list, want: dict, what: str, n: int = MIXED_REQUESTS,
                   tol: dict = FLEET_TOL, epe_budget=None) -> dict:
    """Every rank's answers, cut from the forwards it recorded as the
    leader's are cut from its own (the leader's batches name the requests;
    its answers give the rows' offset), held against the one-process
    answers (``want[level]``, in the burst's order) at each request's
    level within ``tol``, or with ``epe_budget`` within that mean EPE (a
    bf16 preset, whose bands round differently from the whole image)."""
    lead = recs[0]
    answers = {a["request_id"]: a for a in lead["answers"]}
    order = sorted(answers)  # the burst's pairs in request order
    check(len(answers) == n and all(a["status"] == "ok" for a in answers.values()),
          f"{what}: answers {[(a['status'], a['detail']) for a in answers.values()]}")
    n_warm = len(lead["flows"]) - len(lead["batches"])
    first = answers[lead["batches"][0][0]]["flow"]
    h, w = first.shape[:2]
    row0 = lead["flows"][n_warm][0]
    top = next((t for t in range(row0.shape[0] - h + 1)
                if torch.equal(row0[t:t + h, :w], torch.from_numpy(first))), None)
    check(top is not None, f"{what}: the leader's answer is no crop of its forward")
    worst, worst_epe = 0.0, 0.0
    for r, rec in enumerate(recs):
        for k, ids in enumerate(lead["batches"]):
            for j, rid in enumerate(ids):
                got = rec["flows"][n_warm + k][j][top:top + h, :w]
                ref = want[answers[rid]["iters"]][order.index(rid)]
                check(ref.status == "ok", f"{what}: the one-process answer {rid} {ref.status}")
                err, ok = max_err(torch, got, torch.tensor(ref.flow), **tol)
                epe = float((got - torch.tensor(ref.flow)).norm(dim=-1).mean())
                if epe_budget is not None:
                    ok = epe <= epe_budget
                check(ok, f"{what} rank {r} request {rid}: {err:.3e} (mean EPE {epe:.3e}) "
                          "from one process")
                worst, worst_epe = max(worst, err), max(worst_epe, epe)
    return {"n": len(answers), "ranks": len(recs), "max_abs_diff": worst,
            "max_mean_epe": worst_epe}


def check_mixed(torch, card: str, started: dict) -> dict:
    """(h) The serve entry over ``--mesh 1,2,2`` and ``--mesh 2,1,2`` and
    its stream over ``--mesh 2,1,2``, four ranks in one world: every rank
    exits 0 and names the mesh; every pipe index's answers against this
    process's one-process answers; the largest difference between pipe
    indices; each rank's lockstep operations, collectives and launches,
    the same on all four. Returns each rank's launches by run."""
    import types

    t0 = time.perf_counter()
    codes, _ = _wait_ranks(started["procs"])
    if codes != [0] * MIXED_WORLD:
        tails = []
        for r in range(MIXED_WORLD):
            with open(os.path.join(started["outdir"], f"rank{r}.log")) as fh:
                tails.append(f"rank {r}: {fh.read()[-2000:]}")
        check(False, f"mixed (h): exits {codes}:\n" + "\n".join(tails))
    ranks_s = time.perf_counter() - started["t0"]
    recs = {run: [torch.load(os.path.join(started["outdir"], f"rank{r}_{k}.pt"),
                             weights_only=False) for r in range(MIXED_WORLD)]
            for k, run in enumerate(MIXED_RUNS)}
    levels = {a["iters"] for run, rs in recs.items() if run.startswith("serve")
              for a in rs[0]["answers"]}
    check(levels <= set(MIXED_LEVELS), f"mixed (h): levels {levels}")
    want = _mixed_refs(torch, levels)
    paths = {}
    for run, rs in recs.items():
        kind, mesh = run.split()
        reps = [r["report"] for r in rs]
        op = "stream" if kind == "stream" else "serve"
        batches = reps[0][f"{op}_batches"]
        check(all(r["rc"] == 0 for r in rs) and all(rep.get("follower") for rep in reps[1:])
              and all(rep["mesh"] == MIXED_MESHES[mesh] for rep in reps)
              and [rep["rank"] for rep in reps[1:]] == [1, 2, 3],
              f"mixed (h) {run}: meshes {[rep.get('mesh') for rep in reps]}")
        check(all(rep["lockstep_ops"].get(op) == batches for rep in reps),
              f"mixed (h) {run}: {batches} batches, ops {[rep['lockstep_ops'] for rep in reps]}")
        n_warm = len(rs[0]["flows"]) - batches
        if kind == "serve":
            answers = _mixed_answers(torch, rs, want, f"mixed (h) {run}")
            by_id = {a["request_id"]: a["iters"] for a in rs[0]["answers"]}
            levels_run = [by_id[ids[0]] for ids in rs[0]["batches"]]
        else:
            got = [types.SimpleNamespace(**a) for a in rs[0]["answers"]]
            answers = _against(torch, got, want["stream"], f"mixed (h) {run}")
            levels_run = [MIXED_STREAM_ITERS] * batches
        launches = [_mixed_launches(rep, levels_run, f"mixed (h) {run} rank {r}")
                    for r, rep in enumerate(reps)]
        check(all(l == launches[0] for l in launches),
              f"mixed (h) {run}: the ranks' launches differ: {launches}")
        for r, l in enumerate(launches):
            paths[f"mixed (h) {run} rank {r}"] = l
        unit = "stream_frames_per_sec" if op == "stream" else "serve_pairs_per_sec"
        row = {"card": card, "mesh": MIXED_MESHES[mesh], "answers": answers,
               "pipe_max_abs_diff": _pipe_spread(rs), "batches": batches,
               "warmup_forwards": n_warm, "levels": levels_run,
               "seconds": [r["seconds"] for r in rs], unit: reps[0][unit],
               **{k: reps[0][f"{op}_{k}"] for k in ("wall_s", "p50_ms", "p99_ms")},
               "launches": launches, "collectives": [rep["collectives"] for rep in reps],
               "lockstep": [rep["lockstep"] for rep in reps],
               "note": "four ranks time-slice one card beside the train-from-files phase: "
                       "not a mesh's speed"}
        print(f"mixed (h) {run}: {json.dumps(row)}", flush=True)
    print(f"mixed (h): the ranks took {ranks_s:.1f} s from their start, the check "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return paths


def check_spatial(torch, card: str, tmp: str) -> dict:
    """The spatial axis (``parallel/halo.py``): (a) the flagship's whole f32
    forward at 1088x1920 and 2176x3840, batch 1, ``SPATIAL_ITERS``
    iterations, in this process as graph replays (wall and device ms, pool
    and peak bytes, A 32 and B 4 a forward), the 1088x1920 one held against
    the plain versions at ``SPATIAL_PLAIN_ITERS`` iterations; (b) the same
    1088x1920 forward split by rows over two ranks sharing the card under
    gloo, each rank's flows against (a)'s; (c) the evaluate entry with
    ``--mesh 1,2`` against one process. Returns each path's launches."""
    t0 = time.perf_counter()
    paths, want = {}, None
    for size in SPATIAL_SIZES:
        model, fwd, frames, flows, row = _spatial_one_process(torch, card, size)
        if want is None:
            want = tuple(t.cpu() for t in flows)
            _spatial_vs_plain(torch, model, fwd, frames, row)
        label = f"spatial (a) {size[0]}x{size[1]}"
        paths[label] = row["launches"]
        _spatial_print(f"a) {size[0]}x{size[1]}", row)
        del model, fwd, frames, flows
        torch.cuda.empty_cache()
    paths.update(_spatial_two_ranks(torch, card, tmp, want))
    _spatial_evaluation(tmp)
    print(f"spatial: the phase took {time.perf_counter() - t0:.1f} s", flush=True)
    return paths


# ---------------------------------------------------- spatial training (f)

# The flagship's train step split by image rows over two ranks sharing the
# card under gloo (``--mesh 1,2``), at the things crop 400x720, batch 2, 12
# iterations, remat on, against one process: at stage chairs (BatchNorm
# trains, its statistics summed over both ranks) and at stage things
# (BatchNorm frozen). Both stages run in the same two rank processes, one
# after the other, so the launcher, the join and cuDNN's autotuning are paid
# once.
SPATIAL_TRAIN_WORKER = "--spatial_train_worker"
SPATIAL_TRAIN_STAGES = ("chairs", "things")
SPATIAL_TRAIN_STEPS = 2
SPATIAL_TRAIN_ARGS = ["--batch_size", "2", "--num_steps", str(SPATIAL_TRAIN_STEPS)]
SPATIAL_TRAIN_MESH = "mesh(data=1,spatial=2:gpu)"
# Two ranks on bands against one process: the loss within 1e-5 relative,
# every gradient within 1e-4 of its largest value, the upsampler's within
# 1e-3 (below) and the two encoders' (``fnet.*``, ``cnet.*``) within 5e-2:
# at 400x720 their float32 gradients are themselves that far from float64's
# (the probe below: up to 1.9e-2 for one process), small differences of
# large sums behind instance and batch norm; the phase prints the one
# process's own float32
# error against a float64 run of each encoder, and holds the encoders on
# two bands in float64 within 1e-10 of the whole image (the exchanges and
# the group sums exact).
SPATIAL_TRAIN_LOSS_RTOL = 1e-5
SPATIAL_TRAIN_GRAD_TOL = 1e-4
SPATIAL_TRAIN_FLIPPED = ("fnet.", "cnet.")
SPATIAL_TRAIN_ENCODER_TOL = 5e-2
# A bias whose output a training BatchNorm centres has a gradient of exactly
# zero (the weights net's at stage chairs): a sum over the batch's 576,000
# pixels of terms that cancel, float32 noise of up to 4.4e-4 of the step's
# largest gradient (measured), held below 2e-3 of it on each side.
SPATIAL_TRAIN_CENTRED = ("upsampler.weights_est_net.conv.",)
SPATIAL_TRAIN_CENTRED_TOL = 2e-3
# The upsampler's gradients: normalized convolution does not change when
# its confidence is scaled, so the weights net's gradient, like the NConv
# weights' (ROADMAP.md queue 3 entry 2), is a small difference of large
# terms; at 400x720 the bands moved it by up to 4.8e-4 of its largest value
# (stage things, measured), the NConv weights' by 3.8e-5.
SPATIAL_TRAIN_UPSAMPLER = ("upsampler.",)
SPATIAL_TRAIN_UPSAMPLER_TOL = 1e-3
SPATIAL_TRAIN_F64_TOL = 1e-10
# The encoder probe: each encoder of the flagship (instance-norm fnet,
# batch-norm cnet, training) on a seeded (2, 3, 400, 720) input with a
# seeded gradient at its output.
SPATIAL_PROBE_SHAPE = (2, 3, 400, 720)
SPATIAL_PROBE_ENCODERS = {"fnet": (256, "instance"), "cnet": (256, "batch")}


def encoder_probe(torch, name: str, dtype, group=None, world_sum=None) -> dict:
    """The probe's gradients of encoder ``name`` at ``dtype`` on the card:
    of the whole image, or of this rank's band of it under ``group`` (the
    batch norm's statistics summed by ``world_sum``), by parameter name."""
    from raft_ncup_tpu_torch.nn.extractor import Encoder
    from raft_ncup_tpu_torch.nn.layers import init_weights, synced_batch_stats
    from raft_ncup_tpu_torch.parallel import halo
    from raft_ncup_tpu_torch.utils.device import cudnn_autotune, f32_precision

    dim, norm = SPATIAL_PROBE_ENCODERS[name]
    enc = Encoder(dim, norm)
    init_weights(enc, torch.Generator().manual_seed(1))
    enc = enc.to("cuda", dtype).train()
    gen = torch.Generator().manual_seed(2)
    x = (2 * torch.rand(SPATIAL_PROBE_SHAPE, generator=gen) - 1).to("cuda", dtype)
    B, _, H, W = SPATIAL_PROBE_SHAPE
    up = torch.randn((B, dim, H // 8, W // 8), generator=gen).to("cuda", dtype)
    named = list(enc.named_parameters())
    synced = (synced_batch_stats(enc, world_sum) if world_sum is not None
              else contextlib.nullcontext())
    with f32_precision(), cudnn_autotune(), synced, halo.spatial(group):
        y = enc(halo.band(x, 2))
        grads = torch.autograd.grad((y * halo.band(up, 2)).sum(), [p for _, p in named])
    return {n: g for (n, _), g in zip(named, grads)}


def _rel_worst(want: dict, got: dict) -> tuple:
    """The largest per-tensor error of ``got`` against ``want`` over each
    tensor's largest value, with its name (tensors below 1e-6 of the
    largest gradient, rounding noise, left out)."""
    gmax = max(float(w.abs().max()) for w in want.values())
    return max((float((got[n].double() - w.double()).abs().max()) / float(w.abs().max()), n)
               for n, w in want.items() if float(w.abs().max()) > NEGLIGIBLE * gmax)


def _spatial_train_argv(base: list, stage: str) -> list:
    """The train entry's flags for ``stage``: stage chairs trains on the
    procedural pairs (no FlyingChairs tree), stage things on the written
    FlyingThings3D tree."""
    argv = list(base)
    argv[argv.index("--stage") + 1] = stage
    if stage == "chairs":
        argv.append("--synthetic_ok")
    return argv + SPATIAL_TRAIN_ARGS


def spatial_train_worker(outdir: str, argv: list) -> int:
    """One rank of the spatial training run (``chip_smoke.py
    --spatial_train_worker OUTDIR <train flags>`` under the launcher): it
    joins the world once and runs the train entry at each stage of
    ``SPATIAL_TRAIN_STAGES``, writing ``OUTDIR/<stage>/rank<RANK>.json``;
    exits 1 when a run failed."""
    import torch

    sys.path.insert(0, HERE)
    from raft_ncup_tpu_torch.parallel import multihost

    multihost.COLLECTIVE_TIMEOUT_S = DP_COLLECTIVE_TIMEOUT_S
    device = multihost.local_device(argv[argv.index("--device") + 1])
    torch.cuda.set_device(device)
    multihost.initialize_distributed(device=device)
    code = 0
    try:
        from raft_ncup_tpu_torch.parallel import mesh as mesh_mod

        # The encoders on two bands in float64 (this rank's share, summed over
        # the ranks), written beside the stages' records.
        group = mesh_mod.spatial_group(mesh_mod.make_mesh(1, 2, device=device))
        probe = {}
        for name in SPATIAL_PROBE_ENCODERS:
            grads = encoder_probe(torch, name, torch.float64, group, multihost.all_reduce_grad)
            probe[name] = {n: multihost.all_reduce_(g.clone()).cpu() for n, g in grads.items()}
        torch.save(probe, os.path.join(outdir, f"probe_rank{multihost.process_index()}.pt"))
        for stage in SPATIAL_TRAIN_STAGES:
            sdir = os.path.join(outdir, stage)
            os.makedirs(sdir, exist_ok=True)
            status, error, _, record = _dp_run(
                torch, sdir, _spatial_train_argv(argv, stage) + ["--checkpoint_dir", sdir],
                timed=False)
            with open(os.path.join(sdir, f"rank{record['rank']}.json"), "w") as fh:
                json.dump(record, fh)
            if error or status:
                print(f"spatial_train_worker rank {record['rank']} {stage}: exit {status}, "
                      f"{error}", file=sys.stderr)
                code = 1
    finally:
        multihost.shutdown()
    return code


def _spatial_train_base(tmp: str) -> list:
    """The train entry's flags of the phase: ``train_raft_nc_things.sh``'s
    (no pretrained load, no in-run validation) on a FlyingThings3D tree
    under ``tmp``, on the card ``DP_CARD``."""
    things = os.path.join(tmp, "FlyingThings3D")
    base = [t for t in script_flags("train_raft_nc_things.sh") if t != "--compressed_ft"]
    for flag in ("--load_pretrained", "--validation"):
        i = base.index(flag)
        del base[i:i + 2]
    return base + ["--root_things", things, "--sum_freq", "1", *DP_CARD]


def start_spatial_train(tmp: str) -> dict:
    """(f)'s two ranks, started (``torch.distributed.run``, gloo, ``--mesh
    1,2``) and not waited for: ``check_spatial_train`` waits for them. The
    script starts them beside the data-parallel phase's (c)-(e), whose
    numbers it does not hold, so their step times are under that load."""
    write_things_tree(os.path.join(tmp, "FlyingThings3D"))
    outdir = os.path.join(tmp, "f2")
    return {"t0": time.perf_counter(), "outdir": outdir,
            "procs": _start_ranks(outdir, _spatial_train_base(tmp) + ["--mesh", "1,2"], 2,
                                  "gloo", True, None, SPATIAL_TRAIN_WORKER)}


def check_spatial_train(torch, card: str, tmp: str, ranks_started: dict) -> dict:
    """(f) The flagship's train step split by rows over two ranks sharing the
    card (gloo, ``--mesh 1,2`` through ``torch.distributed.run``, started by
    :func:`start_spatial_train`), at stage chairs and stage things, against
    one process in this one: the losses, the step-1 gradients (reduced,
    equal on both ranks), the batches (each rank's the whole one-process
    batch, by hash), each rank's launches a step (the one-process counts)
    and collectives (the same on both ranks); and the encoders on two bands
    in float64 against the whole image. Returns each rank's launches at each
    stage."""
    t0 = time.perf_counter()
    base = _spatial_train_base(tmp)
    ones = {}
    for stage in SPATIAL_TRAIN_STAGES:
        argv = _spatial_train_argv(base, stage)
        stream = [_digest(b) for b in _dp_stream(argv, SPATIAL_TRAIN_STEPS)]
        sdir = os.path.join(tmp, "f1", stage)
        t1 = time.perf_counter()
        status, error, _, a = _dp_run(torch, sdir, argv + ["--checkpoint_dir", sdir],
                                      timed=False)
        check(status == 0 and error is None, f"spatial (f) one process, {stage}: exit "
                                             f"{status}, {error}")
        check(a["host"] == stream and a["card_equal"],
              f"spatial (f) one process, {stage}: the batches are not the loader's stream")
        check(all(s["launches"] == DP_WANT for s in a["steps"]),
              f"spatial (f) one process, {stage}: launches "
              f"{[s['launches'] for s in a['steps']]}")
        a["grad_tensors"] = torch.load(a["grads"], weights_only=True)
        a["seconds"] = time.perf_counter() - t1
        ones[stage] = (a, stream)
    outdir = ranks_started["outdir"]
    codes, outs = _wait_ranks(ranks_started["procs"])
    seconds = time.perf_counter() - ranks_started["t0"]
    check(codes == [0], f"spatial (f): torchrun exited {codes}:\n{outs[0][0][-2000:]}\n"
                        f"{outs[0][1][-4000:]}")
    paths = {}
    # The encoder probe: the bands' float64 gradients against the whole
    # image's, and the one process's float32 against its float64.
    probe = torch.load(os.path.join(outdir, "probe_rank0.pt"), weights_only=True)
    row = {}
    for name in SPATIAL_PROBE_ENCODERS:
        f64 = {n: g.cpu() for n, g in encoder_probe(torch, name, torch.float64).items()}
        f32 = {n: g.cpu() for n, g in encoder_probe(torch, name, torch.float32).items()}
        row[name] = {"bands_f64_vs_whole_f64": _rel_worst(f64, probe[name]),
                     "whole_f32_vs_whole_f64": _rel_worst(f64, f32)}
        check(row[name]["bands_f64_vs_whole_f64"][0] <= SPATIAL_TRAIN_F64_TOL,
              f"spatial (f) {name} probe: two bands in float64 against the whole image: "
              f"{row[name]}")
    _spatial_print("f) encoders", {"card": card, "shape": list(SPATIAL_PROBE_SHAPE), **row})
    for stage in SPATIAL_TRAIN_STAGES:
        a, stream = ones[stage]
        ranks = _dp_records(os.path.join(outdir, stage), 2)
        grads = [torch.load(r["grads"], weights_only=True) for r in ranks]
        worst, failures = _dp_grad_errs(
            torch, grads[0], a["grad_tensors"], SPATIAL_TRAIN_GRAD_TOL, SPATIAL_TRAIN_FLIPPED,
            SPATIAL_TRAIN_ENCODER_TOL, SPATIAL_TRAIN_CENTRED if stage == "chairs" else (),
            SPATIAL_TRAIN_UPSAMPLER, SPATIAL_TRAIN_UPSAMPLER_TOL)
        a_losses = [s["loss"] for s in a["steps"]]
        losses = [s["loss"] for s in ranks[0]["steps"]]
        loss_rel = [abs(x - y) / abs(y) for x, y in zip(losses, a_losses)]
        colls = [r["summary"]["collectives"] for r in ranks]
        _spatial_print(f"f) {stage}", {
            "card": card, "bn": "trains" if stage == "chairs" else "frozen",
            "losses": losses, "one_process_losses": a_losses, "loss_rel_diff": loss_rel,
            "grad_rel_diff_step1": worst,
            "launches_per_step": [[s["launches"] for s in r["steps"]] for r in ranks],
            "collectives_per_rank": colls,
            "per_rank": [{"rank": r["rank"], "mesh": r["summary"]["mesh"],
                          "step_ms": [s["ms"] for s in r["steps"]],
                          "peak_gib": max(s["peak_gib"] or 0.0 for s in r["steps"])}
                         for r in ranks],
            "one_process_step_ms": [s["ms"] for s in a["steps"]],
            "one_process_peak_gib": max(s["peak_gib"] or 0.0 for s in a["steps"]),
            "one_process_seconds": a["seconds"],
            "note": "two ranks time-slice one card beside the data-parallel phase's (c)-(e): "
                    "not scaling, and their step times are under that load"})
        check(all(torch.equal(grads[0][k], grads[1][k]) for k in grads[0]),
              f"spatial (f) {stage}: the ranks' reduced gradients differ")
        check(not failures, f"spatial (f) {stage}: step-1 gradients against one process: "
                            f"{failures}")
        check(len(losses) == SPATIAL_TRAIN_STEPS
              and [s["loss"] for s in ranks[1]["steps"]] == losses
              and max(loss_rel) <= SPATIAL_TRAIN_LOSS_RTOL,
              f"spatial (f) {stage}: losses {losses} against one process's {a_losses}")
        check(colls[0] == colls[1] and colls[0]["by_op"]["collective-permute"]["count"] > 0
              and colls[0]["by_op"]["reduce-scatter"]["count"] > 0,
              f"spatial (f) {stage}: the ranks' collectives differ or miss a kind: {colls}")
        for r, rec in enumerate(ranks):
            check(rec["host"] == stream and rec["card_equal"],
                  f"spatial (f) {stage}: rank {r}'s batches are not the one-process batches")
            check(all(s["launches"] == DP_WANT for s in rec["steps"]),
                  f"spatial (f) {stage}: rank {r} launched "
                  f"{[s['launches'] for s in rec['steps']]}")
            check(rec["summary"]["mesh"] == SPATIAL_TRAIN_MESH,
                  f"spatial (f) {stage}: rank {r}'s mesh {rec['summary']['mesh']}")
            paths[f"spatial (f) {stage} rank {r}"] = _dp_launches(rec)
    print(f"spatial (f): the ranks took {seconds:.1f} s from their start, the phase "
          f"{time.perf_counter() - t0:.1f} s after the data-parallel phase", flush=True)
    return paths


# --------------------------------------------------------------- pipe axis

PIPE_WORKER = "--pipe_worker"
PIPE_MICRO = 6  # micro-batches of batch 1 in the phase's stream
PIPE_ITERS = 12
PIPE_WORLD = 2
PIPE_MESH = "mesh(data=1,spatial=1,pipe=2:gpu)"
# One hand-off of the flagship's f32 carry at 440x1024, batch 1: net and
# inp (128 channels at 55x128), fmap1 and fmap2 (256) and coords1.
PIPE_CARRY_BYTES = 2 * 3_604_480 + 2 * 7_208_960 + 56_320


def _pipe_pairs(torch, n: int, seed: int = 0) -> list:
    """``n`` Sintel-size pairs edge-padded to 440x1024, each a (1, H, W, 3)
    host tensor (the micro-batches of batch 1)."""
    from raft_ncup_tpu_torch.serve import make_pairs

    return [tuple(t.cpu() for t in padded_batch(torch, [p]))
            for p in make_pairs(SERVE_SIZE, n, seed=seed)]


def pipe_worker(outdir: str, argv: list) -> int:
    """One rank of the pipelined forward (``chip_smoke.py --pipe_worker
    OUTDIR [--micro M] [--iters N] [--device DEV] [--stage_timing]``, under
    the launcher's environment, or alone as one stage): the flagship f32,
    seeded weights, ``M`` micro-batches of batch 1 at 440x1024, S = the
    world's size. A first stream captures the stage programs; a second,
    timed, runs under the runtime guards. Writes ``OUTDIR/rank<RANK>.pt``:
    both streams' launches and collectives, the second's flows, wall
    seconds, per-program device ms and hand-off waits, the guards' counts,
    whether the receive buffers stayed the same, peak bytes; with
    ``--stage_timing`` (one stage) the device ms of the encode, one
    iteration and the finalize, timed alone."""
    import torch

    sys.path.insert(0, HERE)
    from raft_ncup_tpu_torch.analysis import guards
    from raft_ncup_tpu_torch.inference import pipe_schedule
    from raft_ncup_tpu_torch.parallel import mesh as mesh_mod
    from raft_ncup_tpu_torch.parallel import multihost

    opts = {"--micro": str(PIPE_MICRO), "--iters": str(PIPE_ITERS), "--device": None}
    timing_alone = "--stage_timing" in argv
    for i, a in enumerate(argv):
        if a in opts:
            opts[a] = argv[i + 1]
    micro, iters = int(opts["--micro"]), int(opts["--iters"])
    multihost.COLLECTIVE_TIMEOUT_S = DP_COLLECTIVE_TIMEOUT_S
    device = multihost.local_device(opts["--device"])
    torch.cuda.set_device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    joined = world > 1 and multihost.initialize_distributed(device=device)
    rank = multihost.process_index() if joined else 0
    try:
        model = flagship(torch)
        mesh = mesh_mod.make_mesh(1, 1, world, device=device) if world > 1 else None
        pf = pipe_schedule.PipelinedForward(model, mesh=mesh, timing=True)
        pairs = _pipe_pairs(torch, micro)
        rec = {"rank": rank, "world": world, "mesh": mesh_mod.mesh_fingerprint(mesh),
               "backend": multihost.backend(), "micro": micro, "iters": iters}
        for name in ("first", "second"):
            reset_launches()
            mesh_mod.reset_collective_stats()
            compiles = pf.cache.stats["compiles"]
            ptrs = {k: [t.data_ptr() for t in v] for k, v in pf._inputs.items()}
            torch.cuda.synchronize()
            if name == "second":
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            # The second stream under the runtime guards (the native layer
            # raises on an implicit synchronisation); the first captures.
            guard = (guards.forbid_host_transfers() if name == "second"
                     else contextlib.nullcontext(guards.GuardStats()))
            with guards.RecompileWatchdog() as wd, guard as st:
                outs = pf.forward_many(pairs, iters)
                done = torch.cuda.Event()
                done.record()
                done.synchronize()
            seconds = time.perf_counter() - t0
            rec[name] = {
                "seconds": seconds, "pairs_per_sec": micro / seconds,
                "launches": read_launches(), "collectives": mesh_mod.collective_stats(),
                "outputs": pipe_schedule.output_stats(), "timing": pf.last_timing,
                "captures": pf.cache.stats["compiles"] - compiles, "recompiles": wd.count,
                "host_transfers": st.host_transfers, "sanctioned_gets": st.sanctioned_gets,
                "same_buffers": name == "first" or ptrs == {
                    k: [t.data_ptr() for t in v] for k, v in pf._inputs.items()},
                "stats": dict(pf.stats)}
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        rec["flows"] = [tuple(t.cpu() for t in o) for o in outs]
        if timing_alone:
            rec["stage_ms"] = _stage_timing(torch, model, pairs[0])
        torch.save(rec, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        if joined:
            multihost.shutdown()
    return 0


def _stage_timing(torch, model, pair) -> dict:
    """Device ms of the flagship's encode, one refinement iteration and
    the finalize at 440x1024, batch 1, each alone (the median of 10 after
    2 warm runs, CUDA events): the numbers a pipe's gain is predicted
    from."""
    i1, i2 = (t.cuda() for t in pair)
    carry = model.encode(i1, i2)
    runs = {"encode": lambda: model.encode(i1, i2),
            "iteration": lambda: model.refine_segment(carry, 1),
            "finalize": lambda: model.finalize(carry)}
    out = {}
    for name, fn in runs.items():
        ms = []
        for k in range(12):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            if k >= 2:
                ms.append(a.elapsed_time(b))
        out[name] = statistics.median(ms)
    return out


def start_pipe(tmp: str) -> dict:
    """(g)'s two ranks sharing the card (gloo, ``torch.distributed.run``),
    started and not waited for: :func:`check_pipe` waits for them. The
    script starts them beside the train-from-files phase, so their times
    are under its load."""
    outdir = os.path.join(tmp, "g")
    return {"t0": time.perf_counter(), "outdir": outdir,
            "procs": _start_ranks(outdir, DP_CARD, PIPE_WORLD, "gloo", True, None,
                                  PIPE_WORKER)}


def check_pipe(torch, card: str, tmp: str, started: dict) -> dict:
    """(g) The flagship's test-mode forward pipelined over two ranks sharing
    the card (``--mesh 1,1,2``, gloo): every rank's flows of the second
    stream against this process's one-process forward of the same frames
    and weights at the flagship tolerances; each rank's launches per stream
    against the schedule (kernel A ``seg_len`` a micro-batch on both, B 4 a
    micro-batch on rank 1 only); rank 0's hand-offs (one
    ``collective-permute`` of the carry's bytes a micro-batch), one output
    broadcast a micro-batch on both; the second stream with no capture, no
    implicit transfer and the same receive buffers. Returns each rank's
    launches over both streams."""
    t0 = time.perf_counter()
    codes, outs = _wait_ranks(started["procs"])
    check(codes == [0], f"pipe (g): torchrun exited {codes}:\n{outs[0][0][-2000:]}\n"
                        f"{outs[0][1][-4000:]}")
    recs = [torch.load(os.path.join(started["outdir"], f"rank{r}.pt"), weights_only=False)
            for r in range(PIPE_WORLD)]
    model = flagship(torch)
    pairs = _pipe_pairs(torch, PIPE_MICRO)
    want = [model(a.cuda(), b.cuda(), iters=PIPE_ITERS) for a, b in pairs]
    seg_len = PIPE_ITERS // PIPE_WORLD
    paths = {}
    for r, rec in enumerate(recs):
        errs = []
        for (lr, up), (wlr, wup) in zip(rec["flows"], want):
            e_lr, ok_lr = max_err(torch, lr.cuda(), wlr, **FLOW_LR_TOL)
            e_up, ok_up = max_err(torch, up.cuda(), wup, **FLOW_UP_TOL)
            errs.append((e_lr, e_up))
            check(ok_lr and ok_up, f"pipe (g) rank {r}: flows against one process "
                                   f"{e_lr:.3e} / {e_up:.3e}")
        last = r == PIPE_WORLD - 1
        sched = {"corr_lookup": PIPE_MICRO * seg_len, "corr_lookup_bwd": 0,
                 "nconv": 4 * PIPE_MICRO if last else 0, "nconv_bwd": 0}
        second = rec["second"]
        cp = second["collectives"]["by_op"]["collective-permute"]
        row = {"card": card, "rank": r, "mesh": rec["mesh"], "backend": rec["backend"],
               "micro_batches": PIPE_MICRO, "iters": PIPE_ITERS,
               "max_abs_err_lr_up": [max(e[0] for e in errs), max(e[1] for e in errs)],
               "launches_first_stream": rec["first"]["launches"],
               "launches_second_stream": second["launches"], "schedule": sched,
               "handoffs": cp, "outputs": second["outputs"],
               "captures": [rec["first"]["captures"], second["captures"]],
               "second_stream": {k: second[k] for k in ("recompiles", "host_transfers",
                                                        "sanctioned_gets", "same_buffers",
                                                        "pairs_per_sec", "timing")},
               "peak_gib": rec["peak_bytes"] / 2**30,
               "note": "two ranks time-slice one card beside the train-from-files "
                       "phase: not a pipeline's speed"}
        print(f"pipe (g) rank {r}: {json.dumps(row)}", flush=True)
        check(rec["mesh"] == PIPE_MESH and rec["backend"] == "gloo",
              f"pipe (g) rank {r}: mesh {rec['mesh']} backend {rec['backend']}")
        check(second["launches"] == sched, f"pipe (g) rank {r}: launches {second['launches']} "
                                            f"of the second stream, want {sched}")
        check(rec["first"]["launches"]["corr_lookup"] >= sched["corr_lookup"]
              and (rec["first"]["launches"]["nconv"] > 0) == last,
              f"pipe (g) rank {r}: first stream's launches {rec['first']['launches']}")
        check(cp == {"count": 0 if last else PIPE_MICRO,
                     "bytes": 0 if last else PIPE_MICRO * PIPE_CARRY_BYTES},
              f"pipe (g) rank {r}: hand-offs {cp}")
        check(second["outputs"]["broadcasts"] == PIPE_MICRO,
              f"pipe (g) rank {r}: output broadcasts {second['outputs']}")
        check(rec["first"]["captures"] > 0 and second["captures"] == 0
              and second["recompiles"] == 0 and second["host_transfers"] == 0
              and second["same_buffers"],
              f"pipe (g) rank {r}: second stream {row['second_stream']}, captures "
              f"{row['captures']}")
        paths[f"pipe (g) rank {r}"] = {k: rec["first"]["launches"][k]
                                       + second["launches"][k] for k in sched}
    print(f"pipe (g): the ranks took {time.perf_counter() - started['t0']:.1f} s from their "
          f"start, the phase {time.perf_counter() - t0:.1f} s after the PAC phase",
          flush=True)
    del model
    torch.cuda.empty_cache()
    return paths


# ------------------------------------------------------------- PAC and DJIF

PAC_HEADS = ("pac", "djif")
PAC_REQUESTS = 4
PAC_TRAIN_STEPS = 2
PAC_TRAIN = dict(TRAIN_CFG, batch_size=2)  # 400x720, 12 iterations, remat on
PAC_TRAIN_WORKER = "--pac_train_worker"


def pac_model_config(kind: str, plain: bool = False, **kw):
    """The flagship's configuration with the ``kind`` head, through the
    kernels or (``plain``) their plain versions."""
    from raft_ncup_tpu_torch.config import UpsamplerConfig

    impl = (dict(corr_impl="onthefly", nconv_impl="xla") if plain
            else dict(corr_impl="pallas", nconv_impl="pallas"))
    return model_config("raft_nc_dbl", False, upsampler=UpsamplerConfig(kind=kind), **impl,
                        **kw)


def pac_train_worker(outdir: str, argv: list) -> int:
    """``chip_smoke.py --pac_train_worker OUTDIR``: ``PAC_TRAIN_STEPS`` train
    steps of the flagship with each head at 400x720, batch 2, 12
    iterations, remat on, every kernel count set to 0 before each head's
    steps; writes ``OUTDIR/pac_train.json`` (losses, ms a step, peak bytes,
    launches, plain-version calls) for :func:`check_pac` to judge."""
    import torch

    sys.path.insert(0, HERE)
    from raft_ncup_tpu_torch.config import TrainConfig
    from raft_ncup_tpu_torch.data.synthetic import SyntheticFlowDataset
    from raft_ncup_tpu_torch.training.state import create_train_state
    from raft_ncup_tpu_torch.training.step import make_train_step

    rows = {}
    for kind in PAC_HEADS:
        tcfg = TrainConfig(**PAC_TRAIN)
        state = create_train_state(pac_model_config(kind, dataset=tcfg.stage), tcfg, "cuda")
        data = SyntheticFlowDataset(tcfg.image_size, seed=tcfg.seed)
        batches = [data.batch(i, tcfg.batch_size, "cuda") for i in range(PAC_TRAIN_STEPS)]
        step = make_train_step(tcfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        losses, step_ms = [], []
        with counting_plain_versions() as plain_calls:
            for batch in batches:
                t0 = time.perf_counter()
                metrics = step(state, batch)
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t0))
                losses.append(float(metrics["loss"]))
        rows[kind] = {"train": f"batch {tcfg.batch_size} at {tcfg.image_size[0]}x"
                               f"{tcfg.image_size[1]}, {tcfg.iters} iterations, remat on",
                      "iters": tcfg.iters, "losses": losses, "step_ms": step_ms,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "launches": read_launches(), "plain_version_calls": dict(plain_calls)}
        del state, batches
        torch.cuda.empty_cache()
    with open(os.path.join(outdir, "pac_train.json"), "w") as fh:
        json.dump(rows, fh)
    return 0


def start_pac_train(tmp: str) -> dict:
    """The PAC and DJIF train steps in a process of their own, started and
    not waited for (:func:`check_pac` waits); the script starts it beside
    the train-from-files phase, whose loader leaves the card idle."""
    return {"t0": time.perf_counter(), "outdir": tmp,
            "procs": [subprocess.Popen([sys.executable, os.path.join(HERE, "chip_smoke.py"),
                                        PAC_TRAIN_WORKER, tmp], cwd=HERE,
                                       env=dict(os.environ, PYTHONPATH=HERE),
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True)]}


def check_pac(torch, card, started: dict) -> dict:
    """The flagship with each of the PAC and DJIF heads
    (``--final_upsampling PacJointUpsampleFull | DjifOriginal``): served
    through the serve entry's ``serve_pairs`` (``PAC_REQUESTS`` requests at
    436x1024, batch sizes 1 and 2, level 12, graph replays), every answer
    finite and one against the plain-version forward at the flagship
    tolerances, kernel A 12 launches a batch and kernel B none; then the
    ``PAC_TRAIN_STEPS`` train steps of each (``started`` by
    :func:`start_pac_train`): finite losses, no plain version called, A 24
    and A' 12 launches a step and no B or B'. Returns each run's launches."""
    from raft_ncup_tpu_torch.config import ServeConfig
    from raft_ncup_tpu_torch.models.raft import RAFT
    from raft_ncup_tpu_torch.ops.padding import InputPadder
    from raft_ncup_tpu_torch.serve import make_pairs, serve_pairs

    paths, rows = {}, {}
    none = {"corr_lookup_bwd": 0, "nconv": 0, "nconv_bwd": 0}
    for kind in PAC_HEADS:
        model = RAFT(pac_model_config(kind), device="cuda", seed=0)
        cfg = ServeConfig(batch_sizes=(1, 2), iter_levels=(12,), queue_capacity=16)
        pairs = make_pairs(SERVE_SIZE, PAC_REQUESTS, seed=0)
        reset_launches()
        t0 = time.perf_counter()
        report, responses = serve_pairs(model, cfg, pairs, SERVE_SIZE)
        torch.cuda.synchronize()
        launches = read_launches()
        serve_s = time.perf_counter() - t0
        check(report["errors"] == 0 and all(r.ok for r in responses),
              f"serve {kind}: {[r.detail for r in responses if not r.ok]}")
        check(all(r.flow.shape == (*SERVE_SIZE, 2)
                  and bool(torch.isfinite(torch.from_numpy(r.flow)).all()) for r in responses),
              f"serve {kind}: a flow of the wrong shape or not finite")
        per_batch = report["corr_kernel_launches"] / report["serve_batches"]
        check(per_batch == 12 and launches["corr_lookup"] > 0
              and {k: launches[k] for k in none} == none,
              f"serve {kind}: launches {launches}, {per_batch} lookups a batch")
        plain = RAFT(pac_model_config(kind, plain=True), device="cuda", seed=0)
        plain.load_state_dict(model.state_dict(), strict=True)
        padder = InputPadder((*SERVE_SIZE, 3), mode="sintel")
        p1, p2 = padder.pad(*(torch.from_numpy(x)[None].cuda() for x in pairs[0]))
        lr_p, up_p = plain(p1, p2, iters=12)
        lr_k, _ = model(p1, p2, iters=12)
        e_lr, ok_lr = max_err(torch, lr_k, lr_p, **FLOW_LR_TOL)
        e_up, ok_up = max_err(torch, torch.from_numpy(responses[0].flow).cuda(),
                              padder.unpad(up_p)[0], **FLOW_UP_TOL)
        check(ok_lr and ok_up, f"serve {kind}: against the plain versions {e_lr} / {e_up}")
        paths[f"serve raft_nc_dbl {kind}"] = launches
        rows[kind] = {"card": card, "head": kind,
                      "serve_pairs_per_sec": report["serve_pairs_per_sec"],
                      "serve_p50_ms": report["serve_p50_ms"], "serve_seconds": serve_s,
                      "serve_launches": launches, "max_abs_err_vs_plain": [e_lr, e_up]}
        del plain, model
        torch.cuda.empty_cache()
    codes, outs = _wait_ranks(started["procs"])
    check(codes == [0], f"pac: the train worker exited {codes}:\n{outs[0][1][-4000:]}")
    with open(os.path.join(started["outdir"], "pac_train.json")) as fh:
        trained = started["trained"] = json.load(fh)
    for kind in PAC_HEADS:
        t = trained[kind]
        per_step = {k: v / PAC_TRAIN_STEPS for k, v in t["launches"].items()}
        want = {"corr_lookup": 2 * t["iters"], "corr_lookup_bwd": t["iters"], "nconv": 0,
                "nconv_bwd": 0}
        print(f"pac {kind}: {json.dumps({**rows[kind], **t, 'launches_per_step': per_step})}",
              flush=True)
        check(not t["plain_version_calls"], f"train {kind}: plain versions ran: "
                                            f"{t['plain_version_calls']}")
        check(all(math.isfinite(x) for x in t["losses"]), f"train {kind}: losses {t['losses']}")
        check(per_step == want, f"train {kind}: launches a step {per_step}, want {want}")
        paths[f"train raft_nc_dbl {kind}"] = t["launches"]
    print(f"pac: the train worker took {time.perf_counter() - started['t0']:.1f} s from its "
          "start", flush=True)
    return paths

# ------------------------------------------------------- PAC on bands (i)
# The PAC and DJIF heads and the bf16 preset on a band of rows (item 9b-vi):
# one world of two gloo ranks sharing the card runs the serve entry over the
# mesh (1, 2) with each head and with the flagship under bf16_infer, then
# two PAC train steps over the mesh. The ranks start beside train from
# files, where the loader leaves the card idle; their train steps wait for
# the PAC train worker's record (its 20.5 GiB gone before theirs come), and
# the script judges them last.
PAC_MESH_WORKER = "--pac_mesh_worker"
PAC_MESH_AFTER = "--train_after"
PAC_MESH_LEVEL = 4  # few iterations: the band, not the loop, is under test
PAC_MESH_REQUESTS = 4
PAC_MESH_TOL = dict(atol=1e-4, rtol=0.0)
PAC_MESH_SERVE_ARGS = ["--model", "raft_nc_dbl", "--size", str(SERVE_SIZE[0]),
                       str(SERVE_SIZE[1]), "--seed", "0", "--serve_batch_sizes", "2",
                       "--iter_levels", str(PAC_MESH_LEVEL), "--num_requests",
                       str(PAC_MESH_REQUESTS), "--burst_size", str(PAC_MESH_REQUESTS),
                       "--queue_capacity", "16", "--serve_pad_bucket", str(SPATIAL_BUCKET),
                       "--flight_dir", "", *DP_CARD, "--mesh", "1,2"]
PAC_MESH_RUNS = {  # in this order, in one world; then the PAC train steps
    "pac": [*PAC_MESH_SERVE_ARGS, "--final_upsampling", "PacJointUpsampleFull"],
    "djif": [*PAC_MESH_SERVE_ARGS, "--final_upsampling", "DjifOriginal"],
    "bf16_infer": [*PAC_MESH_SERVE_ARGS, "--serve_precision", "bf16_infer"],
}


def pac_mesh_worker(outdir: str, argv: list) -> int:
    """One rank of (i) (``chip_smoke.py --pac_mesh_worker OUTDIR
    --train_after PATH <serve flags> [--then <serve flags> ...]``, under the
    launcher's environment): :func:`mixed_worker`'s serve runs, then, once
    ``PATH`` exists, :func:`_pac_mesh_train`, every call of a kernel's plain
    version counted over both."""
    after = argv[argv.index(PAC_MESH_AFTER) + 1]
    argv = [a for a in argv if a not in (PAC_MESH_AFTER, after)]
    with counting_plain_versions() as plain:
        return mixed_worker(outdir, argv, after=lambda *a: _pac_mesh_train(*a, plain, after))


def _pac_mesh_train(torch, outdir: str, rank: int, device, plain: dict, after: str) -> int:
    """``PAC_TRAIN_STEPS`` train steps of the flagship with the PAC head over
    the mesh (1, 2), the configuration and batches of
    :func:`pac_train_worker` (400x720, batch 2, 12 iterations, remat on),
    once the file ``after`` exists (that worker's record: its memory is
    free), every kernel count set to 0 before them; writes
    ``OUTDIR/rank<R>_train.json`` (losses, ms a step, this rank's peak
    bytes, launches, collectives, and the plain-version calls of the whole
    worker)."""
    from raft_ncup_tpu_torch.config import TrainConfig
    from raft_ncup_tpu_torch.data.synthetic import SyntheticFlowDataset
    from raft_ncup_tpu_torch.parallel import mesh as mesh_mod
    from raft_ncup_tpu_torch.training.state import create_train_state
    from raft_ncup_tpu_torch.training.step import make_train_step

    deadline = time.perf_counter() + DP_TIMEOUT_S
    while not os.path.exists(after):
        if time.perf_counter() > deadline:
            print(f"pac_mesh_worker: no {after} after {DP_TIMEOUT_S} s", file=sys.stderr)
            return 1
        time.sleep(1.0)
    tcfg = TrainConfig(**PAC_TRAIN)
    mesh = mesh_mod.make_mesh(1, 2, device=device)
    state = create_train_state(pac_model_config("pac", dataset=tcfg.stage), tcfg, device)
    data = SyntheticFlowDataset(tcfg.image_size, seed=tcfg.seed)
    batches = [data.batch(i, tcfg.batch_size, device) for i in range(PAC_TRAIN_STEPS)]
    step = make_train_step(tcfg, mesh=mesh)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    mesh_mod.reset_collective_stats()
    losses, step_ms = [], []
    for batch in batches:
        t0 = time.perf_counter()
        metrics = step(state, batch)
        torch.cuda.synchronize(device)
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(metrics["loss"]))
    row = {"iters": tcfg.iters, "losses": losses, "step_ms": step_ms,
           "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30,
           "launches": read_launches(), "collectives": mesh_mod.collective_stats(),
           "mesh": mesh_mod.mesh_fingerprint(mesh), "plain_version_calls": dict(plain)}
    with open(os.path.join(outdir, f"rank{rank}_train.json"), "w") as fh:
        json.dump(row, fh)
    return 0


def start_pac_mesh(tmp: str, after: str) -> dict:
    """(i)'s two ranks, started and not waited for (:func:`check_pac_mesh`
    waits); their train steps start once the file ``after`` (the PAC train
    worker's record) exists."""
    outdir = os.path.join(tmp, "i")
    argv = [PAC_MESH_AFTER, after]
    for k, run in enumerate(PAC_MESH_RUNS.values()):
        argv += (["--then"] if k else []) + run
    return {"t0": time.perf_counter(), "outdir": outdir,
            "procs": _start_ranks(outdir, argv, 2, "gloo", worker=PAC_MESH_WORKER)}


def _pac_mesh_refs(torch) -> dict:
    """This process's one-process answers of (i)'s runs: the burst's pairs
    through a server of each run's model (batch size 2, the level, the pad
    bucket of 16: the mesh's 448 rows)."""
    from raft_ncup_tpu_torch.config import ServeConfig
    from raft_ncup_tpu_torch.models.raft import RAFT
    from raft_ncup_tpu_torch.serving import FlowServer, SyntheticTraffic

    pairs = [(a, b) for _, a, b in SyntheticTraffic(SERVE_SIZE, PAC_MESH_REQUESTS, seed=0)]
    refs = {}
    for run in PAC_MESH_RUNS:
        model = (flagship(torch) if run == "bf16_infer"
                 else RAFT(pac_model_config(run), device="cuda", seed=0))
        server = FlowServer(model, ServeConfig(
            batch_sizes=(2,), iter_levels=(PAC_MESH_LEVEL,), queue_capacity=16,
            pad_bucket=SPATIAL_BUCKET, precision="bf16_infer" if run == "bf16_infer" else None))
        refs[run] = {PAC_MESH_LEVEL: paused_burst(server, pairs)[0]}
        server.drain()
        del model, server
        torch.cuda.empty_cache()
    return refs


def check_pac_mesh(torch, card: str, started: dict, one_process: dict) -> dict:
    """(i) The serve entry over the mesh (1, 2) with the PAC head, the DJIF
    head and the flagship under bf16_infer, then two PAC train steps over
    it, in one world of two ranks: every rank exits 0 and names the mesh;
    every rank's answers (cut from its own forwards) within ``PAC_MESH_TOL``
    of this process's one-process server (the bf16 run's within
    ``FORWARD_EPE_BUDGET`` in mean EPE: its bands round bf16 at other
    places); A ``PAC_MESH_LEVEL`` a batch on every rank, B none with a head
    and 4 a batch with NCUP; the train steps' losses equal on both ranks
    and within ``SPATIAL_TRAIN_LOSS_RTOL`` of the PAC phase's one process
    (``one_process``, its ``pac_train.json``), A 24 and A' 12 a step, no B
    or B', each rank's peak bytes beside one process's; no plain version
    called in the worker. Returns each rank's launches by run."""
    from raft_ncup_tpu_torch.precision import FORWARD_EPE_BUDGET

    t0 = time.perf_counter()
    codes, _ = _wait_ranks(started["procs"])
    outdir = started["outdir"]
    if codes != [0, 0]:
        tails = []
        for r in range(2):
            path = os.path.join(outdir, f"rank{r}.log")
            if os.path.exists(path):
                with open(path) as fh:
                    tails.append(f"rank {r}: {fh.read()[-3000:]}")
        check(False, f"pac (i): exits {codes}:\n" + "\n".join(tails))
    ranks_s = time.perf_counter() - started["t0"]
    recs = {run: [torch.load(os.path.join(outdir, f"rank{r}_{k}.pt"), weights_only=False)
                  for r in range(2)] for k, run in enumerate(PAC_MESH_RUNS)}
    want = _pac_mesh_refs(torch)
    paths = {}
    for run, rs in recs.items():
        reps = [r["report"] for r in rs]
        batches = reps[0]["serve_batches"]
        check(all(r["rc"] == 0 for r in rs) and reps[1].get("follower")
              and all(rep["mesh"] == SPATIAL_MESH for rep in reps)
              and all(rep["lockstep_ops"].get("serve") == batches for rep in reps),
              f"pac (i) {run}: meshes {[rep.get('mesh') for rep in reps]}, ops "
              f"{[rep.get('lockstep_ops') for rep in reps]}")
        bf16 = run == "bf16_infer"
        answers = _mixed_answers(torch, rs, want[run], f"pac (i) {run}", n=PAC_MESH_REQUESTS,
                                 tol=PAC_MESH_TOL,
                                 epe_budget=FORWARD_EPE_BUDGET if bf16 else None)
        for r, rep in enumerate(reps):
            launches = {"corr_lookup": rep["corr_kernel_launches"], "corr_lookup_bwd": 0,
                        "nconv": rep["nconv_kernel_launches"], "nconv_bwd": 0}
            want_l = {"corr_lookup": PAC_MESH_LEVEL * batches, "corr_lookup_bwd": 0,
                      "nconv": 4 * batches if bf16 else 0, "nconv_bwd": 0}
            check(batches > 0 and launches == want_l,
                  f"pac (i) {run} rank {r}: launches {launches}, want {want_l}")
            paths[f"pac (i) {run} rank {r}"] = launches
        row = {"card": card, "mesh": SPATIAL_MESH, "answers": answers, "batches": batches,
               "level": PAC_MESH_LEVEL, "seconds": [r["seconds"] for r in rs],
               "warmup_s": reps[0]["warmup_s"],
               "serve_pairs_per_sec": reps[0]["serve_pairs_per_sec"],
               **{k: reps[0][f"serve_{k}"] for k in ("wall_s", "p50_ms", "p99_ms")},
               "launches": [paths[f"pac (i) {run} rank {r}"] for r in range(2)],
               "collectives": [rep["collectives"] for rep in reps],
               "note": "two ranks time-slice one card beside other phases: not a mesh's speed"}
        print(f"pac (i) {run}: {json.dumps(row)}", flush=True)
    trained = []
    for r in range(2):
        with open(os.path.join(outdir, f"rank{r}_train.json")) as fh:
            trained.append(json.load(fh))
    one = one_process["pac"]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(trained[0]["losses"], one["losses"])]
    want_step = {"corr_lookup": 2 * one["iters"], "corr_lookup_bwd": one["iters"], "nconv": 0,
                 "nconv_bwd": 0}
    for r, t in enumerate(trained):
        per_step = {k: v / PAC_TRAIN_STEPS for k, v in t["launches"].items()}
        check(not t["plain_version_calls"], f"pac (i) rank {r}: plain versions ran: "
                                            f"{t['plain_version_calls']}")
        check(per_step == want_step and t["mesh"] == SPATIAL_MESH,
              f"pac (i) train rank {r}: launches a step {per_step}, want {want_step}, "
              f"mesh {t['mesh']}")
        paths[f"pac (i) train rank {r}"] = t["launches"]
    check(trained[0]["losses"] == trained[1]["losses"]
          and len(loss_rel) == PAC_TRAIN_STEPS and max(loss_rel) <= SPATIAL_TRAIN_LOSS_RTOL,
          f"pac (i) train: losses {[t['losses'] for t in trained]} against one process's "
          f"{one['losses']}")
    check(trained[0]["collectives"] == trained[1]["collectives"]
          and trained[0]["collectives"]["by_op"]["collective-permute"]["count"] > 0,
          f"pac (i) train: the ranks' collectives differ: "
          f"{[t['collectives'] for t in trained]}")
    row = {"card": card, "mesh": SPATIAL_MESH, "train": one["train"],
           "losses": trained[0]["losses"], "one_process_losses": one["losses"],
           "loss_rel_diff": loss_rel,
           "per_rank": [{"rank": r, "step_ms": t["step_ms"], "peak_gib": t["peak_gib"],
                         "launches": t["launches"], "collectives": t["collectives"]}
                        for r, t in enumerate(trained)],
           "one_process_peak_gib": one["peak_gib"], "one_process_step_ms": one["step_ms"],
           "peak_share_of_one_process": [t["peak_gib"] / one["peak_gib"] for t in trained],
           "note": "two ranks time-slice one card beside other phases: peak bytes per rank, "
                   "not a mesh's speed"}
    print(f"pac (i) train: {json.dumps(row)}", flush=True)
    print(f"pac (i): the ranks took {ranks_s:.1f} s from their start, the check "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return paths


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
    lap = _PhaseClock()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}",
          flush=True)

    import threading

    from raft_ncup_tpu_torch.io import codec_build

    t0 = time.perf_counter()
    lint = start_lint()
    codec_result = {}

    def build_codecs():
        try:
            codec_result["seconds"] = codec_build.build()
        except Exception as e:  # reported on the main thread
            codec_result["error"] = e

    codec_thread = threading.Thread(target=build_codecs)
    codec_thread.start()
    seconds = cuda_build.build()
    codec_thread.join()
    if "error" in codec_result:
        raise codec_result["error"]
    print(f"build: {time.perf_counter() - t0:.2f} s wall, per kernel {seconds}, "
          f"host decoders {codec_result['seconds']}", flush=True)
    for name in cuda_build.KERNELS:
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    lap("build")
    check_lint(lint)
    check_codecs(card)

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
    lap("codecs and kernels alone")

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
    lap("serve and profile")
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
    lap("evaluate and entries")
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
    lap("stages, early exit and stream")
    # Telemetry: the serve entry with every output on (plain and --stream
    # branches, under chaos), no synchronisation, its overhead and the cost
    # ledger's MFU.
    with tempfile.TemporaryDirectory() as tmp:
        paths.update(check_telemetry(torch, card, tmp))
    lap("telemetry")
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
    lap("train")
    # The flagship trained from files through the train entry (loader,
    # augmentation, device prefetch, validation, checkpoints, chaos). Beside
    # it, where the loader leaves the card idle, the PAC and DJIF train
    # steps and the pipe phase's two ranks, judged later.
    pac_tmp, g_tmp = tempfile.TemporaryDirectory(), tempfile.TemporaryDirectory()
    h_tmp = tempfile.TemporaryDirectory()
    pac_train, g_ranks = start_pac_train(pac_tmp.name), start_pipe(g_tmp.name)
    h_ranks = start_mixed(h_tmp.name)
    i_tmp = tempfile.TemporaryDirectory()
    i_ranks = start_pac_mesh(i_tmp.name, os.path.join(pac_tmp.name, "pac_train.json"))
    with tempfile.TemporaryDirectory() as tmp:
        paths.update(check_train_files(torch, card, tmp,
                                       train[f"median_ms_steps_2_to_{TRAIN_STEPS}"]))
        paths["telemetry profile_steps"] = check_profile_steps(
            torch, card, tmp, os.path.join(tmp, "Sintel"))
    lap("train from files")
    # Pipelined serving and streaming against the waiting server and engine,
    # each under the runtime guards, and the train entry's --strict_guards.
    for phase in (check_pipelined_serve, check_pipelined_stream):
        paths.update(phase(torch, card)[1])
    with tempfile.TemporaryDirectory() as tmp:
        paths["train strict_guards"] = check_strict_guards(torch, card, tmp)
    lap("pipelined and strict guards")
    # Fleet replicas: two flagship replica processes of the serve entry on
    # the card behind the router, under chaos; each replica's launches come
    # from its own report.
    with tempfile.TemporaryDirectory() as tmp:
        paths.update(check_fleet(torch, card, tmp)[1])
    lap("fleet")
    # Data parallelism: one process against two ranks on the one card
    # (gloo), agreed preemption, NCCL and sharded validation; each rank's
    # launches come from its own record.
    # Its (c)-(e) run beside the two ranks of the spatial training phase,
    # which are started once (b) is done and held right after.
    f_tmp = tempfile.TemporaryDirectory()
    f_ranks = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths.update(check_data_parallel(
            torch, card, tmp, after_b=lambda: f_ranks.update(start_spatial_train(f_tmp.name))))
    lap("data parallel")
    # Spatial training: the flagship's train step split by rows over two
    # ranks sharing the card, at stage chairs and stage things, against one
    # process; each rank's launches from its own record.
    with f_tmp:
        paths.update(check_spatial_train(torch, card, f_tmp.name, f_ranks))
    lap("spatial training")
    # The PAC and DJIF heads: the flagship with each, served here; their
    # train steps' records. The pipe axis: the flagship's forward pipelined
    # over two ranks sharing the card (--mesh 1,1,2), held against one
    # process; each rank's launches from its own record.
    with pac_tmp:
        paths.update(check_pac(torch, card, pac_train))
    lap("pac")
    with g_tmp:
        paths.update(check_pipe(torch, card, g_tmp.name, g_ranks))
    lap("pipe")
    # The spatial axis: the flagship's whole forward at 1088x1920 and
    # 2176x3840 in one process, then split by rows over two ranks sharing
    # the card (gloo), and sharded evaluation; each rank's launches come
    # from its own report.
    with tempfile.TemporaryDirectory() as tmp:
        paths.update(check_spatial(torch, card, tmp))
    lap("spatial")
    # Spatial serving: the serve entry over the mesh (1, 2) as two ranks
    # sharing the card (plain, --stream, early exit) and a fleet slot of
    # two ranks, against one process; each rank's launches from its own
    # report.
    with tempfile.TemporaryDirectory() as tmp:
        paths.update(check_spatial_serving(torch, card, tmp))
    lap("spatial serving")
    # A pipe axis beside a data or spatial axis: the serve entry over the
    # meshes (1, 2, 2) and (2, 1, 2) in one world of four ranks sharing the
    # card (started beside train from files), every pipe index's answers
    # against one process; each rank's launches from its own report.
    with h_tmp:
        paths.update(check_mixed(torch, card, h_ranks))
    lap("mixed (h)")
    # The PAC and DJIF heads and bf16_infer on a band of rows: the serve
    # entry over the mesh (1, 2) and two PAC train steps over it, in one
    # world of two ranks sharing the card (started beside train from files),
    # against this process and the PAC phase's one process; each rank's
    # launches from its own report and record.
    with i_tmp:
        paths.update(check_pac_mesh(torch, card, i_ranks, pac_train["trained"]))
    lap("pac (i)")
    print(f"phases: {json.dumps(lap.seconds)}, total {sum(lap.seconds.values()):.1f} s",
          flush=True)

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
    sources = {"corr_lookup.cu": "corr_lookup", "corr_lookup_bwd.cu": "corr_lookup_bwd",
               "nconv.cu": "nconv", "nconv_bwd.cu": "nconv_bwd"}
    for k in kernels:
        name = sources[os.path.basename(k["source"])]
        k["data_parallel_launches_per_rank"] = [
            paths[f"data parallel (b) rank {r}"][name] for r in range(2)]
        k["data_parallel_steps"] = DP_STEPS
        k["spatial_one_process_launches"] = {
            f"{h}x{w}": paths[f"spatial (a) {h}x{w}"][name] for h, w in SPATIAL_SIZES}
        k["spatial_launches_per_rank"] = [paths[f"spatial (b) rank {r}"][name] for r in range(2)]
        k["spatial_serving_launches_per_rank"] = {
            run: [paths[f"{run} rank {r}"][name] for r in range(2)]
            for run in ("spatial (d) serve", "spatial (d) stream", "spatial (e) replica")}
        k["spatial_train_launches_per_rank"] = {
            stage: [paths[f"spatial (f) {stage} rank {r}"][name] for r in range(2)]
            for stage in SPATIAL_TRAIN_STAGES}
        k["spatial_train_steps"] = SPATIAL_TRAIN_STEPS
        k["pipe_launches_per_rank"] = [paths[f"pipe (g) rank {r}"][name]
                                       for r in range(PIPE_WORLD)]
        k["pac_launches"] = {f"{run} {kind}": paths[f"{run} raft_nc_dbl {kind}"][name]
                             for run in ("serve", "train") for kind in PAC_HEADS}
        k["mixed_launches_per_rank"] = {run: [paths[f"mixed (h) {run} rank {r}"][name]
                                              for r in range(MIXED_WORLD)]
                                        for run in MIXED_RUNS}
        k["pac_mesh_launches_per_rank"] = {run: [paths[f"pac (i) {run} rank {r}"][name]
                                                 for r in range(2)]
                                           for run in (*PAC_MESH_RUNS, "train")}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


class _PhaseClock:
    """``lap(name)``: the seconds since the previous lap (or since it was
    made), kept in ``seconds`` and printed as ``phase NAME: S s``."""

    def __init__(self):
        self.seconds: dict = {}
        self._last = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = round(now - self._last, 1)
        self._last = now
        print(f"phase {name}: {self.seconds[name]} s", flush=True)


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
    if len(sys.argv) > 2 and sys.argv[1] == DP_WORKER:
        sys.exit(dp_worker(sys.argv[2], sys.argv[3:]))
    if len(sys.argv) > 2 and sys.argv[1] == SERVE_WORKER:
        sys.exit(serve_worker(sys.argv[2], sys.argv[3:]))
    if len(sys.argv) > 2 and sys.argv[1] == SPATIAL_TRAIN_WORKER:
        sys.exit(spatial_train_worker(sys.argv[2], sys.argv[3:]))
    if len(sys.argv) > 2 and sys.argv[1] == PIPE_WORKER:
        sys.exit(pipe_worker(sys.argv[2], sys.argv[3:]))
    if len(sys.argv) > 2 and sys.argv[1] == PAC_TRAIN_WORKER:
        sys.exit(pac_train_worker(sys.argv[2], sys.argv[3:]))
    if len(sys.argv) > 2 and sys.argv[1] == MIXED_WORKER:
        sys.exit(mixed_worker(sys.argv[2], sys.argv[3:]))
    if len(sys.argv) > 2 and sys.argv[1] == PAC_MESH_WORKER:
        sys.exit(pac_mesh_worker(sys.argv[2], sys.argv[3:]))
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
