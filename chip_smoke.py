#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of the repository: ``python3 chip_smoke.py``. It

1. prints the card's name and power limit (the slice is f32: the model's
   forward, the train step and the plain versions keep TF32 off
   themselves);
2. builds the four hand-written kernels from ``raft_ncup_tpu_torch/csrc``,
   all ``nvcc`` processes at once;
3. holds the correlation-lookup kernel (A) against its plain PyTorch
   version at the served shape (batch 2, 55x128 level 0, C=256, 4 levels,
   r=4) with random and with smooth flow, at 1088x1920 (136x240 level 0)
   and at 2176x3840 (272x480), with CUDA-event times, the bound of each row
   and the tiles that took each of the kernel's two paths (checked against
   ``corr_cuda.tile_paths``); then at edge cases (C 4 to 512, radius 0 to
   8, odd levels down to 1x1, windows off every side);
4. holds the fused NConv2d kernel (B) against its plain version at the
   four NCUP layer shapes of one served batch of two (4 folded planes of
   440x1024) and at edge cases (every k, Cout 8, bias, ragged, tiny and
   misaligned planes);
5. holds the lookup (A) and its backward kernel (A') against the plain
   lookup and its autograd at the training shape (batch 6, 50x90, C=256,
   4 levels, r=4) with random and smooth flow (d f1s, each d f2 level,
   d coords), with A''s device counts (tiles per path, d f2 row adds)
   against ``corr_cuda.backward_work``, then A' at edge cases with and
   without d coords; and the NConv2d (B) and its backward kernel (B')
   against their plain versions at the four NCUP layers of a training
   batch (12 planes of 400x720), B' also at edge cases, with the NaN
   places of windows without confidence, and twice on the same inputs
   with bit-equal d weight and d bias; then checks
   that the wrappers raise on CUDA inputs their kernels do not take (other
   dtypes, strided layouts), with or without a gradient;
6. serves 8 Sintel-size (436x1024) requests through ``FlowServer`` with
   the flagship model on the card, checks every answer, checks that both
   forward kernels ran while serving, and holds one served pair against
   the same model run through the plain versions;
7. traces forwards of the served model at batch 2 with ``torch.profiler``
   and prints where the device time goes (wall and device ms per
   forward, idle share, time per kernel group, the top kernels);
8. trains the flagship 5 steps at ``scripts/train_raft_nc_things.sh``'s
   configuration (batch 6 at 400x720, 12 iterations, remat on) through
   all four kernels: finite losses, no step skipped, no plain version
   called, each kernel launched as often as the step's structure says
   (A 24, A' 12, B 96, B' 48 a step); ms per step, peak memory with remat on
   and off, and a trace of one step split by its forward, backward and
   optimizer ranges (its ``train:`` line);
9. holds one train step through the kernels against the same step
   through the plain versions at batch 2, 400x720: the loss and every
   gradient;
10. prints one JSON line describing the kernels, the card's name and
    power limit, and, last, the JSON result line.

Any failed check exits non-zero before the last line. With no CUDA
device it exits non-zero at once; it never falls back to the CPU.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
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


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


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


def corr_inputs(torch, gen, B, H, W, C, levels, mix="random"):
    """Feature maps, and coords = grid + a ``random_flow`` or a
    ``smooth_flow``."""
    from raft_ncup_tpu_torch.ops.corr_cuda import prepare_levels

    f1 = torch.randn(B, H, W, C, generator=gen)
    f2 = torch.randn(B, H, W, C, generator=gen)
    y, x = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    grid = torch.stack([x, y], -1).float()[None].expand(B, H, W, 2)
    flow = (smooth_flow if mix == "smooth" else random_flow)(torch, gen, B, H, W)
    coords = (grid + flow).contiguous().cuda()
    f1s, lv = prepare_levels(f1.cuda(), f2.cuda(), levels)
    return f1s, lv, coords


def corr_work(torch, f1s, lv, coords, radius):
    """(bytes, flops) the lookup needs for these inputs: every input read
    once and the output written once; two flops per multiply-add of the
    dot products at in-bounds patch positions (out-of-bounds ones need
    none), plus 7 per output tap for the bilinear blend."""
    B, H, W, C = f1s.shape
    K = 2 * radius + 1
    n_out = B * H * W * len(lv) * K * K
    nbytes = 4 * (f1s.numel() + coords.numel() + sum(t.numel() for t in lv) + n_out)
    k1 = torch.arange(K + 1, device=coords.device, dtype=torch.float32)
    positions = 0
    for l, t in enumerate(lv):
        hl, wl = t.shape[1], t.shape[2]
        p = coords.reshape(-1, 2) / float(2 ** l)
        o = torch.floor(p) - radius
        ix = o[:, 0:1] + k1
        iy = o[:, 1:2] + k1
        cx = ((ix >= 0) & (ix < wl)).sum(1)
        cy = ((iy >= 0) & (iy < hl)).sum(1)
        positions += int((cx * cy).sum())
    return nbytes, 2 * C * positions + 7 * n_out


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
               mix="random", plain_reps=3):
    from raft_ncup_tpu_torch.ops.corr_cuda import lookup_levels, lookup_pyramid

    f1s, lv, coords = corr_inputs(torch, gen, B, H, W, C, levels, mix)
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
    row = dict(
        shape=f"B={B} level0={H}x{W} C={C} L={levels} r={radius} {mix} flow",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes, flops=flops,
        bound_ms=max(t_bytes, t_ops),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        check_launches=lookup_levels.launches - launches0,
        path_tiles=paths,
    )
    print(f"kernel A {name}: {row['shape']}: max|kernel-plain| {err:.3e} "
          f"(atol {CORR_TOL['atol']}) kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
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
    """(bytes, flops): data, conf, weight read once, out and conf_out
    written once; per in-bounds tap and input channel one multiply
    (data*conf) and two multiply-adds per output channel, plus a divide,
    a bias add and a scale per output."""
    p = k // 2

    def along(n):  # in-bounds taps along one axis of n pixels
        return sum(max(0, n - abs(d)) for d in range(-p, p + 1))

    taps = along(H) * along(W)  # in-bounds, per plane
    nbytes = 4 * (2 * B * cin * H * W + cout * cin * k * k + 2 * B * cout * H * W)
    flops = B * cin * taps * (1 + 4 * cout) + 3 * B * cout * H * W
    return nbytes, flops


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
TRAIN_PLANES = (12, 400, 720)  # NCUP folds the 2 flow channels of 6 pairs
# Gradients against their plain versions, relative to the largest value of
# each plain gradient: sums in another order, and with float atomics in an
# order that changes from run to run. Kernel B' is held against its plain
# version run in float64 (its NaN and infinite places against the float32
# run): cuDNN's float32 weight gradient on small planes is itself off by up
# to 2.1e-3 of its largest value, while the kernel stays within 1e-6. On
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


def corr_bwd_inputs(torch, gen, mix):
    """Kernel A''s inputs at the training shape: f1s, the pyramid, coords
    with ``mix`` flow, and the upstream gradient of the lookup."""
    s = TRAIN_CORR
    f1s, lv, coords = corr_inputs(torch, gen, s["B"], s["H"], s["W"], s["C"],
                                  s["levels"], mix)
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


def check_corr_bwd(torch, gen, flush, mix, plain_reps=1):
    """Kernel A (the forward) and A' at the training shape against their
    plain versions, on the card: the lookup, then d f1s, every d f2 level
    and d coords against the autograd of the plain lookup, and the model's
    launch (d f1s and d f2) again with its device counts. Times the model's
    launch, with the bound."""
    from raft_ncup_tpu_torch.ops.corr_cuda import (
        lookup_levels, lookup_levels_backward, lookup_pyramid, lookup_pyramid_backward)

    s = TRAIN_CORR
    f1s, lv, coords, g = corr_bwd_inputs(torch, gen, mix)
    r = s["radius"]
    fwd_err, fwd_ok = max_err(torch, lookup_levels(f1s, lv, coords, r),
                              lookup_pyramid(f1s, lv, coords, r), **CORR_TOL)
    check(fwd_ok, f"corr lookup kernel disagrees with its plain version at the training "
                  f"shape ({mix} flow): {fwd_err:.3e}")
    model_path = (True, True, False)
    got = lookup_levels_backward(f1s, lv, coords, r, g)
    model, counts = corr_bwd_counts(torch, f1s, lv, coords, r, g, model_path)
    ref = lookup_pyramid_backward(f1s, lv, coords, r, g)
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


def check_corr_bwd_edges(torch, gen):
    """Kernel A' against the autograd of the plain lookup, with and without
    d coords, at the forward's edge coords on 9x11 queries (not multiples
    of the 2x4 tile; levels 9x11, 4x5, 2x2, 1x1; windows fully off every
    side) for C in {4, 512} and radius in {0, 8}, and on smooth 33x47
    coords, where the tiled path runs, at C=252 (a lane without channels
    in the second slice) r=4, C=4 r=8 and C=128 r=0; each launch's device
    counts against ``backward_work``. Every gradient within GRAD_TOL of its
    largest value."""
    from raft_ncup_tpu_torch.ops.corr_cuda import lookup_pyramid_backward, prepare_levels

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
        ref = lookup_pyramid_backward(f1s, lv, coords, r, g)
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
    """Kernels A' and B' on the card: A' at the training shape (random,
    then smooth flow) and B' at the NCUP layers, each from its own
    ``backward_generator``, and A''s edge phase from ``gen``. Returns
    their rows."""
    rows_gen = backward_generator(torch)
    corr_bwd = [check_corr_bwd(torch, rows_gen, flush, mix) for mix in ("random", "smooth")]
    check_corr_bwd_edges(torch, gen)
    return corr_bwd, check_nconv_bwd(torch, backward_generator(torch), flush)


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
    back to the plain version, with or without a gradient."""
    from raft_ncup_tpu_torch.ops.corr_cuda import lookup_levels
    from raft_ncup_tpu_torch.ops.nconv_cuda import nconv2d_fused

    f1 = torch.randn(1, 8, 8, 16, device="cuda")
    lv = [torch.randn(1, 8, 8, 16, device="cuda")]
    co = torch.zeros(1, 8, 8, 2, device="cuda")
    d = torch.randn(1, 1, 8, 8, device="cuda")
    w = torch.rand(2, 1, 3, 3, device="cuda")
    cases = [
        ("corr, float64", TypeError, lambda: lookup_levels(f1.double(), lv, co, 2)),
        ("corr, non-contiguous", ValueError,
         lambda: lookup_levels(f1.transpose(1, 2), lv, co, 2)),
        ("corr, float64 with a gradient", TypeError,
         lambda: lookup_levels(f1.double().requires_grad_(), lv, co, 2)),
        ("nconv, float64", TypeError, lambda: nconv2d_fused(d.double(), d.double(), w)),
        ("nconv, non-contiguous", ValueError,
         lambda: nconv2d_fused(d.transpose(2, 3), d, w)),
        ("nconv, non-contiguous with a gradient", ValueError,
         lambda: nconv2d_fused(d.transpose(2, 3), d, w.clone().requires_grad_())),
    ]
    for what, exc, call in cases:
        try:
            call()
        except exc:
            continue
        raise CheckFailed(f"wrapper accepted an unsupported input: {what}")
    print(f"wrappers: {len(cases)} unsupported CUDA inputs refused", flush=True)


# ------------------------------------------------------------------- serve

def check_serve(torch, card):
    from raft_ncup_tpu_torch.config import ServeConfig, flagship_config
    from raft_ncup_tpu_torch.models.raft import RAFT
    from raft_ncup_tpu_torch.ops import corr_cuda
    from raft_ncup_tpu_torch.ops.corr_cuda import lookup_levels
    from raft_ncup_tpu_torch.ops.nconv_cuda import nconv2d_fused
    from raft_ncup_tpu_torch.ops.padding import InputPadder
    from raft_ncup_tpu_torch.serve import make_pairs, serve_pairs

    cfg = ServeConfig(batch_sizes=(1, 2), iter_levels=(12,), queue_capacity=16)
    model = RAFT(flagship_config(corr_impl="pallas", nconv_impl="pallas"),
                 device="cuda", seed=0)
    pairs = make_pairs(SERVE_SIZE, SERVE_REQUESTS, seed=0)
    lookup_levels.launches = 0
    nconv2d_fused.launches = 0
    corr_cuda.reset_path_tiles()
    report, responses = serve_pairs(model, cfg, pairs, SERVE_SIZE)
    torch.cuda.synchronize()
    launches = {"corr_lookup": lookup_levels.launches, "nconv": nconv2d_fused.launches}
    served_paths = corr_cuda.path_tiles()
    print(f"serve: {report['serve_ok']}/{report['serve_requests']} ok at "
          f"{SERVE_SIZE[0]}x{SERVE_SIZE[1]}, batch sizes {cfg.batch_sizes}, "
          f"{cfg.iter_levels[0]} iterations; p50 {report['serve_p50_ms']} ms, "
          f"p99 {report['serve_p99_ms']} ms, {report['serve_pairs_per_sec']:.3f} pairs/s "
          f"on {card}; {report['stats']}; launches while serving "
          f"(warm-up included) {launches}; corr lookup tiles by path {served_paths}",
          flush=True)
    check(report["errors"] == 0, f"serve errors: {[r.detail for r in responses if not r.ok]}")
    for r in responses:
        check(r.ok, f"request {r.request_id} answered {r.status}: {r.detail}")
        check(r.flow.shape == (*SERVE_SIZE, 2), f"flow shape {r.flow.shape}")
        check(bool(torch.isfinite(torch.from_numpy(r.flow)).all()), "non-finite flow")
    check(report["corr_kernel_launches"] > 0, "served without the corr kernel")
    check(report["nconv_kernel_launches"] > 0, "served without the nconv kernel")

    # One served pair against the same weights through the plain versions.
    plain = RAFT(flagship_config(corr_impl="onthefly", nconv_impl="xla"),
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
    print(f"served pair vs plain versions: max|flow_lr diff| {e_lr:.3e} "
          f"(atol {FLOW_LR_TOL['atol']}), max|flow_up diff| {e_up:.3e} "
          f"(atol {FLOW_UP_TOL['atol']}), max|flow_up| {float(up_p.abs().max()):.3f}",
          flush=True)
    check(ok_lr and ok_up, "served flow disagrees with the plain-version model")
    report.update(flow_lr_err=e_lr, flow_up_err=e_up, corr_path_tiles=served_paths)
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
    for fn in kernel_counters().values():
        fn.launches = 0


def read_launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in kernel_counters().items()}


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


def check_train(torch, card) -> dict:
    """The main path of this slice: 5 steps of the flagship's training at
    the full configuration above, through both kernels and both backward
    kernels; finite losses, no skipped step, no plain version called, every
    kernel launched. Then the peak memory of one step without remat and a
    profiled step."""
    from raft_ncup_tpu_torch.config import TrainConfig, flagship_config
    from raft_ncup_tpu_torch.data.synthetic import SyntheticFlowDataset
    from raft_ncup_tpu_torch.training.state import create_train_state
    from raft_ncup_tpu_torch.training.step import make_train_step

    cfg = TrainConfig(**TRAIN_CFG)
    model_cfg = flagship_config(dataset=cfg.stage, corr_impl="pallas", nconv_impl="pallas")
    state = create_train_state(model_cfg, cfg, "cuda")
    data = SyntheticFlowDataset(cfg.image_size, seed=cfg.seed)
    batches = [data.batch(i, cfg.batch_size, "cuda") for i in range(TRAIN_STEPS)]
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
    bwd_counts = corr_cuda.backward_counts()
    peak_remat = torch.cuda.max_memory_allocated()
    skipped = int(state.sentinel["skipped"])
    torch.cuda.reset_peak_memory_stats()
    make_train_step(cfg, remat=False)(state, batches[0])
    torch.cuda.synchronize()
    peak_no_remat = torch.cuda.max_memory_allocated()
    prof = profile_train_step(torch, step, state, batches[1])
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    report = {
        "card": card,
        "config": f"raft_nc_dbl stage {cfg.stage}, batch {cfg.batch_size} at "
                  f"{cfg.image_size[0]}x{cfg.image_size[1]}, {cfg.iters} iterations, f32, "
                  "remat on, sentinel on",
        "losses": losses, "skipped": skipped, "step_ms": step_ms,
        "median_ms_steps_2_to_5": statistics.median(step_ms[1:]),
        "peak_gib_remat": peak_remat / 2**30, "peak_gib_no_remat": peak_no_remat / 2**30,
        "launches": launches, "launches_per_step": per_step,
        "corr_lookup_bwd_counts": bwd_counts,
        "plain_version_calls": plain_calls, "profile": prof,
    }
    print(f"train: {json.dumps(report)}", flush=True)
    check(not plain_calls, f"plain versions ran during the train steps: {plain_calls}")
    check(all(math.isfinite(x) for x in losses), f"non-finite train loss: {losses}")
    check(skipped == 0, f"the sentinel skipped {skipped} of {TRAIN_STEPS} steps")
    # Per step: the lookup in each iteration's forward and in remat's
    # recompute, its backward once an iteration; the 4 NCUP layers likewise.
    want = {"corr_lookup": 2 * cfg.iters, "corr_lookup_bwd": cfg.iters,
            "nconv": 8 * cfg.iters, "nconv_bwd": 4 * cfg.iters}
    check(per_step == want, f"launches per step {per_step}, want {want}")
    return report


def _step_grads(torch, corr_impl, nconv_impl, batch, cfg):
    from raft_ncup_tpu_torch.config import flagship_config
    from raft_ncup_tpu_torch.models.raft import RAFT
    from raft_ncup_tpu_torch.training.state import state_for
    from raft_ncup_tpu_torch.training.step import loss_and_grads

    model = RAFT(flagship_config(dataset=cfg.stage, corr_impl=corr_impl, nconv_impl=nconv_impl),
                 device="cuda", seed=0)
    state = state_for(model, cfg)
    loss, _, grads = loss_and_grads(state, batch, cfg)
    out = float(loss), {n: g.detach() for (n, _), g in zip(state.named_params, grads)}
    del model, state, grads
    torch.cuda.empty_cache()
    return out


def check_train_vs_plain(torch) -> dict:
    """One step at batch 2, 400x720, from the same seeded weights and
    batch, through the kernels and through the plain versions (the
    on-the-fly lookup and the two-convolution NConv2d, differentiated by
    autograd): the loss and every gradient tensor."""
    from raft_ncup_tpu_torch.config import TrainConfig
    from raft_ncup_tpu_torch.data.synthetic import SyntheticFlowDataset

    cfg = TrainConfig(**{**TRAIN_CFG, "batch_size": 2})
    batch = SyntheticFlowDataset(cfg.image_size, seed=cfg.seed).batch(0, 2, "cuda")
    reset_launches()
    k_loss, k_grads = _step_grads(torch, "pallas", "pallas", batch, cfg)
    check(all(n > 0 for n in read_launches().values()), "the kernel step skipped a kernel")
    p_loss, p_grads = _step_grads(torch, "onthefly", "xla", batch, cfg)
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
    report = {"loss_kernels": k_loss, "loss_plain": p_loss, "loss_rel_diff": loss_rel,
              "grad_rel_diff": worst, "tolerances": tols,
              "negligible_tensors": len(negligible), "tensors": len(k_grads)}
    print(f"train step, kernels vs plain versions (batch 2, 400x720): {json.dumps(report)}",
          flush=True)
    check(loss_rel <= STEP_LOSS_RTOL, f"kernel step loss {k_loss} vs plain {p_loss}")
    check(not failures, f"kernel step gradients differ from the plain step's: {failures}")
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


def profile_forward(torch, model, card) -> dict:
    """Where a served batch's time goes: ``PROFILE_REPS`` traced forwards
    of the served model at batch 2, 436x1024 (padded to 440x1024), 12
    iterations. ``wall_ms`` is host time per forward ending in a
    synchronise, ``device_ms`` the summed kernel time per forward from the
    trace, ``idle_share`` 1 - device_ms / wall_ms. With no device time in
    the trace, ``device_ms`` is null rather than a host number."""
    import numpy as np
    from raft_ncup_tpu_torch.ops.padding import InputPadder

    h, w = SERVE_SIZE
    imgs = np.random.default_rng(1).uniform(0, 255, (2, PROFILE_BATCH, h, w, 3))
    padder = InputPadder((h, w, 3), mode="sintel")
    i1, i2 = padder.pad(*(torch.from_numpy(x.astype(np.float32)).cuda() for x in imgs))
    for _ in range(2):
        model(i1, i2, iters=12)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_REPS):
            model(i1, i2, iters=12)
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
    prof_report = {
        "card": card,
        "shape": f"batch {PROFILE_BATCH} at {h}x{w} (padded {i1.shape[1]}x{i1.shape[2]}), "
                 "12 iterations, f32",
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "idle_share": None if device_ms is None else 1.0 - device_ms / wall_ms,
        "by_group": groups,
        "top": [{"kernel": k[:120], "ms": v} for k, v in top],
    }
    print(f"profile: {json.dumps(prof_report)}", flush=True)
    return prof_report


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
    check_corr_edges(torch, gen)
    nconv_rows = check_nconv(torch, gen, flush)
    check_nconv_edges(torch, gen)
    corr_bwd, nconv_bwd_rows = check_backward(torch, gen, flush)
    check_wrappers_refuse(torch)
    model, serve, launches = check_serve(torch, card)
    profile = profile_forward(torch, model, card)
    check(profile["device_ms"] is not None, "the trace holds no device time")
    del model
    torch.cuda.empty_cache()
    train = check_train(torch, card)
    check(all(p["device_ms"] > 0 for p in train["profile"]["phases"].values()),
          "a phase of the train trace holds no device time")
    check_train_vs_plain(torch)

    # One CUDA kernel replaces both TPU tiers, so both corr rows give its
    # main-path count as `launches`; `check_launches` is the row's own check.
    # `launches` is the serve run's count for the forward kernels and the
    # train run's for the backward kernels; `train_launches` the train run's
    # for all four.
    tl = train["launches"]
    corr_src = "raft_ncup_tpu_torch/csrc/corr_lookup.cu"
    kernels = [
        dict(name="corr_lookup at the served shape (the TPU's resident tier)", route="cuda",
             source=corr_src, replaces="raft_ncup_tpu/ops/corr_pallas.py:422",
             launches=launches["corr_lookup"], train_launches=tl["corr_lookup"],
             **_kernel_numbers(corr_served)),
        dict(name="corr_lookup at 1088x1920 (the TPU's banded tier; launches are the "
             "main-path count of the same kernel)", route="cuda",
             source=corr_src, replaces="raft_ncup_tpu/ops/corr_pallas.py:672",
             launches=launches["corr_lookup"], train_launches=tl["corr_lookup"],
             **_kernel_numbers(corr_banded)),
        dict(name="corr_lookup at the served shape with smooth flow (the same kernel)",
             route="cuda", source=corr_src,
             replaces="raft_ncup_tpu/ops/corr_pallas.py:422",
             launches=launches["corr_lookup"], train_launches=tl["corr_lookup"],
             **_kernel_numbers(corr_smooth)),
        dict(name="corr_lookup at 2176x3840 (the TPU's banded tier; the same kernel)",
             route="cuda", source=corr_src,
             replaces="raft_ncup_tpu/ops/corr_pallas.py:672",
             launches=launches["corr_lookup"], train_launches=tl["corr_lookup"],
             **_kernel_numbers(corr_4k)),
        dict(name="nconv2d_fused (4 NCUP layers of one served batch of 2)", route="cuda",
             source="raft_ncup_tpu_torch/csrc/nconv.cu",
             replaces="raft_ncup_tpu/ops/nconv_pallas.py:125",
             launches=launches["nconv"], train_launches=tl["nconv"],
             **_summed_numbers(nconv_rows)),
    ]
    for row in corr_bwd:
        kernels.append(dict(
            name=f"corr_lookup_bwd at the training shape, {row['shape'].split()[-2]} flow "
                 "(no TPU kernel: JAX differentiates the XLA path)",
            route="cuda", source="raft_ncup_tpu_torch/csrc/corr_lookup_bwd.cu",
            replaces="raft_ncup_tpu/ops/corr_pallas.py:816",
            launches=tl["corr_lookup_bwd"], train_launches=tl["corr_lookup_bwd"],
            launches_per_step=train["launches_per_step"]["corr_lookup_bwd"],
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
        **_summed_numbers(nconv_bwd_rows)))
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
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
