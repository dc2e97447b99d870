#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of the repository: ``python3 chip_smoke.py``. It

1. prints the card's name and power limit (the slice is f32: the model's
   forward and the plain versions keep TF32 off themselves);
2. builds both hand-written kernels from ``raft_ncup_tpu_torch/csrc``;
3. holds the correlation-lookup kernel against its plain PyTorch version
   at the served shape (batch 2, 55x128 level 0, C=256, 4 levels, r=4)
   with random and with smooth flow, at 1088x1920 (136x240 level 0) and at
   2176x3840 (272x480), with CUDA-event times, the bound of each row and
   the tiles that took each of the kernel's two paths (checked against
   ``corr_cuda.tile_paths``); then at edge cases (C 4 to 512, radius 0 to
   8, odd levels down to 1x1, windows off every side);
4. holds the fused NConv2d kernel against its plain version at the four
   NCUP layer shapes of one served batch of two (4 folded planes of
   440x1024) and at edge cases (every k, Cout 8, bias, ragged, tiny and
   misaligned planes), and checks that both wrappers raise on CUDA inputs
   their kernels do not take (gradients, other dtypes, strided layouts);
5. serves 8 Sintel-size (436x1024) requests through ``FlowServer`` with
   the flagship model on the card, checks every answer, checks that both
   kernels ran while serving, and holds one served pair against the same
   model run through the plain versions;
6. traces forwards of the served model at batch 2 with ``torch.profiler``
   and prints where the device time goes (wall and device ms per
   forward, idle share, time per kernel group, the top kernels);
7. prints one JSON line describing the kernels, the card's name and
   power limit, and, last, the JSON result line.

Any failed check exits non-zero before the last line. With no CUDA
device it exits non-zero at once; it never falls back to the CPU.
"""

from __future__ import annotations

import json
import math
import os
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


def check_wrappers_refuse(torch):
    """On a CUDA tensor a wrapper launches its kernel or raises: inputs
    that need a gradient, another dtype or a non-contiguous layout raise
    instead of falling back to the plain version."""
    from raft_ncup_tpu_torch.ops.corr_cuda import lookup_levels
    from raft_ncup_tpu_torch.ops.nconv_cuda import nconv2d_fused

    f1 = torch.randn(1, 8, 8, 16, device="cuda")
    lv = [torch.randn(1, 8, 8, 16, device="cuda")]
    co = torch.zeros(1, 8, 8, 2, device="cuda")
    d = torch.randn(1, 1, 8, 8, device="cuda")
    w = torch.rand(2, 1, 3, 3, device="cuda")
    cases = [
        ("corr, requires_grad", NotImplementedError,
         lambda: lookup_levels(f1.clone().requires_grad_(), lv, co, 2)),
        ("corr, float64", TypeError, lambda: lookup_levels(f1.double(), lv, co, 2)),
        ("corr, non-contiguous", ValueError,
         lambda: lookup_levels(f1.transpose(1, 2), lv, co, 2)),
        ("nconv, requires_grad", NotImplementedError,
         lambda: nconv2d_fused(d, d, w.clone().requires_grad_())),
        ("nconv, float64", TypeError, lambda: nconv2d_fused(d.double(), d.double(), w)),
        ("nconv, non-contiguous", ValueError,
         lambda: nconv2d_fused(d.transpose(2, 3), d, w)),
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


# ----------------------------------------------------------------- profile

PROFILE_BATCH = 2
PROFILE_REPS = 3
_CONV_MARKERS = ("conv", "gemm", "cudnn", "cutlass", "xmma", "implicit", "winograd", "fft")


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "corr_lookup_kernel" in low:
        return "corr_lookup_kernel"
    if "nconv_kernel" in low:
        return "nconv_kernel"
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
    check_wrappers_refuse(torch)
    model, serve, launches = check_serve(torch, card)
    profile = profile_forward(torch, model, card)
    check(profile["device_ms"] is not None, "the trace holds no device time")

    # One CUDA kernel replaces both TPU tiers, so both corr rows give its
    # main-path count as `launches`; `check_launches` is the row's own check.
    corr_src = "raft_ncup_tpu_torch/csrc/corr_lookup.cu"
    kernels = [
        dict(name="corr_lookup at the served shape (the TPU's resident tier)", route="cuda",
             source=corr_src, replaces="raft_ncup_tpu/ops/corr_pallas.py:422",
             launches=launches["corr_lookup"], **_kernel_numbers(corr_served)),
        dict(name="corr_lookup at 1088x1920 (the TPU's banded tier; launches are the "
             "main-path count of the same kernel)", route="cuda",
             source=corr_src, replaces="raft_ncup_tpu/ops/corr_pallas.py:672",
             launches=launches["corr_lookup"], **_kernel_numbers(corr_banded)),
        dict(name="corr_lookup at the served shape with smooth flow (the same kernel)",
             route="cuda", source=corr_src,
             replaces="raft_ncup_tpu/ops/corr_pallas.py:422",
             launches=launches["corr_lookup"], **_kernel_numbers(corr_smooth)),
        dict(name="corr_lookup at 2176x3840 (the TPU's banded tier; the same kernel)",
             route="cuda", source=corr_src,
             replaces="raft_ncup_tpu/ops/corr_pallas.py:672",
             launches=launches["corr_lookup"], **_kernel_numbers(corr_4k)),
        dict(name="nconv2d_fused (4 NCUP layers of one served batch of 2)", route="cuda",
             source="raft_ncup_tpu_torch/csrc/nconv.cu",
             replaces="raft_ncup_tpu/ops/nconv_pallas.py:125",
             launches=launches["nconv"],
             max_abs_err=max(r["max_abs_err"] for r in nconv_rows),
             ms=sum(r["ms"] for r in nconv_rows),
             plain_ms=sum(r["plain_ms"] for r in nconv_rows),
             bound_ms=sum(r["bound_ms"] for r in nconv_rows),
             bound_by="bytes" if all(r["bound_by"] == "bytes" for r in nconv_rows)
             else "operations",
             library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


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
