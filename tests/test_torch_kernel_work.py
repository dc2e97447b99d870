"""The counts every kernel bound in PERF.md rests on, and the host-side
path rules of the correlation-lookup kernels, against brute force on
small shapes, on the CPU.

``chip_smoke.corr_work`` and ``chip_smoke.nconv_work`` give the bytes
and operations of kernel A (the correlation lookup) and kernel B (the
fused NConv2d) from this run's inputs; ``corr_cuda.tile_paths`` predicts
which tiles of 2x4 queries take kernel A's tiled path, and
``corr_cuda.backward_work`` the paths and d f2 row adds of its backward
kernel A'. Each is held here against a plain loop over every query,
window position, pixel or tap. Emulations of A''s tiled decomposition
and of B''s fixed-order weight-gradient partials are held against the
plain backward versions. Importing ``chip_smoke`` needs no card: it
decides only in ``main``.
"""

import json
import math
import os
import re

import numpy as np
import pytest
import torch

import chip_compare
import chip_smoke
from raft_ncup_tpu_torch.ops import corr_cuda, nconv_cuda


def _corr_operands(seed, b, h, w, c, levels, spread):
    """Pre-scaled f1, a pooled pyramid of odd sizes, and coords on the
    grid plus offsets up to ``spread`` px, with a third of the windows
    thrown far outside the levels."""
    g = np.random.default_rng(seed)
    f1 = torch.from_numpy(g.normal(size=(b, h, w, c)).astype(np.float32))
    f2 = torch.from_numpy(g.normal(size=(b, h, w, c)).astype(np.float32))
    f1s, lv = corr_cuda.prepare_levels(f1, f2, levels)
    y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = np.stack([x, y], -1)[None].astype(np.float32)
    coords = grid + g.uniform(-spread, spread, (b, h, w, 2))
    far = g.random((b, h, w, 1)) < 0.33
    coords = coords + far * g.choice([-1.0, 1.0], (b, h, w, 2)) * 5 * max(h, w)
    return f1s, lv, torch.from_numpy(coords.astype(np.float32))


def _corr_work_brute(f1s, lv, coords, radius):
    b, h, w, c = f1s.shape
    k1 = 2 * radius + 2
    positions = 0
    pts = coords.numpy().reshape(-1, 2).astype(np.float64)
    for lvl, t in enumerate(lv):
        hl, wl = t.shape[1], t.shape[2]
        for px, py in pts:
            ox = math.floor(px / 2**lvl) - radius
            oy = math.floor(py / 2**lvl) - radius
            for i in range(k1):
                for j in range(k1):
                    positions += 0 <= oy + i < hl and 0 <= ox + j < wl
    n_out = b * h * w * len(lv) * (2 * radius + 1) ** 2
    nbytes = 4 * (f1s.numel() + coords.numel() + sum(t.numel() for t in lv) + n_out)
    return nbytes, 2 * c * positions + 7 * n_out


@pytest.mark.parametrize(
    "b,h,w,c,levels,radius,spread",
    [
        (1, 9, 11, 8, 4, 4, 3.0),   # levels 9x11, 4x5, 2x2, 1x1
        (2, 7, 13, 4, 3, 0, 1.5),   # radius 0: 2x2 patches
        (3, 5, 6, 12, 2, 3, 20.0),  # windows mostly off the small levels
    ],
    ids=["odd_1x1_deepest", "radius0", "wide_flow"],
)
def test_corr_work_matches_brute_force(b, h, w, c, levels, radius, spread):
    f1s, lv, coords = _corr_operands(20 + b, b, h, w, c, levels, spread)
    assert chip_smoke.corr_work(torch, f1s, lv, coords, radius) == _corr_work_brute(
        f1s, lv, coords, radius
    )


def _nconv_work_brute(b, h, w, k, cin, cout):
    p = k // 2
    taps = 0
    for y in range(h):
        for x in range(w):
            for ky in range(k):
                for kx in range(k):
                    taps += 0 <= y + ky - p < h and 0 <= x + kx - p < w
    nbytes = 4 * (2 * b * cin * h * w + cout * cin * k * k + 2 * b * cout * h * w)
    return nbytes, b * cin * taps * (1 + 4 * cout) + 3 * b * cout * h * w


@pytest.mark.parametrize(
    "b,h,w,k,cin,cout",
    [(1, 5, 7, 1, 2, 1), (2, 9, 4, 3, 4, 2), (1, 6, 11, 5, 1, 2),
     (3, 2, 3, 7, 2, 8), (1, 13, 10, 7, 1, 1)],
    ids=["k1", "k3", "k5", "k7_plane_inside_halo", "k7"],
)
def test_nconv_work_matches_brute_force(b, h, w, k, cin, cout):
    assert chip_smoke.nconv_work(b, h, w, k, cin, cout) == _nconv_work_brute(
        b, h, w, k, cin, cout
    )


@pytest.mark.parametrize("with_coords", [False, True], ids=["model_path", "with_d_coords"])
@pytest.mark.parametrize(
    "b,h,w,c,levels,radius,spread",
    [(1, 9, 11, 8, 4, 4, 3.0), (3, 5, 6, 12, 2, 3, 20.0)],
    ids=["odd_1x1_deepest", "wide_flow"],
)
def test_corr_bwd_work_matches_brute_force(b, h, w, c, levels, radius, spread, with_coords):
    """Kernel A' reads what the forward reads with the upstream gradient in
    place of the output, and writes d f1s and every d level (and d coords);
    4C flops and C atomic adds per in-level position, 8 flops per tap for
    the patch gradient (and 2C and 12 more for d coords)."""
    f1s, lv, coords = _corr_operands(40 + b, b, h, w, c, levels, spread)
    _, fwd_flops = _corr_work_brute(f1s, lv, coords, radius)
    n_taps = b * h * w * levels * (2 * radius + 1) ** 2
    positions = (fwd_flops - 7 * n_taps) // (2 * c)
    nbytes = 4 * (2 * f1s.numel() + coords.numel() + 2 * sum(t.numel() for t in lv) + n_taps)
    flops = 4 * c * positions + 8 * n_taps
    if with_coords:
        nbytes += 4 * coords.numel()
        flops += 2 * c * positions + 12 * n_taps
    assert chip_smoke.corr_bwd_work(torch, f1s, lv, coords, radius, with_coords) == (
        nbytes, flops, c * positions)


def _nconv_bwd_work_brute(b, h, w, k, cin, cout, bias, with_gc):
    p = k // 2
    taps = 0
    for y in range(h):
        for x in range(w):
            for ky in range(k):
                for kx in range(k):
                    taps += 0 <= y + ky - p < h and 0 <= x + kx - p < w
    n_in, n_out, nw = b * cin * h * w, b * cout * h * w, cout * cin * k * k
    reads = 2 * n_in + nw + 3 * n_out + (n_out if with_gc else 0) + (cout if bias else 0)
    writes = 2 * n_in + nw + (cout if bias else 0)
    flops = b * cin * taps * (1 + 8 * cout) + 12 * n_out + 3 * n_in
    return 4 * (reads + writes), flops


@pytest.mark.parametrize(
    "b,h,w,k,cin,cout,bias,with_gc",
    [(1, 5, 7, 1, 2, 1, False, False), (2, 9, 4, 3, 4, 2, True, True),
     (1, 6, 11, 5, 1, 2, False, True), (3, 2, 3, 7, 2, 8, True, True)],
    ids=["nconv_out_no_conf_grad", "k3_bias", "k5", "k7_plane_inside_halo"],
)
def test_nconv_bwd_work_matches_brute_force(b, h, w, k, cin, cout, bias, with_gc):
    """Kernel B' reads data, conf, the weight, out, conf_out and go (and gc
    and the bias), writes d data, d conf and d weight (and d bias); per
    in-bounds tap and input channel 1 + 8 Cout flops, 12 per output pixel
    and 3 per input pixel."""
    assert chip_smoke.nconv_bwd_work(b, h, w, k, cin, cout, bias, with_gc) == (
        _nconv_bwd_work_brute(b, h, w, k, cin, cout, bias, with_gc))


def _tile_paths_brute(coords, level_hw, radius, channels):
    """The kernel's rule, one tile and one query at a time."""
    b, h, w, _ = coords.shape
    k1 = 2 * radius + 2
    tiles = tiled = 0
    pts = coords.numpy().astype(np.float64)
    for lvl, (hl, wl) in enumerate(level_hw):
        for bb in range(b):
            for ty in range(0, h, corr_cuda.TILE_H):
                for tx in range(0, w, corr_cuda.TILE_W):
                    tiles += 1
                    rects = []
                    for y in range(ty, min(ty + corr_cuda.TILE_H, h)):
                        for x in range(tx, min(tx + corr_cuda.TILE_W, w)):
                            ox = min(max(math.floor(pts[bb, y, x, 0] / 2**lvl) - radius, -k1), wl)
                            oy = min(max(math.floor(pts[bb, y, x, 1] / 2**lvl) - radius, -k1), hl)
                            x0, x1 = max(ox, 0), min(ox + k1, wl)
                            y0, y1 = max(oy, 0), min(oy + k1, hl)
                            if x0 < x1 and y0 < y1:
                                rects.append((x0, x1, y0, y1))
                    areas = sum((r[1] - r[0]) * (r[3] - r[2]) for r in rects)
                    box = 0 if not rects else (
                        (max(r[1] for r in rects) - min(r[0] for r in rects))
                        * (max(r[3] for r in rects) - min(r[2] for r in rects)))
                    tiled += (channels <= corr_cuda.MAX_TILED_CHANNELS
                              and corr_cuda.STRIP_RATIO * box <= areas)
    return tiled, tiles - tiled


@pytest.mark.parametrize(
    "radius,spread,size,channels",
    [(4, 2.0, (2, 9, 19), 4), (4, 40.0, (1, 12, 24), 4), (2, 8.0, (2, 7, 10), 4),
     (6, 1.0, (1, 5, 9), 4), (4, 1.0, (1, 6, 8), 260)],
    ids=["smooth", "wide_random", "radius2", "radius6", "c260_all_per_query"],
)
def test_tile_paths_match_brute_force(radius, spread, size, channels):
    b, h, w = size
    _, lv, coords = _corr_operands(30 + radius, b, h, w, 4, 4, spread)
    level_hw = [(t.shape[1], t.shape[2]) for t in lv]
    got = corr_cuda.tile_paths(coords, level_hw, radius, channels)
    assert got == _tile_paths_brute(coords, level_hw, radius, channels)
    assert sum(got) == len(lv) * b * -(-h // corr_cuda.TILE_H) * -(-w // corr_cuda.TILE_W)
    if channels > corr_cuda.MAX_TILED_CHANNELS:
        assert got[0] == 0


def test_tile_paths_split_the_served_mixes():
    """At the served shape, the smooth mix is mostly tiled and the random
    mix takes both paths, so the card's served rows show both."""
    gen = torch.Generator().manual_seed(0)
    b, h, w = 2, 55, 128
    y, x = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    grid = torch.stack([x, y], -1).float()[None].expand(b, h, w, 2)
    level_hw = [(55, 128), (27, 64), (13, 32), (6, 16)]
    random = corr_cuda.tile_paths(grid + chip_smoke.random_flow(torch, gen, b, h, w),
                                  level_hw, 4, 256)
    smooth = corr_cuda.tile_paths(grid + chip_smoke.smooth_flow(torch, gen, b, h, w),
                                  level_hw, 4, 256)
    assert random[0] > 0 and random[1] > 0
    assert smooth[0] > 0.75 * sum(smooth)


def _split_f32(p, w):
    """The kernel's split(): (p / w, p % w) by float32 arithmetic, as in
    csrc/corr_lookup.cu: y = (int)(((float)p + 0.5f) * (1.f / w))."""
    inv = np.float32(1.0) / np.float32(w)
    y = ((p.astype(np.float32) + np.float32(0.5)) * inv).astype(np.int64)
    return y, p - y * w


def test_split_is_exact_wherever_the_kernel_uses_it():
    """A tiled box holds at most 8 (K+1)^2 <= 2592 pixels (the rule with a
    ratio of at least 1), a window at most 324: every index and width
    there divides exactly."""
    p = np.arange(8 * 18 * 18, dtype=np.int64)
    for w in range(1, p.size + 1):
        y, x = _split_f32(p, w)
        assert (y == p // w).all() and (x == p % w).all(), w


@pytest.mark.parametrize("w", [1, 2, 3, 7, 255, 1000, 4093, 65535])
def test_split_is_exact_up_to_its_stated_limit(w):
    g = np.random.default_rng(w)
    p = np.concatenate([np.arange(2**22 - 4096, 2**22 - 1),
                        g.integers(0, 2**22 - 1, 20000)]).astype(np.int64)
    y, x = _split_f32(p, w)
    assert (y == p // w).all() and (x == p % w).all()


def test_edge_coords_put_every_window_of_the_far_elements_outside():
    gen = torch.Generator().manual_seed(1)
    b, h, w, radius = 3, 9, 11, 8
    coords = chip_smoke.edge_coords(torch, gen, b, h, w)
    for lvl, (hl, wl) in enumerate([(9, 11), (4, 5), (2, 2), (1, 1)]):
        o = torch.floor(coords[2:] / 2**lvl) - radius
        inside_x = (o[..., 0] + 2 * radius + 2 > 0) & (o[..., 0] < wl)
        inside_y = (o[..., 1] + 2 * radius + 2 > 0) & (o[..., 1] < hl)
        assert not bool((inside_x & inside_y).any())
    # the far element's quadrants go off every side
    d = coords[2] - coords[0]
    assert {bool((d[..., 0] > h * 2).any()), bool((d[..., 0] < -h * 2).any()),
            bool((d[..., 1] > h * 2).any()), bool((d[..., 1] < -h * 2).any())} == {True}


def test_chip_smoke_exits_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_compare_exits_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_compare.main(["."]) != 0
    assert "compare:" not in capsys.readouterr().out


def test_chip_compare_draws_its_inputs_with_this_chip_smoke():
    """Every checkout compared sees the inputs of this checkout's
    chip_smoke.py, at the shapes chip_smoke.py times."""
    cs = chip_compare._chip_smoke()
    assert os.path.samefile(cs.__file__, chip_smoke.__file__)
    assert cs.corr_inputs.__code__.co_code == chip_smoke.corr_inputs.__code__.co_code
    assert cs.nconv_inputs.__code__.co_code == chip_smoke.nconv_inputs.__code__.co_code
    shapes = {(b, h, w) for _, b, h, w, _ in chip_compare.ROWS}
    assert shapes == {(2, 55, 128), (1, 136, 240)}
    # the backward rows: both training mixes, at chip_smoke's training shapes
    assert chip_compare.BWD_MIXES == ("random", "smooth")
    assert (cs.TRAIN_CORR, cs.TRAIN_PLANES) == (chip_smoke.TRAIN_CORR, chip_smoke.TRAIN_PLANES)


# ------------------------------------------- kernel A': paths and d f2 adds

def _backward_work_brute(coords, level_hw, radius, channels, needs):
    """Kernel A''s rule, one tile and one query at a time: the forward's
    path rule per (tile, level) unless d coords is asked for; a tiled tile
    adds one d f2 row per pixel of its box that some window covers, a
    per-query tile one per in-level window position."""
    b, h, w, _ = coords.shape
    k1 = 2 * radius + 2
    tiled = per_query = adds = 0
    pts = coords.numpy().astype(np.float64)
    for lvl, (hl, wl) in enumerate(level_hw):
        for bb in range(b):
            for ty in range(0, h, corr_cuda.TILE_H):
                for tx in range(0, w, corr_cuda.TILE_W):
                    rects = []
                    for y in range(ty, min(ty + corr_cuda.TILE_H, h)):
                        for x in range(tx, min(tx + corr_cuda.TILE_W, w)):
                            ox = min(max(math.floor(pts[bb, y, x, 0] / 2**lvl) - radius, -k1), wl)
                            oy = min(max(math.floor(pts[bb, y, x, 1] / 2**lvl) - radius, -k1), hl)
                            x0, x1 = max(ox, 0), min(ox + k1, wl)
                            y0, y1 = max(oy, 0), min(oy + k1, hl)
                            if x0 < x1 and y0 < y1:
                                rects.append((x0, x1, y0, y1))
                    areas = sum((r[1] - r[0]) * (r[3] - r[2]) for r in rects)
                    bx = (min((r[0] for r in rects), default=0),
                          max((r[1] for r in rects), default=0))
                    by = (min((r[2] for r in rects), default=0),
                          max((r[3] for r in rects), default=0))
                    box = (bx[1] - bx[0]) * (by[1] - by[0])
                    rule = (not needs[2] and channels <= corr_cuda.MAX_TILED_CHANNELS
                            and corr_cuda.STRIP_RATIO * box <= areas)
                    tiled += rule
                    per_query += not rule
                    if not needs[1]:
                        continue
                    if not rule:
                        adds += areas
                        continue
                    for py in range(by[0], by[1]):
                        for px in range(bx[0], bx[1]):
                            adds += any(r[0] <= px < r[1] and r[2] <= py < r[3] for r in rects)
    return {"tiled": tiled, "per_query": per_query, "d_f2_row_adds": adds}


def _coords_field(kind, seed, b, h, w, spread):
    """Coords on the grid plus: ``operands``, offsets up to ``spread`` px
    with a third of the windows thrown fully outside the levels;
    ``smooth``, a smooth field of up to ``spread`` px; ``edge``, the
    forward's edge coords (near the grid, far, and off every side)."""
    gen = torch.Generator().manual_seed(seed)
    if kind == "operands":
        return _corr_operands(seed, b, h, w, 4, 1, spread)[2]
    if kind == "edge":
        return chip_smoke.edge_coords(torch, gen, b, h, w)
    y, x = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    grid = torch.stack([x, y], -1).float()[None].expand(b, h, w, 2)
    field = chip_smoke.smooth_flow(torch, gen, b, h, w, coarse=(2, 3)) * (spread / 20)
    return (grid + field).contiguous()


MODEL, WITH_D_COORDS, NO_D_F2 = (True, True, False), (True, True, True), (True, False, False)


@pytest.mark.parametrize(
    "kind,radius,spread,size,channels,needs",
    [("smooth", 4, 20.0, (2, 11, 19), 256, MODEL),
     ("smooth", 0, 3.0, (1, 9, 14), 256, MODEL),
     ("operands", 4, 2.0, (2, 9, 19), 256, MODEL),
     ("operands", 4, 40.0, (1, 12, 24), 256, MODEL),
     ("operands", 0, 1.5, (2, 7, 10), 256, MODEL),
     ("edge", 4, 0.0, (4, 9, 11), 256, MODEL),
     ("edge", 0, 0.0, (3, 9, 11), 512, MODEL),
     ("smooth", 4, 20.0, (1, 10, 13), 512, MODEL),
     ("smooth", 4, 20.0, (2, 11, 19), 256, WITH_D_COORDS),
     ("edge", 4, 0.0, (3, 9, 11), 256, NO_D_F2)],
    ids=["smooth", "smooth_radius0", "near_grid_far_windows", "wide_random",
         "radius0_far_windows", "edge_every_border", "edge_radius0_c512", "smooth_c512",
         "with_d_coords", "without_d_f2"],
)
def test_backward_work_matches_brute_force(kind, radius, spread, size, channels, needs):
    b, h, w = size
    coords = _coords_field(kind, 50 + radius + h, b, h, w, spread)
    level_hw = [(h, w), (h // 2, w // 2), (h // 4, w // 4), (max(h // 8, 1), max(w // 8, 1))]
    got = corr_cuda.backward_work(coords, level_hw, radius, channels, needs)
    assert got == _backward_work_brute(coords, level_hw, radius, channels, needs)
    assert got["tiled"] + got["per_query"] == len(level_hw) * b * -(-h // 2) * -(-w // 4)
    if needs == MODEL and channels <= corr_cuda.MAX_TILED_CHANNELS:
        assert (got["tiled"], got["per_query"]) == corr_cuda.tile_paths(
            coords, level_hw, radius, channels)


def test_backward_work_cuts_the_adds_on_smooth_flow():
    """On the training shape's smooth mix nearly every (tile, level) is
    tiled and the row adds fall several-fold against one per window
    position; on the random mix both paths run."""
    gen = torch.Generator().manual_seed(0)
    b, h, w = 2, 50, 90
    y, x = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    grid = torch.stack([x, y], -1).float()[None].expand(b, h, w, 2)
    level_hw = [(50, 90), (25, 45), (12, 22), (6, 11)]
    smooth = grid + chip_smoke.smooth_flow(torch, gen, b, h, w)
    random = grid + chip_smoke.random_flow(torch, gen, b, h, w)
    s = corr_cuda.backward_work(smooth, level_hw, 4, 256)
    r = corr_cuda.backward_work(random, level_hw, 4, 256)
    per_position = corr_cuda.backward_work(smooth, level_hw, 4, 256, WITH_D_COORDS)
    assert s["tiled"] > 0.95 * (s["tiled"] + s["per_query"])
    assert per_position["d_f2_row_adds"] > 4 * s["d_f2_row_adds"]
    assert r["tiled"] > 0 and r["per_query"] > 0


def _patch_grads(g_ql, fx, fy, k):
    """(K+1, K+1) patch gradient of one (query, level) from its K*K taps
    (x-major), by the blend's bilinear weights."""
    gp = np.zeros((k + 1, k + 1))
    for kx in range(k):
        for ky in range(k):
            t = g_ql[kx * k + ky]
            gp[ky, kx] += t * (1 - fy) * (1 - fx)
            gp[ky, kx + 1] += t * (1 - fy) * fx
            gp[ky + 1, kx] += t * fy * (1 - fx)
            gp[ky + 1, kx + 1] += t * fy * fx
    return gp


def _tiled_backward_emulation(f1s, lv, coords, radius, g):
    """d f1s and the d f2 levels summed as kernel A' sums them, in float64:
    per (tile, level) the tile's patch gradients; a tiled tile walks its
    box once, adding each covered pixel's row sum over the queries once and
    feeding each pixel's row to all 8 queries' d f1s; a per-query tile
    walks each window's in-level positions."""
    f1 = f1s.double().numpy()
    b, h, w, c = f1.shape
    k = 2 * radius + 1
    k1 = k + 1
    gg = g.double().numpy()
    pts = coords.double().numpy()
    df1 = np.zeros_like(f1)
    dlv = [np.zeros(t.shape) for t in lv]
    for lvl, t in enumerate(lv):
        f2 = t.double().numpy()
        hl, wl = f2.shape[1], f2.shape[2]
        for bb in range(b):
            for ty in range(0, h, corr_cuda.TILE_H):
                for tx in range(0, w, corr_cuda.TILE_W):
                    qs = []
                    for y in range(ty, min(ty + corr_cuda.TILE_H, h)):
                        for x in range(tx, min(tx + corr_cuda.TILE_W, w)):
                            p = pts[bb, y, x] / 2**lvl
                            fl = np.floor(p)
                            ox = int(min(max(fl[0] - radius, -k1), wl))
                            oy = int(min(max(fl[1] - radius, -k1), hl))
                            gp = _patch_grads(gg[bb, y, x, lvl * k * k:(lvl + 1) * k * k],
                                              p[0] - fl[0], p[1] - fl[1], k)
                            rect = (max(ox, 0), min(ox + k1, wl), max(oy, 0), min(oy + k1, hl))
                            qs.append(((y, x), ox, oy, gp, rect))
                    live = [q for q in qs if q[4][0] < q[4][1] and q[4][2] < q[4][3]]
                    areas = sum((r[1] - r[0]) * (r[3] - r[2]) for *_, r in live)
                    if not live:
                        continue
                    bx0, bx1 = min(q[4][0] for q in live), max(q[4][1] for q in live)
                    by0, by1 = min(q[4][2] for q in live), max(q[4][3] for q in live)
                    if corr_cuda.STRIP_RATIO * (bx1 - bx0) * (by1 - by0) <= areas:
                        for py in range(by0, by1):
                            for px in range(bx0, bx1):
                                row, hit = np.zeros(c), False
                                for (y, x), ox, oy, gp, _ in qs:
                                    i, j = py - oy, px - ox
                                    gv = gp[i, j] if 0 <= i < k1 and 0 <= j < k1 else 0.0
                                    hit = hit or (0 <= i < k1 and 0 <= j < k1)
                                    df1[bb, y, x] += gv * f2[bb, py, px]
                                    row += gv * f1[bb, y, x]
                                if hit:
                                    dlv[lvl][bb, py, px] += row
                    else:
                        for (y, x), ox, oy, gp, r in live:
                            for py in range(r[2], r[3]):
                                for px in range(r[0], r[1]):
                                    gv = gp[py - oy, px - ox]
                                    df1[bb, y, x] += gv * f2[bb, py, px]
                                    dlv[lvl][bb, py, px] += gv * f1[bb, y, x]
    return df1, dlv


@pytest.mark.parametrize(
    "kind,radius,size,spread",
    [("smooth", 2, (1, 6, 9), 6.0), ("operands", 2, (2, 5, 7), 1.0), ("edge", 1, (3, 5, 7), 0.0)],
    ids=["smooth", "near_grid_far_windows", "edge"],
)
def test_tiled_decomposition_matches_the_plain_backward(kind, radius, size, spread):
    """Summing gP over a tile's box and adding d f2 once per covered box
    pixel gives the gradients of the plain backward (the autograd of the
    plain lookup), within 1e-5 of each one's largest value."""
    b, h, w = size
    g0 = np.random.default_rng(h + radius)
    f1 = torch.from_numpy(g0.normal(size=(b, h, w, 8)).astype(np.float32))
    f2 = torch.from_numpy(g0.normal(size=(b, h, w, 8)).astype(np.float32))
    f1s, lv = corr_cuda.prepare_levels(f1, f2, 3)
    coords = _coords_field(kind, 60 + h, b, h, w, spread)
    k = 2 * radius + 1
    g = torch.from_numpy(g0.normal(size=(b, h, w, 3 * k * k)).astype(np.float32))
    level_hw = [(t.shape[1], t.shape[2]) for t in lv]
    work = corr_cuda.backward_work(coords, level_hw, radius, 8)
    assert work["tiled"] > 0
    df1, dlv = _tiled_backward_emulation(f1s, lv, coords, radius, g)
    ref = corr_cuda.lookup_pyramid_backward(f1s, lv, coords, radius, g, MODEL)
    for got, want in [(df1, ref[0])] + list(zip(dlv, ref[1])):
        want = want.double().numpy()
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-5 * scale


# ----------------------------------- kernel B': fixed-order d w partials

def _kernel_constant(source, name):
    path = os.path.join(os.path.dirname(corr_cuda.__file__), "..", "csrc", source)
    text = open(path).read()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_python_rules_state_the_kernels_constants():
    """The tile and the path rule that corr_cuda states in tensor code are
    the forward's and the backward's."""
    for source in ("corr_lookup.cu", "corr_lookup_bwd.cu"):
        assert _kernel_constant(source, "kTileH") == corr_cuda.TILE_H
        assert _kernel_constant(source, "kTileW") == corr_cuda.TILE_W
        assert _kernel_constant(source, "kStripRatio") == corr_cuda.STRIP_RATIO
    assert _kernel_constant("corr_lookup_bwd.cu", "kMaxTiledChannels") == (
        corr_cuda.MAX_TILED_CHANNELS)


def _nconv_partials_emulation(data, conf, weight, bias, out, conf_out, go, gc, eps):
    """d w and d bias as kernel B' sums them: one partial per tile of the
    kernel (kTileH x kTileW output pixels of one plane) from the tile's own
    pixels, the partials added in the blocks' order (batch, tile row, tile
    column), then the weight-sum term of conf_out; float32 throughout."""
    th, tw = _kernel_constant("nconv_bwd.cu", "kTileH"), _kernel_constant("nconv_bwd.cu", "kTileW")
    cout, cin, k, _ = weight.shape
    p = k // 2
    s = weight.sum(dim=(1, 2, 3)).view(1, -1, 1, 1)
    y = conf_out * s + eps
    n = (out if bias is None else out - bias.view(1, -1, 1, 1)) * y
    g_n = go / y
    g_d = (-go * n) * (1.0 / (y * y)) + gc / s
    pad = (p, p, p, p)
    dc = torch.nn.functional.pad(data * conf, pad)
    cp = torch.nn.functional.pad(conf, pad)
    b, _, h, w = data.shape
    dw = torch.zeros_like(weight)
    db = torch.zeros(cout)
    gs = torch.zeros(cout)
    for bb in range(b):
        for y0 in range(0, h, th):
            for x0 in range(0, w, tw):
                ys, xs = slice(y0, min(y0 + th, h)), slice(x0, min(x0 + tw, w))
                th_, tw_ = ys.stop - y0, xs.stop - x0
                part = torch.zeros_like(weight)
                for ky in range(k):
                    for kx in range(k):
                        win_dc = dc[bb, :, y0 + ky:y0 + ky + th_, x0 + kx:x0 + kx + tw_]
                        win_c = cp[bb, :, y0 + ky:y0 + ky + th_, x0 + kx:x0 + kx + tw_]
                        part[:, :, ky, kx] = (
                            torch.einsum("ohw,ihw->oi", g_n[bb, :, ys, xs], win_dc)
                            + torch.einsum("ohw,ihw->oi", g_d[bb, :, ys, xs], win_c))
                dw = dw + part
                db = db + go[bb, :, ys, xs].sum(dim=(1, 2))
                gs = gs + (gc[bb, :, ys, xs] * conf_out[bb, :, ys, xs]).sum(dim=(1, 2))
    return dw + (-gs / s.view(-1)).view(-1, 1, 1, 1), db


@pytest.mark.parametrize(
    "b,h,w,k,cin,cout,with_bias",
    [(2, 20, 70, 5, 2, 2, False), (1, 17, 130, 3, 4, 2, True), (1, 16, 64, 1, 2, 1, False),
     (2, 9, 11, 7, 1, 3, True)],
    ids=["k5_ragged", "k3_bias_three_tile_columns", "k1_one_tile", "k7_inside_one_tile"],
)
def test_nconv_fixed_order_partials_match_the_plain_backward(b, h, w, k, cin, cout, with_bias):
    """Kernel B''s per-tile partials of d w and d bias, reduced in its
    fixed order, agree with ``nconv2d_backward_plain`` within 1e-5 of
    each one's largest value."""
    g0 = np.random.default_rng(b * h + k)
    data = torch.from_numpy(g0.normal(size=(b, cin, h, w)).astype(np.float32))
    conf = torch.from_numpy(g0.uniform(0.05, 1, (b, cin, h, w)).astype(np.float32))
    weight = torch.from_numpy(g0.uniform(0.5, 2, (cout, cin, k, k)).astype(np.float32))
    bias = torch.from_numpy(g0.normal(size=cout).astype(np.float32)) if with_bias else None
    out, conf_out = nconv_cuda.nconv2d_plain(data, conf, weight, bias)
    go = torch.from_numpy(g0.normal(size=out.shape).astype(np.float32))
    gc = torch.from_numpy(g0.normal(size=out.shape).astype(np.float32))
    args = (data, conf, weight, bias, out, conf_out, go, gc, 1e-20)
    dw, db = _nconv_partials_emulation(*args)
    ref = nconv_cuda.nconv2d_backward_plain(*args)
    assert (dw - ref[2]).abs().max() <= 1e-5 * ref[2].abs().max()
    if with_bias:
        assert (db - ref[3]).abs().max() <= 1e-5 * ref[3].abs().max()


# ------------------------------------------------- chip_compare's new rows

def test_chip_compare_backward_rows_run_on_chip_smokes_inputs(monkeypatch, capsys):
    """The A' and B' rows of chip_compare run end to end at tiny shapes on
    the CPU (each wrapper takes its plain version there): they draw with
    chip_smoke's input functions, hold the kernel against the plain
    version and print one ``compare:`` line each."""
    monkeypatch.setattr(torch.Tensor, "cuda", lambda self, *a, **k: self)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda *a, **k: 0.0)
    monkeypatch.setattr(chip_smoke, "TRAIN_CORR",
                        dict(B=1, H=6, W=9, C=8, levels=2, radius=2))
    monkeypatch.setattr(chip_smoke, "TRAIN_PLANES", (1, 12, 20))
    gen = torch.Generator().manual_seed(0)
    for mix in chip_compare.BWD_MIXES:
        assert chip_compare.corr_bwd_row(torch, chip_smoke, gen, None, ".", mix)
    for name, k, cin, cout in chip_smoke.NCUP_LAYERS:
        assert chip_compare.nconv_bwd_row(torch, chip_smoke, gen, None, ".", name, k, cin, cout)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("compare: ")]
    rows = [json.loads(ln[len("compare: "):])["row"] for ln in lines]
    assert rows == ["A' training random", "A' training smooth"] + [
        f"B' {name}" for name, *_ in chip_smoke.NCUP_LAYERS]


def test_chip_compare_backward_rows_time_what_chip_smoke_checks(monkeypatch):
    """chip_compare's A' and B' rows and chip_smoke's backward phases draw
    the same inputs, in the same order, whatever chip_smoke drew before:
    A' random then smooth from one fresh ``backward_generator``, B' at the
    four layers from another. Both sides run on the CPU at tiny shapes
    (each wrapper takes its plain version there)."""
    monkeypatch.setattr(torch.Tensor, "cuda", lambda self, *a, **k: self)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda *a, **k: 0.0)
    monkeypatch.setattr(chip_smoke, "TRAIN_CORR",
                        dict(B=1, H=6, W=9, C=8, levels=2, radius=2))
    monkeypatch.setattr(chip_smoke, "TRAIN_PLANES", (1, 12, 20))
    monkeypatch.setattr(chip_smoke, "NCONV_EDGES", [])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)

    def counts_on_cpu(torch_, f1s, lv, coords, radius, g, needs):
        got = corr_cuda.lookup_levels_backward(f1s, lv, coords, radius, g, needs)
        return got, corr_cuda.backward_work(
            coords, [(t.shape[1], t.shape[2]) for t in lv], radius, f1s.shape[-1], needs)

    monkeypatch.setattr(chip_smoke, "corr_bwd_counts", counts_on_cpu)
    monkeypatch.setattr(chip_smoke, "check_corr_bwd_edges",
                        lambda torch_, gen: torch.randn(7, generator=gen))
    drawn = {}
    side = []
    real_corr, real_nconv = chip_smoke.corr_bwd_inputs, chip_smoke.nconv_bwd_inputs

    def corr(torch_, gen, mix):
        got = real_corr(torch_, gen, mix)
        drawn.setdefault(side[-1], []).append((f"A' {mix}", got))
        return got

    def nconv(torch_, gen, name, *shape):
        got = real_nconv(torch_, gen, name, *shape)
        drawn.setdefault(side[-1], []).append((f"B' {name}", got))
        return got

    monkeypatch.setattr(chip_smoke, "corr_bwd_inputs", corr)
    monkeypatch.setattr(chip_smoke, "nconv_bwd_inputs", nconv)
    side.append("smoke")
    earlier = torch.Generator().manual_seed(0)
    torch.randn(1000, generator=earlier)  # the phases before the backward ones
    chip_smoke.check_backward(torch, earlier, None)
    side.append("compare")
    assert chip_compare.backward_rows(torch, chip_smoke, None, ".")

    def flat(x):
        if x is None:
            return [None]
        if isinstance(x, (list, tuple)):
            return [t for v in x for t in flat(v)]
        return [x]

    names = [[n for n, _ in drawn[k]] for k in ("smoke", "compare")]
    assert names[0] == names[1] == ["A' random", "A' smooth"] + [
        f"B' {name}" for name, *_ in chip_smoke.NCUP_LAYERS]
    for (_, a), (_, b) in zip(drawn["smoke"], drawn["compare"]):
        for x, y in zip(flat(a), flat(b), strict=True):
            assert (x is None and y is None) or torch.equal(x, y)
    # and they are seed 0's first draws, not those after chip_smoke's earlier phases
    f1s = real_corr(torch, torch.Generator().manual_seed(0), "random")[0]
    assert torch.equal(drawn["smoke"][0][1][0], f1s)


@pytest.mark.parametrize(
    "source,group",
    [("corr_lookup.cu", "corr_lookup_kernel"), ("corr_lookup_bwd.cu", "corr_lookup_bwd_kernel"),
     ("nconv.cu", "nconv_kernel"), ("nconv_bwd.cu", "nconv_bwd_kernel")],
)
def test_trace_groups_every_kernel_of_its_source(source, group):
    """chip_smoke's trace puts each kernel function of a source in that
    kernel's group (what the train split and the profile read)."""
    path = os.path.join(os.path.dirname(corr_cuda.__file__), "..", "csrc", source)
    names = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(",
                       open(path).read())
    assert names
    for name in names:
        traced = f"void (anonymous namespace)::{name}<5, 2, 2>(float*)"
        assert chip_smoke._kernel_group(traced) == group
