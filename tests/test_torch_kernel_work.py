"""The counts every kernel bound in PERF.md rests on, and the host-side
path rule of the correlation-lookup kernel, against brute force on small
shapes, on the CPU.

``chip_smoke.corr_work`` and ``chip_smoke.nconv_work`` give the bytes
and operations of kernel A (the correlation lookup) and kernel B (the
fused NConv2d) from this run's inputs; ``corr_cuda.tile_paths`` predicts
which tiles of 2x4 queries take kernel A's tiled path. Each is held here
against a plain loop over every query, window position, pixel or tap.
Importing ``chip_smoke`` needs no card: it decides only in ``main``.
"""

import math
import os

import numpy as np
import pytest
import torch

import chip_compare
import chip_smoke
from raft_ncup_tpu_torch.ops import corr_cuda


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
    shapes = {(b, h, w) for _, b, h, w, _ in chip_compare.ROWS}
    assert shapes == {(2, 55, 128), (1, 136, 240)}
