"""Fused correlation-window lookup: the wrapper around the CUDA kernel
``csrc/corr_lookup.cu`` and its plain PyTorch version.

Counterpart of ``raft_ncup_tpu/ops/corr_pallas.py``'s
``corr_lookup_pallas``: the Pallas resident-tier kernel
(``_lookup_kernel``) and banded-tier kernel (``_banded_lookup_kernel``)
compute one function, and one CUDA kernel computes it here, for all
pyramid levels in one launch; the volume never exists. The source notes
what bounds it on the card and what its design does about that.

As in the JAX op, the pyramid pooling and the 1/sqrt(C) pre-scale of
fmap1 stay plain tensor code around the launch (:func:`prepare_levels`);
the model prepares them once per pair and calls :func:`lookup_levels`
every iteration.

The features are f32 or, under the bf16 precision presets, bf16, as the
Pallas kernels take them (``corr_pallas.py:718-719``): the scaled fmap1
and each pooled level rounded to bf16. The kernel has an entry point for
each (``corr_lookup_f32``, ``corr_lookup_bf16``); both sum in f32 and
write f32. The backward kernel takes f32 only: the backward of a bf16
lookup upcasts its saved operands first, as JAX differentiates its f32
XLA path (``corr_pallas.py:816-832``), and returns the cotangents at the
operands' dtype.

:func:`lookup_levels` is the wrapper. For a CPU tensor it runs the plain
version, :func:`lookup_pyramid` (the on-the-fly lookup of
``ops/corr.py``); for a CUDA tensor it launches the kernel or raises.
``lookup_levels.launches`` counts the launches, and
``lookup_levels.launches_by_dtype`` counts them by the features' dtype
(``"float32"``, ``"bfloat16"``). When an input needs a
gradient, the call goes through an ``autograd.Function`` whose backward
is :func:`lookup_levels_backward`: the hand-written backward kernel
``csrc/corr_lookup_bwd.cu`` on the card (``.launches`` counts it), the
plain :func:`lookup_pyramid_backward` (the autograd of the plain
version) on the CPU. The JAX op differentiates its XLA path the same way
(``corr_pallas.py:816``).

Each tile of 2x4 queries at one level, one warp's work, takes one of two
exact paths: the tiled path reads the bounding box of the tile's windows
once for all 8 queries when the windows overlap enough (smooth flow,
coarse levels); the per-query path reads each query's window (random
flow, far windows, C above 256). The kernel counts the tiles of each
path on the device; :func:`path_tiles` reads the counts and
:func:`reset_path_tiles` zeroes them. :func:`tile_paths` states the same
rule in plain tensor code.

The backward kernel takes the same tiles and the same rule per level: a
tiled tile sums its box once and adds one d f2 row per covered box pixel,
a per-query tile adds a row per window position (every tile, when d
coords is asked for). :func:`backward_counts` reads its device counts
(tiles per path, d f2 row adds), :func:`reset_backward_counts` zeroes
them and :func:`backward_work` states them in tensor code.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import numpy as np
import torch

from raft_ncup_tpu_torch.ops import cuda_build
from raft_ncup_tpu_torch.ops.corr import _delta_window, _pool_fmap_pyramid
from raft_ncup_tpu_torch.ops.geometry import grid_sample
from raft_ncup_tpu_torch.utils.device import f32_precision

KERNEL = "corr_lookup"
KERNEL_BWD = "corr_lookup_bwd"
SOURCE = "raft_ncup_tpu_torch/csrc/corr_lookup.cu"
MAX_LEVELS = 8
MAX_CHANNELS = 512
MAX_RADIUS = 8
# The features' dtypes the forward kernel takes, each with its entry point
# and the alignment of a 4-channel chunk (one vector load).
FEATURE_DTYPES = {torch.float32: ("corr_lookup_f32", 16),
                  torch.bfloat16: ("corr_lookup_bf16", 8)}
# The kernel's tiling and path rule, as its constants in csrc/corr_lookup.cu
# (kTileH, kTileW, kMaxTiledNV, kStripRatio) fix them: tiles of TILE_H rows
# of TILE_W queries. A tile takes the tiled path when C <= MAX_TILED_CHANNELS
# and STRIP_RATIO * (pixels of the bounding box of its clipped windows) <=
# (sum of the clipped windows' areas): each box pixel read serves at least
# STRIP_RATIO window positions.
TILE_H, TILE_W = 2, 4
MAX_TILED_CHANNELS = 256
STRIP_RATIO = 2
# Query rows the plain version samples at once; bounds its peak memory.
ROW_CHUNK = 8


def _plain_dtype(f1s: torch.Tensor) -> torch.dtype:
    return torch.float64 if f1s.dtype == torch.float64 else torch.float32


@f32_precision()
def lookup_pyramid(
    f1s: torch.Tensor,
    f2_levels: Sequence[torch.Tensor],
    coords: torch.Tensor,
    radius: int,
) -> torch.Tensor:
    """Plain version of the kernel: windowed correlation on prepared
    inputs, sampling fmap2 at the window taps and contracting with the
    query features (TF32 off), ``ROW_CHUNK`` query rows at a time.

    Args:
      f1s: (B, H, W, C) query features, already scaled by 1/sqrt(C).
      f2_levels: the pooled fmap2 pyramid, each (B, Hl, Wl, C).
      coords: (B, H, W, 2) query positions in level-0 pixels, x first.
    Returns:
      (B, H, W, L * (2r+1)^2) float32 (float64 for float64 ``f1s``, the
      reference the kernels' checks hold their results against),
      level-major then x-major taps.
    """
    B, H, W, C = f1s.shape
    K = 2 * radius + 1
    dt = _plain_dtype(f1s)
    delta = _delta_window(radius, coords.device)
    chunks = []
    for r0 in range(0, H, ROW_CHUNK):
        f1c = f1s[:, r0: r0 + ROW_CHUNK].to(dt)
        cc = coords[:, r0: r0 + ROW_CHUNK].to(dt)
        per_level = []
        for lvl, f2l in enumerate(f2_levels):
            taps = cc[:, :, :, None, None, :] / (2**lvl) + delta
            sampled = grid_sample(f2l.to(dt), taps)  # (B, rc, W, K, K, C)
            corr = torch.einsum("brwijc,brwc->brwij", sampled, f1c)
            per_level.append(corr.reshape(*corr.shape[:3], K * K))
        chunks.append(torch.cat(per_level, dim=-1))
    return torch.cat(chunks, dim=1)


@f32_precision()
def lookup_pyramid_backward(
    f1s: torch.Tensor,
    f2_levels: Sequence[torch.Tensor],
    coords: torch.Tensor,
    radius: int,
    grad: torch.Tensor,
    needs: tuple[bool, bool, bool] = (True, True, True),
) -> tuple[torch.Tensor | None, list[torch.Tensor] | None, torch.Tensor | None]:
    """Plain version of the backward kernel: the autograd of
    :func:`lookup_pyramid`, ``ROW_CHUNK`` query rows at a time so that the
    sampled windows of one chunk are alive at once.

    ``grad`` is the (B, H, W, L*(2r+1)^2) upstream gradient; ``needs``
    says which of (d f1s, d f2 levels, d coords) to return (None for the
    others). Like the forward it computes in float64 for float64
    ``f1s``."""
    H = f1s.shape[1]
    dt = _plain_dtype(f1s)
    levels = [lv.detach().to(dt).requires_grad_(needs[1]) for lv in f2_levels]
    df1 = torch.zeros_like(f1s, dtype=dt) if needs[0] else None
    dco = torch.zeros_like(coords, dtype=dt) if needs[2] else None
    dlv = [torch.zeros_like(lv) for lv in levels] if needs[1] else None
    for r0 in range(0, H, ROW_CHUNK):
        rows = slice(r0, r0 + ROW_CHUNK)
        f1c = f1s[:, rows].detach().to(dt).requires_grad_(needs[0])
        cc = coords[:, rows].detach().to(dt).requires_grad_(needs[2])
        wrt = [t for t, need in ((f1c, needs[0]), (cc, needs[2])) if need]
        if needs[1]:
            wrt += levels
        if not wrt:
            break
        with torch.enable_grad():
            out = lookup_pyramid(f1c, levels, cc, radius)
            # An empty level (0x0: a pyramid deeper than the image) takes
            # no part in the graph; its gradient stays the zeros above.
            grads = list(torch.autograd.grad(out, wrt, grad[:, rows].to(dt),
                                             allow_unused=True))
        if needs[0]:
            df1[:, rows] = _or_zero(grads.pop(0), f1c)
        if needs[2]:
            dco[:, rows] = _or_zero(grads.pop(0), cc)
        if needs[1]:
            for acc, d in zip(dlv, grads):
                if d is not None:
                    acc += d
    return df1, dlv, dco


def _or_zero(g: torch.Tensor | None, like: torch.Tensor) -> torch.Tensor:
    """``g``, or zeros of ``like``'s shape where autograd found no path."""
    return torch.zeros_like(like) if g is None else g


def prepare_levels(
    fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int,
    dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """(B, H, W, C) maps -> (fmap1 * 1/sqrt(C), pooled fmap2 pyramid),
    contiguous at ``dtype`` (default f32): the operands of
    :func:`lookup_levels`. As JAX's ``(fmap1 * scale).astype(dtype)``, the
    product is taken at fmap1's dtype (a bf16 fmap1 takes the scale
    rounded to bf16, as a JAX scalar takes the array's dtype) and rounded
    to ``dtype``; fmap2 is rounded to ``dtype`` and each level pooled from
    the level above as rounded (``ops.corr._pool_fmap_pyramid``)."""
    dtype = dtype or torch.float32
    scale = 1.0 / math.sqrt(fmap1.shape[-1])
    if fmap1.dtype == torch.bfloat16:
        f1s = fmap1 * _bf16_round(scale)
    else:
        f1s = fmap1.float() * scale
    levels = _pool_fmap_pyramid(fmap2, num_levels, dtype)
    return f1s.to(dtype).contiguous(), [lv.contiguous() for lv in levels]


def _bf16_round(x: float) -> float:
    """``x`` rounded to bfloat16 (through float32, to nearest even), as
    ``torch.tensor(x, dtype=torch.bfloat16)`` rounds it, on the host:
    the guards count a read of a tensor, even of one made on the host."""
    bits = int(np.float32(x).view(np.uint32))
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return float(np.uint32(bits).view(np.float32))


def _tile_windows(coords, level_hw, radius):
    """Per level, the clipped windows of every tile's queries:
    ``(x0, x1, y0, y1, some)``, each (B, ty, tx, TILE_H * TILE_W) with the
    queries of a tile row-major and the padding past the image empty;
    ``some`` says whether a window holds a pixel of its level. Coordinates
    are integral floats."""
    B, H, W, _ = coords.shape
    ty, tx = -(-H // TILE_H), -(-W // TILE_W)
    k1 = 2 * radius + 2
    pad = (0, tx * TILE_W - W, 0, ty * TILE_H - H)

    def per_tile(v):
        """(B, H, W) -> (B, ty, tx, TILE_H * TILE_W), the padding empty."""
        v = torch.nn.functional.pad(v, pad, value=float(-k1))
        v = v.reshape(B, ty, TILE_H, tx, TILE_W).permute(0, 1, 3, 2, 4)
        return v.reshape(B, ty, tx, TILE_H * TILE_W)

    for lvl, (hl, wl) in enumerate(level_hw):
        o = torch.floor(coords.float() / float(2**lvl)) - radius
        ox = per_tile(o[..., 0].clamp(-k1, wl))
        oy = per_tile(o[..., 1].clamp(-k1, hl))
        x0, x1 = ox.clamp(min=0), (ox + k1).clamp(max=wl)
        y0, y1 = oy.clamp(min=0), (oy + k1).clamp(max=hl)
        yield x0, x1, y0, y1, (x0 < x1) & (y0 < y1)


def _tile_rule(x0, x1, y0, y1, some):
    """(tiled, areas): whether each tile takes the tiled path by the
    kernels' box rule (channels aside), and the sum of its windows' areas."""
    far = float(2**29)
    area = torch.where(some, (x1 - x0) * (y1 - y0), 0.0).sum(-1)
    bx0 = x0.masked_fill(~some, far).amin(-1)
    bx1 = x1.masked_fill(~some, -far).amax(-1)
    by0 = y0.masked_fill(~some, far).amin(-1)
    by1 = y1.masked_fill(~some, -far).amax(-1)
    npix = (bx1 - bx0).clamp(min=0) * (by1 - by0).clamp(min=0)
    return STRIP_RATIO * npix <= area, area


def _union_area(x0, x1, y0, y1, some):
    """Pixels covered by at least one of the (..., n) clipped windows, by
    inclusion and exclusion over the 2^n - 1 subsets, each subset's
    intersection built from a smaller one's."""
    far = float(2**29)
    x0, y0 = x0.masked_fill(~some, far), y0.masked_fill(~some, far)
    x1, y1 = x1.masked_fill(~some, -far), y1.masked_fill(~some, -far)
    n = x0.shape[-1]
    inter = [None] * (1 << n)
    total = torch.zeros(x0.shape[:-1], dtype=torch.float64, device=x0.device)
    for subset in range(1, 1 << n):
        top = subset.bit_length() - 1
        rest = subset & ~(1 << top)
        box = (x0[..., top], x1[..., top], y0[..., top], y1[..., top])
        if rest:
            r = inter[rest]
            box = (torch.maximum(r[0], box[0]), torch.minimum(r[1], box[1]),
                   torch.maximum(r[2], box[2]), torch.minimum(r[3], box[3]))
        inter[subset] = box
        area = (box[1] - box[0]).clamp(min=0) * (box[3] - box[2]).clamp(min=0)
        total += area.double() if bin(subset).count("1") % 2 else -area.double()
    return total


def tile_paths(
    coords: torch.Tensor,
    level_hw: Sequence[tuple[int, int]],
    radius: int,
    channels: int,
) -> tuple[int, int]:
    """(tiled, per_query): the number of tiles that take each path for
    (B, H, W, 2) ``coords`` over levels of sizes ``level_hw`` and
    ``channels`` channels, by the kernel's rule. Each window is clipped to
    its level; a tile is tiled when ``channels`` is at most
    ``MAX_TILED_CHANNELS`` and ``STRIP_RATIO`` times the pixels of the
    bounding box of its clipped windows is at most the sum of their areas.
    Plain tensor code on the coords' device."""
    B, H, W, _ = coords.shape
    tiles = len(level_hw) * B * -(-H // TILE_H) * -(-W // TILE_W)
    if channels > MAX_TILED_CHANNELS or tiles == 0:
        return 0, tiles
    tiled = sum(int(_tile_rule(*win)[0].sum())
                for win in _tile_windows(coords, level_hw, radius))
    return tiled, tiles - tiled


def backward_work(
    coords: torch.Tensor,
    level_hw: Sequence[tuple[int, int]],
    radius: int,
    channels: int,
    needs: tuple[bool, bool, bool] = (True, True, False),
) -> dict[str, int]:
    """What the backward kernel does for these coords, by its rule: the
    (tile, level) pairs that take its tiled and its per-query path, and
    the rows of C floats it adds into the d f2 levels. With d coords
    (``needs[2]``) every tile takes the per-query path; otherwise a tile
    takes the forward's path (:func:`tile_paths`). A per-query tile adds
    a row per in-level window position, a tiled one a row per pixel of its
    box that some window covers; no rows without d f2 (``needs[1]``).
    Plain tensor code on the coords' device."""
    B, H, W, _ = coords.shape
    tiles = len(level_hw) * B * -(-H // TILE_H) * -(-W // TILE_W)
    tiled = adds = 0
    for win in _tile_windows(coords, level_hw, radius):
        rule, area = _tile_rule(*win)
        if needs[2] or channels > MAX_TILED_CHANNELS:
            rule = torch.zeros_like(rule)
        tiled += int(rule.sum())
        if needs[1]:
            adds += int(area[~rule].sum())
            if bool(rule.any()):
                adds += int(_union_area(*(t[rule] for t in win)).sum())
    return {"tiled": tiled, "per_query": tiles - tiled, "d_f2_row_adds": adds}


_path_counts: dict[torch.device, torch.Tensor] = {}


def _counts_buffer(device: torch.device) -> torch.Tensor:
    buf = _path_counts.get(device)
    if buf is None:
        buf = _path_counts[device] = torch.zeros(2, dtype=torch.int64, device=device)
    return buf


def path_tiles() -> dict[str, int]:
    """Tiles that took the tiled and the per-query path in every launch
    since the last :func:`reset_path_tiles`, over all devices. Reads the
    device counters, so it waits for the launches to finish."""
    tiled = per_query = 0
    for buf in _path_counts.values():
        t, q = buf.tolist()
        tiled, per_query = tiled + t, per_query + q
    return {"tiled": tiled, "per_query": per_query}


def reset_path_tiles() -> None:
    for buf in _path_counts.values():
        buf.zero_()


_bwd_counts: dict[torch.device, torch.Tensor] = {}


def _bwd_counts_buffer(device: torch.device) -> torch.Tensor:
    buf = _bwd_counts.get(device)
    if buf is None:
        buf = _bwd_counts[device] = torch.zeros(3, dtype=torch.int64, device=device)
    return buf


def backward_counts() -> dict[str, int]:
    """The backward kernel's (tile, level) pairs on its tiled and its
    per-query path and its d f2 row adds, in every launch since the last
    :func:`reset_backward_counts`, over all devices; :func:`backward_work`
    states them in tensor code. Reads the device counters, so it waits for
    the launches to finish."""
    total = [0, 0, 0]
    for buf in _bwd_counts.values():
        total = [a + b for a, b in zip(total, buf.tolist())]
    return dict(zip(("tiled", "per_query", "d_f2_row_adds"), total))


def reset_backward_counts() -> None:
    for buf in _bwd_counts.values():
        buf.zero_()


_fns: dict[torch.dtype, tuple] = {}


def _launcher(dtype: torch.dtype):
    """The library and the entry point for features of ``dtype``."""
    if dtype not in _fns:
        lib = cuda_build.load(KERNEL)
        fn = getattr(lib, FEATURE_DTYPES[dtype][0])
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
        _fns[dtype] = (lib, fn)
    return _fns[dtype]


def _level_table(levels):
    """The C arrays of the levels' pointers and of their (Hl, Wl)."""
    ptrs = (ctypes.c_void_p * len(levels))(*[lv.data_ptr() for lv in levels])
    hw = (ctypes.c_int * (2 * len(levels)))(
        *[d for lv in levels for d in (lv.shape[1], lv.shape[2])]
    )
    return ptrs, hw


def _check_operands(f1s, f2_levels, coords, radius, dtypes=(torch.float32,)) -> None:
    """Raise unless the operands are what the kernel takes: features of one
    dtype out of ``dtypes``, f32 coords, all contiguous on one device."""
    tensors = [f1s, coords, *f2_levels]
    dev = f1s.device
    if f1s.dtype not in dtypes:
        raise TypeError(
            f"corr lookup: features of {f1s.dtype}; this kernel takes {list(dtypes)}")
    if coords.dtype != torch.float32:
        raise TypeError(f"corr lookup: coords of {coords.dtype}, want float32")
    for lv in f2_levels:
        if lv.dtype != f1s.dtype:
            raise TypeError(
                f"corr lookup: f1s of {f1s.dtype} and a level of {lv.dtype}: "
                "the features take one dtype")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"corr lookup: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("corr lookup: operands must be contiguous")
    if f1s.dim() != 4 or coords.shape != (*f1s.shape[:3], 2):
        raise ValueError(
            f"corr lookup: f1s {tuple(f1s.shape)} / coords "
            f"{tuple(coords.shape)} are not (B, H, W, C) / (B, H, W, 2)"
        )
    B, _, _, C = f1s.shape
    if C % 4 or C > MAX_CHANNELS or not 0 <= radius <= MAX_RADIUS:
        raise ValueError(
            f"corr lookup: C={C} (want a multiple of 4, <= {MAX_CHANNELS}) "
            f"radius={radius} (want 0..{MAX_RADIUS})"
        )
    if not 1 <= len(f2_levels) <= MAX_LEVELS:
        raise ValueError(f"corr lookup: 1..{MAX_LEVELS} levels, got {len(f2_levels)}")
    for lv in f2_levels:
        if lv.dim() != 4 or lv.shape[0] != B or lv.shape[3] != C:
            raise ValueError(
                f"corr lookup: level {tuple(lv.shape)} is not (B, Hl, Wl, C)"
            )
    align = FEATURE_DTYPES[f1s.dtype][1]
    for t in (f1s, *f2_levels):
        if t.data_ptr() % align:
            raise ValueError(f"corr lookup: feature rows must be {align}-byte aligned")


def lookup_levels(
    f1s: torch.Tensor,
    f2_levels: Sequence[torch.Tensor],
    coords: torch.Tensor,
    radius: int,
) -> torch.Tensor:
    """The kernel's wrapper: (B, H, W, C) pre-scaled queries, the pooled
    pyramid (all f32 or all bf16) and (B, H, W, 2) f32 coords ->
    (B, H, W, L*(2r+1)^2) f32.

    A CPU tensor takes :func:`lookup_pyramid`; a CUDA tensor launches
    the kernel on the current stream or raises. With an input that needs
    a gradient the call is differentiable (:class:`_Lookup`)."""
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (f1s, coords, *f2_levels)
    ):
        return _Lookup.apply(f1s, coords, radius, *f2_levels)
    return _lookup_forward(f1s, f2_levels, coords, radius)


lookup_levels.launches = 0
lookup_levels.launches_by_dtype = {}
# A list while ``inference.costs.counting_flops`` counts a run: each launch
# appends its operations (``lookup_work``).
lookup_levels.work_log = None


def lookup_work(f1s, f2_levels, coords, radius) -> tuple[int, int]:
    """(bytes, operations) one lookup needs for these inputs: every input
    read once and the output written once (features at their own size, 4
    bytes in f32 and 2 in bf16; coords and output f32); two operations per
    multiply-add of the dot products at in-bounds patch positions
    (out-of-bounds ones need none), plus 7 per output tap for the bilinear
    blend. Reads the in-bounds count back to the host."""
    B, H, W, C = f1s.shape
    K = 2 * radius + 1
    n_out = B * H * W * len(f2_levels) * K * K
    nbytes = (f1s.element_size() * f1s.numel() + 4 * coords.numel()
              + sum(t.element_size() * t.numel() for t in f2_levels) + 4 * n_out)
    k1 = torch.arange(K + 1, device=coords.device, dtype=torch.float32)
    positions = 0
    for l, t in enumerate(f2_levels):
        hl, wl = t.shape[1], t.shape[2]
        p = coords.reshape(-1, 2) / float(2 ** l)
        o = torch.floor(p) - radius
        ix = o[:, 0:1] + k1
        iy = o[:, 1:2] + k1
        cx = ((ix >= 0) & (ix < wl)).sum(1)
        cy = ((iy >= 0) & (iy < hl)).sum(1)
        positions += int((cx * cy).sum())
    return nbytes, 2 * C * positions + 7 * n_out


def _lookup_forward(f1s, f2_levels, coords, radius) -> torch.Tensor:
    if f1s.device.type == "cpu":
        return lookup_pyramid(f1s, f2_levels, coords, radius)
    if f1s.device.type != "cuda":
        raise ValueError(f"corr lookup: unsupported device {f1s.device}")
    _check_operands(f1s, f2_levels, coords, radius, tuple(FEATURE_DTYPES))
    lib, fn = _launcher(f1s.dtype)
    B, H, W, C = f1s.shape
    L = len(f2_levels)
    K = 2 * radius + 1
    out = torch.empty((B, H, W, L * K * K), dtype=torch.float32, device=f1s.device)
    ptrs, hw = _level_table(f2_levels)
    rc = fn(
        f1s.data_ptr(), coords.data_ptr(), ptrs, hw, L, B, H, W, C, radius,
        out.data_ptr(), _counts_buffer(f1s.device).data_ptr(),
        f1s.device.index, torch.cuda.current_stream(f1s.device).cuda_stream,
    )
    cuda_build.check(rc, lib, FEATURE_DTYPES[f1s.dtype][0])
    lookup_levels.launches += 1
    by_dtype = lookup_levels.launches_by_dtype
    key = str(f1s.dtype).removeprefix("torch.")
    by_dtype[key] = by_dtype.get(key, 0) + 1
    if lookup_levels.work_log is not None:
        lookup_levels.work_log.append(lookup_work(f1s, f2_levels, coords, radius)[1])
    return out


class _Lookup(torch.autograd.Function):
    """The lookup with its backward: the forward kernel (or plain version)
    forward, :func:`lookup_levels_backward` backward. Saves only its
    inputs, as the JAX op does: bf16 operands stay bf16 until the backward
    upcasts them to f32 copies for the f32 backward kernel (or plain
    version); the cotangents return at the operands' dtype."""

    @staticmethod
    def forward(ctx, f1s, coords, radius, *f2_levels):
        ctx.radius = radius
        ctx.save_for_backward(f1s, coords, *f2_levels)
        return _lookup_forward(f1s, list(f2_levels), coords, radius)

    @staticmethod
    def backward(ctx, grad):
        f1s, coords, *levels = ctx.saved_tensors
        need = ctx.needs_input_grad
        needs = (need[0], any(need[3:]), need[1])
        up = _plain_dtype(f1s)  # bf16 -> f32; f32 and a float64 replay stay
        df1, dlv, dco = lookup_levels_backward(
            f1s.to(up).contiguous(), [lv.to(up).contiguous() for lv in levels],
            coords, ctx.radius, grad.contiguous(), needs,
        )
        if df1 is not None:
            df1 = df1.to(f1s.dtype)
        dlv = ([None] * len(levels) if dlv is None
               else [d.to(lv.dtype) for d, lv in zip(dlv, levels)])
        return (df1, dco, None, *dlv)


_bwd_fn = None


def _bwd_launcher():
    global _bwd_fn
    if _bwd_fn is None:
        lib = cuda_build.load(KERNEL_BWD)
        fn = lib.corr_lookup_bwd_f32
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
        _bwd_fn = (lib, fn)
    return _bwd_fn


def lookup_levels_backward(
    f1s: torch.Tensor,
    f2_levels: Sequence[torch.Tensor],
    coords: torch.Tensor,
    radius: int,
    grad: torch.Tensor,
    needs: tuple[bool, bool, bool] = (True, True, True),
) -> tuple[torch.Tensor | None, list[torch.Tensor] | None, torch.Tensor | None]:
    """The backward kernel's wrapper: the forward's operands and the
    (B, H, W, L*(2r+1)^2) upstream ``grad`` -> (d f1s, [d f2 level],
    d coords), each f32 or None where ``needs`` says it is not wanted.

    A CPU tensor takes :func:`lookup_pyramid_backward`; a CUDA tensor
    launches the kernel on the current stream or raises."""
    if f1s.device.type == "cpu":
        return lookup_pyramid_backward(f1s, f2_levels, coords, radius, grad, needs)
    if f1s.device.type != "cuda":
        raise ValueError(f"corr lookup: unsupported device {f1s.device}")
    _check_operands(f1s, f2_levels, coords, radius)
    B, H, W, C = f1s.shape
    L = len(f2_levels)
    K = 2 * radius + 1
    if (
        grad.device != f1s.device or grad.dtype != torch.float32
        or not grad.is_contiguous() or grad.shape != (B, H, W, L * K * K)
    ):
        raise ValueError(
            f"corr lookup backward: grad {tuple(grad.shape)} {grad.dtype} is not a "
            f"contiguous f32 ({B}, {H}, {W}, {L * K * K}) on {f1s.device}"
        )
    lib, fn = _bwd_launcher()
    df1 = torch.empty_like(f1s) if needs[0] else None
    dlv = [torch.zeros_like(lv) for lv in f2_levels] if needs[1] else None
    dco = torch.empty_like(coords) if needs[2] else None
    ptrs, hw = _level_table(f2_levels)
    gptrs = None if dlv is None else _level_table(dlv)[0]
    rc = fn(
        f1s.data_ptr(), coords.data_ptr(), ptrs, hw, L, B, H, W, C, radius,
        grad.data_ptr(), None if df1 is None else df1.data_ptr(), gptrs,
        None if dco is None else dco.data_ptr(),
        _bwd_counts_buffer(f1s.device).data_ptr(),
        f1s.device.index, torch.cuda.current_stream(f1s.device).cuda_stream,
    )
    cuda_build.check(rc, lib, "corr_lookup_bwd_f32")
    lookup_levels_backward.launches += 1
    return df1, dlv, dco


lookup_levels_backward.launches = 0


def corr_lookup_fused(
    fmap1: torch.Tensor,
    fmap2: torch.Tensor,
    coords: torch.Tensor,
    radius: int,
    num_levels: int = 4,
    dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Counterpart of ``corr_lookup_pallas``: (B, H, W, C) x2 + (B, H, W, 2)
    -> (B, H, W, L*(2r+1)^2) f32, without the correlation volume, the
    features at ``dtype`` (default f32)."""
    f1s, levels = prepare_levels(fmap1, fmap2, num_levels, dtype)
    return lookup_levels(f1s, levels, coords.float().contiguous(), radius)
