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

:func:`lookup_levels` is the wrapper. For a CPU tensor it runs the plain
version, :func:`lookup_pyramid` (the on-the-fly lookup of
``ops/corr.py``); for a CUDA tensor it launches the kernel or raises.
``lookup_levels.launches`` counts the launches. Forward only in this
slice: a CUDA call whose inputs require grad raises.

Each tile of 2x4 queries at one level, one warp's work, takes one of two
exact paths: the tiled path reads the bounding box of the tile's windows
once for all 8 queries when the windows overlap enough (smooth flow,
coarse levels); the per-query path reads each query's window (random
flow, far windows, C above 256). The kernel counts the tiles of each
path on the device; :func:`path_tiles` reads the counts and
:func:`reset_path_tiles` zeroes them. :func:`tile_paths` states the same
rule in plain tensor code.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from raft_ncup_tpu_torch.ops import cuda_build
from raft_ncup_tpu_torch.ops.corr import _delta_window, _pool_fmap_pyramid
from raft_ncup_tpu_torch.ops.geometry import grid_sample
from raft_ncup_tpu_torch.utils.device import f32_precision

KERNEL = "corr_lookup"
SOURCE = "raft_ncup_tpu_torch/csrc/corr_lookup.cu"
MAX_LEVELS = 8
MAX_CHANNELS = 512
MAX_RADIUS = 8
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
      (B, H, W, L * (2r+1)^2) float32, level-major then x-major taps.
    """
    B, H, W, C = f1s.shape
    K = 2 * radius + 1
    delta = _delta_window(radius, coords.device)
    chunks = []
    for r0 in range(0, H, ROW_CHUNK):
        f1c = f1s[:, r0: r0 + ROW_CHUNK].float()
        cc = coords[:, r0: r0 + ROW_CHUNK].float()
        per_level = []
        for lvl, f2l in enumerate(f2_levels):
            taps = cc[:, :, :, None, None, :] / (2**lvl) + delta
            sampled = grid_sample(f2l.float(), taps)  # (B, rc, W, K, K, C)
            corr = torch.einsum("brwijc,brwc->brwij", sampled, f1c)
            per_level.append(corr.reshape(*corr.shape[:3], K * K))
        chunks.append(torch.cat(per_level, dim=-1))
    return torch.cat(chunks, dim=1)


def prepare_levels(
    fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """(B, H, W, C) maps -> (fmap1 * 1/sqrt(C), pooled fmap2 pyramid),
    f32 and contiguous: the operands of :func:`lookup_levels`."""
    C = fmap1.shape[-1]
    f1s = (fmap1.float() * (1.0 / math.sqrt(C))).contiguous()
    levels = [
        lv.contiguous() for lv in _pool_fmap_pyramid(fmap2.float(), num_levels)
    ]
    return f1s, levels


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
    ty, tx = -(-H // TILE_H), -(-W // TILE_W)
    tiles = len(level_hw) * B * ty * tx
    if channels > MAX_TILED_CHANNELS or tiles == 0:
        return 0, tiles
    k1 = 2 * radius + 2
    pad = (0, tx * TILE_W - W, 0, ty * TILE_H - H)
    far = float(2**29)

    def per_tile(v, fill, reduce):
        """(B, H, W) -> (B, ty, tx), the padding filled with ``fill``."""
        v = torch.nn.functional.pad(v, pad, value=fill)
        return reduce(v.reshape(B, ty, TILE_H, tx, TILE_W), dim=(2, 4))

    tiled = 0
    for lvl, (hl, wl) in enumerate(level_hw):
        o = torch.floor(coords.float() / float(2**lvl)) - radius
        ox = o[..., 0].clamp(-k1, wl)
        oy = o[..., 1].clamp(-k1, hl)
        x0, x1 = ox.clamp(min=0), (ox + k1).clamp(max=wl)
        y0, y1 = oy.clamp(min=0), (oy + k1).clamp(max=hl)
        some = (x0 < x1) & (y0 < y1)
        area = torch.where(some, (x1 - x0) * (y1 - y0), 0.0)
        bx0 = per_tile(x0.masked_fill(~some, far), far, torch.amin)
        bx1 = per_tile(x1.masked_fill(~some, -far), -far, torch.amax)
        by0 = per_tile(y0.masked_fill(~some, far), far, torch.amin)
        by1 = per_tile(y1.masked_fill(~some, -far), -far, torch.amax)
        npix = (bx1 - bx0).clamp(min=0) * (by1 - by0).clamp(min=0)
        tiled += int((STRIP_RATIO * npix <= per_tile(area, 0.0, torch.sum)).sum())
    return tiled, tiles - tiled


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


_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = cuda_build.load(KERNEL)
        fn = lib.corr_lookup_f32
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
        _fn = (lib, fn)
    return _fn


def _check_operands(f1s, f2_levels, coords, radius) -> None:
    tensors = [f1s, coords, *f2_levels]
    dev = f1s.device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"corr lookup: tensors on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"corr lookup: f32 only in this slice, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("corr lookup: operands must be contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                "corr lookup kernel is forward-only in this slice; its "
                "backward lands with the training slice"
            )
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
    for t in (f1s, *f2_levels):
        if t.data_ptr() % 16:
            raise ValueError("corr lookup: feature rows must be 16-byte aligned")


def lookup_levels(
    f1s: torch.Tensor,
    f2_levels: Sequence[torch.Tensor],
    coords: torch.Tensor,
    radius: int,
) -> torch.Tensor:
    """The kernel's wrapper: (B, H, W, C) pre-scaled queries, the pooled
    pyramid and (B, H, W, 2) coords -> (B, H, W, L*(2r+1)^2) f32.

    A CPU tensor takes :func:`lookup_pyramid`; a CUDA tensor launches
    the kernel on the current stream or raises."""
    if f1s.device.type == "cpu":
        return lookup_pyramid(f1s, f2_levels, coords, radius)
    if f1s.device.type != "cuda":
        raise ValueError(f"corr lookup: unsupported device {f1s.device}")
    _check_operands(f1s, f2_levels, coords, radius)
    lib, fn = _launcher()
    B, H, W, C = f1s.shape
    L = len(f2_levels)
    K = 2 * radius + 1
    out = torch.empty((B, H, W, L * K * K), dtype=torch.float32, device=f1s.device)
    ptrs = (ctypes.c_void_p * L)(*[lv.data_ptr() for lv in f2_levels])
    hw = (ctypes.c_int * (2 * L))(
        *[d for lv in f2_levels for d in (lv.shape[1], lv.shape[2])]
    )
    rc = fn(
        f1s.data_ptr(), coords.data_ptr(), ptrs, hw, L, B, H, W, C, radius,
        out.data_ptr(), _counts_buffer(f1s.device).data_ptr(),
        f1s.device.index, torch.cuda.current_stream(f1s.device).cuda_stream,
    )
    cuda_build.check(rc, lib, "corr_lookup_f32")
    lookup_levels.launches += 1
    return out


lookup_levels.launches = 0


def corr_lookup_fused(
    fmap1: torch.Tensor,
    fmap2: torch.Tensor,
    coords: torch.Tensor,
    radius: int,
    num_levels: int = 4,
) -> torch.Tensor:
    """Counterpart of ``corr_lookup_pallas``: (B, H, W, C) x2 + (B, H, W, 2)
    -> (B, H, W, L*(2r+1)^2) f32, without the correlation volume."""
    f1s, levels = prepare_levels(fmap1, fmap2, num_levels)
    return lookup_levels(f1s, levels, coords.float().contiguous(), radius)
