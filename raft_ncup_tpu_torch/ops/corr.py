"""All-pairs correlation and multi-scale windowed lookup, plain PyTorch
(port of ``raft_ncup_tpu/ops/corr.py``).

- ``build_corr_pyramid`` + ``corr_lookup`` materialize the O((HW)^2)
  volume once per pair (``corr_impl="volume"``).
- ``corr_lookup_onthefly`` never materializes it: correlation is linear
  in fmap2, so sampling fmap2 at the window taps and contracting with
  fmap1 equals sampling the volume (``corr_impl="onthefly"``).
- The fused lookup (``corr_impl="pallas"``) is ``ops/corr_cuda.py``;
  its plain version, ``corr_cuda.lookup_pyramid``, is the core of
  ``corr_lookup_onthefly``.

All functions are NHWC; the output is (B, H, W, L * (2r+1)^2) in
level-major, then x-major tap order, f32. ``dtype`` is the correlation
features' storage dtype (the precision policy's ``corr``; default f32):
the volume or the fmap2 pyramid is stored and pooled at it, each level
rounded to it, as the JAX package does; sums are taken in f32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from raft_ncup_tpu_torch.ops.geometry import avg_pool2, grid_sample


class CorrPyramid(NamedTuple):
    """Materialized correlation pyramid: ``levels[l]`` is
    (B, H1*W1, H2/2^l, W2/2^l), pre-divided by sqrt(C)."""

    levels: tuple[torch.Tensor, ...]


def _delta_window(radius: int, device=None) -> torch.Tensor:
    """(K, K, 2) window offsets, K = 2r+1. Tap (i, j) offsets x by i - r
    and y by j - r, so the flattened window is x-major: the reference's
    tap order, which the motion encoder's weights depend on."""
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    di, dj = torch.meshgrid(d, d, indexing="ij")
    return torch.stack([di, dj], dim=-1)


def build_corr_pyramid(
    fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4,
    dtype: torch.dtype | None = None,
) -> CorrPyramid:
    """All-pairs correlation of two (B, H, W, C) maps and its 2x2
    average pyramid, stored at ``dtype``: the maps are rounded to it, the
    dot products summed in f32 and the volume rounded to it."""
    B, H, W, C = fmap1.shape
    H2, W2 = fmap2.shape[1], fmap2.shape[2]
    dtype = dtype or torch.float32
    f1 = fmap1.reshape(B, H * W, C).to(dtype).float()
    f2 = fmap2.reshape(B, H2 * W2, C).to(dtype).float()
    corr = torch.einsum("bxc,byc->bxy", f1, f2) / math.sqrt(C)
    corr = corr.to(dtype).reshape(B, H * W, H2, W2)
    levels = [corr]
    for _ in range(num_levels - 1):
        n, q, h, w = levels[-1].shape
        pooled = avg_pool2(levels[-1].reshape(n * q, h, w, 1))
        levels.append(pooled.reshape(n, q, pooled.shape[1], pooled.shape[2]))
    return CorrPyramid(levels=tuple(levels))


def corr_lookup(
    pyramid: CorrPyramid, coords: torch.Tensor, radius: int
) -> torch.Tensor:
    """Sample (2r+1)^2 windows around ``coords / 2^l`` at every level of a
    materialized pyramid. coords: (B, H, W, 2)."""
    B, H, W, _ = coords.shape
    K = 2 * radius + 1
    delta = _delta_window(radius, coords.device)
    out = []
    for lvl, corr in enumerate(pyramid.levels):
        _, _, Hl, Wl = corr.shape
        centroid = coords.reshape(B, H * W, 1, 1, 2) / (2**lvl)
        c = (centroid + delta).reshape(B * H * W, K, K, 2)
        vol = corr.reshape(B * H * W, Hl, Wl, 1)
        out.append(grid_sample(vol, c).reshape(B, H, W, K * K))
    return torch.cat(out, dim=-1)


def _pool_fmap_pyramid(
    fmap2: torch.Tensor, num_levels: int, dtype: torch.dtype | None = None
) -> list[torch.Tensor]:
    """Average-pool fmap2 into a pyramid. Pooling the features and then
    correlating equals pooling the correlation volume, because the 2x2
    mean acts on the fmap2 axes only and correlation is linear in fmap2.
    With ``dtype``, fmap2 is rounded to it first and each level is pooled
    from the level above as rounded to it."""
    levels = [fmap2 if dtype is None else fmap2.to(dtype)]
    for _ in range(num_levels - 1):
        levels.append(avg_pool2(levels[-1]))
    return levels


def corr_lookup_onthefly(
    fmap1: torch.Tensor,
    fmap2: torch.Tensor,
    coords: torch.Tensor,
    radius: int,
    num_levels: int = 4,
    dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Equivalent to ``corr_lookup(build_corr_pyramid(f1, f2), coords, r)``
    up to float associativity, without materializing the volume.
    fmap1, fmap2: (B, H, W, C), rounded to ``dtype``; coords: (B, H, W, 2)."""
    from raft_ncup_tpu_torch.ops.corr_cuda import lookup_pyramid

    C = fmap1.shape[-1]
    dtype = dtype or torch.float32
    f2_levels = _pool_fmap_pyramid(fmap2, num_levels, dtype)
    f1s = fmap1.to(dtype).float() * (1.0 / math.sqrt(C))
    return lookup_pyramid(f1s, f2_levels, coords, radius)
