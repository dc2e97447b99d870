"""Parity of the port's correlation lookup (kernel A's function) with the
JAX package, on the CPU.

On a CPU tensor the port's fused-lookup wrapper runs its plain version,
so these tests hold that plain version (and the port's volume path)
against JAX ``corr_lookup_pallas`` in interpret mode and against JAX
``corr_lookup(build_corr_pyramid(...))``. Tolerance atol = rtol = 1e-4:
the same function summed in another order in f32, the bound
``tests/test_corr_pallas.py`` holds the Pallas kernel to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_ncup_tpu.config import flagship_config as jax_flagship_config
from raft_ncup_tpu.models.raft import RAFT as JaxRAFT
from raft_ncup_tpu.ops.corr import build_corr_pyramid as jax_build_pyramid
from raft_ncup_tpu.ops.corr import corr_lookup as jax_corr_lookup
from raft_ncup_tpu.ops.corr_pallas import corr_lookup_pallas
from raft_ncup_tpu_torch.config import flagship_config
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.ops import corr as pcorr
from raft_ncup_tpu_torch.ops import corr_cuda

TOL = dict(atol=1e-4, rtol=1e-4)


def _maps(seed, b, h, w, c):
    g = np.random.default_rng(seed)
    f1 = g.normal(size=(b, h, w, c)).astype(np.float32)
    f2 = g.normal(size=(b, h, w, c)).astype(np.float32)
    return f1, f2


def _grid(b, h, w):
    y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.broadcast_to(
        np.stack([x, y], -1)[None], (b, h, w, 2)
    ).astype(np.float32)


def _fractional_oob_coords(seed, b, h, w):
    """Grid + fractional offsets + large displacements that push about a
    third of the windows fully out of bounds in every direction."""
    g = np.random.default_rng(seed)
    big = g.uniform(-1.5 * max(h, w), 1.5 * max(h, w), (b, h, w, 2))
    mask = g.random((b, h, w, 2)) < 0.3
    frac = g.uniform(-0.99, 0.99, (b, h, w, 2))
    return (_grid(b, h, w) + big * mask + frac).astype(np.float32)


def _jax_refs(f1, f2, coords, radius, levels):
    jf1, jf2, jc = jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(coords)
    # Jitted: one compile each instead of one per primitive.
    pallas = jax.jit(
        lambda a, b, c: corr_lookup_pallas(a, b, c, radius, levels, True)
    )(jf1, jf2, jc)
    volume = jax.jit(
        lambda a, b, c: jax_corr_lookup(jax_build_pyramid(a, b, levels), c, radius)
    )(jf1, jf2, jc)
    return np.asarray(pallas), np.asarray(volume)


def _port(f1, f2, coords, radius, levels):
    t = torch.from_numpy
    fused = corr_cuda.corr_lookup_fused(t(f1), t(f2), t(coords), radius, levels)
    volume = pcorr.corr_lookup(
        pcorr.build_corr_pyramid(t(f1), t(f2), levels), t(coords), radius
    )
    return fused.numpy(), volume.numpy()


OOB_SHIFTS = np.asarray(
    [(1.0, 0.0), (-1.0, 0.0), (0.0, 1.0), (-1.0, -1.0)], np.float32
)


def _grid_fractional_oob(b, h, w):
    """Batch element 0 on the grid; element 1 fractional with a third of
    its windows out of bounds; elements 2-5 with every window pushed out
    right, left, down and up-left."""
    far = _grid(len(OOB_SHIFTS), h, w) + OOB_SHIFTS[:, None, None, :] * 4.0 * max(h, w)
    return np.concatenate(
        [_grid(1, h, w), _fractional_oob_coords(1, 1, h, w), far], axis=0
    )


def _smooth_field_coords(b, h, w):
    """Grid + a seeded 3x4 coarse field of up to +-6 px, bilinearly
    upsampled (the smooth flow the model produces), + sub-pixel noise."""
    g = np.random.default_rng(5)
    coarse = g.uniform(-6.0, 6.0, (b, 3, 4, 2))
    ys, xs = np.linspace(0, 2, h), np.linspace(0, 3, w)
    y0 = np.minimum(np.floor(ys).astype(int), 1)
    x0 = np.minimum(np.floor(xs).astype(int), 2)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    c = coarse[:, y0][:, :, x0], coarse[:, y0][:, :, x0 + 1]
    d = coarse[:, y0 + 1][:, :, x0], coarse[:, y0 + 1][:, :, x0 + 1]
    field = (1 - fy) * ((1 - fx) * c[0] + fx * c[1]) + fy * ((1 - fx) * d[0] + fx * d[1])
    noise = g.uniform(-0.5, 0.5, (b, h, w, 2))
    return (_grid(b, h, w) + field + noise).astype(np.float32)


CASES = {
    # name: (b, h, w, c, radius, levels, coords maker)
    "grid_fractional_oob": (6, 8, 12, 16, 3, 3, _grid_fractional_oob),
    "smooth_field": (2, 12, 16, 12, 4, 3, _smooth_field_coords),
    # 9x11 -> 4x5 -> 2x2 -> 1x1: avg_pool2 drops an odd row and column,
    # and the deepest level is 1x1, at the flagship radius.
    "odd_sizes_1x1_deepest": (1, 9, 11, 8, 4, 4,
                              lambda b, h, w: _fractional_oob_coords(3, b, h, w)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_lookup_matches_jax(name):
    b, h, w, c, radius, levels, make = CASES[name]
    f1, f2 = _maps(10, b, h, w, c)
    coords = make(b, h, w)
    jp, jv = _jax_refs(f1, f2, coords, radius, levels)
    fused, volume = _port(f1, f2, coords, radius, levels)
    assert fused.shape == jp.shape == (b, h, w, levels * (2 * radius + 1) ** 2)
    print(f"{name}: max|fused-pallas| {np.abs(fused - jp).max():.3e}, "
          f"max|volume-volume| {np.abs(volume - jv).max():.3e}")
    np.testing.assert_allclose(fused, jp, **TOL)
    np.testing.assert_allclose(fused, jv, **TOL)
    np.testing.assert_allclose(volume, jv, **TOL)
    if name == "grid_fractional_oob":
        # Fully out-of-bounds windows are exact zeros on both sides.
        assert not fused[2:].any()
        np.testing.assert_array_equal(fused[2:], jp[2:])


def test_model_corr_closure_matches_jax():
    """The correlation closure exactly as each model builds it for
    ``corr_impl="pallas"`` (JAX: interpret-mode kernel per level; port:
    pooled pyramid prepared once, the wrapper per call)."""
    b, h, w, c = 1, 8, 12, 256
    f1, f2 = _maps(12, b, h, w, c)
    coords = _fractional_oob_coords(4, b, h, w)
    jmodel = JaxRAFT(jax_flagship_config(corr_impl="pallas"))
    jfn = jmodel._build_corr_fn(jnp.asarray(f1), jnp.asarray(f2))
    ref = np.asarray(jfn(jnp.asarray(coords)))
    pmodel = RAFT(flagship_config(corr_impl="pallas"), device="cpu")
    pfn = pmodel._build_corr_fn(torch.from_numpy(f1), torch.from_numpy(f2))
    out = pfn(torch.from_numpy(coords)).numpy()
    assert out.shape == ref.shape == (b, h, w, 324)
    print(f"closure: max|port-jax| {np.abs(out - ref).max():.3e}")
    np.testing.assert_allclose(out, ref, **TOL)


def test_cpu_wrapper_runs_plain_version_and_counts_nothing():
    f1, f2 = _maps(13, 1, 8, 8, 8)
    t = torch.from_numpy
    before = corr_cuda.lookup_levels.launches
    f1s, levels = corr_cuda.prepare_levels(t(f1), t(f2), 2)
    out = corr_cuda.lookup_levels(f1s, levels, t(_grid(1, 8, 8)), 2)
    ref = corr_cuda.lookup_pyramid(f1s, levels, t(_grid(1, 8, 8)), 2)
    assert corr_cuda.lookup_levels.launches == before
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
