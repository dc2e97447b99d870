"""Parity of the port's geometry ops, encoder and update block with the
JAX package on the CPU (the pieces the whole-model test composes), with
JAX weights carried across. Geometry is exact or f32-rounding close;
the networks are held at atol 1e-4 / rtol 1e-4, f32 convolutions summed
in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_ncup_tpu.nn.extractor import BasicEncoder as JaxBasicEncoder
from raft_ncup_tpu.nn.update import BasicUpdateBlock as JaxBasicUpdateBlock
from raft_ncup_tpu.ops import geometry as jgeo
from raft_ncup_tpu_torch.nn.extractor import Encoder
from raft_ncup_tpu_torch.nn.update import BasicUpdateBlock
from raft_ncup_tpu_torch.ops import geometry as pgeo
from raft_ncup_tpu_torch.utils.jax_weights import load_jax_variables

NET_TOL = dict(atol=1e-4, rtol=1e-4)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def test_geometry_ops_match_jax():
    g = np.random.default_rng(0)
    img = g.normal(size=(2, 7, 9, 3)).astype(np.float32)
    coords = g.uniform(-2.0, 10.0, (2, 5, 4, 2)).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_array_equal(
        pgeo.coords_grid(2, 7, 9).numpy(), np.asarray(jgeo.coords_grid(2, 7, 9))
    )
    np.testing.assert_allclose(
        pgeo.grid_sample(t(img), t(coords)).numpy(),
        np.asarray(jgeo.grid_sample(jnp.asarray(img), jnp.asarray(coords))),
        atol=1e-6, rtol=1e-6,
    )
    np.testing.assert_array_equal(
        pgeo.upsample_nearest(t(img), 3).numpy(),
        np.asarray(jgeo.upsample_nearest(jnp.asarray(img), 3)),
    )
    np.testing.assert_allclose(  # odd sizes: the trailing row/col drops
        pgeo.avg_pool2(t(img)).numpy(), np.asarray(jgeo.avg_pool2(jnp.asarray(img))),
        atol=1e-6,
    )
    even = g.normal(size=(1, 8, 12, 2)).astype(np.float32)
    for hw in ((16, 24), (4, 6), (8, 12)):
        np.testing.assert_allclose(
            pgeo.adaptive_area_resize(t(even), hw).numpy(),
            np.asarray(jgeo.adaptive_area_resize(jnp.asarray(even), hw)),
            atol=1e-6,
        )


@pytest.mark.parametrize("norm_fn", ["instance", "batch"])
def test_basic_encoder_matches_jax(norm_fn):
    g = np.random.default_rng(1)
    x = g.uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32)
    jenc = JaxBasicEncoder(64, norm_fn)
    variables = jax.tree_util.tree_map(
        np.array, jax.jit(jenc.init)(jax.random.key(0), jnp.asarray(x))
    )
    for bn in jax.tree_util.tree_leaves(variables.get("batch_stats", {})):
        bn[...] = g.uniform(0.5, 1.5, bn.shape)  # non-trivial, positive
    ref = np.asarray(jax.jit(jenc.apply)(variables, jnp.asarray(x)))
    enc = load_jax_variables(Encoder(64, norm_fn), variables).eval()
    with torch.no_grad():
        out = _nhwc(enc(_nchw(x)))
    assert out.shape == ref.shape == (2, 4, 6, 64)
    np.testing.assert_allclose(out, ref, **NET_TOL)


def test_basic_update_block_matches_jax():
    g = np.random.default_rng(2)
    b, h, w, planes = 2, 4, 6, 4 * 81
    net = np.tanh(g.normal(size=(b, h, w, 128))).astype(np.float32)
    inp = np.maximum(g.normal(size=(b, h, w, 128)), 0).astype(np.float32)
    corr = g.normal(size=(b, h, w, planes)).astype(np.float32)
    flow = g.normal(0, 2, (b, h, w, 2)).astype(np.float32)
    jblk = JaxBasicUpdateBlock(planes, 128, use_mask_head=False)
    args = [jnp.asarray(a) for a in (net, inp, corr, flow)]
    variables = jax.tree_util.tree_map(
        np.array, jax.jit(jblk.init)(jax.random.key(3), *args)
    )
    ref_net, ref_mask, ref_delta = jax.jit(jblk.apply)(variables, *args)
    assert ref_mask is None
    blk = load_jax_variables(BasicUpdateBlock(planes, 128, 128), variables)
    with torch.no_grad():
        out_net, out_delta = blk(*(_nchw(a) for a in (net, inp, corr, flow)))
    np.testing.assert_allclose(_nhwc(out_net), np.asarray(ref_net), **NET_TOL)
    np.testing.assert_allclose(_nhwc(out_delta), np.asarray(ref_delta), **NET_TOL)
