"""The backward of both kernels' functions: the port's plain backward
versions against ``jax.vjp`` of the JAX ops, on the CPU.

On CPU tensors the port's wrappers run their plain versions inside the
``autograd.Function`` whose backward, on the card, is a hand-written
kernel (kernel A', ``csrc/corr_lookup_bwd.cu``; kernel B',
``csrc/nconv_bwd.cu``). Here the backward is its plain version:

- the lookup's, the autograd of the plain lookup (``corr_cuda.
  lookup_pyramid_backward``), against ``jax.vjp`` of ``corr_lookup_pallas``
  in interpret mode, as ``tests/test_corr_pallas.py`` runs it, whose
  ``custom_vjp`` differentiates the XLA on-the-fly lookup;
- the NConv2d's, the explicit formulas (``nconv_cuda.
  nconv2d_backward_plain``), against ``jax.vjp`` of ``nconv2d_fused`` in
  interpret mode, as ``tests/test_nconv.py`` runs it, whose
  ``custom_vjp`` differentiates the two-convolution composition.

Tolerance: each gradient within 1e-5 of its own largest magnitude. Both
sides sum the same f32 terms in another order (the window sums, the
convolutions' reductions); the differences measured here stay below
1e-6 of that magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_ncup_tpu.ops.corr_pallas import corr_lookup_pallas
from raft_ncup_tpu.ops.nconv_pallas import nconv2d_fused as jax_nconv2d_fused
from raft_ncup_tpu_torch.ops import corr_cuda, nconv_cuda
from raft_ncup_tpu_torch.ops.nconv import nconv2d

GRAD_TOL = 1e-5


def assert_grad_close(port, ref, what):
    """|port - ref| <= GRAD_TOL * max|ref| over the finite values, and NaN
    and infinities at the same places with the same values."""
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, what
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(port), fin, err_msg=what)
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref), err_msg=what)
    np.testing.assert_array_equal(port[np.isinf(ref)], ref[np.isinf(ref)], err_msg=what)
    if fin.any():
        scale = np.abs(ref[fin]).max()
        err = np.abs(port[fin] - ref[fin]).max()
        assert err <= GRAD_TOL * max(scale, 1e-30), f"{what}: {err} vs scale {scale}"


# ------------------------------------------------------------ lookup (A')

def _lookup_inputs(seed, b, h, w, c, spread, far):
    """fmap1, fmap2 and coords = grid + offsets up to ``spread`` px with
    fractional parts, a share ``far`` of the windows thrown 1.5 sizes
    away (partly or wholly outside the levels)."""
    g = np.random.default_rng(seed)
    f1 = g.normal(size=(b, h, w, c)).astype(np.float32)
    f2 = g.normal(size=(b, h, w, c)).astype(np.float32)
    y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = np.stack([x, y], -1)[None].astype(np.float32)
    coords = grid + g.uniform(-spread, spread, (b, h, w, 2))
    away = g.uniform(-1.5, 1.5, (b, h, w, 2)) * max(h, w)
    coords = coords + away * (g.random((b, h, w, 1)) < far)
    return f1, f2, coords.astype(np.float32)


@pytest.mark.parametrize(
    "b,h,w,c,radius,levels,spread,far",
    [(2, 8, 12, 16, 3, 3, 0.99, 0.3), (1, 9, 11, 8, 4, 4, 6.0, 0.2)],
    ids=["fractional_and_far", "odd_levels_to_1x1"],
)
def test_lookup_backward_matches_jax_vjp(b, h, w, c, radius, levels, spread, far):
    f1, f2, coords = _lookup_inputs(b + h, b, h, w, c, spread, far)
    k = 2 * radius + 1
    g = np.random.default_rng(7).normal(size=(b, h, w, levels * k * k)).astype(np.float32)

    @jax.jit  # one compile instead of one interpret-mode trace per primitive
    def jax_vjp(a, b_, c_, g_):
        out, vjp = jax.vjp(
            lambda a, b_, c_: corr_lookup_pallas(a, b_, c_, radius, levels, True),
            a, b_, c_)
        return out, vjp(g_)

    out_j, refs = jax_vjp(*(jnp.asarray(x) for x in (f1, f2, coords, g)))

    ins = [torch.from_numpy(x).requires_grad_() for x in (f1, f2, coords)]
    out = corr_cuda.corr_lookup_fused(ins[0], ins[1], ins[2], radius, levels)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-5, rtol=0)
    for name, t, ref in zip(("d fmap1", "d fmap2", "d coords"), ins, refs):
        assert_grad_close(t.grad.numpy(), np.asarray(ref), name)
    assert np.abs(ins[2].grad.numpy()).max() > 0  # coords do get a gradient


def test_lookup_backward_computes_only_what_is_needed():
    """``needs`` drops the gradients nobody asked for; the others are
    those of the full call."""
    f1, f2, coords = _lookup_inputs(3, 1, 8, 8, 8, 2.0, 0.2)
    f1s, lv = corr_cuda.prepare_levels(torch.from_numpy(f1), torch.from_numpy(f2), 3)
    co = torch.from_numpy(coords)
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 8, 8, 3 * 25)).astype(np.float32))
    full = corr_cuda.lookup_levels_backward(f1s, lv, co, 2, g)
    only = corr_cuda.lookup_levels_backward(f1s, lv, co, 2, g, (False, False, True))
    assert only[0] is None and only[1] is None
    torch.testing.assert_close(only[2], full[2], rtol=0, atol=0)
    model_path = corr_cuda.lookup_levels_backward(f1s, lv, co, 2, g, (True, True, False))
    assert model_path[2] is None
    torch.testing.assert_close(model_path[0], full[0], rtol=0, atol=0)
    for a, b in zip(model_path[1], full[1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_lookup_backward_at_a_query_a_float32_step_below_an_integer():
    """A query at x = 59.999996 (ROADMAP queue 3, entry 3), radius 3, two
    levels: at level 1 the tap x/2 + 3 = 32.999998 rounds to 33 in float32,
    so a float32 computation that places each tap on its own puts taps on
    both sides of an integer, where the bilinear weights' derivative jumps.
    JAX's float32 VJP of ``corr_lookup_onthefly`` jumps exactly as the
    port's float32 plain backward does: both miss the float64 d coords by
    about 2% of the largest value there (and agree with each other within
    ``GRAD_TOL``), while every other query stays within ``GRAD_TOL``. Kernel
    A' takes one fraction per query and level and agreed with float64
    within 2.1e-6 on the card, so it is the more exact side."""
    from raft_ncup_tpu.ops.corr import corr_lookup_onthefly

    g = np.random.default_rng(0)
    b, h, w, c, radius, levels = 1, 8, 80, 8, 3, 2
    f1 = g.normal(size=(b, h, w, c)).astype(np.float32)
    f2 = g.normal(size=(b, h, w, c)).astype(np.float32)
    y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    coords = (np.stack([x, y], -1)[None]
              + g.uniform(-0.4, 0.4, (b, h, w, 2))).astype(np.float32)
    coords[0, 3, 7] = (np.float32(59.999996), np.float32(3.25))
    k = 2 * radius + 1
    up = g.normal(size=(b, h, w, levels * k * k)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b_, c_: corr_lookup_onthefly(a, b_, c_, radius, levels),
                     *(jnp.asarray(t) for t in (f1, f2, coords)))
    jax32 = np.asarray(vjp(jnp.asarray(up))[2], np.float64)

    def port(dt):
        t = [torch.from_numpy(a).to(dt) for a in (f1, f2, coords, up)]
        f1s, lv = corr_cuda.prepare_levels(t[0], t[1], levels, dt)
        return corr_cuda.lookup_pyramid_backward(f1s, lv, t[2], radius, t[3],
                                                 (False, False, True))[2].numpy()

    port32, port64 = port(torch.float32).astype(np.float64), port(torch.float64)
    scale = np.abs(port64).max()
    at = np.zeros((b, h, w), bool)
    at[0, 3, 7] = True
    for got in (port32, jax32):
        err = np.abs(got - port64) / scale
        assert err[at][0, 0] > 1e-2  # the jump, in x
        assert err[~at].max() <= GRAD_TOL and err[at][0, 1] <= GRAD_TOL
    assert np.abs(port32 - jax32).max() <= GRAD_TOL * scale


# ------------------------------------------------------------ NConv2d (B')

def _nconv_inputs(seed, b, h, w, k, cin, cout, zero_region):
    g = np.random.default_rng(seed)
    data = g.normal(size=(b, h, w, cin)).astype(np.float32) * 3
    conf = g.uniform(0.05, 1.0, (b, h, w, cin)).astype(np.float32)
    if zero_region:
        # A zero-stuffed grid with a corner of no confidence at all: there
        # the window sums D are exactly 0, so JAX's division VJP gives NaN.
        stuffed = np.zeros_like(conf)
        stuffed[:, 2::4, 2::4] = conf[:, 2::4, 2::4]
        stuffed[:, : h // 2, : w // 2] = 0
        conf = stuffed
    raw = g.normal(2.0, 0.5, (k, k, cin, cout)).astype(np.float32)
    weight = (np.log1p(np.exp(10 * raw)) / 10).astype(np.float32)
    bias = g.normal(size=(cout,)).astype(np.float32)
    return data, conf, weight, bias


@pytest.mark.parametrize(
    "k,cin,cout,with_bias,zero_region",
    [(5, 1, 2, False, True), (3, 4, 2, True, False), (1, 2, 1, False, False),
     (7, 1, 1, True, False)],
    ids=["nconv_in_zero_region", "decoder_bias", "nconv_out", "k7_bias"],
)
def test_nconv_backward_matches_jax_vjp(k, cin, cout, with_bias, zero_region):
    b, h, w = 2, 16, 20
    data, conf, weight, bias = _nconv_inputs(k * 10 + cin, b, h, w, k, cin, cout, zero_region)
    bias = bias if with_bias else None
    g = np.random.default_rng(11)
    go = g.normal(size=(b, h, w, cout)).astype(np.float32)
    gc = g.normal(size=(b, h, w, cout)).astype(np.float32)

    @jax.jit
    def jax_vjp(d, c, w_, b_, go_, gc_):
        outs, vjp = jax.vjp(
            lambda d, c, w_, b_: jax_nconv2d_fused(d, c, w_, b_, 1e-20, True), d, c, w_, b_)
        return outs, vjp((go_, gc_))

    (out_j, conf_j), refs = jax_vjp(
        *(None if x is None else jnp.asarray(x) for x in (data, conf, weight, bias, go, gc)))

    ins = [torch.from_numpy(x).requires_grad_() for x in (data, conf, weight)]
    if bias is not None:
        ins.append(torch.from_numpy(bias).requires_grad_())
    out, conf_out = nconv2d(*ins[:3], ins[3] if bias is not None else None, impl="pallas")
    torch.autograd.backward((out, conf_out), (torch.from_numpy(go), torch.from_numpy(gc)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(conf_out.detach().numpy(), np.asarray(conf_j), atol=1e-5, rtol=1e-4)
    for name, t, ref in zip(("d data", "d conf", "d weight", "d bias"), ins, refs):
        assert_grad_close(t.grad.numpy(), np.asarray(ref), name)
    if zero_region:  # both sides give the NaN of an empty window, at the same places
        assert np.isnan(ins[1].grad.numpy()).any()


def test_nconv_backward_without_a_conf_gradient():
    """The model never reads the last layer's conf_out: the backward then
    gets no gradient for it, and equals JAX's with a zero one."""
    data, conf, weight, _ = _nconv_inputs(5, 2, 12, 16, 1, 2, 1, False)
    go = np.random.default_rng(3).normal(size=(2, 12, 16, 1)).astype(np.float32)
    @jax.jit
    def jax_vjp(d, c, w_, go_):
        (_, conf_j), vjp = jax.vjp(
            lambda d, c, w_: jax_nconv2d_fused(d, c, w_, None, 1e-20, True), d, c, w_)
        return vjp((go_, jnp.zeros_like(conf_j)))

    refs = jax_vjp(*(jnp.asarray(x) for x in (data, conf, weight, go)))
    ins = [torch.from_numpy(x).requires_grad_() for x in (data, conf, weight)]
    out, _ = nconv2d(*ins, impl="pallas")
    out.backward(torch.from_numpy(go))
    for name, t, ref in zip(("d data", "d conf", "d weight"), ins, refs):
        assert_grad_close(t.grad.numpy(), np.asarray(ref), name)


def test_nconv_function_matches_autograd_of_the_plain_version():
    """Away from empty windows the explicit formulas are the autograd of
    the two-convolution plain version."""
    data, conf, weight, bias = _nconv_inputs(9, 2, 12, 16, 3, 2, 2, False)
    grads = []
    for fused in (True, False):
        ins = [torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
               for x in (data, conf)]
        ins += [torch.from_numpy(weight.transpose(3, 2, 0, 1).copy()).requires_grad_(),
                torch.from_numpy(bias).requires_grad_()]
        fn = nconv_cuda.nconv2d_fused if fused else nconv_cuda.nconv2d_plain
        out, conf_out = fn(*ins)
        (out.square().sum() + conf_out.square().sum()).backward()
        grads.append([t.grad for t in ins])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))
