"""Parity of the port's normalized convolution (kernel B's function) and
of the NCUP modules that hold it with the JAX package, on the CPU.

On a CPU tensor the port's fused-NConv2d wrapper runs its plain version
(two convolutions, a divide and a scale), so these tests hold it against
JAX ``nconv2d_fused`` in interpret mode and JAX ``nconv2d(impl="xla")``.
Tolerance atol 1e-5, rtol 1e-4: the same sums in another order in f32.
The modules (``NConvUNet``, ``NConvUpsampler``) run with weights carried
from the JAX variables by ``utils.jax_weights``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_ncup_tpu.config import UpsamplerConfig as JaxUpsamplerConfig
from raft_ncup_tpu.nn.nconv_unet import NConvUNet as JaxNConvUNet
from raft_ncup_tpu.nn.upsampler import NConvUpsampler as JaxNConvUpsampler
from raft_ncup_tpu.ops import nconv as jnconv
from raft_ncup_tpu.ops.nconv_pallas import nconv2d_fused as jax_nconv2d_fused
from raft_ncup_tpu_torch.config import UpsamplerConfig
from raft_ncup_tpu_torch.nn.nconv_unet import NConvUNet
from raft_ncup_tpu_torch.nn.upsampler import NConvUpsampler
from raft_ncup_tpu_torch.ops import nconv as pnconv
from raft_ncup_tpu_torch.ops import nconv_cuda
from raft_ncup_tpu_torch.utils.jax_weights import load_jax_variables

TOL = dict(atol=1e-5, rtol=1e-4)
# (k, Cin, Cout) of the four NCUP layers: nconv_in, nconv_x2_0,
# decoder_0, nconv_out.
NCUP_LAYERS = [(5, 1, 2), (5, 2, 2), (3, 4, 2), (1, 2, 1)]


def _stuffed(g, b, h, w, c, scale=4):
    """A (b, h, w, c) map that is zero except at the stride-``scale``
    centres, as NCUP's zero-stuffing leaves data and confidence."""
    low = g.uniform(0.05, 1.0, (b, h // scale, w // scale, c)).astype(np.float32)
    out = np.zeros((b, h, w, c), np.float32)
    out[:, scale // 2:: scale, scale // 2:: scale, :] = low
    return out


def _to_np(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("k,cin,cout", NCUP_LAYERS)
def test_nconv2d_matches_jax(k, cin, cout, bias):
    """Batch element 0 has a dense confidence; elements 1-2 a confidence
    zero-stuffed at stride 4 (exactly zero at 15 of 16 pixels)."""
    g = np.random.default_rng(100 + 10 * k + cin + cout)
    b, h, w = 3, 16, 20
    data = g.normal(size=(b, h, w, cin)).astype(np.float32)
    conf = np.concatenate([
        g.uniform(0.0, 1.0, (1, h, w, cin)).astype(np.float32),
        _stuffed(g, b - 1, h, w, cin),
    ])
    raw = g.normal(size=(k, k, cin, cout)).astype(np.float32)
    weight = np.array(jnconv.positivity(jnp.asarray(raw)))
    bvec = g.normal(size=(cout,)).astype(np.float32) if bias else None

    jargs = [jnp.asarray(x) for x in (data, conf, weight)]
    jb = None if bvec is None else jnp.asarray(bvec)
    ref_fused = jax_nconv2d_fused(*jargs, jb, 1e-20, True)
    ref_xla = jnconv.nconv2d(*jargs, jb, impl="xla")
    t = torch.from_numpy
    out, conf_out = pnconv.nconv2d(
        t(data), t(conf), t(weight), None if bvec is None else t(bvec),
        impl="pallas",
    )
    for ref in (ref_fused, ref_xla):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref[0]), **TOL)
        np.testing.assert_allclose(conf_out.numpy(), np.asarray(ref[1]), **TOL)
    print(f"k={k} cin={cin} cout={cout} bias={bias}: "
          f"max|out-fused| {np.abs(out.numpy() - np.asarray(ref_fused[0])).max():.3e}")


def test_positivity_and_downsample_and_zero_stuff_match_jax():
    g = np.random.default_rng(7)
    raw = g.normal(size=(3, 3, 2, 2)).astype(np.float32)
    for fn in ("softplus", "exp", "sigmoid", "softmax"):
        np.testing.assert_allclose(
            pnconv.positivity(torch.from_numpy(raw), fn).numpy(),
            np.asarray(jnconv.positivity(jnp.asarray(raw), fn)),
            atol=1e-6, rtol=1e-6,
        )
    data = g.normal(size=(2, 8, 6, 3)).astype(np.float32)
    conf = g.uniform(0, 1, (2, 8, 6, 3)).astype(np.float32)
    for pooling in ("conf_based", "max_pooling"):
        pd, pc = pnconv.downsample_data_conf(
            torch.from_numpy(data), torch.from_numpy(conf), pooling
        )
        jd, jc = jnconv.downsample_data_conf(
            jnp.asarray(data), jnp.asarray(conf), pooling
        )
        np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(
        pnconv.zero_stuff_upsample(torch.from_numpy(data), 4, 2).numpy(),
        np.asarray(jnconv.zero_stuff_upsample(jnp.asarray(data), 4, 2)),
    )


def test_cpu_wrapper_runs_plain_version_and_counts_nothing():
    g = np.random.default_rng(8)
    data = torch.from_numpy(g.normal(size=(2, 2, 8, 8)).astype(np.float32))
    conf = torch.from_numpy(g.uniform(0, 1, (2, 2, 8, 8)).astype(np.float32))
    w = torch.from_numpy(g.uniform(0.1, 1, (2, 2, 3, 3)).astype(np.float32))
    before = nconv_cuda.nconv2d_fused.launches
    out = nconv_cuda.nconv2d_fused(data, conf, w)
    ref = nconv_cuda.nconv2d_plain(data, conf, w)
    assert nconv_cuda.nconv2d_fused.launches == before
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_nconv_unet_matches_jax_with_carried_weights():
    g = np.random.default_rng(9)
    b, h, w = 4, 32, 48  # the channels-to-batch fold gives B = 2 * batch
    data = _stuffed(g, b, h, w, 1) * 8.0
    conf = _stuffed(g, b, h, w, 1)
    jnet = JaxNConvUNet()
    variables = jax.jit(jnet.init)(jax.random.key(1), jnp.asarray(data), jnp.asarray(conf))
    ref_out, ref_conf = jax.jit(jnet.apply)(variables, jnp.asarray(data), jnp.asarray(conf))
    net = load_jax_variables(NConvUNet(impl="pallas"), _to_np(variables))
    out, conf_out = net(
        torch.from_numpy(data).permute(0, 3, 1, 2),
        torch.from_numpy(conf).permute(0, 3, 1, 2),
    )
    np.testing.assert_allclose(
        out.permute(0, 2, 3, 1).detach().numpy(), np.asarray(ref_out), **TOL
    )
    np.testing.assert_allclose(
        conf_out.permute(0, 2, 3, 1).detach().numpy(), np.asarray(ref_conf), **TOL
    )


def test_nconv_upsampler_matches_jax_with_carried_weights():
    """The NCUP upsampler of the sintel flagship (BN in the weights net,
    with perturbed running statistics so a swapped BN mapping fails),
    including the channels-to-batch fold."""
    g = np.random.default_rng(10)
    b, h8, w8 = 2, 6, 8
    flow2 = g.normal(0, 3, (b, 2 * h8, 2 * w8, 2)).astype(np.float32)
    guidance = np.tanh(g.normal(size=(b, h8, w8, 128))).astype(np.float32)
    jup = JaxNConvUpsampler(JaxUpsamplerConfig(), use_bn=True)
    variables = _to_np(
        jax.jit(jup.init)(jax.random.key(2), jnp.asarray(flow2), jnp.asarray(guidance))
    )
    stats = variables["batch_stats"]["weights_est_net"]
    for name in sorted(stats):
        bn = stats[name]["BatchNorm_0"]
        n = bn["mean"].shape[0]
        bn["mean"] = g.normal(0, 0.2, n).astype(np.float32)
        bn["var"] = g.uniform(0.5, 1.5, n).astype(np.float32)
    ref = np.asarray(
        jax.jit(jup.apply)(variables, jnp.asarray(flow2), jnp.asarray(guidance))
    )
    up = NConvUpsampler(UpsamplerConfig(), use_bn=True, nconv_impl="pallas")
    load_jax_variables(up, variables)
    up.eval()
    with torch.no_grad():
        out = up(
            torch.from_numpy(flow2).permute(0, 3, 1, 2),
            torch.from_numpy(guidance).permute(0, 3, 1, 2),
        ).permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape == (b, 8 * h8, 8 * w8, 2)
    print(f"upsampler: max|port-jax| {np.abs(out - ref).max():.3e}")
    np.testing.assert_allclose(out, ref, **TOL)
