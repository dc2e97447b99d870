"""The port's other models and upsampler heads against the JAX package, on
the CPU, with the JAX variables carried across.

- The test-mode forward of ``raft`` (full size, convex upsampling),
  small ``raft`` (bilinear ``upflow``) and small ``raft_nc_dbl`` (NCUP fed
  by the 96-channel GRU state) at 64x96, 3 iterations, f32. JAX runs
  ``corr_impl="pallas"`` (the Pallas lookup in interpret mode on the
  CPU) and the XLA NConv2d; the port runs
  ``corr_impl="pallas", nconv_impl="pallas"``, whose wrappers take their
  plain versions on CPU tensors. Every BatchNorm mean and variance is
  perturbed to seeded values first. Each also with ``flow_init``.
  Tolerances are the flagship's (``tests/test_torch_model.py``): flow_lr
  atol 2e-3, flow_up atol 5e-3, rtol 1e-3.
- The carried keys of each configuration against ``export_torch_state``.
- ``convex_upsample`` (with mask logits up to +-30), ``upflow`` (both
  ``align_corners``), ``bilinear_resize_align_corners`` and
  ``extract_3x3_patches`` at atol 1e-5.
- The small encoder, the small update block and the mask head alone, at
  atol 1e-4 / rtol 1e-4 (f32 convolutions summed in another order).
- Each new upsampler head (bilinear, the U-Net weights net at 2 and 3
  levels, binary weights, estimation at high resolution with the simple
  and the binary weights) with its BatchNorm frozen and training: the
  output and the running statistics after the call at atol 1e-5.
- The serve entry with ``--model raft --small --device cpu``.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_ncup_tpu.config import ModelConfig as JaxModelConfig
from raft_ncup_tpu.config import UpsamplerConfig as JaxUpsamplerConfig
from raft_ncup_tpu.models.raft import RAFT as JaxRAFT
from raft_ncup_tpu.nn.extractor import SmallEncoder as JaxSmallEncoder
from raft_ncup_tpu.nn.update import BasicUpdateBlock as JaxBasicUpdateBlock
from raft_ncup_tpu.nn.update import SmallUpdateBlock as JaxSmallUpdateBlock
from raft_ncup_tpu.nn.upsampler import build_upsampler as jax_build_upsampler
from raft_ncup_tpu.ops import geometry as jgeo
from raft_ncup_tpu.utils.torch_export import export_torch_state
from raft_ncup_tpu_torch import serve as serve_mod
from raft_ncup_tpu_torch.config import ModelConfig, UpsamplerConfig, small_model_config
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.nn.extractor import Encoder
from raft_ncup_tpu_torch.nn.update import BasicUpdateBlock, SmallUpdateBlock
from raft_ncup_tpu_torch.nn.upsampler import build_upsampler
from raft_ncup_tpu_torch.ops import geometry as pgeo
from raft_ncup_tpu_torch.utils.jax_weights import carry_state_dict, load_jax_variables
from test_torch_train import _perturb_batch_stats

H, W, ITERS = 64, 96, 3
FLOW_LR_TOL = dict(atol=2e-3, rtol=1e-3)
FLOW_UP_TOL = dict(atol=5e-3, rtol=1e-3)
GEO_TOL = dict(atol=1e-5, rtol=0)
NET_TOL = dict(atol=1e-4, rtol=1e-4)
HEAD_TOL = dict(atol=1e-5, rtol=1e-5)
VARIANTS = {
    "raft": dict(variant="raft"),
    "raft_small": dict(variant="raft", small=True),
    "raft_nc_dbl_small": dict(variant="raft_nc_dbl", small=True),
}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def jax_run(request):
    """For one variant: its name, the JAX variables (perturbed BatchNorm
    statistics) as numpy, the inputs and the JAX test-mode outputs, with
    and without ``flow_init``."""
    kw = VARIANTS[request.param]
    g = np.random.default_rng(0)
    model = JaxRAFT(JaxModelConfig(corr_impl="pallas", **kw))
    variables = jax.jit(model.init, static_argnums=1)(jax.random.key(0), (1, H, W, 3))
    variables = jax.tree_util.tree_map(np.array, variables)
    _perturb_batch_stats(variables.get("batch_stats", {}), g)
    img1 = g.uniform(0, 255, (1, H, W, 3)).astype(np.float32)
    img2 = np.roll(img1, (2, 3), axis=(1, 2)).copy()
    flow_init = g.normal(0, 2, (1, H // 8, W // 8, 2)).astype(np.float32)
    apply = jax.jit(functools.partial(model.apply, iters=ITERS, test_mode=True))
    out = dict(name=request.param, kw=kw, variables=variables, img1=img1, img2=img2,
               flow_init=flow_init)
    out["flow_lr"], out["flow_up"] = map(
        np.asarray, apply(variables, jnp.asarray(img1), jnp.asarray(img2)))
    out["warm_lr"], out["warm_up"] = map(np.asarray, apply(
        variables, jnp.asarray(img1), jnp.asarray(img2), flow_init=jnp.asarray(flow_init)))
    return out


def _port_model(run):
    model = RAFT(ModelConfig(corr_impl="pallas", nconv_impl="pallas", **run["kw"]),
                 device="cpu")
    return load_jax_variables(model, run["variables"])


def test_variant_carried_state_matches_export_torch_state(jax_run):
    variables = jax_run["variables"]
    carried = carry_state_dict(variables)
    exported = export_torch_state(variables)
    held = RAFT(ModelConfig(**jax_run["kw"]), device="cpu").state_dict()
    assert set(carried) == set(held)
    assert set(held) <= set(exported)
    # The export adds only the reference's duplicate aliases.
    extra = set(exported) - set(held)
    assert all(".norm3." in k or ".encoder." in k for k in extra), sorted(extra)
    for k, v in carried.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(exported[k]), err_msg=k)
    if jax_run["name"] == "raft":
        assert {"update_block.mask.0.weight", "update_block.mask.2.bias"} <= set(held)
    else:
        assert not any(k.startswith("update_block.mask.") for k in held)


def test_variant_forward_matches_jax(jax_run):
    model = _port_model(jax_run)
    flow_lr, flow_up = model(torch.from_numpy(jax_run["img1"]),
                             torch.from_numpy(jax_run["img2"]), iters=ITERS)
    flow_lr, flow_up = flow_lr.numpy(), flow_up.numpy()
    assert flow_lr.shape == jax_run["flow_lr"].shape == (1, H // 8, W // 8, 2)
    assert flow_up.shape == jax_run["flow_up"].shape == (1, H, W, 2)
    print(f"{jax_run['name']} {H}x{W} {ITERS} iters: max|flow_lr diff| "
          f"{np.abs(flow_lr - jax_run['flow_lr']).max():.3e}, max|flow_up diff| "
          f"{np.abs(flow_up - jax_run['flow_up']).max():.3e}, "
          f"max|flow_up| {np.abs(jax_run['flow_up']).max():.3f}")
    np.testing.assert_allclose(flow_lr, jax_run["flow_lr"], **FLOW_LR_TOL)
    np.testing.assert_allclose(flow_up, jax_run["flow_up"], **FLOW_UP_TOL)
    assert np.abs(jax_run["flow_up"]).max() > 0.1


def test_variant_flow_init_matches_jax(jax_run):
    model = _port_model(jax_run)
    flow_lr, flow_up = model(torch.from_numpy(jax_run["img1"]),
                             torch.from_numpy(jax_run["img2"]), iters=ITERS,
                             flow_init=torch.from_numpy(jax_run["flow_init"]))
    np.testing.assert_allclose(flow_lr.numpy(), jax_run["warm_lr"], **FLOW_LR_TOL)
    np.testing.assert_allclose(flow_up.numpy(), jax_run["warm_up"], **FLOW_UP_TOL)
    assert np.abs(jax_run["warm_lr"] - jax_run["flow_lr"]).max() > 0.1


# --------------------------------------------------------------- geometry

def test_convex_upsample_matches_jax():
    """Random logits with large ones (up to +-30), so a softmax over the
    wrong axis or a mask channel out of place shows."""
    g = np.random.default_rng(1)
    flow = g.normal(0, 3, (2, 5, 7, 2)).astype(np.float32)
    mask = g.normal(0, 3, (2, 5, 7, 576)).astype(np.float32)
    mask[g.random(mask.shape) < 0.05] *= 10.0
    assert np.abs(mask).max() > 20
    ours = pgeo.convex_upsample(torch.from_numpy(flow), torch.from_numpy(mask), 8)
    ref = np.asarray(jgeo.convex_upsample(jnp.asarray(flow), jnp.asarray(mask), 8))
    assert ours.shape == ref.shape == (2, 40, 56, 2)
    np.testing.assert_allclose(ours.numpy(), ref, **GEO_TOL)


@pytest.mark.parametrize("align_corners", [True, False])
def test_upflow_matches_jax(align_corners):
    g = np.random.default_rng(2)
    flow = g.normal(0, 3, (2, 5, 7, 2)).astype(np.float32)
    ours = pgeo.upflow(torch.from_numpy(flow), 8, align_corners)
    ref = np.asarray(jgeo.upflow(jnp.asarray(flow), 8, align_corners))
    assert ours.shape == ref.shape == (2, 40, 56, 2)
    np.testing.assert_allclose(ours.numpy(), ref, **GEO_TOL)


def test_patches_and_align_corners_resize_match_jax():
    g = np.random.default_rng(3)
    x = g.normal(size=(2, 6, 9, 5)).astype(np.float32)
    np.testing.assert_allclose(
        pgeo.extract_3x3_patches(torch.from_numpy(x)).numpy(),
        np.asarray(jgeo.extract_3x3_patches(jnp.asarray(x))), **GEO_TOL)
    for hw in ((24, 36), (11, 7), (1, 1), (6, 9)):
        np.testing.assert_allclose(
            pgeo.bilinear_resize_align_corners(torch.from_numpy(x), hw).numpy(),
            np.asarray(jgeo.bilinear_resize_align_corners(jnp.asarray(x), hw)),
            **GEO_TOL)


# ----------------------------------------------------------- small modules

@pytest.mark.parametrize("norm_fn", ["instance", "none"])
def test_small_encoder_matches_jax(norm_fn):
    g = np.random.default_rng(4)
    x = g.uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32)
    jenc = JaxSmallEncoder(160, norm_fn)
    variables = jax.tree_util.tree_map(
        np.array, jax.jit(jenc.init)(jax.random.key(0), jnp.asarray(x)))
    ref = np.asarray(jax.jit(jenc.apply)(variables, jnp.asarray(x)))
    enc = load_jax_variables(Encoder(160, norm_fn, small=True), variables).eval()
    with torch.no_grad():
        out = _nhwc(enc(_nchw(x)))
    assert out.shape == ref.shape == (2, 4, 6, 160)
    np.testing.assert_allclose(out, ref, **NET_TOL)


def _update_inputs(seed, hdim, cdim, planes):
    g = np.random.default_rng(seed)
    b, h, w = 2, 4, 6
    return [
        np.tanh(g.normal(size=(b, h, w, hdim))).astype(np.float32),
        np.maximum(g.normal(size=(b, h, w, cdim)), 0).astype(np.float32),
        g.normal(size=(b, h, w, planes)).astype(np.float32),
        g.normal(0, 2, (b, h, w, 2)).astype(np.float32),
    ]


def test_small_update_block_matches_jax():
    planes = 4 * 49
    args = _update_inputs(5, 96, 64, planes)
    jblk = JaxSmallUpdateBlock(planes, 96)
    jargs = [jnp.asarray(a) for a in args]
    variables = jax.tree_util.tree_map(
        np.array, jax.jit(jblk.init)(jax.random.key(1), *jargs))
    ref_net, ref_mask, ref_delta = jax.jit(jblk.apply)(variables, *jargs)
    assert ref_mask is None
    blk = load_jax_variables(SmallUpdateBlock(planes, 96, 64), variables)
    with torch.no_grad():
        net, delta = blk(*(_nchw(a) for a in args))
    np.testing.assert_allclose(_nhwc(net), np.asarray(ref_net), **NET_TOL)
    np.testing.assert_allclose(_nhwc(delta), np.asarray(ref_delta), **NET_TOL)


def test_mask_head_matches_jax():
    planes = 4 * 81
    args = _update_inputs(6, 128, 128, planes)
    jblk = JaxBasicUpdateBlock(planes, 128, use_mask_head=True)
    jargs = [jnp.asarray(a) for a in args]
    variables = jax.tree_util.tree_map(
        np.array, jax.jit(jblk.init)(jax.random.key(2), *jargs))
    ref_net, ref_mask, ref_delta = jax.jit(jblk.apply)(variables, *jargs)
    blk = load_jax_variables(BasicUpdateBlock(planes, 128, 128, use_mask_head=True),
                             variables)
    with torch.no_grad():
        net, delta = blk(*(_nchw(a) for a in args))
        mask = blk.mask_logits(net)
    assert mask.shape == (2, 576, 4, 6)
    np.testing.assert_allclose(_nhwc(net), np.asarray(ref_net), **NET_TOL)
    np.testing.assert_allclose(_nhwc(delta), np.asarray(ref_delta), **NET_TOL)
    np.testing.assert_allclose(_nhwc(mask), np.asarray(ref_mask), **NET_TOL)


# -------------------------------------------------------- upsampler heads

HEADS = {
    "bilinear": dict(kind="bilinear"),
    "unet": dict(weights_est_net="unet"),
    "unet_3_levels": dict(weights_est_net="unet", weights_est_num_ch=(8, 16, 32)),
    "binary": dict(weights_est_net="binary"),
    "est_on_high_res": dict(est_on_high_res=True),
    "est_on_high_res_binary": dict(est_on_high_res=True, weights_est_net="binary"),
}


@pytest.mark.parametrize("bn_trains", [False, True], ids=["bn_frozen", "bn_trains"])
@pytest.mark.parametrize("head", sorted(HEADS))
def test_upsampler_head_matches_jax(head, bn_trains):
    """One head on a (1, 14, 18, 2) flow with 24-channel guidance at half
    its resolution (a 3-level U-Net pads its up path to the skip's 7x9),
    from the same perturbed variables: the output and, when BatchNorm
    trains, the running statistics after the call."""
    g = np.random.default_rng(7)
    x = g.normal(0, 2, (1, 14, 18, 2)).astype(np.float32)
    guid = g.normal(size=(1, 7, 9, 24)).astype(np.float32)
    kw = HEADS[head]
    jup = jax_build_upsampler(JaxUpsamplerConfig(**kw), "sintel")
    variables = jax.tree_util.tree_map(
        np.array, jax.jit(jup.init)(jax.random.key(3), jnp.asarray(x), jnp.asarray(guid)))
    _perturb_batch_stats(variables.get("batch_stats", {}), g)
    if bn_trains:
        ref, mut = jax.jit(functools.partial(jup.apply, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(x), jnp.asarray(guid))
        new_stats = carry_state_dict({"batch_stats": mut.get("batch_stats", {})})
    else:
        ref = jax.jit(jup.apply)(variables, jnp.asarray(x), jnp.asarray(guid))
        new_stats = {}
    up = build_upsampler(UpsamplerConfig(**kw), "sintel", "pallas", guidance_ch=24)
    load_jax_variables(up, variables)
    up.train(bn_trains)
    with torch.no_grad():
        out = _nhwc(up(_nchw(x), _nchw(guid)))
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (1, 56, 72, 2)
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(out, ref, **HEAD_TOL)
    buffers = dict(up.named_buffers())
    for name, r in new_stats.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(buffers[name].numpy(), r.numpy(), **HEAD_TOL)
    has_bn = head.startswith("unet") or head == "est_on_high_res"
    assert bool(new_stats) == (bn_trains and has_bn)


# ------------------------------------------------------------------ entry

def test_serve_entry_serves_the_small_raft_model(capsys):
    rc = serve_mod.main([
        "--device", "cpu", "--model", "raft", "--small", "--size", "40", "48",
        "--num_requests", "2", "--iter_levels", "2", "--serve_batch_sizes", "1,2",
    ])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(lines) == 1
    report = json.loads(lines[0])
    assert report["serve_ok"] == 2 and report["errors"] == 0
    assert report["variant"] == "raft" and report["small"] is True
    assert report["corr_kernel_launches"] == 0  # CPU: plain versions


def test_small_model_config_is_the_jax_preset():
    cfg = small_model_config()
    assert (cfg.variant, cfg.small, cfg.align_corners) == ("raft", True, True)
    assert (cfg.hidden_dim, cfg.context_dim, cfg.fnet_dim) == (96, 64, 128)
    assert (cfg.resolved_corr_radius, cfg.corr_planes) == (3, 196)
    assert small_model_config("raft_nc_dbl").variant == "raft_nc_dbl"
