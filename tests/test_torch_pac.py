"""The port's PAC and DJIF upsampler heads (``ops/pac.py``, ``nn/pac.py``)
against the JAX package's, on the CPU.

- Every PAC primitive at the cases of ``tests/test_pac.py`` and
  ``tests/test_pac_full.py`` (the adapting kernel: Gaussian with 'same'
  padding and strided, 'inv' and 'inv' asymmetric, smoothed centres,
  channel-wise, normalised, masked; the PAC convolution strided and with
  shared filters; pooling shared and channel-wise; the transposed
  convolution; the half-pixel resize up and down), on seeded numpy
  inputs: the forward within 1e-5, and every input's gradient against
  ``jax.vjp`` under a seeded cotangent within 1e-4 of its largest value.
- The modules (``PacConv2d`` with a Gaussian and a learnable 'inv' kernel,
  ``PacPool2d`` channel-wise, ``PacConvTranspose2d``'s linear filler and
  its normalised form, ``PacJointUpsample``, ``DJIF``, ``JointBilateral``)
  with JAX's initialised variables carried across by
  ``utils.jax_weights.carry_state_dict``.
- Small ``raft_nc_dbl`` with each head: the carried keys equal
  ``export_torch_state``'s; the forward at 64x64 with carried weights
  against JAX's at the flagship tolerances (flow_lr atol 2e-3, flow_up atol
  5e-3, rtol 1e-3); one train step (batch 2, 64x64, 2 iterations) against
  JAX ``make_train_step`` at ``tests/test_torch_train.py``'s tolerances
  (the loss within 1e-5 relative, every gradient within 1e-3 of its own
  largest value, the encoders' through a float64 replay of the port's own
  encoders, the biases ahead of instance norm as rounding noise; behind the
  DJIF head's flipped ReLU, ``FLIPPED_HEADS``, test_torch_train's
  ``FLIP_TOL``). Gradients that are zero by structure are held as rounding
  noise (below 1e-6 of the largest) on both sides.
- The CLI's ``--final_upsampling`` mapping, as JAX's.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_ncup_tpu import cli as jax_cli
from raft_ncup_tpu.config import ModelConfig as JaxModelConfig
from raft_ncup_tpu.config import TrainConfig as JaxTrainConfig
from raft_ncup_tpu.config import UpsamplerConfig as JaxUpsamplerConfig
from raft_ncup_tpu.models.raft import RAFT as JaxRAFT
from raft_ncup_tpu.nn import pac as jax_pac_nn
from raft_ncup_tpu.ops import pac as jax_pac
from raft_ncup_tpu.parallel.step import make_train_step as jax_make_train_step
from raft_ncup_tpu.resilience.anomaly import init_sentinel as jax_init_sentinel
from raft_ncup_tpu.training.state import TrainState as JaxTrainState
from raft_ncup_tpu.utils.torch_export import export_torch_state
from raft_ncup_tpu.utils.torch_import import import_torch_state
from raft_ncup_tpu_torch import cli
from raft_ncup_tpu_torch.config import ModelConfig, TrainConfig, UpsamplerConfig
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.nn import pac as pac_nn
from raft_ncup_tpu_torch.nn.layers import init_weights
from raft_ncup_tpu_torch.nn.upsampler import build_upsampler
from raft_ncup_tpu_torch.ops import pac as pac_ops
from raft_ncup_tpu_torch.training.state import state_for
from raft_ncup_tpu_torch.training.step import make_train_step
from raft_ncup_tpu_torch.utils.jax_weights import carry_state_dict, load_jax_variables
from test_torch_train import ENCODERS, FLIP_TOL, _EncoderReplay, _grad_capture
from test_torch_variants_train import _zero_by_structure

B, C, H, W = 2, 3, 12, 14
K = 5
FWD_ATOL = 1e-5
GRAD_REL = 1e-4
LR_ATOL, UP_ATOL, RTOL = 2e-3, 5e-3, 1e-3
LOSS_RTOL, GRAD_TOL, NEGLIGIBLE = 1e-5, 1e-3, 1e-6
MODEL_HW = (64, 64)
TRAIN_BATCH, TRAIN_ITERS = 2, 2
HEADS = ("pac", "djif")
# A ReLU input of the DJIF head within float32 rounding of zero lands on
# opposite sides in the port's and JAX's float32 (measured at the model's
# shapes against float64: the port's head moved 2 of 4096 input-gradient
# elements by 1.2e-3 of the largest, JAX's none), and every gradient
# upstream of the head moves with it: 1.7e-3 of a tensor's largest value
# on this batch. The head's own gradients stay within GRAD_TOL.
FLIPPED_HEADS = ("djif",)


def rnp(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _check_fn(port_fn, jax_fn, args, fwd_atol=FWD_ATOL, seed=99):
    """The port's function against JAX's on ``args`` (numpy): the outputs,
    then every floating input's gradient under one seeded cotangent per
    output."""
    t_args = [torch.tensor(a, requires_grad=np.issubdtype(a.dtype, np.floating)) for a in args]
    outs = port_fn(*t_args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    j_outs, vjp = jax.vjp(jax.jit(jax_fn), *[jnp.asarray(a) for a in args])
    j_outs = j_outs if isinstance(j_outs, tuple) else (j_outs,)
    g = np.random.default_rng(seed)
    cts = [g.normal(size=np.shape(o)).astype(np.float32) for o in j_outs]
    for o, jo in zip(outs, j_outs):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), atol=fwd_atol, rtol=1e-4)
    j_grads = vjp(tuple(jnp.asarray(c) for c in cts) if len(cts) > 1 else jnp.asarray(cts[0]))
    live = [(t, jg) for t, jg in zip(t_args, j_grads) if t.requires_grad]
    # An output with no gradient (a mask from comparisons) adds nothing on
    # either side.
    differentiable = [(o, torch.from_numpy(c)) for o, c in zip(outs, cts) if o.requires_grad]
    grads = torch.autograd.grad([o for o, _ in differentiable], [t for t, _ in live],
                                [c for _, c in differentiable], allow_unused=True)
    gmax = max(float(np.abs(np.asarray(jg)).max()) for _, jg in live)
    for got, (_, jg) in zip(grads, live):
        jg = np.asarray(jg)
        got = np.zeros_like(jg) if got is None else got.numpy()
        scale = float(np.abs(jg).max())
        if scale < NEGLIGIBLE * gmax:
            # Zero by structure (a bias the kernel's differences cancel):
            # rounding noise on both sides.
            assert float(np.abs(got).max()) < NEGLIGIBLE * gmax
            continue
        assert float(np.abs(got - jg).max()) <= GRAD_REL * scale


# ---------------------------------------------------------------- primitives


def _kernel_case(name):
    """The keyword arguments of one adapting-kernel case of
    tests/test_pac_full.py (``alpha``/``lam``, ``smooth`` and ``mask``
    become differentiable inputs)."""
    sk = lambda kind: np.asarray(jax_pac.smooth_kernel_2d(kind))  # noqa: E731
    return {
        "gaussian_same_pad": dict(ksize=K, padding=2),
        "gaussian_stride2_pad1": dict(ksize=3, stride=2, padding=1),
        "inv": dict(ksize=K, padding=2, kernel_type="inv", alpha=0.5, lam=2.0),
        "inv_asym": dict(ksize=K, padding=2, kernel_type="inv", alpha=0.1, lam=1.0, asym=True),
        "smooth_gaussian": dict(ksize=K, padding=2, smooth=sk("gaussian")),
        "smooth_average_3": dict(ksize=K, padding=2, smooth=sk("average_3")),
        "channel_wise": dict(ksize=K, padding=2, channel_wise=True),
        "normalize_kernel": dict(ksize=K, padding=2, normalize_kernel=True),
        "masked": dict(ksize=K, padding=2, mask=True),
    }[name]


KERNEL_CASES = ("gaussian_same_pad", "gaussian_stride2_pad1", "inv", "inv_asym",
                "smooth_gaussian", "smooth_average_3", "channel_wise", "normalize_kernel",
                "masked")


@pytest.mark.parametrize("case", KERNEL_CASES)
def test_pac_kernel2d_matches_jax(case):
    kw = dict(_kernel_case(case))
    ksize = kw.pop("ksize")
    args = [rnp(0, B, H, W, C)]
    names = ["guide"]
    if "alpha" in kw:
        args += [np.float32(kw.pop("alpha")), np.float32(kw.pop("lam"))]
        names += ["inv_alpha", "inv_lambda"]
    if "smooth" in kw:
        args.append(kw.pop("smooth").astype(np.float32))
        names.append("smooth_kernel")
    if kw.pop("mask", False):
        args.append((rnp(9, B, H, W, 1) > 0).astype(np.float32))
        names.append("mask")

    def call(mod):
        def fn(guide, *rest):
            extra = dict(zip(names[1:], rest))
            kernel, mask_out = mod.pac_kernel2d(guide, ksize, **kw, **extra)
            return kernel if mask_out is None else (kernel, mask_out)
        return fn

    _check_fn(call(pac_ops), call(jax_pac), [np.asarray(a) for a in args])


@pytest.mark.parametrize("case", ["patches", "gaussian_kernel", "pacconv2d_strided",
                                  "pacconv2d_shared_filters", "pacpool2d", "pacpool2d_cw",
                                  "pacconv_transpose2d", "resize_down", "resize_up"])
def test_pac_ops_match_jax(case):
    x, g = rnp(1, B, H, W, C), rnp(2, B, H, W, C)
    if case == "patches":
        _check_fn(lambda a: pac_ops.extract_patches(a, K, 2),
                  lambda a: jax_pac.extract_patches(a, K, 2), [x])
    elif case == "gaussian_kernel":
        _check_fn(lambda a: pac_ops.pac_gaussian_kernel(a, K),
                  lambda a: jax_pac.pac_gaussian_kernel(a, K), [g])
    elif case in ("pacconv2d_strided", "pacconv2d_shared_filters"):
        shared = case.endswith("filters")
        w = rnp(6, K * K) if shared else rnp(3, K * K, C, 4)
        bias = None if shared else rnp(4, 4)

        def call(mod):
            def fn(x, g, w, *b):
                kernel, _ = mod.pac_kernel2d(g, K, stride=1 if shared else 2, padding=2)
                return mod.pacconv2d(x, kernel, w, b[0] if b else None, pad_lo=(2, 2),
                                     pad_hi=(2, 2), stride=1 if shared else 2,
                                     shared_filters=shared)
            return fn

        _check_fn(call(pac_ops), call(jax_pac), [x, g, w] + ([] if bias is None else [bias]))
    elif case.startswith("pacpool2d"):
        cw = case.endswith("cw")

        def call(mod):
            def fn(x, g):
                kernel, _ = mod.pac_kernel2d(g, 3, stride=2, padding=1, channel_wise=cw)
                return mod.pacpool2d(x, kernel, 3, stride=2, padding=1)
            return fn

        _check_fn(call(pac_ops), call(jax_pac), [x, g])
    elif case == "pacconv_transpose2d":
        xs, gh = rnp(5, B, 6, 7, C), rnp(6, B, 12, 14, 4)

        def call(mod):
            def fn(x, g, w, b):
                kernel, _ = mod.pac_kernel2d(g, K, pad_lo=(2, 2), pad_hi=(2, 2))
                return mod.pacconv_transpose2d(x, kernel, w, b, stride=2, padding=2,
                                               output_padding=1)
            return fn

        _check_fn(call(pac_ops), call(jax_pac), [xs, gh, rnp(7, K * K, C, 4), rnp(8, 4)])
    else:
        out = (5, 6) if case == "resize_down" else (27, 33)
        _check_fn(lambda a: pac_ops.resize_half_pixel(a, out),
                  lambda a: jax.image.resize(a, (B, *out, C), method="bilinear"), [x])


def test_zero_stuff_mask_and_smooth_kernels_match_jax():
    for shape, s in (((3, 4), 2), ((5, 2), 4)):
        np.testing.assert_array_equal(pac_ops.zero_stuff_mask(shape, s).numpy(),
                                      np.asarray(jax_pac.zero_stuff_mask(shape, s)))
    for kind in ("gaussian", "average_3", "average_5"):
        np.testing.assert_array_equal(pac_ops.smooth_kernel_2d(kind).numpy(),
                                      np.asarray(jax_pac.smooth_kernel_2d(kind)))
    with pytest.raises(ValueError, match="unknown fixed smooth kernel"):
        pac_ops.smooth_kernel_2d("box")


# ------------------------------------------------------------------ modules


def _module_case(name):
    """(JAX module, port module, inputs) of one module case."""
    x, g = rnp(10, B, H, W, C), rnp(11, B, H, W, C)
    if name == "pacconv2d":
        return (jax_pac_nn.PacConv2d(features=4, kernel_size=K, padding=2),
                pac_nn.PacConv2d(C, 4, kernel_size=K, padding=2), (x, g))
    if name == "pacconv2d_inv":
        return (jax_pac_nn.PacConv2d(features=3, kernel_size=3, padding=1,
                                     kernel_type="inv_0.5_2"),
                pac_nn.PacConv2d(C, 3, kernel_size=3, padding=1, kernel_type="inv_0.5_2"),
                (x, g))
    if name == "pacpool2d_cw":
        return (jax_pac_nn.PacPool2d(kernel_size=3, stride=2, padding=1, channel_wise=True,
                                     out_channels=C),
                pac_nn.PacPool2d(kernel_size=3, stride=2, padding=1, channel_wise=True,
                                 out_channels=C), (x, g))
    if name == "convt_linear":
        kw = dict(kernel_size=5, stride=2, padding=2, output_padding=1, filler="linear")
        return (jax_pac_nn.PacConvTranspose2d(C, C, **kw), pac_nn.PacConvTranspose2d(C, C, **kw),
                (rnp(12, B, 6, 7, C), rnp(13, B, 12, 14, 2)))
    if name == "convt_normalized":
        kw = dict(kernel_size=5, stride=2, padding=2, output_padding=1, normalize_kernel=True)
        return (jax_pac_nn.PacConvTranspose2d(C, 2, **kw), pac_nn.PacConvTranspose2d(C, 2, **kw),
                (rnp(12, B, 6, 7, C), rnp(13, B, 12, 14, 2)))
    if name == "pac_joint_upsample":
        return (jax_pac_nn.PacJointUpsample(factor=4, channels=2, guide_channels=5),
                pac_nn.PacJointUpsample(factor=4, channels=2, guide_channels=5),
                (rnp(14, 1, 5, 6, 2), rnp(15, 1, 20, 24, 5)))
    if name == "djif":
        return (jax_pac_nn.DJIF(factor=4, channels=2, guide_channels=5),
                pac_nn.DJIF(factor=4, channels=2, guide_channels=5),
                (rnp(16, 1, 5, 6, 2), rnp(17, 1, 20, 24, 5)))
    if name == "joint_bilateral":
        return (jax_pac_nn.JointBilateral(factor=4, channels=2),
                pac_nn.JointBilateral(factor=4, channels=2),
                (rnp(18, 1, 5, 6, 2), rnp(19, 1, 20, 24, 3)))
    raise KeyError(name)


MODULE_CASES = ("pacconv2d", "pacconv2d_inv", "pacpool2d_cw", "convt_linear",
                "convt_normalized", "pac_joint_upsample", "djif", "joint_bilateral")


def _carry(variables) -> dict:
    """``carry_state_dict`` of a module's own variables (its top-level
    parameters keyed without a module path)."""
    return {k.lstrip("."): v for k, v in carry_state_dict(variables).items()}


def _leaf_names(params) -> list:
    """The port's state-dict name of each of JAX's parameter leaves, in
    ``tree_flatten`` order."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        sub = cur = {}
        keys = [p.key for p in path]
        for k in keys[:-1]:
            cur = cur.setdefault(k, {})
        cur[keys[-1]] = np.asarray(leaf)
        (name,) = _carry({"params": sub})
        out.append(name)
    return out


@pytest.mark.parametrize("case", MODULE_CASES)
def test_pac_modules_match_jax(case):
    """The module's forward and the gradients of its inputs and of every
    parameter, with JAX's initialised variables carried across; the
    deterministic fillers (linear, identity) are the port's own init."""
    jmod, tmod, inputs = _module_case(case)
    variables = jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.key(0), *[jnp.asarray(a) for a in inputs]))
    state = _carry(variables)
    if case in ("convt_linear", "joint_bilateral"):
        init_weights(tmod, torch.Generator().manual_seed(0))
        for k, v in tmod.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), state[k].numpy(), err_msg=k)
    tmod.load_state_dict(state, strict=True)
    params = variables.get("params", {})
    leaves, tree = jax.tree_util.tree_flatten(params)
    names, n = _leaf_names(params), len(inputs)
    # A convolution's kernel is HWIO in JAX, OIHW in the port.
    oihw = [path[-1].key == "kernel" for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]

    def jax_fn(*a):
        return jmod.apply({"params": jax.tree_util.tree_unflatten(tree, list(a[n:]))}, *a[:n])

    def port_fn(*a):
        weights = {name: t.permute(3, 2, 0, 1) if conv else t
                   for name, t, conv in zip(names, a[n:], oihw)}
        return torch.func.functional_call(tmod, weights, tuple(a[:n]))

    _check_fn(port_fn, jax_fn, [*inputs, *[np.asarray(v) for v in leaves]])


# -------------------------------------------------------------- the model


def _model_cfgs(kind):
    jcfg = JaxModelConfig(variant="raft_nc_dbl", small=True, corr_impl="onthefly",
                          dataset="chairs", upsampler=JaxUpsamplerConfig(kind=kind))
    pcfg = ModelConfig(variant="raft_nc_dbl", small=True, corr_impl="pallas",
                       nconv_impl="pallas", dataset="chairs",
                       upsampler=UpsamplerConfig(kind=kind))
    return jcfg, pcfg


@pytest.fixture(scope="module", params=HEADS)
def carried(request):
    """JAX's model with each head, the port's seeded weights carried into
    its variables (the PAC transposed weights, which the JAX package's
    import does not map, set by hand in their shared layout)."""
    jcfg, pcfg = _model_cfgs(request.param)
    seeded = RAFT(pcfg, device="cpu", seed=0)
    jmodel = JaxRAFT(jcfg)
    template = jax.eval_shape(lambda k: jmodel.init(k, (1, *MODEL_HW, 3)), jax.random.key(0))
    state = {k: v.numpy() for k, v in seeded.state_dict().items()}
    convt = {k: state.pop(k) for k in list(state) if ".up_convt" in k and k.endswith("weight")}
    variables = import_torch_state(state, template, strict=True)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    for k, v in convt.items():
        node = variables["params"]
        for part in k.split(".")[:-1]:
            node = node[part]
        node["weight"] = v
    return request.param, jmodel, pcfg, variables


def test_carried_state_matches_export_torch_state(carried):
    kind, _, pcfg, variables = carried
    exported, state = export_torch_state(variables), carry_state_dict(variables)
    port = RAFT(pcfg, device="cpu").state_dict()
    assert set(state) == set(exported) == set(port)
    assert any(f"upsampler.{kind}." in k for k in state)
    for k, v in state.items():
        np.testing.assert_array_equal(v.numpy(), exported[k])
        assert tuple(v.shape) == tuple(port[k].shape), k


def test_forward_matches_jax(carried):
    kind, jmodel, pcfg, variables = carried
    port = load_jax_variables(RAFT(pcfg, device="cpu", seed=1), variables)
    g = np.random.default_rng(5)
    i1 = g.uniform(0, 255, (1, *MODEL_HW, 3)).astype(np.float32)
    i2 = np.roll(i1, (2, 3), axis=(1, 2)).copy()
    jlr, jup = jmodel.apply(variables, jnp.asarray(i1), jnp.asarray(i2), iters=3,
                            test_mode=True)
    lr, up = port(torch.from_numpy(i1), torch.from_numpy(i2), iters=3)
    assert up.shape == (1, *MODEL_HW, 2) and up.dtype == torch.float32
    assert bool(torch.isfinite(up).all())
    np.testing.assert_allclose(lr.numpy(), np.asarray(jlr), atol=LR_ATOL, rtol=RTOL)
    np.testing.assert_allclose(up.numpy(), np.asarray(jup), atol=UP_ATOL, rtol=RTOL)
    # The head stays f32 under bf16_infer (the trunk runs bf16).
    lr16, up16 = port.with_policy("bf16_infer")(torch.from_numpy(i1), torch.from_numpy(i2),
                                                iters=3)
    assert up16.dtype == torch.float32 and bool(torch.isfinite(up16).all())


def _batch(seed):
    g = np.random.default_rng(seed)
    img1 = g.uniform(0, 255, (TRAIN_BATCH, *MODEL_HW, 3)).astype(np.float32)
    return {"image1": img1, "image2": np.roll(img1, (2, 3), axis=(1, 2)).copy(),
            "flow": g.normal(0, 2, (TRAIN_BATCH, *MODEL_HW, 2)).astype(np.float32),
            "valid": (g.random((TRAIN_BATCH, *MODEL_HW)) > 0.1).astype(np.float32)}


def test_train_step_matches_jax(carried):
    kind, jmodel, pcfg, variables = carried
    batch = _batch(3)
    tx = _grad_capture()
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                          opt_state=tx.init(params), tx=tx, sentinel=jax_init_sentinel())
    jcfg = JaxTrainConfig(stage="chairs", iters=TRAIN_ITERS, batch_size=TRAIN_BATCH,
                          image_size=MODEL_HW)
    new_state, jmetrics = jax_make_train_step(jmodel, jcfg)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(2))
    ref_grads = carry_state_dict({"params": jax.tree_util.tree_map(np.array,
                                                                   new_state.opt_state)})

    model = load_jax_variables(RAFT(pcfg, device="cpu"), variables)
    cfg = TrainConfig(stage="chairs", iters=TRAIN_ITERS, batch_size=TRAIN_BATCH,
                      image_size=MODEL_HW)
    st = state_for(model, cfg)
    replay = _EncoderReplay(model)
    seen, update = [], st.optimizer.update

    def spy(grads, grad_norm):
        seen.append([g.clone() for g in grads])
        return update(grads, grad_norm)

    st.optimizer.update = spy
    metrics = make_train_step(cfg)(st, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = {name: g for (name, _), g in zip(st.named_params, seen[0])}
    replayed = replay.grads(cfg.freeze_bn)

    loss, jloss = float(metrics["loss"]), float(jmetrics["loss"])
    assert math.isfinite(loss) and float(metrics["bad_step"]) == 0.0
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss), (loss, jloss)
    assert set(grads) == set(ref_grads)
    assert any(f"upsampler.{kind}." in n and float(g.abs().max()) > 0 for n, g in grads.items())
    gmax = max(float(r.abs().max()) for r in ref_grads.values())
    for name, g in grads.items():
        r = ref_grads[name]
        scale = float(r.abs().max())
        if _zero_by_structure(name) or scale < NEGLIGIBLE * gmax:
            assert scale < NEGLIGIBLE * gmax and float(g.abs().max()) < NEGLIGIBLE * gmax, name
            continue
        # Behind a flipped ReLU of the DJIF head (see FLIPPED_HEADS) every
        # gradient upstream of the head moves: test_torch_train's tolerance
        # for gradients behind a flip.
        tol = GRAD_TOL if name.startswith("upsampler.") or kind not in FLIPPED_HEADS \
            else FLIP_TOL
        if name.startswith(ENCODERS):
            err = float((replayed[name] - r.double()).abs().max())
            assert err <= tol * scale, f"{name} (float64 replay): {err} vs max {scale}"
            continue
        err = float((g - r).abs().max())
        assert err <= tol * scale, f"{name}: {err} vs max {scale}"


# ------------------------------------------------------------------ the CLI


@pytest.mark.parametrize("flag,kind", [("PacJointUpsampleFull", "pac"),
                                       ("DjifOriginal", "djif"),
                                       ("NConvUpsampler", "nconv")])
def test_final_upsampling_flag_selects_the_head_as_jax(flag, kind):
    argv = ["--stage", "sintel", f"--final_upsampling={flag}", "--model", "raft_nc_dbl"]
    ours = cli.model_config_from_args(cli.build_train_parser().parse_args(argv), "sintel")
    theirs = jax_cli.model_config_from_args(jax_cli.build_train_parser().parse_args(argv),
                                            "sintel")
    assert ours.upsampler.kind == theirs.upsampler.kind == kind
    assert {k: v for k, v in dataclasses.asdict(ours.upsampler).items()
            if k in dataclasses.asdict(theirs.upsampler)} == {
        k: v for k, v in dataclasses.asdict(theirs.upsampler).items()
        if k in dataclasses.asdict(ours.upsampler)}
    head = build_upsampler(ours.upsampler, "sintel", guidance_ch=96)
    if kind == "nconv":
        assert not isinstance(head, pac_nn._PacHead)
    else:
        assert isinstance(head, pac_nn._PacHead) and hasattr(head, kind)
