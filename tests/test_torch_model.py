"""The slice as a whole: the port's flagship RAFT-NCUP test-mode forward
against the JAX model, on the CPU, with the JAX variables carried across.

JAX runs ``RAFT(flagship_config(corr_impl="pallas")).apply(...,
test_mode=True)``: on the CPU its correlation lookup is the Pallas kernel
in interpret mode (``models/raft.py:335-337``) and its NConv2d the XLA
composition. The port runs ``corr_impl="pallas", nconv_impl="pallas"``,
whose wrappers take their plain versions on CPU tensors. At 64x96 the
deepest correlation level is 1x1. Every BatchNorm mean and variance is
perturbed to seeded values first, so a swapped BN mapping fails.

Tolerances are those the JAX package was held to against the PyTorch
original (``tests/test_torch_parity.py:138-139``): flow_lr atol 2e-3,
flow_up atol 5e-3, rtol 1e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_ncup_tpu.config import flagship_config as jax_flagship_config
from raft_ncup_tpu.models.raft import RAFT as JaxRAFT
from raft_ncup_tpu.utils.torch_export import export_torch_state
from raft_ncup_tpu_torch.config import (
    ModelConfig,
    UpsamplerConfig,
    flagship_config,
    small_model_config,
)
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.utils import device as device_mod
from raft_ncup_tpu_torch.utils.jax_weights import carry_state_dict, load_jax_variables

H, W, ITERS = 64, 96, 3


def _perturb_batch_stats(tree, g):
    for key in sorted(tree):
        v = tree[key]
        if isinstance(v, dict):
            _perturb_batch_stats(v, g)
        elif key == "mean":
            tree[key] = g.normal(0.0, 0.2, v.shape).astype(np.float32)
        elif key == "var":
            tree[key] = g.uniform(0.5, 1.5, v.shape).astype(np.float32)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX model, its (perturbed) variables as numpy, the inputs and
    the JAX outputs, computed once for the file."""
    g = np.random.default_rng(0)
    model = JaxRAFT(jax_flagship_config(corr_impl="pallas"))
    # Jitted: one compile each instead of one per primitive.
    variables = jax.jit(model.init, static_argnums=1)(jax.random.key(0), (1, H, W, 3))
    variables = jax.tree_util.tree_map(np.array, variables)
    _perturb_batch_stats(variables["batch_stats"], g)
    img1 = g.uniform(0, 255, (1, H, W, 3)).astype(np.float32)
    img2 = np.roll(img1, (2, 3), axis=(1, 2)).copy()
    apply = jax.jit(functools.partial(model.apply, iters=ITERS, test_mode=True))
    flow_lr, flow_up = apply(variables, jnp.asarray(img1), jnp.asarray(img2))
    flow_init = g.normal(0, 2, (1, H // 8, W // 8, 2)).astype(np.float32)
    warm_lr, warm_up = apply(
        variables, jnp.asarray(img1), jnp.asarray(img2),
        flow_init=jnp.asarray(flow_init),
    )
    return dict(
        variables=variables, img1=img1, img2=img2,
        flow_lr=np.asarray(flow_lr), flow_up=np.asarray(flow_up),
        flow_init=flow_init, warm_lr=np.asarray(warm_lr),
        warm_up=np.asarray(warm_up),
    )


def _port_model(variables):
    model = RAFT(
        flagship_config(corr_impl="pallas", nconv_impl="pallas"), device="cpu"
    )
    return load_jax_variables(model, variables)


def test_carried_state_matches_export_torch_state(jax_run):
    variables = jax_run["variables"]
    carried = carry_state_dict(variables)
    exported = export_torch_state(variables)
    model = RAFT(flagship_config(), device="cpu")
    held = model.state_dict()
    assert set(carried) == set(held)
    # Every tensor the port holds is keyed as the export keys it; the
    # export adds only the reference's duplicate aliases.
    assert set(held) <= set(exported)
    extra = set(exported) - set(held)
    assert all(".norm3." in k or ".encoder." in k for k in extra), sorted(extra)
    for k, v in carried.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(exported[k]), err_msg=k)
    model.load_state_dict(carried, strict=True)


def test_flagship_forward_matches_jax(jax_run):
    model = _port_model(jax_run["variables"])
    flow_lr, flow_up = model(
        torch.from_numpy(jax_run["img1"]), torch.from_numpy(jax_run["img2"]),
        iters=ITERS,
    )
    flow_lr, flow_up = flow_lr.numpy(), flow_up.numpy()
    assert flow_lr.shape == jax_run["flow_lr"].shape == (1, H // 8, W // 8, 2)
    assert flow_up.shape == jax_run["flow_up"].shape == (1, H, W, 2)
    d_lr = np.abs(flow_lr - jax_run["flow_lr"]).max()
    d_up = np.abs(flow_up - jax_run["flow_up"]).max()
    print(f"flagship 64x96 {ITERS} iters: max|flow_lr diff| {d_lr:.3e}, "
          f"max|flow_up diff| {d_up:.3e}, "
          f"max|flow_up| {np.abs(jax_run['flow_up']).max():.3f}")
    np.testing.assert_allclose(flow_lr, jax_run["flow_lr"], atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(flow_up, jax_run["flow_up"], atol=5e-3, rtol=1e-3)


def test_flow_init_warm_start_matches_jax(jax_run):
    """``flow_init`` shifts the initial coordinates (the warm start the
    evaluation of video sequences uses)."""
    model = _port_model(jax_run["variables"])
    flow_lr, flow_up = model(
        torch.from_numpy(jax_run["img1"]), torch.from_numpy(jax_run["img2"]),
        iters=ITERS, flow_init=torch.from_numpy(jax_run["flow_init"]),
    )
    print(f"flow_init: max|flow_lr diff| "
          f"{np.abs(flow_lr.numpy() - jax_run['warm_lr']).max():.3e}, max|flow_up diff| "
          f"{np.abs(flow_up.numpy() - jax_run['warm_up']).max():.3e}")
    np.testing.assert_allclose(flow_lr.numpy(), jax_run["warm_lr"], atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(flow_up.numpy(), jax_run["warm_up"], atol=5e-3, rtol=1e-3)
    assert np.abs(jax_run["warm_lr"] - jax_run["flow_lr"]).max() > 0.1


def test_entry_points_raise_without_cuda_and_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_mod.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RAFT(flagship_config())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_mod.resolve_device("cuda")


def test_forward_runs_with_tf32_off_and_restores_the_callers_flags(monkeypatch):
    """The model owns the f32 policy: TF32 is off inside its forward and in
    the kernels' plain versions whatever the caller set, and the caller's
    flags come back afterwards."""
    from raft_ncup_tpu_torch.ops import corr_cuda, nconv_cuda
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = []

    def spy(fn):
        def call(*args, **kwargs):
            seen.append((fn.__name__, torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))
            return fn(*args, **kwargs)
        return call

    # Every convolution and contraction of the model goes through these two.
    monkeypatch.setattr(torch.nn.functional, "conv2d", spy(torch.nn.functional.conv2d))
    monkeypatch.setattr(torch, "einsum", spy(torch.einsum))
    g = np.random.default_rng(0)
    model = RAFT(flagship_config(corr_impl="pallas", nconv_impl="pallas"), device="cpu")
    x = torch.from_numpy(g.uniform(0, 255, (1, 64, 64, 3)).astype(np.float32))
    _, flow_up = model(x, x, iters=1)
    d = torch.from_numpy(g.uniform(0, 1, (1, 1, 8, 8)).astype(np.float32))
    nconv_cuda.nconv2d_plain(d, d, d[0, :, :3, :3].expand(2, 1, 3, 3))
    f = torch.from_numpy(g.normal(size=(1, 4, 4, 8)).astype(np.float32))
    corr_cuda.lookup_pyramid(f, [f], torch.zeros(1, 4, 4, 2), 1)
    assert flow_up.shape == (1, 64, 64, 2)
    assert {name for name, *_ in seen} == {"conv2d", "einsum"}
    assert all(flags == [False, False] for _, *flags in seen), seen
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


def test_unported_configurations_raise():
    """The settings of later slices raise, each naming its slice: the PAC
    and DJIF upsamplers. Encoder dropout and ``freeze_raft`` build (a
    dropout outside [0, 1) raises). The bf16
    presets build with their policy, and an unknown preset raises. The
    variants and heads of this slice build; a size not divisible by 8
    raises; training mode works."""
    for preset, legacy in (("bf16_infer", False), ("bf16_train", False), ("f32", True)):
        cfg = flagship_config(precision=preset, mixed_precision=legacy)
        model = RAFT(cfg, device="cpu")
        want = "bf16_infer" if legacy else preset
        assert model.policy.name == cfg.precision_policy.name == want
        assert model.fnet.conv1.dtype == torch.bfloat16
        assert model.fnet.conv1.weight.dtype == torch.float32
    with pytest.raises(ValueError, match="unknown precision preset"):
        flagship_config(precision="fp8")
    for kind in ("pac", "djif"):  # the port's since the PAC slice (nn/pac.py)
        assert UpsamplerConfig(kind=kind).kind == kind
    for knob in ({"dropout": 0.1}, {"freeze_raft": True}):
        assert RAFT(flagship_config(**knob), device="cpu").cfg == flagship_config(**knob)
    with pytest.raises(ValueError, match="dropout"):
        flagship_config(dropout=1.0)
    for bad in ({"kind": "nearest"}, {"weights_est_net": "mlp"}):
        with pytest.raises(ValueError):
            UpsamplerConfig(**bad)
    for cfg in (ModelConfig(variant="raft"), small_model_config(align_corners=False),
                small_model_config("raft_nc_dbl"),
                flagship_config(upsampler=UpsamplerConfig(kind="bilinear"))):
        assert RAFT(cfg, device="cpu").cfg == cfg
    with pytest.raises(ValueError):
        model = RAFT(flagship_config(), device="cpu")
        x = torch.zeros(1, 60, 90, 3)
        model(x, x, iters=1)
    # Training mode is ported: train() works, and the forward then returns
    # every iteration's upsampled flow, differentiable.
    model = RAFT(flagship_config(), device="cpu")
    assert model.train() is model and model.training
    x = torch.zeros(1, 64, 64, 3)
    seq = model(x, x + 1.0, iters=2)
    assert seq.shape == (2, 1, 64, 64, 2) and seq.requires_grad
    model.eval()
    flow_lr, flow_up = model(x, x, iters=1)
    assert flow_up.shape == (1, 64, 64, 2) and not flow_up.requires_grad
