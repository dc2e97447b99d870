"""A train step whose correlation pyramid has an empty level, through the
port and through the JAX package, on the CPU.

Small ``raft`` at 32x48: the features are 4x6, so the pyramid's levels
are 4x6, 2x3, 1x1 and 0x0. The empty fourth level takes no part in the
lookup's graph; the plain backward of kernel A' (``lookup_pyramid_backward``)
once raised there ("The differentiated Tensor ... appears to not have been
used in the graph"). JAX's ``make_train_step`` runs at this size, so the
port's step is held against it at ``tests/test_torch_train.py``'s
tolerances: the loss within 1e-5 relative, every gradient within 1e-3 of
its own largest magnitude, and a gradient that is zero by structure (the
biases ahead of instance norm) below 1e-6 of the step's largest on both
sides. The plain backward itself gives the empty level a zero gradient of
its shape, and its other gradients equal the float64 plain autograd.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from raft_ncup_tpu.config import ModelConfig as JaxModelConfig
from raft_ncup_tpu.config import TrainConfig as JaxTrainConfig
from raft_ncup_tpu.models.raft import RAFT as JaxRAFT
from raft_ncup_tpu.parallel.step import make_train_step as jax_make_train_step
from raft_ncup_tpu.resilience.anomaly import init_sentinel as jax_init_sentinel
from raft_ncup_tpu.training.state import TrainState as JaxTrainState
from raft_ncup_tpu.utils.torch_import import import_torch_state
import raft_ncup_tpu_torch.models.raft as raft_mod
from raft_ncup_tpu_torch.config import ModelConfig, TrainConfig
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.ops.corr_cuda import (
    lookup_pyramid,
    lookup_pyramid_backward,
    prepare_levels,
)
from raft_ncup_tpu_torch.training.state import state_for
from raft_ncup_tpu_torch.training.step import make_train_step
from raft_ncup_tpu_torch.utils.jax_weights import carry_state_dict, load_jax_variables

torch.set_num_threads(1)

H, W, BATCH, ITERS = 32, 48, 1, 2
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-3
NEGLIGIBLE = 1e-6  # of the step's largest gradient


def _batch():
    g = np.random.default_rng(0)
    img1 = g.uniform(0, 255, (BATCH, H, W, 3)).astype(np.float32)
    return {"image1": img1, "image2": np.roll(img1, (2, 3), axis=(1, 2)).copy(),
            "flow": g.normal(0, 2, (BATCH, H, W, 2)).astype(np.float32),
            "valid": np.ones((BATCH, H, W), np.float32)}


def _jax_step(batch):
    """JAX's train step on the port's seeded weights: (variables, loss,
    gradients), the gradients stored by an optax transform that updates
    nothing."""
    model = JaxRAFT(JaxModelConfig(variant="raft", small=True, corr_impl="onthefly"))
    template = jax.eval_shape(lambda k: model.init(k, (1, H, W, 3)), jax.random.key(0))
    port = RAFT(ModelConfig(variant="raft", small=True), device="cpu", seed=0)
    variables = import_torch_state({k: v.numpy() for k, v in port.state_dict().items()},
                                   template, strict=True)
    variables = jax.tree_util.tree_map(np.array, variables)
    tx = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables.get("batch_stats", {})),
        opt_state=tx.init(params), tx=tx, sentinel=jax_init_sentinel())
    cfg = JaxTrainConfig(stage="things", iters=ITERS, batch_size=BATCH, image_size=(H, W))
    new_state, metrics = jax_make_train_step(model, cfg)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(2))
    assert float(metrics["bad_step"]) == 0.0
    return variables, float(metrics["loss"]), jax.tree_util.tree_map(np.array,
                                                                    new_state.opt_state)


def test_train_step_with_an_empty_pyramid_level_matches_jax(monkeypatch):
    batch = _batch()
    variables, ref_loss, ref_grads = _jax_step(batch)
    model = RAFT(ModelConfig(variant="raft", small=True, corr_impl="pallas"), device="cpu")
    load_jax_variables(model, variables)
    cfg = TrainConfig(stage="things", iters=ITERS, batch_size=BATCH, image_size=(H, W))
    state = state_for(model, cfg)
    seen = []
    update = state.optimizer.update

    def spy(grads, grad_norm):
        seen.append([g.clone() for g in grads])
        return update(grads, grad_norm)

    state.optimizer.update = spy
    levels = []

    def recording(*a, **kw):
        f1s, lv = prepare_levels(*a, **kw)
        levels.append([tuple(t.shape[1:3]) for t in lv])
        return f1s, lv

    monkeypatch.setattr(raft_mod, "prepare_levels", recording)
    metrics = make_train_step(cfg)(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert levels and levels[0] == [(4, 6), (2, 3), (1, 1), (0, 0)]
    loss = float(metrics["loss"])
    assert float(metrics["bad_step"]) == 0.0
    assert abs(loss - ref_loss) <= LOSS_RTOL * abs(ref_loss), (loss, ref_loss)

    grads = {name: g for (name, _), g in zip(state.named_params, seen[0])}
    ref = carry_state_dict({"params": ref_grads})
    assert set(grads) == set(ref)
    gmax = max(float(r.abs().max()) for r in ref.values())
    for name, g in grads.items():
        r = ref[name]
        scale = float(r.abs().max())
        if scale < NEGLIGIBLE * gmax:  # zero by structure on both sides
            assert float(g.abs().max()) < NEGLIGIBLE * gmax, name
            continue
        err = float((g - r).abs().max())
        assert err <= GRAD_TOL * scale, f"{name}: {err} vs max {scale}"


def test_plain_backward_gives_an_empty_level_a_zero_gradient():
    g = torch.Generator().manual_seed(0)
    fmap1 = torch.randn(1, 4, 6, 16, generator=g, dtype=torch.float64)
    fmap2 = torch.randn(1, 4, 6, 16, generator=g, dtype=torch.float64)
    coords = torch.rand(1, 4, 6, 2, generator=g, dtype=torch.float64) * 5
    f1s, lv = prepare_levels(fmap1, fmap2, 4, dtype=torch.float64)
    assert [tuple(t.shape[1:3]) for t in lv] == [(4, 6), (2, 3), (1, 1), (0, 0)]
    radius = 3
    grad = torch.randn(1, 4, 6, 4 * (2 * radius + 1) ** 2, generator=g, dtype=torch.float64)
    df1, dlv, dco = lookup_pyramid_backward(f1s, lv, coords, radius, grad)
    assert dlv[3].shape == lv[3].shape and dlv[3].numel() == 0
    # The float64 plain autograd of the same inputs, the empty level left out.
    leaves = [f1s.clone().requires_grad_(), coords.clone().requires_grad_()] + [
        t.clone().requires_grad_() for t in lv[:3]]
    out = lookup_pyramid(leaves[0], leaves[2:] + [lv[3]], leaves[1], radius)
    want = torch.autograd.grad(out, leaves, grad)
    for got, ref in zip([df1, dco, *dlv[:3]], want):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-12)
    # Only some of the gradients asked for: the rest stay None.
    df1, dlv, dco = lookup_pyramid_backward(f1s, lv, coords, radius, grad,
                                            needs=(False, True, False))
    assert df1 is None and dco is None and dlv[3].numel() == 0
