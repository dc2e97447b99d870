"""Training of the port's other models against the JAX package's, on the
CPU.

One whole train step at 64x96, batch 2, 3 iterations, f32, against JAX
``make_train_step``, from the variables of the JAX ``RAFT(cfg).init``
with every BatchNorm mean and variance perturbed to seeded values,
carried into the port: ``raft`` (full size, convex upsampling with the
mask head every iteration) at stage ``things`` (BatchNorm frozen), and
small ``raft`` (bilinear ``upflow``, no BatchNorm anywhere) at stage
``chairs``. The loss within 1e-5 relative; every gradient within 1e-3 of
its own largest magnitude; the BatchNorm statistics after the step
within 1e-5. As in ``tests/test_torch_train.py``, JAX's gradients come
out of ``make_train_step`` through an optax transform that stores them,
JAX looks up correlations with ``corr_impl="onthefly"`` (the function
whose VJP the Pallas op's backward takes) and the port runs the kernels'
functions (their plain versions on the CPU). The biases ahead of the
feature encoder's instance norm have an exactly zero gradient: both
sides give rounding noise there, held below 1e-6 of the step's largest
gradient. Every encoder parameter is also held within 1e-3 against a
float64 replay of the port's own encoder.

Then the train entry with ``--model raft --small --device cpu``, resumed
from its checkpoint, which carries the variant.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_ncup_tpu.config import ModelConfig as JaxModelConfig
from raft_ncup_tpu.config import TrainConfig as JaxTrainConfig
from raft_ncup_tpu.models.raft import RAFT as JaxRAFT
from raft_ncup_tpu.parallel.step import make_train_step as jax_make_train_step
from raft_ncup_tpu.resilience.anomaly import init_sentinel as jax_init_sentinel
from raft_ncup_tpu.training.state import TrainState as JaxTrainState
from raft_ncup_tpu_torch import train as train_entry
from raft_ncup_tpu_torch.config import ModelConfig, TrainConfig
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.training import checkpoint
from raft_ncup_tpu_torch.training.state import state_for
from raft_ncup_tpu_torch.training.step import make_train_step
from raft_ncup_tpu_torch.utils.jax_weights import carry_state_dict, load_jax_variables
from test_torch_train import ENCODERS, _EncoderReplay, _grad_capture, _perturb_batch_stats

H, W = 64, 96
BATCH, ITERS = 2, 3
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-3
STATS_TOL = 1e-5
NEGLIGIBLE = 1e-6  # of the step's largest gradient
CASES = {
    "raft_things_bn_frozen": (dict(variant="raft"), "things"),
    "raft_small_chairs": (dict(variant="raft", small=True), "chairs"),
}


def _batch(seed):
    g = np.random.default_rng(seed)
    img1 = g.uniform(0, 255, (BATCH, H, W, 3)).astype(np.float32)
    return {
        "image1": img1,
        "image2": np.roll(img1, (2, 3), axis=(1, 2)).copy(),
        "flow": g.normal(0, 2, (BATCH, H, W, 2)).astype(np.float32),
        "valid": (g.random((BATCH, H, W)) > 0.1).astype(np.float32),
    }


def _zero_by_structure(name):
    """Whether ``name`` is the bias of a convolution whose output the
    feature encoder's instance norm centres per channel (its gradient is
    exactly zero). No other normalization centres in these steps: the
    full-size context encoder's BatchNorm is frozen and the small one has
    none."""
    if not name.startswith("fnet.") or not name.endswith(".bias") or name == "fnet.conv2.bias":
        return False
    return name.rsplit(".", 2)[-2].startswith("conv") or name.endswith("downsample.0.bias")


def _jax_step(kw, stage, batch):
    """JAX ``make_train_step`` once from perturbed init variables:
    (variables as numpy, loss, gradients, BatchNorm statistics after)."""
    model = JaxRAFT(JaxModelConfig(corr_impl="onthefly", dataset=stage, **kw))
    variables = jax.jit(model.init, static_argnums=1)(jax.random.key(0), (1, H, W, 3))
    variables = jax.tree_util.tree_map(np.array, variables)
    _perturb_batch_stats(variables.get("batch_stats", {}), np.random.default_rng(1))
    tx = _grad_capture()
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables.get("batch_stats", {})),
        opt_state=tx.init(params), tx=tx, sentinel=jax_init_sentinel(),
    )
    cfg = JaxTrainConfig(stage=stage, iters=ITERS, batch_size=BATCH, image_size=(H, W))
    new_state, metrics = jax_make_train_step(model, cfg)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(2))
    return dict(
        variables=variables, loss=float(metrics["loss"]),
        grads=jax.tree_util.tree_map(np.array, new_state.opt_state),
        batch_stats=jax.tree_util.tree_map(np.array, new_state.batch_stats),
        bad_step=float(metrics["bad_step"]),
    )


def _port_step(kw, stage, variables, batch):
    """The port's ``make_train_step`` once from the same variables: (loss,
    gradients by name, the encoders' float64 replay, the model after, the
    metrics)."""
    model = RAFT(ModelConfig(corr_impl="pallas", nconv_impl="pallas", dataset=stage, **kw),
                 device="cpu")
    load_jax_variables(model, variables)
    cfg = TrainConfig(stage=stage, iters=ITERS, batch_size=BATCH, image_size=(H, W))
    state = state_for(model, cfg)
    replay = _EncoderReplay(model)
    seen = []
    update = state.optimizer.update

    def spy(grads, grad_norm):
        seen.append([g.clone() for g in grads])
        return update(grads, grad_norm)

    state.optimizer.update = spy
    metrics = make_train_step(cfg)(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = {name: g for (name, _), g in zip(state.named_params, seen[0])}
    return float(metrics["loss"]), grads, replay.grads(cfg.freeze_bn), model, metrics


@pytest.mark.parametrize("case", sorted(CASES))
def test_variant_train_step_matches_jax(case):
    kw, stage = CASES[case]
    batch = _batch(3)
    ref = _jax_step(kw, stage, batch)
    loss, grads, replayed, model, metrics = _port_step(kw, stage, ref["variables"], batch)

    assert ref["bad_step"] == 0.0 and float(metrics["bad_step"]) == 0.0
    assert math.isfinite(loss)
    assert abs(loss - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"]), (loss, ref["loss"])

    ref_grads = carry_state_dict({"params": ref["grads"]})
    assert set(grads) == set(ref_grads)
    if kw["variant"] == "raft" and not kw.get("small"):
        assert float(grads["update_block.mask.2.weight"].abs().max()) > 0
    gmax = max(float(r.abs().max()) for r in ref_grads.values())
    worst = (0.0, "")
    for name, g in grads.items():
        r = ref_grads[name]
        scale = float(r.abs().max())
        if _zero_by_structure(name) or scale < NEGLIGIBLE * gmax:
            assert scale < NEGLIGIBLE * gmax, f"{name}: JAX {scale} of {gmax}"
            assert float(g.abs().max()) < NEGLIGIBLE * gmax, f"{name}: {g.abs().max()}"
            continue
        if name.startswith(ENCODERS):
            err = float((replayed[name] - r.double()).abs().max())
            assert err <= GRAD_TOL * scale, f"{name} (float64 replay): {err} vs max {scale}"
        err = float((g - r).abs().max())
        worst = max(worst, (err / scale, name))
        assert err <= GRAD_TOL * scale, f"{name}: {err} vs max {scale}"
    print(f"{case}: loss {loss:.6f} (JAX {ref['loss']:.6f}); worst gradient {worst}")

    ref_stats = carry_state_dict({"batch_stats": ref["batch_stats"]})
    buffers = dict(model.named_buffers())
    assert {k for k in buffers if not k.endswith("num_batches_tracked")} == {
        k for k in ref_stats if not k.endswith("num_batches_tracked")}
    for name, r in ref_stats.items():
        if not name.endswith("num_batches_tracked"):
            torch.testing.assert_close(buffers[name], r, rtol=0, atol=STATS_TOL)


def _entry_args(tmp, steps, *extra):
    return ["--name", "small", "--stage", "chairs", "--num_steps", str(steps),
            "--batch_size", "1", "--image_size", "64", "96", "--iters", "2",
            "--sum_freq", "1", "--lr", "1e-4", "--checkpoint_dir", str(tmp),
            "--scheduler", "step", "--device", "cpu", *extra]


def test_train_entry_trains_and_resumes_the_small_raft_model(tmp_path, capsys):
    """2 steps of ``--model raft --small``, then a run restored from its
    checkpoint to step 3 without the model flags: the checkpoint carries
    the variant. A third run straight to 3 steps ends in the same weights
    (the step schedule does not depend on ``--num_steps``, as the cyclic
    one does)."""
    assert train_entry.main(_entry_args(tmp_path, 2, "--model", "raft", "--small")) == 0
    ckpt = torch.load(tmp_path / "small" / "step_2.pt", weights_only=True)
    assert (ckpt["model_cfg"]["variant"], ckpt["model_cfg"]["small"]) == ("raft", True)
    assert train_entry.main(_entry_args(tmp_path, 3, "--restore_ckpt",
                                        str(tmp_path / "small"))) == 0
    out = capsys.readouterr().out
    assert '"steps": 2, "step": 2' in out and '"steps": 1, "step": 3' in out
    assert out.count('"variant": "raft", "small": true') == 2
    resumed = checkpoint.restore(str(tmp_path / "small"), TrainConfig(), "cpu")
    assert resumed.step == 3 and resumed.model.cfg.small
    whole_dir = tmp_path / "whole"
    assert train_entry.main(_entry_args(whole_dir, 3, "--model", "raft", "--small")) == 0
    whole = checkpoint.restore(str(whole_dir / "small"), TrainConfig(), "cpu")
    for k, v in whole.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k


@pytest.mark.parametrize("kw", [dict(variant="raft"), dict(variant="raft_nc_dbl", small=True),
                                dict(variant="raft_nc_dbl", upsampler_kind="bilinear")],
                         ids=["raft", "raft_nc_dbl_small", "raft_nc_dbl_bilinear"])
def test_variant_checkpoint_round_trip(kw, tmp_path):
    """A saved state of each variant restores to the same configuration,
    weights and step."""
    from raft_ncup_tpu_torch.config import UpsamplerConfig

    kw = dict(kw)
    kind = kw.pop("upsampler_kind", "nconv")
    cfg = TrainConfig(stage="chairs", checkpoint_dir=str(tmp_path))
    model = RAFT(ModelConfig(upsampler=UpsamplerConfig(kind=kind), **kw), device="cpu", seed=5)
    state = state_for(model, cfg)
    state.step = 7
    back = checkpoint.restore(checkpoint.save(state, cfg), cfg, "cpu")
    assert back.model.cfg == model.cfg and back.step == 7
    for k, v in model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], v), k


def test_train_flags_select_the_model():
    parse = functools.partial(train_entry.build_parser().parse_args)
    from raft_ncup_tpu_torch.cli import model_config_from_args

    base = ["--stage", "things"]
    cfg = model_config_from_args(parse(base), "things")
    assert (cfg.variant, cfg.small, cfg.upsampler.kind) == ("raft_nc_dbl", False, "nconv")
    cfg = model_config_from_args(
        parse(base + ["--model", "raft", "--small", "--align_corners"]), "things")
    assert (cfg.variant, cfg.small, cfg.align_corners) == ("raft", True, True)
    assert (cfg.corr_impl, cfg.nconv_impl, cfg.dataset) == ("pallas", "pallas", "things")
    cfg = model_config_from_args(parse(base + ["--upsampler_bi"]), "things")
    assert cfg.upsampler.kind == "bilinear"
