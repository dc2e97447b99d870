"""The port's bf16 precision presets against the JAX package's, on the CPU.

- The policy: the presets, their pinned dtypes, the error budgets and the
  errors on unknown presets equal JAX's, and so does the resolution of
  ``mixed_precision`` against an explicit preset, through ``ModelConfig``
  and through the CLI.
- The pyramid and the pre-scale under bf16: ``prepare_levels`` gives JAX's
  ``(fmap1 * scale).astype(bf16)`` and ``_pool_fmap_pyramid(fmap2.astype(
  bf16))`` bit for bit, at C=256 (a scale of 1/16) and C=128 (a scale that
  bf16 rounds), from f32 and from bf16 maps.
- The lookup on the same bf16 operands: the port's wrapper (its plain
  version on the CPU) against JAX ``corr_lookup_pallas(..., dtype=bf16)``
  in interpret mode, within atol 1e-4, the f32 rows' tolerance.
- The whole test-mode forward under ``bf16_infer`` at 64x96, 3
  iterations, for the flagship and for ``raft``, with the JAX variables
  carried across (JAX runs ``corr_impl="pallas"`` in interpret mode): the
  port's bf16 flow is no further from JAX's bf16 flow, in mean EPE, than
  JAX's bf16 flow is from JAX's f32 flow, both within
  ``FORWARD_EPE_BUDGET``, and the outputs are f32. Under f32 the forward
  converts no tensor between float dtypes.
- Training under ``bf16_train``, 2 steps of the flagship (batch 1, 64x96,
  3 iterations, AdamW at a constant 1e-3 so that the second step moves):
  the port's loss trajectory tracks its f32 trajectory and JAX's
  ``bf16_train`` trajectory within ``TRAIN_LOSS_RTOL``; every parameter,
  gradient and optimizer moment, the loss, the gradient norm and the
  sentinel stay f32; NCUP's layers receive f32. JAX's step looks up with
  ``corr_impl="onthefly"``, the function the Pallas op's backward
  differentiates (``tests/test_torch_train.py`` does the same).
  ``TrainConfig.precision`` names the model's preset: a train state
  refuses a model of another, the train entry logs the preset it trains
  (``--mixed_precision`` alone: ``bf16_infer``), and a resumed run keeps
  its checkpoint's.
- Serving: an f32-built model served with ``ServeConfig(precision=
  "bf16_infer")`` answers as a ``bf16_infer``-built model with the same
  weights, holds no copy of them, and its report names the preset.
- The card's bound on a served bf16 pair against the bf16 plain-version
  forward (``chip_smoke.BF16_PLAIN_SHARE``): a 1e-6 relative perturbation
  of every lookup of a 128x256 bf16 forward moves it by less than that
  share of bf16's own distance from f32, for the flagship, ``raft`` and
  small ``raft``.

Measured on the CPU (worst over the cases): the bf16 lookup against JAX's
Pallas kernel 3.98e-5 (atol 1e-4); the forward's mean EPE (px), port bf16
against JAX bf16, 9.79e-3 (flagship) and 4.03e-3 (raft), against JAX bf16
against JAX f32 1.10e-2 and 6.51e-3 (max |flow_up diff| port against JAX
3.35e-2 and 8.32e-3); the train losses relative to the port's f32
trajectory 2.4e-3 and to JAX's bf16 trajectory 4.3e-3 (tolerance 0.15); the
perturbed lookups moved the bf16 forward by 0.177 (flagship), 0.097
(raft) and 0.145 (small raft) of bf16's distance from f32 (bound 0.5).
The two bf16 forwards round at different places (the port rounds the
result of every op to bf16; XLA may keep f32 between the ops it fuses), so
they are held by mean EPE against bf16's own distance from f32.

Choice recorded here: the port's ``Conv2d`` under a compute dtype adds its
bias after the convolution, in bf16, as the JAX layer does. Passing the
bias into the convolution call instead measured 1.03e-2 and 4.34e-3 mean
EPE against JAX bf16 above; on the card both are a convolution and an add.
"""

import argparse
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from raft_ncup_tpu import precision as jax_precision
from raft_ncup_tpu.cli import add_model_args as jax_add_model_args
from raft_ncup_tpu.cli import model_config_from_args as jax_model_config_from_args
from raft_ncup_tpu.config import ModelConfig as JaxModelConfig
from raft_ncup_tpu.config import TrainConfig as JaxTrainConfig
from raft_ncup_tpu.models.raft import RAFT as JaxRAFT
from raft_ncup_tpu.ops.corr import _pool_fmap_pyramid as jax_pool_fmap_pyramid
from raft_ncup_tpu.ops.corr_pallas import corr_lookup_pallas
from raft_ncup_tpu.parallel.step import make_train_step as jax_make_train_step
from raft_ncup_tpu.resilience.anomaly import init_sentinel as jax_init_sentinel
from raft_ncup_tpu.training import optim as jax_optim
from raft_ncup_tpu.training.state import TrainState as JaxTrainState
from raft_ncup_tpu.utils.torch_import import import_torch_state
from raft_ncup_tpu_torch import cli as cli_mod
from raft_ncup_tpu_torch import precision
from raft_ncup_tpu_torch import serve as serve_mod
from raft_ncup_tpu_torch import train as train_mod
from raft_ncup_tpu_torch.cli import add_model_args, model_config_from_args
from raft_ncup_tpu_torch.config import ModelConfig, ServeConfig, TrainConfig
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.ops.corr_cuda import lookup_levels, prepare_levels
from raft_ncup_tpu_torch.serving import FlowServer
from raft_ncup_tpu_torch.training.state import create_train_state, state_for
from raft_ncup_tpu_torch.training.step import make_train_step
from raft_ncup_tpu_torch.utils.jax_weights import load_jax_variables

H, W, ITERS = 64, 96, 3
CORR_ATOL = 1e-4
PINNED = ("param", "compute", "output", "corr", "coord", "acc", "norm", "upsampler")
BATCH, STEPS = 1, 2
TRAIN_KW = dict(stage="things", iters=ITERS, batch_size=BATCH, image_size=(H, W),
                lr=1e-3, scheduler="step", scheduler_step=1000)


def _name(dtype) -> str:
    """'float32' / 'bfloat16' for a torch or a numpy-style JAX dtype."""
    return str(dtype).removeprefix("torch.")


def _bits(x) -> np.ndarray:
    """The 16-bit patterns of a bf16 torch tensor or JAX array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _jax_variables(jax_model, port_model):
    """The port model's weights as JAX variables (numpy), imported into the
    tree ``init`` would make (its shapes only: no init runs)."""
    template = jax.eval_shape(lambda k: jax_model.init(k, (1, H, W, 3)), jax.random.key(0))
    state = {k: v.numpy() for k, v in port_model.state_dict().items()}
    return jax.tree_util.tree_map(np.array, import_torch_state(state, template, strict=True))


def _epe(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b), axis=-1).mean())


# ------------------------------------------------------------------ policy

def test_presets_pins_and_budgets_match_jax():
    assert precision.PRESET_NAMES == jax_precision.PRESET_NAMES
    assert precision.FORWARD_EPE_BUDGET == jax_precision.FORWARD_EPE_BUDGET == 0.5
    assert precision.TRAIN_LOSS_RTOL == jax_precision.TRAIN_LOSS_RTOL == 0.15
    for name in precision.PRESET_NAMES:
        ours, ref = precision.PRESETS[name], jax_precision.PRESETS[name]
        assert ours.name == ref.name and ours.is_f32 == ref.is_f32
        for attr in PINNED:
            assert _name(getattr(ours, attr)) == _name(getattr(ref, f"{attr}_jnp")), attr
        assert ours.corr_itemsize == ref.corr_itemsize
        if ref.module_dtype is None:
            assert ours.module_dtype is None
        else:
            assert _name(ours.module_dtype) == _name(ref.module_dtype)
        assert precision.resolve_policy(name) is ours
    assert precision.resolve_policy(None) is precision.F32
    assert precision.resolve_policy(precision.BF16_TRAIN) is precision.BF16_TRAIN


@pytest.mark.parametrize("build", [
    lambda m: m.resolve_policy("fp8"),
    lambda m: m.resolve_policy("bf16"),
    lambda m: m.PrecisionPolicy(name="half", compute_dtype="float16"),
    lambda m: m.PrecisionPolicy(name="bf16_master", param_dtype="bfloat16"),
    lambda m: m.PrecisionPolicy(name="bf16_out", output_dtype="bfloat16"),
], ids=["unknown", "bare_bf16", "float16", "bf16_master_weights", "bf16_output"])
def test_invalid_presets_raise_as_jax(build):
    with pytest.raises(ValueError) as ours:
        build(precision)
    with pytest.raises(ValueError) as ref:
        build(jax_precision)
    assert str(ours.value) == str(ref.value)


def test_configs_refuse_an_unknown_preset():
    for make in (lambda: ModelConfig(precision="fp8"),
                 lambda: ServeConfig(precision="fp8"),
                 lambda: TrainConfig(precision="fp8")):
        with pytest.raises(ValueError, match="unknown precision preset"):
            make()
    assert ServeConfig().precision is None and TrainConfig().precision == "f32"


@pytest.mark.parametrize("precision_, mixed", [
    ("f32", False), ("f32", True), ("bf16_infer", False), ("bf16_train", True),
])
def test_mixed_precision_resolves_as_jax(precision_, mixed):
    ours = ModelConfig(precision=precision_, mixed_precision=mixed).precision_policy
    ref = JaxModelConfig(precision=precision_, mixed_precision=mixed).precision_policy
    assert ours.name == ref.name


@pytest.mark.parametrize("argv", [
    [], ["--mixed_precision"], ["--mixed_precision", "--precision", "f32"],
    ["--precision", "bf16_train"], ["--precision", "bf16_infer", "--mixed_precision"],
])
def test_cli_resolves_the_preset_as_jax(argv):
    """An explicit ``--precision`` (``f32`` included) wins over
    ``--mixed_precision``; the bool alone maps to ``bf16_infer``."""
    p, jp = argparse.ArgumentParser(), argparse.ArgumentParser()
    add_model_args(p)
    jax_add_model_args(jp)
    ours = model_config_from_args(p.parse_args(argv), "sintel")
    ref = jax_model_config_from_args(jp.parse_args(argv), dataset="sintel")
    assert ours.precision_policy.name == ref.precision_policy.name
    # The train configuration names the preset the model resolves to.
    train = cli_mod.train_config_from_args(cli_mod.build_train_parser().parse_args(
        ["--stage", "things", *argv]))
    assert train.precision == ours.precision_policy.name
    serve = serve_mod.build_parser().parse_args(argv + ["--serve_precision", "bf16_infer"])
    assert serve.serve_precision == "bf16_infer"
    assert serve_mod.build_parser().parse_args(argv).serve_precision is None


# ---------------------------------------------------- pyramid and lookup

@pytest.mark.parametrize("channels", [256, 128])
@pytest.mark.parametrize("maps", ["float32", "bfloat16"])
def test_prepare_levels_rounds_as_jax(channels, maps):
    g = np.random.default_rng(channels)
    f1, f2 = (g.normal(0, 3, (2, 15, 22, channels)).astype(np.float32) for _ in range(2))
    jf1, jf2 = (jnp.asarray(x).astype(maps) for x in (f1, f2))
    # corr_pallas._forward's expression: a Python float scale, which JAX
    # takes at the maps' dtype (rounded to bf16 for bf16 maps).
    ref_f1 = (jf1 * (1.0 / math.sqrt(channels))).astype(jnp.bfloat16)
    ref_levels = jax_pool_fmap_pyramid(jf2.astype(jnp.bfloat16), 4)
    tf1, tf2 = (torch.from_numpy(x).to(getattr(torch, maps)) for x in (f1, f2))
    f1s, levels = prepare_levels(tf1, tf2, 4, torch.bfloat16)
    assert f1s.dtype == torch.bfloat16 and f1s.is_contiguous()
    np.testing.assert_array_equal(_bits(f1s), _bits(ref_f1))
    assert [tuple(lv.shape) for lv in levels] == [r.shape for r in ref_levels]
    for lv, ref in zip(levels, ref_levels):
        assert lv.dtype == torch.bfloat16 and lv.is_contiguous()
        np.testing.assert_array_equal(_bits(lv), _bits(ref))


@pytest.mark.parametrize("channels,radius", [(256, 4), (128, 3)])
def test_bf16_lookup_matches_jax_pallas(channels, radius):
    g = np.random.default_rng(radius)
    b, h, w = 1, 12, 20
    f1, f2 = (g.normal(0, 3, (b, h, w, channels)).astype(np.float32) for _ in range(2))
    y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    coords = np.stack([x, y], -1)[None] + g.uniform(-6, 6, (b, h, w, 2))
    coords[0, 0, :3] += 40.0  # windows off the levels
    coords = coords.astype(np.float32)
    jf1, jf2 = (jnp.asarray(v).astype(jnp.bfloat16) for v in (f1, f2))
    ref = np.asarray(corr_lookup_pallas(jf1, jf2, jnp.asarray(coords), radius, 4, True,
                                        jnp.bfloat16))
    tf1, tf2 = (torch.from_numpy(v).to(torch.bfloat16) for v in (f1, f2))
    f1s, levels = prepare_levels(tf1, tf2, 4, torch.bfloat16)
    out = lookup_levels(f1s, levels, torch.from_numpy(coords), radius)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    err = float(np.abs(out.numpy() - ref).max())
    print(f"bf16 lookup C={channels} r={radius}: max|port-jax| {err:.3e}, "
          f"max|jax| {np.abs(ref).max():.3f}")
    assert err <= CORR_ATOL


# -------------------------------------------------------------- forward

@pytest.fixture(scope="module", params=["raft_nc_dbl", "raft"])
def forward_run(request):
    """For one variant: the JAX variables (the port's seeded weights), the
    inputs, and JAX's f32 and bf16_infer test-mode outputs."""
    variant = request.param
    port = RAFT(ModelConfig(variant=variant), device="cpu", seed=0)
    jax_f32 = JaxRAFT(JaxModelConfig(variant=variant, corr_impl="pallas"))
    jax_bf16 = JaxRAFT(JaxModelConfig(variant=variant, corr_impl="pallas",
                                      precision="bf16_infer"))
    variables = _jax_variables(jax_f32, port)
    g = np.random.default_rng(1)
    img1 = g.uniform(0, 255, (1, H, W, 3)).astype(np.float32)
    img2 = np.roll(img1, (2, 3), axis=(1, 2)).copy()
    outs = {}
    for name, model in (("f32", jax_f32), ("bf16", jax_bf16)):
        lr, up = jax.jit(lambda v, a, b, m=model: m.apply(v, a, b, iters=ITERS,
                                                           test_mode=True))(
            variables, jnp.asarray(img1), jnp.asarray(img2))
        outs[name] = (np.asarray(lr), np.asarray(up))
    return dict(variant=variant, variables=variables, img1=img1, img2=img2, **outs)


def test_bf16_forward_tracks_jax(forward_run):
    cfg = ModelConfig(variant=forward_run["variant"], corr_impl="pallas",
                      nconv_impl="pallas", precision="bf16_infer")
    model = load_jax_variables(RAFT(cfg, device="cpu"), forward_run["variables"])
    flow_lr, flow_up = model(torch.from_numpy(forward_run["img1"]),
                             torch.from_numpy(forward_run["img2"]), iters=ITERS)
    assert flow_lr.dtype == flow_up.dtype == torch.float32
    assert flow_up.shape == (1, H, W, 2)
    jax_lr, jax_up = forward_run["bf16"]
    assert jax_up.dtype == np.float32
    port_vs_jax = _epe(flow_up.numpy(), jax_up)
    bf16_vs_f32 = _epe(jax_up, forward_run["f32"][1])
    print(f"{forward_run['variant']} bf16_infer: mean EPE port-jax {port_vs_jax:.3e}, "
          f"jax bf16-f32 {bf16_vs_f32:.3e}; max|flow_up diff| port-jax "
          f"{np.abs(flow_up.numpy() - jax_up).max():.3e}, max|flow_lr diff| "
          f"{np.abs(flow_lr.numpy() - jax_lr).max():.3e}")
    assert port_vs_jax <= bf16_vs_f32
    assert max(port_vs_jax, bf16_vs_f32) <= precision.FORWARD_EPE_BUDGET


class _FloatCasts(TorchDispatchMode):
    """Records every conversion between two floating dtypes."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten._to_copy.default:
            src, dst = args[0].dtype, kwargs.get("dtype", args[0].dtype)
            if src != dst and src.is_floating_point and dst.is_floating_point:
                self.seen.add((_name(src), _name(dst)))
        return func(*args, **kwargs)


@pytest.mark.parametrize("variant", ["raft_nc_dbl", "raft"])
def test_f32_forward_adds_no_cast(variant):
    """Under f32 the module dtype is None: the forward converts no tensor
    between float dtypes. Under bf16_infer it does, both ways."""
    x = torch.from_numpy(np.random.default_rng(9).uniform(0, 255, (1, 32, 48, 3))
                         .astype(np.float32))
    seen = {}
    for preset in ("f32", "bf16_infer"):
        model = RAFT(ModelConfig(variant=variant, corr_impl="pallas", nconv_impl="pallas",
                                 precision=preset), device="cpu")
        with _FloatCasts() as casts:
            model(x, x, iters=1)
        seen[preset] = casts.seen
    assert seen["f32"] == set()
    assert seen["bf16_infer"] == {("float32", "bfloat16"), ("bfloat16", "float32")}


# ------------------------------------------------------------- training

def _batches():
    g = np.random.default_rng(5)
    out = []
    for _ in range(STEPS):
        img1 = g.uniform(0, 255, (BATCH, H, W, 3)).astype(np.float32)
        out.append({
            "image1": img1, "image2": np.roll(img1, (2, 3), axis=(1, 2)).copy(),
            "flow": g.normal(0, 2, (BATCH, H, W, 2)).astype(np.float32),
            "valid": (g.random((BATCH, H, W)) > 0.1).astype(np.float32),
        })
    return out


def _port_trajectory(preset, batches, seen=None):
    """Losses of ``STEPS`` port steps from the seed-0 weights under
    ``preset``; ``seen`` collects what the step's tensors look like."""
    cfg = TrainConfig(**TRAIN_KW, precision=preset)
    model = RAFT(ModelConfig(dataset="things", corr_impl="pallas", nconv_impl="pallas",
                             precision=preset), device="cpu", seed=0)
    state = state_for(model, cfg)
    step = make_train_step(cfg)
    if seen is not None:
        update = state.optimizer.update

        def spy(grads, grad_norm):
            seen["grads"] = {g.dtype for g in grads}
            return update(grads, grad_norm)

        state.optimizer.update = spy

        def record(module, args):
            seen["ncup"] |= {a.dtype for a in args if isinstance(a, torch.Tensor)}

        seen["ncup"] = set()
        for m in model.upsampler.modules():
            m.register_forward_pre_hook(record)
    losses = []
    for batch in batches:
        metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        losses.append(float(metrics["loss"]))
    if seen is not None:
        seen.update(state=state, metrics=metrics)
    return losses


def _jax_trajectory(batches, variables):
    cfg = JaxTrainConfig(**TRAIN_KW, precision="bf16_train")
    model = JaxRAFT(JaxModelConfig(dataset="things", corr_impl="onthefly",
                                   precision="bf16_train"))
    tx = jax_optim.build_optimizer(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), tx=tx, sentinel=jax_init_sentinel(),
    )
    step = jax_make_train_step(model, cfg)
    losses = []
    for batch in batches:
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                              jax.random.key(2))
        losses.append(float(metrics["loss"]))
    return losses


def test_bf16_train_tracks_f32_and_jax_and_keeps_f32_state():
    batches = _batches()
    seen = {}
    bf16 = _port_trajectory("bf16_train", batches, seen)
    f32 = _port_trajectory("f32", batches)
    port = RAFT(ModelConfig(dataset="things"), device="cpu", seed=0)
    variables = _jax_variables(JaxRAFT(JaxModelConfig(dataset="things")), port)
    ref = _jax_trajectory(batches, variables)
    rel_f32 = [abs(a - b) / abs(b) for a, b in zip(bf16, f32)]
    rel_jax = [abs(a - b) / abs(b) for a, b in zip(bf16, ref)]
    print(f"bf16_train losses {bf16}, f32 {f32}, jax bf16_train {ref}; relative "
          f"to f32 {max(rel_f32):.3e}, to jax {max(rel_jax):.3e}")
    assert all(np.isfinite(bf16)) and bf16[0] != bf16[1]
    assert max(rel_f32) <= precision.TRAIN_LOSS_RTOL
    assert max(rel_jax) <= precision.TRAIN_LOSS_RTOL
    state, metrics = seen["state"], seen["metrics"]
    assert state.model.fnet.conv1.dtype == torch.bfloat16
    assert int(state.sentinel["skipped"]) == 0
    assert {p.dtype for p in state.model.parameters()} == {torch.float32}
    assert seen["grads"] == {torch.float32}
    assert {t.dtype for t in state.optimizer.mu + state.optimizer.nu} == {torch.float32}
    assert metrics["loss"].dtype == metrics["grad_norm"].dtype == torch.float32
    assert {v.dtype for v in state.sentinel.values() if v.is_floating_point()} == {
        torch.float32}
    assert seen["ncup"] == {torch.float32}


def test_train_precision_names_the_model_preset(tmp_path, capsys):
    """``TrainConfig.precision`` is the preset the model runs: a train state
    refuses a model of another preset; the train entry logs and reports
    the preset it trains (``--mixed_precision`` alone gives ``bf16_infer``),
    and a resumed run keeps its checkpoint's preset and refuses flags that
    ask for another."""
    with pytest.raises(ValueError, match="must agree"):
        create_train_state(ModelConfig(), TrainConfig(precision="bf16_train"), "cpu")
    with pytest.raises(ValueError, match="must agree"):
        state_for(RAFT(ModelConfig(precision="bf16_train"), device="cpu"), TrainConfig())

    def entry(steps, *extra):
        return train_mod.main([
            "--name", "mixed", "--stage", "chairs", "--model", "raft_nc_dbl", "--synthetic_ok",
            "--num_steps", str(steps),
            "--batch_size", "1", "--image_size", str(H), str(W), "--iters", "1",
            "--sum_freq", "1", "--checkpoint_dir", str(tmp_path), "--device", "cpu",
            *extra])

    run_dir = tmp_path / "mixed"
    assert entry(1, "--mixed_precision") == 0
    assert entry(2, "--restore_ckpt", str(run_dir)) == 0
    with pytest.raises(ValueError, match="keeps its own"):
        entry(3, "--restore_ckpt", str(run_dir), "--precision", "f32")
    summaries = [json.loads(line) for line in capsys.readouterr().out.splitlines()
                 if line.startswith("{")]
    assert [(d["step"], d["precision"]) for d in summaries] == [(1, "bf16_infer"),
                                                                 (2, "bf16_infer")]
    logged = [json.loads(line) for line in (run_dir / "log.txt").read_text().splitlines()
              if line.startswith("{")]
    assert [d["precision"] for d in logged] == ["bf16_infer", "bf16_infer"]


# -------------------------------------------------------------- serving

def test_serve_precision_runs_the_same_weights_at_the_preset():
    g = np.random.default_rng(8)
    pairs = [(a, np.roll(a, (1, 2), axis=(0, 1)).copy())
             for a in (g.uniform(0, 255, (60, 90, 3)).astype(np.float32) for _ in range(2))]
    cfg = dict(batch_sizes=(1, 2), iter_levels=(2,), queue_capacity=4)
    model = RAFT(ModelConfig(corr_impl="pallas", nconv_impl="pallas"), device="cpu", seed=3)
    built = RAFT(ModelConfig(corr_impl="pallas", nconv_impl="pallas",
                             precision="bf16_infer"), device="cpu", seed=4)
    built.load_state_dict(model.state_dict(), strict=True)
    flows, reports, served = [], [], []
    for m, preset in ((model, "bf16_infer"), (built, None), (model, None)):
        with FlowServer(m, ServeConfig(**cfg, precision=preset)) as server:
            handles = [server.submit(a, b) for a, b in pairs]
            served.append(server._fwd.model_for()[0])
        flows.append([h.result(0).flow for h in handles])
        reports.append(server.report()["precision"])
    assert reports == ["bf16_infer", "bf16_infer", "f32"]
    assert served[1] is built and served[2] is model
    # The preset ran on the model's own tensors: no weight was copied.
    view = served[0]
    assert view is not model
    assert view.fnet.conv1.dtype == torch.bfloat16 and model.fnet.conv1.dtype is None
    ours, theirs = view.state_dict(), model.state_dict()
    assert list(ours) == list(theirs)
    assert all(ours[k].data_ptr() == theirs[k].data_ptr() for k in ours)
    for a, b in zip(flows[0], flows[1]):
        np.testing.assert_array_equal(a, b)
    assert max(np.abs(a - b).max() for a, b in zip(flows[0], flows[2])) > 0


# ------------------------------------------- the card's served-pair bound

PERTURB_SIZE, PERTURB_ITERS, PERTURB_REL = (128, 256), 12, 1e-6


@pytest.mark.parametrize("variant,small", [("raft_nc_dbl", False), ("raft", False),
                                           ("raft", True)],
                         ids=["raft_nc_dbl", "raft", "raft_small"])
def test_lookup_rounding_moves_a_bf16_forward_less_than_the_card_allows(
        variant, small, monkeypatch):
    """Where ``chip_smoke.BF16_PLAIN_SHARE`` comes from. On the card a served
    bf16 pair is held against the same preset's plain-version forward,
    whose lookups sum the same bf16 products in another f32 order: about
    1e-6 relative apart. Here every lookup of a ``bf16_infer`` forward at
    128x256, 12 iterations, is scaled by 1 + 1e-6 u (u uniform in [-1, 1]
    from a seed), and the mean EPE this moves the flow, as a share of the
    mean EPE between the bf16 and the f32 forward, stays within the card's
    bound. Measured: 0.177 (flagship), 0.097 (raft), 0.145 (small raft)."""
    import raft_ncup_tpu_torch.models.raft as raft_mod
    from chip_smoke import BF16_PLAIN_SHARE

    h, w = PERTURB_SIZE
    g = np.random.default_rng(1)
    img1 = torch.from_numpy(g.uniform(0, 255, (1, h, w, 3)).astype(np.float32))
    img2 = torch.roll(img1, (2, 3), dims=(1, 2))
    model = RAFT(ModelConfig(variant=variant, small=small, corr_impl="pallas",
                             nconv_impl="pallas"), device="cpu", seed=0)
    bf16 = model.with_policy("bf16_infer")
    real, gen = raft_mod.lookup_levels, torch.Generator().manual_seed(0)

    def perturbed(*args):
        out = real(*args)
        return out * (1 + PERTURB_REL * (2 * torch.rand(out.shape, generator=gen) - 1))

    with torch.no_grad():
        up_f32 = model(img1, img2, iters=PERTURB_ITERS)[1]
        up_bf16 = bf16(img1, img2, iters=PERTURB_ITERS)[1]
        monkeypatch.setattr(raft_mod, "lookup_levels", perturbed)
        up_moved = bf16(img1, img2, iters=PERTURB_ITERS)[1]
    bf16_vs_f32, moved = _epe(up_bf16, up_f32), _epe(up_moved, up_bf16)
    print(f"{variant}{' small' if small else ''}: a {PERTURB_REL} relative perturbation of "
          f"every lookup moved the bf16 forward by {moved:.4e} px mean EPE, "
          f"{moved / bf16_vs_f32:.4f} of bf16's {bf16_vs_f32:.4e} px from f32 "
          f"(bound {BF16_PLAIN_SHARE})")
    assert 0 < moved <= BF16_PLAIN_SHARE * bf16_vs_f32
