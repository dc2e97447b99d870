"""The port's training against the JAX package's, on the CPU.

- One whole train step of the flagship at 64x64, batch 2, 2 iterations,
  against JAX ``make_train_step``: the loss, every gradient by name, and
  the BatchNorm statistics after the step, for stage ``things``
  (BatchNorm frozen) and for stage ``chairs`` (BatchNorm trains) with the
  Sintel upsampler, whose weights net has BatchNorm inside the
  checkpointed iteration. JAX's gradients come out of ``make_train_step``
  itself: its optimizer is swapped for a transform that stores the
  gradients as its state and updates nothing. The JAX model looks up
  correlations with ``corr_impl="onthefly"``, the function whose VJP the
  Pallas op's backward takes (``tests/test_torch_grad.py`` holds the
  port's lookup against the Pallas op itself); the port runs both
  kernels' functions (their plain versions on the CPU).
- The optimizer fed the same gradients as optax, stepped 3 times; the
  schedules at several counts.
- The divergence sentinel on a NaN batch; an interrupted and resumed run
  of the train entry point against an uninterrupted one; BatchNorm's
  running variance against flax's.

Tolerances: the loss within 1e-5 relative; every gradient within 1e-3 of
its own largest magnitude (the same f32 model computed in another order
through 2 iterations and their backward); BatchNorm statistics within
1e-5; optimizer states within 1e-6 relative (the same elementwise
formulas). Three kinds of gradient take another check, each for a stated
reason (ROADMAP.md's queue 3 records the two looser bounds):

- The bias of a convolution whose output a normalization over the same
  channels centres (instance norm; batch norm while it trains) has a
  gradient of exactly zero: both sides return rounding noise, so the
  port's must stay below ``NEGLIGIBLE`` of the step's largest gradient,
  as must any gradient that JAX puts there.
- Two tensors of the feature encoder's stem (``FLIPPED``), within
  ``FLIP_TOL``: a ReLU whose input lies within a few 1e-6 of zero can
  round to opposite sides in two float32 computations, and its pixel's
  share of the weight gradients below it then differs; behind instance
  norm those gradients are small differences of large terms, so one
  pixel shows. With these seeded weights and this batch the port's
  float32 flips against JAX's there (4.3e-3 and 4.5e-2 of the largest
  value) and nowhere else. So every parameter of both encoders is also
  held against JAX within 1e-3 through a float64 replay of the port's
  own encoder, from the input and the output gradient it saw in the step
  (the replay agrees with JAX within 4e-6 on these two).
- The NConv U-Net's weights (``NCUP_WEIGHTS``), within ``NCUP_TOL``: at
  initialization every NConv layer holds weights near 2, so its output
  channels carry nearly the same data and each weight's gradient is a
  difference of nearly equal terms (measured up to 1.0e-2 for
  ``nconv_out``, whose two input channels differ least).
"""

import copy
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raft_ncup_tpu.config import TrainConfig as JaxTrainConfig
from raft_ncup_tpu.config import flagship_config as jax_flagship_config
from raft_ncup_tpu.models.raft import RAFT as JaxRAFT
from raft_ncup_tpu.parallel.step import make_train_step as jax_make_train_step
from raft_ncup_tpu.resilience.anomaly import init_sentinel as jax_init_sentinel
from raft_ncup_tpu.training import optim as jax_optim
from raft_ncup_tpu.training.state import TrainState as JaxTrainState
from raft_ncup_tpu.utils.torch_import import import_torch_state
from raft_ncup_tpu_torch import train as train_entry
from raft_ncup_tpu_torch.config import TrainConfig, flagship_config
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.nn.layers import BatchNorm2d
from raft_ncup_tpu_torch.data.synthetic import SyntheticFlowDataset
from raft_ncup_tpu_torch.training import checkpoint, optim
from raft_ncup_tpu_torch.training.state import create_train_state, state_for
from raft_ncup_tpu_torch.training.step import loss_and_grads, make_train_step
from raft_ncup_tpu_torch.utils.jax_weights import carry_state_dict, load_jax_variables

H = W = 64
BATCH, ITERS = 2, 2
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-3
STATS_TOL = 1e-5
NEGLIGIBLE = 1e-6  # of the step's largest gradient
ENCODERS = ("fnet", "cnet")
FLIPPED = ("fnet.conv1.weight", "fnet.layer1.0.conv1.weight")
FLIP_TOL = 1e-1
NCUP_WEIGHTS = "upsampler.interpolation_net."
NCUP_TOL = 5e-2


def _zero_by_structure(name, dataset, stage):
    """Whether the bias ``name`` feeds a normalization that centres each
    of its channels in this step, so its gradient is exactly zero."""
    if not name.endswith(".bias") or name in ("fnet.conv2.bias", "cnet.conv2.bias"):
        return False
    conv = name.rsplit(".", 2)[-2].startswith("conv") or name.endswith("downsample.0.bias")
    if name.startswith("fnet."):  # instance norm
        return conv
    bn_trains = stage == "chairs"
    if name.startswith("cnet."):
        return conv and bn_trains
    return (bn_trains and dataset == "sintel"
            and name.startswith("upsampler.weights_est_net.conv.") and name.endswith(".0.bias"))


def _batch(seed):
    g = np.random.default_rng(seed)
    img1 = g.uniform(0, 255, (BATCH, H, W, 3)).astype(np.float32)
    return {
        "image1": img1,
        "image2": np.roll(img1, (2, 3), axis=(1, 2)).copy(),
        "flow": g.normal(0, 2, (BATCH, H, W, 2)).astype(np.float32),
        "valid": (g.random((BATCH, H, W)) > 0.1).astype(np.float32),
    }


def _perturb_batch_stats(tree, g):
    for key in sorted(tree):
        v = tree[key]
        if isinstance(v, dict):
            _perturb_batch_stats(v, g)
        elif key == "mean":
            tree[key] = g.normal(0.0, 0.2, v.shape).astype(np.float32)
        elif key == "var":
            tree[key] = g.uniform(0.5, 1.5, v.shape).astype(np.float32)


def _grad_capture():
    """An optax transform whose state becomes the gradients it is given
    and whose updates are zero."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, grads), grads),
    )


def _jax_step(dataset, stage, batch):
    """JAX ``make_train_step`` once on perturbed variables: (variables as
    numpy, loss, gradients, the BatchNorm statistics after the step)."""
    model = JaxRAFT(jax_flagship_config(dataset=dataset, corr_impl="onthefly"))
    # The variables are the port's seeded weights, imported into the tree
    # that init would make (its shapes only: no init is run).
    template = jax.eval_shape(lambda k: model.init(k, (1, H, W, 3)), jax.random.key(0))
    port = RAFT(flagship_config(dataset=dataset), device="cpu", seed=0)
    variables = import_torch_state(
        {k: v.numpy() for k, v in port.state_dict().items()}, template, strict=True)
    variables = jax.tree_util.tree_map(np.array, variables)
    _perturb_batch_stats(variables["batch_stats"], np.random.default_rng(1))
    tx = _grad_capture()
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), tx=tx, sentinel=jax_init_sentinel(),
    )
    cfg = JaxTrainConfig(stage=stage, iters=ITERS, batch_size=BATCH, image_size=(H, W))
    step = jax_make_train_step(model, cfg)
    new_state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                              jax.random.key(2))
    return dict(
        variables=variables, loss=float(metrics["loss"]),
        grads=jax.tree_util.tree_map(np.array, new_state.opt_state),
        batch_stats=jax.tree_util.tree_map(np.array, new_state.batch_stats),
        bad_step=float(metrics["bad_step"]),
    )


class _EncoderReplay:
    """Float64 copies of both encoders as they stand before the step, and
    hooks that keep each encoder's input and the gradient of its output
    in the step; :meth:`grads` recomputes every encoder parameter's
    gradient in float64 from them."""

    def __init__(self, model):
        self.copies = {n: copy.deepcopy(getattr(model, n)).double() for n in ENCODERS}
        self.inputs, self.out_grads = {}, {}
        self.hooks = [getattr(model, n).register_forward_hook(self._capture(n))
                      for n in ENCODERS]

    def _capture(self, name):
        def hook(module, args, out):
            self.inputs[name] = args[0].detach()
            out.register_hook(lambda g: self.out_grads.__setitem__(name, g.detach()))
        return hook

    def grads(self, frozen_bn):
        for h in self.hooks:
            h.remove()
        out = {}
        for name, enc in self.copies.items():
            enc.train()
            for m in enc.modules():
                if frozen_bn and isinstance(m, torch.nn.BatchNorm2d):
                    m.eval()
            params = list(enc.named_parameters())
            y = enc(self.inputs[name].double())
            gs = torch.autograd.grad(y, [p for _, p in params], self.out_grads[name].double())
            out.update({f"{name}.{n}": g for (n, _), g in zip(params, gs)})
        return out


def _port_step(dataset, stage, variables, batch, remat=True):
    """The port's ``make_train_step`` once from the same variables: (loss,
    gradients by name, the encoders' gradients by name from their float64
    replay, the model after the step, the metrics)."""
    model = RAFT(flagship_config(dataset=dataset, corr_impl="pallas", nconv_impl="pallas"),
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
    metrics = make_train_step(cfg, remat=remat)(state, {k: torch.from_numpy(v) for k, v in
                                                       batch.items()})
    grads = {name: g for (name, _), g in zip(state.named_params, seen[0])}
    return float(metrics["loss"]), grads, replay.grads(cfg.freeze_bn), model, metrics


@pytest.mark.parametrize(
    "dataset,stage",
    [("things", "things"), ("sintel", "chairs")],
    ids=["things_bn_frozen", "chairs_bn_trains_in_the_upsampler"],
)
def test_train_step_matches_jax(dataset, stage):
    batch = _batch(3)
    ref = _jax_step(dataset, stage, batch)
    loss, grads, replayed, model, metrics = _port_step(dataset, stage, ref["variables"], batch)

    assert ref["bad_step"] == 0.0 and float(metrics["bad_step"]) == 0.0
    assert math.isfinite(loss)
    assert abs(loss - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"]), (loss, ref["loss"])

    ref_grads = carry_state_dict({"params": ref["grads"]})
    assert set(grads) == set(ref_grads)
    gmax = max(float(r.abs().max()) for r in ref_grads.values())
    for name, g in grads.items():
        r = ref_grads[name]
        scale = float(r.abs().max())
        if _zero_by_structure(name, dataset, stage) or scale < NEGLIGIBLE * gmax:
            assert scale < NEGLIGIBLE * gmax, f"{name}: JAX {scale} of {gmax}"
            assert float(g.abs().max()) < NEGLIGIBLE * gmax, f"{name}: {g.abs().max()}"
            continue
        if name.startswith(ENCODERS):
            err = float((replayed[name] - r.double()).abs().max())
            assert err <= GRAD_TOL * scale, f"{name} (float64 replay): {err} vs max {scale}"
        tol = (FLIP_TOL if name in FLIPPED
               else NCUP_TOL if name.startswith(NCUP_WEIGHTS) else GRAD_TOL)
        err = float((g - r).abs().max())
        assert err <= tol * scale, f"{name}: {err} vs max {scale}"

    ref_stats = carry_state_dict({"batch_stats": ref["batch_stats"]})
    before = carry_state_dict({"batch_stats": ref["variables"]["batch_stats"]})
    buffers = dict(model.named_buffers())
    for name, r in ref_stats.items():
        if name.endswith("num_batches_tracked"):
            continue
        torch.testing.assert_close(buffers[name], r, rtol=0, atol=STATS_TOL)
        moved = not torch.equal(r, before[name])
        assert moved == (stage == "chairs"), name  # BN trains in chairs only
    if stage == "chairs":
        # Under remat each iteration updates the upsampler's BatchNorm
        # once, as the JAX scan carry does; the recompute does not.
        ups = model.upsampler.weights_est_net.conv[0][1]
        assert isinstance(ups, BatchNorm2d)
        assert int(ups.num_batches_tracked) == ITERS
        assert int(model.cnet.norm1.num_batches_tracked) == 1


def test_remat_changes_neither_gradients_nor_statistics():
    """The same step without ``torch.utils.checkpoint``: the same
    gradients and BatchNorm statistics (the recompute only replays the
    forward)."""
    model = RAFT(flagship_config(dataset="sintel", corr_impl="pallas", nconv_impl="pallas"),
                 device="cpu", seed=4)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    batch = {k: torch.from_numpy(v[:1]) for k, v in _batch(5).items()}
    cfg = TrainConfig(stage="chairs", iters=ITERS, batch_size=1, image_size=(H, W))
    out = []
    for remat in (True, False):
        model.load_state_dict(state)
        ts = state_for(model, cfg)
        loss, _, grads = loss_and_grads(ts, batch, cfg, remat=remat)
        out.append((loss, grads, {k: v.clone() for k, v in model.named_buffers()}))
    (l1, g1, b1), (l2, g2, b2) = out
    assert torch.equal(l1, l2)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max()))
    for k in b1:
        torch.testing.assert_close(b1[k], b2[k], rtol=0, atol=0)


def test_backward_and_recompute_keep_tf32_off(monkeypatch):
    """The backward's convolutions, and the forward that remat runs again
    inside it, see TF32 off like the model's forward (and cuDNN's
    autotuner on), whatever the caller's flags; the caller's flags come
    back afterwards."""
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    model = RAFT(flagship_config(dataset="things", corr_impl="pallas", nconv_impl="pallas"),
                 device="cpu", seed=1)
    cfg = TrainConfig(stage="things", iters=1, batch_size=1, image_size=(H, W))
    seen = []

    def flags(*_):
        seen.append((torch.is_grad_enabled(), torch.backends.cudnn.benchmark,
                     torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))

    model.update_block.register_forward_pre_hook(flags)  # forward, then recompute
    model.fnet.conv1.weight.register_hook(flags)  # the backward
    batch = {k: torch.from_numpy(v[:1]) for k, v in _batch(6).items()}
    loss_and_grads(state_for(model, cfg), batch, cfg)
    assert [grad for grad, *_ in seen] == [True, True, False]  # forward, recompute, backward
    assert all(flags == [True, False, False] for _, *flags in seen), seen
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.benchmark


# ---------------------------------------------------------------- optimizer

@pytest.mark.parametrize(
    "optimizer,scheduler", [("adamw", "cyclic"), ("adam", "step")],
)
def test_optimizer_matches_optax(optimizer, scheduler):
    """Three updates from the same gradients; the second's global norm is
    above the clip, the others below it."""
    g = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    params = {k: g.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = []
    for scale in (0.05, 3.0, 0.2):
        grads.append({k: (g.normal(size=s) * scale).astype(np.float32)
                      for k, s in shapes.items()})
    kw = dict(lr=1e-3, num_steps=40, wdecay=5e-3, epsilon=1e-8, clip=1.0,
              optimizer=optimizer, scheduler=scheduler, scheduler_step=2)
    tx = jax_optim.build_optimizer(JaxTrainConfig(**kw))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)

    names = sorted(shapes)
    tp = [torch.from_numpy(params[k].copy()) for k in names]
    opt = optim.Optimizer(tp, TrainConfig(**kw))
    for step_grads in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in step_grads.items()},
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        tg = [torch.from_numpy(step_grads[k]) for k in names]
        opt.commit(*opt.update(tg, optim.global_norm(tg)), keep_old=torch.tensor(False))
        adam = opt_state[1][0]
        for i, k in enumerate(names):
            np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(opt.mu[i].numpy(), np.asarray(adam.mu[k]),
                                       rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(opt.nu[i].numpy(), np.asarray(adam.nu[k]),
                                       rtol=1e-6, atol=1e-12)
        assert int(opt.count) == int(adam.count)


@pytest.mark.parametrize("counts", [[0, 1, 2, 3, 4, 5, 6, 50, 500, 1098, 1099, 1500]])
def test_schedules_match_jax(counts):
    c = torch.tensor(counts, dtype=torch.int32)
    ours = optim.onecycle_linear(1.25e-4, 1100, pct_start=0.05)(c)
    ref = jax_optim.onecycle_linear(1.25e-4, 1100, pct_start=0.05)(jnp.asarray(counts))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=0)
    ours = optim.step_lr(2e-5, 100, 0.5)(c)
    ref = jax_optim.step_lr(2e-5, 100, 0.5)(jnp.asarray(counts))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=0)
    # The step reads the schedule at the count before its update.
    cfg = TrainConfig(lr=1.25e-4, num_steps=1000)
    opt = optim.Optimizer([torch.zeros(2)], cfg)
    assert float(opt.lr()) == pytest.approx(1.25e-4 / 25, rel=1e-6)


# ----------------------------------------------------- sentinel and resume

def _small_state(stage="chairs", seed=0):
    cfg = TrainConfig(stage=stage, iters=1, batch_size=1, image_size=(H, W), num_steps=10)
    model = RAFT(flagship_config(dataset="sintel", corr_impl="pallas", nconv_impl="pallas"),
                 device="cpu", seed=seed)
    return cfg, state_for(model, cfg)


def test_nan_batch_leaves_the_state_unchanged():
    cfg, state = _small_state()
    step = make_train_step(cfg)
    good = {k: torch.from_numpy(v[:1]) for k, v in _batch(7).items()}
    step(state, good)
    before = (
        {k: v.clone() for k, v in state.model.state_dict().items()},
        [t.clone() for t in state.optimizer.mu + state.optimizer.nu],
        state.optimizer.count.clone(),
    )
    bad = dict(good, image1=torch.full_like(good["image1"], float("nan")))
    metrics = step(state, bad)
    assert float(metrics["bad_step"]) == 1.0
    assert state.step == 2  # the attempt still counts
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[0][k]), k  # parameters and BN statistics
    for a, b in zip(state.optimizer.mu + state.optimizer.nu, before[1]):
        assert torch.equal(a, b)
    assert torch.equal(state.optimizer.count, before[2])
    assert int(state.sentinel["skipped"]) == 1 and int(state.sentinel["consecutive"]) == 1
    metrics = step(state, good)  # and the next good step goes through
    assert float(metrics["bad_step"]) == 0.0 and int(state.sentinel["consecutive"]) == 0


def _entry_args(tmp, name, steps, *extra):
    return ["--name", name, "--stage", "chairs", "--model", "raft_nc_dbl", "--synthetic_ok",
            "--num_steps", str(steps), "--batch_size", "1", "--image_size", str(H), str(W),
            "--iters", "1", "--sum_freq", "2", "--lr", "1e-4", "--checkpoint_dir", str(tmp),
            "--device", "cpu", *extra]


def test_train_entry_runs_and_resumes(tmp_path, capsys):
    """``python -m raft_ncup_tpu_torch.train --device cpu``: 2 steps, a
    checkpoint and the log; then a run restored from its directory that
    continues to step 3."""
    assert train_entry.main(_entry_args(tmp_path, "run", 2)) == 0
    run_dir = tmp_path / "run"
    assert (run_dir / "step_2.pt").exists() and (run_dir / "log.txt").exists()
    assert train_entry.main(_entry_args(tmp_path, "run", 3, "--restore_ckpt", str(run_dir))) == 0
    out = capsys.readouterr().out
    assert '"steps": 2, "step": 2' in out and '"steps": 1, "step": 3' in out
    assert "[     2 lr" in out  # the logger's summary every --sum_freq steps
    assert torch.load(run_dir / "step_3.pt", weights_only=True)["step"] == 3


def test_resumed_run_equals_an_uninterrupted_one(tmp_path):
    """4 steps in one run, against 2 steps, a checkpoint, and a run
    restored from it to 4 (the same configuration, so the same schedule):
    parameters, BatchNorm statistics, moments, count and sentinel equal
    bit for bit."""
    cfg = TrainConfig(stage="chairs", iters=1, batch_size=1, image_size=(H, W), num_steps=4,
                      lr=1e-4, checkpoint_dir=str(tmp_path))
    data = SyntheticFlowDataset(cfg.image_size, seed=cfg.seed)
    step = make_train_step(cfg)
    model_cfg = flagship_config(dataset="chairs", corr_impl="pallas", nconv_impl="pallas")

    def run(state, until):
        while state.step < until:
            step(state, data.batch(state.step, cfg.batch_size))
        return state

    whole = run(create_train_state(model_cfg, cfg, "cpu"), 4)
    path = checkpoint.save(run(create_train_state(model_cfg, cfg, "cpu"), 2), cfg)
    split = run(checkpoint.restore(path, cfg, "cpu"), 4)
    assert whole.step == split.step == 4
    for k, v in whole.model.state_dict().items():
        assert torch.equal(v, split.model.state_dict()[k]), k
    for a, b in zip(whole.optimizer.mu + whole.optimizer.nu,
                    split.optimizer.mu + split.optimizer.nu):
        assert torch.equal(a, b)
    assert torch.equal(whole.optimizer.count, split.optimizer.count)
    for k in whole.sentinel:
        assert torch.equal(whole.sentinel[k], split.sentinel[k])


def test_checkpoint_round_trip_keeps_the_configuration(tmp_path):
    cfg, state = _small_state(stage="things", seed=3)
    path = checkpoint.save(state, dataclasses.replace(cfg, checkpoint_dir=str(tmp_path)))
    back = checkpoint.restore(path, cfg, "cpu")
    assert back.model.cfg == state.model.cfg and back.step == state.step
    for k, v in state.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], v)


def test_train_entry_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _entry_args(tmp_path, "nocard", 1)[:-2]  # no --device
    with pytest.raises(RuntimeError):
        train_entry.main(args)


def test_batchnorm_running_variance_is_flax_s():
    """flax updates the running variance with the biased batch variance;
    torch's BatchNorm2d would use the unbiased one (0.98770 here)."""
    import flax.linen as fnn

    x = np.random.default_rng(0).normal(size=(1, 4, 3, 2)).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = bn.init(jax.random.key(0), jnp.asarray(x))
    y, mut = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    port = BatchNorm2d(2).train()
    out = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]), rtol=1e-6)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y),
                               atol=1e-5)
    assert port.running_var[0].item() == pytest.approx(0.98038, abs=1e-5)
