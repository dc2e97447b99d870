"""The port's resilience and the training settings of this slice against
the JAX package's, on the CPU.

- ``retry_io``: the same delays, retries and give-ups as JAX's on a fake
  clock; ``ChaosSpec``: every kind parses and renders as JAX's does.
- ``CheckpointManager``: atomic writes (a failed write leaves no file and
  is retried), ``max_to_keep``, a refused restore under another seed or
  architecture, an in-place restore.
- ``load_pretrained_trunk`` against JAX's on a ``.pth`` that JAX's
  ``save_torch_checkpoint`` wrote from a ``raft`` model, into the
  flagship: the same weights bit for bit, the upsampler at its initial
  values, a stray component raising; and from a port run directory.
- The ``freeze_raft`` update against optax's ``multi_transform``
  (``set_to_zero`` for the trunk, the clip reading the trainable norm)
  within ``test_optimizer_matches_optax``'s tolerances, the frozen
  parameters bit for bit.
- ``add_noise``'s arithmetic given JAX's draws (within ``NOISE_ATOL``,
  a few float32 steps at 255); the port's own draws' range and
  determinism.
- Channel dropout: the share of dropped channels within 5 sigma, whole
  channels, the kept values equal to flax's ``Dropout``'s; the identity
  in eval mode.
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raft_ncup_tpu.config import ModelConfig as JaxModelConfig
from raft_ncup_tpu.config import TrainConfig as JaxTrainConfig
from raft_ncup_tpu.models.raft import RAFT as JaxRAFT
from raft_ncup_tpu.resilience.chaos import ChaosSpec as JaxChaosSpec
from raft_ncup_tpu.resilience.retry import retry_io as jax_retry_io
from raft_ncup_tpu.training import optim as jax_optim
from raft_ncup_tpu.training.checkpoint import load_pretrained_trunk as jax_load_trunk
from raft_ncup_tpu.utils.torch_export import save_torch_checkpoint
from raft_ncup_tpu.utils.torch_import import import_torch_state
from raft_ncup_tpu_torch.config import ModelConfig, TrainConfig, flagship_config
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.nn.extractor import channel_dropout
from raft_ncup_tpu_torch.resilience import ChaosSpec, RetryStats, resume_metadata, retry_io
from raft_ncup_tpu_torch.training import checkpoint, optim
from raft_ncup_tpu_torch.training.checkpoint import CheckpointManager, load_pretrained_trunk
from raft_ncup_tpu_torch.training.state import state_for
from raft_ncup_tpu_torch.training.step import add_noise, noisy, step_generators
from raft_ncup_tpu_torch.utils.jax_weights import load_jax_variables

NOISE_ATOL = 1e-4
H = W = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small CPU runs launch many tiny ops, and
    with the test workers sharing the cores a parallel region per op waits
    on threads that are not scheduled (a run took 10x longer)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ----------------------------------------------------------- retry, chaos


@pytest.mark.parametrize("fail_times", [0, 2, 5])
def test_retry_io_backs_off_and_counts_as_jaxs(fail_times):
    def run(fn):
        calls, sleeps = [0], []

        def flaky():
            calls[0] += 1
            if calls[0] <= fail_times:
                raise OSError("stall")
            return "ok"

        stats = RetryStats()
        kw = dict(attempts=3, base_delay_s=0.1, max_delay_s=0.25, sleep=sleeps.append)
        if fn is retry_io:
            kw["stats"] = stats
        try:
            out = fn(flaky, **kw)
        except OSError:
            out = "raised"
        return out, calls[0], sleeps, stats

    ours, ref = run(retry_io), run(jax_retry_io)
    assert ours[:3] == ref[:3]
    stats = ours[3]
    assert stats.retries == min(fail_times, 3) and stats.giveups == int(fail_times > 3)
    assert stats.clean == (fail_times == 0)


@pytest.mark.parametrize("spec", [
    None, "", "nan@3", "nan@5,nan@6,nan@7,sigterm@3", "ioerror@0,ioerror@9",
    "burst@4,poison@15,sigterm@20", "corruptframe@4,abandon@7",
    "killreplica@1,stallreplica@2,drainreplica@3,partitionhost@4,killsupervisor@5"])
def test_chaos_spec_renders_as_jaxs(spec):
    ours, ref = ChaosSpec.parse(spec), JaxChaosSpec.parse(spec)
    assert ours.render() == ref.render() and ours.active == ref.active
    assert ChaosSpec.parse(ours.render() if ours.active else None) == ours
    with pytest.raises(ValueError):
        ChaosSpec.parse("meteor@3")


# ------------------------------------------------------------ checkpoints


def _small_state(seed=0, **kw):
    cfg = TrainConfig(stage="chairs", seed=seed)
    return state_for(RAFT(ModelConfig(variant="raft", small=True, **kw), device="cpu",
                          seed=seed), cfg), cfg


def test_checkpoint_manager_keeps_five_and_writes_atomically(tmp_path, monkeypatch):
    state, cfg = _small_state()
    mgr = CheckpointManager(str(tmp_path), metadata=resume_metadata(state.model.cfg, cfg))
    real_save, calls = torch.save, [0]

    def torn_write(obj, f, *a, **k):
        calls[0] += 1
        if calls[0] == 1:
            open(f, "wb").write(b"half a file")
            raise OSError("disk full")
        return real_save(obj, f, *a, **k)

    monkeypatch.setattr(checkpoint.torch, "save", torn_write)
    for step in range(1, 8):
        state.step = step
        mgr.save(state, cfg)
    assert mgr.retry_stats.retries == 1 and mgr.retry_stats.giveups == 0
    names = sorted(os.listdir(tmp_path))
    assert names == ["resume_meta.json"] + [f"step_{n}.pt" for n in (3, 4, 5, 6, 7)]
    assert mgr.latest_step == 7
    torch.load(mgr.path(3), weights_only=True)  # the retried file is whole


def test_checkpoint_manager_restores_in_place_and_refuses_another_run(tmp_path):
    state, cfg = _small_state(seed=1)
    mgr = CheckpointManager(str(tmp_path), metadata=resume_metadata(state.model.cfg, cfg))
    state.step = 4
    with torch.no_grad():
        state.optimizer.mu[0].fill_(0.5)
    mgr.save(state, cfg)
    saved = {k: v.clone() for k, v in state.model.state_dict().items()}
    ptrs = [p.data_ptr() for p in state.model.parameters()]
    mu0 = state.optimizer.mu[0]
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
        mu0.zero_()
    state.step = 9
    mgr.restore(state)
    assert state.step == 4 and [p.data_ptr() for p in state.model.parameters()] == ptrs
    assert state.optimizer.mu[0] is mu0 and float(mu0.flatten()[0]) == 0.5
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    # Another seed, or another architecture, is refused before any tensor moves.
    other, ocfg = _small_state(seed=2)
    with pytest.raises(ValueError, match="seed"):
        CheckpointManager(str(tmp_path), metadata=resume_metadata(other.model.cfg, ocfg)
                          ).restore(other)
    wide, wcfg = _small_state(seed=1, dropout=0.1)
    with pytest.raises(ValueError, match="config_fingerprint"):
        CheckpointManager(str(tmp_path), metadata=resume_metadata(wide.model.cfg, wcfg)
                          ).restore(wide)


# ---------------------------------------------------------- warm start


def _jax_variables(port, jax_cfg):
    template = jax.eval_shape(lambda k: JaxRAFT(jax_cfg).init(k, (1, H, W, 3)),
                              jax.random.key(0))
    return jax.tree_util.tree_map(np.array, import_torch_state(
        {k: v.numpy() for k, v in port.state_dict().items()}, template, strict=True))


@pytest.fixture(scope="module")
def raft_pth(tmp_path_factory):
    src = RAFT(ModelConfig(variant="raft"), device="cpu", seed=3)
    path = str(tmp_path_factory.mktemp("pth") / "raft-things.pth")
    save_torch_checkpoint(path, _jax_variables(src, JaxModelConfig(variant="raft")))
    return src, path


def _upsampler(model):
    return {k: v.clone() for k, v in model.state_dict().items() if k.startswith("upsampler.")}


def test_warm_start_from_a_reference_pth_matches_jax(raft_pth, tmp_path):
    src, path = raft_pth
    dest = RAFT(flagship_config(dataset="things"), device="cpu", seed=5)
    dest_vars = _jax_variables(dest, JaxModelConfig(variant="raft_nc_dbl", dataset="things"))
    merged = jax_load_trunk(path, dest_vars)
    want = load_jax_variables(RAFT(flagship_config(dataset="things"), device="cpu"), merged)
    before = _upsampler(dest)
    load_pretrained_trunk(path, dest)
    got = dest.state_dict()
    for k, v in want.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k
    for k, v in before.items():
        assert torch.equal(got[k], v), k
    for k, v in src.state_dict().items():
        if k in got and not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k
    # A stray component raises in both packages.
    state = torch.load(path, weights_only=True)
    stray = str(tmp_path / "stray.pth")
    torch.save({**state, "module.bogus.conv.weight": torch.zeros(1)}, stray)
    with pytest.raises(KeyError, match="bogus"):
        load_pretrained_trunk(stray, RAFT(flagship_config(), device="cpu"))
    with pytest.raises(KeyError):
        jax_load_trunk(stray, dest_vars)


def test_warm_start_from_a_port_run_directory(raft_pth, tmp_path):
    src, _ = raft_pth
    cfg = TrainConfig(stage="things", checkpoint_dir=str(tmp_path), name="raft")
    checkpoint.save(state_for(src, cfg), cfg)
    dest = RAFT(flagship_config(dataset="things"), device="cpu", seed=6)
    before = _upsampler(dest)
    load_pretrained_trunk(str(tmp_path / "raft"), dest)
    got = dest.state_dict()
    for k, v in src.state_dict().items():
        if k in got and not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k
    assert all(torch.equal(got[k], v) for k, v in before.items())
    payload = torch.load(checkpoint.latest(str(tmp_path / "raft")), weights_only=True)
    payload["model"]["bogus.weight"] = torch.zeros(1)
    bad = str(tmp_path / "bad" / "step_1.pt")
    os.makedirs(os.path.dirname(bad))
    torch.save(payload, bad)
    with pytest.raises(ValueError, match="bogus"):
        load_pretrained_trunk(os.path.dirname(bad), dest)


# ------------------------------------------------------------ freeze_raft


def test_freeze_raft_update_matches_optax_multi_transform():
    g = np.random.default_rng(0)
    shapes = {"fnet": {"w": (3, 4), "b": (5,)}, "upsampler": {"w": (2, 2, 3), "b": (4,)}}
    params = {top: {k: g.normal(size=s).astype(np.float32) for k, s in sub.items()}
              for top, sub in shapes.items()}
    kw = dict(lr=1e-3, num_steps=40, wdecay=5e-3, epsilon=1e-8, clip=1.0,
              optimizer="adamw", scheduler="cyclic")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tx = jax_optim.build_optimizer(JaxTrainConfig(**kw),
                                   trainable_mask=jax_optim.freeze_raft_mask(params))
    opt_state = tx.init(jp)
    names = [(top, k) for top in sorted(shapes) for k in sorted(shapes[top])]
    tp = [torch.from_numpy(params[t][k].copy()) for t, k in names]
    frozen0 = [p.clone() for (t, _), p in zip(names, tp) if t != "upsampler"]
    opt = optim.Optimizer(tp, TrainConfig(**kw), [t == "upsampler" for t, _ in names])
    # The trunk's gradients are large: the whole norm is above the clip in
    # every step, the trainable norm above it in the second only.
    for scale in (0.05, 3.0, 0.2):
        grads = {top: {k: (g.normal(size=s) * (10.0 if top == "fnet" else scale)
                           ).astype(np.float32) for k, s in sub.items()}
                 for top, sub in shapes.items()}
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        tg = [torch.from_numpy(grads[t][k]) for t, k in names]
        opt.commit(*opt.update(tg, opt.clip_norm(tg)), keep_old=torch.tensor(False))
        for (t, k), p in zip(names, tp):
            np.testing.assert_allclose(p.numpy(), np.asarray(jp[t][k]), rtol=1e-6, atol=1e-7)
    assert all(torch.equal(a, b) for a, b in zip(
        [p for (t, _), p in zip(names, tp) if t != "upsampler"], frozen0))
    assert len(opt.mu) == 2 and int(opt.count) == 3


def test_freeze_raft_state_trains_the_upsampler_only():
    state, _ = _small_state()
    assert len(state.optimizer.params) == len(list(state.model.parameters()))
    cfg = TrainConfig(stage="things")
    frozen = state_for(RAFT(flagship_config(dataset="things", freeze_raft=True, small=True),
                            device="cpu"), cfg)
    names = [n for n, _ in frozen.model.named_parameters()]
    want = [p for n, p in frozen.model.named_parameters() if n.startswith("upsampler.")]
    assert 0 < len(want) < len(names)
    assert all(a is b for a, b in zip(frozen.optimizer.params, want))


# ----------------------------------------------------------- noise, dropout


def test_add_noise_arithmetic_given_jaxs_draws():
    g = np.random.default_rng(0)
    img = g.uniform(0, 255, (2, 16, 24, 3)).astype(np.float32)
    img[0, 0, :4, 0] = (0.0, 255.0, 1.0, 254.0)  # clamped at both ends
    kstd, k1, _ = jax.random.split(jax.random.PRNGKey(7), 3)
    stdv = jax.random.uniform(kstd, (), maxval=5.0)
    n1 = jax.random.normal(k1, img.shape)
    want = np.asarray(jnp.clip(jnp.asarray(img) + stdv * n1, 0.0, 255.0))
    got = noisy(torch.from_numpy(img), torch.tensor(np.asarray(stdv)),
                torch.from_numpy(np.array(n1))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=NOISE_ATOL)
    # The port's own draws: a stddev in [0, 5), the range kept, the same
    # draws for the same (seed, step), others for the next step.
    t = torch.from_numpy(img)
    a = add_noise(t, t, step_generators(1234, 3, "cpu")[0])
    b = add_noise(t, t, step_generators(1234, 3, "cpu")[0])
    c = add_noise(t, t, step_generators(1234, 4, "cpu")[0])
    assert all(torch.equal(x, y) for x, y in zip(a, b)) and not torch.equal(a[0], c[0])
    assert 0.0 <= float(a[0].min()) and float(a[0].max()) <= 255.0
    assert 0.0 < float((a[0] - t).std()) < 5.0 and not torch.equal(a[0], a[1])


def test_channel_dropout_statistics_and_eval_identity():
    rate = 0.25
    x = torch.ones(64, 256, 4, 4)
    y = channel_dropout(x, rate, torch.Generator().manual_seed(0))
    per_channel = y.flatten(2)
    assert torch.equal(per_channel.amin(-1), per_channel.amax(-1))  # whole channels
    dropped = float((per_channel[..., 0] == 0).float().mean())
    sigma = (rate * (1 - rate) / (64 * 256)) ** 0.5
    assert abs(dropped - rate) < 5 * sigma
    flax_out = np.asarray(fnn.Dropout(rate, broadcast_dims=(1, 2), deterministic=False).apply(
        {}, jnp.ones((64, 4, 4, 256)), rngs={"dropout": jax.random.PRNGKey(0)}))
    kept = np.unique(per_channel[per_channel != 0].numpy())
    assert kept.tolist() == np.unique(flax_out[flax_out != 0]).tolist()
    assert abs(float((flax_out[:, 0, 0] == 0).mean()) - rate) < 5 * sigma
    # Eval mode: no dropout, the encoders of a model without it.
    g = np.random.default_rng(1)
    x = torch.from_numpy(g.uniform(-1, 1, (2, 3, H, W)).astype(np.float32))
    with_drop = RAFT(ModelConfig(variant="raft", small=True, dropout=rate), device="cpu", seed=4)
    plain = RAFT(ModelConfig(variant="raft", small=True), device="cpu", seed=4)
    gen = torch.Generator().manual_seed(0)
    for enc in ("fnet", "cnet"):
        assert torch.equal(getattr(with_drop, enc)(x, gen), getattr(plain, enc)(x))
    with_drop.train()
    dropped = with_drop.fnet(x, gen).flatten(2).abs().amax(-1) == 0
    assert 0 < float(dropped.float().mean()) < 0.6
