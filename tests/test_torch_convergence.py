"""The convergence run and the NCUP-against-bilinear twin of the port
(``raft_ncup_tpu_torch/synth_convergence.py``,
``raft_ncup_tpu_torch/ncup_vs_bilinear.py``) against the JAX package's
scripts (``scripts/synth_convergence.sh``, ``scripts/ncup_vs_bilinear.py``,
loaded by file path), on the CPU with one torch thread.

- ``bootstrap_ci`` equals JAX's on several inputs, the empty-input error
  included.
- The train flags: for each twin the port's ``parse_train`` of its
  ``train_argv`` equals JAX's of its own, field by field over the fields
  both configurations and both namespaces have; only the device and the
  platform differ, and the lookup and NConv implementations, which the
  port's CLI fixes to its kernels (``raft_ncup_tpu_torch/cli.py``). The
  convergence recipe's flags are the shell script's.
- A tiny run of the twin script (trunk 2 steps, NCUP 2 steps, one eval
  seed of 4 pairs) writes a record with JAX's keys; the bilinear and the
  NCUP twins carry the trunk bit for bit; a second call trains nothing.
- Ten steps of the convergence recipe (small ``raft``, AdamW with
  OneCycle, lr 4e-4, weight decay 1e-5, batch 2, 4 iterations, at 64x64)
  from JAX's initialisation carried across, fed the same batches, against
  JAX's trainer: the learning rate equal at every step, the loss within
  ``LOSS_RTOL`` at every step.
"""

import argparse
import functools
import importlib.util
import json
import os
import shlex

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_ncup_tpu.cli import parse_train as jax_parse_train
from raft_ncup_tpu.config import TrainConfig as JaxTrainConfig
from raft_ncup_tpu.config import small_model_config as jax_small_model_config
from raft_ncup_tpu.parallel.step import make_train_step as jax_make_train_step
from raft_ncup_tpu.training.optim import build_schedule as jax_build_schedule
from raft_ncup_tpu.training.state import create_train_state as jax_create_train_state
from raft_ncup_tpu_torch import cli
from raft_ncup_tpu_torch import ncup_vs_bilinear, synth_convergence
from raft_ncup_tpu_torch import train as train_entry
from raft_ncup_tpu_torch.config import TrainConfig, small_model_config
from raft_ncup_tpu_torch.data.synthetic import SyntheticFlowDataset
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.training.checkpoint import load_model_weights
from raft_ncup_tpu_torch.training.state import state_for
from raft_ncup_tpu_torch.training.step import make_train_step
from raft_ncup_tpu_torch.utils.jax_weights import load_jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The loss over ten steps from the same weights and batches: the two
# float32 models differ by rounding at the first step (1e-5, as
# tests/test_torch_train.py holds one step), and AdamW's updates carry it
# on; measured at most 1.2e-5 relative over the ten steps.
LOSS_RTOL = 1e-4
STEPS, H, W = 10, 64, 64


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_ncup_vs_bilinear", os.path.join(REPO, "scripts", "ncup_vs_bilinear.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- (a) CI


@pytest.mark.parametrize("values,seed", [
    ([0.091], 0), ([0.1, 0.2, -0.05], 1234), ([0.091, 0.118, 0.05, 0.2], 4321),
    (list(np.linspace(-1, 1, 17)), 7)])
def test_bootstrap_ci_equals_jaxs(values, seed):
    theirs = _jax_script().bootstrap_ci(values, seed=seed)
    ours = ncup_vs_bilinear.bootstrap_ci(values, seed=seed)
    assert ours == theirs


def test_bootstrap_ci_refuses_no_values_as_jax_does():
    with pytest.raises(ValueError, match="at least one value"):
        _jax_script().bootstrap_ci([])
    with pytest.raises(ValueError, match="at least one value"):
        ncup_vs_bilinear.bootstrap_ci([])


# ------------------------------------------------------------ (b) flags


def _shared_fields(ours, theirs):
    a = ours if isinstance(ours, dict) else vars(ours) if isinstance(
        ours, argparse.Namespace) else {f: getattr(ours, f) for f in ours.__dataclass_fields__}
    b = theirs if isinstance(theirs, dict) else vars(theirs) if isinstance(
        theirs, argparse.Namespace) else {f: getattr(theirs, f)
                                          for f in theirs.__dataclass_fields__}
    return {k: (a[k], b[k]) for k in sorted(set(a) & set(b))}


def _assert_same_parse(ours, theirs):
    (a_args, *a_cfgs), (b_args, *b_cfgs) = ours, theirs
    pairs = [_shared_fields(a_args, b_args)] + [
        _shared_fields(x, y) for x, y in zip(a_cfgs, b_cfgs)]
    for fields in pairs:
        assert len(fields) > 3
        for k, (x, y) in fields.items():
            if k in ("device", "platform", "corr_impl", "nconv_impl"):
                continue
            if k == "chairs_split_file":  # each package's own copy of the split
                x, y = os.path.basename(x), os.path.basename(y)
            if k == "data_parallel":  # None: every device, which the port resolves at parse
                x, y = (1 if v is None else v for v in (x, y))
            x = dataclasses_as_dict(x)
            y = dataclasses_as_dict(y)
            assert x == y, (k, x, y)


def dataclasses_as_dict(v):
    if hasattr(v, "__dataclass_fields__"):
        return {f: dataclasses_as_dict(getattr(v, f)) for f in v.__dataclass_fields__}
    return list(v) if isinstance(v, tuple) else v


@pytest.mark.parametrize("twin", ["trunk", "ncup", "bilinear"])
def test_twin_flags_parse_as_jaxs(twin):
    names = dict(trunk_steps=4000, ncup_steps=2000, seed=4321, ckpt_dir="/ck",
                 trunk_name="rigid_trunk", ncup_name="rigid_ncup")
    ours = ncup_vs_bilinear.train_argv(argparse.Namespace(device="cpu", **names), twin)
    theirs = _jax_script().train_argv(argparse.Namespace(**names), twin)
    assert ours[ours.index("--device") + 1] == "cpu"
    assert [a for a in ours if a not in ("--device",)] != theirs  # --platform is JAX's
    _assert_same_parse(cli.parse_train(ours), jax_parse_train(theirs))


def test_convergence_flags_are_the_shell_scripts():
    text = open(os.path.join(REPO, "scripts", "synth_convergence.sh")).read()
    line = text[text.index("python train.py"):].replace("\\\n", " ").splitlines()[0]
    theirs = shlex.split(line)[2:]
    ours = synth_convergence.train_argv("synth_r4", "checkpoints", "cpu")
    assert ours[ours.index("--checkpoint_dir") + 1] == "checkpoints"

    def pairs(argv, drop):
        out, i = {}, 0
        while i < len(argv):
            key = argv[i]
            vals = []
            i += 1
            while i < len(argv) and not argv[i].startswith("--"):
                vals.append(argv[i])
                i += 1
            if key not in drop:
                out[key] = vals
        return out

    assert pairs(ours, ("--device", "--checkpoint_dir")) == pairs(theirs, ("--platform",))
    _assert_same_parse(cli.parse_train(ours), jax_parse_train(theirs))


# ------------------------------------------------------- (c) the twin run


def _small_validators(monkeypatch):
    """The train entry's synthetic validators at 4 pairs and 2 iterations:
    the runs here check the scripts' flow, not the numbers."""
    for name in ("synthetic", "synthetic_rigid"):
        monkeypatch.setitem(train_entry.VALIDATORS, name, functools.partial(
            train_entry.VALIDATORS[name], length=4, iters=2))


def _in_process(calls):
    """``synth_convergence.run_train`` in this process (``train.main``),
    recording each call."""

    def run(argv, resume_dir=None):
        argv = list(argv) + (["--restore_ckpt", resume_dir] if resume_dir else [])
        calls.append(argv)
        assert train_entry.main(argv + ["--num_workers", "1"]) == 0
        return {"steps": 2, "median_iteration_ms": None, "wall_seconds": 0.0}

    return run


def test_tiny_twin_run_writes_jaxs_record_and_resumes(tmp_path, monkeypatch):
    calls = []
    _small_validators(monkeypatch)
    monkeypatch.setattr(synth_convergence, "run_train", _in_process(calls))
    monkeypatch.setattr(ncup_vs_bilinear, "REPO", str(tmp_path))
    argv = ["--device", "cpu", "--trunk_steps", "2", "--ncup_steps", "2", "--eval_seeds", "999",
            "--val_length", "4", "--ckpt_dir", "ck", "--out", "rec.json"]
    assert ncup_vs_bilinear.main(argv) == 0
    assert [c[c.index("--name") + 1] for c in calls] == ["torch_rigid_trunk",
                                                        "torch_rigid_ncup"]
    record = json.load(open(tmp_path / "rec.json"))
    jax_keys = {"experiment", "trunk", "ncup_steps", "seed", "eval", "results",
                "results_per_seed", "bilinear_minus_ncup", "bilinear_minus_ncup_per_seed",
                "bootstrap_ci"}
    assert jax_keys <= set(record)
    assert set(record["results"]) == {"bilinear", "ncup"}
    assert set(record["bootstrap_ci"]) == {"delta", "delta_bnd", "delta_interior"}
    assert record["eval"]["length"] == 4 and record["eval"]["seeds"] == [999]
    assert record["device"]["device"] == "cpu" and record["device"]["torch"]
    # The twins carry the trained trunk bit for bit: the frozen trunk's
    # updates in the NCUP run are exactly zero.
    a = ncup_vs_bilinear.build_parser().parse_args(argv)
    a.ckpt_dir = str(tmp_path / "ck")
    bilinear = ncup_vs_bilinear.twin_model(a, "bilinear").state_dict()
    ncup = ncup_vs_bilinear.twin_model(a, "ncup").state_dict()
    trunk = load_model_weights(RAFT(small_model_config("raft"), device="cpu"),
                               str(tmp_path / "ck" / "torch_rigid_trunk")).state_dict()
    shared = [k for k in bilinear if not k.startswith("upsampler.")]
    assert shared and all(torch.equal(bilinear[k], ncup[k]) for k in shared)
    assert all(torch.equal(trunk[k], ncup[k]) for k in shared if k in trunk)
    assert any(not k.startswith("upsampler.") for k in trunk)
    # A second call finds both runs at their last step and trains nothing.
    assert ncup_vs_bilinear.main(argv) == 0
    assert len(calls) == 2
    assert json.load(open(tmp_path / "rec.json"))["trained"] == {"trunk": None, "ncup": None}


def test_convergence_run_logs_the_untrained_validation_once(tmp_path, monkeypatch):
    calls, seen = [], []
    _small_validators(monkeypatch)
    monkeypatch.setattr(synth_convergence, "run_train", _in_process(calls))
    monkeypatch.setattr(synth_convergence, "REPO", str(tmp_path))
    validators = dict(train_entry.VALIDATORS)
    monkeypatch.setattr("raft_ncup_tpu_torch.evaluation.VALIDATORS", {
        "synthetic": lambda *a, **kw: seen.append(a) or validators["synthetic"](*a, **kw)})
    argv = ["--device", "cpu", "--num_steps", "2", "--ckpt_dir", "ck"]
    assert synth_convergence.main(argv) == 0
    assert synth_convergence.main(argv) == 0
    # The untrained model once: the train entry's own seeded weights.
    assert len(seen) == 1 and len(calls) == 1
    (model, _data_cfg), want = seen[0], RAFT(small_model_config("raft"), device="cpu", seed=1234)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 want.state_dict().values()))
    curve = synth_convergence.validation_curve(str(tmp_path / "ck" / "torch_synth_r4"))
    assert set(curve) == {0, 2}


# ----------------------------------------- (d) ten steps against JAX's


def _batches():
    ds = SyntheticFlowDataset((H, W), length=2 * STEPS, seed=3)
    return [{k: v.numpy().astype(np.float32) for k, v in ds.batch(s, 2).items()}
            for s in range(STEPS)]


def test_ten_steps_of_the_recipe_follow_jaxs_trainer():
    tcfg = dict(stage="chairs", lr=4e-4, wdecay=1e-5, batch_size=2, image_size=(H, W),
                iters=4, num_steps=4000)
    jax_model, jstate = jax_create_train_state(
        jax.random.key(0), jax_small_model_config("raft", corr_impl="onthefly"),
        JaxTrainConfig(**tcfg))
    variables = {"params": jax.tree_util.tree_map(np.asarray, jstate.params)}
    model = load_jax_variables(RAFT(small_model_config("raft"), device="cpu"), variables)
    cfg = TrainConfig(**tcfg)
    state = state_for(model, cfg)
    jstep = jax_make_train_step(jax_model, JaxTrainConfig(**tcfg))
    schedule = jax_build_schedule(JaxTrainConfig(**tcfg))
    step = make_train_step(cfg)
    worst = 0.0
    for i, batch in enumerate(_batches()):
        lr_ours, lr_theirs = float(state.optimizer.lr()), float(schedule(i))
        assert lr_ours == lr_theirs, (i, lr_ours, lr_theirs)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.key(100 + i))
        m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        ours, theirs = float(m["loss"]), float(jm["loss"])
        assert float(m["bad_step"]) == 0.0 == float(jm["bad_step"])
        worst = max(worst, abs(ours - theirs) / abs(theirs))
        assert abs(ours - theirs) <= LOSS_RTOL * abs(theirs), (i, ours, theirs)
    assert worst > 0.0  # two float32 computations, not one
