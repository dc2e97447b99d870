"""The train entry (``python -m raft_ncup_tpu_torch.train``) in-process
on the CPU, as ``tests/test_chaos_train.py`` drives the JAX trainer, and
the shipped scripts' flags through both packages' parsers.

The runs train the small ``raft`` model at 2 iterations, batch 1, from a
FlyingThings3D-layout tree of 80x112 frames cropped to 64x96, through the
loader, its augmentation and the prefetcher (the plain versions of the
kernels on the CPU).

- ``sigterm@2`` exits 75 with ``step_2.pt`` saved; the resumed run ends
  in a state (weights, moments, count, sentinel) bit for bit equal to an
  uninterrupted run's, noise and dropout included.
- ``nan@1`` is skipped by the sentinel and the run completes.
- Two bad steps in a row with ``--sentinel_halt_after 2`` exit 76 with the
  live state rolled back, bit for bit, to ``step_2.pt``; the validation
  at step 2 is in ``log.txt``.
- Every ``scripts/train_raft_nc_*.sh`` and ``scripts/eval_raft_nc_*.sh``
  flag line parses through both packages to equal model fields (the port
  pins ``corr_impl``: it always runs its kernels), and the two models
  built from them hold the same tensors, key for key and shape for shape,
  in the reference's naming.
"""

import dataclasses
import functools
import glob
import json
import os
import shlex

import jax
import numpy as np
import pytest
import torch

from raft_ncup_tpu import cli as jax_cli
from raft_ncup_tpu.models.raft import RAFT as JaxRAFT
from raft_ncup_tpu.utils.torch_export import export_torch_state
from raft_ncup_tpu_torch import cli, train
from raft_ncup_tpu_torch.io import write_flo, write_pfm, write_png
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.training import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (80, 112)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small CPU runs launch many tiny ops, and
    with the test workers sharing the cores a parallel region per op waits
    on threads that are not scheduled (a run took 10x longer)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(g, n):
    base = np.kron(g.uniform(0, 255, (HW[0] // 8, HW[1] // 8, 3)), np.ones((8, 8, 1)))
    return [np.clip(np.roll(base, (i, 2 * i), axis=(0, 1)) + g.normal(0, 6, base.shape),
                    0, 255).astype(np.uint8) for i in range(n)]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("entry_data")
    g = np.random.default_rng(0)
    for seq in ("A/0000", "A/0001"):
        frames = _frames(g, 3)
        for dstype in ("frames_cleanpass", "frames_finalpass"):
            d = root / "things" / dstype / "TRAIN" / seq / "left"
            d.mkdir(parents=True)
            for i, f in enumerate(frames):
                write_png(d / f"{i:04d}.png", f)
        for direction, sign in (("into_future", 1.0), ("into_past", -1.0)):
            d = root / "things" / "optical_flow" / "TRAIN" / seq / direction / "left"
            d.mkdir(parents=True)
            for i in range(3):
                flow = np.zeros((*HW, 3), np.float32)
                flow[..., 0], flow[..., 1] = 2.0 * sign, 1.0 * sign
                write_pfm(d / f"{i:04d}.pfm", flow)
    for scene in ("s0",):
        frames = _frames(g, 2)
        for dstype in ("clean", "final"):
            d = root / "sintel" / "training" / dstype / scene
            d.mkdir(parents=True)
            for i, f in enumerate(frames):
                write_png(d / f"frame_{i:04d}.png", f[:64, :96])
        d = root / "sintel" / "training" / "flow" / scene
        d.mkdir(parents=True)
        write_flo(d / "frame_0000.flo", np.ones((64, 96, 2), np.float32))
    return root


def _args(data, ckdir, steps, *extra):
    return ["--name", "run", "--stage", "things", "--model", "raft", "--small",
            "--num_steps", str(steps), "--batch_size", "1", "--image_size", "64", "96",
            "--iters", "2", "--lr", "1e-4", "--sum_freq", "1", "--num_workers", "1",
            "--checkpoint_dir", str(ckdir), "--root_things", str(data / "things"),
            "--root_sintel", str(data / "sintel"), "--device", "cpu", *extra]


def _summary(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _assert_same_state(a, b):
    for part in ("model", "sentinel"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    for k in ("mu", "nu"):
        assert all(torch.equal(x, y) for x, y in zip(a["optimizer"][k], b["optimizer"][k]))
    assert torch.equal(a["optimizer"]["count"], b["optimizer"]["count"])
    assert a["step"] == b["step"]


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def test_sigterm_exits_75_and_the_resumed_run_is_bitwise_uninterrupted(data, tmp_path, capsys):
    extra = ("--add_noise", "--dropout", "0.1")
    assert train.main(_args(data, tmp_path / "whole", 4, *extra)) == 0
    assert _summary(capsys)["status"] == 0
    rc = train.main(_args(data, tmp_path / "split", 4, *extra, "--chaos", "sigterm@2"))
    assert rc == 75 and _summary(capsys)["status"] == 75
    run = tmp_path / "split" / "run"
    assert sorted(os.listdir(run)) == ["flight", "log.txt", "resume_meta.json", "step_2.pt"]
    # The drain banked its flight dump beside the checkpoint.
    (dump,) = os.listdir(run / "flight")
    assert dump.startswith("flight_preemption_drain_")
    assert "preempted @ 2" in (run / "log.txt").read_text()
    assert train.main(_args(data, tmp_path / "split", 4, *extra,
                            "--restore_ckpt", str(run))) == 0
    assert _summary(capsys)["steps"] == 2
    _assert_same_state(_load(run / "step_4.pt"), _load(tmp_path / "whole" / "run" / "step_4.pt"))


def test_a_nan_batch_is_skipped(data, tmp_path, capsys):
    assert train.main(_args(data, tmp_path, 3, "--chaos", "nan@1")) == 0
    out = _summary(capsys)
    assert out["skipped"] == 1 and out["status"] == 0 and np.isfinite(out["loss"])
    log = (tmp_path / "run" / "log.txt").read_text()
    assert "chaos: nan@1" in log and "sentinel @ 2: skipped=1 consecutive=1" in log


def test_consecutive_bad_steps_halt_with_exit_76_and_roll_back(data, tmp_path, capsys,
                                                               monkeypatch):
    seen = {}
    create = train.create_train_state

    def keep(*args, **kwargs):
        seen["state"] = create(*args, **kwargs)
        return seen["state"]

    monkeypatch.setattr(train, "create_train_state", keep)
    rc = train.main(_args(data, tmp_path, 6, "--chaos", "nan@2,nan@3",
                          "--sentinel_halt_after", "2", "--val_freq", "2",
                          "--validation", "sintel"))
    assert rc == 76 and _summary(capsys)["status"] == 76
    run = tmp_path / "run"
    log = (run / "log.txt").read_text()
    assert "[val @ 2] " in log and "clean" in log.split("[val @ 2] ")[1].splitlines()[0]
    assert "sentinel halt @ 4" in log and "rolled back to the last good checkpoint (step 2)" in log
    state = seen["state"]
    saved = _load(run / "step_2.pt")
    live = {"step": state.step, "model": state.model.state_dict(), "sentinel": state.sentinel,
            "optimizer": state.optimizer.state_dict()}
    _assert_same_state(live, saved)


# ------------------------------------------------- the shipped scripts' flags


def _script_args(path, entry):
    text = open(path).read().replace("\\\n", " ")
    for line in text.splitlines():
        toks = shlex.split(line.strip()) if line.strip().startswith("python") else []
        if entry in toks:
            toks = toks[toks.index(entry) + 1:]
            return [t.replace("$EXP", "exp").replace("$CKPT", "ckpt") for t in toks
                    if t != "$@"]
    raise AssertionError(f"no python {entry} line in {path}")


SCRIPTS = sorted(glob.glob(os.path.join(REPO, "scripts", "train_raft_nc_*.sh"))
                 + glob.glob(os.path.join(REPO, "scripts", "eval_raft_nc_*.sh")))


@functools.lru_cache(maxsize=None)
def _jax_keys(cfg):
    template = jax.eval_shape(lambda k: JaxRAFT(cfg).init(k, (1, 64, 64, 3)),
                              jax.random.key(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), template)
    return {k: tuple(np.shape(v)) for k, v in export_torch_state(zeros).items()}


@pytest.mark.parametrize("script", SCRIPTS, ids=os.path.basename)
def test_shipped_script_flags_select_the_same_model(script):
    assert len(SCRIPTS) == 5
    if "/train_" in script:
        argv = _script_args(script, "train.py")
        ours, ref = cli.parse_train(argv)[1], jax_cli.parse_train(argv)[1]
    else:
        argv = _script_args(script, "evaluate.py")
        ours, ref = cli.parse_eval(argv)[1], jax_cli.parse_eval(argv)[1]
    shared = {f.name for f in dataclasses.fields(ours)} & {f.name for f in dataclasses.fields(ref)}
    shared -= {"corr_impl"}  # the port always runs its kernels
    for name in sorted(shared - {"upsampler"}):
        assert getattr(ours, name) == getattr(ref, name), name
    assert dataclasses.asdict(ours.upsampler) == dataclasses.asdict(ref.upsampler)
    assert ours.variant == "raft_nc_dbl" and ours.corr_impl == "pallas"
    model = RAFT(ours, device="cpu")
    state = model.state_dict()
    state.update({a: state[k] for a, k in checkpoint.reference_aliases(model).items()})
    assert {k: tuple(v.shape) for k, v in state.items()} == _jax_keys(ref)


def test_model_flag_defaults_match_jax():
    import argparse

    ours, ref = argparse.ArgumentParser(), argparse.ArgumentParser()
    cli.add_model_args(ours)
    jax_cli.add_model_args(ref)
    got, want = vars(ours.parse_args([])), vars(ref.parse_args([]))
    assert got == {k: v for k, v in want.items() if k != "corr_impl"}
    assert got["model"] == "raft"
    # The PAC and DJIF heads are the port's since the PAC slice.
    assert cli.model_config_from_args(ours.parse_args(["--final_upsampling=DjifOriginal"]),
                                      "sintel").upsampler.kind == "djif"
    with pytest.raises(ValueError, match="ROADMAP"):
        cli.parse_train(["--stage", "things", "--data_parallel", "2"])
    # --strict_guards is the port's since its runtime-guards slice.
    assert cli.parse_train(["--stage", "things", "--strict_guards"])[0].strict_guards
    # --profile_steps is the port's since its telemetry slice.
    assert cli.parse_train(["--stage", "things", "--profile_steps", "3"])[0].profile_steps == 3
