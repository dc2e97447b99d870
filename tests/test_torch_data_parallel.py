"""Data parallelism across processes (``raft_ncup_tpu_torch/parallel/``),
on the CPU: one two-rank gloo world for the whole module
(``tests/_torch_dp_child.py``, each rank in its own interpreter, each with
its own timeout), held against JAX's mesh step and the port's one
process.

- The two-rank train step of the small ``raft_nc_dbl`` with the Sintel
  upsampler at stage chairs (16x32, 1 iteration, a global batch of 4), so
  BatchNorm trains, inside the checkpointed iteration, over the global
  batch: against JAX ``make_train_step`` on ``make_mesh(data=2)`` over two
  of the 8 virtual CPU devices, from the same carried weights (the loss,
  every gradient, the BatchNorm statistics and the parameters after the
  step), and against the port's one-process step on the global batch.
- The noise and dropout draws of each rank against the one-process rows;
  sharded validation and the mesh eval step against one process; the
  agreed preemption poll and the train entry under ``sigterm@2`` on rank 1
  (both ranks exit 75 at step 2, one checkpoint, written by rank 0 only,
  with rank 1 held back until rank 0 has written it), then resumed.

Tolerances. Against JAX, those of ``tests/test_torch_train.py`` (the same
f32 model computed in another order): the loss within 1e-5 relative;
every gradient within 1e-3 of its own largest magnitude, a bias that a
normalization centres (exactly zero on both sides) below 1e-6 of the
step's largest gradient, the NConv U-Net's weights within 5e-2 (ROADMAP.md
queue 3 entry 2); BatchNorm statistics within 1e-5; the parameters after
AdamW's first step, which moves each by about the step's learning rate
``lr0`` in the direction of its gradient's sign, within ``1e-2 lr0`` where
JAX's gradient is above 1e-3 of its tensor's largest (a sign both sides
agree on) and within ``2 lr0`` elsewhere. Against the port's one process
(the same code, the sums taken over ranks): every gradient within 1e-5 of
its largest magnitude, but the NConv U-Net's weights within 1e-3 (the
gradients of ROADMAP.md queue 3 entry 2, differences of nearly equal
terms, moved 4.3e-5 by the other order of the BatchNorm sums), the loss and metrics within 1e-6 relative, the
statistics within 1e-6, the parameters as against JAX; the two ranks'
parameters equal bit for bit. Draws and validation sums: the same values
(validation within 1e-6 relative, its sums taken in another order).
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raft_ncup_tpu.config import TrainConfig as JaxTrainConfig
from raft_ncup_tpu.config import small_model_config as jax_small_model_config
from raft_ncup_tpu.models.raft import RAFT as JaxRAFT
from raft_ncup_tpu.parallel import batch_sharding, global_batch
from raft_ncup_tpu.parallel import make_mesh as jax_make_mesh
from raft_ncup_tpu.parallel.step import make_train_step as jax_make_train_step
from raft_ncup_tpu.resilience.anomaly import init_sentinel as jax_init_sentinel
from raft_ncup_tpu.training.optim import build_optimizer
from raft_ncup_tpu.training.state import TrainState as JaxTrainState
from raft_ncup_tpu.utils.torch_import import import_torch_state
from raft_ncup_tpu_torch.evaluation import validate_synthetic
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.training import step as step_mod
from raft_ncup_tpu_torch.training.state import state_for
from raft_ncup_tpu_torch.utils.jax_weights import carry_state_dict

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _torch_dp_child as child  # noqa: E402

WORLD, BATCH = 2, 4
SPAWN_TIMEOUT_S = 240
LOSS_RTOL, GRAD_TOL, STATS_TOL = 1e-5, 1e-3, 1e-5
NEGLIGIBLE = 1e-6
NCUP_WEIGHTS, NCUP_TOL = "upsampler.interpolation_net.", 5e-2
SELF_GRAD_TOL, SELF_RTOL = 1e-5, 1e-6
SIGN_DEFINED = 1e-3  # of a tensor's largest gradient


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs():
    g = np.random.default_rng(11)
    img1 = g.uniform(0, 255, (BATCH, child.H, child.W, 3)).astype(np.float32)
    return {
        "image1": img1,
        "image2": np.roll(img1, (1, 2), axis=(1, 2)).copy(),
        "flow": g.normal(0, 2, (BATCH, child.H, child.W, 2)).astype(np.float32),
        "valid": (g.random((BATCH, child.H, child.W)) > 0.1).astype(np.float32),
    }


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both ranks' outputs, after one run of the child in each; the
    references are computed here while the ranks run."""
    work = tmp_path_factory.mktemp("dp")
    np.savez(work / "inputs.npz", **_inputs())
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE), OMP_NUM_THREADS="1",
               RAFT_TORCH_TELEMETRY="1")
    env.pop("RAFT_TORCH_FLIGHT_DIR", None)
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "_torch_dp_child.py"),
                               str(port), str(r), str(WORLD), str(work)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(WORLD)]
    logs = []
    try:
        refs = _references()
        for p in procs:
            out, _ = p.communicate(timeout=SPAWN_TIMEOUT_S)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    out = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"ranks": out, "logs": logs, "work": work, "refs": refs}


def _port_one_process():
    cfg = child.train_cfg(BATCH)
    state = state_for(RAFT(child.model_cfg(), device="cpu", seed=0), cfg)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    batch = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    return before, child.step_outputs(state, batch, cfg, mesh=None), state


def _capture_then(tx):
    """``tx`` after a transform whose state becomes the raw gradients."""
    capture = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))
    return optax.chain(capture, tx)


def _jax_mesh_step(before):
    cfg = child.model_cfg()
    model = JaxRAFT(jax_small_model_config(cfg.variant, dataset=cfg.dataset,
                                           corr_impl="onthefly"))
    template = jax.eval_shape(lambda k: model.init(k, (1, child.H, child.W, 3)),
                              jax.random.key(0))
    variables = import_torch_state({k: v.numpy() for k, v in before.items()}, template,
                                   strict=True)
    tcfg = JaxTrainConfig(stage="chairs", batch_size=BATCH, image_size=(child.H, child.W),
                          iters=child.ITERS, num_steps=10)
    tx = _capture_then(build_optimizer(tcfg))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), tx=tx, sentinel=jax_init_sentinel())
    mesh = jax_make_mesh(data=WORLD, spatial=1, devices=jax.devices()[:WORLD])
    batch = global_batch(_inputs(), mesh, batch_sharding(mesh))
    new, metrics = jax_make_train_step(model, tcfg, mesh=mesh)(state, batch, jax.random.key(2))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {
        "loss": float(metrics["loss"]), "bad_step": float(metrics["bad_step"]),
        "metrics": {k: float(metrics[k]) for k in ("epe", "1px", "3px", "5px")},
        "grads": carry_state_dict({"params": as_np(new.opt_state[0])}),
        "after": carry_state_dict({"params": as_np(new.params),
                                   "batch_stats": as_np(new.batch_stats)}),
    }


@pytest.fixture(scope="module")
def references(world):
    return world["refs"]


def _references():
    before, port, state = _port_one_process()
    return {"before": before, "port": port, "jax": _jax_mesh_step(before),
            "lr0": float(state.optimizer.lr())}


def _zero_by_structure(name):
    """A bias whose output the weights net's training BatchNorm centres."""
    return name.startswith("upsampler.weights_est_net.conv.") and name.endswith(".0.bias")


def _check_params_after(got, want, grads, lr0, what):
    for name, w in want.items():
        if name.endswith("num_batches_tracked") or name not in grads:
            continue
        g = grads[name].abs()
        defined = g > SIGN_DEFINED * float(g.max())
        diff = (got[name] - w).abs()
        assert float(diff.max()) <= 2 * lr0, f"{what} {name}: {float(diff.max())}"
        if bool(defined.any()):
            assert float(diff[defined].max()) <= 1e-2 * lr0, (
                f"{what} {name}: {float(diff[defined].max())} where the sign is defined")


def test_two_rank_step_matches_jax_mesh_step(world, references):
    ref = references["jax"]
    assert ref["bad_step"] == 0.0
    r0 = world["ranks"][0]["step"]
    assert abs(float(r0["loss"]) - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
    for k, v in ref["metrics"].items():
        assert abs(float(r0["metrics"][k]) - v) <= LOSS_RTOL * max(abs(v), 1e-3), k
    grads = r0["grads"]
    assert set(grads) == set(ref["grads"])
    gmax = max(float(r.abs().max()) for r in ref["grads"].values())
    for name, g in grads.items():
        r = ref["grads"][name]
        scale = float(r.abs().max())
        if _zero_by_structure(name) or scale < NEGLIGIBLE * gmax:
            assert scale < NEGLIGIBLE * gmax and float(g.abs().max()) < NEGLIGIBLE * gmax, name
            continue
        tol = NCUP_TOL if name.startswith(NCUP_WEIGHTS) else GRAD_TOL
        err = float((g - r).abs().max())
        assert err <= tol * scale, f"{name}: {err} vs max {scale}"
    after = r0["after"]
    stats = [k for k in ref["after"] if k.endswith(("running_mean", "running_var"))]
    assert stats, "BatchNorm trains at stage chairs"
    for k in stats:
        torch.testing.assert_close(after[k], ref["after"][k], rtol=0, atol=STATS_TOL)
        assert not torch.equal(after[k], references["before"][k]), k  # it moved
    _check_params_after(after, ref["after"], ref["grads"], references["lr0"], "JAX")


def test_two_rank_step_matches_one_process(world, references):
    port = references["port"]
    r0, r1 = (w["step"] for w in world["ranks"])
    for k in r0["after"]:
        assert torch.equal(r0["after"][k], r1["after"][k]), f"the ranks differ at {k}"
    assert torch.equal(r0["loss"], r1["loss"])
    assert abs(float(r0["loss"]) - float(port["loss"])) <= SELF_RTOL * abs(float(port["loss"]))
    for k, v in port["metrics"].items():
        assert abs(float(r0["metrics"][k]) - float(v)) <= SELF_RTOL * max(abs(float(v)), 1e-3), k
    gmax = max(float(g.abs().max()) for g in port["grads"].values())
    for name, g in port["grads"].items():
        scale = float(g.abs().max())
        if scale < NEGLIGIBLE * gmax:  # a bias a normalization centres: rounding noise
            assert float(r0["grads"][name].abs().max()) < NEGLIGIBLE * gmax, name
            continue
        err = float((r0["grads"][name] - g).abs().max())
        tol = GRAD_TOL if name.startswith(NCUP_WEIGHTS) else SELF_GRAD_TOL
        assert err <= tol * scale, f"{name}: {err} vs max {scale}"
    for k, v in port["after"].items():
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(r0["after"][k], v, rtol=0, atol=1e-6)
        elif k.endswith("num_batches_tracked"):
            assert torch.equal(r0["after"][k], v)
    _check_params_after(r0["after"], port["after"], port["grads"], references["lr0"], "port")
    # One coalesced all-reduce of the step's gradients, loss and metrics,
    # and one per training BatchNorm in the forward, the recompute and
    # the backward.
    ops = world["ranks"][0]["step_collectives"]["by_op"]
    n_grad = sum(g.numel() for g in port["grads"].values())
    assert ops["all-reduce"]["count"] >= 2
    assert ops["all-reduce"]["bytes"] >= 4 * (n_grad + 6)


def test_noise_and_dropout_rows_are_the_one_process_rows(world):
    whole = child.draws(None, BATCH)
    for rank, out in enumerate(world["ranks"]):
        d = out["draws"]
        for k in ("noise1", "noise2"):
            assert torch.equal(d[k], whole[k][rank::WORLD]), (rank, k)
        full = whole["dropout"].view(2, BATCH, *whole["dropout"].shape[1:])
        assert torch.equal(d["dropout"], full[:, rank::WORLD].reshape(d["dropout"].shape))
    assert not torch.equal(world["ranks"][0]["draws"]["noise1"],
                           world["ranks"][1]["draws"]["noise1"])


def test_sharded_validation_and_eval_step_match_one_process(world):
    model = RAFT(child.model_cfg(), device="cpu", seed=0)
    whole = validate_synthetic(model, **child.VAL)
    for out in world["ranks"]:
        assert set(out["validation"]) == set(whole)
        for k, v in whole.items():
            assert abs(out["validation"][k] - v) <= 1e-6 * abs(v), (k, out["validation"][k], v)
    batch = _inputs()
    lr, up = step_mod.make_eval_step(model, iters=2)(torch.from_numpy(batch["image1"]),
                                                     torch.from_numpy(batch["image2"]))
    for out in world["ranks"]:
        glr, gup = out["eval_step"]
        torch.testing.assert_close(glr, lr, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(gup, up, rtol=1e-5, atol=1e-5)


def test_preemption_is_agreed_across_ranks(world):
    # Rank 1 signals itself after step 3; the ranks agree every 2 steps,
    # so both stop at step 4.
    stops = [out["poll_stop"] for out in world["ranks"]]
    assert stops == [4, 4]
    # The entry under sigterm@2 on rank 1 only: both exit 75 at step 2.
    assert [out["entry_preempted"][0] for out in world["ranks"]] == [75, 75]
    assert [out["entry_resumed"][0] for out in world["ranks"]] == [0, 0]
    assert "preemption: received signal" in world["logs"][1]


def test_a_late_rank_still_joins_the_preemption_save(world):
    # Rank 1 came to its save after the agreed stop only once rank 0 had
    # written step_2.pt; the save is a collective all the same, so rank 1
    # joined it from what it holds in memory, and both exited 75.
    assert world["ranks"][0]["late_seen"] is None
    assert world["ranks"][1]["late_seen"] == [(2, True)]
    assert [out["entry_preempted"] for out in world["ranks"]] == [(75, 1), (75, 0)]


def test_only_rank_zero_writes(world):
    # Checkpoints written by rank 0 only: step_2.pt when preempted, step_4.pt at the end.
    assert [out["entry_preempted"][1] for out in world["ranks"]] == [1, 0]
    assert [out["entry_resumed"][1] for out in world["ranks"]] == [1, 0]
    run = world["work"] / "ck" / "run"
    assert sorted(p.name for p in run.glob("step_*.pt")) == ["step_2.pt", "step_4.pt"]
    log = (run / "log.txt").read_text()
    assert log.count("world=2 mesh=mesh(data=2,spatial=1:cpu) backend=gloo") == 2  # two runs
    dumps = sorted(os.listdir(run / "flight"))
    assert len(dumps) == 1 and "preemption_drain" in dumps[0]
    # Every rank joined the same world and agreed on its fingerprint.
    assert [out["fingerprint"] for out in world["ranks"]] == ["mesh(data=2,spatial=1:cpu)"] * 2
    assert all(out["backend"] == "gloo" and out["barrier"] for out in world["ranks"])
