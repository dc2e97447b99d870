"""Training with the PAC and DJIF heads over the spatial axis
(``parallel/halo.py``, ``nn/pac.py``), on the CPU: one two-rank gloo world (``tests/_torch_pac_spatial_child.py train``) on the
mesh ``(data=1, spatial=2)``, each rank in its own interpreter with its own
timeout, from JAX's variables carried across.

- One train step of the small ``raft_nc_dbl`` with each head (stage chairs,
  64x64, batch 2, 2 iterations, remat on), the head running on the rank's
  band every iteration and the loss reading its band of each prediction:
  the loss and the gradient norm against JAX's step on ``make_mesh(data=1,
  spatial=2)`` at rtol 2e-4 (JAX's own tolerance for its sharded step
  against its unsharded one, ``tests/test_highres.py``); every gradient
  against the port's one-process step within ``SELF_GRAD_TOL`` of its own
  largest value (``tests/test_torch_spatial_train.py``'s bound for the same
  code on bands), a gradient that is rounding noise on one side (zero by
  structure) below 1e-6 of the step's largest on the other; the small
  feature encoder's stem and first stage, behind a ReLU input within
  rounding of zero, at that file's ``FLIP_TOL``; the head's own parameters
  at ``tests/test_torch_pac.py``'s ``GRAD_TOL`` (``HEAD_GRAD_TOL`` below).
- Both ranks apply the same reduced gradients and issue the same
  collectives, halo exchanges among them.

``bf16_train`` on the mesh is ``tests/test_torch_bf16_spatial.py``'s.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_ncup_tpu.config import TrainConfig as JaxTrainConfig
from raft_ncup_tpu.parallel import make_mesh as jax_make_mesh
from raft_ncup_tpu.parallel.step import make_train_step as jax_make_train_step
from raft_ncup_tpu.resilience.anomaly import init_sentinel as jax_init_sentinel
from raft_ncup_tpu.training.optim import build_optimizer
from raft_ncup_tpu.training.state import TrainState as JaxTrainState
from raft_ncup_tpu_torch.models.raft import RAFT

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _torch_pac_spatial_child as child  # noqa: E402
from test_torch_pac_spatial import jax_head_model, jax_variables, spawn_world  # noqa: E402
from test_torch_pac import GRAD_TOL as HEAD_GRAD_TOL  # noqa: E402
from test_torch_spatial_train import FLIP_PREFIXES, FLIP_TOL, SELF_GRAD_TOL  # noqa: E402

JAX_RTOL = 2e-4
NEGLIGIBLE = 1e-6
# The heads' own parameters take tests/test_torch_pac.py's bound for them
# (HEAD_GRAD_TOL, 1e-3 of the largest value): DJIF's t_conv1, a 9x9 kernel
# on one channel whose gradient sums every full-resolution pixel's products
# of both signs, moved by 2.4e-4 of its largest value between the bands'
# float32 and one process's (measured on this batch); the float64 module
# test of tests/test_torch_pac_spatial.py holds DJIF's gradients on bands
# within 1e-10.


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch():
    g = np.random.default_rng(27)
    img1 = g.uniform(0, 255, (child.TRAIN_BATCH, *child.TRAIN_HW, 3)).astype(np.float32)
    return {"image1": img1, "image2": np.roll(img1, (2, 3), axis=(1, 2)).copy(),
            "flow": g.normal(0, 2, (child.TRAIN_BATCH, *child.TRAIN_HW, 2)).astype(np.float32),
            "valid": (g.random((child.TRAIN_BATCH, *child.TRAIN_HW)) > 0.1).astype(np.float32)}


def _jax_step(jmodel, variables, stage, batch, mesh, precision_="f32"):
    """JAX's train step on ``mesh`` from the carried variables: its loss and
    gradient norm."""
    tcfg = JaxTrainConfig(stage=stage, lr=1e-4, num_steps=50, batch_size=child.TRAIN_BATCH,
                          image_size=child.TRAIN_HW, iters=child.TRAIN_ITERS,
                          precision=precision_)
    tx = build_optimizer(tcfg)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables.get("batch_stats", {})),
        opt_state=tx.init(params), tx=tx, sentinel=jax_init_sentinel())
    _, metrics = jax_make_train_step(jmodel, tcfg, mesh=mesh)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(2))
    return {k: float(metrics[k]) for k in ("loss", "grad_norm", "bad_step")}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    hw = child.TRAIN_HW
    jmodels, variables = {}, {}
    for kind in child.HEADS:
        jmodels[kind] = jax_head_model(kind, dataset="chairs")
        variables[kind] = jax_variables(
            jmodels[kind], RAFT(child.head_cfg(kind, "chairs"), device="cpu", seed=0), hw)
    batch = _batch()
    inputs = {"batch": {k: torch.from_numpy(v) for k, v in batch.items()},
              "variables": variables}

    def references():
        # JAX's steps compile on threads of their own (XLA compiles
        # outside the interpreter's lock) while this thread runs the port's
        # one-process steps.
        jax_mesh = jax_make_mesh(data=1, spatial=2, devices=jax.devices()[:2])
        with ThreadPoolExecutor(len(child.HEADS)) as pool:
            futures = {kind: pool.submit(_jax_step, jmodels[kind], variables[kind], "chairs",
                                         batch, jax_mesh) for kind in child.HEADS}
            refs = {kind: {"port": child.step_outputs(
                child.head_cfg(kind, "chairs"), variables[kind], child.train_cfg("chairs"),
                inputs["batch"], None)} for kind in child.HEADS}
            for kind, future in futures.items():
                refs[kind]["jax"] = future.result()
        return refs

    return spawn_world(tmp_path_factory, "train", inputs, references)


def test_the_world_is_a_spatial_mesh(world):
    for r, rank in enumerate(world["ranks"]):
        assert rank["fingerprint"] == "mesh(data=1,spatial=2:cpu)"
        assert rank["layout"] == (0, r) and rank["barrier"]


@pytest.mark.parametrize("kind", child.HEADS)
def test_head_step_matches_jax_spatial_step(world, kind):
    ref = world["refs"][kind]["jax"]
    assert ref["bad_step"] == 0.0
    for rank in world["ranks"]:
        got = rank[kind]
        assert float(got["metrics"]["bad_step"]) == 0.0
        for k in ("loss", "grad_norm"):
            v = float(got["metrics"][k])
            assert abs(v - ref[k]) <= JAX_RTOL * abs(ref[k]), (k, v, ref[k])


@pytest.mark.parametrize("kind", child.HEADS)
def test_head_step_matches_one_process(world, kind):
    port = world["refs"][kind]["port"]
    r0, r1 = (w[kind] for w in world["ranks"])
    assert torch.equal(r0["loss"], r1["loss"])
    for name in port["grads"]:
        assert torch.equal(r0["grads"][name], r1["grads"][name]), name
    loss, want = float(r0["loss"]), float(port["loss"])
    assert abs(loss - want) <= JAX_RTOL * abs(want), (loss, want)
    assert any(name.startswith(f"upsampler.{kind}.") and float(g.abs().max()) > 0
               for name, g in r0["grads"].items())
    gmax = max(float(g.abs().max()) for g in port["grads"].values())
    for name, g in port["grads"].items():
        scale = float(g.abs().max())
        if scale < NEGLIGIBLE * gmax:  # zero by structure: rounding noise on both sides
            assert float(r0["grads"][name].abs().max()) < NEGLIGIBLE * gmax, name
            continue
        err = float((r0["grads"][name] - g).abs().max())
        tol = (FLIP_TOL if name.startswith(FLIP_PREFIXES) else
               HEAD_GRAD_TOL if name.startswith("upsampler.") else SELF_GRAD_TOL)
        assert err <= tol * scale, f"{name}: {err} vs max {scale}"


@pytest.mark.parametrize("case", child.HEADS)
def test_both_ranks_run_the_same_collectives(world, case):
    a, b = (w[case]["collectives"] for w in world["ranks"])
    assert a == b
    ops = a["by_op"]
    assert ops["collective-permute"]["count"] > 0 and ops["all-gather"]["count"] > 0
    assert ops["reduce-scatter"]["count"] == ops["all-gather"]["count"]
