"""The flagship's bf16 presets on a band of rows of the spatial axis
(``parallel/halo.py``, ``precision/``), on the CPU: one two-rank gloo
world (``tests/_torch_pac_spatial_child.py bf16``) on the mesh ``(data=1,
spatial=2)``, each rank in its own interpreter with its own timeout, from
JAX's variables carried across.

- The test-mode forward under ``bf16_infer`` at 64x96, 3 iterations: the
  port's flow no further from JAX's bf16 flow on ``make_mesh(data=1,
  spatial=2)``, in mean EPE, than JAX's ``(1, 2)`` bf16 flow is from JAX's
  ``(1, 2)`` f32 flow, both within ``FORWARD_EPE_BUDGET``
  (``tests/test_torch_precision.py``'s rule, there without a mesh); the
  outputs f32. On the CPU the halos cross gloo in bf16 (its point-to-point
  and all-gather carry the dtype); a card tensor crosses as float32, the
  host copy's dtype, and is cast back (exact); the norms' group sums are
  f32.
- The serve entry under ``--serve_precision bf16_infer`` with ``--mesh
  1,2``: every answer within ``FORWARD_EPE_BUDGET`` of one process's, in
  mean EPE.
- One ``bf16_train`` step (stage things, BatchNorm frozen, 64x64, batch 2,
  2 iterations): the loss within ``TRAIN_LOSS_RTOL`` of JAX's
  ``bf16_train`` step on the same mesh, every gradient f32 and finite, both
  ranks applying the same gradients.
- One process: the wire buffer a gloo rank receives a card tensor into has
  the dtype ``guards.collective_read`` sends it in (bf16 as float32).
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from raft_ncup_tpu.inference.pipeline import ShapeCachedForward as JaxShapeCachedForward
from raft_ncup_tpu.parallel import make_mesh as jax_make_mesh
from raft_ncup_tpu_torch import precision
from raft_ncup_tpu_torch.analysis import guards
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.parallel import halo

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _torch_pac_spatial_child as child  # noqa: E402
from test_torch_pac_spatial import (  # noqa: E402
    _epe,
    _frames,
    check_served,
    jax_flagship,
    jax_variables,
    spawn_world,
)
from test_torch_pac_spatial_train import _batch, _jax_step  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    stage = child.BF16_TRAIN_STAGE
    variables = {
        "flagship": jax_variables(jax_flagship("f32"), RAFT(
            child.flagship_cfg("f32"), device="cpu", seed=0), (child.H, child.W)),
        "train": jax_variables(jax_flagship("f32", stage), RAFT(
            child.flagship_cfg("f32", stage), device="cpu", seed=0), child.TRAIN_HW),
    }
    img1, img2 = _frames()
    batch = _batch()
    inputs = {"image1": torch.from_numpy(img1), "image2": torch.from_numpy(img2),
              "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
              "variables": variables}

    def references():
        jax_mesh = jax_make_mesh(data=1, spatial=2, devices=jax.devices()[:2])
        with ThreadPoolExecutor(1) as pool:
            step = pool.submit(_jax_step, jax_flagship("bf16_train", stage), variables["train"],
                               stage, batch, jax_mesh, "bf16_train")
            refs = {}
            for name in ("f32", "bf16_infer"):
                jfwd = JaxShapeCachedForward(jax_flagship(name), variables["flagship"],
                                             mesh=jax_mesh)
                refs[f"jax {name}"] = np.asarray(jfwd(img1, img2, iters=child.ITERS)[1])
            refs["serve"] = child.served(child.SERVE_ARGV["bf16_infer"])
            refs["jax bf16_train"] = step.result()
        return refs

    return spawn_world(tmp_path_factory, "bf16", inputs, references)


def test_the_world_is_a_spatial_mesh(world):
    for r, rank in enumerate(world["ranks"]):
        assert rank["fingerprint"] == "mesh(data=1,spatial=2:cpu)"
        assert rank["layout"] == (0, r) and rank["barrier"]


def test_bf16_infer_forward_tracks_jax_on_a_spatial_mesh(world):
    jax_bf16, jax_f32 = world["refs"]["jax bf16_infer"], world["refs"]["jax f32"]
    bf16_vs_f32 = _epe(jax_bf16, jax_f32)
    for rank in world["ranks"]:
        lr, up = rank["bf16_infer"]["flow_lr"], rank["bf16_infer"]["flow_up"]
        assert lr.dtype == up.dtype == torch.float32
        assert up.shape == (1, child.H, child.W, 2)
        port_vs_jax = _epe(up.numpy(), jax_bf16)
        print(f"bf16_infer on (1, 2): mean EPE port-jax {port_vs_jax:.3e}, jax bf16-f32 "
              f"{bf16_vs_f32:.3e}")
        assert port_vs_jax <= bf16_vs_f32
        assert max(port_vs_jax, bf16_vs_f32) <= precision.FORWARD_EPE_BUDGET
    a, b = (r["bf16_infer"]["flow_up"] for r in world["ranks"])
    assert torch.equal(a, b)


def test_serve_entry_under_bf16_infer_on_a_spatial_mesh(world):
    def close(flow, ref):
        assert _epe(flow, ref) <= precision.FORWARD_EPE_BUDGET

    check_served(world["refs"]["serve"], [r["serve"] for r in world["ranks"]], close)


def test_bf16_train_step_tracks_jax_on_a_spatial_mesh(world):
    ref = world["refs"]["jax bf16_train"]
    assert ref["bad_step"] == 0.0
    r0, r1 = (w["bf16_train"] for w in world["ranks"])
    for name, g in r0["grads"].items():
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()), name
        assert torch.equal(g, r1["grads"][name]), name
    loss = float(r0["loss"])
    print(f"bf16_train on (1, 2): loss {loss}, JAX {ref['loss']}, relative "
          f"{abs(loss - ref['loss']) / abs(ref['loss']):.3e}")
    assert abs(loss - ref["loss"]) <= precision.TRAIN_LOSS_RTOL * abs(ref["loss"])
    assert float(r0["metrics"]["bad_step"]) == 0.0
    ops = r0["collectives"]["by_op"]
    assert ops["collective-permute"]["count"] > 0 and r0["collectives"] == r1["collectives"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int64])
def test_the_gloo_wire_buffer_holds_what_collective_read_sends(dtype):
    """Under gloo a card tensor crosses through ``guards.collective_read``'s
    host copy, which holds bf16 as float32: the receiving wire buffer must
    have that dtype (a bf16 buffer received twice the bytes it expected on
    the card), and the bf16 -> float32 -> bf16 round trip is exact."""
    t = torch.linspace(-3, 3, 7).to(dtype)
    sent = guards.collective_read(t)
    assert sent.dtype == halo._wire_dtype(dtype)
    assert torch.equal(sent.to(dtype), t)
