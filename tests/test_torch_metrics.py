"""The port's inference tier on the CPU: the metric accumulators against
the JAX package's, and the pipeline's pieces.

- ``accumulate`` of every kind (epe, px, kitti, epe_band), with and
  without a pad crop, over several batches: within 1e-6 relative of the
  JAX accumulator on the same fields (both sum in float32, in another
  order); a KITTI frame with no valid pixel adds nothing; ``finalize``
  equal to JAX's on the same sums.
- ``ShapeCachedForward`` on a CPU model: one entry per key (shape and
  batch, iterations, warm start, metric kind and pad, preset), LRU
  eviction and its ``stats``; its forward is the model's and its metric
  fold the accumulator of the model's flow.
- The launch bookkeeping of a captured graph (taken back after capture,
  added per replay), on the wrappers' counters.
- ``SamplePrefetcher``, ``uniform_batches``, ``EvalPipeline``,
  ``DispatchThrottle`` and ``AsyncDrain``: order, errors, closing early.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_ncup_tpu.inference import metrics as jmetrics
from raft_ncup_tpu_torch.config import small_model_config
from raft_ncup_tpu_torch.inference import metrics as pmetrics
from raft_ncup_tpu_torch.inference import pipeline
from raft_ncup_tpu_torch.inference.pipeline import (
    AsyncDrain,
    DispatchThrottle,
    EvalPipeline,
    SamplePrefetcher,
    ShapeCachedForward,
    uniform_batches,
)
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.ops.corr_cuda import lookup_levels
from raft_ncup_tpu_torch.ops.nconv_cuda import nconv2d_fused

ACC_RTOL = 1e-6
PAD = ((2, 2), (0, 4))


def _batches(kind, pad, n=3):
    g = np.random.default_rng({"epe": 0, "px": 1, "kitti": 2, "epe_band": 3}[kind])
    out = []
    for i in range(n):
        ht, wd = 20, 28
        pht = ht + (pad[0][0] + pad[0][1] if pad else 0)
        pwd = wd + (pad[1][0] + pad[1][1] if pad else 0)
        gt = g.normal(0, 3, (2, ht, wd, 2)).astype(np.float32)
        pred = np.pad(gt, ((0, 0), (pad[0] if pad else (0, 0)), (pad[1] if pad else (0, 0)),
                           (0, 0))) + g.normal(0, 2, (2, pht, pwd, 2)).astype(np.float32)
        batch = {"flow_up": pred.astype(np.float32), "gt": gt}
        if kind == "kitti":
            valid = (g.uniform(size=(2, ht, wd)) > 0.3).astype(np.float32)
            if i == 1:
                valid[0] = 0.0  # a frame with no valid pixel
            batch["valid"] = valid
        if kind == "epe_band":
            batch["band"] = (g.uniform(size=(2, ht, wd)) > 0.7).astype(np.float32)
        out.append(batch)
    return out


@pytest.mark.parametrize("pad", [None, PAD])
@pytest.mark.parametrize("kind", ["epe", "px", "kitti", "epe_band"])
def test_accumulators_match_jax(kind, pad):
    jacc = jmetrics.init_acc(kind)
    pacc = pmetrics.init_acc(kind)
    assert pacc.dtype == torch.float32 and pacc.shape == jacc.shape
    for b in _batches(kind, pad):
        jacc = jmetrics.accumulate(kind, jacc, jnp.asarray(b["flow_up"]), jnp.asarray(b["gt"]),
                                   valid=None if "valid" not in b else jnp.asarray(b["valid"]),
                                   band=None if "band" not in b else jnp.asarray(b["band"]),
                                   pad=pad)
        pacc = pmetrics.accumulate(
            kind, pacc, torch.from_numpy(b["flow_up"]), torch.from_numpy(b["gt"]),
            valid=None if "valid" not in b else torch.from_numpy(b["valid"]),
            band=None if "band" not in b else torch.from_numpy(b["band"]), pad=pad)
    want = np.asarray(jacc)
    got = pacc.numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=ACC_RTOL, atol=0)
    if kind == "kitti":
        assert want[1] == 5.0  # six frames, one without a valid pixel
    assert pmetrics.finalize(kind, want) == jmetrics.finalize(kind, want)


def test_finalize_degenerate_kitti_and_unknown_kind():
    assert pmetrics.finalize("kitti", np.zeros(4)) == {"epe": 0.0, "f1": 0.0}
    with pytest.raises(ValueError, match="unknown metric kind"):
        pmetrics.finalize("nope", np.zeros(2))
    with pytest.raises(ValueError, match="unknown metric kind"):
        pmetrics.accumulate("nope", torch.zeros(2), torch.zeros(1, 4, 4, 2),
                            torch.zeros(1, 4, 4, 2))
    x = torch.arange(2 * 10 * 12 * 2, dtype=torch.float32).reshape(2, 10, 12, 2)
    np.testing.assert_array_equal(pmetrics.unpad_in_graph(x, PAD).numpy(),
                                  np.asarray(jmetrics.unpad_in_graph(jnp.asarray(x), PAD)))


# ------------------------------------------------------ ShapeCachedForward


@pytest.fixture(scope="module")
def tiny_model():
    return RAFT(small_model_config("raft", corr_impl="pallas", nconv_impl="pallas"),
                device="cpu", seed=0)


def _imgs(g, b, h, w):
    return [g.uniform(0, 255, (b, h, w, 3)).astype(np.float32) for _ in range(2)]


def test_shape_cache_keys_lru_and_stats(tiny_model):
    g = np.random.default_rng(0)
    fwd = ShapeCachedForward(tiny_model, cache_size=3)
    a = _imgs(g, 1, 32, 40)
    lr, up = fwd.forward(*a, iters=1)
    want_lr, want_up = tiny_model(*(torch.from_numpy(x) for x in a), iters=1)
    torch.testing.assert_close(lr, want_lr, rtol=0, atol=0)
    torch.testing.assert_close(up, want_up, rtol=0, atol=0)
    assert fwd.stats == {"compiles": 1, "hits": 0, "evictions": 0}
    fwd.forward(*_imgs(g, 1, 32, 40), iters=1)  # same key: a hit
    assert fwd.stats == {"compiles": 1, "hits": 1, "evictions": 0}
    fwd.forward(*a, iters=2)  # iterations
    fwd.forward(*_imgs(g, 2, 32, 40), iters=1)  # batch
    assert fwd.stats == {"compiles": 3, "hits": 1, "evictions": 0}
    finit = np.zeros((1, 4, 5, 2), np.float32)
    warm_lr, _ = fwd.forward(*a, iters=1, flow_init=finit)  # warm start: evicts the oldest
    torch.testing.assert_close(warm_lr, want_lr, rtol=0, atol=0)  # a zero init is cold
    assert fwd.stats == {"compiles": 4, "hits": 1, "evictions": 1}
    assert len(fwd.pool_bytes) == 3 and not any(fwd.pool_bytes.values())
    fwd.forward(*a, iters=1)  # evicted: captured again
    assert fwd.stats == {"compiles": 5, "hits": 1, "evictions": 2}
    fwd.forward(*a, iters=1, policy="bf16_infer")  # another preset, another key
    assert fwd.stats["compiles"] == 6
    assert sorted(k[-1] for k in fwd.pool_bytes) == ["bf16_infer", "f32", "f32"]
    fwd.clear()
    assert not fwd.pool_bytes


def test_shape_cache_metrics_fold_the_models_flow(tiny_model):
    g = np.random.default_rng(1)
    fwd = ShapeCachedForward(tiny_model)
    i1, i2 = _imgs(g, 2, 32, 40)
    gt = g.normal(size=(2, 28, 36, 2)).astype(np.float32)
    band = (g.uniform(size=(2, 28, 36)) > 0.5).astype(np.float32)
    pad = ((2, 2), (2, 2))
    batch = {"image1": i1, "image2": i2, "flow": gt, "band": band}
    acc = fwd.metrics(batch, iters=2, acc=pmetrics.init_acc("epe_band"), kind="epe_band",
                      pad=pad)
    acc = fwd.metrics(batch, iters=2, acc=acc, kind="epe_band", pad=pad)
    _, up = tiny_model(torch.from_numpy(i1), torch.from_numpy(i2), iters=2)
    want = pmetrics.init_acc("epe_band")
    for _ in range(2):
        want = pmetrics.accumulate("epe_band", want, up, torch.from_numpy(gt),
                                   band=torch.from_numpy(band), pad=pad)
    torch.testing.assert_close(acc, want, rtol=0, atol=0)
    assert fwd.stats == {"compiles": 1, "hits": 1, "evictions": 0}
    # Warm-start metrics return the low-res flow too, under their own key.
    finit = torch.zeros(2, 4, 5, 2)
    acc2, flow_lr = fwd.metrics(batch, iters=2, acc=acc, kind="epe_band", pad=pad,
                                flow_init=finit)
    assert flow_lr.shape == (2, 4, 5, 2) and fwd.stats["compiles"] == 2
    torch.testing.assert_close(acc2, pmetrics.accumulate(
        "epe_band", acc, up, torch.from_numpy(gt), band=torch.from_numpy(band), pad=pad),
        rtol=0, atol=0)
    # Another kind or pad is another key.
    fwd.metrics({"image1": i1, "image2": i2, "flow": gt}, iters=2,
                acc=pmetrics.init_acc("epe"), kind="epe", pad=pad)
    assert fwd.stats["compiles"] == 3


def test_replays_add_the_launches_the_capture_took_back(monkeypatch):
    monkeypatch.setattr(lookup_levels, "launches", 5)
    monkeypatch.setattr(lookup_levels, "launches_by_dtype", {"float32": 5})
    monkeypatch.setattr(nconv2d_fused, "launches", 1)
    before = pipeline._launch_counts()
    lookup_levels.launches += 32  # what a capture of one forward counts
    lookup_levels.launches_by_dtype["bfloat16"] = 32
    nconv2d_fused.launches += 4
    after = pipeline._launch_counts()
    pipeline._set_launch_counts(before)
    assert pipeline._launch_counts() == (5, {"float32": 5}, 1)
    delta = pipeline._launch_delta(after, before)
    assert delta == (32, {"bfloat16": 32}, 4)
    for _ in range(3):  # three replays
        pipeline._add_launches(delta)
    assert pipeline._launch_counts() == (101, {"float32": 5, "bfloat16": 96}, 13)


# ------------------------------------------------------------ the pipeline


class _Numbers:
    def __init__(self, n, fail_at=None, shape_change_at=None):
        self.n, self.fail_at, self.shape_change_at = n, fail_at, shape_change_at

    def __len__(self):
        return self.n

    def sample(self, i):
        if i == self.fail_at:
            raise RuntimeError(f"bad sample {i}")
        h = 4 if self.shape_change_at is None or i < self.shape_change_at else 6
        return {"image1": np.full((h, 8, 3), i, np.float32), "i": i}


def test_sample_prefetcher_order_errors_and_close():
    with SamplePrefetcher(_Numbers(9), num_workers=3, lookahead=4) as sp:
        assert [s["i"] for s in sp] == list(range(9))
    sp = SamplePrefetcher(_Numbers(9, fail_at=4), num_workers=2, lookahead=2)
    got = []
    with pytest.raises(RuntimeError, match="bad sample 4"):
        for s in sp:
            got.append(s["i"])
    assert got == [0, 1, 2, 3]
    sp = SamplePrefetcher(_Numbers(50), num_workers=2)
    next(sp)
    sp.close()
    with pytest.raises(StopIteration):
        next(sp)


def test_uniform_batches_split_on_shape_change():
    samples = [_Numbers(7, shape_change_at=3).sample(i) for i in range(7)]
    assert [[s["i"] for s in b] for b in uniform_batches(samples, 2)] == [
        [0, 1], [2], [3, 4], [5, 6]]


def _stage(group):
    return ({"image1": np.stack([s["image1"] for s in group])},
            {"ids": [s["i"] for s in group]})


def test_eval_pipeline_order_errors_and_early_close():
    with EvalPipeline(_Numbers(7, shape_change_at=5), _stage, device="cpu", batch_size=2,
                      depth=2, num_workers=2) as pipe:
        got = [(tuple(b["image1"].shape), m["ids"]) for b, m in pipe
               if isinstance(b["image1"], torch.Tensor)]
    assert got == [((2, 4, 8, 3), [0, 1]), ((2, 4, 8, 3), [2, 3]), ((1, 4, 8, 3), [4]),
                   ((2, 6, 8, 3), [5, 6])]
    with pytest.raises(RuntimeError, match="bad sample 3"):
        with EvalPipeline(_Numbers(8, fail_at=3), _stage, device="cpu",
                          batch_size=2) as pipe:
            for _ in pipe:
                pass
    threads = threading.active_count()
    pipe = EvalPipeline(_Numbers(200), _stage, device="cpu", batch_size=1, depth=1)
    next(pipe)
    pipe.close()  # mid-pass: the worker and the decode pool stop
    assert not pipe._thread.is_alive()
    assert threading.active_count() <= threads


def test_throttle_and_drain_on_the_cpu():
    throttle = DispatchThrottle()
    throttle.push(torch.zeros(3))  # CPU work is done when it returns
    throttle.drain()
    assert pipeline.default_inflight("cpu") == 1 and pipeline.default_inflight("cuda") == 2
    seen = []
    with AsyncDrain(depth=2) as drain:
        for i in range(5):
            x = torch.full((2,), float(i))
            drain.submit(x, lambda a: seen.append(a.copy()))
            x += 10  # the drain holds a copy
        drain.submit((torch.ones(1), torch.zeros(2)), lambda t: seen.append(len(t)))
    assert [float(a[0]) for a in seen[:5]] == [0, 1, 2, 3, 4] and seen[5] == 2

    def boom(_):
        raise OSError("disk full")

    drain = AsyncDrain()
    drain.submit(torch.zeros(1), boom)
    with pytest.raises(OSError, match="disk full"):
        drain.close()
