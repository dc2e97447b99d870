"""The port's training data path against the JAX package's, on the CPU.

Trees in the layouts of FlyingThings3D, FlyingChairs, MPI Sintel, KITTI
and HD1K are written once per module with the JAX package's writers
(``write_pfm``, ``write_flo``, ``write_flow_kitti``; PNG frames through
OpenCV), 80x112 frames cropped to 64x96.

- Each training reader and ``fetch_training_set`` of every stage: the
  same pair lists, the same mixtures' index tables and the same
  augmentation parameters.
- ``FlowLoader``'s stream against JAX's, batch for batch with one shard:
  images within 1 level (OpenCV's resize, ``tests/test_torch_augment.py``),
  flow within 1e-4 px, validity equal.
- A mid-epoch resume equals the uninterrupted stream bit for bit; a read
  that fails once is retried with its generator rebuilt, so the stream is
  unchanged; a sample that always fails is quarantined and replaced by
  the same neighbour as in JAX's loader; when every sample is
  quarantined the loader raises.
- ``DevicePrefetcher`` on the CPU: order, memory shared with the host
  arrays, exceptions, ``close`` of a stalled worker, the depth check.
"""

import dataclasses
import os
import threading
import time

import cv2
import jax  # noqa: F401  (keeps the JAX side on the CPU, as conftest sets it)
import numpy as np
import pytest
import torch

from raft_ncup_tpu.config import DataConfig as JaxDataConfig
from raft_ncup_tpu.data import datasets as jds
from raft_ncup_tpu.data.loader import FlowLoader as JaxFlowLoader
from raft_ncup_tpu.io import write_flo, write_flow_kitti, write_pfm
from raft_ncup_tpu_torch.config import DataConfig
from raft_ncup_tpu_torch.data import datasets as pds
from raft_ncup_tpu_torch.data.device_prefetch import DevicePrefetcher
from raft_ncup_tpu_torch.data.loader import FlowLoader
from raft_ncup_tpu_torch.resilience import ChaosDataset

HW = (80, 112)
CROP = (64, 96)
FRAMES = 4
U8_ATOL, U8_SHARE, FLOW_ATOL = 1, 0.01, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small CPU runs launch many tiny ops, and
    with the test workers sharing the cores a parallel region per op waits
    on threads that are not scheduled (a run took 10x longer)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(g, n, hw=HW):
    coarse = g.uniform(0, 255, (hw[0] // 8, hw[1] // 8, 3)).astype(np.float32)
    base = cv2.resize(coarse, (hw[1], hw[0]), interpolation=cv2.INTER_CUBIC)
    return [np.clip(np.roll(base, (i, 2 * i), axis=(0, 1)) + g.normal(0, 8, base.shape),
                    0, 255).astype(np.uint8) for i in range(n)]


def _png(path, img):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    assert cv2.imwrite(str(path), img[..., ::-1])


def _write_tree(root):
    g = np.random.default_rng(0)
    flow = lambda: g.normal(0, 5, (*HW, 2)).astype(np.float32)  # noqa: E731
    for seq in ("A/0000", "B/0001"):
        frames = _frames(g, FRAMES)
        for dstype in ("frames_cleanpass", "frames_finalpass"):
            for i, f in enumerate(frames):
                _png(os.path.join(root, "things", dstype, "TRAIN", seq, "left",
                                  f"{6 + i:04d}.png"), f)
        for direction in ("into_future", "into_past"):
            d = os.path.join(root, "things", "optical_flow", "TRAIN", seq, direction, "left")
            os.makedirs(d, exist_ok=True)
            for i in range(FRAMES):
                f3 = np.concatenate([flow(), np.zeros((*HW, 1), np.float32)], -1)
                write_pfm(os.path.join(d, f"OpticalFlow_{6 + i:04d}_L.pfm"), f3)
    for scene in ("alley", "bamboo"):
        frames = _frames(g, 3)
        for dstype in ("clean", "final"):
            for i, f in enumerate(frames):
                _png(os.path.join(root, "sintel", "training", dstype, scene,
                                  f"frame_{i + 1:04d}.png"), f)
        d = os.path.join(root, "sintel", "training", "flow", scene)
        os.makedirs(d, exist_ok=True)
        for i in range(2):
            write_flo(os.path.join(d, f"frame_{i + 1:04d}.flo"), flow())
    kitti = os.path.join(root, "kitti", "training")
    os.makedirs(os.path.join(kitti, "flow_occ"), exist_ok=True)
    for i in range(2):
        f1, f2 = _frames(g, 2)
        _png(os.path.join(kitti, "image_2", f"{i:06d}_10.png"), f1)
        _png(os.path.join(kitti, "image_2", f"{i:06d}_11.png"), f2)
        write_flow_kitti(os.path.join(kitti, "flow_occ", f"{i:06d}_10.png"), flow())
    hd1k = os.path.join(root, "hd1k")
    os.makedirs(os.path.join(hd1k, "hd1k_flow_gt", "flow_occ"), exist_ok=True)
    for seq in range(2):
        for i, f in enumerate(_frames(g, 3)):
            _png(os.path.join(hd1k, "hd1k_input", "image_2", f"{seq:06d}_{i:04d}.png"), f)
            write_flow_kitti(os.path.join(hd1k, "hd1k_flow_gt", "flow_occ",
                                          f"{seq:06d}_{i:04d}.png"), flow())
    chairs = os.path.join(root, "chairs")
    os.makedirs(chairs, exist_ok=True)
    for i in range(4):
        f1, f2 = _frames(g, 2)
        _png(os.path.join(chairs, f"{i + 1:05d}_img1.png"), f1)
        _png(os.path.join(chairs, f"{i + 1:05d}_img2.png"), f2)
        write_flo(os.path.join(chairs, f"{i + 1:05d}_flow.flo"), flow())


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_data"))
    _write_tree(root)
    kw = dict(root_things=os.path.join(root, "things"), root_sintel=os.path.join(root, "sintel"),
              root_kitti=os.path.join(root, "kitti"), root_hd1k=os.path.join(root, "hd1k"),
              root_chairs=os.path.join(root, "chairs"))
    return DataConfig(**kw), JaxDataConfig(**kw)


def _lists(ds):
    return ds.image_list, ds.flow_list


def test_training_readers_list_the_same_pairs(roots):
    cfg, _ = roots
    for dstype in ("frames_cleanpass", "frames_finalpass"):
        ours = pds.FlyingThings3D(root=cfg.root_things, dstype=dstype)
        ref = jds.FlyingThings3D(root=cfg.root_things, dstype=dstype)
        assert len(ours) == 2 * 2 * (FRAMES - 1) and _lists(ours) == _lists(ref)
    ours, ref = pds.HD1K(root=cfg.root_hd1k), jds.HD1K(root=cfg.root_hd1k)
    assert len(ours) == 4 and _lists(ours) == _lists(ref)
    for ours, ref in ((pds.MpiSintel(root=cfg.root_sintel), jds.MpiSintel(root=cfg.root_sintel)),
                      (pds.KITTI(root=cfg.root_kitti), jds.KITTI(root=cfg.root_kitti))):
        assert len(ours) > 0 and _lists(ours) == _lists(ref)
    # The compressed form globs webp frames: none here.
    assert len(pds.FlyingThings3D(root=cfg.root_things, load_compressed=True)) == 0


def _augmentor_fields(ds):
    return None if ds.augmentor is None else dataclasses.asdict(ds.augmentor)


def _structure(ds):
    if hasattr(ds, "_table"):
        return ("mixed", ds._table, [(len(p), w, _augmentor_fields(p), _lists(p))
                                     for p, w in ds.parts])
    return ("flat", _augmentor_fields(ds), _lists(ds))


@pytest.mark.parametrize("stage", ["chairs", "things", "sintel", "kitti"])
def test_fetch_training_set_matches_jax(roots, stage):
    cfg, jcfg = roots
    ours = pds.fetch_training_set(stage, CROP, cfg)
    ref = jds.fetch_training_set(stage, CROP, jcfg)
    assert len(ours) == len(ref) > 0
    assert _structure(ours) == _structure(ref)
    if stage == "sintel":  # the 100/100/200/5/1 mixture
        assert [w for _, w in ours.parts] == [100, 100, 200, 5, 1]


def test_the_synthetic_fallback_serves_the_loader(tmp_path):
    cfg = DataConfig(root_things=str(tmp_path / "none"), synthetic_ok=True)
    ds = pds.fetch_training_set("things", CROP, cfg)
    assert len(pds.fetch_training_set("things", CROP, DataConfig(
        root_things=str(tmp_path / "none")))) == 0
    batch = next(FlowLoader(ds, 2, num_workers=1, shard_index=0, num_shards=1).batches())
    assert batch["image1"].dtype == np.uint8 and batch["image1"].shape == (2, *CROP, 3)
    assert batch["flow"].dtype == np.float32 and batch["valid"].shape == (2, *CROP)


def _assert_batches_close(ours, ref):
    assert set(ours) == set(ref)
    for k in ("image1", "image2"):
        d = np.abs(ours[k].astype(np.int32) - ref[k].astype(np.int32))
        assert ours[k].dtype == np.uint8 and d.max() <= U8_ATOL
        assert (d > 0).mean() <= U8_SHARE
    np.testing.assert_allclose(ours["flow"], ref["flow"], rtol=0, atol=FLOW_ATOL)
    np.testing.assert_array_equal(ours["valid"], ref["valid"])


def _take(it, n):
    out = [next(it) for _ in range(n)]
    it.close()
    return out


@pytest.mark.parametrize("stage,n", [("things", 3), ("sintel", 2)])
def test_loader_stream_matches_jax(roots, stage, n):
    cfg, jcfg = roots
    kw = dict(seed=3, num_workers=2, shard_index=0, num_shards=1)
    ours = FlowLoader(pds.fetch_training_set(stage, CROP, cfg), 2, **kw)
    ref = JaxFlowLoader(jds.fetch_training_set(stage, CROP, jcfg), 2, **kw)
    assert len(ours) == len(ref)
    for a, b in zip(_take(ours.batches(), n), _take(ref.batches(), n)):
        _assert_batches_close(a, b)


def _bitwise(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_loader_resumes_mid_epoch_and_across_epochs(roots):
    cfg, _ = roots
    loader = FlowLoader(pds.fetch_training_set("things", CROP, cfg), 4, seed=1,
                        num_workers=2, shard_index=0, num_shards=1)
    per_epoch = len(loader)
    whole = _take(loader.batches(), per_epoch + 2)
    _bitwise(_take(loader.batches(0, 2), 1)[0], whole[2])
    _bitwise(_take(loader.batches(1, 1), 1)[0], whole[per_epoch + 1])
    # One epoch's pass equals the stream's first epoch.
    for a, b in zip(loader.one_epoch(0), whole[:per_epoch]):
        _bitwise(a, b)


class _Failing:
    """A dataset whose reads of ``bad`` always raise ``OSError``."""

    def __init__(self, ds, bad):
        self._ds, self._bad = ds, set(bad)

    def __len__(self):
        return len(self._ds)

    def sample(self, index, rng=None):
        if index in self._bad:
            raise OSError(f"unreadable sample {index}")
        return self._ds.sample(index, rng)


def test_a_failed_read_retries_then_quarantines_as_jaxs_loader(roots):
    cfg, jcfg = roots
    kw = dict(seed=5, num_workers=1, shard_index=0, num_shards=1, io_retries=1,
              io_retry_backoff_s=0.0)
    clean = FlowLoader(pds.fetch_training_set("things", CROP, cfg), 2, **kw)
    first = _take(clean.batches(), 2)
    # A read that fails once: retried with its generator rebuilt, so the
    # stream is unchanged.
    flaky = FlowLoader(ChaosDataset(pds.fetch_training_set("things", CROP, cfg),
                                    frozenset({0})), 2, **kw)
    for a, b in zip(_take(flaky.batches(), 2), first):
        _bitwise(a, b)
    assert flaky.retry_stats.retries == 1 and not flaky.retry_stats.quarantined
    # A sample that always fails: quarantined, replaced by the same
    # neighbour in both packages.
    bad = int(clean._epoch_indices(0)[1])
    ours = FlowLoader(_Failing(pds.fetch_training_set("things", CROP, cfg), [bad]), 2, **kw)
    ref = JaxFlowLoader(_Failing(jds.fetch_training_set("things", CROP, jcfg), [bad]), 2, **kw)
    _assert_batches_close(_take(ours.batches(), 1)[0], _take(ref.batches(), 1)[0])
    assert ours.retry_stats.quarantined == [bad] and ours.retry_stats.giveups == 1
    # Every sample failing: the source is gone, and the loader says so.
    ds = pds.fetch_training_set("things", CROP, cfg)
    dead = FlowLoader(_Failing(ds, range(len(ds))), 2, **kw)
    with pytest.raises(RuntimeError, match="quarantined"):
        next(dead.batches())


def _host_batches(n, size=3):
    for i in range(n):
        yield {"image1": np.full((1, size, size, 3), i, np.uint8),
               "flow": np.full((1, size, size, 2), float(i), np.float32),
               "extra_info": [("scene", i)]}


def test_device_prefetcher_on_the_cpu_keeps_order_and_memory():
    host = list(_host_batches(5))
    with DevicePrefetcher(iter(host), depth=2, device="cpu") as pf:
        got = list(pf)
    assert len(got) == 5
    for i, (g, h) in enumerate(zip(got, host)):
        assert set(g) == {"image1", "flow"}  # extra_info dropped
        assert isinstance(g["flow"], torch.Tensor) and float(g["flow"][0, 0, 0, 0]) == i
        assert g["image1"].data_ptr() == h["image1"].ctypes.data  # no copy on the CPU
    with pytest.raises(StopIteration):
        next(pf)
    with pytest.raises(ValueError, match="depth"):
        DevicePrefetcher(iter(host), depth=0, device="cpu")


def test_device_prefetcher_raises_worker_errors_and_closes_a_stalled_worker():
    def broken():
        yield from _host_batches(1)
        raise OSError("disk gone")

    pf = DevicePrefetcher(broken(), depth=2, device="cpu")
    next(pf)
    with pytest.raises(OSError, match="disk gone"):
        next(pf)
    closed = threading.Event()

    def endless():
        try:
            i = 0
            while True:
                yield from _host_batches(1)
                i += 1
        finally:
            closed.set()

    pf = DevicePrefetcher(endless(), depth=1, device="cpu")
    time.sleep(0.3)  # the worker fills the queue and waits on it
    t0 = time.perf_counter()
    pf.close()
    assert time.perf_counter() - t0 < 5 and not pf._thread.is_alive()
    assert closed.is_set()  # the wrapped generator was closed
    pf.close()  # idempotent
