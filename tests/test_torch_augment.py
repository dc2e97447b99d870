"""The port's augmentation (``raft_ncup_tpu_torch/data/augment.py``)
against the JAX package's (``raft_ncup_tpu/data/augment.py``), on the CPU.

The same numpy inputs and a generator of the same seed go through both.

- ``ColorJitter``: bit for bit (the same numpy code).
- The resize against ``cv2.resize(INTER_LINEAR)`` at 12 scale pairs, up
  and down, with stretch: uint8 within 1 level, with the share of pixels
  that differ below ``U8_SHARE`` (OpenCV's scalar tail of each row rounds
  once where its vectorised part rounds three times); float32 flow within
  ``FLOW_ATOL`` px.
- ``FlowAugmentor`` and ``SparseFlowAugmentor`` of the JAX package's stage
  ranges: the same crop offsets, the generator left in the same state
  (every draw the same, flips included), images within 1 level, flow
  within ``FLOW_ATOL`` px, and the sparse validity and
  ``resize_sparse_flow_map`` bit for bit.
"""

import cv2
import numpy as np
import pytest

from raft_ncup_tpu.data import augment as jaug
from raft_ncup_tpu_torch.data import augment as paug

U8_ATOL = 1
U8_SHARE = 0.01
FLOW_ATOL = 1e-4
HW = (80, 112)
CROP = (64, 96)


def _pair(seed, hw=HW):
    g = np.random.default_rng(seed)
    # Smooth-ish frames: coarse noise upsampled, plus fine noise.
    coarse = g.uniform(0, 255, (hw[0] // 8, hw[1] // 8, 3)).astype(np.float32)
    base = cv2.resize(coarse, (hw[1], hw[0]), interpolation=cv2.INTER_CUBIC)
    img1 = np.clip(base + g.normal(0, 10, base.shape), 0, 255).astype(np.uint8)
    img2 = np.roll(img1, (2, 3), axis=(0, 1)).copy()
    flow = g.normal(0, 20, (*hw, 2)).astype(np.float32)
    return img1, img2, flow


def _u8_close(a, b):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert a.shape == b.shape
    assert d.max() <= U8_ATOL, d.max()
    assert (d > 0).mean() <= U8_SHARE, (d > 0).mean()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("factors", [(), (0.3, 0.3, 0.3, 0.3 / 3.14)], ids=["dense", "sparse"])
def test_color_jitter_is_bitwise_jaxs(seed, factors):
    img1, img2, _ = _pair(seed)
    stack = np.concatenate([img1, img2])
    ours = paug.ColorJitter(*factors)(stack, np.random.default_rng(seed))
    ref = jaug.ColorJitter(*factors)(stack, np.random.default_rng(seed))
    np.testing.assert_array_equal(ours, ref)


SCALES = [(1.3, 0.9), (0.77, 1.11), (1.7411, 1.5), (0.8, 0.8), (2 ** 0.8, 2 ** -0.4),
          (1.0, 1.2), (0.61, 0.73), (1.05, 1.05), (2 ** 0.5, 2 ** 0.3), (0.93, 1.41),
          (1.2345, 0.8765), (1.6, 1.6)]


@pytest.mark.parametrize("fx,fy", SCALES)
def test_resize_matches_opencv(fx, fy):
    img, _, flow = _pair(7, (54, 96))
    _u8_close(paug.resize_linear(img, fx, fy),
              cv2.resize(img, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR))
    got = paug.resize_linear(flow, fx, fy)
    want = cv2.resize(flow, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOW_ATOL)


def _record_offsets(monkeypatch, module):
    seen = []
    orig = module._rand_crop_offsets

    def rec(*args, **kwargs):
        seen.append(orig(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(module, "_rand_crop_offsets", rec)
    return seen


# The augmentation ranges of the stages (chairs, things, sintel).
DENSE = [dict(min_scale=-0.1, max_scale=1.0), dict(min_scale=-0.4, max_scale=0.8),
         dict(min_scale=-0.2, max_scale=0.6)]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("ranges", DENSE, ids=["chairs", "things", "sintel"])
def test_flow_augmentor_matches_jax(seed, ranges, monkeypatch):
    img1, img2, flow = _pair(seed)
    p_off, j_off = _record_offsets(monkeypatch, paug), _record_offsets(monkeypatch, jaug)
    pg, jg = np.random.default_rng(seed), np.random.default_rng(seed)
    ours = paug.FlowAugmentor(CROP, do_flip=True, **ranges)(img1, img2, flow, pg)
    ref = jaug.FlowAugmentor(CROP, do_flip=True, **ranges)(img1, img2, flow, jg)
    assert p_off == j_off
    assert pg.bit_generator.state == jg.bit_generator.state
    _u8_close(ours[0], ref[0])
    _u8_close(ours[1], ref[1])
    np.testing.assert_allclose(ours[2], ref[2], rtol=0, atol=FLOW_ATOL)


def _sparse(seed):
    img1, img2, flow = _pair(seed)
    valid = (np.random.default_rng(seed + 100).random(HW) > 0.6).astype(np.float32)
    return img1, img2, flow * valid[..., None], valid


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("ranges", [dict(min_scale=-0.2, max_scale=0.4, do_flip=False),
                                    dict(min_scale=-0.3, max_scale=0.5, do_flip=True)],
                         ids=["kitti", "kitti_in_sintel"])
def test_sparse_flow_augmentor_matches_jax(seed, ranges, monkeypatch):
    img1, img2, flow, valid = _sparse(seed)
    p_off, j_off = _record_offsets(monkeypatch, paug), _record_offsets(monkeypatch, jaug)
    pg, jg = np.random.default_rng(seed), np.random.default_rng(seed)
    ours = paug.SparseFlowAugmentor(CROP, **ranges)(img1, img2, flow, valid, pg)
    ref = jaug.SparseFlowAugmentor(CROP, **ranges)(img1, img2, flow, valid, jg)
    assert p_off == j_off
    assert pg.bit_generator.state == jg.bit_generator.state
    _u8_close(ours[0], ref[0])
    _u8_close(ours[1], ref[1])
    np.testing.assert_array_equal(ours[2], ref[2])
    np.testing.assert_array_equal(ours[3], ref[3])


@pytest.mark.parametrize("f", [0.8, 1.0, 1.37, 2 ** 0.5])
def test_resize_sparse_flow_map_is_bitwise_jaxs(f):
    _, _, flow, valid = _sparse(3)
    for a, b in zip(paug.resize_sparse_flow_map(flow, valid, f, f),
                    jaug.resize_sparse_flow_map(flow, valid, f, f)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
