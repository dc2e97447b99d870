"""Host-side augmentation of optical-flow training pairs (port of
``raft_ncup_tpu/data/augment.py``, without OpenCV).

The reference's dense and sparse augmentors (photometric jitter, an
occlusion eraser, a random scale and stretch, flips, a crop), each drawing
from the caller's ``np.random.Generator`` in exactly the JAX package's
order, so a sample depends only on (seed, epoch, index) in both packages.
Colour jitter is the JAX package's numpy code as it stands.

The JAX package resizes with ``cv2.resize(..., fx, fy, INTER_LINEAR)``;
:func:`resize_linear` is that resize on numpy: the output is
``round(w fx) x round(h fy)``, a destination pixel ``d`` samples the
source at ``(d + 0.5) / f - 0.5`` with the *given* ``f`` (not the ratio of
the sizes), indices and weights are clamped at the borders as OpenCV
clamps them, float32 images take float32 weights, and uint8 images take
OpenCV's 11-bit fixed-point weights with the rounding of its vectorised
row pass. OpenCV's scalar tail of each row rounds once instead of three
times, so a few pixels may differ by one level. One case is not covered:
OpenCV switches an exact 2x downscale of both sides to ``INTER_AREA``,
which the random scales here never draw.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# ------------------------------------------------------------------ resize

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _taps(n_out: int, n_in: int, f: float):
    """Per destination index: the two source indices and their float32
    weights, as OpenCV's ``resizeGeneric`` computes them."""
    pos = ((np.arange(n_out, dtype=np.float64) + 0.5) * (1.0 / f) - 0.5).astype(np.float32)
    s = np.floor(pos)
    frac = pos - s
    s = s.astype(np.int64)
    low, high = s < 0, s >= n_in - 1
    frac[low] = 0.0
    s[low] = 0
    frac[high] = 0.0
    s[high] = n_in - 1
    return s, np.minimum(s + 1, n_in - 1), np.float32(1.0) - frac, frac


def resize_linear(img: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """``cv2.resize(img, None, fx=fx, fy=fy, interpolation=INTER_LINEAR)``
    for an (H, W) or (H, W, C) uint8 or float32 array."""
    h, w = img.shape[:2]
    w_out, h_out = int(round(w * fx)), int(round(h * fy))
    if (h_out, w_out) == (h, w):
        return img.copy()
    x0, x1, ax0, ax1 = _taps(w_out, w, fx)
    y0, y1, ay0, ay1 = _taps(h_out, h, fy)
    squeeze = img.ndim == 2
    src = img[..., None] if squeeze else img
    if img.dtype == np.uint8:
        ia = [np.rint(a * _COEF_SCALE).astype(np.int32)[:, None] for a in (ax0, ax1)]
        ib = [np.rint(b * _COEF_SCALE).astype(np.int32)[:, None, None] for b in (ay0, ay1)]
        s = src.astype(np.int32)
        rows = s[:, x0] * ia[0] + s[:, x1] * ia[1]  # (h, w_out, C), scale 2^11
        # The vectorised row pass: each row to int16 after >> 4, the high
        # half of its product with the weight, then a rounding shift by 2.
        out = ((ib[0] * (rows[y0] >> 4)) >> 16) + ((ib[1] * (rows[y1] >> 4)) >> 16)
        out = np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)
    elif img.dtype == np.float32:
        rows = src[:, x0] * ax0[:, None] + src[:, x1] * ax1[:, None]
        out = rows[y0] * ay0[:, None, None] + rows[y1] * ay1[:, None, None]
    else:
        raise TypeError(f"resize_linear takes uint8 or float32, got {img.dtype}")
    return out[..., 0] if squeeze else out


# ------------------------------------------------------------ color jitter


def _rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) float RGB in [0,1] -> HSV with hue in [0,1)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.max(axis=-1)
    minc = rgb.min(axis=-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    dz = np.maximum(delta, 1e-12)
    h = np.where(
        maxc == r,
        (g - b) / dz,
        np.where(maxc == g, 2.0 + (b - r) / dz, 4.0 + (r - g) / dz),
    )
    h = np.where(delta == 0, 0.0, h / 6.0) % 1.0
    return np.stack([h, s, v], axis=-1)


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    choices = np.stack(
        [
            np.stack([v, t, p], -1),
            np.stack([q, v, p], -1),
            np.stack([p, v, t], -1),
            np.stack([p, q, v], -1),
            np.stack([t, p, v], -1),
            np.stack([v, p, q], -1),
        ]
    )
    iy, ix = np.indices(i.shape)
    return choices[i, iy, ix]


@dataclass(frozen=True)
class ColorJitter:
    """torchvision-style photometric jitter in numpy: brightness, contrast
    and saturation multiply by U(max(0, 1-x), 1+x), hue shifts by
    U(-hue, hue) turns, in a random order."""

    brightness: float = 0.4
    contrast: float = 0.4
    saturation: float = 0.4
    hue: float = 0.5 / 3.14

    def __call__(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        x = img.astype(np.float32) / 255.0
        ops = rng.permutation(4)
        fb = rng.uniform(max(0, 1 - self.brightness), 1 + self.brightness)
        fc = rng.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
        fs = rng.uniform(max(0, 1 - self.saturation), 1 + self.saturation)
        fh = rng.uniform(-self.hue, self.hue)
        for op in ops:
            if op == 0:
                x = x * fb
            elif op == 1:
                gray_mean = (
                    0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
                ).mean()
                x = x * fc + gray_mean * (1 - fc)
            elif op == 2:
                gray = (
                    0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
                )[..., None]
                x = x * fs + gray * (1 - fs)
            else:
                hsv = _rgb_to_hsv(np.clip(x, 0.0, 1.0))
                hsv[..., 0] = (hsv[..., 0] + fh) % 1.0
                x = _hsv_to_rgb(hsv)
            x = np.clip(x, 0.0, 1.0)
        return (x * 255.0 + 0.5).astype(np.uint8)


# --------------------------------------------------------------- augmentors


def _eraser(
    img2: np.ndarray, rng: np.random.Generator, prob: float, bounds=(50, 100)
) -> np.ndarray:
    """Occlusion: paint 1-2 mean-colour rectangles onto img2 with
    probability ``prob``."""
    ht, wd = img2.shape[:2]
    if rng.random() < prob:
        img2 = img2.copy()
        mean_color = img2.reshape(-1, 3).mean(axis=0)
        for _ in range(rng.integers(1, 3)):
            x0 = rng.integers(0, wd)
            y0 = rng.integers(0, ht)
            dx = rng.integers(bounds[0], bounds[1])
            dy = rng.integers(bounds[0], bounds[1])
            img2[y0 : y0 + dy, x0 : x0 + dx, :] = mean_color
    return img2


def _rand_crop_offsets(
    rng: np.random.Generator, shape, crop_size, margins=(0, 0)
) -> tuple[int, int]:
    my, mx = margins
    max_y = shape[0] - crop_size[0]
    max_x = shape[1] - crop_size[1]
    y0 = int(np.clip(rng.integers(0, max(max_y + my, 1)), 0, max_y))
    x0 = int(np.clip(rng.integers(-mx, max(max_x + mx, 1 - mx)), 0, max_x))
    return y0, x0


@dataclass(frozen=True)
class FlowAugmentor:
    """Dense-flow augmentation (reference: core/utils/augmentor.py:13-118)."""

    crop_size: tuple[int, int]
    min_scale: float = -0.2
    max_scale: float = 0.5
    do_flip: bool = True
    spatial_aug_prob: float = 0.8
    stretch_prob: float = 0.8
    max_stretch: float = 0.2
    h_flip_prob: float = 0.5
    v_flip_prob: float = 0.1
    asymmetric_color_aug_prob: float = 0.2
    eraser_aug_prob: float = 0.5

    def __call__(self, img1, img2, flow, rng: np.random.Generator):
        jitter = ColorJitter()
        # Photometric: per frame with probability 0.2, else one jitter of
        # both frames stacked.
        if rng.random() < self.asymmetric_color_aug_prob:
            img1 = jitter(img1, rng)
            img2 = jitter(img2, rng)
        else:
            stack = jitter(np.concatenate([img1, img2], axis=0), rng)
            img1, img2 = np.split(stack, 2, axis=0)

        img2 = _eraser(img2, rng, self.eraser_aug_prob)

        # Spatial: a random log2 scale and an optional stretch, clamped so
        # the scaled image covers the crop and 8 pixels.
        ht, wd = img1.shape[:2]
        min_scale = max(
            (self.crop_size[0] + 8) / float(ht),
            (self.crop_size[1] + 8) / float(wd),
        )
        scale = 2.0 ** rng.uniform(self.min_scale, self.max_scale)
        scale_x = scale_y = scale
        if rng.random() < self.stretch_prob:
            scale_x *= 2.0 ** rng.uniform(-self.max_stretch, self.max_stretch)
            scale_y *= 2.0 ** rng.uniform(-self.max_stretch, self.max_stretch)
        scale_x = max(scale_x, min_scale)
        scale_y = max(scale_y, min_scale)

        if rng.random() < self.spatial_aug_prob:
            img1 = resize_linear(img1, scale_x, scale_y)
            img2 = resize_linear(img2, scale_x, scale_y)
            flow = resize_linear(flow, scale_x, scale_y)
            flow = flow * np.array([scale_x, scale_y], np.float32)

        if self.do_flip:
            if rng.random() < self.h_flip_prob:
                img1 = img1[:, ::-1]
                img2 = img2[:, ::-1]
                flow = flow[:, ::-1] * np.array([-1.0, 1.0], np.float32)
            if rng.random() < self.v_flip_prob:
                img1 = img1[::-1]
                img2 = img2[::-1]
                flow = flow[::-1] * np.array([1.0, -1.0], np.float32)

        y0, x0 = _rand_crop_offsets(rng, img1.shape, self.crop_size)
        ys = slice(y0, y0 + self.crop_size[0])
        xs = slice(x0, x0 + self.crop_size[1])
        return (
            np.ascontiguousarray(img1[ys, xs]),
            np.ascontiguousarray(img2[ys, xs]),
            np.ascontiguousarray(flow[ys, xs]),
        )


def resize_sparse_flow_map(flow, valid, fx=1.0, fy=1.0):
    """Resize sparse flow by scattering each valid point to its nearest
    pixel of the target grid (reference: core/utils/augmentor.py:159-191)."""
    ht, wd = flow.shape[:2]
    xx, yy = np.meshgrid(np.arange(wd), np.arange(ht))
    coords = np.stack([xx, yy], axis=-1).reshape(-1, 2).astype(np.float32)
    flow_flat = flow.reshape(-1, 2).astype(np.float32)
    keep = valid.reshape(-1) >= 1

    coords1 = coords[keep] * np.array([fx, fy], np.float32)
    flow1 = flow_flat[keep] * np.array([fx, fy], np.float32)

    ht1 = int(round(ht * fy))
    wd1 = int(round(wd * fx))
    xi = np.round(coords1[:, 0]).astype(np.int32)
    yi = np.round(coords1[:, 1]).astype(np.int32)
    inside = (xi > 0) & (xi < wd1) & (yi > 0) & (yi < ht1)

    flow_img = np.zeros((ht1, wd1, 2), np.float32)
    valid_img = np.zeros((ht1, wd1), np.int32)
    flow_img[yi[inside], xi[inside]] = flow1[inside]
    valid_img[yi[inside], xi[inside]] = 1
    return flow_img, valid_img


@dataclass(frozen=True)
class SparseFlowAugmentor:
    """Sparse-flow (KITTI, HD1K) augmentation (reference:
    core/utils/augmentor.py:120-244): symmetric colour jitter with weaker
    factors, an isotropic scale, a horizontal flip only, and a crop biased
    by (y 20, x 50) margins."""

    crop_size: tuple[int, int]
    min_scale: float = -0.2
    max_scale: float = 0.5
    do_flip: bool = False
    spatial_aug_prob: float = 0.8
    h_flip_prob: float = 0.5
    eraser_aug_prob: float = 0.5

    def __call__(self, img1, img2, flow, valid, rng: np.random.Generator):
        jitter = ColorJitter(0.3, 0.3, 0.3, 0.3 / 3.14)
        stack = jitter(np.concatenate([img1, img2], axis=0), rng)
        img1, img2 = np.split(stack, 2, axis=0)

        img2 = _eraser(img2, rng, self.eraser_aug_prob)

        ht, wd = img1.shape[:2]
        min_scale = max(
            (self.crop_size[0] + 1) / float(ht),
            (self.crop_size[1] + 1) / float(wd),
        )
        scale = max(
            2.0 ** rng.uniform(self.min_scale, self.max_scale), min_scale
        )

        if rng.random() < self.spatial_aug_prob:
            img1 = resize_linear(img1, scale, scale)
            img2 = resize_linear(img2, scale, scale)
            flow, valid = resize_sparse_flow_map(flow, valid, fx=scale, fy=scale)

        if self.do_flip and rng.random() < self.h_flip_prob:
            img1 = img1[:, ::-1]
            img2 = img2[:, ::-1]
            flow = flow[:, ::-1] * np.array([-1.0, 1.0], np.float32)
            valid = valid[:, ::-1]

        y0, x0 = _rand_crop_offsets(
            rng, img1.shape, self.crop_size, margins=(20, 50)
        )
        ys = slice(y0, y0 + self.crop_size[0])
        xs = slice(x0, x0 + self.crop_size[1])
        return (
            np.ascontiguousarray(img1[ys, xs]),
            np.ascontiguousarray(img2[ys, xs]),
            np.ascontiguousarray(flow[ys, xs]),
            np.ascontiguousarray(valid[ys, xs]),
        )
