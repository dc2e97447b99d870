"""Middlebury colour-wheel flow visualization (port of
``raft_ncup_tpu/viz/flow_viz.py``, numpy only).

- :func:`flow_to_image`: normalize by the largest radius, map the angle
  onto the 55-colour Baker et al. (ICCV 2007) wheel, desaturate small
  motions toward white, zero unknown flow;
- :func:`flow_to_color`: the second wheel of the reference, built
  channel by channel; on the same inputs the two agree exactly.
"""

from __future__ import annotations

import numpy as np

UNKNOWN_FLOW_THRESH = 1e7


def make_colorwheel() -> np.ndarray:
    """The 55-entry Middlebury color wheel, (55, 3) float in [0, 255]."""
    segments = [
        (15, 0, 1, False),  # RY: red fixed, green ramps up
        (6, 1, 0, True),  # YG: green fixed, red ramps down
        (4, 1, 2, False),  # GC
        (11, 2, 1, True),  # CB
        (13, 2, 0, False),  # BM
        (6, 0, 2, True),  # MR
    ]
    wheel = np.zeros((sum(s[0] for s in segments), 3))
    col = 0
    for n, fixed, ramp, down in segments:
        wheel[col : col + n, fixed] = 255
        r = np.floor(255 * np.arange(n) / n)
        wheel[col : col + n, ramp] = 255 - r if down else r
        col += n
    return wheel


def flow_to_image(
    flow: np.ndarray,
    convert_to_bgr: bool = False,
    rad_max: float | None = None,
) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8 Middlebury color image.

    ``rad_max=None`` normalizes by the image's own max radius (reference
    behavior); pass a value to fix the scale across frames.
    """
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"flow must be (H, W, 2), got {flow.shape}")
    u = flow[:, :, 0].astype(np.float64)
    v = flow[:, :, 1].astype(np.float64)

    unknown = (np.abs(u) > UNKNOWN_FLOW_THRESH) | (
        np.abs(v) > UNKNOWN_FLOW_THRESH
    )
    u = np.where(unknown, 0.0, u)
    v = np.where(unknown, 0.0, v)

    rad = np.sqrt(u**2 + v**2)
    if rad_max is None:
        rad_max = float(rad.max()) if rad.size else 0.0
    scale = rad_max + np.finfo(np.float64).eps
    u, v, rad = u / scale, v / scale, rad / scale

    wheel = make_colorwheel() / 255.0  # (ncols, 3)
    ncols = wheel.shape[0]

    angle = np.arctan2(-v, -u) / np.pi  # [-1, 1]
    fk = (angle + 1) / 2 * (ncols - 1)  # [0, ncols-1]
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = (fk - k0)[..., None]

    col = (1 - f) * wheel[k0] + f * wheel[k1]  # (H, W, 3)

    small = (rad <= 1)[..., None]
    col = np.where(small, 1 - rad[..., None] * (1 - col), col * 0.75)
    img = np.floor(255.0 * col * ~unknown[..., None]).astype(np.uint8)
    if convert_to_bgr:
        img = img[:, :, ::-1]
    return img


def _make_colorwheel_vcn() -> np.ndarray:
    """The VCN variant's wheel (reference: core/utils/flow_viz.py:
    ``makeColorwheel``): same 55 RY/YG/GC/CB/BM/MR segments, built
    channel-by-channel the way the original does. Kept as an
    independent construction so the cross-check against
    :func:`make_colorwheel` is a real one."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[:RY, 0] = 255
    wheel[:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


def flow_to_color(
    flow: np.ndarray,
    convert_to_bgr: bool = False,
    rad_max: float | None = None,
) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8, the VCN-derived second wheel
    (reference: core/utils/flow_viz.py:145-275 ``computeColor``).

    Per-channel port of the original's loop; on shared inputs it must
    agree with :func:`flow_to_image` exactly (the two reference
    implementations encode the same map — the cross-check test pins
    that the port kept them equivalent). Same ``rad_max`` contract:
    ``None`` normalizes per frame, a value fixes the scale across
    frames.
    """
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"flow must be (H, W, 2), got {flow.shape}")
    u = flow[:, :, 0].astype(np.float64)
    v = flow[:, :, 1].astype(np.float64)

    unknown = (np.abs(u) > UNKNOWN_FLOW_THRESH) | (
        np.abs(v) > UNKNOWN_FLOW_THRESH
    )
    u = np.where(unknown, 0.0, u)
    v = np.where(unknown, 0.0, v)

    rad = np.sqrt(u**2 + v**2)
    if rad_max is None:
        rad_max = float(rad.max()) if rad.size else 0.0
    scale = rad_max + np.finfo(np.float64).eps
    u, v, rad = u / scale, v / scale, rad / scale

    wheel = _make_colorwheel_vcn()
    ncols = wheel.shape[0]
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = k0 + 1
    k1[k1 == ncols] = 0
    f = fk - k0

    img = np.zeros((*u.shape, 3), np.uint8)
    small = rad <= 1
    for ch in range(3):
        col0 = wheel[k0, ch] / 255.0
        col1 = wheel[k1, ch] / 255.0
        col = (1 - f) * col0 + f * col1
        col = np.where(small, 1 - rad * (1 - col), col * 0.75)
        img[:, :, ch] = np.floor(255.0 * col * ~unknown).astype(np.uint8)
    if convert_to_bgr:
        img = img[:, :, ::-1]
    return img
