"""Procedural flow pairs (port of ``raft_ncup_tpu/data/synthetic.py``,
without OpenCV).

Two styles, as in the JAX package:

- ``"smooth"``: a random textured image, a smooth random flow and the
  backward-warped second frame (dense, no discontinuities);
- ``"rigid"``: a moving background and 2-4 textured shapes, each with its
  own similarity motion, both frames rendered from the surfaces, so the
  flow is exact and sharply discontinuous at the shapes' boundaries.

The JAX package uses OpenCV's bicubic resize and bilinear remap with
reflected borders; here ``F.interpolate(mode="bicubic")`` and
``F.grid_sample(padding_mode="reflection")`` take their place, on the
device the pair is made on. The random draws come from a CPU
``torch.Generator`` seeded by ``(seed, index)``, so a pair depends only on
its index and is the same on every device up to float rounding; it is not
the JAX package's pair.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _generator(seed: int, index: int) -> torch.Generator:
    state = np.random.SeedSequence([int(seed), int(index)]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]) & 0x7FFF_FFFF_FFFF_FFFF)


def _uniform(gen, lo, hi, size=()):
    return lo + (hi - lo) * torch.rand(size, generator=gen, dtype=torch.float64)


def _smooth_noise(gen, shape_hw, scale, channels, device) -> torch.Tensor:
    """(h, w, channels) noise: N(0, 1) on a grid ``scale`` times coarser,
    bicubically upsampled."""
    h, w = shape_hw
    low = torch.randn(channels, max(2, h // scale), max(2, w // scale), generator=gen)
    up = F.interpolate(low[None].to(device), size=(h, w), mode="bicubic", align_corners=False)
    return up[0].permute(1, 2, 0)


def _norm255(t: torch.Tensor) -> torch.Tensor:
    return (t - t.min()) / (t.max() - t.min() + 1e-6) * 255.0


def _remap(img: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of an (h, w, C) image at (h, w, 2) xy pixel points,
    borders reflected."""
    h, w = img.shape[:2]
    grid = torch.stack(
        [pts[..., 0] * (2.0 / max(w - 1, 1)) - 1.0, pts[..., 1] * (2.0 / max(h - 1, 1)) - 1.0],
        dim=-1,
    )
    out = F.grid_sample(
        img.permute(2, 0, 1)[None].float(), grid[None].float(), mode="bilinear",
        padding_mode="reflection", align_corners=True,
    )
    return out[0].permute(1, 2, 0)


def _grid(h, w, device) -> torch.Tensor:
    y, x = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device), indexing="ij",
    )
    return torch.stack([x, y], dim=-1)


def _to_u8(img: torch.Tensor) -> torch.Tensor:
    return img.clamp(0, 255).round().to(torch.uint8)


def make_pair(gen, size_hw, max_mag=12.0, device="cpu") -> dict:
    """One smooth sample: textured frame, smooth flow, warped frame."""
    h, w = size_hw
    img1 = _norm255(_smooth_noise(gen, (h, w), 8, 3, device)).floor()
    flow = _smooth_noise(gen, (h, w), 32, 2, device) * (max_mag / 2.0)
    # Backward warp: image2(x) = image1(x - flow), so flow maps 1 -> 2.
    img2 = _remap(img1, _grid(h, w, device) - flow)
    return {
        "image1": _to_u8(img1), "image2": _to_u8(img2), "flow": flow.float(),
        "valid": torch.ones((h, w), dtype=torch.float32, device=device),
    }


class _Similarity:
    """2D similarity motion ``M(p) = s R (p - c) + c + d``."""

    def __init__(self, center, angle, scale, shift, device):
        self.c = torch.tensor(center, dtype=torch.float32, device=device)
        self.d = torch.tensor(shift, dtype=torch.float32, device=device)
        cos, sin = math.cos(angle) * scale, math.sin(angle) * scale
        a = np.array([[cos, -sin], [sin, cos]])
        self.A = torch.tensor(a, dtype=torch.float32, device=device)
        self.Ainv = torch.tensor(np.linalg.inv(a), dtype=torch.float32, device=device)

    def forward(self, pts):
        return (pts - self.c) @ self.A.T + self.c + self.d

    def inverse(self, pts):
        return (pts - self.c - self.d) @ self.Ainv.T + self.c


def make_rigid_pair(gen, size_hw, max_mag=12.0, n_shapes=(2, 4), device="cpu") -> dict:
    """One piecewise-rigid sample: 2-4 moving textured shapes over a
    moving background, flow exact everywhere."""
    h, w = size_hw
    pts = _grid(h, w, device)

    def motion(max_shift, max_rot_deg, max_log_scale, center):
        ang = math.radians(float(_uniform(gen, -max_rot_deg, max_rot_deg)))
        s = math.exp(float(_uniform(gen, -max_log_scale, max_log_scale)))
        theta = float(_uniform(gen, 0.0, 2 * math.pi))
        r = float(_uniform(gen, 0.25, 1.0)) * max_shift
        return _Similarity(center, ang, s, (r * math.cos(theta), r * math.sin(theta)), device)

    bg_tex = _norm255(_smooth_noise(gen, (h, w), 8, 3, device))
    bg_m = motion(max_mag / 4.0, 2.0, 0.02, ((w - 1) / 2.0, (h - 1) / 2.0))
    img1 = bg_tex.clone()
    img2 = _remap(bg_tex, bg_m.inverse(pts))
    flow = bg_m.forward(pts) - pts
    n = int(torch.randint(n_shapes[0], n_shapes[1] + 1, (), generator=gen))
    for _ in range(n):
        c = (float(_uniform(gen, 0.2 * w, 0.8 * w)), float(_uniform(gen, 0.2 * h, 0.8 * h)))
        ax = [float(v) * min(h, w) for v in _uniform(gen, 0.10, 0.28, (2,))]
        th = float(_uniform(gen, 0.0, math.pi))
        rect = float(torch.rand((), generator=gen)) < 0.4
        rot = torch.tensor([[math.cos(th), math.sin(th)], [-math.sin(th), math.cos(th)]],
                           dtype=torch.float32, device=device)
        center = torch.tensor(c, dtype=torch.float32, device=device)

        def inside(p, rot=rot, center=center, ax=ax, rect=rect):
            loc = (p - center) @ rot.T
            u, v = loc[..., 0] / ax[0], loc[..., 1] / ax[1]
            return torch.maximum(u.abs(), v.abs()) <= 1.0 if rect else u * u + v * v <= 1.0

        scale = 4 if float(torch.rand((), generator=gen)) < 0.5 else 8
        tex = _norm255(_smooth_noise(gen, (h, w), scale, 3, device))
        m = motion(0.85 * max_mag, 8.0, 0.05, c)
        mask1 = inside(pts)
        img1 = torch.where(mask1[..., None], tex, img1)
        flow = torch.where(mask1[..., None], m.forward(pts) - pts, flow)
        back = m.inverse(pts)  # frame-2 pixel -> frame-1 surface point
        img2 = torch.where(inside(back)[..., None], _remap(tex, back), img2)
    return {
        "image1": _to_u8(img1), "image2": _to_u8(img2), "flow": flow.float(),
        "valid": torch.ones((h, w), dtype=torch.float32, device=device),
    }


def flow_boundary_mask(flow, thresh: float = 2.0, band_px: int = 3) -> np.ndarray:
    """(H, W) bool mask of pixels within ``band_px`` of a flow discontinuity:
    a forward-difference gradient magnitude above ``thresh`` px, dilated by
    a (2 band_px + 1)^2 square. The JAX package dilates with ``cv2.dilate``,
    whose default border adds nothing; a max-pool pads with -inf, which is
    the same. ``flow`` is an (H, W, 2) array or tensor."""
    flow = np.asarray(flow, np.float32)
    gx = np.abs(np.diff(flow, axis=1, append=flow[:, -1:])).sum(-1)
    gy = np.abs(np.diff(flow, axis=0, append=flow[-1:])).sum(-1)
    edge = torch.from_numpy(((gx + gy) > thresh).astype(np.float32))
    k = 2 * band_px + 1
    band = F.max_pool2d(edge[None, None], k, stride=1, padding=band_px)
    return band[0, 0].numpy() > 0


class SyntheticFlowDataset:
    """Fixed-length procedural dataset: sample ``index`` depends only on
    ``(seed, index)``."""

    def __init__(self, size_hw, length=512, seed=0, max_mag=12.0, style="smooth"):
        if style not in ("smooth", "rigid"):
            raise ValueError(f"unknown synthetic style: {style!r}")
        self.size_hw = tuple(size_hw)
        self.length = length
        self.seed = seed
        self.max_mag = max_mag
        self.style = style

    def __len__(self) -> int:
        return self.length

    def sample(self, index: int, rng=None, device="cpu") -> dict:
        """Pair ``index``: uint8 images and float32 flow and valid, as
        tensors on ``device``; on the CPU these are the host arrays the
        loader (``data/loader.py``) stacks. ``rng``, the loader's
        per-sample generator, is not drawn from: the pair depends on
        ``(seed, index)`` only."""
        make = make_rigid_pair if self.style == "rigid" else make_pair
        return make(_generator(self.seed, index), self.size_hw, self.max_mag, device=device)

    def batch(self, step: int, batch_size: int, device="cpu") -> dict:
        """The batch of train step ``step``: samples ``step * batch_size``
        onwards (modulo the length), stacked, on ``device``."""
        samples = [
            self.sample((step * batch_size + i) % self.length, device=device)
            for i in range(batch_size)
        ]
        return {k: torch.stack([s[k] for s in samples]) for k in samples[0]}
