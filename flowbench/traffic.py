"""The benchmark's inputs, made on the device from the run's seed: smooth
textured frames, a smooth flow and the second frame warped by it (the
``smooth`` pairs of the port's ``data/synthetic.py``, copied here so the
traffic cannot move with the program, and made many at once).

Every seed gives the same sizes; only the pixels and the flows differ,
so two seeds ask the same work of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flowbench.weights import sub_seed


def _smooth(gen, n: int, channels: int, hw: tuple, scale: int, device) -> torch.Tensor:
    """(n, channels, h, w) noise drawn on a grid ``scale`` times coarser,
    bicubically upsampled."""
    h, w = hw
    low = torch.randn((n, channels, max(2, h // scale), max(2, w // scale)), generator=gen,
                      device=device)
    return F.interpolate(low, size=(h, w), mode="bicubic", align_corners=False)


def make_pairs(seed: int, n: int, hw: tuple, device, stream: int = 2,
               max_mag: float = 12.0, chunk: int = 16) -> dict:
    """``n`` pairs at ``hw``: uint8 ``image1``/``image2`` (n, h, w, 3),
    float32 ``flow`` (n, h, w, 2) mapping frame 1 to frame 2, ``valid``
    (n, h, w) ones. Made ``chunk`` pairs a call, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, stream))
    h, w = hw
    y, x = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                          torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
    grid = torch.stack([x, y], dim=-1)
    out = {"image1": [], "image2": [], "flow": []}
    for start in range(0, n, chunk):
        m = min(chunk, n - start)
        tex = _smooth(gen, m, 3, hw, 8, device)
        lo = tex.amin(dim=(1, 2, 3), keepdim=True)
        hi = tex.amax(dim=(1, 2, 3), keepdim=True)
        img1 = torch.floor((tex - lo) / (hi - lo + 1e-6) * 255.0)
        flow = _smooth(gen, m, 2, hw, 32, device).permute(0, 2, 3, 1) * (max_mag / 2.0)
        # Backward warp: image2(x) = image1(x - flow), borders reflected.
        pts = grid - flow
        norm = torch.stack([pts[..., 0] * (2.0 / max(w - 1, 1)) - 1.0,
                            pts[..., 1] * (2.0 / max(h - 1, 1)) - 1.0], dim=-1)
        img2 = F.grid_sample(img1, norm, mode="bilinear", padding_mode="reflection",
                             align_corners=True)
        out["image1"].append(img1.permute(0, 2, 3, 1).clamp(0, 255).round().to(torch.uint8))
        out["image2"].append(img2.permute(0, 2, 3, 1).clamp(0, 255).round().to(torch.uint8))
        out["flow"].append(flow)
    pairs = {k: torch.cat(v) for k, v in out.items()}
    pairs["valid"] = torch.ones((n, h, w), device=device)
    return pairs


def order(seed: int, n: int, count: int) -> list:
    """``count`` indices into ``n`` items: each item in turn, from a
    start and in a cyclic order drawn from the seed, so every seed asks
    for each item as often."""
    gen = torch.Generator().manual_seed(sub_seed(seed, 3))
    perm = torch.randperm(n, generator=gen).tolist()
    return [perm[i % n] for i in range(count)]
