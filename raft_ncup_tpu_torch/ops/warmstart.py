"""Forward flow interpolation for warm-starting the next frame (port of
``forward_interpolate_batch`` in ``raft_ncup_tpu/ops/warmstart.py``).

Each pixel's flow is splatted to where it lands in the next frame, and
every grid cell takes the value of the nearest surviving point. The JAX
package computes it with XLA (no Pallas), so the port's version is plain
tensor code, on the device the flow lies on:

- a point survives when its destination lies in the open interval
  (0, W) x (0, H), strictly, as in the reference;
- the nearest point is a brute-force masked distance argmin; ties go to
  the first point in index order (``torch.argmin``'s rule, which is
  ``jnp.argmin``'s);
- when no point survives, the result is zero;
- ``chunk`` queries at a time bound the transient (``chunk * H * W``
  floats a batch row).

It has no data-dependent shapes and no host synchronisation, so it can
run inside a captured CUDA graph.
"""

from __future__ import annotations

import torch


def forward_interpolate_batch(flow: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """(B, H, W, 2) flow at frame t -> (B, H, W, 2) estimate for frame
    t+1, each batch row on its own."""
    if flow.dim() != 4 or flow.shape[3] != 2:
        raise ValueError(f"flow must be (B, H, W, 2), got {tuple(flow.shape)}")
    B, ht, wd, _ = flow.shape
    n = ht * wd
    flow = flow.float()
    dx = flow[..., 0].reshape(B, n)
    dy = flow[..., 1].reshape(B, n)
    y0, x0 = torch.meshgrid(
        torch.arange(ht, dtype=torch.float32, device=flow.device),
        torch.arange(wd, dtype=torch.float32, device=flow.device), indexing="ij",
    )
    qx, qy = x0.reshape(n), y0.reshape(n)
    x1, y1 = qx + dx, qy + dy
    valid = (x1 > 0) & (x1 < wd) & (y1 > 0) & (y1 < ht)
    # Points that do not survive park at +inf, so every query prefers a
    # survivor; with none, argmin gives index 0 and the select zeroes it.
    px = torch.where(valid, x1, float("inf"))[:, None, :]
    py = torch.where(valid, y1, float("inf"))[:, None, :]
    vals = torch.stack([dx, dy], dim=-1)  # (B, N, 2)
    c = min(max(1, int(chunk)), n)
    idx = []
    for s in range(0, n, c):
        d2 = (qx[None, s:s + c, None] - px) ** 2 + (qy[None, s:s + c, None] - py) ** 2
        idx.append(torch.argmin(d2, dim=2))
    idx = torch.cat(idx, dim=1)  # (B, N)
    out = torch.gather(vals, 1, idx[..., None].expand(B, n, 2)).reshape(B, ht, wd, 2)
    return torch.where(valid.any(dim=1)[:, None, None, None], out, torch.zeros_like(out))
