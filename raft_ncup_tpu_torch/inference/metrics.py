"""Validation metrics folded on the device (port of
``raft_ncup_tpu/inference/metrics.py``).

Each batch folds into a small float32 accumulator of sums on the model's
device, inside the same captured forward as the model
(``inference/pipeline.ShapeCachedForward.metrics``); a validation pass
pulls the handful of sums once at its end, never a flow field.

Accumulator layouts (float32 sums, as the JAX package keeps them, so the
two packages' sums agree):

- ``"epe"``      (2,) ``[epe_sum, n_px]``: chairs, synthetic-smooth;
- ``"px"``       (5,) ``[epe_sum, n_px, n_lt_1px, n_lt_3px, n_lt_5px]``:
  Sintel;
- ``"kitti"``    (4,) ``[frame_epe_mean_sum, n_frames, n_outliers,
  n_valid_px]``: per-frame EPE mean, pixel-pooled F1;
- ``"epe_band"`` (6,) ``[epe_sum, n_px, band_epe_sum, n_band,
  interior_epe_sum, n_interior]``: the synthetic-rigid boundary band.

Predictions padded to a stride-8 shape are cropped back to the ground
truth's shape by :func:`unpad_in_graph` (a static slice per cached
shape), so padded pixels never reach a sum.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

ACC_SIZES = {"epe": 2, "px": 5, "kitti": 4, "epe_band": 6}


def init_acc(kind: str, device="cpu") -> torch.Tensor:
    """A zeroed accumulator for ``kind`` on ``device``."""
    return torch.zeros((ACC_SIZES[kind],), dtype=torch.float32, device=device)


def unpad_in_graph(x: torch.Tensor, pad) -> torch.Tensor:
    """Crop padded (..., H, W, C) predictions back to the native shape;
    ``pad`` is ``InputPadder.pad_spec``, ``((top, bottom), (left, right))``."""
    (t, b), (le, r) = pad
    ht, wd = x.shape[-3], x.shape[-2]
    return x[..., t:ht - b, le:wd - r, :]


def accumulate(
    kind: str,
    acc: torch.Tensor,
    flow_up: torch.Tensor,
    gt: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    band: Optional[torch.Tensor] = None,
    pad=None,
) -> torch.Tensor:
    """``acc`` plus one batch's sums. ``flow_up`` is the (possibly padded)
    (B, H, W, 2) prediction, ``gt`` the native-shape ground truth,
    ``valid`` a (B, H, W) mask read as >= 0.5 (kitti), ``band`` a
    (B, H, W) 0/1 boundary mask (epe_band)."""
    if pad is not None:
        flow_up = unpad_in_graph(flow_up, pad)
    flow_up = flow_up.float()
    gt = gt.float()
    epe = torch.sqrt(torch.sum((flow_up - gt) ** 2, dim=-1))  # (B, H, W)
    n = torch.full((), float(epe.numel()), dtype=torch.float32, device=epe.device)

    if kind == "epe":
        delta = torch.stack([epe.sum(), n])
    elif kind == "px":
        delta = torch.stack([
            epe.sum(), n,
            (epe < 1.0).float().sum(), (epe < 3.0).float().sum(), (epe < 5.0).float().sum(),
        ])
    elif kind == "kitti":
        vm = (valid >= 0.5).float()
        mag = torch.sqrt(torch.sum(gt * gt, dim=-1))
        out = (epe > 3.0) & ((epe / torch.clamp(mag, min=1e-12)) > 0.05)
        nv_frame = vm.sum(dim=(1, 2))  # (B,)
        # A frame with no valid pixel adds nothing, to the sum or the count.
        has_valid = (nv_frame > 0).float()
        frame_epe = torch.sum(epe * vm, dim=(1, 2)) / torch.clamp(nv_frame, min=1.0)
        delta = torch.stack([frame_epe.sum(), has_valid.sum(), (out.float() * vm).sum(),
                             vm.sum()])
    elif kind == "epe_band":
        bm = band.float()
        delta = torch.stack([epe.sum(), n, (epe * bm).sum(), bm.sum(),
                             (epe * (1.0 - bm)).sum(), (1.0 - bm).sum()])
    else:
        raise ValueError(f"unknown metric kind: {kind!r}")
    return acc + delta


def finalize(kind: str, acc) -> dict:
    """Host sums -> the metric dict."""
    acc = np.asarray(acc, np.float64)
    if kind == "epe":
        return {"epe": float(acc[0] / acc[1])}
    if kind == "px":
        return {
            "epe": float(acc[0] / acc[1]),
            "1px": float(acc[2] / acc[1]),
            "3px": float(acc[3] / acc[1]),
            "5px": float(acc[4] / acc[1]),
        }
    if kind == "kitti":
        # Every frame without a valid pixel: 0.0, not NaN.
        return {
            "epe": float(acc[0] / acc[1]) if acc[1] else 0.0,
            "f1": 100.0 * float(acc[2] / acc[3]) if acc[3] else 0.0,
        }
    if kind == "epe_band":
        return {
            "epe": float(acc[0] / acc[1]),
            "bnd": float(acc[2] / acc[3]),
            "interior": float(acc[4] / acc[5]),
        }
    raise ValueError(f"unknown metric kind: {kind!r}")
