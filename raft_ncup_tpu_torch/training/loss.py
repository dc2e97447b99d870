"""Sequence loss and training metrics (port of
``raft_ncup_tpu/training/loss.py``).

Gamma-weighted L1 over the per-iteration flow predictions, as the
reference computes it: the per-iteration term is ``mean(valid * |pred -
gt|)`` over all elements (invalid pixels count in the denominator);
validity is ``valid >= 0.5`` and ``|flow_gt| < max_flow`` (the
configuration's ``TrainConfig.max_flow``, 400 by default); the metrics
(epe, 1px, 3px, 5px) are taken on the final prediction over valid pixels,
from their sums and count (:func:`sequence_loss_sums`), which a
data-parallel step reduces across the ranks before it divides.
"""

from __future__ import annotations

import torch


def sequence_loss_sums(
    flow_preds: torch.Tensor,
    flow_gt: torch.Tensor,
    valid: torch.Tensor,
    gamma: float = 0.8,
    max_flow: float = 400.0,
    shards: int = 1,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The loss and the metrics' sums over valid pixels with their count
    (``"valid"``): what a data-parallel step reduces across ranks, since a
    mean over valid pixels is not the mean of the ranks' means. On one of
    ``shards`` equal bands of rows (the spatial axis) each term's mean is
    divided by ``shards``: the band's share of the whole image's mean, so
    the sum over the bands is the whole image's loss."""
    n = flow_preds.shape[0]
    mag = torch.sqrt(torch.sum(flow_gt**2, dim=-1))
    valid = (valid >= 0.5) & (mag < max_flow)
    vmask = valid[None, ..., None].to(flow_preds.dtype)
    weights = gamma ** torch.arange(
        n - 1, -1, -1, dtype=flow_preds.dtype, device=flow_preds.device
    )
    per_iter = torch.mean(vmask * (flow_preds - flow_gt[None]).abs(), dim=(1, 2, 3, 4)) / shards
    loss = torch.sum(weights * per_iter)

    with torch.no_grad():
        epe = torch.sqrt(torch.sum((flow_preds[-1] - flow_gt) ** 2, dim=-1))
        v = valid.to(epe.dtype)
        sums = {
            "epe": (epe * v).sum(),
            "1px": ((epe < 1).to(epe.dtype) * v).sum(),
            "3px": ((epe < 3).to(epe.dtype) * v).sum(),
            "5px": ((epe < 5).to(epe.dtype) * v).sum(),
            "valid": v.sum(),
        }
    return loss, sums


def finalize_metrics(sums: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The metrics (means over valid pixels) from :func:`sequence_loss_sums`'
    sums and count."""
    denom = sums["valid"].clamp(min=1.0)
    return {k: v / denom for k, v in sums.items() if k != "valid"}


def sequence_loss(
    flow_preds: torch.Tensor,
    flow_gt: torch.Tensor,
    valid: torch.Tensor,
    gamma: float = 0.8,
    max_flow: float = 400.0,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """flow_preds (T, B, H, W, 2), flow_gt (B, H, W, 2), valid (B, H, W)
    -> (scalar loss, metrics of 0-d tensors on the device)."""
    loss, sums = sequence_loss_sums(flow_preds, flow_gt, valid, gamma, max_flow)
    with torch.no_grad():
        metrics = finalize_metrics(sums)
    return loss, metrics
