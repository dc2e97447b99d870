"""Sequence loss and training metrics (port of
``raft_ncup_tpu/training/loss.py``).

Gamma-weighted L1 over the per-iteration flow predictions, as the
reference computes it: the per-iteration term is ``mean(valid * |pred -
gt|)`` over all elements (invalid pixels count in the denominator);
validity is ``valid >= 0.5`` and ``|flow_gt| < max_flow`` (the
configuration's ``TrainConfig.max_flow``, 400 by default); the metrics
(epe, 1px, 3px, 5px) are taken on the final prediction over valid pixels.
"""

from __future__ import annotations

import torch


def sequence_loss(
    flow_preds: torch.Tensor,
    flow_gt: torch.Tensor,
    valid: torch.Tensor,
    gamma: float = 0.8,
    max_flow: float = 400.0,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """flow_preds (T, B, H, W, 2), flow_gt (B, H, W, 2), valid (B, H, W)
    -> (scalar loss, metrics of 0-d tensors on the device)."""
    n = flow_preds.shape[0]
    mag = torch.sqrt(torch.sum(flow_gt**2, dim=-1))
    valid = (valid >= 0.5) & (mag < max_flow)
    vmask = valid[None, ..., None].to(flow_preds.dtype)
    weights = gamma ** torch.arange(
        n - 1, -1, -1, dtype=flow_preds.dtype, device=flow_preds.device
    )
    per_iter = torch.mean(vmask * (flow_preds - flow_gt[None]).abs(), dim=(1, 2, 3, 4))
    loss = torch.sum(weights * per_iter)

    with torch.no_grad():
        epe = torch.sqrt(torch.sum((flow_preds[-1] - flow_gt) ** 2, dim=-1))
        v = valid.to(epe.dtype)
        denom = v.sum().clamp(min=1.0)

        def vmean(x):
            return (x * v).sum() / denom

        metrics = {
            "epe": vmean(epe),
            "1px": vmean((epe < 1).to(epe.dtype)),
            "3px": vmean((epe < 3).to(epe.dtype)),
            "5px": vmean((epe < 5).to(epe.dtype)),
        }
    return loss, metrics
