"""The divergence sentinel (port of ``raft_ncup_tpu/resilience/anomaly.py``).

A step is bad when its loss or gradient norm is not finite, or when the
gradient norm spikes above ``sentinel_spike_factor`` times its running
average (an EMA of decay ``sentinel_ema_decay``, armed after
``sentinel_warmup`` good steps): the ``TrainConfig`` fields, with the JAX
package's defaults. A bad step keeps
the parameters, the optimizer's moments and count, and the BatchNorm
statistics bit for bit (the train step selects on the device), while the
step counter still advances. The counters live on the device as 0-d
tensors; nothing is read back to the host per step.
"""

from __future__ import annotations

import torch

from raft_ncup_tpu_torch.config import TrainConfig


def init_sentinel(device) -> dict[str, torch.Tensor]:
    return {
        "skipped": torch.zeros((), dtype=torch.int32, device=device),
        "consecutive": torch.zeros((), dtype=torch.int32, device=device),
        "good": torch.zeros((), dtype=torch.int32, device=device),
        "ema_grad_norm": torch.zeros((), dtype=torch.float32, device=device),
    }


@torch.no_grad()
def judge(
    sentinel: dict[str, torch.Tensor],
    loss: torch.Tensor,
    grad_norm: torch.Tensor,
    cfg: TrainConfig,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(bad, the updated counters) for one step under ``cfg``'s sentinel
    settings; ``bad`` is a 0-d bool tensor."""
    finite = torch.isfinite(loss) & torch.isfinite(grad_norm)
    warmed = sentinel["good"] >= cfg.sentinel_warmup
    spike = warmed & (grad_norm > cfg.sentinel_spike_factor * sentinel["ema_grad_norm"])
    bad = ~finite | spike
    bad_i = bad.to(torch.int32)
    ema = torch.where(
        bad,
        sentinel["ema_grad_norm"],
        torch.where(
            sentinel["good"] == 0,
            grad_norm,
            cfg.sentinel_ema_decay * sentinel["ema_grad_norm"]
            + (1.0 - cfg.sentinel_ema_decay) * grad_norm,
        ),
    )
    return bad, {
        "skipped": sentinel["skipped"] + bad_i,
        "consecutive": torch.where(bad, sentinel["consecutive"] + 1, 0).to(torch.int32),
        "good": sentinel["good"] + (1 - bad_i),
        "ema_grad_norm": ema,
    }
