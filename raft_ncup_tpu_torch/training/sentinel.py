"""The divergence sentinel (port of ``raft_ncup_tpu/resilience/anomaly.py``).

A step is bad when its loss or gradient norm is not finite, or when the
gradient norm spikes above ``SPIKE_FACTOR`` times its running average
(armed after ``WARMUP`` good steps); the constants are the JAX
``TrainConfig`` defaults. A bad step keeps
the parameters, the optimizer's moments and count, and the BatchNorm
statistics bit for bit (the train step selects on the device), while the
step counter still advances. The counters live on the device as 0-d
tensors; nothing is read back to the host per step.
"""

from __future__ import annotations

import torch

SPIKE_FACTOR = 20.0
EMA_DECAY = 0.99
WARMUP = 10


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
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(bad, the updated counters) for one step; ``bad`` is a 0-d bool
    tensor."""
    finite = torch.isfinite(loss) & torch.isfinite(grad_norm)
    warmed = sentinel["good"] >= WARMUP
    spike = warmed & (grad_norm > SPIKE_FACTOR * sentinel["ema_grad_norm"])
    bad = ~finite | spike
    bad_i = bad.to(torch.int32)
    ema = torch.where(
        bad,
        sentinel["ema_grad_norm"],
        torch.where(
            sentinel["good"] == 0,
            grad_norm,
            EMA_DECAY * sentinel["ema_grad_norm"] + (1.0 - EMA_DECAY) * grad_norm,
        ),
    )
    return bad, {
        "skipped": sentinel["skipped"] + bad_i,
        "consecutive": torch.where(bad, sentinel["consecutive"] + 1, 0).to(torch.int32),
        "good": sentinel["good"] + (1 - bad_i),
        "ema_grad_norm": ema,
    }
