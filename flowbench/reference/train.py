"""Plain PyTorch reference of the training step (RAFT ``train.py``):
sequence loss, gradients by autograd, global-norm clip, AdamW under the
one-cycle schedule. It imports no module of the program.

The loss is RAFT's ``sequence_loss``: gamma-weighted L1 of every
iteration's flow, ``mean(valid * |pred - gt|)`` over all elements, valid
where ``valid >= 0.5`` and ``|gt| < max_flow``. The clip scales every
gradient by ``clip / norm`` when the global norm reaches ``clip``; AdamW
is Loshchilov and Hutter's decoupled decay as optax chains it
(``scale_by_adam``, ``add_decayed_weights``, then ``-lr``), the rate read
at the count before the update; the schedule is PyTorch's
``OneCycleLR(anneal_strategy='linear')`` over ``num_steps + 100`` steps.
"""

from __future__ import annotations

import torch

from flowbench.reference import model as ref

B1, B2 = 0.9, 0.999
STATS = ("running_mean", "running_var", "num_batches_tracked")


def trainable(params: dict) -> list:
    """The names of the trained tensors: all but BatchNorm's statistics."""
    return [k for k in params if k.rsplit(".", 1)[-1] not in STATS]


def onecycle_lr(max_lr: float, total_steps: int, count: int, pct_start: float = 0.05,
                div_factor: float = 25.0, final_div_factor: float = 1e4) -> float:
    initial = max_lr / div_factor
    final = initial / final_div_factor
    warm_end = pct_start * total_steps - 1.0
    ann_end = float(total_steps - 1)
    if count <= warm_end:
        return initial + min(max(count / warm_end, 0.0), 1.0) * (max_lr - initial)
    pct = min(max((count - warm_end) / (ann_end - warm_end), 0.0), 1.0)
    return max_lr + pct * (final - max_lr)


def sequence_loss(preds, flow_gt, valid, gamma: float, max_flow: float):
    n = preds.shape[0]
    mag = torch.sqrt((flow_gt ** 2).sum(-1))
    vmask = ((valid >= 0.5) & (mag < max_flow))[None, ..., None].float()
    loss = 0.0
    for i in range(n):
        loss = loss + gamma ** (n - 1 - i) * (vmask[0] * (preds[i] - flow_gt).abs()).mean()
    return loss


def train(params: dict, cfg: dict, mix: dict, batches: list, steps: int,
          on_coords=None) -> dict:
    """``steps`` steps from ``params`` on ``batches`` (dicts of image1,
    image2, flow, valid). Returns per step the loss, per trained tensor
    the norm of the first step's gradient as the clip leaves it and
    before it, and the norm of each tensor's change after ``steps``.
    ``on_coords`` sees the first step's lookup coordinates."""
    names = trainable(params)
    p = {k: v.detach().clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(p[k]) for k in names}
    nu = {k: torch.zeros_like(p[k]) for k in names}
    out = {"loss": [], "grad_norm": {}, "clipped_norm": {}, "change_norm": {}}
    for step in range(steps):
        for k in names:
            p[k].requires_grad_(True)
        b = batches[step]
        preds = ref.forward(p, cfg, b["image1"], b["image2"], mix["iters"], train=True,
                            on_coords=on_coords if step == 0 else None)
        loss = sequence_loss(preds, b["flow"], b["valid"], mix["gamma"], mix["max_flow"])
        grads = torch.autograd.grad(loss, [p[k] for k in names], allow_unused=True)
        del preds
        grads = [torch.zeros_like(p[k]) if g is None else g for k, g in zip(names, grads)]
        with torch.no_grad():
            gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
            factor = 1.0 if gnorm < mix["clip"] else mix["clip"] / gnorm
            lr = onecycle_lr(mix["lr"], mix["num_steps"] + 100, step)
            c = step + 1
            for k, g in zip(names, grads):
                g = g * float(factor)
                if step == 0:
                    out["grad_norm"][k] = float(grads[names.index(k)].double().norm())
                    out["clipped_norm"][k] = float(g.double().norm())
                mu[k] = B1 * mu[k] + (1 - B1) * g
                nu[k] = B2 * nu[k] + (1 - B2) * g * g
                u = (mu[k] / (1 - B1 ** c)) / (torch.sqrt(nu[k] / (1 - B2 ** c)) + mix["epsilon"])
                u = u + mix["wdecay"] * p[k].detach()
                p[k] = p[k].detach() - lr * u
            out["loss"].append(float(loss))
    with torch.no_grad():
        for k in names:
            out["change_norm"][k] = float((p[k] - params[k]).double().norm())
    return out
