"""Learning-rate schedules and the optimizer (port of
``raft_ncup_tpu/training/optim.py``).

The JAX package chains ``optax.clip_by_global_norm(clip)`` with
``optax.adamw`` (or ``optax.adam``) under a schedule. :class:`Optimizer`
computes the same update, term for term:

- clipping scales every gradient by ``clip / norm`` only when the global
  norm is at least ``clip`` (``torch.nn.utils.clip_grad_norm_`` divides
  by ``norm + 1e-6`` and differs);
- Adam's moments with bias correction at the incremented count, then
  ``mu_hat / (sqrt(nu_hat) + eps)``, plus ``wdecay * param`` for AdamW;
- the step is ``-lr(count)`` times that, the schedule read at the count
  *before* the update.

The schedule is the JAX ``onecycle_linear`` (torch's ``OneCycleLR`` with
linear annealing, over ``num_steps + 100`` steps) or ``step_lr``; both
take the count as a 0-d tensor and stay on its device, so a step reads
nothing back to the host. :meth:`Optimizer.update` returns the candidate
parameters, moments and count without writing them, so the divergence
sentinel can keep the old ones with a select.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from raft_ncup_tpu_torch.config import TrainConfig

Schedule = Callable[[torch.Tensor], torch.Tensor]


def onecycle_linear(
    max_lr: float,
    total_steps: int,
    pct_start: float = 0.05,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
) -> Schedule:
    """torch ``OneCycleLR(anneal_strategy='linear', cycle_momentum=False)``:
    warm-up ends at ``pct_start * total_steps - 1``, the anneal at
    ``total_steps - 1``."""
    initial = max_lr / div_factor
    final = initial / final_div_factor
    warm_end = float(pct_start * total_steps) - 1.0
    ann_end = float(total_steps - 1)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        step = count.to(torch.float32)
        warm_pct = torch.clamp(step / max(warm_end, 1e-8), 0.0, 1.0)
        up = initial + warm_pct * (max_lr - initial)
        ann_pct = torch.clamp((step - warm_end) / max(ann_end - warm_end, 1e-8), 0.0, 1.0)
        down = max_lr + ann_pct * (final - max_lr)
        return torch.where(step <= warm_end, up, down)

    return schedule


def step_lr(base_lr: float, step_size: int, gamma: float = 0.5) -> Schedule:
    """torch ``StepLR``."""

    def schedule(count: torch.Tensor) -> torch.Tensor:
        return base_lr * gamma ** torch.div(count, step_size, rounding_mode="floor").to(
            torch.float32
        )

    return schedule


def build_schedule(cfg: TrainConfig) -> Schedule:
    if cfg.scheduler.lower() == "cyclic":
        return onecycle_linear(cfg.lr, cfg.total_schedule_steps, pct_start=0.05)
    if cfg.scheduler.lower() == "step":
        return step_lr(cfg.lr, cfg.scheduler_step, 0.5)
    raise NotImplementedError(f"{cfg.scheduler} scheduler is not implemented!")


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as ``optax.global_norm``."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


class Optimizer:
    """Global-norm clip, then AdamW or Adam with the configured schedule,
    over ``params`` (a list of tensors). Holds the moments ``mu`` and
    ``nu`` (zero at first) and the update ``count`` (a 0-d int32 tensor
    on the parameters' device)."""

    b1 = 0.9
    b2 = 0.999

    def __init__(self, params: Sequence[torch.Tensor], cfg: TrainConfig):
        name = cfg.optimizer.lower()
        if name not in ("adamw", "adam"):
            raise NotImplementedError(f"{cfg.optimizer} optimizer is not implemented!")
        self.params = list(params)
        self.schedule = build_schedule(cfg)
        self.clip = float(cfg.clip)
        self.eps = float(cfg.epsilon)
        self.wdecay = float(cfg.wdecay) if name == "adamw" else 0.0
        dev = self.params[0].device
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), dtype=torch.int32, device=dev)

    def lr(self) -> torch.Tensor:
        """The learning rate the next update applies (a 0-d tensor)."""
        return self.schedule(self.count)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], grad_norm: torch.Tensor):
        """Candidate ``(params, mu, nu, count)`` after one update with
        ``grads`` (their global norm given); nothing is written."""
        trigger = grad_norm < self.clip
        count_inc = self.count + 1
        c = count_inc.to(torch.float32)
        # A Python float to the power of a tensor: a tensor made from b1
        # on the card would be a host-to-device copy that synchronises.
        bc1 = 1.0 - torch.pow(self.b1, c)
        bc2 = 1.0 - torch.pow(self.b2, c)
        step = -self.lr()
        new_p, new_mu, new_nu = [], [], []
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = torch.where(trigger, g, (g / grad_norm) * self.clip)
            mu = (1 - self.b1) * g + self.b1 * mu
            nu = (1 - self.b2) * (g * g) + self.b2 * nu
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.wdecay:
                u = u + self.wdecay * p
            new_p.append(p + u * step)
            new_mu.append(mu)
            new_nu.append(nu)
        return new_p, new_mu, new_nu, count_inc

    @torch.no_grad()
    def commit(self, new_p, new_mu, new_nu, new_count, keep_old: torch.Tensor) -> None:
        """Write a candidate from :meth:`update`, selecting each value on
        the device: the old one where ``keep_old`` (a 0-d bool tensor) is
        true."""

        def put(dst, src):
            dst.copy_(torch.where(keep_old, dst, src))

        for dst, src in zip(self.params, new_p):
            put(dst, src)
        for dst, src in zip(self.mu, new_mu):
            put(dst, src)
        for dst, src in zip(self.nu, new_nu):
            put(dst, src)
        put(self.count, new_count)

    def state_dict(self) -> dict:
        return {"mu": [t.clone() for t in self.mu], "nu": [t.clone() for t in self.nu],
                "count": self.count.clone()}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        for dst, src in zip(self.mu, state["mu"]):
            dst.copy_(src)
        for dst, src in zip(self.nu, state["nu"]):
            dst.copy_(src)
        self.count.copy_(state["count"])
