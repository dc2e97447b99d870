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
  *before* the update;
- under ``freeze_raft`` only the upsampler's parameters are trainable
  (``multi_transform`` with ``set_to_zero`` for the rest), and the clip
  reads the norm of their gradients only.

The schedule is the JAX ``onecycle_linear`` (torch's ``OneCycleLR`` with
linear annealing, over ``num_steps + 100`` steps) or ``step_lr``; both
take the count as a 0-d tensor and stay on its device, so a step reads
nothing back to the host. :meth:`Optimizer.update` returns the candidate
parameters, moments and count without writing them, so the divergence
sentinel can keep the old ones with a select.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

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
    """sqrt of the sum of squares of every element, as ``optax.global_norm``
    (a norm per tensor, by one multi-tensor launch, then their norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


@torch.no_grad()
def select_into(dsts: Sequence[torch.Tensor], srcs: Sequence[torch.Tensor],
                keep_old: torch.Tensor) -> None:
    """``dst.copy_(torch.where(keep_old, dst, src))`` for each pair, in a
    few launches: the tensors of each dtype are flattened into one buffer,
    selected once and copied back by one multi-tensor copy."""
    groups: dict = {}
    for d, s in zip(dsts, srcs):
        groups.setdefault(d.dtype, []).append((d, s))
    for pairs in groups.values():
        d_list = [d for d, _ in pairs]
        flat = torch.where(keep_old, torch.cat([d.reshape(-1) for d in d_list]),
                           torch.cat([s.reshape(-1) for _, s in pairs]))
        views = [v.view_as(d) for v, d in zip(flat.split([d.numel() for d in d_list]), d_list)]
        torch._foreach_copy_(d_list, views)


class Optimizer:
    """Global-norm clip, then AdamW or Adam with the configured schedule,
    over ``params`` (a list of tensors). Holds the moments ``mu`` and
    ``nu`` (zero at first) of the trainable parameters and the update
    ``count`` (a 0-d int32 tensor on the parameters' device).

    ``trainable`` (one bool per parameter; all by default) freezes the
    others, as the JAX package's ``multi_transform`` with ``set_to_zero``
    does for ``freeze_raft``: a frozen parameter gets no update, no weight
    decay and no moments, and the clip takes the norm of the trainable
    gradients only (:meth:`clip_norm`).

    The update runs as multi-tensor (``torch._foreach_*``) ops, a few
    launches for all parameters together."""

    b1 = 0.9
    b2 = 0.999

    def __init__(self, params: Sequence[torch.Tensor], cfg: TrainConfig,
                 trainable: Optional[Sequence[bool]] = None):
        name = cfg.optimizer.lower()
        if name not in ("adamw", "adam"):
            raise NotImplementedError(f"{cfg.optimizer} optimizer is not implemented!")
        params = list(params)
        trainable = [True] * len(params) if trainable is None else list(trainable)
        if len(trainable) != len(params) or not any(trainable):
            raise ValueError("trainable needs one flag per parameter, at least one set")
        self.train_idx = [i for i, t in enumerate(trainable) if t]
        self.params = [params[i] for i in self.train_idx]
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

    def trainable_grads(self, grads: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """The gradients of the trainable parameters, from one per parameter."""
        return [grads[i] for i in self.train_idx]

    def clip_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global norm the clip reads: over the trainable gradients of
        ``grads`` (one per parameter)."""
        return global_norm(self.trainable_grads(grads))

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], grad_norm: torch.Tensor):
        """Candidate ``(params, mu, nu, count)`` of the trainable parameters
        after one update with ``grads`` (one per parameter the optimizer was
        built over), where ``grad_norm`` is :meth:`clip_norm`'s; nothing is
        written."""
        grads = self.trainable_grads(grads)
        # Clipping scales by clip / norm only when the norm reaches the clip.
        factor = torch.where(grad_norm < self.clip, torch.ones_like(grad_norm),
                             self.clip / grad_norm)
        count_inc = self.count + 1
        c = count_inc.to(torch.float32)
        # A Python float to the power of a tensor: a tensor made from b1
        # on the card would be a host-to-device copy that synchronises.
        bc1 = 1.0 - torch.pow(self.b1, c)
        bc2 = 1.0 - torch.pow(self.b2, c)
        g = torch._foreach_mul(grads, factor)
        mu = torch._foreach_mul(self.mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1 - self.b1)
        nu = torch._foreach_mul(self.nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(g, g), alpha=1 - self.b2)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        if self.wdecay:
            torch._foreach_add_(u, self.params, alpha=self.wdecay)
        torch._foreach_mul_(u, -self.lr())
        new_p = torch._foreach_add(self.params, u)
        return new_p, mu, nu, count_inc

    @torch.no_grad()
    def commit(self, new_p, new_mu, new_nu, new_count, keep_old: torch.Tensor) -> None:
        """Write a candidate from :meth:`update`, selecting each value on
        the device: the old one where ``keep_old`` (a 0-d bool tensor) is
        true."""
        select_into([*self.params, *self.mu, *self.nu, self.count],
                    [*new_p, *new_mu, *new_nu, new_count], keep_old)

    def state_dict(self) -> dict:
        return {"mu": [t.clone() for t in self.mu], "nu": [t.clone() for t in self.nu],
                "count": self.count.clone()}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        if len(state["mu"]) != len(self.mu):
            raise ValueError(f"the saved optimizer holds {len(state['mu'])} moments, this "
                             f"one {len(self.mu)} (another model or freeze_raft setting)")
        for dst, src in zip(self.mu, state["mu"]):
            dst.copy_(src)
        for dst, src in zip(self.nu, state["nu"]):
            dst.copy_(src)
        self.count.copy_(state["count"])
