"""Base layers: convolution and normalization (port of
``raft_ncup_tpu/nn/layers.py``), NCHW inside.

``Conv2d`` pads kernel//2 per axis by default (the scheme of every conv
in the model) and initializes like torch: kernel and bias
U(-1/sqrt(fan_in), 1/sqrt(fan_in)), or, with ``init_mode='kaiming_out'``
(the encoders), kernel N(0, 2/fan_out). Initialization draws from an
explicit ``torch.Generator`` (:func:`init_weights`), so a seed gives the
same weights on every device.

``BatchNorm2d`` trains as flax's ``BatchNorm`` does (biased batch
variance in the running average); :func:`frozen_batch_stats` keeps its
running statistics still while a checkpointed forward is recomputed.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
from torch import nn


def _pair(v) -> tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with k//2 padding by default and a seeded init."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size=3,
        stride=1,
        dilation=1,
        padding=None,
        bias: bool = True,
        init_mode: str = "torch",
    ):
        kh, kw = _pair(kernel_size)
        if padding is None:
            padding = (kh // 2, kw // 2)
        if init_mode not in ("torch", "kaiming_out"):
            raise ValueError(f"unknown init_mode: {init_mode!r}")
        self.init_mode = init_mode
        super().__init__(
            in_channels, out_channels, (kh, kw), stride=stride,
            padding=padding, dilation=dilation, bias=bias,
        )

    def reset_parameters(self) -> None:
        # Weights are drawn by init_weights() from an explicit generator.
        pass

    @torch.no_grad()
    def init_from(self, gen: torch.Generator) -> None:
        cout, cin, kh, kw = self.weight.shape
        fan_in = cin * kh * kw
        if self.init_mode == "torch":
            b = math.sqrt(1.0 / fan_in)
            self.weight.copy_(torch.rand(self.weight.shape, generator=gen) * 2 * b - b)
        else:
            std = math.sqrt(2.0 / (cout * kh * kw))
            self.weight.copy_(torch.randn(self.weight.shape, generator=gen) * std)
        if self.bias is not None:
            b = 1.0 / math.sqrt(fan_in)
            self.bias.copy_(torch.rand(self.bias.shape, generator=gen) * 2 * b - b)


_frozen = threading.local()


@contextlib.contextmanager
def frozen_batch_stats():
    """Within this context (on this thread) a training ``BatchNorm2d``
    normalizes with its batch statistics but leaves its running statistics
    as they are: the recompute context of a checkpointed forward, so each
    forward updates them once, as the JAX model's scan carry does."""
    prev = getattr(_frozen, "on", False)
    _frozen.on = True
    try:
        yield
    finally:
        _frozen.on = prev


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm as flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``.

    In eval mode it normalizes with the running statistics, as torch does.
    In training mode it normalizes with the batch mean and biased variance,
    as torch does, but updates the running variance with the biased
    variance (torch uses the unbiased one): ``running = 0.9 running + 0.1
    batch`` for both. The batch variance is E[x^2] - E[x]^2, clipped at
    zero, as flax computes it."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp(min=0.0)
        if not getattr(_frozen, "on", False):
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(m * mean.detach())
                self.running_var.mul_(1.0 - m).add_(m * var.detach())
                self.num_batches_tracked.add_(1)
        mul = (torch.rsqrt(var + self.eps) * self.weight).view(1, -1, 1, 1)
        y = (xf - mean.view(1, -1, 1, 1)) * mul + self.bias.view(1, -1, 1, 1)
        return y.to(x.dtype)


def Norm(kind: str, channels: int) -> nn.Module:
    """Normalization by name, as the encoders use it: 'batch'
    (:class:`BatchNorm2d`, eps 1e-5), 'instance' (per-sample, per-channel,
    no affine), 'none' (identity). 'group' lands with the small model's
    slice."""
    if kind == "batch":
        return BatchNorm2d(channels)
    if kind == "instance":
        return nn.InstanceNorm2d(channels, eps=1e-5, affine=False)
    if kind == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm kind: {kind!r}")


@torch.no_grad()
def init_weights(module: nn.Module, gen: torch.Generator) -> None:
    """Seeded initialization of every parameter under ``module``, in
    module order: convs by their ``init_mode``, BatchNorm to the
    identity, and any module with an ``init_from(gen)`` method by it."""
    for m in module.modules():
        if hasattr(m, "init_from"):
            m.init_from(gen)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
