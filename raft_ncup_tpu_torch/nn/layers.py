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
running statistics still while a checkpointed forward is recomputed, and
:func:`synced_batch_stats` makes it take its statistics over the ranks'
global batch (sync-BN).

Mixed precision, as in the JAX package: parameters live in f32. A
``Conv2d`` built with a compute ``dtype`` (bf16 under the bf16 presets)
casts its input, weight and bias to it at use and computes there; with
``dtype=None`` it follows its input and adds no cast. With a compute
dtype the bias is added after the convolution, in that dtype, as the JAX
layer adds it (cuDNN's path in PyTorch adds a bias after the convolution
too, so this costs the card nothing). Normalizations always compute in f32
and return their input's dtype.

Under the spatial axis (``parallel/halo.py``, a :func:`halo.spatial`
context), the input is a band of rows: ``Conv2d`` pads its height with
the neighbouring ranks' rows instead of zeros whenever its kernel is
taller than 1 or its stride above 1, and ``InstanceNorm2d`` takes its
statistics over the whole image, summed over the group. BatchNorm in eval
mode uses its running statistics and stays local.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F
from torch import nn

from raft_ncup_tpu_torch.parallel import halo

# Normalizations compute in f32 under every preset: PrecisionPolicy.norm.
NORM_DTYPE = torch.float32


def _pair(v) -> tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with k//2 padding by default, a seeded init and a
    compute ``dtype`` (``None``: the input's)."""

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
        dtype: torch.dtype | None = None,
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
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        padding = self.padding
        kh, sh = self.kernel_size[0], self.stride[0]
        if halo.current() is not None and (kh > 1 or sh > 1):
            # A band of rows: the neighbours' rows stand in for the zeros.
            rows = x.shape[2]  # the band starts at rank * rows
            if rows % sh:
                raise ValueError(f"a band of {rows} rows does not split at stride {sh}: "
                                 "pad the height to a multiple of 8 times the spatial size")
            top, bottom = halo.halo_rows(kh, sh, padding[0], self.dilation[0],
                                         halo.first_row(rows), rows)
            x = halo.extend(x, top, bottom)
            padding = (0, padding[1])
        if self.dtype is None:
            return F.conv2d(x, self.weight, self.bias, self.stride, padding, self.dilation,
                            self.groups)
        y = F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), None, self.stride, padding,
                     self.dilation, self.groups)
        if self.bias is None:
            return y
        return y + self.bias.to(self.dtype).view(1, -1, 1, 1)

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


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (no padding) with the seeded init of torch's
    default: kernel and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)), where
    torch reads fan_in from the (in, out, kh, kw) weight's dim 1,
    out * kh * kw."""

    def reset_parameters(self) -> None:
        # Weights are drawn by init_weights() from an explicit generator.
        pass

    @torch.no_grad()
    def init_from(self, gen: torch.Generator) -> None:
        _, cout, kh, kw = self.weight.shape
        b = 1.0 / math.sqrt(cout * kh * kw)
        self.weight.copy_(torch.rand(self.weight.shape, generator=gen) * 2 * b - b)
        if self.bias is not None:
            self.bias.copy_(torch.rand(self.bias.shape, generator=gen) * 2 * b - b)


def _norm_input(x: torch.Tensor) -> torch.Tensor:
    """A normalization's input at its compute dtype: f32, or float64 for a
    float64 input (a replay in float64 stays float64)."""
    return x.to(torch.promote_types(x.dtype, NORM_DTYPE))


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
    zero, as flax computes it. It computes in f32 (float64 for a float64
    replay) and returns the input's dtype."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)
        # Under a process group while training (sync-BN): the differentiable
        # sum over the ranks that :func:`synced_batch_stats` sets, else None.
        self.sync = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(_norm_input(x)).to(x.dtype)
        xf = _norm_input(x)
        if self.sync is None:
            mean = xf.mean(dim=(0, 2, 3))
            meansq = (xf * xf).mean(dim=(0, 2, 3))
        else:
            # The global batch's E[x] and E[x^2]: per-channel sums and the
            # count, summed over the ranks in one collective.
            c = xf.shape[1]
            count = xf.new_full((1,), xf.numel() // c)
            total = self.sync(torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
                                         count]))
            mean, meansq = total[:c] / total[-1], total[c:2 * c] / total[-1]
        var = (meansq - mean * mean).clamp(min=0.0)
        if not getattr(_frozen, "on", False):
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(m * mean.detach())
                self.running_var.mul_(1.0 - m).add_(m * var.detach())
                self.num_batches_tracked.add_(1)
        mul = (torch.rsqrt(var + self.eps) * self.weight).view(1, -1, 1, 1)
        y = (xf - mean.view(1, -1, 1, 1)) * mul + self.bias.view(1, -1, 1, 1)
        return y.to(x.dtype)


@contextlib.contextmanager
def synced_batch_stats(model: nn.Module, reduce_sum):
    """Within this context every :class:`BatchNorm2d` of ``model`` that
    trains takes its statistics over the global batch: ``reduce_sum`` (a
    differentiable sum over the ranks, ``parallel.multihost.all_reduce_grad``)
    sums each one's per-channel sums and count. The setting is on the
    modules, not the thread, so the recompute of a checkpointed forward,
    which autograd may run on its own thread, reduces as the forward did."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    prev = [m.sync for m in norms]
    for m in norms:
        m.sync = reduce_sum
    try:
        yield
    finally:
        for m, p in zip(norms, prev):
            m.sync = p


class InstanceNorm2d(nn.InstanceNorm2d):
    """Per-sample, per-channel normalization without affine, eps 1e-5,
    computed in f32 and returned in the input's dtype. On a band of rows
    the statistics are the whole image's, in two passes summed over the
    spatial group: the mean, then the mean of the centred squares."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, affine=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = _norm_input(x)
        if halo.current() is None:
            return super().forward(xf).to(x.dtype)
        n = xf.shape[2] * xf.shape[3] * halo.current().size
        mean = halo.group_sum(xf.sum(dim=(2, 3), keepdim=True)) / n
        centred = xf - mean
        var = halo.group_sum((centred * centred).sum(dim=(2, 3), keepdim=True)) / n
        return (centred * torch.rsqrt(var + self.eps)).to(x.dtype)


def Norm(kind: str, channels: int) -> nn.Module:
    """Normalization by name, as the encoders use it: 'batch'
    (:class:`BatchNorm2d`, eps 1e-5), 'instance' (per-sample, per-channel,
    no affine), 'none' (identity). No configuration of the model reaches
    the JAX package's 'group' norm: the small fnet uses 'instance' and
    the small cnet 'none'."""
    if kind == "batch":
        return BatchNorm2d(channels)
    if kind == "instance":
        return InstanceNorm2d(channels)
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
