"""Feature and context encoders (port of ``raft_ncup_tpu/nn/extractor.py``).

Stride-8 CNN, NCHW: a 7x7/s2 stem and three 2-block stages at strides 1,
2, 2, then a 1x1 output conv. The full-size encoder has a stem of 64 and
residual stages of 64 -> 96 -> 128; the small one a stem of 32 and
bottleneck stages of 32 -> 64 -> 96. Submodule names follow the
reference's torch module tree (``conv1``, ``norm1``, ``layer1.0.conv1``,
``layer2.0.downsample.0``, ...), so the carried state dict
(``utils/jax_weights.py``) keys match it. ``dtype`` is every convolution's
compute dtype (``None``: the input's); the norms compute in f32.

``dropout`` > 0 drops whole output channels per sample in training mode,
as the JAX package's ``nn.Dropout(rate, broadcast_dims=(1, 2))`` on NHWC
(``Dropout2d``'s mask): a kept channel is divided by ``1 - dropout``. The
mask draws from the ``generator`` the caller passes.
"""

from __future__ import annotations

import torch
from torch import nn

from raft_ncup_tpu_torch.nn.layers import Conv2d, Norm


class ResidualBlock(nn.Module):
    """Two 3x3 convs and an identity or 1x1 downsample shortcut."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str, stride: int = 1,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, stride=stride, init_mode="kaiming_out",
                            dtype=dtype)
        self.norm1 = Norm(norm_fn, planes)
        self.conv2 = Conv2d(planes, planes, 3, init_mode="kaiming_out", dtype=dtype)
        self.norm2 = Norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                Conv2d(in_planes, planes, 1, stride=stride, init_mode="kaiming_out",
                       dtype=dtype),
                Norm(norm_fn, planes),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 at a quarter of the planes, each conv
    normalized, and an identity or 1x1 downsample shortcut."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str, stride: int = 1,
                 dtype: torch.dtype | None = None):
        super().__init__()
        p4 = planes // 4
        self.conv1 = Conv2d(in_planes, p4, 1, init_mode="kaiming_out", dtype=dtype)
        self.norm1 = Norm(norm_fn, p4)
        self.conv2 = Conv2d(p4, p4, 3, stride=stride, init_mode="kaiming_out", dtype=dtype)
        self.norm2 = Norm(norm_fn, p4)
        self.conv3 = Conv2d(p4, planes, 1, init_mode="kaiming_out", dtype=dtype)
        self.norm3 = Norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                Conv2d(in_planes, planes, 1, stride=stride, init_mode="kaiming_out",
                       dtype=dtype),
                Norm(norm_fn, planes),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        y = torch.relu(self.norm3(self.conv3(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class Encoder(nn.Module):
    """The stride-8 encoder; ``small`` selects the bottleneck variant.
    The fnet takes instance norm; the cnet batch norm (full size) or none
    (small)."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "batch", small: bool = False,
                 dtype: torch.dtype | None = None, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        stem = 32 if small else 64
        stages = (32, 64, 96) if small else (64, 96, 128)
        block = BottleneckBlock if small else ResidualBlock
        self.conv1 = Conv2d(3, stem, 7, stride=2, init_mode="kaiming_out", dtype=dtype)
        self.norm1 = Norm(norm_fn, stem)
        layers = []
        in_planes = stem
        for dim, stride in zip(stages, (1, 2, 2)):
            layers.append(nn.Sequential(
                block(in_planes, dim, norm_fn, stride, dtype),
                block(dim, dim, norm_fn, 1, dtype),
            ))
            in_planes = dim
        self.layer1, self.layer2, self.layer3 = layers
        self.conv2 = Conv2d(in_planes, output_dim, 1, init_mode="kaiming_out", dtype=dtype)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        x = torch.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        x = self.conv2(x)
        if self.dropout > 0 and self.training:
            x = channel_dropout(x, self.dropout, generator)
        return x


def channel_dropout(x: torch.Tensor, rate: float, generator=None) -> torch.Tensor:
    """Zero whole channels of NCHW ``x`` per sample with probability
    ``rate``, dividing the kept ones by ``1 - rate``."""
    keep = 1.0 - rate
    mask = torch.empty(x.shape[:2] + (1, 1), device=x.device).bernoulli_(keep,
                                                                       generator=generator)
    return torch.where(mask.bool(), x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
