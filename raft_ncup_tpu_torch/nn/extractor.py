"""Feature and context encoders (port of ``raft_ncup_tpu/nn/extractor.py``).

Stride-8 CNN, NCHW: a 7x7/s2 stem and three 2-block residual stages
(64 -> 96 -> 128 at strides 1, 2, 2), then a 1x1 output conv. Submodule
names follow the reference's torch module tree (``conv1``, ``norm1``,
``layer1.0.conv1``, ``layer2.0.downsample.0``, ...), so the carried
state dict (``utils/jax_weights.py``) keys match it.
"""

from __future__ import annotations

import torch
from torch import nn

from raft_ncup_tpu_torch.nn.layers import Conv2d, Norm


class ResidualBlock(nn.Module):
    """Two 3x3 convs and an identity or 1x1 downsample shortcut."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, stride=stride, init_mode="kaiming_out")
        self.norm1 = Norm(norm_fn, planes)
        self.conv2 = Conv2d(planes, planes, 3, init_mode="kaiming_out")
        self.norm2 = Norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                Conv2d(in_planes, planes, 1, stride=stride, init_mode="kaiming_out"),
                Norm(norm_fn, planes),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class BasicEncoder(nn.Module):
    """The stride-8 encoder of the full-size model: fnet with instance
    norm, cnet with batch norm."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "batch", dropout: float = 0.0):
        super().__init__()
        if dropout > 0:
            raise NotImplementedError("encoder dropout lands with a later slice of the port")
        self.conv1 = Conv2d(3, 64, 7, stride=2, init_mode="kaiming_out")
        self.norm1 = Norm(norm_fn, 64)
        layers = []
        in_planes = 64
        for i, (dim, stride) in enumerate(zip((64, 96, 128), (1, 2, 2)), start=1):
            layers.append(nn.Sequential(
                ResidualBlock(in_planes, dim, norm_fn, stride),
                ResidualBlock(dim, dim, norm_fn, 1),
            ))
            in_planes = dim
        self.layer1, self.layer2, self.layer3 = layers
        self.conv2 = Conv2d(128, output_dim, 1, init_mode="kaiming_out")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)
