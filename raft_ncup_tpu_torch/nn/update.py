"""Recurrent update block (port of ``raft_ncup_tpu/nn/update.py``), NCHW.

The motion encoder fuses correlation features and the current flow, a
separable conv GRU (1x5 then 5x1) refines the hidden state, and a flow
head emits the per-iteration flow delta. raft_nc_dbl has no mask head:
the NCUP upsampler takes the GRU state as guidance instead.
"""

from __future__ import annotations

import torch
from torch import nn

from raft_ncup_tpu_torch.nn.layers import Conv2d


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = Conv2d(input_dim, hidden_dim, 3)
        self.conv2 = Conv2d(hidden_dim, 2, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(torch.relu(self.conv1(x)))


class SepConvGRU(nn.Module):
    """Separable GRU: a horizontal (1x5) pass, then a vertical (5x1) one."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 256):
        super().__init__()
        cat = hidden_dim + input_dim
        for suffix, k in (("1", (1, 5)), ("2", (5, 1))):
            for gate in ("z", "r", "q"):
                setattr(self, f"conv{gate}{suffix}", Conv2d(cat, hidden_dim, k))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for suffix in ("1", "2"):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{suffix}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{suffix}")(hx))
            q = torch.tanh(
                getattr(self, f"convq{suffix}")(torch.cat([r * h, x], dim=1))
            )
            h = (1 - z) * h + z * q
        return h


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = Conv2d(corr_planes, 256, 1)
        self.convc2 = Conv2d(256, 192, 3)
        self.convf1 = Conv2d(2, 128, 7)
        self.convf2 = Conv2d(128, 64, 3)
        self.conv = Conv2d(64 + 192, 128 - 2, 3)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = torch.relu(self.convc1(corr))
        cor = torch.relu(self.convc2(cor))
        flo = torch.relu(self.convf1(flow))
        flo = torch.relu(self.convf2(flo))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class BasicUpdateBlock(nn.Module):
    """Motion encoder + SepConvGRU + flow head, without the mask head
    (``use_mask_head=False`` of the JAX package, as raft_nc_dbl uses it)."""

    def __init__(self, corr_planes: int, hidden_dim: int = 128, input_dim: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes)
        self.gru = SepConvGRU(hidden_dim, input_dim=input_dim + 128)
        self.flow_head = FlowHead(hidden_dim, hidden_dim=256)

    def forward(
        self, net: torch.Tensor, inp: torch.Tensor, corr: torch.Tensor,
        flow: torch.Tensor,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """NCHW in; returns ``(net, delta_flow)``."""
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, self.flow_head(net)
