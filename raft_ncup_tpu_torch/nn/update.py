"""Recurrent update blocks (port of ``raft_ncup_tpu/nn/update.py``), NCHW.

The motion encoder fuses correlation features and the current flow, a
conv GRU refines the hidden state (separable 1x5 then 5x1 in the
full-size block, a plain 3x3 in the small one), and a flow head emits
the per-iteration flow delta. The ``raft`` variant's full-size block also
has the mask head of convex upsampling; raft_nc_dbl has none (the NCUP
upsampler takes the GRU state as guidance instead), and neither has the
small block (it upsamples bilinearly). ``dtype`` is every convolution's
compute dtype (``None``: the input's), the mask head's included.
"""

from __future__ import annotations

import torch
from torch import nn

from raft_ncup_tpu_torch.nn.layers import Conv2d


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden_dim: int = 256, dtype=None):
        super().__init__()
        self.conv1 = Conv2d(input_dim, hidden_dim, 3, dtype=dtype)
        self.conv2 = Conv2d(hidden_dim, 2, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(torch.relu(self.conv1(x)))


class ConvGRU(nn.Module):
    """Plain 3x3 conv GRU."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 256, dtype=None):
        super().__init__()
        cat = hidden_dim + input_dim
        self.convz = Conv2d(cat, hidden_dim, 3, dtype=dtype)
        self.convr = Conv2d(cat, hidden_dim, 3, dtype=dtype)
        self.convq = Conv2d(cat, hidden_dim, 3, dtype=dtype)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q


class SepConvGRU(nn.Module):
    """Separable GRU: a horizontal (1x5) pass, then a vertical (5x1) one."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 256, dtype=None):
        super().__init__()
        cat = hidden_dim + input_dim
        for suffix, k in (("1", (1, 5)), ("2", (5, 1))):
            for gate in ("z", "r", "q"):
                setattr(self, f"conv{gate}{suffix}", Conv2d(cat, hidden_dim, k, dtype=dtype))

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


class SmallMotionEncoder(nn.Module):
    def __init__(self, corr_planes: int, dtype=None):
        super().__init__()
        self.convc1 = Conv2d(corr_planes, 96, 1, dtype=dtype)
        self.convf1 = Conv2d(2, 64, 7, dtype=dtype)
        self.convf2 = Conv2d(64, 32, 3, dtype=dtype)
        self.conv = Conv2d(32 + 96, 80, 3, dtype=dtype)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = torch.relu(self.convc1(corr))
        flo = torch.relu(self.convf1(flow))
        flo = torch.relu(self.convf2(flo))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_planes: int, dtype=None):
        super().__init__()
        self.convc1 = Conv2d(corr_planes, 256, 1, dtype=dtype)
        self.convc2 = Conv2d(256, 192, 3, dtype=dtype)
        self.convf1 = Conv2d(2, 128, 7, dtype=dtype)
        self.convf2 = Conv2d(128, 64, 3, dtype=dtype)
        self.conv = Conv2d(64 + 192, 128 - 2, 3, dtype=dtype)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = torch.relu(self.convc1(corr))
        cor = torch.relu(self.convc2(cor))
        flo = torch.relu(self.convf1(flow))
        flo = torch.relu(self.convf2(flo))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SmallUpdateBlock(nn.Module):
    """Small motion encoder + ConvGRU + flow head; no mask head."""

    def __init__(self, corr_planes: int, hidden_dim: int = 96, input_dim: int = 64,
                 dtype=None):
        super().__init__()
        self.encoder = SmallMotionEncoder(corr_planes, dtype)
        self.gru = ConvGRU(hidden_dim, input_dim=input_dim + 82, dtype=dtype)
        self.flow_head = FlowHead(hidden_dim, hidden_dim=128, dtype=dtype)

    def forward(
        self, net: torch.Tensor, inp: torch.Tensor, corr: torch.Tensor,
        flow: torch.Tensor,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """NCHW in; returns ``(net, delta_flow)``."""
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, self.flow_head(net)


class BasicUpdateBlock(nn.Module):
    """Motion encoder + SepConvGRU + flow head, and with ``use_mask_head``
    the ``raft`` variant's mask head (:meth:`mask_logits`). Without it
    this is the JAX package's ``use_mask_head=False``, as raft_nc_dbl
    uses it."""

    def __init__(
        self, corr_planes: int, hidden_dim: int = 128, input_dim: int = 128,
        use_mask_head: bool = False, dtype=None,
    ):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes, dtype)
        self.gru = SepConvGRU(hidden_dim, input_dim=input_dim + 128, dtype=dtype)
        self.flow_head = FlowHead(hidden_dim, hidden_dim=256, dtype=dtype)
        self.mask = None
        if use_mask_head:
            self.mask = nn.Sequential(
                Conv2d(hidden_dim, 256, 3, dtype=dtype), nn.ReLU(),
                Conv2d(256, 64 * 9, 1, dtype=dtype),
            )

    def mask_logits(self, net: torch.Tensor) -> torch.Tensor:
        """The convex-upsampling mask logits (B, 576, h, w) for the GRU
        state ``net``, scaled by 0.25 as the reference does to balance
        gradients. It reads only ``net``, so the model computes it where
        the upsampling needs it: after the loop in test mode, every
        iteration in training."""
        return 0.25 * self.mask(net)

    def forward(
        self, net: torch.Tensor, inp: torch.Tensor, corr: torch.Tensor,
        flow: torch.Tensor,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """NCHW in; returns ``(net, delta_flow)``."""
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, self.flow_head(net)
