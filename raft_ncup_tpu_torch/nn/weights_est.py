"""Confidence estimation nets of the NCUP upsampler (port of
``raft_ncup_tpu/nn/weights_est.py``), NCHW: ``SimpleWeightsNet`` and
``UNetWeightsNet``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from raft_ncup_tpu_torch.nn.layers import Conv2d, ConvTranspose2d, Norm
from raft_ncup_tpu_torch.parallel import halo


class SimpleWeightsNet(nn.Module):
    """Conv(+BN)+ReLU stack and a sigmoid head. ``num_ch`` excludes the
    input channel count, which is given as ``in_ch``. Submodules are
    ``conv.i.0`` (conv), ``conv.i.1`` (BN, with ``use_bn``) and ``out``,
    the reference's names."""

    def __init__(
        self,
        in_ch: int,
        num_ch=(64, 32),
        out_ch: int = 2,
        filter_sz=(3, 3, 1),
        dilation=(1, 1, 1),
        use_bn: bool = False,
    ):
        super().__init__()
        if len(filter_sz) != len(num_ch) + 1:
            raise ValueError(
                f"filter_sz {filter_sz} needs one entry per layer of "
                f"num_ch {num_ch} plus the head"
            )
        stages = []
        prev = in_ch
        for i, ch in enumerate(num_ch):
            k, d = filter_sz[i], dilation[i]
            pad = k // 2 + ((k - 1) * (d - 1)) // 2
            mods = [Conv2d(prev, ch, k, dilation=d, padding=pad)]
            if use_bn:
                mods.append(Norm("batch", ch))
            stages.append(nn.Sequential(*mods))
            prev = ch
        self.conv = nn.ModuleList(stages)
        k, d = filter_sz[-1], dilation[-1]
        pad = k // 2 + ((k - 1) * (d - 1)) // 2
        self.out = Conv2d(prev, out_ch, k, dilation=d, padding=pad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for stage in self.conv:
            x = torch.relu(stage(x))
        return torch.sigmoid(self.out(x))


class _DoubleConv(nn.Module):
    """(3x3 conv, BatchNorm, ReLU) twice; submodules ``conv.i.0`` (conv)
    and ``conv.i.1`` (BN), as the JAX package exports them."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.ModuleList([
            nn.Sequential(Conv2d(c, out_ch, 3), Norm("batch", out_ch))
            for c in (in_ch, out_ch)
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for stage in self.conv:
            x = torch.relu(stage(x))
        return x


class UNetWeightsNet(nn.Module):
    """A double-conv U-Net with a sigmoid head: ``inconv`` at
    ``num_ch[0]``, then per level a 2x2 max-pool and ``down{i}``; back up,
    ``up{i}_tconv`` (2x2 stride-2 transposed conv) zero-padded to its skip's
    size (the odd pixel at the bottom and right) and ``up{i}_conv`` over
    the skip and it, concatenated; ``outconv`` 1x1. Its BatchNorm trains
    when the model's BatchNorm trains. On a band of rows
    (``parallel/halo.py``) the pooling and the transposed convolutions are
    local when the band's height divides by ``2 ** n_down``; the bands of
    a group are equally high, so on another band every rank runs the net
    on the gathered whole image and keeps its band (``halo.on_whole``)."""

    def __init__(self, in_ch: int, num_ch=(16, 32, 64), out_ch: int = 2):
        super().__init__()
        num_ch = tuple(num_ch)
        self.n_down = len(num_ch) - 1
        self.inconv = _DoubleConv(in_ch, num_ch[0])
        for i in range(self.n_down):
            setattr(self, f"down{i}", _DoubleConv(num_ch[i], num_ch[i + 1]))
        for i in range(self.n_down):
            ch, skip = num_ch[-1 - i], num_ch[-2 - i]
            setattr(self, f"up{i}_tconv", ConvTranspose2d(ch, ch, 2, stride=2))
            setattr(self, f"up{i}_conv", _DoubleConv(skip + ch, skip))
        self.outconv = Conv2d(num_ch[0], out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if halo.current() is not None and x.shape[2] % (2 ** self.n_down):
            # A band that pools to an odd row would pad it in the image's
            # interior, where the whole image pads nothing.
            return halo.on_whole(self._net, x)
        return self._net(x)

    def _net(self, x: torch.Tensor) -> torch.Tensor:
        feats = [self.inconv(x)]
        for i in range(self.n_down):
            feats.append(getattr(self, f"down{i}")(F.max_pool2d(feats[-1], 2, 2)))
        y = feats[-1]
        for i in range(self.n_down):
            skip = feats[-i - 2]
            y = getattr(self, f"up{i}_tconv")(y)
            dh = skip.shape[2] - y.shape[2]
            dw = skip.shape[3] - y.shape[3]
            y = F.pad(y, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
            y = getattr(self, f"up{i}_conv")(torch.cat([skip, y], dim=1))
        return torch.sigmoid(self.outconv(y))
