"""Confidence estimation net of the NCUP upsampler (port of
``raft_ncup_tpu/nn/weights_est.py``'s ``SimpleWeightsNet``), NCHW."""

from __future__ import annotations

import torch
from torch import nn

from raft_ncup_tpu_torch.nn.layers import Conv2d, Norm


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
