"""Input padding to stride-8-divisible shapes (port of
``raft_ncup_tpu/ops/padding.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


class InputPadder:
    """Pads NHWC images so H and W are divisible by 8 (replicate padding).

    mode='sintel' centers the vertical padding; mode='kitti' puts all
    vertical padding below the image. Horizontal padding is centered in
    both modes. ``divisor`` applies to the height (the width always pads
    to 8, as in the JAX package). ``bucket`` > 0 instead rounds the
    padded height and width up to multiples of ``bucket``.
    """

    def __init__(
        self,
        dims: tuple[int, ...],
        mode: str = "sintel",
        divisor: int = 8,
        bucket: int = 0,
    ):
        # dims is NHWC (B, H, W, C) or HWC (H, W, C).
        if len(dims) == 4:
            self.ht, self.wd = dims[1], dims[2]
        else:
            self.ht, self.wd = dims[0], dims[1]
        d = divisor
        if bucket:
            if bucket % d or bucket % 8:
                raise ValueError(
                    f"pad bucket {bucket} must be a multiple of the "
                    f"divisor ({d}) and of the stride (8)"
                )
            pad_ht = -self.ht % bucket
            pad_wd = -self.wd % bucket
        else:
            pad_ht = (((self.ht // d) + 1) * d - self.ht) % d
            pad_wd = (((self.wd // 8) + 1) * 8 - self.wd) % 8
        wpad = (pad_wd // 2, pad_wd - pad_wd // 2)
        if mode == "sintel":
            self._pad = ((pad_ht // 2, pad_ht - pad_ht // 2), wpad)
        else:
            self._pad = ((0, pad_ht), wpad)

    @property
    def pad_spec(self) -> tuple[tuple[int, int], tuple[int, int]]:
        """Static ``((top, bottom), (left, right))`` amounts."""
        return self._pad

    def pad(self, *inputs: torch.Tensor) -> list[torch.Tensor]:
        """Edge-pad each (B, H, W, C) tensor."""
        (t, b), (le, r) = self._pad
        out = []
        for x in inputs:
            y = F.pad(x.permute(0, 3, 1, 2), (le, r, t, b), mode="replicate")
            out.append(y.permute(0, 2, 3, 1))
        return out

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        (t, b), (le, r) = self._pad
        ht, wd = x.shape[-3], x.shape[-2]
        return x[..., t: ht - b, le: wd - r, :]
