"""Fused correlation-window lookup: the wrapper around the CUDA kernel
``csrc/corr_lookup.cu`` and its plain PyTorch version.

Counterpart of ``raft_ncup_tpu/ops/corr_pallas.py``'s
``corr_lookup_pallas``: the Pallas resident-tier kernel
(``_lookup_kernel``) and banded-tier kernel (``_banded_lookup_kernel``)
compute one function, and one CUDA kernel computes it here, for all
pyramid levels in one launch; the volume never exists. The source notes
what bounds it on the card and what its design does about that.

As in the JAX op, the pyramid pooling and the 1/sqrt(C) pre-scale of
fmap1 stay plain tensor code around the launch (:func:`prepare_levels`);
the model prepares them once per pair and calls :func:`lookup_levels`
every iteration.

:func:`lookup_levels` is the wrapper. For a CPU tensor it runs the plain
version, :func:`lookup_pyramid` (the on-the-fly lookup of
``ops/corr.py``); for a CUDA tensor it launches the kernel or raises.
``lookup_levels.launches`` counts the launches. Forward only in this
slice: a CUDA call whose inputs require grad raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from raft_ncup_tpu_torch.ops import cuda_build
from raft_ncup_tpu_torch.ops.corr import _delta_window, _pool_fmap_pyramid
from raft_ncup_tpu_torch.ops.geometry import grid_sample
from raft_ncup_tpu_torch.utils.device import f32_precision

KERNEL = "corr_lookup"
SOURCE = "raft_ncup_tpu_torch/csrc/corr_lookup.cu"
MAX_LEVELS = 8
MAX_CHANNELS = 512
MAX_RADIUS = 8
# Query rows the plain version samples at once; bounds its peak memory.
ROW_CHUNK = 8


@f32_precision()
def lookup_pyramid(
    f1s: torch.Tensor,
    f2_levels: Sequence[torch.Tensor],
    coords: torch.Tensor,
    radius: int,
) -> torch.Tensor:
    """Plain version of the kernel: windowed correlation on prepared
    inputs, sampling fmap2 at the window taps and contracting with the
    query features (TF32 off), ``ROW_CHUNK`` query rows at a time.

    Args:
      f1s: (B, H, W, C) query features, already scaled by 1/sqrt(C).
      f2_levels: the pooled fmap2 pyramid, each (B, Hl, Wl, C).
      coords: (B, H, W, 2) query positions in level-0 pixels, x first.
    Returns:
      (B, H, W, L * (2r+1)^2) float32, level-major then x-major taps.
    """
    B, H, W, C = f1s.shape
    K = 2 * radius + 1
    delta = _delta_window(radius, coords.device)
    chunks = []
    for r0 in range(0, H, ROW_CHUNK):
        f1c = f1s[:, r0: r0 + ROW_CHUNK].float()
        cc = coords[:, r0: r0 + ROW_CHUNK].float()
        per_level = []
        for lvl, f2l in enumerate(f2_levels):
            taps = cc[:, :, :, None, None, :] / (2**lvl) + delta
            sampled = grid_sample(f2l.float(), taps)  # (B, rc, W, K, K, C)
            corr = torch.einsum("brwijc,brwc->brwij", sampled, f1c)
            per_level.append(corr.reshape(*corr.shape[:3], K * K))
        chunks.append(torch.cat(per_level, dim=-1))
    return torch.cat(chunks, dim=1)


def prepare_levels(
    fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """(B, H, W, C) maps -> (fmap1 * 1/sqrt(C), pooled fmap2 pyramid),
    f32 and contiguous: the operands of :func:`lookup_levels`."""
    C = fmap1.shape[-1]
    f1s = (fmap1.float() * (1.0 / math.sqrt(C))).contiguous()
    levels = [
        lv.contiguous() for lv in _pool_fmap_pyramid(fmap2.float(), num_levels)
    ]
    return f1s, levels


_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = cuda_build.load(KERNEL)
        fn = lib.corr_lookup_f32
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
        _fn = (lib, fn)
    return _fn


def _check_operands(f1s, f2_levels, coords, radius) -> None:
    tensors = [f1s, coords, *f2_levels]
    dev = f1s.device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"corr lookup: tensors on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"corr lookup: f32 only in this slice, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("corr lookup: operands must be contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                "corr lookup kernel is forward-only in this slice; its "
                "backward lands with the training slice"
            )
    if f1s.dim() != 4 or coords.shape != (*f1s.shape[:3], 2):
        raise ValueError(
            f"corr lookup: f1s {tuple(f1s.shape)} / coords "
            f"{tuple(coords.shape)} are not (B, H, W, C) / (B, H, W, 2)"
        )
    B, _, _, C = f1s.shape
    if C % 4 or C > MAX_CHANNELS or not 0 <= radius <= MAX_RADIUS:
        raise ValueError(
            f"corr lookup: C={C} (want a multiple of 4, <= {MAX_CHANNELS}) "
            f"radius={radius} (want 0..{MAX_RADIUS})"
        )
    if not 1 <= len(f2_levels) <= MAX_LEVELS:
        raise ValueError(f"corr lookup: 1..{MAX_LEVELS} levels, got {len(f2_levels)}")
    for lv in f2_levels:
        if lv.dim() != 4 or lv.shape[0] != B or lv.shape[3] != C:
            raise ValueError(
                f"corr lookup: level {tuple(lv.shape)} is not (B, Hl, Wl, C)"
            )
    for t in (f1s, *f2_levels):
        if t.data_ptr() % 16:
            raise ValueError("corr lookup: feature rows must be 16-byte aligned")


def lookup_levels(
    f1s: torch.Tensor,
    f2_levels: Sequence[torch.Tensor],
    coords: torch.Tensor,
    radius: int,
) -> torch.Tensor:
    """The kernel's wrapper: (B, H, W, C) pre-scaled queries, the pooled
    pyramid and (B, H, W, 2) coords -> (B, H, W, L*(2r+1)^2) f32.

    A CPU tensor takes :func:`lookup_pyramid`; a CUDA tensor launches
    the kernel on the current stream or raises."""
    if f1s.device.type == "cpu":
        return lookup_pyramid(f1s, f2_levels, coords, radius)
    if f1s.device.type != "cuda":
        raise ValueError(f"corr lookup: unsupported device {f1s.device}")
    _check_operands(f1s, f2_levels, coords, radius)
    lib, fn = _launcher()
    B, H, W, C = f1s.shape
    L = len(f2_levels)
    K = 2 * radius + 1
    out = torch.empty((B, H, W, L * K * K), dtype=torch.float32, device=f1s.device)
    ptrs = (ctypes.c_void_p * L)(*[lv.data_ptr() for lv in f2_levels])
    hw = (ctypes.c_int * (2 * L))(
        *[d for lv in f2_levels for d in (lv.shape[1], lv.shape[2])]
    )
    rc = fn(
        f1s.data_ptr(), coords.data_ptr(), ptrs, hw, L, B, H * W, C, radius,
        out.data_ptr(), f1s.device.index,
        torch.cuda.current_stream(f1s.device).cuda_stream,
    )
    cuda_build.check(rc, lib, "corr_lookup_f32")
    lookup_levels.launches += 1
    return out


lookup_levels.launches = 0


def corr_lookup_fused(
    fmap1: torch.Tensor,
    fmap2: torch.Tensor,
    coords: torch.Tensor,
    radius: int,
    num_levels: int = 4,
) -> torch.Tensor:
    """Counterpart of ``corr_lookup_pallas``: (B, H, W, C) x2 + (B, H, W, 2)
    -> (B, H, W, L*(2r+1)^2) f32, without the correlation volume."""
    f1s, levels = prepare_levels(fmap1, fmap2, num_levels)
    return lookup_levels(f1s, levels, coords.float().contiguous(), radius)
