"""Device resolution and the f32 precision policy of the port.

The entry points (``RAFT``, ``FlowServer`` through its model, the serve
entry) run on the card unless the caller asks for the CPU. With no
device given and no CUDA present they raise: nothing carries on quietly
on the CPU.

Under the ``f32`` precision preset the port computes in f32, but cuDNN
convolutions default to TF32 on the card. :func:`f32_precision` turns
TF32 off around the model's forward and the kernels' plain versions, so
every caller gets f32 without setting process-wide flags itself. (The
flags do not touch bf16 convolutions, which the bf16 presets run.)
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    device and raises when CUDA is absent."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU explicitly"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


@contextlib.contextmanager
def f32_precision():
    """Run the enclosed code (or the decorated function) with TF32 off for
    cuDNN convolutions and CUDA matmuls, then restore the caller's flags.
    The flags are process-wide, so two threads must not run forwards
    concurrently while a caller has TF32 on; the server runs its model on
    one dispatcher thread."""
    conv = torch.backends.cudnn.allow_tf32
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = matmul


@contextlib.contextmanager
def cudnn_autotune():
    """Run the enclosed code (or the decorated function) with cuDNN's
    autotuner on (``torch.backends.cudnn.benchmark``), then restore the
    caller's flag. The train step runs under it: at the training shapes,
    cuDNN's heuristic picks for one f32 convolution an FFT algorithm that
    launches a small complex GEMM per frequency, about 16,000 launches a
    call; the autotuner times the candidates once per shape instead. It
    changes which f32 algorithm runs, not the precision."""
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = prev
