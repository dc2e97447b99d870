"""What the drivers share: the program's model built from a configuration
file and the benchmark's weights, the device's description, the
reference's precision flags and freeing the program's state."""

from __future__ import annotations

import contextlib
import gc

import torch


def device_of(cell) -> torch.device:
    if cell.device == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(cell.device)


def port_model(cfg: dict, weights: dict, device: torch.device):
    """The program's ``RAFT`` for configuration file ``cfg``, on
    ``device``, holding ``weights`` (loaded by name, strictly), with both
    hand-written kernels (``corr_impl`` and ``nconv_impl`` ``pallas``;
    their plain versions on the CPU)."""
    from raft_ncup_tpu_torch.config import ModelConfig, UpsamplerConfig
    from raft_ncup_tpu_torch.models.raft import RAFT

    kw = dict(variant=cfg["model"], precision=cfg["precision"], dataset=cfg["dataset"],
              corr_levels=cfg["corr_levels"], corr_radius=cfg["corr_radius"],
              corr_impl="pallas", nconv_impl="pallas")
    if "upsampler" in cfg:
        kw["upsampler"] = UpsamplerConfig(**{k: tuple(v) if isinstance(v, list) else v
                                             for k, v in cfg["upsampler"].items()})
    mc = ModelConfig(**kw)
    got = (mc.hidden_dim, mc.context_dim, mc.fnet_dim)
    want = (cfg["hidden_dim"], cfg["context_dim"], cfg["fnet_dim"])
    if got != want:
        raise ValueError(f"the program's widths {got} are not the configuration's {want}")
    model = RAFT(mc, device=device)
    model.load_state_dict(weights, strict=True)
    return model


@contextlib.contextmanager
def reference_precision(tf32: bool = False):
    """The reference in float32 with TF32 off (``tf32`` on: the control,
    one precision below the configuration's)."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.benchmark) = prev


def device_info(device: torch.device, count: int, peak_bytes: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(peak_bytes)}


def reset_peak(device: torch.device) -> None:
    """Start a new peak of reserved memory at the window's start: the
    caching allocator's unused blocks (cuDNN's autotuning trials of the
    warm-up, chiefly) go back to the card first, so the peak counts what
    the program then holds (its tensors, the CUDA graphs' pools, which
    ``max_memory_allocated`` does not see, and what it reserves anew)."""
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device: torch.device) -> int:
    """The peak of memory the caching allocator reserved on ``device``."""
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_reserved(device))


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|: how far ``a`` lies from the reference ``b``."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))
