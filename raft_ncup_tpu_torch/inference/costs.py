"""The captured-forward cost ledger: what each cached entry costs,
recorded once when it is built (port of ``raft_ncup_tpu/inference/costs.py``).

JAX records each warmed executable's ``Compiled.cost_analysis()``. PyTorch
has no such analysis of a CUDA graph, so the port counts the run that
precedes each capture: ``ShapeCachedForward`` runs every new key once
eagerly on a side stream before capturing it (``pipeline._capture``), and
that run, and only that run, is counted (never inside
``torch.cuda.graph``). On the CPU the eager entry's first call is counted.
Per entry the ledger holds:

- ``flops``: the aten operations ``torch.utils.flop_counter.FlopCounterMode``
  counts over the run (convolutions and matrix products, 2 per
  multiply-add), plus the operations of the hand-written kernels the run
  launched (kernel A, the correlation lookup; kernel B, the fused
  NConv2d), by the work formulas ``corr_cuda.lookup_work`` and
  ``nconv_cuda.nconv_work`` that ``tests/test_torch_kernel_work.py``
  holds against brute force: the flop counter cannot see a kernel loaded
  from a shared library. ``flops_by_source`` splits the sum;
- ``bytes_accessed``: always None. PyTorch gives no byte count of a graph
  or of an eager run, and the ledger invents none;
- ``capture_ms``, where JAX has ``compile_ms``: the host wall time of
  building the entry (the counted eager run, cuDNN's autotuning at the
  key's shapes, the capture), which is what the key's first caller would
  pay;
- ``memory_stats``: ``{"graph_pool_reserved_bytes": ...}``, the device
  memory the capture added to the cache's shared graph pool (0 on the
  CPU).

Entries are keyed ``"<device type>|<cache key>"``, the cache's own key, so
a re-warm of a cached key records nothing twice. An early-exit entry is
three graphs (encode, segment, finalize) and records three keys.

A pipelined forward's stage programs (``inference/pipe_schedule.py``)
carry ``segments`` in their meta. JAX derives each segment's share of a
tick that runs all S segments (``flops_per_segment = flops / S``); the
port's ``pipe_segment`` program is one stage's segment already, so its
``flops_per_segment`` is its own count, and ``flops_per_tick`` is the S
stages' segments of one steady-state tick. ``bytes_per_segment`` stays
None, as ``bytes_accessed`` does.

**MFU** = achieved FLOP/s over the card's peak: :func:`peak_flops` reads
``utils/flops.GPU_PEAK_FLOPS`` by the card's name and the preset's compute
dtype; the CPU takes a nominal per-core figure (``RAFT_TORCH_CPU_PEAK_FLOPS``
overrides it). ``None`` means the card is unknown, never 0.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Dict, Optional

from raft_ncup_tpu_torch.utils.flops import peak_flops as card_peak_flops
from raft_ncup_tpu_torch.utils.knobs import knob_raw

CPU_PEAK_ENV = "RAFT_TORCH_CPU_PEAK_FLOPS"

# Nominal peak per CPU core, the JAX package's: 8-lane f32 FMA (AVX2) at
# about 3 GHz = 2 * 8 * 3e9 FLOP/s. An order-of-magnitude figure.
CPU_PEAK_FLOPS_PER_CORE = 4.8e10


def peak_flops(device_type: Optional[str], device_name: Optional[str] = None,
               dtype: str = "f32") -> Optional[float]:
    """Dense peak FLOP/s of one device: a CUDA card by its name and the
    compute dtype (``"f32"`` or ``"bf16"``), or the whole CPU; None when the
    card is unknown."""
    if device_type == "cpu":
        override = knob_raw(CPU_PEAK_ENV)
        if override:
            try:
                return float(override)
            except ValueError:
                pass
        return (os.cpu_count() or 1) * CPU_PEAK_FLOPS_PER_CORE
    if device_type == "cuda":
        return card_peak_flops(device_name, dtype)
    return None


def mfu(
    flops_per_item: Optional[float],
    items_per_sec: Optional[float],
    peak: Optional[float],
) -> Optional[float]:
    """Model FLOPs utilization: achieved FLOP/s over ``peak``. ``None``
    when any input is unknown, never 0.0, which would claim a
    measurement."""
    if not flops_per_item or not items_per_sec or not peak:
        return None
    return round(flops_per_item * items_per_sec / peak, 6)


@contextlib.contextmanager
def counting_flops():
    """Count the enclosed run's operations: yields a dict that holds, on
    exit, ``aten`` (FlopCounterMode's total), ``corr_lookup`` and ``nconv``
    (the launched kernels' work) and ``total``. The flop counter is a
    dispatch mode of the calling thread; the kernels' wrappers append each
    launch's work to a log this context installs and removes, so the
    caller holds the card meanwhile (the cache builds an entry on the one
    thread that runs its forwards)."""
    from torch.utils.flop_counter import FlopCounterMode

    from raft_ncup_tpu_torch.ops import corr_cuda, nconv_cuda

    counts: Dict[str, float] = {}
    logs = {"corr_lookup": [], "nconv": []}
    corr_cuda.lookup_levels.work_log = logs["corr_lookup"]
    nconv_cuda.nconv2d_fused.work_log = logs["nconv"]
    mode = FlopCounterMode(display=False)
    try:
        with mode:
            yield counts
    finally:
        corr_cuda.lookup_levels.work_log = None
        nconv_cuda.nconv2d_fused.work_log = None
    counts["aten"] = float(mode.get_total_flops())
    for name, log in logs.items():
        counts[name] = float(sum(log))
    counts["total"] = counts["aten"] + counts["corr_lookup"] + counts["nconv"]


class CostLedger:
    """Thread-safe per-process ledger of the cached entries' costs.

    ``record`` is called once per (device type, cache key) when the entry
    is built; re-recording a key overwrites it in place (the entry
    describes the graph, not the event). ``meta`` carries the structured
    identity consumers filter on (kind, shape, iterations, preset)."""

    def __init__(self):
        self._entries: Dict[str, dict] = {}
        self._lock = threading.Lock()

    def record(self, key: str, *, flops: dict, capture_ms: float, pool_bytes: int,
               backend: str, **meta) -> dict:
        entry = {
            "key": str(key),
            "backend": backend,
            "flops": flops["total"],
            "flops_by_source": {k: flops[k] for k in ("aten", "corr_lookup", "nconv")},
            "bytes_accessed": None,
            "capture_ms": round(float(capture_ms), 1),
            "memory_stats": {"graph_pool_reserved_bytes": int(pool_bytes)},
            "meta": {k: v for k, v in meta.items() if v is not None},
        }
        segs = entry["meta"].get("segments")
        if entry["meta"].get("kind") == "pipe_segment" and isinstance(segs, int) and segs > 1:
            entry["flops_per_segment"] = entry["flops"]
            entry["flops_per_tick"] = entry["flops"] * segs
            entry["bytes_per_segment"] = None
        with self._lock:
            self._entries[str(key)] = entry
        return entry

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def lookup(self, **meta) -> Optional[dict]:
        """The first entry whose ``meta`` matches every given item (e.g.
        ``lookup(kind="pipe_segment", segments=2)``), JAX's lookup."""
        with self._lock:
            entries = list(self._entries.values())
        for e in entries:
            m = e.get("meta") or {}
            if all(m.get(k) == v for k, v in meta.items()):
                return e
        return None

    def snapshot(self) -> dict:
        """JSON-able dump of every entry (tuples as lists), in the JAX
        ledger's layout (always enabled here)."""
        with self._lock:
            entries = {
                k: {**e, "meta": {mk: (list(mv) if isinstance(mv, tuple) else mv)
                                  for mk, mv in (e.get("meta") or {}).items()}}
                for k, e in self._entries.items()
            }
        return {"enabled": True, "entries": entries}


_default_lock = threading.Lock()
_default: Optional[CostLedger] = None


def get_cost_ledger() -> CostLedger:
    """The process-wide default ledger (created on first use)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = CostLedger()
        return _default


def set_cost_ledger(ledger: Optional[CostLedger]) -> Optional[CostLedger]:
    """Swap the process default (test isolation); returns the previous
    ledger."""
    global _default
    with _default_lock:
        prev, _default = _default, ledger
        return prev
