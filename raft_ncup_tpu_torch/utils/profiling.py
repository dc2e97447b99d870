"""Profiling and throughput measurement (port of
``raft_ncup_tpu/utils/profiling.py``).

``stage_annotation`` labels a host stage on a profiler's timeline
(``torch.profiler.record_function``, where JAX has
``jax.profiler.TraceAnnotation``); ``trace`` records a ``torch.profiler``
trace of the CPU and, on a card, of CUDA and writes it as a Chrome trace
(viewable in Perfetto or ``chrome://tracing``); ``measure_throughput*``
time a unit of work, synchronising the device of its result.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator, Optional

import torch


def stage_annotation(name: str):
    """A host range named ``name`` on a profiler's timeline: the serve and
    stream dispatch stages wear it around the replay of their CUDA graph.
    Outside a profile it costs a few microseconds. It must not sit inside a
    ``torch.cuda.graph`` capture: annotate around the replay. The
    telemetry spans (``observability/spans.py``) do not use it: they
    import no torch."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[Optional[str]]:
    """Record a ``torch.profiler`` trace of the enclosed code (CPU
    activity, and CUDA kernels when a card is present) and write it as a
    Chrome trace ``trace_<pid>_<n>.json`` in ``log_dir``; yields the path
    it will write. A no-op yielding None when ``log_dir`` is None. The
    caller synchronises before leaving, so the device's last kernels are
    in the trace."""
    if log_dir is None:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    n = len([f for f in os.listdir(log_dir) if f.endswith(".json")])
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield path
    prof.export_chrome_trace(path)


def _sync(out) -> None:
    """Wait for the device of the first tensor in ``out`` (a tensor, or a
    tuple, list or dict holding tensors)."""
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        for x in out:
            if isinstance(x, torch.Tensor):
                out = x
                break
    if isinstance(out, torch.Tensor) and out.device.type == "cuda":
        torch.cuda.synchronize(out.device)


def measure_throughput(
    fn: Callable[[], object],
    warmup: int = 2,
    reps: int = 5,
    sync: Optional[Callable[[object], None]] = None,
) -> float:
    """Time ``fn`` (one unit of work) and return calls/sec."""
    return measure_throughput_detailed(fn, warmup, reps, sync)[0]


def measure_throughput_detailed(
    fn: Callable[[], object],
    warmup: int = 2,
    reps: int = 5,
    sync: Optional[Callable[[object], None]] = None,
) -> tuple[float, list[float]]:
    """Time ``fn`` per rep and return ``(calls/sec, [rep seconds...])``.

    ``sync`` receives the output and must wait for it; by default it
    synchronises the CUDA device of the first tensor in the output (a CPU
    result is ready when returned). Each rep waits on its own, so the
    record carries the spread."""
    sync = sync or _sync
    for _ in range(warmup):
        sync(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sync(fn())
        times.append(time.perf_counter() - t0)
    return reps / sum(times), times
