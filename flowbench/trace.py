"""The traced window: ``torch.profiler`` over the measured work, reduced
to the device's operations (name, start, duration), its busy time, the
longest idle gaps with what the host was doing in each, and the top
operations by time. Host ranges come from ``record_function`` labels
(the program's own and the drivers')."""

from __future__ import annotations

import contextlib
import time
from typing import Optional


class Trace:
    """``with Trace(enabled) as tr: ...`` profiles the block when enabled;
    afterwards ``tr.ops`` holds the device operations as ``(name,
    start_s, dur_s)`` on one clock, ``tr.host`` the labelled host ranges,
    and ``tr.window_s`` the traced wall time."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.ops: list = []
        self.host: list = []
        self.window_s: Optional[float] = None
        self._prof = None

    def __enter__(self) -> "Trace":
        if self.enabled:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            self._prof = torch.profiler.profile(activities=acts, record_shapes=False,
                                                with_stack=False)
            self._prof.__enter__()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        if self._prof is None:
            return
        import torch

        torch.cuda.synchronize()
        self.window_s = time.monotonic() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._collect()

    def _collect(self) -> None:
        for ev in self._prof.profiler.kineto_results.events():
            kind = _kind(ev)
            if kind is None:
                continue
            start = _ns(ev, "start") * 1e-9
            dur = _ns(ev, "duration") * 1e-9
            (self.ops if kind == "device" else self.host).append((ev.name(), start, dur))
        self.ops.sort(key=lambda o: o[1])


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")() * 1000)


DEVICE_ACTIVITIES = ("kernel", "memcpy", "memset")


def _kind(ev):
    """``device`` for an operation that ran on the card (a kernel, a copy,
    a set), ``host`` for a labelled host range (``record_function``),
    None for the rest (host operations, runtime calls, and the labels'
    projections onto the card's timeline)."""
    activity = str(ev.activity_type()).lower() if hasattr(ev, "activity_type") else ""
    if "gpu_user_annotation" in activity:
        return None
    if "user_annotation" in activity:
        return "host"
    if any(a in activity for a in DEVICE_ACTIVITIES) and "runtime" not in activity:
        return "device"
    if not activity and "CUDA" in str(ev.device_type()) and not ev.is_user_annotation():
        return "device"
    return None


def busy_s(ops: list) -> float:
    """Seconds in which some operation ran on the device (union of the
    operations' intervals)."""
    total, end = 0.0, float("-inf")
    for _, s, d in ops:
        e = s + d
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps(ops: list) -> list:
    """Idle intervals between the device's operations: ``(start, dur)``."""
    out, end = [], None
    for _, s, d in ops:
        if end is not None and s > end:
            out.append((end, s - end))
        end = s + d if end is None else max(end, s + d)
    return out


def kernel_s(ops: list, pattern) -> float:
    """Summed time of the operations whose name matches ``pattern``."""
    return sum(d for n, _, d in ops if pattern.search(n))


def breakdown(ops: list, host: list, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps, each named by the innermost host range open at the gap's middle."""
    by_name: dict = {}
    for n, _, d in ops:
        by_name[n] = by_name.get(n, 0.0) + d
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    longest = sorted(gaps(ops), key=lambda g: -g[1])[:top]
    idle = []
    for start, dur in longest:
        mid = start + dur / 2
        around = [(d, n) for n, s, d in host if s <= mid <= s + d]
        idle.append([min(around)[1] if around else "host outside any labelled range", dur])
    return {"device_ops": [[n[:200], s] for n, s in device_ops], "idle_gaps": idle}


@contextlib.contextmanager
def label(name: str):
    """A host range on the profiler's timeline (``record_function``)."""
    from torch.profiler import record_function

    with record_function(name):
        yield
