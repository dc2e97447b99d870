"""Helpers the per-layer readers (``flowbench/metrics/<name>.py``) share:
the traced window's kernels by name, the served batches' rows, the
padded frame size and the card's peaks. A reader returns None where its
cell gives it nothing to read."""

from __future__ import annotations

import re

from flowbench import work
from flowbench import trace as tracing

CORR = re.compile(r"\bcorr_lookup_kernel\b")
CORR_BWD = re.compile(r"\bcorr_lookup_bwd_(tile|query)_kernel\b")
NCONV = re.compile(r"\bnconv_kernel\b")
NCONV_BWD = re.compile(r"\bnconv_bwd_(kernel|finalize)\b")
COPY = re.compile(r"^(Memcpy|Memset)")


def traced(ctx) -> bool:
    tr = ctx.get("trace")
    return tr is not None and tr.window_s is not None and bool(tr.ops)


def kernel_s(ctx) -> float:
    """Summed time of the traced window's kernels (copies and sets left out)."""
    return sum(d for n, _, d in ctx["trace"].ops if not COPY.search(n))


def span_ms(ctx, name: str) -> list:
    return [r["duration_ms"] for r in ctx["spans"] if r["name"] == name and "duration_ms" in r]


def pairs(ctx) -> int:
    """Pairs answered ok among the traced window's requests."""
    return sum(1 for r in ctx["window"] if r[4])


def rows(ctx) -> int:
    """Rows the served batches ran (pad rows included)."""
    return sum(r["attrs"].get("rows", 0) + r["attrs"].get("pad_rows", 0)
               for r in ctx["spans"] if r["name"] == "serve_pad_stage")


def padded_hw(ctx) -> tuple:
    h, w = ctx["mix"]["frame_hw"]
    div = 8 * int(ctx["mix"].get("mesh", [1, 1])[1])
    return h + (-h % div), w + (-w % 8)


def peaks(ctx) -> dict:
    import torch

    return work.peaks(torch.cuda.get_device_name(ctx["device"]))


def share(bound_s: float, spent_s: float):
    """A share of a roofline in %, None when nothing was spent."""
    return None if spent_s <= 0 else 100.0 * bound_s / spent_s


def idle(ctx):
    """Idle share of the traced window; over several cards, the mean of
    each card's idle share of its own traced span."""
    if "busy_share_mean" in ctx:
        return 100.0 * (1.0 - ctx["busy_share_mean"])
    tr = ctx["trace"]
    return 100.0 * (1.0 - tracing.busy_s(tr.ops) / tr.window_s)
