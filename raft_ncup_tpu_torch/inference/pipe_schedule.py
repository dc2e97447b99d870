"""The segment arithmetic of a pipelined refinement (port of
``split_iters`` and ``validate_segment_levels`` in
``raft_ncup_tpu/inference/pipe_schedule.py``).

The iteration budget's ``segments`` argument needs these two rules. The
pipelined forward itself and its pipe axis are not ported (ROADMAP.md,
queue 1 item 9b-iv: ``parallel/`` has the data and spatial axes across
processes only).
"""

from __future__ import annotations

from typing import Sequence


def split_iters(iters: int, segments: int) -> int:
    """Iteration count -> per-segment length. Segments are equal-length
    contiguous blocks, so ``segments`` must divide ``iters``."""
    iters, segments = int(iters), int(segments)
    if segments < 1:
        raise ValueError(f"segments must be >= 1, got {segments}")
    if iters < 1 or iters % segments:
        raise ValueError(
            f"iters={iters} does not split into {segments} equal scan "
            f"segments; pipelined budgets must be multiples of "
            f"{segments} (see serving/budget.py segment quantization)"
        )
    return iters // segments


def validate_segment_levels(levels: Sequence[int], segments: int) -> None:
    """Every iteration level must be a multiple of the segment length
    ``levels[0] / segments``: a reduced budget runs fewer segments of the
    same segment program. ``(24, 16, 8)`` with 2 segments (length 12) is
    refused; ``(24, 12)`` is valid. One segment imposes nothing."""
    segments = int(segments)
    if segments < 1:
        raise ValueError(f"segments must be >= 1, got {segments}")
    if segments == 1:
        return
    levels = tuple(int(x) for x in levels)
    if not levels:
        raise ValueError("empty iteration level set")
    if levels[0] % segments:
        raise ValueError(
            f"top iteration level {levels[0]} does not split into "
            f"{segments} equal segments"
        )
    seg_len = levels[0] // segments
    bad = [x for x in levels if x % seg_len]
    if bad:
        raise ValueError(
            f"iteration levels {bad} do not quantize to the segment "
            f"boundary (multiples of {levels[0]}/{segments} = {seg_len} "
            f"iterations) required by pipe segments={segments}; with a "
            "pipelined mesh a budget level must run a whole number of "
            f"scan segments — e.g. {tuple(seg_len * k for k in range(segments, 0, -1))}"
        )
