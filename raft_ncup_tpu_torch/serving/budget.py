"""Load-adaptive anytime iteration budget with hysteresis (port of
``raft_ncup_tpu/serving/budget.py``).

RAFT refines flow iteratively, and stopping early gives a coarser but
valid field, so the iteration count is a latency/quality knob the server
turns under load. The level set is small and fixed (descending).
Degrading is immediate (occupancy >= ``high_water``, or a paging SLO,
moves one level down); recovering needs ``recover_patience`` consecutive
decisions at or below ``low_water`` with no page, so a load sitting on a
threshold does not flap.

Early exit feeds the controller each batch's mean executed iterations
(:meth:`IterationBudgetController.note_executed`); their EWMA is its model
of what a request costs, and :meth:`decide` scales occupancy by it. An
unfed controller is the worst-case controller. With ``segments`` > 1
every level must fall on a segment boundary
(``inference/pipe_schedule.validate_segment_levels``), checked at
construction.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from raft_ncup_tpu_torch.inference.pipe_schedule import validate_segment_levels


class IterationBudgetController:
    """Map admission-queue occupancy to a GRU iteration budget."""

    def __init__(
        self,
        levels: Sequence[int],
        capacity: int,
        high_water: float = 0.75,
        low_water: float = 0.25,
        recover_patience: int = 4,
        segments: int = 1,
    ):
        levels = tuple(int(x) for x in levels)
        if not levels or any(x <= 0 for x in levels):
            raise ValueError(f"iteration levels must be positive: {levels!r}")
        if list(levels) != sorted(set(levels), reverse=True):
            raise ValueError(
                f"iteration levels must be strictly descending: {levels!r}"
            )
        validate_segment_levels(levels, segments)
        self.segments = int(segments)
        if not 0.0 <= low_water < high_water <= 1.0:
            raise ValueError(
                f"want 0 <= low_water < high_water <= 1, got "
                f"{low_water}/{high_water}"
            )
        self.levels = levels
        self.capacity = max(1, int(capacity))
        self.high_water = float(high_water)
        self.low_water = float(low_water)
        self.recover_patience = max(1, int(recover_patience))
        self._level = 0  # index into levels; 0 = full quality
        self._calm = 0  # consecutive at/below-low_water decisions
        self.drops = 0
        self.recoveries = 0
        self.slo_drops = 0  # drops the SLO verdict caused (occupancy alone would not)
        self.decisions: List[int] = [0] * len(levels)
        # Executed-iterations EWMA (early exit); None until the first
        # observation, when the controller assumes the top level.
        self._exec_ewma: Optional[float] = None
        self.exec_alpha = 0.25

    @property
    def level(self) -> int:
        return self._level

    @property
    def iters(self) -> int:
        """Current budget without making a decision."""
        return self.levels[self._level]

    def note_executed(self, executed_iters: float) -> None:
        """Feed one batch's mean executed iteration count, clamped into
        [1, levels[0]] so a bogus observation cannot corrupt the scale."""
        x = min(float(self.levels[0]), max(1.0, float(executed_iters)))
        if self._exec_ewma is None:
            self._exec_ewma = x
        else:
            a = self.exec_alpha
            self._exec_ewma = a * x + (1.0 - a) * self._exec_ewma

    @property
    def expected_iters(self) -> float:
        """The per-request cost model: the executed-iterations EWMA, or
        the top level before any observation."""
        if self._exec_ewma is None:
            return float(self.levels[0])
        return self._exec_ewma

    def expected_scale(self) -> float:
        """The share of the top level a request is expected to cost (1.0
        unfed): a queue of requests that exit after half their budget is
        half the work its depth says."""
        return min(1.0, self.expected_iters / float(self.levels[0]))

    def decide(self, queue_depth: int, slo_degraded: bool = False) -> int:
        """Observe ``queue_depth`` and the SLO verdict, maybe move one level,
        and return the iteration budget for the batch being assembled.
        Occupancy is the depth's share of the capacity scaled by
        :meth:`expected_scale`. ``slo_degraded`` (the telemetry hub's
        ``slo_paging("serve")``) degrades as a high-water occupancy does,
        one level a decision, and is not scaled: a burning objective
        degrades however cheap a request is expected to be. Recovery needs
        both: no page and calm occupancy for the patience window."""
        occ = min(1.0, (max(0, int(queue_depth)) / self.capacity) * self.expected_scale())
        if occ >= self.high_water or slo_degraded:
            self._calm = 0
            if self._level < len(self.levels) - 1:
                self._level += 1
                self.drops += 1
                if slo_degraded and occ < self.high_water:
                    self.slo_drops += 1
        elif occ <= self.low_water:
            self._calm += 1
            if self._calm >= self.recover_patience and self._level > 0:
                self._level -= 1
                self.recoveries += 1
                self._calm = 0
        else:
            # Between the watermarks: hold the level, reset patience.
            self._calm = 0
        self.decisions[self._level] += 1
        return self.levels[self._level]

    def summary(self) -> str:
        per = " ".join(f"{it}it={n}" for it, n in zip(self.levels, self.decisions))
        return (
            f"budget: level={self._level} ({self.iters} iters) "
            f"expected={self.expected_iters:.1f} "
            f"drops={self.drops} recoveries={self.recoveries} [{per}]"
        )
