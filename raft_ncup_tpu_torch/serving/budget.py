"""Load-adaptive anytime iteration budget with hysteresis (port of
``raft_ncup_tpu/serving/budget.py``, without pipeline segments, the SLO
input and the early-exit cost model, which land with later slices).

RAFT refines flow iteratively, and stopping early gives a coarser but
valid field, so the iteration count is a latency/quality knob the server
turns under load. The level set is small and fixed (descending).
Degrading is immediate (occupancy >= ``high_water`` moves one level
down); recovering needs ``recover_patience`` consecutive decisions at or
below ``low_water``, so a load sitting on a threshold does not flap.
"""

from __future__ import annotations

from typing import List, Sequence


class IterationBudgetController:
    """Map admission-queue occupancy to a GRU iteration budget."""

    def __init__(
        self,
        levels: Sequence[int],
        capacity: int,
        high_water: float = 0.75,
        low_water: float = 0.25,
        recover_patience: int = 4,
    ):
        levels = tuple(int(x) for x in levels)
        if not levels or any(x <= 0 for x in levels):
            raise ValueError(f"iteration levels must be positive: {levels!r}")
        if list(levels) != sorted(set(levels), reverse=True):
            raise ValueError(
                f"iteration levels must be strictly descending: {levels!r}"
            )
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
        self.decisions: List[int] = [0] * len(levels)

    @property
    def level(self) -> int:
        return self._level

    @property
    def iters(self) -> int:
        """Current budget without making a decision."""
        return self.levels[self._level]

    def decide(self, queue_depth: int) -> int:
        """Observe ``queue_depth``, maybe move one level, and return the
        iteration budget for the batch being assembled."""
        occ = min(1.0, max(0, int(queue_depth)) / self.capacity)
        if occ >= self.high_water:
            self._calm = 0
            if self._level < len(self.levels) - 1:
                self._level += 1
                self.drops += 1
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
            f"drops={self.drops} recoveries={self.recoveries} [{per}]"
        )
