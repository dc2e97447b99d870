"""Deterministic multi-phase and mixed-resolution traffic (port of
``raft_ncup_tpu/traffic.py``).

``serving/traffic.SyntheticTraffic`` is one arrival rate for the whole
run; the questions elasticity asks are about rate changes: how long
after a load step new capacity takes traffic, whether a scale-down under
load loses anything. :class:`StepTraffic` strings :class:`TrafficPhase`
segments (each its own inter-arrival interval) into one schedule whose
due times, frame content and phase attribution are pure functions of
``(seed, phases)``. :class:`MixedResolutionTraffic` draws each request's
size from a zipf law over a list of sizes.

Three consumption shapes, one schedule:

- ``iter(traffic)`` yields ``(due_s, image1, image2)``, as
  ``serving/traffic.replay`` takes them;
- :meth:`items` yields ``fleet/router.replay_fleet`` dicts
  (``image1``/``image2`` + ``due_s``/``phase``/``index`` riders);
- :meth:`schedule` yields the rich records (global index, phase name,
  due time, frames).

Chaos composes as for the single-rate stream: ``burst@N`` expands request
``N`` into ``burst_size`` simultaneous arrivals, ``poison@N`` NaNs request
``N``'s first frame; ``N`` is the global request index across phases.

Frames come from the port's ``data/synthetic.SyntheticFlowDataset`` as
uint8 host arrays (``serving/traffic.host_pair``). The schedule (phases,
due times, which dataset index each arrival takes, bursts and poison) is
the JAX package's draw for draw; the port's synthetic pairs themselves
are not the JAX package's pixels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from raft_ncup_tpu_torch.data.synthetic import SyntheticFlowDataset
from raft_ncup_tpu_torch.resilience.chaos import ChaosSpec
from raft_ncup_tpu_torch.serving.traffic import host_pair

__all__ = [
    "TrafficPhase", "StepTraffic", "TrafficItem",
    "MixedResolutionTraffic",
]


@dataclass(frozen=True)
class TrafficPhase:
    """One constant-rate segment of a schedule. ``interval_s`` is the
    inter-arrival gap inside the phase (0 = as fast as the caller
    submits)."""

    name: str
    n_requests: int
    interval_s: float

    def __post_init__(self) -> None:
        if self.n_requests < 0:
            raise ValueError(f"n_requests must be >= 0: {self.n_requests}")
        if self.interval_s < 0:
            raise ValueError(f"interval_s must be >= 0: {self.interval_s}")


@dataclass(frozen=True)
class TrafficItem:
    """One scheduled arrival, fully attributed."""

    index: int          # global request index (the chaos coordinate)
    phase: str
    due_s: float        # seconds from schedule start
    image1: np.ndarray
    image2: np.ndarray


class StepTraffic:
    """A deterministic multi-phase arrival schedule.

    Due times accumulate across phases: phase k+1's first request is
    due one of ITS intervals after phase k's last — a step is a rate
    change at an instant, not a gap. Frame content is keyed on the
    global emission index through ``SyntheticFlowDataset`` exactly like
    the single-rate stream, so two runs (or two benches) replaying the
    same ``(seed, phases)`` submit identical bytes.
    """

    def __init__(
        self,
        size_hw: Tuple[int, int],
        phases: List[TrafficPhase],
        *,
        seed: int = 0,
        burst_size: int = 8,
        chaos: Optional[ChaosSpec] = None,
        style: str = "smooth",
    ):
        if not phases:
            raise ValueError("a schedule needs at least one phase")
        names = [p.name for p in phases]
        if len(set(names)) != len(names):
            raise ValueError(f"phase names must be unique: {names}")
        self.size_hw = tuple(size_hw)
        self.phases = list(phases)
        self.burst_size = max(1, int(burst_size))
        self.chaos = chaos or ChaosSpec()
        self.n_requests = sum(p.n_requests for p in phases)
        live_bursts = sum(
            1 for i in self.chaos.burst_requests if i < self.n_requests
        )
        self._total = self.n_requests + live_bursts * (self.burst_size - 1)
        self._ds = SyntheticFlowDataset(
            self.size_hw, length=max(1, self._total), seed=seed,
            style=style,
        )

    @classmethod
    def step(
        cls,
        size_hw: Tuple[int, int],
        *,
        low_n: int = 8,
        high_n: int = 24,
        low_interval_s: float = 0.25,
        high_interval_s: float = 0.02,
        seed: int = 0,
        **kw,
    ) -> "StepTraffic":
        """The canonical elasticity scenario: low → high → low. The
        high phase is what must force a scale-up; the trailing low
        phase is what must let the scale-down drain with zero loss."""
        return cls(size_hw, [
            TrafficPhase("low", low_n, low_interval_s),
            TrafficPhase("high", high_n, high_interval_s),
            TrafficPhase("cooldown", low_n, low_interval_s),
        ], seed=seed, **kw)

    def __len__(self) -> int:
        return self._total

    def phase_bounds(self) -> Dict[str, Tuple[int, int]]:
        """``{phase name: (first, past-last)}`` in GLOBAL request
        indices — what turns a per-request latency list into per-phase
        percentiles, and what aims chaos coordinates at a phase."""
        bounds: Dict[str, Tuple[int, int]] = {}
        start = 0
        for p in self.phases:
            bounds[p.name] = (start, start + p.n_requests)
            start += p.n_requests
        return bounds

    def schedule(self) -> Iterator[TrafficItem]:
        """The rich schedule: every arrival with its phase attribution.
        Burst copies share their trigger's index, phase, and due time
        (they ARE request N, multiplied)."""
        emitted = 0
        index = 0
        due = 0.0
        for p in self.phases:
            for _ in range(p.n_requests):
                due += p.interval_s
                copies = (
                    self.burst_size
                    if index in self.chaos.burst_requests else 1
                )
                for _ in range(copies):
                    img1, img2 = host_pair(self._ds, emitted)
                    if index in self.chaos.poison_requests:
                        img1 = np.full(img1.shape, np.nan, np.float32)
                    emitted += 1
                    yield TrafficItem(
                        index=index, phase=p.name, due_s=due,
                        image1=img1, image2=img2,
                    )
                index += 1

    def __iter__(self) -> Iterator[Tuple[float, np.ndarray, np.ndarray]]:
        """``serving/traffic.replay`` compatibility: bare
        ``(due_s, image1, image2)`` triples."""
        for item in self.schedule():
            yield item.due_s, item.image1, item.image2

    def items(self) -> Iterator[dict]:
        """``fleet/router.replay_fleet`` compatibility: one dict per
        arrival (extra keys ride along for the bench's attribution)."""
        for item in self.schedule():
            yield {
                "image1": item.image1,
                "image2": item.image2,
                "due_s": item.due_s,
                "phase": item.phase,
                "index": item.index,
            }


class MixedResolutionTraffic:
    """Deterministic mixed-RESOLUTION arrival schedule with a zipf
    popularity law over frame sizes.

    Production flow traffic is not one synthetic shape: a few sizes
    dominate (the product's default capture resolutions) with a long
    tail of odd ones — the classic zipf shape. This scenario draws each
    request's size from ``P(rank r) ∝ (r+1)^-exponent`` over ``sizes``
    (listed most-popular first), with one ``SyntheticFlowDataset`` per
    size so frame content stays a pure function of ``(seed, sizes)`` —
    the same schedule replays bitwise-identically into any consumer.

    Attribution reuses :class:`TrafficItem` with the size name (e.g.
    ``"96x128"``) as the phase, so per-size latency/exec-iters breakouts
    fall out of the same phase bucketing the step schedule uses. Chaos
    composes identically: coordinates are global request indices
    (``burst@N`` multiplies request N at its size; ``poison@N`` NaNs its
    first frame).
    """

    def __init__(
        self,
        sizes,
        n_requests: int,
        *,
        exponent: float = 1.1,
        interval_s: float = 0.0,
        seed: int = 0,
        burst_size: int = 8,
        chaos: Optional[ChaosSpec] = None,
        style: str = "smooth",
    ):
        self.sizes = [tuple(int(x) for x in s) for s in sizes]
        if not self.sizes:
            raise ValueError("a mixed-resolution schedule needs sizes")
        if len(set(self.sizes)) != len(self.sizes):
            raise ValueError(f"sizes must be unique: {self.sizes}")
        if exponent <= 0:
            raise ValueError(f"zipf exponent must be > 0: {exponent}")
        self.n_requests = int(n_requests)
        if self.n_requests < 0:
            raise ValueError(f"n_requests must be >= 0: {n_requests}")
        self.exponent = float(exponent)
        self.interval_s = float(interval_s)
        self.burst_size = max(1, int(burst_size))
        self.chaos = chaos or ChaosSpec()
        # The zipf popularity law over size RANKS (list order = rank).
        weights = np.array(
            [(r + 1.0) ** -self.exponent for r in range(len(self.sizes))]
        )
        probs = weights / weights.sum()
        # default_rng(seed): the assignment is a pure function of
        # (seed, sizes, exponent, n) — replays are bitwise-identical.
        rng = np.random.default_rng(seed)
        self._assign = rng.choice(
            len(self.sizes), size=self.n_requests, p=probs
        )
        live_bursts = sum(
            1 for i in self.chaos.burst_requests if i < self.n_requests
        )
        self._total = self.n_requests + live_bursts * (self.burst_size - 1)
        # Per-size emission totals (burst copies included) size each
        # size's dataset exactly once, up front.
        totals = [0] * len(self.sizes)
        for index, s in enumerate(self._assign):
            copies = (
                self.burst_size
                if index in self.chaos.burst_requests else 1
            )
            totals[s] += copies
        self._ds = [
            SyntheticFlowDataset(
                size, length=max(1, totals[k]), seed=seed, style=style
            )
            for k, size in enumerate(self.sizes)
        ]

    @staticmethod
    def size_name(size_hw: Tuple[int, int]) -> str:
        return f"{size_hw[0]}x{size_hw[1]}"

    def __len__(self) -> int:
        return self._total

    def size_counts(self) -> Dict[str, int]:
        """``{size name: request count}`` (burst copies counted with
        their trigger, matching ``phase_bounds``'s request-not-emission
        accounting) — what a bench row reports as the measured mix."""
        counts = {self.size_name(s): 0 for s in self.sizes}
        for s in self._assign:
            counts[self.size_name(self.sizes[s])] += 1
        return counts

    def schedule(self) -> Iterator[TrafficItem]:
        """Every arrival with its size attribution in the phase field.
        Burst copies share their trigger's index, phase, and due time."""
        emitted = [0] * len(self.sizes)
        due = 0.0
        for index, s in enumerate(self._assign):
            s = int(s)
            due += self.interval_s
            copies = (
                self.burst_size
                if index in self.chaos.burst_requests else 1
            )
            for _ in range(copies):
                img1, img2 = host_pair(self._ds[s], emitted[s])
                if index in self.chaos.poison_requests:
                    img1 = np.full(img1.shape, np.nan, np.float32)
                emitted[s] += 1
                yield TrafficItem(
                    index=index, phase=self.size_name(self.sizes[s]),
                    due_s=due, image1=img1, image2=img2,
                )

    def __iter__(self) -> Iterator[Tuple[float, np.ndarray, np.ndarray]]:
        """``serving/traffic.replay`` compatibility: bare
        ``(due_s, image1, image2)`` triples."""
        for item in self.schedule():
            yield item.due_s, item.image1, item.image2

    def items(self) -> Iterator[dict]:
        """``fleet/router.replay_fleet`` compatibility: one dict per
        arrival (extra keys ride along for the bench's attribution)."""
        for item in self.schedule():
            yield {
                "image1": item.image1,
                "image2": item.image2,
                "due_s": item.due_s,
                "phase": item.phase,
                "index": item.index,
            }
