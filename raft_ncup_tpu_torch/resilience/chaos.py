"""Deterministic fault injection (port of ``raft_ncup_tpu/resilience/chaos.py``).

A fault is addressed by a deterministic coordinate, so a failing run
replays exactly. The spec (``--chaos``) is comma-joined ``kind@N``
events. :class:`ChaosSpec` parses and renders every kind of the JAX
package, so a spec round-trips as it does there; the trainer acts on the
training kinds:

- ``nan@S``: the batch that (0-based) step ``S`` consumes gets an all-NaN
  flow, so the loss is not finite and the sentinel must skip the update
  (:func:`chaos_batches`);
- ``ioerror@N``: the ``N``-th (0-based, process-wide) ``dataset.sample``
  read raises ``IOError``, which the loader must retry
  (:class:`ChaosDataset`);
- ``sigterm@S``: a real SIGTERM reaches the trainer right after it
  completes ``S`` attempted steps, so it must save and exit 75.

The serve entry acts on the serving kinds (``burst``, ``poison``,
``sigterm``: ``serving/traffic.py``) and the streaming kinds
(``corruptframe``, ``abandon``, ``burst``, ``sigterm``:
``streaming/traffic.py``). The fleet kinds act through
``fleet/router.replay_fleet`` at submission indices: ``killreplica@N``
SIGKILLs, ``stallreplica@N`` SIGSTOPs and ``drainreplica@N`` SIGTERM-drains
the replica that carried submission ``N``; ``partitionhost@N`` and
``killsupervisor@N`` cut off or kill that replica's host agent
(``fleet/host_supervisor.FleetManager``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator, Optional

import numpy as np

_KINDS = ("nan", "ioerror", "sigterm", "burst", "poison", "corruptframe",
          "abandon", "killreplica", "stallreplica", "drainreplica",
          "partitionhost", "killsupervisor")


@dataclass(frozen=True)
class ChaosSpec:
    """Parsed fault-injection plan. Empty spec = no chaos."""

    nan_steps: frozenset = frozenset()
    ioerror_reads: frozenset = frozenset()
    sigterm_after: Optional[int] = None
    burst_requests: frozenset = frozenset()
    poison_requests: frozenset = frozenset()
    corrupt_frames: frozenset = frozenset()
    abandon_frames: frozenset = frozenset()
    kill_replica_at: frozenset = frozenset()
    stall_replica_at: frozenset = frozenset()
    drain_replica_at: frozenset = frozenset()
    partition_host_at: frozenset = frozenset()
    kill_supervisor_at: frozenset = frozenset()

    @classmethod
    def parse(cls, spec: Optional[str]) -> "ChaosSpec":
        sets: dict = {k: set() for k in _KINDS if k != "sigterm"}
        sig: Optional[int] = None
        for token in (spec or "").split(","):
            token = token.strip()
            if not token:
                continue
            kind, sep, value = token.partition("@")
            if not sep or kind not in _KINDS:
                raise ValueError(
                    f"bad chaos event {token!r} (want one of "
                    f"{'/'.join(_KINDS)}@N, comma-joined)"
                )
            n = int(value)
            if kind == "sigterm":
                sig = n
            else:
                sets[kind].add(n)
        return cls(
            frozenset(sets["nan"]),
            frozenset(sets["ioerror"]),
            sig,
            frozenset(sets["burst"]),
            frozenset(sets["poison"]),
            frozenset(sets["corruptframe"]),
            frozenset(sets["abandon"]),
            frozenset(sets["killreplica"]),
            frozenset(sets["stallreplica"]),
            frozenset(sets["drainreplica"]),
            frozenset(sets["partitionhost"]),
            frozenset(sets["killsupervisor"]),
        )

    @property
    def active(self) -> bool:
        return bool(self.nan_steps or self.ioerror_reads
                    or self.burst_requests or self.poison_requests
                    or self.corrupt_frames or self.abandon_frames
                    or self.kill_replica_at or self.stall_replica_at
                    or self.drain_replica_at or self.partition_host_at
                    or self.kill_supervisor_at
                    or self.sigterm_after is not None)

    def render(self) -> str:
        parts = [f"nan@{s}" for s in sorted(self.nan_steps)]
        parts += [f"ioerror@{n}" for n in sorted(self.ioerror_reads)]
        parts += [f"burst@{n}" for n in sorted(self.burst_requests)]
        parts += [f"poison@{n}" for n in sorted(self.poison_requests)]
        parts += [f"corruptframe@{n}" for n in sorted(self.corrupt_frames)]
        parts += [f"abandon@{n}" for n in sorted(self.abandon_frames)]
        parts += [f"killreplica@{n}" for n in sorted(self.kill_replica_at)]
        parts += [f"stallreplica@{n}" for n in sorted(self.stall_replica_at)]
        parts += [f"drainreplica@{n}" for n in sorted(self.drain_replica_at)]
        parts += [
            f"partitionhost@{n}" for n in sorted(self.partition_host_at)
        ]
        parts += [
            f"killsupervisor@{n}" for n in sorted(self.kill_supervisor_at)
        ]
        if self.sigterm_after is not None:
            parts.append(f"sigterm@{self.sigterm_after}")
        return ",".join(parts) or "<none>"


def chaos_batches(
    batches: Iterable[dict],
    nan_steps: frozenset,
    start_step: int = 0,
    log: Optional[Callable[[str], None]] = None,
) -> Iterator[dict]:
    """Wrap a host-batch stream, poisoning the flow of selected steps.

    Batch ``i`` of the stream is the one training step ``start_step + i``
    consumes (the loader/prefetcher are order-preserving), so ``nan@S``
    lands on exactly step ``S`` regardless of prefetch depth.
    """
    for i, batch in enumerate(batches):
        step = start_step + i
        if step in nan_steps:
            batch = dict(batch)
            flow = np.array(batch["flow"], dtype=np.float32, copy=True)
            flow[...] = np.nan
            batch["flow"] = flow
            if log is not None:
                log(f"chaos: NaN flow injected into the batch for step {step}")
        yield batch


class ChaosDataset:
    """Dataset wrapper raising ``IOError`` on configured global reads.

    The read counter is process-global across loader worker threads
    (lock-guarded), so ``ioerror@N`` means "the N-th sample() call this
    process makes", independent of which worker lands on it.
    """

    def __init__(self, dataset, ioerror_reads: frozenset):
        self._dataset = dataset
        self._fail = frozenset(int(n) for n in ioerror_reads)
        self._lock = threading.Lock()
        self._reads = 0

    def __len__(self) -> int:
        return len(self._dataset)

    def __getattr__(self, name):  # is_test etc. pass through
        return getattr(self._dataset, name)

    def sample(self, index: int, rng=None):
        with self._lock:
            n = self._reads
            self._reads += 1
        if n in self._fail:
            raise IOError(
                f"chaos: injected IOError on dataset read {n} "
                f"(sample index {index})"
            )
        return self._dataset.sample(index, rng)
