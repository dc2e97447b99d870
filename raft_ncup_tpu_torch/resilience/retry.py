"""Bounded exponential-backoff retry of host I/O (port of
``raft_ncup_tpu/resilience/retry.py``).

A transient read or write error (an NFS stall during a dataset read or a
checkpoint save) must not end a long run, and an unbounded retry must not
hang it: every retry here is bounded, backs off exponentially and is
counted in a :class:`RetryStats`, which the trainer writes to ``log.txt``
at the end of the run. Every retry, give-up and quarantine is also a
telemetry event (``io_retry``, ``io_giveup``, ``io_sample_quarantined``),
whose counters carry the canonical names
(``LEGACY_KEY_ALIASES["retry"]``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple, TypeVar

from raft_ncup_tpu_torch.observability import get_telemetry

T = TypeVar("T")


@dataclass(eq=False)  # a counter object: identity, not value, equality
class RetryStats:
    """One run's I/O-fault accounting. Thread-safe: the loader's workers
    fail concurrently. Mutate through ``note_*`` and ``quarantine``."""

    retries: int = 0  # failed attempts that were retried
    giveups: int = 0  # operations that exhausted their attempts
    quarantined: list = field(default_factory=list)  # sample indices given up on
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def note_retry(self) -> None:
        with self._lock:
            self.retries += 1

    def note_giveup(self) -> None:
        with self._lock:
            self.giveups += 1

    def quarantine(self, index: int) -> bool:
        """Record a quarantined index once; False if already recorded."""
        with self._lock:
            if index in self.quarantined:
                return False
            self.quarantined.append(index)
        get_telemetry().event("io_sample_quarantined", index=index)
        return True

    @property
    def clean(self) -> bool:
        return not (self.retries or self.giveups or self.quarantined)

    def summary(self) -> str:
        q = ",".join(str(i) for i in self.quarantined) or "-"
        return f"retries={self.retries} giveups={self.giveups} quarantined=[{q}]"


def retry_io(
    fn: Callable[[], T],
    *,
    attempts: int = 3,
    base_delay_s: float = 0.05,
    max_delay_s: float = 2.0,
    retry_on: Tuple[type, ...] = (OSError,),
    stats: Optional[RetryStats] = None,
    desc: str = "io",
    sleep: Callable[[float], None] = time.sleep,
    log: Optional[Callable[[str], None]] = None,
) -> T:
    """Call ``fn``, retrying up to ``attempts`` times on ``retry_on`` with
    delays doubling from ``base_delay_s`` up to ``max_delay_s``. The last
    failure re-raises the original exception after counting a give-up.
    ``sleep`` can be replaced, so tests run on a fake clock."""
    delay = base_delay_s
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            if attempt >= attempts:
                if stats is not None:
                    stats.note_giveup()
                get_telemetry().event("io_giveup", desc=desc)
                raise
            attempt += 1
            if stats is not None:
                stats.note_retry()
            get_telemetry().event("io_retry", desc=desc, attempt=attempt)
            if log is not None:
                log(f"{desc}: attempt {attempt}/{attempts} failed ({e}); "
                    f"retrying in {delay:.2f}s")
            sleep(delay)
            delay = min(delay * 2.0, max_delay_s)
