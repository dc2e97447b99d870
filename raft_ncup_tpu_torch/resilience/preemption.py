"""Preemption-safe shutdown and the identity of a resumed run (port of
``raft_ncup_tpu/resilience/preemption.py`` for one process).

:class:`PreemptionHandler` turns SIGTERM and SIGINT into a flag, which the
train loop reads at each step boundary (:meth:`PreemptionHandler.poll`);
on a raised flag it saves one checkpoint and exits :data:`EXIT_PREEMPTED`.
A second signal restores the previous handlers, so a third is fatal.
Processes do not agree on the step yet: that arrives with the multi-GPU
slice (ROADMAP.md, queue 1 item 9).

:func:`resume_metadata` pins the run's identity (variant, a fingerprint of
the model configuration, seed) next to its checkpoints; the checkpoint
manager checks it before any restore.

Exit codes, away from 0/1 so that a wrapper can tell them apart:
``EXIT_PREEMPTED`` (75): stopped cleanly, state saved, safe to requeue;
``EXIT_DIVERGED`` (76): the sentinel halted the run and it was rolled
back to its latest checkpoint.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import signal
import sys
from typing import Any, Sequence

EXIT_PREEMPTED = 75  # EX_TEMPFAIL: re-runnable, state saved
EXIT_DIVERGED = 76  # EX_PROTOCOL: training diverged, rolled back


def config_fingerprint(model_cfg: Any) -> str:
    """16 hex digits of the SHA-256 of the model configuration's JSON."""
    text = json.dumps(dataclasses.asdict(model_cfg), sort_keys=True, default=str)
    return hashlib.sha256(text.encode("utf-8")).hexdigest()[:16]


def resume_metadata(model_cfg: Any, train_cfg: Any) -> dict:
    """The identity saved beside the checkpoints and checked on restore."""
    return {
        "model_variant": model_cfg.variant,
        "config_fingerprint": config_fingerprint(model_cfg),
        "seed": int(train_cfg.seed),
    }


class PreemptionHandler:
    """Context manager: SIGTERM/SIGINT set a flag that ``poll`` reads."""

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM, signal.SIGINT)):
        self.signals = tuple(signals)
        self._requested = False
        self._previous: dict = {}

    @property
    def requested(self) -> bool:
        return self._requested

    def _handle(self, signum, frame) -> None:
        if self._requested:
            # A second signal: stop intercepting, so the next one is fatal.
            self._restore()
            return
        self._requested = True
        print(f"preemption: received signal {signum}; will checkpoint and exit at the "
              "next step boundary", file=sys.stderr)

    def __enter__(self) -> "PreemptionHandler":
        for s in self.signals:
            self._previous[s] = signal.signal(s, self._handle)
        return self

    def __exit__(self, *exc) -> None:
        self._restore()

    def _restore(self) -> None:
        for s, prev in self._previous.items():
            try:
                signal.signal(s, prev)
            except (OSError, ValueError) as e:  # not the main thread, or teardown
                print(f"preemption: could not restore signal {s}: {e}", file=sys.stderr)
        self._previous = {}

    def poll(self, step: int) -> bool:
        """Whether to stop at the boundary before step ``step``."""
        return self._requested
