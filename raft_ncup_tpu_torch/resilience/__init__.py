"""Fault tolerance of the trainer (port of ``raft_ncup_tpu/resilience/``):
retried host I/O (``retry``), deterministic fault injection (``chaos``)
and the preemption protocol with its exit codes (``preemption``). The
divergence sentinel lives in ``training/sentinel.py``."""

from raft_ncup_tpu_torch.resilience.chaos import ChaosDataset, ChaosSpec, chaos_batches
from raft_ncup_tpu_torch.resilience.preemption import (
    EXIT_DIVERGED,
    EXIT_PREEMPTED,
    PreemptionHandler,
    resume_metadata,
)
from raft_ncup_tpu_torch.resilience.retry import RetryStats, retry_io

__all__ = [
    "ChaosDataset", "ChaosSpec", "chaos_batches", "EXIT_DIVERGED", "EXIT_PREEMPTED",
    "PreemptionHandler", "resume_metadata", "RetryStats", "retry_io",
]
