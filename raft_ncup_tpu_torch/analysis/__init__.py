"""Runtime guards of the port (``raft_ncup_tpu/analysis/`` holds the JAX
package's, with its static lint, which the port does not have): see
:mod:`raft_ncup_tpu_torch.analysis.guards`."""

from raft_ncup_tpu_torch.analysis.guards import (
    GuardStats,
    GuardViolation,
    RecompileWatchdog,
    StepGuard,
    collective_read,
    flag_read,
    forbid_host_transfers,
    host_read,
    mark_host_thread,
    max_recompiles,
    note_compile,
    stage_out,
)

__all__ = [
    "GuardStats",
    "GuardViolation",
    "RecompileWatchdog",
    "StepGuard",
    "collective_read",
    "flag_read",
    "forbid_host_transfers",
    "host_read",
    "mark_host_thread",
    "max_recompiles",
    "note_compile",
    "stage_out",
]
