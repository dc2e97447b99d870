"""Correctness tooling for the port's sync-free hot path, in two halves
that hold one set of invariants:

- **the static lint** (``lint.py``, ``astutil.py``, ``project.py`` and
  ``rules/``): AST analysis with rules JGL001-JGL013, each with its
  PyTorch/CUDA meaning — host syncs, nondeterminism and branches on
  tensor values in traced code (CUDA-graph captures, autograd functions,
  module forwards), graphs captured without a shared pool, dtype
  hygiene, the precision policy, mesh axis names, per-iteration pulls in
  the serving loops, swallowed exceptions, host-only telemetry, lock
  discipline, the fleet's wire keys and the env-knob registry. Run it
  with ``python -m raft_ncup_tpu_torch.analysis --strict-allowlist
  raft_ncup_tpu_torch/ chip_*.py``; audited exceptions live in
  ``allowlist.txt``. Pure stdlib: it builds nothing and touches no card.
  Its JAX counterpart is ``raft_ncup_tpu/analysis/lint.py`` and
  ``rules/`` (same rule IDs, allowlist format, CLI and JSON document).
- **the runtime guards** (``guards.py``): ``forbid_host_transfers``,
  ``RecompileWatchdog``/``max_recompiles`` and ``StepGuard`` assert the
  same invariants live, on the running loops, and ``host_read``,
  ``flag_read`` and ``collective_read`` are the sanctioned reads. Its
  JAX counterpart is ``raft_ncup_tpu/analysis/guards.py``.

The lint proves the invariants before anything runs; the guards catch
what static analysis cannot see (a transfer at dispatch, a new shape
that captures another graph).
"""

from raft_ncup_tpu_torch.analysis.astutil import Finding
from raft_ncup_tpu_torch.analysis.lint import (
    LintResult,
    load_allowlist,
    main,
    run_lint,
)

# The guards' names, imported at their first use (guards.py imports
# torch; the lint must start without it).
_GUARD_EXPORTS = (
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
)
__all__ = ["Finding", "LintResult", "load_allowlist", "main", "run_lint",
           *_GUARD_EXPORTS]


def __getattr__(name: str):
    if name in _GUARD_EXPORTS:
        from raft_ncup_tpu_torch.analysis import guards

        return getattr(guards, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
