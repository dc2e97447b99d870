"""The port's lint rule registry — one module per JGL rule, under the JAX
package's rule IDs (``raft_ncup_tpu/analysis/rules/``), each with its
torch meaning in its docstring.

Per-module rules expose ``RULE_ID``, ``SUMMARY`` and
``check(ctx: ModuleContext) -> Iterator[Finding]``; whole-program rules
(JGL011+) expose ``check_project(proj: ProjectIndex)`` instead and run
once over the cross-module graph after the per-module pass. Adding a
rule means adding a module here and listing it in ``ALL_RULES``; the
engine, CLI ``--select`` filtering, catalog output and tests pick it up
from the registry.
"""

from __future__ import annotations

from raft_ncup_tpu_torch.analysis.rules import (
    jgl001_host_sync,
    jgl002_donation,
    jgl003_nondeterminism,
    jgl004_tracer_control_flow,
    jgl005_dtype_hygiene,
    jgl006_partition_axes,
    jgl007_swallowed_exceptions,
    jgl008_eval_loop_pulls,
    jgl009_precision_policy,
    jgl010_telemetry_isolation,
    jgl011_lock_discipline,
    jgl012_wire_contract,
    jgl013_env_knobs,
)

ALL_RULES = (
    jgl001_host_sync,
    jgl002_donation,
    jgl003_nondeterminism,
    jgl004_tracer_control_flow,
    jgl005_dtype_hygiene,
    jgl006_partition_axes,
    jgl007_swallowed_exceptions,
    jgl008_eval_loop_pulls,
    jgl009_precision_policy,
    jgl010_telemetry_isolation,
    jgl011_lock_discipline,
    jgl012_wire_contract,
    jgl013_env_knobs,
)

RULES_BY_ID = {mod.RULE_ID: mod for mod in ALL_RULES}
