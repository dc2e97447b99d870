"""JGL011 — cross-module lock discipline for the control plane.

The meaning is the JAX rule's
(``raft_ncup_tpu/analysis/rules/jgl011_lock_discipline.py``): the port's
fleet supervisor, router and telemetry hub are the same threaded Python
(a lock-order fault between the fleet supervisor and the router was one
of the port's own faults).

For every class under ``fleet/`` or ``observability/`` that owns a
``threading.Lock/RLock/Condition`` instance attribute: an instance
attribute that is WRITTEN under the lock somewhere must not be read or
written outside it anywhere else — in any method, any nested closure,
or any other module that reaches the attribute through an object
reference. The finding names both sites, because that is what makes a
data race auditable: the guarded write proves the author considered the
attribute shared, the unguarded touch is the hole chaos tests can only
hope to hit (docs/ANALYSIS.md "Whole-program rules").

What does NOT count as unguarded:

- accesses directly in ``__init__`` (construction is single-threaded —
  no other thread holds a reference yet);
- accesses in a private method whose every observed call site holds the
  lock (or is itself such a method, or is ``__init__``) — the
  "always-locked helper" pattern (``FleetRouter._register``). Public
  methods and methods whose references escape (``target=self._loop``)
  are assumed to have callers the analysis cannot see;
- cross-module accesses guarded by ``with <obj>.<lock>:`` on the same
  base expression (``replay_fleet``'s ``with router._lock:``);
- attributes never written under the lock at all: a class that guards
  nothing about an attribute gets no opinion from this rule.

Lexical blind spots (a lock object shared across instances, a
``Condition.wait`` releasing mid-block) are allowlist material, not
rule extensions — see docs/ANALYSIS.md.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Set

from raft_ncup_tpu_torch.analysis.astutil import Finding
from raft_ncup_tpu_torch.analysis.project import ClassInfo, ProjectIndex

RULE_ID = "JGL011"
SUMMARY = (
    "attribute written under its class lock but read/written without "
    "it elsewhere (whole-program)"
)


def _in_scope(path: str) -> bool:
    p = path.replace("\\", "/")
    return (
        "/fleet/" in p
        or p.startswith("fleet/")
        or "/observability/" in p
        or p.startswith("observability/")
    )


def _always_locked(info: ClassInfo) -> Set[str]:
    """Private methods of ``info`` provably entered only with the lock
    held: every observed call site is lock-guarded, in ``__init__``, or
    in another always-locked method — and the method's reference never
    escapes. Fixpoint over the per-class call graph."""
    escaped = {e.callee for e in info.call_events if not e.is_call}
    calls: Dict[str, List] = {}
    for e in info.call_events:
        if e.is_call:
            calls.setdefault(e.callee, []).append(e)
    always: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for m in info.methods:
            if m in always:
                continue
            if not m.startswith("_") or m.startswith("__"):
                continue  # public / dunder: unseen callers assumed
            if m in escaped or m not in calls:
                continue
            if all(
                e.guarded
                or e.in_init
                or (not e.in_nested and e.method in always)
                for e in calls[m]
            ):
                always.add(m)
                changed = True
    return always


def _effectively_guarded(a, always: Set[str]) -> bool:
    if a.guarded:
        return True
    return not a.in_nested and a.method in always


def check_project(proj: ProjectIndex) -> Iterator[Finding]:
    # attr name -> lock-owning classes with a locked write to it, for
    # attributing cross-module accesses. Only private attrs are matched
    # externally, and only when exactly one class owns the name —
    # ambiguity would produce noise, not findings.
    ext_owners: Dict[str, List[tuple]] = {}
    findings: List[Finding] = []

    for info in proj.classes:
        if not _in_scope(info.path):
            continue
        always = _always_locked(info)
        by_attr: Dict[str, List] = {}
        for a in info.accesses:
            by_attr.setdefault(a.attr, []).append(a)
        for attr, accs in sorted(by_attr.items()):
            locked_writes = [
                a for a in accs
                if a.kind == "write"
                and not a.in_init
                and _effectively_guarded(a, always)
            ]
            if not locked_writes:
                continue
            ext_owners.setdefault(attr, []).append(
                (info, locked_writes[0], always)
            )
            unguarded = [
                a for a in accs
                if not a.in_init and not _effectively_guarded(a, always)
            ]
            gw = locked_writes[0]
            for a in unguarded:
                verb = "written" if a.kind == "write" else "read"
                where = (
                    " (inside a nested function — the lock around its "
                    "definition is not held when it runs)"
                    if a.in_nested else ""
                )
                findings.append(Finding(
                    path=a.site.path,
                    line=a.site.line,
                    col=a.site.col,
                    rule=RULE_ID,
                    message=(
                        f"{info.name}.{attr} is written under the class "
                        f"lock at {gw.site.path}:{gw.site.line} "
                        f"[{gw.site.qual}] but {verb} without it "
                        f"here{where}"
                    ),
                    qualname=a.site.qual,
                ))

    for ea in proj.ext_accesses:
        owners = ext_owners.get(ea.attr, [])
        if len(owners) != 1:
            continue
        info, gw, _always = owners[0]
        if ea.attr in info.lock_attrs:
            continue
        if ea.base is None:
            continue  # dynamic base: cannot attribute a guard to it
        if any(
            f"{ea.base}.{lock}" in ea.held for lock in info.lock_attrs
        ):
            continue
        verb = "written" if ea.kind == "write" else "read"
        findings.append(Finding(
            path=ea.site.path,
            line=ea.site.line,
            col=ea.site.col,
            rule=RULE_ID,
            message=(
                f"{info.name}.{ea.attr} ({info.path}) is written under "
                f"the class lock at {gw.site.path}:{gw.site.line} "
                f"[{gw.site.qual}] but {verb} through {ea.base!r} "
                f"without holding {ea.base}.<lock> here"
            ),
            qualname=ea.site.qual,
        ))

    yield from findings
