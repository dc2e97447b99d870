"""JGL012 — wire-protocol contract between frame producers and
consumers.

The meaning is the JAX rule's
(``raft_ncup_tpu/analysis/rules/jgl012_wire_contract.py``), over the
port's ``fleet/`` and ``raft_ncup_tpu_torch/serve.py``. The lockstep
headers of a mesh of processes (``parallel/lockstep.py``) are another
protocol, out of this rule's scope: every rank runs one commit, so their
fields are mandatory, and their keys are written by the dispatching tier
(``serving/server.py``, ``streaming/engine.py``) and read by its own
handlers and by ``Lockstep`` itself, none of which speaks the fleet's
wire.

The fleet wire protocol (fleet/wire.py) is length-prefixed JSON whose
producers and consumers live in different modules and different
PROCESSES: the router writes a request header in ``fleet/router.py``,
the replica loop reads it in ``serve.py``, and nothing but convention
keeps the two ends naming the same keys. This rule collects every
header-key write (constant keys of any dict literal carrying a
``"kind"`` key — every frame has one — plus ``header["k"] = ...``
store subscripts) and every read (``header.get("k")`` and bare
subscripts) across ``fleet/*.py`` and ``serve.py``, then flags:

- **drift**: a key read but never written by any in-scope producer, or
  written but never read by any in-scope consumer — a renamed or dead
  protocol field that will otherwise surface as an unexplainable
  behavior gap between router and replica versions;
- **bare-subscript reads**: every field beyond ``kind`` is OPTIONAL
  (the schema-evolution contract in fleet/wire.py's docstring), so a
  consumer must read with ``.get``, never ``header["k"]`` — the
  generalization of JGL010's one-off trace-key check, which keeps
  ownership of the ``"trace"`` key in ``fleet/`` (carved out here to
  avoid double findings).

``fleet/wire.py`` itself is the codec, not a producer or consumer of
protocol fields (its ``header.pop("arrays")`` handles the reserved
descriptor key) — it is excluded from collection, as is the reserved
``"arrays"`` key. The two drift halves only run when the linted set
contains BOTH ends (``serve.py`` and ``fleet/`` modules); a standalone
lint of one directory cannot distinguish drift from out-of-scope use.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

from raft_ncup_tpu_torch.analysis.astutil import Finding
from raft_ncup_tpu_torch.analysis.project import (
    WIRE_RESERVED_KEYS,
    ProjectIndex,
)

RULE_ID = "JGL012"
SUMMARY = (
    "wire header key drift or bare-subscript read across fleet/*.py "
    "and serve.py (whole-program)"
)


def _norm(path: str) -> str:
    return path.replace("\\", "/")


def _basename(path: str) -> str:
    return _norm(path).rsplit("/", 1)[-1]


def _in_fleet(path: str) -> bool:
    p = _norm(path)
    return "/fleet/" in p or p.startswith("fleet/")


def _in_scope(path: str) -> bool:
    if _basename(path) == "serve.py":
        return True
    return _in_fleet(path) and _basename(path) != "wire.py"


def check_project(proj: ProjectIndex) -> Iterator[Finding]:
    writes: Dict[str, List] = {}
    reads: Dict[str, List] = {}
    bare_reads: List = []
    for wk in proj.wire_keys:
        if not _in_scope(wk.site.path) or wk.key in WIRE_RESERVED_KEYS:
            continue
        if wk.kind == "write":
            writes.setdefault(wk.key, []).append(wk)
        else:
            reads.setdefault(wk.key, []).append(wk)
            if wk.kind == "read_subscript":
                bare_reads.append(wk)

    findings: List[Finding] = []

    # Bare-subscript reads: per-site, regardless of scope completeness.
    for wk in bare_reads:
        if wk.key == "kind":
            continue  # the one REQUIRED field — a subscript is honest
        if wk.key == "trace" and _in_fleet(wk.site.path):
            continue  # JGL010's trace-key check owns this site
        findings.append(Finding(
            path=wk.site.path,
            line=wk.site.line,
            col=wk.site.col,
            rule=RULE_ID,
            message=(
                f"wire header key {wk.key!r} read with a bare "
                "subscript — every field beyond 'kind' is OPTIONAL "
                "(schema-evolution contract, fleet/wire.py); read it "
                "with .get() and handle None"
            ),
            qualname=wk.site.qual,
        ))

    # Drift needs both ends of the protocol in the linted set.
    has_serve = any(_basename(p) == "serve.py" for p in proj.paths)
    has_fleet = any(_in_scope(p) and _in_fleet(p) for p in proj.paths)
    if has_serve and has_fleet:
        for key in sorted(set(reads) - set(writes)):
            wk = min(reads[key], key=lambda w: (w.site.path, w.site.line))
            findings.append(Finding(
                path=wk.site.path,
                line=wk.site.line,
                col=wk.site.col,
                rule=RULE_ID,
                message=(
                    f"wire header key {key!r} is read here but never "
                    "written by any producer in fleet/ or serve.py — "
                    "renamed or dead protocol field (drift)"
                ),
                qualname=wk.site.qual,
            ))
        for key in sorted(set(writes) - set(reads)):
            wk = min(writes[key], key=lambda w: (w.site.path, w.site.line))
            findings.append(Finding(
                path=wk.site.path,
                line=wk.site.line,
                col=wk.site.col,
                rule=RULE_ID,
                message=(
                    f"wire header key {key!r} is written here but never "
                    "read by any consumer in fleet/ or serve.py — "
                    "renamed or dead protocol field (drift)"
                ),
                qualname=wk.site.qual,
            ))

    yield from findings
