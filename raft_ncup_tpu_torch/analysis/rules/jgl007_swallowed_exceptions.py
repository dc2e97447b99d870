"""JGL007 — swallowed exceptions in the fault-handling layers.

The meaning is the JAX rule's
(``raft_ncup_tpu/analysis/rules/jgl007_swallowed_exceptions.py``): it has
nothing to do with the array library, and the port's ``resilience/``,
``training/``, ``data/`` and ``fleet/`` keep the same contract.

A fault-tolerance stack is only as honest as its error paths: a bare
``except:`` or ``except Exception:`` whose body neither re-raises nor
does anything observable (no call — so no logging, no accounting, no
cleanup) converts a recoverable fault into silent corruption. In this
repo the canonical victims are the resilience protocol itself (a
swallowed save error masks a failed preemption checkpoint), the training
loop plumbing, and the data pipeline (a swallowed decode error becomes a
short epoch). The retry/quarantine layer (resilience/retry.py) exists
precisely so absorbing an error is always *accounted* — this rule keeps
everyone on that path.

Scoped to ``resilience/``, ``training/``, ``data/`` and ``fleet/`` —
the fleet supervisor most of all: a supervisor that silently eats a
child replica's death is the exact failure mode the fleet tier exists
to prevent (an unnoticed dead replica = silent capacity loss + hung
clients; docs/FLEET.md). Narrow handler types (``except queue.Empty:
pass``, ``except ImportError: pass``) are out of scope: catching a
*specific* expected exception and dropping it is a decision, not an
accident. Audited exceptions go through the allowlist with a
justification, like every other rule.
"""

from __future__ import annotations

import ast
from typing import Iterator

from raft_ncup_tpu_torch.analysis.astutil import (
    Finding,
    ModuleContext,
    dotted_name,
    qualname,
)

RULE_ID = "JGL007"
SUMMARY = (
    "swallowed exception (broad except, no re-raise/handling) in "
    "resilience/, training/, data/, fleet/"
)

_BROAD = frozenset({"Exception", "BaseException"})
_SCOPE_DIRS = ("resilience", "training", "data", "fleet")


def _in_scope(path: str) -> bool:
    p = path.replace("\\", "/")
    return any(
        f"/{d}/" in p or p.startswith(f"{d}/") for d in _SCOPE_DIRS
    )


def _is_broad(type_node, aliases) -> bool:
    """Bare ``except:`` or a handler type (or tuple member) named
    Exception/BaseException."""
    if type_node is None:
        return True
    elts = (
        type_node.elts
        if isinstance(type_node, ast.Tuple)
        else [type_node]
    )
    for e in elts:
        dn = dotted_name(e, aliases) or ""
        if dn.split(".")[-1] in _BROAD:
            return True
    return False


def _handles(body) -> bool:
    """A handler 'handles' when it re-raises or does anything observable
    (any call: logging, accounting, cleanup, a recorded fallback)."""
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.Raise, ast.Call)):
                return True
    return False


def check(ctx: ModuleContext) -> Iterator[Finding]:
    if not _in_scope(ctx.path):
        return
    for node in ctx.nodes:
        if not isinstance(node, ast.ExceptHandler):
            continue
        if not _is_broad(node.type, ctx.aliases):
            continue
        if _handles(node.body):
            continue
        label = (
            "bare `except:`" if node.type is None
            else "broad `except " + (ast.unparse(node.type)) + "`"
        )
        yield Finding(
            ctx.path,
            node.lineno,
            node.col_offset,
            RULE_ID,
            f"{label} swallows the error (no re-raise, no logging/"
            "accounting call): in the fault-handling layers every "
            "absorbed exception must be narrow, re-raised, or accounted "
            "(resilience/retry.py)",
            qualname(node),
        )
