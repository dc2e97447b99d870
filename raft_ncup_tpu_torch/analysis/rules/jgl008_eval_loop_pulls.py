"""JGL008 — per-iteration host pull in the eval/serving/streaming loops.

The torch meaning of the JAX rule
(``raft_ncup_tpu/analysis/rules/jgl008_eval_loop_pulls.py``). The eval
pipeline's contract (``inference/pipeline.py``) is that metrics
accumulate on the card inside the forward and the host pulls a handful of
scalars once per dataset window, never per batch; the serving and stream
dispatchers hand each batch's results to the ``AsyncDrain`` worker, never
pulling on the dispatch thread. A pull inside such a loop re-serializes
dispatch with a device→host transfer every iteration.

Flagged, when it runs once per iteration of an enclosing loop (``for``/
``while`` bodies and comprehensions; a function merely *defined* in a
loop is not flagged at its definition):

- ``host_read`` (``analysis.guards``): ``jax.device_get``'s counterpart,
  which the JAX rule flags per iteration;
- the implicit pulls ``.item()``, ``.tolist()``, ``.numpy()``, ``.cpu()``.

Not flagged: ``torch.cuda.synchronize`` and ``Event.synchronize``/
``Stream.synchronize`` (a wait without a transfer, ``block_until_ready``'s
counterpart: the dispatch throttle's bounded in-flight wait is part of
the sanctioned steady state), and ``guards.flag_read`` (the early-exit
segment loop's one-byte read of its stop flag, which is the loop's
design). Scoped to ``inference/``, ``serving/``, ``streaming/`` and
``evaluation.py``. The one audited exception is the ``AsyncDrain``
worker, which IS the sanctioned off-dispatch pull.
"""

from __future__ import annotations

import ast
from typing import Iterator

from raft_ncup_tpu_torch.analysis.astutil import (
    FUNC_NODES,
    Finding,
    ModuleContext,
    dotted_name,
    in_dirs,
    parent,
    qualname,
)

RULE_ID = "JGL008"
SUMMARY = (
    "per-iteration host pull (host_read/.item()/.tolist()/.numpy()/.cpu()) "
    "in the eval/serving/streaming loops"
)

_PULL_TAILS = frozenset({"host_read"})
_PULL_METHODS = frozenset({"item", "tolist", "numpy", "cpu"})
_LOOP_NODES = (
    ast.For,
    ast.AsyncFor,
    ast.While,
    ast.ListComp,
    ast.SetComp,
    ast.DictComp,
    ast.GeneratorExp,
)


def _in_scope(path: str) -> bool:
    p = path.replace("\\", "/")
    return (
        in_dirs(p, ("inference", "serving", "streaming"))
        or p.endswith("/evaluation.py")
        or p == "evaluation.py"
    )


def _executes_per_iteration(node: ast.AST) -> bool:
    """True when ``node`` runs once per iteration of an enclosing loop:
    the nearest loop ancestor is reached before any function-definition
    boundary (a nested def's body runs when called, not when defined)."""
    cur = parent(node)
    while cur is not None:
        if isinstance(cur, _LOOP_NODES):
            return True
        if isinstance(cur, FUNC_NODES):
            return False
        cur = parent(cur)
    return False


def check(ctx: ModuleContext) -> Iterator[Finding]:
    if not _in_scope(ctx.path):
        return
    for node in ctx.nodes:
        if not isinstance(node, ast.Call):
            continue
        if not _executes_per_iteration(node):
            continue
        dn = dotted_name(node.func, ctx.aliases)
        if dn is not None and dn.split(".")[-1] in _PULL_TAILS:
            yield Finding(
                ctx.path,
                node.lineno,
                node.col_offset,
                RULE_ID,
                f"`{dn}` inside the loop pulls to the host every "
                "iteration; keep the accumulator on the card and pull once "
                "per window, or route full-field pulls through AsyncDrain",
                qualname(node),
            )
        elif (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _PULL_METHODS
            and not node.args
        ):
            yield Finding(
                ctx.path,
                node.lineno,
                node.col_offset,
                RULE_ID,
                f"`.{node.func.attr}()` inside the loop is a per-iteration "
                "device→host sync; accumulate on the card and pull once "
                "per window",
                qualname(node),
            )
