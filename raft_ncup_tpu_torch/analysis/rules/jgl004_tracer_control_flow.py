"""JGL004 — Python control flow on a tensor's value in traced code.

The torch meaning of the JAX rule
(``raft_ncup_tpu/analysis/rules/jgl004_tracer_control_flow.py``). An
``if``/``while`` (or a conditional expression) whose test reads a
tensor's value makes the host wait for the card: eagerly a hidden
per-call sync behind an innocent-looking branch, under CUDA-graph
capture an error (and, where it did not fail, a branch frozen at capture
that every replay takes). Data-dependent choices in traced code stay on
the device: ``torch.where``, masks, or a flag that the host reads once
outside the region (``guards.flag_read``).

Precision note: the rule only fires when the test *syntactically
contains* a ``torch`` call that returns a tensor, or a reduction or read
method (``.any()``, ``.all()``, ``.item()``, ``.sum()``, ``.max()``,
``.min()``, ``.mean()``) called with no arguments, so config flags and
shape branches (``if cfg.small:``, ``if H % 8:``) never trigger it.
torch calls that return a Python value (``torch.is_*``, ``torch.*.is_*``,
``torch.get_*``, ``torch.cuda.device_count``, ``torch.finfo``, the
``torch.backends`` switches) are not tensors and are not flagged.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from raft_ncup_tpu_torch.analysis.astutil import (
    Finding,
    ModuleContext,
    dotted_name,
    qualname,
)

RULE_ID = "JGL004"
SUMMARY = "Python if/while on a tensor's value in traced code"

_REDUCTION_METHODS = frozenset(
    {"any", "all", "item", "sum", "max", "min", "mean"}
)
_STATIC_TAILS = frozenset(
    {
        "device_count", "current_device", "finfo", "iinfo", "device",
        "Size", "dtype", "is_available",
    }
)


def _static_torch(dn: str) -> bool:
    """torch calls that return Python values, not tensors."""
    tail = dn.split(".")[-1]
    return (
        tail.startswith(("is_", "get_", "are_"))
        or tail in _STATIC_TAILS
        or dn.startswith("torch.backends.")
    )


def _array_call_in(test: ast.AST, aliases: dict) -> Optional[str]:
    """A tensor-valued subexpression of the branch test, rendered for the
    message; None when the test looks static."""
    for sub in ast.walk(test):
        if not isinstance(sub, ast.Call):
            continue
        dn = dotted_name(sub.func, aliases)
        if dn is not None and dn.split(".")[0] == "torch":
            if _static_torch(dn):
                continue
            return dn
        if (
            isinstance(sub.func, ast.Attribute)
            and sub.func.attr in _REDUCTION_METHODS
            and not sub.args
            and not sub.keywords
        ):
            return f".{sub.func.attr}()"
    return None


def check(ctx: ModuleContext) -> Iterator[Finding]:
    for node in ctx.nodes:
        if not isinstance(node, (ast.If, ast.While, ast.IfExp)):
            continue
        if not ctx.traced.is_traced(node):
            continue
        culprit = _array_call_in(node.test, ctx.aliases)
        if culprit is None:
            continue
        kind = {ast.If: "if", ast.While: "while", ast.IfExp: "conditional"}[
            type(node)
        ]
        yield Finding(
            ctx.path,
            node.lineno,
            node.col_offset,
            RULE_ID,
            f"Python `{kind}` on a tensor's value (`{culprit}`) in traced "
            "code waits for the card (an error under CUDA-graph capture) — "
            "use torch.where/masks, or read one flag outside the region",
            qualname(node),
        )
