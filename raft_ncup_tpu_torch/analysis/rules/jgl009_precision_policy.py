"""JGL009 — raw dtype literals and casts bypassing the precision policy.

The torch meaning of the JAX rule
(``raft_ncup_tpu/analysis/rules/jgl009_precision_policy.py``). The
port's precision policy (``raft_ncup_tpu_torch/precision/``: presets
``f32``, ``bf16_infer``, ``bf16_train``) is the single authority for
every dtype on the hot path: module compute, the correlation features,
the coordinate carry, the outputs. A raw ``torch.float32`` /
``torch.float`` / ``torch.bfloat16`` / ``torch.float16`` / ``torch.half``
in a hot-path function body, or a ``.float()`` / ``.half()`` /
``.bfloat16()`` cast, is a dtype decision the policy cannot see: it
either pins a tensor wide where a bf16 preset should narrow it, or
narrows something the policy pins to float32 (coordinates,
accumulators).

Scope: the function bodies of ``models/``, ``nn/`` and ``inference/``.

Sanctioned routings (not flagged), as in the JAX rule:

- reading a policy: ``self.policy.compute``, ``policy.coord`` — no
  literal appears;
- a class-body attribute default (``dtype = torch.float32``: the
  attribute is the policy-settable knob);
- a module-level named constant (``PARAM_DTYPE = torch.float32``, with a
  comment saying which pinned policy dtype it mirrors).

Everything else is a finding; deliberate exceptions (the float32 metric
accumulators of ``inference/metrics.py``) carry justified allowlist
entries.
"""

from __future__ import annotations

import ast
from typing import Iterator

from raft_ncup_tpu_torch.analysis.astutil import (
    Finding,
    ModuleContext,
    dotted_name,
    in_dirs,
    parent,
    qualname,
)

RULE_ID = "JGL009"
SUMMARY = (
    "raw torch.float32/bfloat16/float16 literal or .float()/.half()/"
    ".bfloat16() cast bypassing the precision policy in models/, nn/, "
    "inference/"
)

_DTYPE_NAMES = frozenset(
    {
        "torch.float32",
        "torch.float",
        "torch.bfloat16",
        "torch.float16",
        "torch.half",
    }
)
_CASTS = frozenset({"float", "half", "bfloat16"})


def _exempt_nodes(tree: ast.AST) -> set:
    """ids of nodes inside sanctioned literal positions: the VALUE of an
    assignment sitting directly in a module or class body (named
    constants and class attribute defaults)."""
    exempt: set = set()
    scopes = [tree] + [
        n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)
    ]
    for scope in scopes:
        for stmt in scope.body:
            value = None
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                value = stmt.value
            if value is None:
                continue
            for sub in ast.walk(value):
                exempt.add(id(sub))
    return exempt


def check(ctx: ModuleContext) -> Iterator[Finding]:
    if not in_dirs(ctx.path, ("models", "nn", "inference")):
        return
    exempt = _exempt_nodes(ctx.tree)
    for node in ctx.nodes:
        if id(node) in exempt:
            continue
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _CASTS
            and not node.args
            and not node.keywords
        ):
            yield Finding(
                ctx.path,
                node.lineno,
                node.col_offset,
                RULE_ID,
                f"raw `.{node.func.attr}()` cast on the hot path: dtype "
                "decisions route through the PrecisionPolicy "
                "(raft_ncup_tpu_torch/precision/) — cast to policy.compute/"
                "coord/..., or to a named module-level constant documenting "
                "which pinned policy dtype it mirrors",
                qualname(node),
            )
            continue
        if not isinstance(node, (ast.Name, ast.Attribute)):
            continue
        dn = dotted_name(node, ctx.aliases)
        if dn not in _DTYPE_NAMES:
            continue
        p = parent(node)
        if isinstance(p, ast.Attribute) and dotted_name(
            p, ctx.aliases
        ) in _DTYPE_NAMES:
            continue  # inner link of the same dotted chain
        yield Finding(
            ctx.path,
            node.lineno,
            node.col_offset,
            RULE_ID,
            f"raw `torch.{dn.split('.')[-1]}` literal on the hot path: dtype "
            "decisions route through the PrecisionPolicy "
            "(raft_ncup_tpu_torch/precision/) — use policy.compute/"
            "coord/..., a policy-settable class attribute, or a named "
            "module-level constant documenting which pinned policy dtype "
            "it mirrors",
            qualname(node),
        )
