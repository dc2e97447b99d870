"""JGL006 — mesh axis names the mesh does not declare.

The torch meaning of the JAX rule
(``raft_ncup_tpu/analysis/rules/jgl006_partition_axes.py``). The JAX
hazard is a ``PartitionSpec`` naming an axis the mesh lacks: GSPMD
silently replicates. The port's mesh (``parallel/mesh.py``) is a
``Mesh`` whose ``shape`` property names its axes (``data``, ``spatial``,
and ``pipe`` above 1), and its API takes axis names as strings:

- ``_groups(mesh, "axis")`` (the process groups along one axis);
- ``mesh.shape.get("axis", default)`` and ``mesh.shape["axis"]`` (any
  ``.shape`` subscripted or ``.get`` with a string: a tensor's shape is
  indexed by integers).

A misspelled name fails just as quietly: ``mesh.shape.get("spatail", 1)``
gives 1, and the forward runs unsplit on every rank. Declared axes are
discovered from the lint run itself (the keys of a ``Mesh.shape`` dict in
any linted module: ``lint.discover_declared_axes``). When the linted set
declares nothing, the engine falls back to the production declarer
``parallel/mesh.py`` (``lint.production_declared_axes``); only when no
declaration exists anywhere does the rule stay silent rather than guess.
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

RULE_ID = "JGL006"
SUMMARY = (
    "mesh axis name (_groups/mesh.shape) not declared by parallel/mesh.py"
)


def _string(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _is_shape(node: ast.AST) -> bool:
    return isinstance(node, ast.Attribute) and node.attr == "shape"


def _axis_of(node: ast.AST, aliases: dict) -> Optional[str]:
    """The literal axis name ``node`` hands to the mesh API, or None."""
    if isinstance(node, ast.Call):
        dn = dotted_name(node.func, aliases) or ""
        if dn.split(".")[-1] == "_groups":
            arg = node.args[1] if len(node.args) >= 2 else next(
                (kw.value for kw in node.keywords if kw.arg == "axis"), None
            )
            return _string(arg)
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "get"
            and _is_shape(node.func.value)
            and node.args
        ):
            return _string(node.args[0])
    elif isinstance(node, ast.Subscript) and _is_shape(node.value):
        return _string(node.slice)
    return None


def check(ctx: ModuleContext) -> Iterator[Finding]:
    if not ctx.declared_axes:
        return  # no mesh declaration in scope — cannot judge names
    for node in ctx.nodes:
        axis = _axis_of(node, ctx.aliases)
        if axis is None or axis in ctx.declared_axes:
            continue
        yield Finding(
            ctx.path,
            node.lineno,
            node.col_offset,
            RULE_ID,
            f"mesh axis {axis!r} is not a declared mesh axis "
            f"({sorted(ctx.declared_axes)}); the mesh API answers an "
            "unknown axis silently (shape.get gives the default, and the "
            "work runs unsplit)",
            qualname(node),
        )
