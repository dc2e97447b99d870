"""JGL005 — dtype hygiene in the numeric core (``ops/``, ``nn/``).

The torch meaning of the JAX rule
(``raft_ncup_tpu/analysis/rules/jgl005_dtype_hygiene.py``). Two hazards,
both of which change a kernel's inputs or a module's numerics silently:

- ``torch.tensor(...)``/``torch.as_tensor(...)`` without a dtype: the
  result follows the input (a Python float list becomes the default
  dtype, a numpy float64 array stays float64), so a float64 slips into a
  dataflow chain, promotes everything it touches, and reaches a kernel
  wrapper that refuses it (or a CUDA graph keyed on another dtype). In
  the numeric core every conversion states its dtype.
- explicit float64 (``torch.float64``, ``torch.double``,
  ``numpy.float64``, a ``"float64"``/``"double"`` dtype string,
  ``.double()``): the H100's float64 rate is a fraction of its float32
  tensor-core rate, and no kernel of the port takes it. float64 in the
  core is either a bug or a plain reference that computes in float64 on
  purpose, which then carries an allowlist entry saying so.

Scoped to ``ops/`` and ``nn/`` paths: drivers and tests convert freely.
"""

from __future__ import annotations

import ast
from typing import Iterator

from raft_ncup_tpu_torch.analysis.astutil import (
    Finding,
    ModuleContext,
    dotted_name,
    in_dirs,
    qualname,
)

RULE_ID = "JGL005"
SUMMARY = "dtype-less torch.tensor/as_tensor or float64 in ops/ and nn/"

_CONVERTERS = frozenset({"torch.tensor", "torch.as_tensor"})
_F64_NAMES = frozenset({"torch.float64", "torch.double", "numpy.float64"})
_F64_STRINGS = frozenset({"float64", "f8", "double"})


def _is_f64_string(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Constant)
        and isinstance(node.value, str)
        and node.value in _F64_STRINGS
    )


def _has_dtype(node: ast.Call, dn: str) -> bool:
    # torch.as_tensor(data, dtype=None, device=None) takes the dtype as
    # its second positional; torch.tensor takes it by keyword only.
    if dn == "torch.as_tensor" and len(node.args) >= 2:
        return True
    return any(kw.arg == "dtype" for kw in node.keywords)


def _f64_string_in_call(node: ast.Call) -> bool:
    """String-spelled float64 in dtype position: ``dtype="float64"`` on
    any call, or ``.astype("float64")``."""
    if any(kw.arg == "dtype" and _is_f64_string(kw.value) for kw in node.keywords):
        return True
    return (
        isinstance(node.func, ast.Attribute)
        and node.func.attr == "astype"
        and bool(node.args)
        and _is_f64_string(node.args[0])
    )


def check(ctx: ModuleContext) -> Iterator[Finding]:
    if not in_dirs(ctx.path, ("ops", "nn")):
        return
    for node in ctx.nodes:
        if isinstance(node, ast.Call):
            dn = dotted_name(node.func, ctx.aliases)
            if dn in _CONVERTERS and not _has_dtype(node, dn):
                yield Finding(
                    ctx.path,
                    node.lineno,
                    node.col_offset,
                    RULE_ID,
                    f"`{dn}` without an explicit dtype: the result follows "
                    "the input (a numpy float64 stays float64) — state it "
                    "(e.g. dtype=torch.float32)",
                    qualname(node),
                )
            if _f64_string_in_call(node) or (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "double"
                and not node.args
            ):
                yield Finding(
                    ctx.path,
                    node.lineno,
                    node.col_offset,
                    RULE_ID,
                    "float64 in the numeric core: no kernel of the port "
                    "takes it and the card runs it at a fraction of float32's "
                    "rate — use float32/bfloat16 (allowlist a plain "
                    "reference that computes in float64 on purpose)",
                    qualname(node),
                )
        dn = (
            dotted_name(node, ctx.aliases)
            if isinstance(node, (ast.Name, ast.Attribute))
            else None
        )
        if dn in _F64_NAMES:
            yield Finding(
                ctx.path,
                node.lineno,
                node.col_offset,
                RULE_ID,
                f"`{dn}` in the numeric core: no kernel of the port takes "
                "float64 and the card runs it at a fraction of float32's "
                "rate — use float32/bfloat16 (allowlist a plain reference "
                "that computes in float64 on purpose)",
                qualname(node),
            )
