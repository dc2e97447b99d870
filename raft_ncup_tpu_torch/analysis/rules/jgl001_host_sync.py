"""JGL001 — host synchronization inside traced code.

The torch meaning of the JAX rule
(``raft_ncup_tpu/analysis/rules/jgl001_host_sync.py``). In traced code
(a CUDA-graph capture, an autograd function, a module's forward: see
``astutil``) a read of a tensor's value on the host either fails (under
capture a sync is an error: ``cudaErrorStreamCaptureUnsupported``) or,
eagerly, silently stalls the host until the card drains its queue, every
call: the one stray pull in a refinement step that erases the overlap of
the dispatch pipeline. Flagged:

- ``.item()``, ``.tolist()``, ``.numpy()``;
- ``.cpu()`` and ``.to("cpu")`` (also ``device="cpu"``);
- ``float()``, ``int()``, ``bool()`` or ``complex()`` of anything but a
  literal or a shape (``len()``, ``.shape``, ``.size()``, ``.dim()``,
  ``.ndim``, ``.numel()``, and arithmetic over them: host integers, no
  sync);
- ``numpy.asarray``/``array``/``copy``/``save``/``savez``;
- ``torch.cuda.synchronize()`` and any ``.synchronize()`` (a stream's or
  an event's).

The sanctioned reads are ``analysis.guards``'s ``host_read``,
``flag_read`` and ``collective_read``: explicit, counted, and outside
the traced region. They are not flagged.
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

RULE_ID = "JGL001"
SUMMARY = (
    "host sync (.item()/.cpu()/float()/np.asarray/synchronize) inside "
    "traced code"
)

_HOST_PULL_CALLS = frozenset(
    {
        "torch.cuda.synchronize",
        "numpy.asarray",
        "numpy.array",
        "numpy.copy",
        "numpy.save",
        "numpy.savez",
    }
)
_BUILTIN_CASTS = frozenset({"float", "int", "bool", "complex"})
_METHOD_PULLS = frozenset({"item", "tolist", "numpy", "cpu", "synchronize"})
_SHAPE_ATTRS = frozenset({"shape", "ndim"})
_SHAPE_METHODS = frozenset({"size", "dim", "numel", "element_size"})


def _is_static_arg(node: ast.AST) -> bool:
    """Literals, shapes and arithmetic over them are host integers: a cast
    of one is Python, not a sync."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Attribute):
        return node.attr in _SHAPE_ATTRS
    if isinstance(node, ast.Subscript):
        return _is_static_arg(node.value)
    if isinstance(node, ast.BinOp):
        return _is_static_arg(node.left) and _is_static_arg(node.right)
    if isinstance(node, ast.UnaryOp):
        return _is_static_arg(node.operand)
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name):
            return node.func.id == "len"
        return (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _SHAPE_METHODS
        )
    return False


def _is_cpu(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cpu"


def _to_cpu(node: ast.Call) -> bool:
    """``t.to("cpu")`` or ``t.to(device="cpu")``."""
    return (
        isinstance(node.func, ast.Attribute)
        and node.func.attr == "to"
        and (
            (node.args and _is_cpu(node.args[0]))
            or any(kw.arg == "device" and _is_cpu(kw.value) for kw in node.keywords)
        )
    )


def check(ctx: ModuleContext) -> Iterator[Finding]:
    for node in ctx.nodes:
        if not isinstance(node, ast.Call) or not ctx.traced.is_traced(node):
            continue
        dn = dotted_name(node.func, ctx.aliases)
        if dn in _HOST_PULL_CALLS:
            yield Finding(
                ctx.path,
                node.lineno,
                node.col_offset,
                RULE_ID,
                f"`{dn}` inside traced code forces a host transfer/sync "
                "(an error under CUDA-graph capture); move it outside the "
                "traced region (guards.host_read at a window boundary)",
                qualname(node),
            )
        elif (
            isinstance(node.func, ast.Name)
            and node.func.id in _BUILTIN_CASTS
            and node.func.id not in ctx.aliases  # not shadowed by an import
            and node.args
            and not _is_static_arg(node.args[0])
        ):
            yield Finding(
                ctx.path,
                node.lineno,
                node.col_offset,
                RULE_ID,
                f"`{node.func.id}(...)` on a tensor is a per-call "
                "device→host sync (an error under CUDA-graph capture); "
                "keep the value on the device",
                qualname(node),
            )
        elif _to_cpu(node) or (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _METHOD_PULLS
            and not node.args
        ):
            what = ".to(\"cpu\")" if _to_cpu(node) else f".{node.func.attr}()"
            yield Finding(
                ctx.path,
                node.lineno,
                node.col_offset,
                RULE_ID,
                f"`{what}` inside traced code pulls the value to the host "
                "(or waits for the card); keep it on the device",
                qualname(node),
            )
