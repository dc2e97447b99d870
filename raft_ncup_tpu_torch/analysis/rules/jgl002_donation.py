"""JGL002 — a CUDA graph captured without a shared memory pool.

The torch meaning of the JAX rule
(``raft_ncup_tpu/analysis/rules/jgl002_donation.py``). The JAX hazard is
memory that doubles with every compiled step that does not donate its
input buffers. A captured CUDA graph keeps a private memory pool for the
life of the graph: every intermediate the capture allocated stays
reserved, so graphs captured in their own pools add up, one whole
forward's activations per key, until the card runs out. The contract
(``inference/pipeline.py``: ``ShapeCachedForward._pool_for_capture``,
handed to ``_capture``'s ``torch.cuda.graph(graph, pool=pool)``) is that
every graph of a cache shares one pool (``torch.cuda.graph_pool_handle``),
as each donated JAX step reuses its input's memory.

Flagged: a ``torch.cuda.graph(...)``, ``CUDAGraph.capture_begin(...)``
or ``torch.cuda.make_graphed_callables(...)`` with no ``pool`` (keyword,
or ``torch.cuda.graph``'s second positional) in a module that captures
more than one graph. Statically, a module captures one graph only when
it has a single capture site at module level and outside any loop: a
site inside a function or a loop captures once per call or iteration.
"""

from __future__ import annotations

import ast
from typing import Iterator

from raft_ncup_tpu_torch.analysis.astutil import (
    FUNC_NODES,
    Finding,
    ModuleContext,
    dotted_name,
    parent,
    qualname,
)

RULE_ID = "JGL002"
SUMMARY = (
    "CUDA graph captured without a shared pool= in a module that "
    "captures more than one graph"
)

_CAPTURES = frozenset(
    {
        "torch.cuda.graph",
        "torch.cuda.graphs.graph",
        "torch.cuda.make_graphed_callables",
        "torch.cuda.graphs.make_graphed_callables",
    }
)
_LOOPS = (ast.For, ast.AsyncFor, ast.While, ast.ListComp, ast.SetComp,
          ast.DictComp, ast.GeneratorExp)


def _is_capture(node: ast.Call, aliases: dict) -> bool:
    if dotted_name(node.func, aliases) in _CAPTURES:
        return True
    return (
        isinstance(node.func, ast.Attribute)
        and node.func.attr == "capture_begin"
    )


def _has_pool(node: ast.Call, aliases: dict) -> bool:
    if any(kw.arg == "pool" for kw in node.keywords):
        return True
    dn = dotted_name(node.func, aliases) or ""
    # torch.cuda.graph(cuda_graph, pool=None, ...); capture_begin(pool=None)
    if dn.endswith(".graph"):
        return len(node.args) >= 2
    if isinstance(node.func, ast.Attribute) and node.func.attr == "capture_begin":
        return len(node.args) >= 1
    return False


def _repeats(node: ast.AST) -> bool:
    """True when ``node`` may run more than once: it sits in a function or
    a loop."""
    cur = parent(node)
    while cur is not None:
        if isinstance(cur, FUNC_NODES + _LOOPS):
            return True
        cur = parent(cur)
    return False


def check(ctx: ModuleContext) -> Iterator[Finding]:
    sites = [
        n for n in ctx.nodes
        if isinstance(n, ast.Call) and _is_capture(n, ctx.aliases)
    ]
    if len(sites) == 1 and not _repeats(sites[0]):
        return
    for node in sites:
        if _has_pool(node, ctx.aliases):
            continue
        yield Finding(
            ctx.path,
            node.lineno,
            node.col_offset,
            RULE_ID,
            "CUDA graph captured without pool=: each graph keeps its own "
            "pool of every intermediate for its lifetime, so graphs "
            "captured one per key add up — share one "
            "torch.cuda.graph_pool_handle() across the module's captures",
            qualname(node),
        )
