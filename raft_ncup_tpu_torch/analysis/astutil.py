"""Shared AST plumbing for the port's static lint (pure stdlib: it
imports no torch).

The analyses are *syntactic*: the lint runs before anything is built or
launched, on any host, and everything a rule needs (import aliases,
dotted-name resolution and the traced-region index) comes from the AST
alone. ``raft_ncup_tpu/analysis/astutil.py`` is the JAX package's
counterpart; this module keeps its own copy of the plumbing and changes
only what "traced" means.

Traced-region detection is the load-bearing piece. Code is *traced*
when it runs where a host sync, a Python-side clock or random read, or a
Python branch on a tensor's value is a bug: under a CUDA-graph capture
(the graph replays what was recorded, with no Python), inside autograd's
own functions, or on the model's forward hot path. A function is traced
when:

1. its body runs under a CUDA-graph capture:

   - code inside a ``with torch.cuda.graph(...)`` block;
   - a function passed to ``torch.cuda.make_graphed_callables``;
   - a function passed to a *capture wrapper*: a function of the module
     that calls one of its parameters inside such a block
     (``inference/pipeline.py``'s ``_capture(key, fn, ...)``), or that
     hands a parameter on to another capture wrapper
     (``_GraphEntry.__init__``, ``_graph_or_eager``, ``_run``). Calls to
     a wrapper resolve by name, as ``self.<method>(...)`` within its
     class, and as ``Class(...)`` for ``Class.__init__``;

2. it is ``forward``, ``backward`` or ``setup_context`` of a
   ``torch.autograd.Function`` subclass;
3. it is passed to ``torch.utils.checkpoint.checkpoint``;
4. it is the ``forward`` of a class in a file under ``models/``,
   ``nn/`` or ``ops/`` (every such class there is an ``nn.Module``; the
   test does not chase base classes across modules);
5. it is defined inside a traced function; or
6. it is called by name from traced code in the same module
   (transitive closure).

A function argument resolves through names, lambdas, simple assignment
chains, the positional arguments of a call (``banded(encode)``,
``functools.partial(f, ...)``) and ``for`` targets unpacked from a
literal tuple of tuples (``for name, fn, args in stages``). Like the JAX
index this is a per-module approximation: calls that cross module
boundaries through attributes (``model(...)``, ``self.update(...)``) are
not followed. The rules stay high-precision inside that boundary and the
allowlist absorbs the rest.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Iterator, Optional

_PARENT = "_graftlint_parent"

FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
_DEF_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)

# Callables whose function-valued positional arguments are traced.
CHECKPOINT_CALLS = frozenset(
    {
        "torch.utils.checkpoint.checkpoint",
        "torch.cuda.make_graphed_callables",
        "torch.cuda.graphs.make_graphed_callables",
    }
)
# Context managers whose block runs under a CUDA-graph capture.
GRAPH_CAPTURES = frozenset({"torch.cuda.graph", "torch.cuda.graphs.graph"})
# The methods of a torch.autograd.Function that autograd runs.
AUTOGRAD_METHODS = frozenset({"forward", "backward", "setup_context"})
MODULE_DIRS = ("models", "nn", "ops")


@dataclass(frozen=True)
class Finding:
    """One lint finding, addressable by the allowlist as
    ``path::rule::qualname``."""

    path: str
    line: int
    col: int
    rule: str
    message: str
    qualname: str = "<module>"

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: {self.rule} "
            f"[{self.qualname}] {self.message}"
        )


def attach_parents(tree: ast.AST) -> None:
    for parent_node in ast.walk(tree):
        for child in ast.iter_child_nodes(parent_node):
            setattr(child, _PARENT, parent_node)


def parent(node: ast.AST) -> Optional[ast.AST]:
    return getattr(node, _PARENT, None)


def enclosing_functions(node: ast.AST) -> Iterator[ast.AST]:
    """All function nodes containing ``node``, innermost first."""
    cur = parent(node)
    while cur is not None:
        if isinstance(cur, FUNC_NODES):
            yield cur
        cur = parent(cur)


def qualname(node: ast.AST) -> str:
    """Dotted enclosing-function path, e.g. ``_capture`` or
    ``forward.fn``; ``<module>`` at top level."""
    names = []
    cur = node if isinstance(node, FUNC_NODES) else None
    if cur is None:
        for fn in enclosing_functions(node):
            cur = fn
            break
    while cur is not None:
        names.append(getattr(cur, "name", "<lambda>"))
        cur = next(enclosing_functions(cur), None)
    return ".".join(reversed(names)) if names else "<module>"


def collect_aliases(tree: ast.AST) -> dict:
    """Map local names to fully-qualified import paths.

    ``import torch.nn.functional as F`` -> ``{'F': 'torch.nn.functional'}``;
    ``from torch import nn`` -> ``{'nn': 'torch.nn'}``; plain
    ``import numpy`` binds the top-level name to itself.
    """
    aliases: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    aliases[a.asname] = a.name
                else:
                    top = a.name.split(".")[0]
                    aliases[top] = top
        elif isinstance(node, ast.ImportFrom):
            if node.module and node.level == 0:
                for a in node.names:
                    aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def dotted_name(node: ast.AST, aliases: dict) -> Optional[str]:
    """Resolve ``Name``/``Attribute`` chains to a dotted string with the
    leading segment expanded through import aliases; None for anything
    dynamic (subscripts, calls)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(aliases.get(node.id, node.id))
    return ".".join(reversed(parts))


def in_dirs(path: str, dirs) -> bool:
    """True when ``path`` lies under a directory named one of ``dirs``."""
    p = path.replace("\\", "/")
    return any(f"/{d}/" in p or p.startswith(f"{d}/") for d in dirs)


def is_graph_capture(node: ast.AST, aliases: dict) -> bool:
    """``node`` is a ``torch.cuda.graph(...)`` call (a capture block's
    context expression)."""
    return isinstance(node, ast.Call) and dotted_name(
        node.func, aliases
    ) in GRAPH_CAPTURES


def _params(fn: ast.AST) -> list:
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args]


@dataclass
class TracedIndex:
    """Per-module index of the functions (and capture blocks) whose code
    is traced (see the module docstring for the marking rules)."""

    tree: ast.AST
    aliases: dict
    path: str = ""
    traced: set = field(default_factory=set)
    blocks: set = field(default_factory=set)  # `with torch.cuda.graph` nodes
    # def node -> names of the parameters it captures (capture wrappers)
    wrappers: dict = field(default_factory=dict)
    nodes: list = field(default_factory=list)  # every node, in walk order
    _defs_by_name: dict = field(default_factory=dict)
    _classes: dict = field(default_factory=dict)
    _assigns: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.nodes = list(ast.walk(self.tree))
        for node in self.nodes:
            if isinstance(node, _DEF_NODES):
                self._defs_by_name.setdefault(node.name, []).append(node)
            elif isinstance(node, ast.ClassDef):
                self._classes.setdefault(node.name, []).append(node)
            elif isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        self._assigns.setdefault(tgt.id, []).append(node.value)
        for node in self.nodes:
            if isinstance(node, (ast.For, ast.AsyncFor)):
                self._bind_for(node)
        self._seed()
        self._propagate()

    def _bind_for(self, node) -> None:
        """``for a, b in rows`` over a literal tuple of tuples (directly or
        through a name bound to one): ``b`` takes each row's element."""
        rows = []
        it = node.iter
        values = (
            list(self._assigns.get(it.id, ())) if isinstance(it, ast.Name)
            else [it]
        )
        for v in values:
            if isinstance(v, (ast.Tuple, ast.List)):
                rows.extend(v.elts)
        targets = (
            [(node.target, None)] if isinstance(node.target, ast.Name)
            else [(t, i) for i, t in enumerate(getattr(node.target, "elts", ()))]
        )
        for tgt, i in targets:
            if not isinstance(tgt, ast.Name):
                continue
            for row in rows:
                if i is None:
                    self._assigns.setdefault(tgt.id, []).append(row)
                elif isinstance(row, (ast.Tuple, ast.List)) and i < len(row.elts):
                    self._assigns.setdefault(tgt.id, []).append(row.elts[i])

    # ------------------------------------------------------------- marking

    def _visible_from(self, def_node: ast.AST, at: Optional[ast.AST]) -> bool:
        """Scope filter for by-name resolution: a def is visible from
        ``at`` when it lives at module level (or in a class body) or inside
        one of ``at``'s enclosing functions. Without this, same-named inner
        functions in sibling methods (``forward.fn`` and
        ``_graph_or_eager.fn``) cross-contaminate."""
        owner = next(enclosing_functions(def_node), None)
        if owner is None:
            return True
        if at is None:
            return False
        return owner is at or owner in set(enclosing_functions(at))

    def _resolve_funcarg(self, node, at=None, seen=None):
        """Function nodes a call argument may refer to (by-name defs,
        lambdas, assignment chains, ``for`` targets over literal rows, and
        the positional arguments of a call), restricted to defs visible
        from the reference node ``at``."""
        seen = seen if seen is not None else set()
        if isinstance(node, ast.Lambda):
            yield node
            return
        if isinstance(node, ast.Call):
            for arg in node.args:
                yield from self._resolve_funcarg(arg, at, seen)
            return
        if isinstance(node, (ast.Tuple, ast.List)):
            for e in node.elts:
                yield from self._resolve_funcarg(e, at, seen)
            return
        if not isinstance(node, ast.Name) or node.id in seen:
            return
        seen.add(node.id)
        for d in self._defs_by_name.get(node.id, []):
            if self._visible_from(d, at):
                yield d
        for value in self._assigns.get(node.id, []):
            yield from self._resolve_funcarg(value, at, seen)

    def _callees(self, call: ast.Call, at):
        """``(def, offset)`` for each def a call may enter: by name, as
        ``self.<method>`` of the enclosing class, or ``Class(...)`` for its
        ``__init__``. ``offset`` is 1 where the call does not pass ``self``."""
        f = call.func
        if isinstance(f, ast.Name):
            for d in self._defs_by_name.get(f.id, []):
                if self._visible_from(d, at):
                    yield d, 0
            for cls in self._classes.get(f.id, []):
                for s in cls.body:
                    if isinstance(s, _DEF_NODES) and s.name == "__init__":
                        yield s, 1
        elif (
            isinstance(f, ast.Attribute)
            and isinstance(f.value, ast.Name)
            and f.value.id == "self"
            and at is not None
        ):
            cls = _enclosing_class(at)
            if cls is not None:
                for s in cls.body:
                    if isinstance(s, _DEF_NODES) and s.name == f.attr:
                        yield s, 1

    @staticmethod
    def _arg_for(call: ast.Call, fn, name: str, offset: int):
        for kw in call.keywords:
            if kw.arg == name:
                return kw.value
        params = _params(fn)
        i = params.index(name) - offset if name in params else -1
        if 0 <= i < len(call.args) and not any(
            isinstance(a, ast.Starred) for a in call.args[: i + 1]
        ):
            return call.args[i]
        return None

    def _find_wrappers(self, calls: list) -> None:
        # Base: a function that calls one of its parameters inside a
        # capture block.
        for block in self.blocks:
            fn = next(enclosing_functions(block), None)
            if fn is None or isinstance(fn, ast.Lambda):
                continue
            params = set(_params(fn))
            for stmt in block.body:
                for sub in _walk_same_scope(stmt):
                    if (
                        isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Name)
                        and sub.func.id in params
                    ):
                        self.wrappers.setdefault(fn, set()).add(sub.func.id)
        # Forwarding: a function that hands a parameter on to a wrapper.
        changed = True
        while changed:
            changed = False
            for call, at in calls:
                # A call in a lambda forwards the parameters of the def
                # the lambda closes over (``lambda: self._wrap(key, fn)``).
                owner = next(
                    (f for f in ([at] if at else []) + list(
                        enclosing_functions(at) if at else []
                    ) if isinstance(f, _DEF_NODES)),
                    None,
                )
                if owner is None:
                    continue
                mine = set(_params(owner))
                for callee, offset in self._callees(call, at):
                    for name in self.wrappers.get(callee, ()):
                        arg = self._arg_for(call, callee, name, offset)
                        if (
                            isinstance(arg, ast.Name)
                            and arg.id in mine
                            and arg.id not in self.wrappers.get(owner, set())
                        ):
                            self.wrappers.setdefault(owner, set()).add(arg.id)
                            changed = True

    def _seed(self) -> None:
        calls = []
        module_classes = in_dirs(self.path, MODULE_DIRS)
        for node in self.nodes:
            if isinstance(node, ast.ClassDef):
                bases = [dotted_name(b, self.aliases) or "" for b in node.bases]
                autograd = any(
                    b == "Function" or b.endswith("autograd.Function")
                    for b in bases
                )
                methods = AUTOGRAD_METHODS if autograd else (
                    {"forward"} if module_classes and node.bases else set()
                )
                for s in node.body:
                    if isinstance(s, _DEF_NODES) and s.name in methods:
                        self.traced.add(s)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                if any(
                    is_graph_capture(item.context_expr, self.aliases)
                    for item in node.items
                ):
                    self.blocks.add(node)
            elif isinstance(node, ast.Call):
                at = next(enclosing_functions(node), None)
                calls.append((node, at))
                if dotted_name(node.func, self.aliases) in CHECKPOINT_CALLS:
                    for arg in node.args:
                        self.traced.update(self._resolve_funcarg(arg, at))
        self._find_wrappers(calls)
        for call, at in calls:
            for callee, offset in self._callees(call, at):
                for name in self.wrappers.get(callee, ()):
                    arg = self._arg_for(call, callee, name, offset)
                    if arg is not None:
                        self.traced.update(self._resolve_funcarg(arg, at))

    def _propagate(self) -> None:
        done: set = set()
        changed = True
        while changed:
            changed = False
            for region in list(self.traced) + list(self.blocks):
                if region in done:
                    continue
                done.add(region)
                changed = True
                for node in ast.walk(region):
                    if isinstance(node, FUNC_NODES) and node is not region:
                        self.traced.add(node)
                    elif isinstance(node, ast.Call) and isinstance(
                        node.func, ast.Name
                    ):
                        at = next(enclosing_functions(node), None)
                        for cal in self._defs_by_name.get(node.func.id, []):
                            if self._visible_from(cal, at):
                                self.traced.add(cal)

    # -------------------------------------------------------------- queries

    def is_traced(self, node: ast.AST) -> bool:
        """True when ``node`` runs inside any traced function or capture
        block."""
        if isinstance(node, FUNC_NODES) and node in self.traced:
            return True
        cur = parent(node)
        while cur is not None:
            if cur in self.traced or cur in self.blocks:
                return True
            cur = parent(cur)
        return False


def _enclosing_class(fn: ast.AST) -> Optional[ast.ClassDef]:
    """The class whose body holds ``fn`` or one of its enclosing
    functions."""
    cur = parent(fn)
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return cur
        cur = parent(cur)
    return None


def _walk_same_scope(node: ast.AST) -> Iterator[ast.AST]:
    """``ast.walk`` that does not enter nested function definitions (their
    bodies run later, not where they are written)."""
    stack = [node]
    while stack:
        cur = stack.pop()
        yield cur
        for child in ast.iter_child_nodes(cur):
            if not isinstance(child, FUNC_NODES):
                stack.append(child)


@dataclass
class ModuleContext:
    """Everything a rule sees for one linted file."""

    path: str  # display path (as passed/discovered, posix separators)
    tree: ast.AST
    aliases: dict
    traced: TracedIndex
    declared_axes: frozenset  # mesh axis names visible to this lint run

    @property
    def nodes(self) -> list:
        """Every node of the module, in ``ast.walk`` order (walked once)."""
        return self.traced.nodes
