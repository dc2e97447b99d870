"""JGL003 — Python-side and global-generator nondeterminism in traced
code.

The torch meaning of the JAX rule
(``raft_ncup_tpu/analysis/rules/jgl003_nondeterminism.py``).
``time.*``, stdlib ``random.*`` and ``numpy.random.*`` in a CUDA-graph
capture run once, at capture: the value is frozen into the graph and
every replay reuses it (the "my noise never changes" bug), and in an
autograd function or a forward they make two ranks of a mesh compute
different things from the same inputs.

torch's own draws are replayed correctly by a graph (its generator
advances a Philox offset per replay), so they are flagged for a
different reason: a draw from the *global* generator (``torch.rand``,
``randn``, ``randint``, ``randperm``, ``bernoulli``, ``normal``,
``multinomial``, their ``*_like`` forms, and the in-place ``normal_``,
``uniform_``, ``bernoulli_``, ``random_``, ``exponential_``) with no
``generator=`` couples the traced region's randomness to every other
draw in the process (other threads, other models, the data loader), so
no seed of the region's own reproduces it. The repo's contract is an
explicit, seeded ``torch.Generator`` passed as ``generator=``. Reseeding
the global generator (``torch.manual_seed``, ``torch.seed``,
``torch.cuda.manual_seed[_all]``) in traced code is flagged too: under
capture it runs once, and eagerly it resets every other draw.
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

RULE_ID = "JGL003"
SUMMARY = (
    "time/random/np.random, a global-generator torch draw, or a reseed "
    "in traced code"
)

_NONDET_PREFIXES = ("time.", "random.", "numpy.random.")
_NONDET_EXACT = frozenset({"os.urandom", "uuid.uuid4", "secrets.token_bytes"})
_RESEEDS = frozenset(
    {
        "torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
        "torch.cuda.manual_seed_all", "torch.random.manual_seed",
    }
)
_TORCH_DRAWS = frozenset(
    {
        "rand", "randn", "randint", "randperm", "bernoulli", "normal",
        "multinomial", "poisson", "rand_like", "randn_like", "randint_like",
    }
)
_INPLACE_DRAWS = frozenset(
    {"normal_", "uniform_", "bernoulli_", "random_", "exponential_",
     "cauchy_", "log_normal_", "geometric_"}
)


def _culprit(node: ast.Call, aliases: dict):
    dn = dotted_name(node.func, aliases)
    if dn is not None and (
        dn in _NONDET_EXACT or dn.startswith(_NONDET_PREFIXES)
    ):
        return dn, "runs once at capture and freezes its value into the graph"
    if dn in _RESEEDS:
        return dn, "reseeds the global generator that every other draw uses"
    if any(kw.arg == "generator" for kw in node.keywords):
        return None
    if dn is not None and dn.startswith("torch.") and (
        dn.split(".")[-1] in _TORCH_DRAWS and dn.count(".") == 1
    ):
        return dn, "draws from the global generator"
    if isinstance(node.func, ast.Attribute) and node.func.attr in _INPLACE_DRAWS:
        return f".{node.func.attr}()", "draws from the global generator"
    return None


def check(ctx: ModuleContext) -> Iterator[Finding]:
    for node in ctx.nodes:
        if not isinstance(node, ast.Call) or not ctx.traced.is_traced(node):
            continue
        hit = _culprit(node, ctx.aliases)
        if hit is None:
            continue
        what, why = hit
        yield Finding(
            ctx.path,
            node.lineno,
            node.col_offset,
            RULE_ID,
            f"`{what}` in traced code {why}; pass a seeded "
            "torch.Generator as generator= (or move the read outside the "
            "traced region)",
            qualname(node),
        )
