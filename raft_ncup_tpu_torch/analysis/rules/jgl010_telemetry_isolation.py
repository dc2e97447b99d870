"""JGL010 — tensor access inside the telemetry and fleet packages.

The torch meaning of the JAX rule
(``raft_ncup_tpu/analysis/rules/jgl010_telemetry_isolation.py``).
Every other subsystem must not *leak* host syncs; telemetry must not
*add* them. A metrics registry that calls ``.item()`` on a card scalar,
a span that stashes a tensor in its attributes, a snapshot thread that
``numpy.asarray``-pulls a buffer: each puts a device round-trip on the
hot path *from the observer*. The port's ``observability/`` is host-only
stdlib by construction, and ``fleet/`` (host-only stdlib and numpy)
shares the contract: the router sits in front of every request, and a
replica supervisor that imports torch pays for (and may initialize) a
CUDA runtime in a process whose whole job is to watch other processes
own the card. The rule enforces both statically:

- **no torch import at all** (``import torch``, ``from torch import
  ...``, ``import torch.nn``): both packages stay importable, and
  correct, without the array library;
- **no tensor access**: any ``torch.*`` call (however aliased), the
  implicit pulls ``.item()``, ``.tolist()``, ``.numpy()``, ``.cpu()``,
  and ``numpy.asarray``/``numpy.array`` calls (on a tensor, a pull).

One more contract, specific to ``fleet/``: the trace-context wire header
stays optional. No code in ``fleet/`` may read it with a mandatory
subscript (``header["trace"]``); consumers use ``.get`` (and
``TraceContext.from_wire`` tolerates None). Writing the field is fine.

Values crossing into telemetry are host numbers already, pulled at the
producers' sanctioned boundaries (the ``AsyncDrain`` worker's one read
per batch, ``guards.host_read`` at a window).
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

RULE_ID = "JGL010"
SUMMARY = (
    "torch import or tensor access inside observability/ or fleet/ "
    "— telemetry and the fleet control plane are host-only and must "
    "never add a sync"
)

_NUMPY_PULLS = frozenset({"numpy.asarray", "numpy.array"})
_METHOD_PULLS = frozenset({"item", "tolist", "numpy", "cpu"})


def check(ctx: ModuleContext) -> Iterator[Finding]:
    if not in_dirs(ctx.path, ("observability", "fleet")):
        return
    in_fleet = in_dirs(ctx.path, ("fleet",))
    for node in ctx.nodes:
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] == "torch":
                    yield Finding(
                        ctx.path, node.lineno, node.col_offset, RULE_ID,
                        f"`import {alias.name}` in observability//fleet/: "
                        "telemetry and the fleet are host-only — a torch "
                        "import here puts tensor access one attribute away "
                        "from every metric call; record host numbers pulled "
                        "at the producers' sanctioned boundaries instead",
                        qualname(node),
                    )
        elif isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[0] == "torch":
                yield Finding(
                    ctx.path, node.lineno, node.col_offset, RULE_ID,
                    f"`from {node.module} import ...` in "
                    "observability//fleet/: telemetry and the fleet are "
                    "host-only (see JGL010)",
                    qualname(node),
                )
        elif isinstance(node, ast.Call):
            dn = dotted_name(node.func, ctx.aliases)
            if dn is not None and dn.split(".")[0] == "torch":
                yield Finding(
                    ctx.path, node.lineno, node.col_offset, RULE_ID,
                    f"`{dn}` call in observability//fleet/: a tensor access "
                    "inside telemetry adds the very sync the guarded hot "
                    "path forbids — pull at the producer's sanctioned "
                    "boundary and hand telemetry the host number",
                    qualname(node),
                )
            elif dn in _NUMPY_PULLS:
                yield Finding(
                    ctx.path, node.lineno, node.col_offset, RULE_ID,
                    f"`{dn}` call in observability//fleet/: on a tensor this "
                    "is an implicit device→host pull — telemetry receives "
                    "host numbers, it never converts",
                    qualname(node),
                )
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _METHOD_PULLS
                and not node.args
                and not node.keywords
            ):
                yield Finding(
                    ctx.path, node.lineno, node.col_offset, RULE_ID,
                    f"`.{node.func.attr}()` call in observability//fleet/: on "
                    "a tensor this is an implicit device→host pull — "
                    "telemetry receives host numbers, it never converts",
                    qualname(node),
                )
        elif (
            in_fleet
            and isinstance(node, ast.Subscript)
            and isinstance(node.ctx, ast.Load)
            and isinstance(node.slice, ast.Constant)
            and node.slice.value == "trace"
        ):
            yield Finding(
                ctx.path, node.lineno, node.col_offset, RULE_ID,
                "mandatory `[\"trace\"]` read in fleet/: the trace-context "
                "wire header is OPTIONAL (old peers must parse new frames "
                "and vice versa) — read it with `.get('trace')` and "
                "tolerate None (TraceContext.from_wire does)",
                qualname(node),
            )
