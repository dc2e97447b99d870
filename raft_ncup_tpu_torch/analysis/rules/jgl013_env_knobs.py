"""JGL013 — one env-knob registry, no stragglers.

Every ``RAFT_TORCH_*`` environment knob of the port is declared exactly
once, as a key of the ``KNOBS`` dict in ``raft_ncup_tpu_torch/utils/
knobs.py`` (default, one line of meaning), and read only through its
getters ``knob_raw`` / ``knob_enabled``. The meaning is the JAX rule's
(``raft_ncup_tpu/analysis/rules/jgl013_env_knobs.py``); the prefix, the
registry's form and the entry points are the port's. Three checks, all
whole-program:

- a direct ``os.environ`` read (``.get``/``[]``/``os.getenv``/``in``)
  whose name carries the prefix, anywhere outside ``knobs.py`` itself,
  is a finding: the knob exists but dodges the registry (no declared
  default, no line of meaning);
- a getter call naming a knob the registry does not declare is a
  finding (the getters also raise at run time; the rule catches it
  before anything runs);
- a registered knob that no getter call ever reads is a finding: a dead
  knob, or a migration that silently dropped a reader. This half only
  runs when the linted set holds the registry AND every entry point of
  the port (``train.py``, ``serve.py``, ``evaluate.py`` and ``demo.py``
  of the package, and at least one root ``chip_*.py``): a lint of one
  subdirectory cannot call a knob dead, the same scope-completeness
  gate JGL012 applies to its drift halves.

Names are resolved through module-level string constants and import
aliases (``knob_raw(CPU_PEAK_ENV)`` with the constant in the same or
another module resolves); dynamic names are out of static reach, and
the getters' run-time check covers them. Writes (``os.environ[k] = v``,
``os.environ.pop``) are a parent setting a child's environment, not
reads, and are not judged.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterator, List

from raft_ncup_tpu_torch.analysis.astutil import Finding
from raft_ncup_tpu_torch.analysis.project import ProjectIndex, registry_keys

RULE_ID = "JGL013"
SUMMARY = (
    "env knob read outside utils/knobs.py, unregistered knob name, or "
    "registered knob never read (whole-program)"
)

KNOB_PREFIX = re.compile(r"^RAFT_TORCH_")

# The port's entry points, where knob readers live; the unread-knob half
# only runs when all of them (and a root chip_*.py) are in the linted set.
DRIVER_BASENAMES = frozenset({"train.py", "serve.py", "evaluate.py", "demo.py"})


def _basename(path: str) -> str:
    return path.replace("\\", "/").rsplit("/", 1)[-1]


def _package_registry() -> Dict[str, None]:
    """Fallback registry: the ``KNOBS`` keys parsed from the package's own
    utils/knobs.py, so linting a subdirectory standalone still validates
    getter names. Empty on partial checkouts: silence, never a crash."""
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)
        ))),
        "utils", "knobs.py",
    )
    try:
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), filename=path)
    except (OSError, SyntaxError):
        return {}
    return {
        name: None for stmt in tree.body for name, _ in registry_keys(stmt)
    }


def check_project(proj: ProjectIndex) -> Iterator[Finding]:
    decls = [
        d for d in proj.knob_decls
        if _basename(d.site.path) == "knobs.py"
    ]
    registry_in_scope = bool(decls)
    registered = {d.name for d in decls} or set(_package_registry())

    findings: List[Finding] = []

    for read in proj.env_reads:
        if read.name is None or not KNOB_PREFIX.match(read.name):
            continue
        if _basename(read.site.path) == "knobs.py":
            continue  # the registry's own getters
        findings.append(Finding(
            path=read.site.path,
            line=read.site.line,
            col=read.site.col,
            rule=RULE_ID,
            message=(
                f"direct os.environ read of knob {read.name!r} outside "
                "the registry — read it through "
                "raft_ncup_tpu_torch.utils.knobs (knob_raw/knob_enabled) "
                "so the name, default and meaning are declared once"
            ),
            qualname=read.site.qual,
        ))

    for call in proj.knob_calls:
        if call.name is None:
            continue  # dynamic name: the getter raises at runtime
        if call.name not in registered:
            findings.append(Finding(
                path=call.site.path,
                line=call.site.line,
                col=call.site.col,
                rule=RULE_ID,
                message=(
                    f"{call.getter}({call.name!r}) names a knob the "
                    "registry does not declare — add it to KNOBS in "
                    "raft_ncup_tpu_torch/utils/knobs.py"
                ),
                qualname=call.site.qual,
            ))

    basenames = {_basename(p) for p in proj.paths}
    has_chip = any(
        b.startswith("chip_") and b.endswith(".py") for b in basenames
    )
    if registry_in_scope and has_chip and DRIVER_BASENAMES <= basenames:
        read_names = {c.name for c in proj.knob_calls if c.name}
        for decl in sorted(decls, key=lambda d: d.name):
            if decl.name not in read_names:
                findings.append(Finding(
                    path=decl.site.path,
                    line=decl.site.line,
                    col=decl.site.col,
                    rule=RULE_ID,
                    message=(
                        f"knob {decl.name!r} is registered but no "
                        "knob_* getter ever reads it — dead knob, or a "
                        "reader was dropped in a migration"
                    ),
                    qualname=decl.site.qual,
                ))

    yield from findings
