"""The port stands alone: it imports nothing of JAX, flax, the JAX
package, OpenCV or Pillow (the card machine has none of them), at run
time (a fresh interpreter) or in its source (an AST scan of every module
and of ``chip_smoke.py``, ``chip_compare.py``, ``chip_spans.py`` and
``chip_procs.py``)."""

import ast
import os
import subprocess
import sys

import jax  # noqa: F401  (the test process itself keeps JAX on the CPU)
import pytest
import torch  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "raft_ncup_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "raft_ncup_tpu", "cv2", "PIL")


def _port_sources():
    files = [os.path.join(REPO, n) for n in ("chip_smoke.py", "chip_compare.py", "chip_spans.py",
                                             "chip_procs.py")]
    for root, _dirs, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_no_source_file_imports_jax_or_the_jax_package():
    files = _port_sources()
    assert len(files) > 20 and os.path.exists(files[0])
    scanned = {os.path.relpath(f, PKG) for f in files}
    assert {os.path.join("streaming", n) for n in
            ("__init__.py", "engine.py", "slots.py", "traffic.py")} <= scanned
    assert {os.path.join("analysis", n) for n in ("__init__.py", "guards.py")} <= scanned
    bad = {
        os.path.relpath(f, REPO): sorted(set(_imported_roots(f)) & set(FORBIDDEN))
        for f in files
    }
    assert not {k: v for k, v in bad.items() if v}


@pytest.mark.parametrize(
    "module",
    ["raft_ncup_tpu_torch", "raft_ncup_tpu_torch.serve", "raft_ncup_tpu_torch.train",
     "raft_ncup_tpu_torch.evaluate", "raft_ncup_tpu_torch.demo",
     "raft_ncup_tpu_torch.streaming", "raft_ncup_tpu_torch.observability",
     "raft_ncup_tpu_torch.analysis"],
)
def test_fresh_import_loads_no_jax(module):
    code = (
        f"import sys, importlib; importlib.import_module({module!r}); "
        "import raft_ncup_tpu_torch.models.raft, raft_ncup_tpu_torch.utils.jax_weights; "
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
