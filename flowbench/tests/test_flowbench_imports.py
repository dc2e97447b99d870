"""What the benchmark loads: no run holds ``jax``, ``jaxlib``, ``flax`` or
the JAX package (by whole top-level name: ``raft_ncup_tpu_torch`` is not
``raft_ncup_tpu``), and the reference loads nothing of the program."""

import ast
import os
import subprocess
import sys

from flowbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "raft_ncup_tpu"}


def _tops_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted("
                          "{m.split('.')[0] for m in sys.modules})))"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_harness_and_drivers_load_no_jax():
    code = ("import flowbench.run, flowbench.harness, flowbench.launch, flowbench.readers\n"
            "import flowbench.drivers.serve, flowbench.drivers.train, flowbench.drivers.mesh_serve\n"
            "from flowbench import harness\n"
            "import raft_ncup_tpu_torch.serving.server, raft_ncup_tpu_torch.training.step\n"
            "import raft_ncup_tpu_torch.observability, raft_ncup_tpu_torch.parallel.multihost\n"
            "[harness.load_reader(m['name']) for m in harness.load_benchmark()['per_layer']]\n")
    tops = _tops_after(code)
    assert "raft_ncup_tpu_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    tops = _tops_after("import flowbench.reference.model, flowbench.reference.train\n")
    assert not tops & (FORBIDDEN | {"raft_ncup_tpu_torch"})


def test_whole_names_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "raft_ncup_tpu_torch_x", sys)
    assert "raft_ncup_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "raft_ncup_tpu.config", sys)
    assert "raft_ncup_tpu" in harness.forbidden_modules()


def test_no_source_imports_jax():
    bad = []
    reference = os.path.join(harness.HERE, "reference")
    for dirpath, _, files in os.walk(harness.HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            for node in ast.walk(ast.parse(open(path).read())):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                bad += [(path, n) for n in names if n.split(".")[0] in FORBIDDEN]
                if dirpath == reference:
                    bad += [(path, n) for n in names if n.split(".")[0] == "raft_ncup_tpu_torch"]
    assert not bad
