"""The port's static lint (``raft_ncup_tpu_torch/analysis``) held against
the JAX package's (``raft_ncup_tpu/analysis``), both run in this process:

- the rules whose meaning does not change (JGL007, JGL011, JGL012) give
  the JAX lint's findings on the port's own files and on the JAX tests'
  snippets, and the CLI gives the JAX CLI's exit codes and JSON keys;
- every translated rule gives, on a torch snippet laid out line for line
  like a JAX one, the JAX rule's (rule, line, qualname) list: one pair
  that fires and one clean pair with the sanctioned pattern per rule;
- the traced index is not vacuous on the real modules, the shipped tree
  lints clean through the module CLI, and the lint imports only the
  standard library;
- the port repairs the lint asked for keep their behaviour.
"""

from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from raft_ncup_tpu.analysis import lint as jax_lint
from raft_ncup_tpu_torch.analysis import astutil
from raft_ncup_tpu_torch.analysis import lint as port_lint
from raft_ncup_tpu_torch.analysis.rules import RULES_BY_ID

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "raft_ncup_tpu_torch")
SAME_MEANING = ["JGL007", "JGL011", "JGL012"]


def _write(root, files: dict) -> None:
    for rel, source in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(source))


def _keys(result, root, full=True):
    out = []
    for f in result.findings:
        path = os.path.relpath(f.path, root).replace(os.sep, "/")
        out.append((f.rule, path, f.line, f.col, f.qualname) if full
                   else (f.rule, path, f.line, f.qualname))
    return sorted(out)


# ------------------------------------------- rules with the same meaning


def test_same_meaning_rules_match_jax_on_the_ports_files():
    paths = [os.path.join(PKG, d) for d in
             ("fleet", "observability", "resilience", "training", "data")]
    paths.append(os.path.join(PKG, "serve.py"))
    ours = port_lint.run_lint(paths, select=SAME_MEANING)
    ref = jax_lint.run_lint(paths, select=SAME_MEANING)
    assert ours.files_checked == ref.files_checked > 20
    assert _keys(ours, REPO) == _keys(ref, REPO)
    # The baseline both give: the reply and republish fields that only
    # direct clients read (allowlisted in both packages).
    assert sorted((f.rule, os.path.basename(f.path), f.qualname) for f in ours.findings) == [
        ("JGL012", "host_supervisor.py", "_handle"),
        ("JGL012", "host_supervisor.py", "_handle"),
        ("JGL012", "host_supervisor.py", "_handle"),
        ("JGL012", "host_supervisor.py", "republish"),
        ("JGL012", "serve.py", "_serve_conn"),
        ("JGL012", "serve.py", "_serve_conn"),
        ("JGL012", "serve.py", "respond"),
    ]


_LOCKED_REGISTRY = """
    import threading

    class Registry:
        def __init__(self):
            self._lock = threading.Lock()
            self._items = {}

        def add(self, key, value):
            with self._lock:
                self._items[key] = value

        def peek(self, key):
            return self._items.get(key)   # unlocked read

        def _locked_size(self):
            return len(self._items)   # guarded via callers

        def size(self):
            with self._lock:
                return self._locked_size()
    """

# The snippet cases of tests/test_lint.py for the same-meaning rules.
SNIPPETS = {
    "jgl007_swallowed": {"data/bad.py": """
        def load(path):
            try:
                return open(path).read()
            except Exception:
                pass

        def drain(q):
            while True:
                try:
                    return q.get_nowait()
                except:
                    continue
        """},
    "jgl007_handled_or_narrow": {"training/ok.py": """
        import sys

        def save(fn):
            try:
                fn()
            except Exception as e:
                print(f"save failed: {e}", file=sys.stderr)
                raise

        def close(handle):
            try:
                handle.close()
            except OSError:
                pass

        def teardown(handle, stats):
            try:
                handle.close()
            except Exception as e:
                stats.record(e)
        """},
    "jgl007_out_of_scope": {"drivers/free.py": """
        def f(x):
            try:
                return x()
            except Exception:
                pass
        """},
    "jgl007_supervisor_eats_deaths": {"fleet/replica.py": """
        def poll(children):
            for child in children:
                try:
                    child.check()
                except Exception:
                    pass
        """},
    "jgl011_unlocked_read": {"fleet/reg.py": _LOCKED_REGISTRY},
    "jgl011_scope": {"inference/reg.py": _LOCKED_REGISTRY},
    "jgl011_cross_module": {
        "fleet/router.py": """
        import threading

        class Router:
            def __init__(self):
                self._lock = threading.Lock()
                self._pending = {}

            def submit(self, rid):
                with self._lock:
                    self._pending[rid] = 1
        """,
        "fleet/replay.py": """
        def replay(router):
            with router._lock:
                router._pending.clear()
            return router._pending.get(0)
        """,
    },
    "jgl012_drift_and_bare": {
        "fleet/worker.py": """
        def handle(header):
            value = header["payload"]
            if header.get("kind") != "job":
                return None
            return value

        def reply_ok(rid):
            reply = {"kind": "ok", "orphan_field": rid}
            return reply
        """,
        "serve.py": """
        def consume(header):
            return header.get("ghost_field")
        """,
    },
    "jgl012_matched_and_carveouts": {
        "fleet/worker.py": """
        def reply_ok(rid, header, ctx):
            kind = header["kind"]
            header["trace"] = ctx
            trace = header["trace"]
            reply = {"kind": "ok", "result": rid}
            return reply, kind, trace
        """,
        "serve.py": """
        def consume(header):
            return header.get("result"), header.get("kind")
        """,
    },
    "jgl012_needs_both_ends": {"fleet/worker.py": """
        def reply_ok(rid):
            return {"kind": "ok", "half_seen": rid}
        """},
}


@pytest.mark.parametrize("case", sorted(SNIPPETS))
def test_same_meaning_rules_match_jax_on_snippets(tmp_path, case):
    _write(tmp_path, SNIPPETS[case])
    ours = port_lint.run_lint([str(tmp_path)], select=SAME_MEANING)
    ref = jax_lint.run_lint([str(tmp_path)], select=SAME_MEANING)
    assert not ours.parse_errors and not ref.parse_errors
    assert _keys(ours, tmp_path) == _keys(ref, tmp_path)
    fires = case in ("jgl007_swallowed", "jgl007_supervisor_eats_deaths",
                     "jgl011_unlocked_read", "jgl011_cross_module", "jgl012_drift_and_bare")
    assert bool(ours.findings) == fires


# ------------------------------------------------------ the engine's CLI


def _cli(module, argv, capsys):
    rc = module.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


_CLI_FILES = {
    "fleet/reg.py": _LOCKED_REGISTRY,
    "clean.py": "x = 1\n",
}
_ALLOWLISTS = {
    "no_justification": "fleet/reg.py::JGL011::peek\n",
    "bad_syntax": "fleet/reg.py  # a path alone is no entry\n",
    "unknown_rule": "fleet/reg.py::JGL999::peek  # no such rule\n",
    "stale": "fleet/reg.py::JGL011::peek  # audited\nclean.py::JGL011::*  # suppresses nothing\n",
    "used": "fleet/reg.py::JGL011::peek  # audited\n",
}
_ARGVS = {
    "findings": [],
    "select_other_rule": ["--select", "JGL007"],
    "select_unknown_rule": ["--select", "JGL999"],
    "no_justification": ["--allowlist", "{no_justification}"],
    "bad_syntax": ["--allowlist", "{bad_syntax}"],
    "unknown_rule": ["--allowlist", "{unknown_rule}"],
    "stale": ["--allowlist", "{stale}"],
    "stale_strict": ["--allowlist", "{stale}", "--strict-allowlist"],
    "stale_strict_no_allowlist": ["--allowlist", "{stale}", "--strict-allowlist",
                                  "--no-allowlist"],
    "used_strict_suppressed": ["--allowlist", "{used}", "--strict-allowlist",
                               "--show-suppressed"],
    "json": ["--format", "json"],
    "json_suppressed": ["--format", "json", "--allowlist", "{used}"],
}


@pytest.mark.parametrize("case", sorted(_ARGVS))
def test_cli_exit_codes_and_json_keys_match_jax(tmp_path, capsys, case):
    _write(tmp_path, _CLI_FILES)
    lists = {}
    for name, text in _ALLOWLISTS.items():
        lists[name] = str(tmp_path / f"{name}.txt")
        (tmp_path / f"{name}.txt").write_text(text)
    argv = [str(tmp_path)] + [a.format(**lists) for a in _ARGVS[case]]
    rc, out, err = _cli(port_lint, argv, capsys)
    ref_rc, ref_out, ref_err = _cli(jax_lint, argv, capsys)
    assert rc == ref_rc, (out, err, ref_out, ref_err)
    assert rc == {"findings": 1, "select_other_rule": 0, "select_unknown_rule": 2,
                  "no_justification": 2, "bad_syntax": 2, "unknown_rule": 2, "stale": 0,
                  "stale_strict": 1, "stale_strict_no_allowlist": 1,
                  "used_strict_suppressed": 0, "json": 1, "json_suppressed": 0}[case]
    if case.startswith("json"):
        doc, ref = json.loads(out), json.loads(ref_out)
        assert set(doc) == set(ref)
        assert [set(f) for f in doc["findings"]] == [set(f) for f in ref["findings"]]
        assert doc["findings"] and doc["exit_code"] == ref["exit_code"] == rc
    if case == "used_strict_suppressed":
        assert "[allowed]" in out and "[allowed]" in ref_out


def test_list_rules_has_every_jax_rule_id(capsys):
    rc, out, _ = _cli(port_lint, ["--list-rules"], capsys)
    ref_rc, ref_out, _ = _cli(jax_lint, ["--list-rules"], capsys)
    ids = [line.split()[0] for line in out.splitlines()[1:]]
    assert rc == ref_rc == 0
    assert ids == [line.split()[0] for line in ref_out.splitlines()[1:]]
    assert ids == [f"JGL{i:03d}" for i in range(1, 14)] == sorted(RULES_BY_ID)
    for rule in RULES_BY_ID.values():
        doc = sys.modules[rule.__name__].__doc__
        assert rule.RULE_ID in doc and "raft_ncup_tpu/analysis/rules/" in doc


# ------------------------------------------------------ translated rules

# (id, rule, fires, JAX files, torch files): each torch file is the JAX
# one's translation, line for line, so both rules' (rule, path, line,
# qualname) lists must agree.
PAIRS = [
    ("host_sync", "JGL001", True, {"m.py": """
        import jax
        import numpy as np


        @jax.jit
        def forward(x):
            y = x * 2
            n = float(y.sum())
            v = y.item()
            return np.asarray(y), n, v
        """}, {"m.py": """
        import torch
        import numpy as np

        class _F(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                y = x * 2
                n = float(y.sum())
                v = y.item()
                return np.asarray(y), n, v
        """}),
    ("host_sync_checkpoint_and_capture", "JGL001", True, {"m.py": """
        import jax


        def step(x):
            return x.tolist()

        def train(x):
            return jax.checkpoint(step)(x)

        def body(x):
            return int(x)
        out = jax.lax.scan(body, 0, None)
        """}, {"m.py": """
        import torch
        from torch.utils.checkpoint import checkpoint

        def step(x):
            return x.tolist()

        def train(x):
            return checkpoint(step, x)

        def body(x):
            return int(x)
        graphed = torch.cuda.make_graphed_callables(body, (0,))
        """}),
    ("host_sync_clean", "JGL001", False, {"m.py": """
        import jax


        @jax.jit
        def forward(x):
            n = int(len(x)) + 1
            return x * n

        def report(y):
            return float(y.sum()), y.item()
        """}, {"m.py": """
        import torch
        from raft_ncup_tpu_torch.analysis.guards import host_read
        class _F(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                n = int(len(x)) + 1
                return x * n

        def report(y):
            return float(y.sum()), host_read(y)
        """}),
    ("donation", "JGL002", True, {"m.py": """
        import jax


        def capture(state, batch):
            def step(state, batch):
                return state
            return jax.jit(step)
        """}, {"m.py": """
        import torch


        def capture(fn, graphs):
            for g in graphs:
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    fn()
        """}),
    ("donation_clean", "JGL002", False, {"m.py": """
        import jax


        def capture(state, batch):
            def step(state, batch):
                return state
            return jax.jit(step, donate_argnums=0)
        """}, {"m.py": """
        import torch

        POOL = torch.cuda.graph_pool_handle()
        def capture(fn, graphs):
            for g in graphs:
                with torch.cuda.graph(g, pool=POOL):
                    fn()
        """}),
    ("nondeterminism", "JGL003", True, {"m.py": """
        import time
        import jax
        import numpy as np

        @jax.jit
        def forward(x):
            t = time.time()
            noise = np.random.rand(3)
            return x + t + noise
        """}, {"m.py": """
        import time
        import torch

        class _F(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                t = time.time()
                noise = torch.rand(3)
                return x + t + noise
        """}),
    ("nondeterminism_clean", "JGL003", False, {"m.py": """
        import jax


        @jax.jit
        def forward(x, key):
            noise = jax.random.normal(key, x.shape)
            return x + noise
        """}, {"m.py": """
        import torch

        class _F(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, gen):
                noise = torch.randn(x.shape, generator=gen)
                return x + noise
        """}),
    ("control_flow", "JGL004", True, {"m.py": """
        import jax
        import jax.numpy as jnp


        @jax.jit
        def forward(x):
            if jnp.any(x > 0):
                x = x + 1
            while x.sum() > 10:
                x = x / 2
            return x
        """}, {"m.py": """
        import torch


        class _F(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                if torch.any(x > 0):
                    x = x + 1
                while x.sum() > 10:
                    x = x / 2
                return x
        """}),
    ("control_flow_clean", "JGL004", False, {"m.py": """
        import jax


        @jax.jit
        def forward(x, small):
            if small and x.shape[0] % 8 == 0:
                x = x + 1
            if jax.device_count() > 1:
                x = x * 2
            return x
        """}, {"m.py": """
        import torch


        class _F(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, small):
                if small and x.shape[0] % 8 == 0:
                    x = x + 1
                if torch.cuda.device_count() > 1:
                    x = x * 2
                return x
        """}),
    ("dtype_hygiene", "JGL005", True, {"ops/k.py": """
        import jax.numpy as jnp
        import numpy as np

        def prepare(x):
            a = jnp.asarray(x)
            b = a.astype(np.float64)
            return b, jnp.zeros((2,), dtype="float64")
        """}, {"ops/k.py": """
        import torch
        import numpy as np

        def prepare(x):
            a = torch.as_tensor(x)
            b = a.to(torch.float64)
            return b, torch.zeros((2,), dtype="float64")
        """}),
    ("dtype_hygiene_clean", "JGL005", False, {"ops/k.py": """
        import jax.numpy as jnp


        def prepare(x):
            a = jnp.asarray(x, jnp.float32)
            return jnp.array([1.0, 2.0], dtype=jnp.float32) + a
        """}, {"ops/k.py": """
        import torch


        def prepare(x):
            a = torch.as_tensor(x, torch.float32)
            return torch.tensor([1.0, 2.0], dtype=torch.float32) + a
        """}),
    ("mesh_axes", "JGL006", True, {"serving/s.py": """
        from jax.sharding import PartitionSpec as P


        def spec(mesh):
            return P("data", "spatail")
        """}, {"serving/s.py": """
        from raft_ncup_tpu_torch.parallel.mesh import _groups


        def spec(mesh):
            return _groups(mesh, "spatail")
        """}),
    ("mesh_axes_shape_get", "JGL006", True, {"serving/s.py": """
        from jax.sharding import PartitionSpec as P


        def spec(mesh):
            return P("pipe_axis")
        """}, {"serving/s.py": """



        def spec(mesh):
            return mesh.shape.get("pipe_axis", 1)
        """}),
    ("mesh_axes_clean", "JGL006", False, {"serving/s.py": """
        from jax.sharding import PartitionSpec as P


        def spec(mesh):
            return P("data", "spatial"), P("pipe")
        """}, {"serving/s.py": """
        from raft_ncup_tpu_torch.parallel.mesh import _groups


        def spec(mesh):
            return _groups(mesh, "data"), mesh.shape["spatial"], mesh.shape.get("pipe", 1)
        """}),
    ("eval_loop_pulls", "JGL008", True, {"inference/loop.py": """
        import jax


        def evaluate(batches, forward):
            out = []
            for b in batches:
                out.append(jax.device_get(forward(b)))
                n = forward(b).item()
            return out, n
        """}, {"inference/loop.py": """
        from raft_ncup_tpu_torch.analysis.guards import host_read


        def evaluate(batches, forward):
            out = []
            for b in batches:
                out.append(host_read(forward(b)))
                n = forward(b).item()
            return out, n
        """}),
    ("eval_loop_pulls_clean", "JGL008", False, {"inference/loop.py": """
        import jax


        def evaluate(batches, forward, acc):
            for b in batches:
                acc = acc + forward(b)
                jax.block_until_ready(acc)
            return jax.device_get(acc)
        """}, {"inference/loop.py": """
        import torch
        from raft_ncup_tpu_torch.analysis.guards import host_read

        def evaluate(batches, forward, acc):
            for b in batches:
                acc = acc + forward(b)
                torch.cuda.synchronize()
            return host_read(acc)
        """}),
    ("precision_policy", "JGL009", True, {"models/m.py": """
        import jax.numpy as jnp


        def forward(x):
            y = x.astype(jnp.bfloat16)
            z = y.astype(jnp.float32)
            return z
        """}, {"models/m.py": """
        import torch


        def forward(x):
            y = x.to(torch.bfloat16)
            z = y.float()
            return z
        """}),
    ("precision_policy_clean", "JGL009", False, {"models/m.py": """
        import jax.numpy as jnp

        PARAM_DTYPE = jnp.float32  # the policy's pinned master weights
        class Head:
            dtype = jnp.float32
            def __call__(self, x, policy):
                return x.astype(policy.compute_jnp).astype(PARAM_DTYPE)
        """}, {"models/m.py": """
        import torch

        PARAM_DTYPE = torch.float32  # the policy's pinned master weights
        class Head:
            dtype = torch.float32
            def __call__(self, x, policy):
                return x.to(policy.compute).to(PARAM_DTYPE)
        """}),
    ("telemetry_isolation", "JGL010", True, {"observability/t.py": """
        import jax
        import numpy as np

        def record(reg, value):
            reg.set(np.asarray(value))
            reg.set(value.item())
            return jax.device_get(value)
        """}, {"observability/t.py": """
        import torch
        import numpy as np

        def record(reg, value):
            reg.set(np.asarray(value))
            reg.set(value.item())
            return torch.as_tensor(value)
        """}),
    ("telemetry_isolation_clean", "JGL010", False, {"fleet/t.py": """
        import json
        import numpy as np

        def record(reg, value, header):
            reg.set(float(value))
            reg.set(np.frombuffer(value, dtype=np.float32))
            return json.dumps(header), header.get("trace")
        """}, {"fleet/t.py": """
        import json
        import numpy as np

        def record(reg, value, header):
            reg.set(float(value))
            reg.set(np.frombuffer(value, dtype=np.float32))
            return json.dumps(header), header.get("trace")
        """}),
    ("env_knobs", "JGL013", True, {
        "utils/knobs.py": """
        KNOBS = (
            Knob("RAFT_NCUP_ALPHA", "str", "a", "alpha knob"),
            Knob("RAFT_NCUP_DEAD", "str", "d", "dead knob"),
        )
        """,
        "train.py": "", "bench.py": "",
        "serve.py": """
        import os
        from raft_ncup_tpu.utils.knobs import knob_raw

        ALPHA_ENV = "RAFT_NCUP_ALPHA"

        def f():
            direct = os.environ.get(ALPHA_ENV)
            good = knob_raw("RAFT_NCUP_ALPHA")
            bad = knob_raw("RAFT_NCUP_GHOST")
            benign = os.environ.get("PATH")
            return direct, good, bad, benign
        """}, {
        "utils/knobs.py": """
        KNOBS = {
            "RAFT_TORCH_ALPHA": ("a", "alpha knob"),
            "RAFT_TORCH_DEAD": ("d", "dead knob"),
        }
        """,
        "train.py": "", "evaluate.py": "", "demo.py": "", "chip_smoke.py": "",
        "serve.py": """
        import os
        from raft_ncup_tpu_torch.utils.knobs import knob_raw

        ALPHA_ENV = "RAFT_TORCH_ALPHA"

        def f():
            direct = os.environ.get(ALPHA_ENV)
            good = knob_raw("RAFT_TORCH_ALPHA")
            bad = knob_raw("RAFT_TORCH_GHOST")
            benign = os.environ.get("PATH")
            return direct, good, bad, benign
        """}),
    ("env_knobs_clean", "JGL013", False, {
        "utils/knobs.py": """
        KNOBS = (
            Knob("RAFT_NCUP_ALPHA", "str", "a", "alpha knob"),
        )
        """,
        "mod.py": """
        import os
        from raft_ncup_tpu.utils.knobs import knob_enabled

        def f():
            good = knob_enabled("RAFT_NCUP_ALPHA")
            internal = os.environ.get("_RAFT_CHILD")
            return good, internal
        """}, {
        "utils/knobs.py": """
        KNOBS = {
            "RAFT_TORCH_ALPHA": ("a", "alpha knob"),
        }
        """,
        "mod.py": """
        import os
        from raft_ncup_tpu_torch.utils.knobs import knob_enabled

        def f():
            good = knob_enabled("RAFT_TORCH_ALPHA")
            internal = os.environ.get("_RAFT_CHILD")
            return good, internal
        """}),
]


def test_jgl001_takes_a_cast_of_a_shape_for_host_arithmetic(tmp_path):
    """Where the JAX rule exempts only literals and len(), a torch shape is
    a host integer too: int() of .shape, .size(), .numel() and arithmetic
    over them is not a sync."""
    _write(tmp_path, {"m.py": """
        import torch

        class _F(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                a = int(x.shape[0] * x.size(1)) + float(x.numel() // 2)
                b = int(x.sum())
                return x * a * b
        """})
    [f] = port_lint.run_lint([str(tmp_path)], select=["JGL001"]).findings
    assert (f.line, f.qualname) == (8, "forward")


def test_every_translated_rule_has_a_firing_and_a_clean_pair():
    translated = {"JGL001", "JGL002", "JGL003", "JGL004", "JGL005", "JGL006", "JGL008",
                  "JGL009", "JGL010", "JGL013"}
    assert translated | set(SAME_MEANING) == set(RULES_BY_ID)
    for fires in (True, False):
        assert {rule for _, rule, f, _, _ in PAIRS if f is fires} == translated


@pytest.mark.parametrize("case", PAIRS, ids=[p[0] for p in PAIRS])
def test_translated_rule_matches_jax_line_for_line(tmp_path, case):
    _, rule, fires, jax_files, torch_files = case
    _write(tmp_path / "jax", jax_files)
    _write(tmp_path / "torch", torch_files)
    ref = jax_lint.run_lint([str(tmp_path / "jax")], select=[rule])
    ours = port_lint.run_lint([str(tmp_path / "torch")], select=[rule])
    assert not ref.parse_errors and not ours.parse_errors
    got = _keys(ours, tmp_path / "torch", full=False)
    assert got == _keys(ref, tmp_path / "jax", full=False)
    assert bool(got) == fires, got


# ---------------------------------------------- not vacuous on the tree


def _index(rel: str) -> astutil.TracedIndex:
    path = os.path.join(PKG, rel)
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    astutil.attach_parents(tree)
    return astutil.TracedIndex(tree, astutil.collect_aliases(tree), "raft_ncup_tpu_torch/" + rel)


def _traced(index: astutil.TracedIndex) -> set:
    """The traced functions' names with their classes: ``_Lookup.forward``."""
    names = set()
    for fn in index.traced:
        parts, cur = [], fn
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                parts.append(cur.name)
            elif isinstance(cur, ast.Lambda):
                parts.append("<lambda>")
            cur = astutil.parent(cur)
        names.add(".".join(reversed(parts)))
    return names


def test_traced_index_marks_the_real_kernels_forwards_and_captures():
    assert {"_Lookup.forward", "_Lookup.backward"} <= _traced(_index("ops/corr_cuda.py"))
    assert {"_NConv.forward", "_NConv.backward"} <= _traced(_index("ops/nconv_cuda.py"))
    assert {"RAFT.forward", "RAFT._forward_train.step"} <= _traced(_index("models/raft.py"))
    assert {"ConvGRU.forward", "BasicUpdateBlock.forward"} <= _traced(_index("nn/update.py"))
    pipeline = _index("inference/pipeline.py")
    wrappers = {fn.name: names for fn, names in pipeline.wrappers.items()}
    assert wrappers["_capture"] == {"fn"} and wrappers["_run"] == {"fn"}
    # What _capture receives: the forward's closure through _run ->
    # _graph_or_eager -> _GraphEntry, and the early exit's three stages.
    assert {"ShapeCachedForward.forward.fn", "ShapeCachedForward.metrics.fn",
            "_EarlyExitEntry.__init__.encode", "_EarlyExitEntry.__init__.segment",
            "_EarlyExitEntry.__init__.finalize"} <= _traced(pipeline)
    assert len(pipeline.blocks) == 1  # the `with torch.cuda.graph(...)` in _capture
    assert {"_AllReduceSum.forward", "_AllReduceSum.backward"} <= _traced(
        _index("parallel/multihost.py"))
    assert {"_Extend.forward", "_GatherRows.backward", "_GroupSum.forward"} <= _traced(
        _index("parallel/halo.py"))
    # Host code stays out of it.
    assert "ShapeCachedForward._get" not in _traced(pipeline)


def test_an_inserted_item_in_a_real_kernel_forward_is_flagged(tmp_path):
    rel = "raft_ncup_tpu_torch/ops/corr_cuda.py"
    src = open(os.path.join(REPO, rel), encoding="utf-8").read()
    tree = ast.parse(src)
    fwd = next(n for c in ast.walk(tree) if isinstance(c, ast.ClassDef) and c.name == "_Lookup"
               for n in c.body if isinstance(n, ast.FunctionDef) and n.name == "forward")
    first = fwd.body[0]
    lines = src.splitlines(keepends=True)
    lines.insert(first.lineno - 1, " " * first.col_offset + "_probe = f1s.sum().item()\n")
    copy = tmp_path / rel
    copy.parent.mkdir(parents=True)
    allow = port_lint.DEFAULT_ALLOWLIST
    copy.write_text(src)
    assert port_lint.run_lint([str(copy)], allow, select=["JGL001"]).findings == []
    copy.write_text("".join(lines))
    [finding] = port_lint.run_lint([str(copy)], allow, select=["JGL001"]).findings
    assert (finding.line, finding.qualname) == (first.lineno, "forward")
    assert ".item()" in finding.message


# -------------------------------------------------- the shipped tree


def test_shipped_tree_lints_clean_via_module_cli():
    chips = sorted(os.path.basename(p) for p in glob.glob(os.path.join(REPO, "chip_*.py")))
    assert "chip_smoke.py" in chips
    proc = subprocess.run(
        [sys.executable, "-m", "raft_ncup_tpu_torch.analysis", "--strict-allowlist",
         "--format", "json", "raft_ncup_tpu_torch/", *chips],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    doc = json.loads(proc.stdout)
    assert doc["files_checked"] > 100 and doc["stale_allowlist_entries"] == []
    assert not [f for f in doc["findings"] if not f["suppressed"]]


def test_every_allowlist_entry_is_justified():
    entries = port_lint.load_allowlist(port_lint.DEFAULT_ALLOWLIST)
    assert entries
    for e in entries:
        assert e.rule in RULES_BY_ID and e.qual != "*", e.render()
        assert len(e.justification.split()) >= 8, e.render()
        assert os.path.exists(os.path.join(REPO, e.path_suffix)), e.render()


def test_the_lint_imports_only_the_standard_library():
    lint_dir = os.path.join(PKG, "analysis")
    files = [os.path.join(lint_dir, n) for n in
             ("__main__.py", "astutil.py", "lint.py", "project.py")]
    files += sorted(glob.glob(os.path.join(lint_dir, "rules", "*.py")))
    assert len(files) == 18
    for path in files:
        tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                assert node.level == 0, path
                names = [node.module]
            else:
                continue
            for name in names:
                if name.startswith("raft_ncup_tpu_torch."):
                    assert name.startswith("raft_ncup_tpu_torch.analysis.") and \
                        "guards" not in name, (path, name)
                else:
                    assert name.split(".")[0] in sys.stdlib_module_names, (path, name)


# ------------------------------------------------ the repairs it asked for


class _FakeGroup:
    """A follower's Lockstep with its receive replaced by a script."""

    def __init__(self, script):
        from raft_ncup_tpu_torch.parallel.lockstep import Lockstep

        self.group = Lockstep.__new__(Lockstep)
        self.group.leader, self.group.stopped, self.group.ops = False, False, {}
        self.group.receive = iter(script).__next__


def test_follow_runs_on_live_once_before_the_first_live_operation():
    calls = []
    fake = _FakeGroup([("serve", {"warmup": True, "iters": 2}, ()),
                       ("serve", {"iters": 2}, ()), ("stream", {"slots": [0]}, ()),
                       ("stop", {"rc": 3}, ())])
    handlers = {"serve": lambda h, t: calls.append(("serve", bool(h.get("warmup")))),
                "stream": lambda h, t: calls.append(("stream", False))}
    rc = fake.group.follow(handlers, on_live=lambda: calls.append("live"))
    assert rc == 3 and fake.group.stopped
    assert calls == [("serve", True), "live", ("serve", False), ("stream", False)]
    assert fake.group.ops == {"serve_warmup": 1, "serve": 1, "stream": 1}
    # Without the hook the loop runs as it did.
    fake = _FakeGroup([("serve", {}, ()), ("stop", {}, ())])
    assert fake.group.follow({"serve": lambda h, t: None}) == 0


def test_count_collective_adds_the_byte_counts_it_is_given():
    from raft_ncup_tpu_torch.parallel import multihost

    saved = dict(multihost._COUNTS)
    try:
        multihost._COUNTS.clear()
        t = torch.zeros(3, 5)
        multihost.count_collective("probe", t.numel() * t.element_size())
        multihost.count_collective("probe", 4)
        assert multihost._COUNTS["probe"] == {"count": 2, "bytes": 64}
        json.dumps(multihost._COUNTS)
    finally:
        multihost._COUNTS.clear()
        multihost._COUNTS.update(saved)


def test_named_dtype_constants_mirror_the_policy_pins():
    from raft_ncup_tpu_torch.inference import pipe_schedule, pipeline
    from raft_ncup_tpu_torch.models import raft
    from raft_ncup_tpu_torch.nn import layers
    from raft_ncup_tpu_torch.precision.policy import PRESETS

    for policy in PRESETS.values():
        assert layers.NORM_DTYPE == policy.norm
        assert pipe_schedule.OUTPUT_DTYPE == policy.output
    assert pipeline.IMAGE_DTYPE == raft.IMAGE_DTYPE == torch.float32
    img = np.arange(24, dtype=np.uint8).reshape(1, 2, 4, 3)
    staged = pipeline.stage_pinned(img, device="cpu")
    assert staged.dtype == torch.float32 and torch.equal(staged, torch.from_numpy(img).float())
    for dt, want in ((torch.bfloat16, torch.float32), (torch.float32, torch.float32),
                     (torch.float64, torch.float64)):
        assert layers._norm_input(torch.ones(2, dtype=dt)).dtype == want
