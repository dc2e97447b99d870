"""The 4K mesh cell's whole path, small, on the CPU: four gloo ranks
started by the launcher (one process a rank, rank 0 prints the result),
the leader's answers held against the reference's whole-image forward.
With the exchange between the ranks left out (every halo brought as
zeros) the run comes out not correct; with ``jax`` held by a follower
rank the launch fails and prints no result."""

import json
import os
import subprocess
import sys

import pytest

from flowbench import harness

RANK = os.path.join(os.path.dirname(__file__), "mesh_rank.py")


def _launch(fault):
    extra = [] if fault is None else ["--fault", fault]
    code = ("import sys; from flowbench import launch; "
            f"sys.exit(launch.launch(4, [sys.executable, {RANK!r}, *{extra!r}], "
            "timeout_s=600))")
    return subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                          text=True, timeout=700)


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_mesh_cell_small(fault):
    out = _launch(fault)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["device"]["count"] == 4
    assert set(result["metrics"]) == {"serve_pairs_per_s", "peak_mem_gib", "setup_s"}
    assert result["correct"] is (fault is None), result["compared"]


def test_jax_on_a_follower_fails_the_launch():
    out = _launch("jax_on_follower")
    assert out.returncode == 3, out.stderr[-3000:]
    assert '"correct"' not in out.stdout
    assert "no run may hold" in out.stderr and ": jax" in out.stderr
