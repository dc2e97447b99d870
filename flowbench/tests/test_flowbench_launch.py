"""The four-card launcher's start-up and teardown, with gloo on the CPU:
one process a rank on a free port, rank 0's line last on standard
output, every rank ended when one fails or rank 0 is done, none left."""

import os
import subprocess
import sys
import time

import pytest

from flowbench import harness

WORKER = os.path.join(os.path.dirname(__file__), "launch_worker.py")


def _launch(tmp_path, *extra, timeout_s=None):
    code = ("import sys; from flowbench import launch; "
            f"sys.exit(launch.launch(4, [sys.executable, {WORKER!r}, *{list(extra)!r}], "
            f"timeout_s={timeout_s!r}))")
    env = dict(os.environ, FLOWBENCH_PIDS=str(tmp_path))
    return subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, env=env,
                          capture_output=True, text=True, timeout=240)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    with open(f"/proc/{pid}/stat") as f:
        return f.read().split(") ", 1)[1][0] != "Z"


def _none_left(tmp_path):
    pids = [int(p) for p in os.listdir(tmp_path)]
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and any(_alive(p) for p in pids):
        time.sleep(0.1)
    assert not any(_alive(p) for p in pids)
    return pids


def test_four_ranks_rank0_prints_last(tmp_path):
    out = _launch(tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "sum 6"
    assert len(_none_left(tmp_path)) == 4


@pytest.mark.parametrize("rank", [0, 2])
def test_a_failing_rank_ends_them_all(tmp_path, rank):
    out = _launch(tmp_path, "--fail", str(rank))
    assert out.returncode == 7
    assert "sum" not in out.stdout
    _none_left(tmp_path)


def test_a_hung_world_is_stopped(tmp_path):
    out = _launch(tmp_path, "--hang", "3", timeout_s=15)
    assert out.returncode == 124
    _none_left(tmp_path)
