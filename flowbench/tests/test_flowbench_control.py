"""The control on the card: the reference one precision below the
configuration's (TF32 on, for float32 with TF32 off) put in the
program's place, at each cell's own mix and load (a short window),
through the harness's own comparison: the run comes out not correct,
because the control fails a limit that the program's numbers of the same
run pass. Run on the card with

    python3 -m pytest -q -m chip flowbench/tests/test_flowbench_control.py
"""

import pytest
import torch

from flowbench import calibrate, harness

BM = harness.load_benchmark()
SEEDS = [2 ** 33 + 1, 2 ** 33 + 2, 2 ** 33 + 3]


@pytest.mark.chip
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("w", BM["workloads"], ids=lambda w: w["name"])
def test_control_reads_not_correct(w, seed):
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < w["chips"]:
        pytest.skip(f"needs {w['chips']} CUDA card(s), found {cards}")
    got = calibrate.reading(w["name"], seed, 6.0)
    assert "correct" in got, got
    limits = harness.load_limits(w["name"])
    assert all(got["program"][k] <= lim for k, lim in limits.items()), got
    assert got["control"].get("answers_unchecked", 0) == 0, got
    assert any(got["control"][k] > lim for k, lim in limits.items()), got
    assert got["correct"] is False, got
