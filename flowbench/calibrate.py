"""Readings that set a cell's limits: the program's numbers and the
control's on many seeds, each seed a run of its own.

    python3 flowbench/calibrate.py --workload <name> --seeds <first> <count> [--seconds S]

For each seed it runs ``flowbench/run.py --control 1`` (the cell at its
own sizes and load, a short window; the reference one precision below
the configuration's, TF32 on for float32 with TF32 off, answers in the
program's place) and prints one JSON line: the program's numbers, the
control's, and whether the harness judged the control's run correct
(it should not). The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(ROOT, "flowbench", "run.py")


def reading(workload: str, seed: int, seconds: float) -> dict:
    """One seed's control run: ``{"program", "control", "correct"}``, or
    ``{"rc", "stderr"}`` where the run printed no result."""
    out = subprocess.run([sys.executable, RUN, "--workload", workload, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", "0", "--control", "1"],
                         cwd=ROOT, capture_output=True, text=True)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        return {"rc": out.returncode, "stderr": out.stderr[-2000:]}
    result = json.loads(lines[-1])
    return {"program": {k: c["value"] for k, c in result["program_compared"].items()},
            "control": {k: c["value"] for k, c in result["compared"].items()},
            "correct": result["correct"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs=2, required=True, metavar=("FIRST", "COUNT"))
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)
    first, count = args.seeds
    for seed in range(first, first + count):
        line = {"workload": args.workload, "seed": seed,
                **reading(args.workload, seed, args.seconds)}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
