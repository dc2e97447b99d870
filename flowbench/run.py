"""Run one cell of the benchmark and print its result line.

    python3 flowbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell, its configuration, traffic mix
and metrics are found by name from ``BENCHMARK.json``
(``flowbench/harness.py``). Without CUDA, or with fewer cards than the
cell asks for, it exits with code 2 and prints no result. A cell over
several cards starts one process per card (``flowbench/launch.py``);
rank 0 prints the result. The last line of standard output is the
result's JSON; the numbers that decide ``correct`` are the last lines of
standard error. A process, on any rank, that holds ``jax``, ``jaxlib``,
``flax`` or the JAX package once the window has closed exits with code 3
and no result is printed.

``--control 1`` runs the cell with its control, the reference one
precision below the configuration's, in the program's place: the result
is the control's and should read not correct, with the program's own
numbers of the same run under ``program_compared``
(``flowbench/calibrate.py`` reads it seed by seed; the benchmark's own
runs never set it).
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from flowbench import harness  # noqa: E402

STARTED_S = harness.process_start_s()


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # Set by the launcher on the processes it starts.
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="put the control in the program's place (calibration only)")
    return ap.parse_args(argv)


def finish(outcome, result) -> int:
    """The exit code of a rank whose run has ended, after the look for
    forbidden modules in this process and, on rank 0, in the other ranks
    (``outcome.context["forbidden_elsewhere"]``); rank 0 prints the result
    only where none holds one. A follower (``result`` None) prints nothing."""
    held = {}
    found = harness.forbidden_modules()
    if found:
        held[f"process {os.getpid()}"] = found
    if outcome is not None:
        held.update(outcome.context.get("forbidden_elsewhere", {}))
    if held:
        print("the run loaded modules no run may hold: "
              + "; ".join(f"{who}: {', '.join(names)}" for who, names in held.items()),
              file=sys.stderr)
        return 3
    if result is not None:
        harness.emit(result)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    harness.scrub_environment()
    bm = harness.load_benchmark()
    entry = next((w for w in bm["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload named {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell {args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if chips > 1 and args.rank is None:
        from flowbench import launch

        return launch.launch(chips, [sys.executable, os.path.abspath(__file__), *sys.argv[1:]])
    # A rank's set-up counts from the launcher's start.
    started = STARTED_S if args.rank is None else harness.process_start_s(os.getppid())
    outcome, result = harness.run_cell(args.workload, args.seed, args.seconds,
                                       bool(args.trace), started_s=started,
                                       overrides={"control": True} if args.control else None)
    return finish(outcome, result)


if __name__ == "__main__":
    sys.exit(main())
