"""The benchmark's harness: it finds a cell's configuration, traffic mix
and per-layer readers by name, runs the mix's driver, reads the metrics
and prints one result line.

Everything that belongs to one configuration, one mix or one metric is
a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``flowbench/configs/<config>.json``: the model's sizes and flags;
- ``flowbench/mixes/<traffic>.json``: the traffic's parameters, among
  them ``driver``, the name of the general driver that reads them
  (``flowbench/drivers/<driver>.py``);
- ``flowbench/metrics/<metric>.py``: a reader, ``read(ctx)`` -> a number
  or None when it finds nothing to read;
- ``flowbench/limits/<workload>.json``: the limits of the numbers that
  decide ``correct``;
- ``flowbench/held/<workload>.json``: a cell kept out of
  ``BENCHMARK.json`` (its entry, its own per-layer metrics and the names
  of the metrics that would list it), which :func:`with_held` puts back.

A driver's ``run(cell)`` returns a :class:`Outcome`. Nothing here
imports the program; the drivers do, and the reference under
``flowbench/reference`` imports none of it.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import re
import statistics
import sys
import time
from typing import Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "flowbench")
# Top-level modules no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "raft_ncup_tpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def process_start_s(pid=None) -> float:
    """The start of this process (or of process ``pid``) on
    ``time.monotonic``'s clock (Linux: its start time in ``/proc`` against
    the boot clock); the import of this module where that cannot be read."""
    try:
        with open(f"/proc/{pid or 'self'}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        started = ticks / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - (time.clock_gettime(time.CLOCK_BOOTTIME) - started)
    except (OSError, ValueError, IndexError, AttributeError):
        return _IMPORTED


_IMPORTED = time.monotonic()


def scrub_environment() -> None:
    """The program's knobs are the harness's to set: drop every
    ``RAFT_TORCH_*`` and ``RAFT_NCUP_*`` variable (early exit, its
    tolerance, the flight recorder, the backend) so the environment
    cannot change the work; keep libraries that could load JAX off it."""
    for key in list(os.environ):
        if key.startswith(("RAFT_TORCH_", "RAFT_NCUP_")):
            del os.environ[key]
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _file(kind: str, name: str, ext: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = os.path.join(HERE, kind, name + ext)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return path


def load_benchmark(root: str = ROOT) -> dict:
    return _read_json(os.path.join(root, "BENCHMARK.json"))


def with_held(bm: dict, workload: str) -> dict:
    """``bm`` with the held cell ``workload`` put back: its entry, its own
    per-layer metrics, and its name in the ``workloads`` of each metric
    that would list it."""
    held = _read_json(_file("held", workload, ".json"))
    out = json.loads(json.dumps(bm))
    out["workloads"].append(held["workload"])
    out["per_layer"].extend(held["per_layer"])
    for m in out["end_to_end"] + out["per_layer"]:
        if m["name"] in held["listed_in"]:
            m["workloads"].append(workload)
    return out


def load_config(name: str) -> dict:
    return _read_json(_file("configs", name, ".json"))


def load_mix(name: str) -> dict:
    return _read_json(_file("mixes", name, ".json"))


def load_limits(workload: str) -> dict:
    return _read_json(_file("limits", workload, ".json"))


def load_driver(name: str):
    if not NAME.match(name):
        raise ValueError(f"not a driver name: {name!r}")
    return importlib.import_module(f"flowbench.drivers.{name}")


def load_reader(metric: str):
    """The reader module of a per-layer metric (its file name is the
    metric's name, dots and all)."""
    path = _file("metrics", metric, ".py")
    spec = importlib.util.spec_from_file_location(f"flowbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bm: dict, workload: str, section: str) -> list:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    the cell ``workload`` reports: those that list it, and those without
    a ``workloads`` list."""
    return [m for m in bm[section] if workload in m.get("workloads", [workload])]


@dataclasses.dataclass
class Cell:
    """What a driver needs: the workload entry, its configuration, mix
    and limits, the run's arguments, and where it runs."""

    workload: dict
    config: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    started_s: float = 0.0


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the end-to-end numbers, the per-layer
    context its readers read, the numbers compared with their limits
    (``[(name, value, limit)]``, ``value <= limit`` passes) and the
    device's description. In a control run (the mix's ``control``) the
    checks are the control's, which stands in the program's place, and
    ``program_checks`` the program's own numbers of the same run."""

    attempted: int
    failed: int
    e2e: dict
    context: dict
    checks: list
    device: dict
    breakdown: Optional[dict] = None
    program_checks: Optional[list] = None

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(
            v is not None and v == v and v <= lim for _, v, lim in self.checks)


def median(values) -> Optional[float]:
    vals = list(values)
    return statistics.median(vals) if vals else None


def forbidden_modules() -> list:
    """Top-level names of loaded modules that no run may hold, compared
    whole (``raft_ncup_tpu_torch`` is not ``raft_ncup_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", root: str = ROOT, overrides: Optional[dict] = None,
             started_s: Optional[float] = None, bm: Optional[dict] = None) -> tuple:
    """Run one cell; returns ``(outcome, result)``, the result the dict
    that :func:`emit` prints. ``overrides`` replaces mix keys (the tests'
    small sizes); ``bm`` stands in for ``BENCHMARK.json`` (a held cell's)."""
    bm = load_benchmark(root) if bm is None else bm
    entry = next((w for w in bm["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")
    mix = load_mix(entry["traffic"])
    mix.update(overrides or {})
    cell = Cell(workload=entry, config=load_config(entry["config"]), mix=mix,
                limits=load_limits(workload), seed=int(seed), seconds=float(seconds),
                trace=bool(trace), device=device,
                started_s=process_start_s() if started_s is None else started_s)
    outcome = load_driver(mix["driver"]).run(cell)
    if outcome is None:  # a follower rank of a cell over several processes
        return None, None
    return outcome, result_of(bm, workload, outcome, trace)


def result_of(bm: dict, workload: str, outcome: Outcome, trace: bool) -> dict:
    """The result line: the end-to-end metrics without tracing, the
    per-layer ones (each reader's, where it found something) with it."""
    metrics = {}
    if not trace:
        for m in cell_metrics(bm, workload, "end_to_end"):
            metrics[m["name"]] = {"value": outcome.e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in cell_metrics(bm, workload, "per_layer"):
            value = load_reader(m["name"]).read(outcome.context)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": outcome.correct, "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics, "device": outcome.device}
    if trace and outcome.breakdown is not None:
        result["breakdown"] = outcome.breakdown
    if outcome.program_checks is not None:
        result["program_compared"] = {name: {"value": v, "limit": lim}
                                      for name, v, lim in outcome.program_checks}
    result["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in outcome.checks}
    return result


def emit(result: dict) -> None:
    """Each compared number beside its limit as the last lines on standard
    error, then the result as the last line on standard output."""
    for name, c in result["compared"].items():
        print(f"compared {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
