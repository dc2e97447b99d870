"""The harness finds every configuration, mix, driver, reader and limit
that BENCHMARK.json names, and BENCHMARK.json keeps to its contract's
shapes."""

import json
import os
import re

import pytest

from flowbench import harness, run

BM = harness.load_benchmark()
HELD = sorted(f[:-5] for f in os.listdir(os.path.join(harness.HERE, "held")) if f.endswith(".json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(BM) == {"command", "paths", "run_seconds", "configs", "workloads",
                       "end_to_end", "per_layer"}
    names = [c["name"] for c in BM["configs"]] + [w["name"] for w in BM["workloads"]] \
        + [m["name"] for m in BM["end_to_end"] + BM["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BM["workloads"]]:
        assert NAME.match(n), n
    for m in BM["end_to_end"] + BM["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BM["end_to_end"])
    assert len(json.dumps(BM)) < 64 * 1024


@pytest.mark.parametrize("cfg", BM["configs"], ids=lambda c: c["name"])
def test_config_found(cfg):
    assert cfg["file"] == f"flowbench/configs/{cfg['name']}.json"
    loaded = harness.load_config(cfg["name"])
    assert loaded["reduced"] == cfg["reduced"] == []
    assert any(w["config"] == cfg["name"] for w in BM["workloads"])


@pytest.mark.parametrize("bm, w", [pytest.param(BM, w, id=w["name"]) for w in BM["workloads"]]
                         + [pytest.param(harness.with_held(BM, h), h, id=h) for h in HELD])
def test_cell_found(bm, w):
    if isinstance(w, str):  # a held cell, put back
        assert w not in [c["name"] for c in BM["workloads"]]
        w = next(c for c in bm["workloads"] if c["name"] == w)
    assert harness.load_config(w["config"])
    mix = harness.load_mix(w["traffic"])
    assert harness.load_driver(mix["driver"]).run
    assert harness.load_limits(w["name"])
    e2e = [m["name"] for m in harness.cell_metrics(bm, w["name"], "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = harness.cell_metrics(bm, w["name"], "per_layer")
    assert per
    for m in per:
        assert m["moves"] in e2e, (m["name"], m["moves"])


@pytest.mark.parametrize("m", BM["per_layer"], ids=lambda m: m["name"])
def test_reader_found(m):
    reader = harness.load_reader(m["name"])
    assert reader.read({"kind": "none"}) is None
    assert m["moves"] in [e["name"] for e in BM["end_to_end"]]


def test_every_reader_named():
    """Each reader file belongs to a metric of BENCHMARK.json or of a held
    cell."""
    files = {f[:-3] for f in os.listdir(os.path.join(harness.HERE, "metrics"))
             if f.endswith(".py")}
    held = {m["name"] for h in HELD for m in harness.with_held(BM, h)["per_layer"]}
    assert files == {m["name"] for m in BM["per_layer"]} | held


def test_unknown_names_refused():
    with pytest.raises(FileNotFoundError):
        harness.load_mix("no.such.mix")
    with pytest.raises(ValueError):
        harness.load_config("../configs/raft")



@pytest.mark.parametrize("where", ["here", "rank 2"])
def test_a_forbidden_module_stops_the_result(monkeypatch, capsys, where):
    """Rank 0 prints no result where it, or a rank that handed it its
    modules, holds one that no run may hold; a follower exits non-zero."""
    import sys
    import types

    outcome = harness.Outcome(attempted=1, failed=0, e2e={}, context={}, checks=[], device={})
    result = {"correct": True, "compared": {}}
    if where == "here":
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        assert run.finish(None, None) == 3
    else:
        outcome.context["forbidden_elsewhere"] = {"rank 2": ["raft_ncup_tpu"]}
    assert run.finish(outcome, result) == 3
    out = capsys.readouterr()
    assert out.out == "" and "no run may hold" in out.err
    monkeypatch.setattr(harness, "FORBIDDEN", ("flowbench_not_loaded",))
    assert run.finish(harness.Outcome(1, 0, {}, {}, [], {}), result) == 0
    assert '"correct": true' in capsys.readouterr().out
