"""The port's serve entry, ``python -m raft_ncup_tpu_torch.serve``, on the
CPU: its serving and streaming flags against the JAX CLI's, the plain and
``--stream`` branches under chaos (SIGTERM drains and exits 75 with
nothing admitted lost; a corrupt frame resets one stream), the synthetic
request schedule against JAX's, and ``--restore_ckpt``.

Drives run the small ``raft`` at 32x48 with 1-2 iterations.
"""

import argparse
import json

import numpy as np
import pytest
import torch

import raft_ncup_tpu.serving.traffic as jax_traffic_mod
import raft_ncup_tpu_torch.serving.traffic as traffic_mod
from raft_ncup_tpu import cli as jax_cli
from raft_ncup_tpu.resilience.chaos import ChaosSpec as JaxChaosSpec
from raft_ncup_tpu_torch import cli
from raft_ncup_tpu_torch import serve as serve_mod
from raft_ncup_tpu_torch.config import small_model_config
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.resilience import EXIT_PREEMPTED, ChaosSpec
from raft_ncup_tpu_torch.serving import SyntheticTraffic
from raft_ncup_tpu_torch.training import checkpoint

SMALL = ["--device", "cpu", "--small", "--size", "32", "48", "--seed", "1"]
PLAIN = SMALL + ["--num_requests", "4", "--iter_levels", "1", "--serve_batch_sizes", "1,2"]
STREAM = SMALL + ["--stream", "--n_streams", "3", "--frames_per_stream", "3",
                  "--stream_iters", "1", "--stream_batch_sizes", "1,2,4"]
# Knobs of the JAX package's configs that the port's do not have (one card,
# no dispatch throttle or asynchronous drain).
_NOT_PORTED = {"mesh", "inflight", "drain_depth"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small CPU runs launch many tiny ops, and
    with the test workers sharing the cores a parallel region per op waits
    on threads that are not scheduled."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(argv, capsys):
    rc = serve_mod.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return rc, json.loads(lines[0])


def _fields(cfg) -> dict:
    return {k: v for k, v in vars(cfg).items() if k not in _NOT_PORTED}


FLAG_SETS = [
    [],
    ["--queue_capacity", "16", "--serve_batch_sizes", "1,2", "--iter_levels", "12,6",
     "--high_water", "0.5", "--low_water", "0.1", "--recover_patience", "2",
     "--deadline_s", "1.5", "--serve_pad_bucket", "64", "--serve_cache_size", "4",
     "--serve_precision", "bf16_infer"],
    ["--stream_capacity", "8", "--stream_batch_sizes", "1,2,4", "--stream_iters", "12",
     "--stream_queue_capacity", "16", "--max_frame_gap", "2", "--idle_timeout_s", "5",
     "--carry_net", "--anomaly_max_flow", "500", "--stream_pad_bucket", "32",
     "--stream_precision", "bf16_infer"],
    ["--carry_net", "false", "--stream_precision", "f32"],
]


@pytest.mark.parametrize("argv", FLAG_SETS)
def test_serve_and_stream_flags_parse_like_jax(argv):
    ours, ref = argparse.ArgumentParser(), argparse.ArgumentParser()
    cli.add_serve_args(ours)
    cli.add_stream_args(ours)
    jax_cli.add_serve_args(ref)
    jax_cli.add_stream_args(ref)
    a, b = ours.parse_args(argv), ref.parse_args(argv)
    assert _fields(cli.serve_config_from_args(a)) == _fields(jax_cli.serve_config_from_args(b))
    assert _fields(cli.stream_config_from_args(a, (436, 1024))) == _fields(
        jax_cli.stream_config_from_args(b, (436, 1024)))
    # The entry takes them too.
    entry = serve_mod.build_parser().parse_args(argv + ["--stream", "--chaos", "sigterm@3"])
    assert cli.stream_config_from_args(entry, (436, 1024)) == cli.stream_config_from_args(
        a, (436, 1024))


@pytest.mark.parametrize("chaos", ["", "burst@1,poison@2"])
def test_request_schedule_follows_jax(monkeypatch, chaos):
    """The same frame source in both (the port's synthetic pairs are not
    JAX's): order, due times, bursts and poison are JAX's."""

    class Frames:
        def __init__(self, size_hw, length=1, seed=0, style="smooth"):
            self.size_hw, self.seed = tuple(size_hw), seed

        def sample(self, index):
            g = np.random.default_rng([self.seed, index])
            return {k: g.integers(0, 256, (*self.size_hw, 3), dtype=np.uint8)
                    for k in ("image1", "image2")}

    class TorchFrames(Frames):
        def sample(self, index):
            return {k: torch.from_numpy(v) for k, v in super().sample(index).items()}

    monkeypatch.setattr(traffic_mod, "SyntheticFlowDataset", TorchFrames)
    monkeypatch.setattr(jax_traffic_mod, "SyntheticFlowDataset", Frames)
    kw = dict(seed=3, interval_s=0.02, burst_size=3)
    ours = SyntheticTraffic((32, 48), 4, chaos=ChaosSpec.parse(chaos), **kw)
    ref = jax_traffic_mod.SyntheticTraffic((32, 48), 4, chaos=JaxChaosSpec.parse(chaos), **kw)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref, strict=True):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_plain_sigterm_drains_and_exits_75(capsys):
    rc, report = _run(PLAIN + ["--chaos", "sigterm@2"], capsys)
    assert rc == EXIT_PREEMPTED and report["interrupted"]
    assert report["serve_requests"] == 2
    assert report["completed"] == report["accepted"] == 2 and report["errors"] == 0


def test_plain_burst_and_poison(capsys):
    rc, report = _run(PLAIN + ["--chaos", "burst@0,poison@1", "--burst_size", "3"], capsys)
    assert rc == 0 and not report["interrupted"]
    assert report["serve_requests"] == 6 and report["rejected"] == 1
    assert report["completed"] == 5 and report["budget_expected_iters"] == 1.0


def test_stream_sigterm_drains_and_exits_75(capsys):
    rc, report = _run(STREAM + ["--chaos", "sigterm@5"], capsys)
    assert rc == EXIT_PREEMPTED and report["interrupted"]
    assert report["stream_frames"] == 5
    assert report["completed"] == report["accepted"] == 5 and report["errors"] == 0


def test_stream_corruptframe_resets_one_stream(capsys):
    rc, report = _run(STREAM + ["--chaos", "corruptframe@4,abandon@7"], capsys)
    assert rc == 0
    assert (report["resets"], report["errors"], report["completed"]) == (1, 0, 8)
    for key in ("stream_frames_per_sec", "stream_p50_ms", "stream_p99_ms", "shed_streams",
                "executables"):
        assert key in report
    assert report["executables"]["compiles"] == 3  # one step a batch size, at warm-up
    assert report["corr_kernel_launches"] == 0  # CPU: the plain versions


def test_later_slices_are_refused():
    with pytest.raises(ValueError, match="ROADMAP.md, queue 1 item 9"):
        serve_mod.main(SMALL + ["--mesh", "1", "2"])
    # Fleet replicas are the port's since its fleet slice: the flags parse
    # into replica mode (tests/test_torch_replica.py drives it).
    args = serve_mod.build_parser().parse_args(
        SMALL + ["--replica_socket", "s", "--replica_index", "3", "--replica_streams", "false"])
    assert (args.replica_socket, args.replica_index, args.replica_streams) == ("s", 3, False)
    # The telemetry flags are the port's since its telemetry slice.
    args = serve_mod.build_parser().parse_args(
        SMALL + ["--report", "--healthz_file", "h.json", "--telemetry_jsonl", "t.jsonl",
                 "--flight_dir", "f", "--telemetry_interval_s", "0.5",
                 "--slo_window_scale", "0.01"])
    assert (args.report, args.healthz_file, args.telemetry_jsonl, args.flight_dir,
            args.telemetry_interval_s, args.slo_window_scale) == (
        True, "h.json", "t.jsonl", "f", 0.5, 0.01)


def test_restore_ckpt_serves_the_saved_weights(tmp_path, capsys):
    model = RAFT(small_model_config("raft", corr_impl="pallas", nconv_impl="pallas"),
                 device="cpu", seed=7)
    path = checkpoint.save_reference_pth(model, str(tmp_path / "raft-small.pth"))
    pairs = serve_mod.make_pairs((32, 48), 1, seed=0)
    loaded = serve_mod.load_model(model.cfg, path, "cpu")
    report, responses = serve_mod.serve_pairs(
        loaded, cli.serve_config_from_args(serve_mod.build_parser().parse_args(
            PLAIN + ["--restore_ckpt", path])), pairs, (32, 48))
    (a, b), = pairs
    _, up = model(torch.from_numpy(a)[None], torch.from_numpy(b)[None], iters=1)
    np.testing.assert_allclose(responses[0].flow, up[0].numpy(), atol=1e-5)
    rc, entry = _run(PLAIN + ["--restore_ckpt", path], capsys)
    assert rc == 0 and entry["completed"] == 4
