"""Serving driver over a mesh of processes, one per card: the program's
``FlowServer`` built with the mix's ``mesh`` (``(1, S, 1)``: each frame's
rows split over S cards, halos exchanged, the dispatches broadcast by
the leader), started by ``flowbench/launch.py``.

Every rank makes the same weights from the seed and builds the server;
rank 0, the leader, makes the frames, captures the traffic's entries,
runs the closed loop of ``drivers/serve.py`` and drains, which stops the
followers. Then every rank takes part in one reduction of its window's
peak of reserved memory (the largest is reported) and of its busy share
of its traced span; rank 0 counts its halo exchanges over the window.
Last, every rank hands rank 0 the forbidden modules it holds
(``harness.forbidden_modules``), which ``flowbench/run.py`` reads before
it prints anything. Rank 0 checks its answers against the reference's
whole-image forward (the windowed lookup: the all-pairs volume of a 4K
pair does not fit) and returns the outcome; the followers return None.
"""

from __future__ import annotations

import os
import time

import torch

from flowbench import harness
from flowbench import trace as tracing
from flowbench.drivers import common, serve
from flowbench.reference import model as ref
from flowbench.traffic import make_pairs, order
from flowbench.weights import make_weights, sub_seed


def _join(cell) -> torch.device:
    from raft_ncup_tpu_torch.parallel import multihost

    rank = int(os.environ["RANK"])
    if cell.device == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    multihost.initialize_distributed(device=device)
    return device


def _counts() -> dict:
    from raft_ncup_tpu_torch.parallel.lockstep import lockstep_stats
    from raft_ncup_tpu_torch.parallel.mesh import collective_stats

    out = {op: int(c["count"]) for op, c in collective_stats()["by_op"].items()}
    out["lockstep-broadcast"] = int(lockstep_stats()["broadcasts"])
    return out


def run(cell):
    import torch.distributed as dist

    from raft_ncup_tpu_torch.observability import Telemetry
    from raft_ncup_tpu_torch.parallel import multihost

    device = _join(cell)
    rank = multihost.process_index()
    mix, cfg = cell.mix, cell.config
    hw = tuple(mix["frame_hw"])
    weights = make_weights(ref.param_spec(cfg), cell.seed, device)
    model = common.port_model(cfg, weights, device)
    tel = Telemetry(span_capacity=1 << 16)
    server = serve.build_server(cell, model, tel, mesh_cfg=tuple(mix["mesh"]))
    if rank != 0:
        # The follower's peak and trace from the leader's first dispatch
        # past the captures (the group's ``on_live``) to the group's stop.
        tr = tracing.Trace(cell.trace)

        def live():
            common.reset_peak(device)
            tr.__enter__()

        server._group.follow(server.lockstep_handlers(), on_live=live)
        tr.__exit__(None, None, None)
        server.drain()
        _reduce(dist, common.peak_bytes(device), _busy_share(tr), device)
        del server, model
        common.free(device)
        _gather_forbidden(dist)
        multihost.shutdown()
        return None
    pairs = make_pairs(cell.seed, int(mix["distinct_pairs"]), hw, device)
    frames1, frames2 = pairs["image1"].cpu().numpy(), pairs["image2"].cpu().numpy()
    del pairs
    keep = serve._KeepEvery(int(mix["keep_every"]),
                            sub_seed(cell.seed, 4) % int(mix["keep_every"]))
    pair_order = order(cell.seed, int(mix["distinct_pairs"]), int(mix["distinct_pairs"]))
    try:
        server.warmup(hw)
        loop = serve.ClosedLoop(server, frames1, frames2, pair_order, int(mix["clients"]))
        loop.run(count=int(mix["warm_requests"]))
        loop.keep = keep
        before = _counts()
        setup_s = time.monotonic() - cell.started_s
        common.reset_peak(device)
        with tracing.Trace(cell.trace) as tr:
            t0 = time.monotonic()
            window = loop.run(seconds=cell.seconds)
        t_drained = time.monotonic()
        after = _counts()
    finally:
        server.drain()
    peak, shares = _reduce(dist, common.peak_bytes(device), _busy_share(tr), device)
    stats = serve.window_stats(window, t0, cell.seconds)
    checks = serve.sample_checks(cell, loop, window)
    answers = [(k, pair, loop.kept[k]) for k, pair in checks]
    records = tel.tracer.records()
    del server, model, loop
    common.free(device)
    held = _gather_forbidden(dist)
    coords: list = []
    gaps = serve.reference_gaps(cell, weights, frames1, frames2, answers, device,
                                coords_log=coords.append if cell.trace else None)
    context = {"kind": "serve", "config": cfg, "mix": mix, "t0": t0, "t1": t_drained,
               "spans": [r for r in records if t0 <= r.get("t_s", -1.0) <= t_drained],
               "window": window, "trace": tr, "device": device,
               "collectives": {k: after[k] - before.get(k, 0) for k in after},
               "forbidden_elsewhere": {f"rank {r}": names for r, names in enumerate(held)
                                       if r != rank and names}}
    if cell.trace and coords:
        context["lookup_row_work"] = serve.lookup_row_work(cfg, coords, int(mix["mesh"][1]))
    dist_world = multihost.process_count()
    context["busy_share_mean"] = shares / dist_world
    multihost.shutdown()
    e2e = {"serve_pairs_per_s": stats["serve_pairs_per_s"],
           "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    checks_out, program = serve.flow_checks(cell, weights, frames1, frames2, answers, gaps,
                                            device)
    info = common.device_info(device, int(cell.workload["chips"]), peak)
    if cell.trace:
        # Each rank's busy share of its own traced span, averaged over the
        # cards, on rank 0's window.
        info["busy_s"] = shares / dist_world * tr.window_s
        info["window_s"] = tr.window_s
    return harness.Outcome(attempted=stats["attempted"], failed=stats["failed"], e2e=e2e,
                           context=context, checks=checks_out, device=info,
                           breakdown=tracing.breakdown(tr.ops, tr.host) if cell.trace else None,
                           program_checks=program)


def _busy_share(tr) -> float:
    return tracing.busy_s(tr.ops) / tr.window_s if tr.window_s else 0.0


def _reduce(dist, peak: int, share: float, device) -> tuple:
    """(the largest window peak over the ranks, the sum of their busy
    shares)."""
    t = torch.tensor([float(peak)], device=device, dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    u = torch.tensor([share], device=device, dtype=torch.float64)
    dist.all_reduce(u)
    return int(t.item()), float(u.item())


def _gather_forbidden(dist) -> list:
    """Every rank's forbidden modules, by rank: the ranks' last exchange,
    once each has closed its window and freed the program."""
    held: list = [None] * dist.get_world_size()
    dist.all_gather_object(held, harness.forbidden_modules())
    return held
