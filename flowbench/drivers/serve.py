"""Serving driver: a closed loop of clients against the program's
``FlowServer`` on one card (or on the leader of a mesh of processes).

Set-up makes the weights and ``distinct_pairs`` frame pairs from the
seed on the device, builds the server with the mix's batch sizes and its
one iteration level, captures every graph the traffic uses (``warmup``)
and serves ``warm_requests`` requests. The window then runs ``clients``
threads, each submitting its next pair when its previous answer arrives,
the pairs in a cyclic order drawn from the seed, until ``seconds`` have
passed; the requests still out are waited for.

End-to-end: pairs answered ``ok`` inside the window over its length; the
peak of reserved device memory over the window (``common.reset_peak``);
set-up. The loop keeps the server saturated, so a latency tail would be
the rate again by Little's law and is not reported.

``correct``: once the window has closed and the program is freed,
``check_answers`` answers, drawn from the seed among every
``keep_every``-th request of the window, are served again by the plain
reference from the same weights and frames; the widest gap, max |flow -
reference| over max |reference|, is held to the cell's ``flow_gap``
limit. With the mix's ``control`` the reference in TF32 answers the same
requests in the program's place and its gaps are the ones held to the
limit (the run should come out not correct); the program's own are kept
beside them.
"""

from __future__ import annotations

import random
import threading
import time

import numpy as np
import torch

from flowbench import harness, work
from flowbench import trace as tracing
from flowbench.drivers import common
from flowbench.reference import model as ref
from flowbench.traffic import make_pairs, order
from flowbench.weights import make_weights, sub_seed

class ClosedLoop:
    """``clients`` threads submitting pairs in ``pair_order`` one after
    another, each waiting for its answer; keeps the flow of every request
    index in ``keep``."""

    def __init__(self, server, frames1, frames2, pair_order, clients: int, keep=()):
        self.server, self.f1, self.f2 = server, frames1, frames2
        self.order = pair_order
        self.clients = clients
        self.keep = keep
        self.kept: dict = {}
        self._next = 0
        self._lock = threading.Lock()

    def _take(self, until: float, count: int):
        with self._lock:
            k = self._next
            if k >= count or time.monotonic() >= until:
                return None
            self._next += 1
            return k

    def _client(self, until: float, count: int, log: list) -> None:
        while True:
            k = self._take(until, count)
            if k is None:
                return
            pair = self.order[k % len(self.order)]
            with tracing.label("flowbench.request"):
                t0 = time.monotonic()
                resp = self.server.submit(self.f1[pair], self.f2[pair]).result()
                t1 = time.monotonic()
            ok = resp.status == "ok"
            if ok and k in self.keep:
                self.kept[k] = np.array(resp.flow, copy=True)
            log.append((k, pair, t0, t1, ok))

    def run(self, seconds: float = float("inf"), count: int = 1 << 62) -> list:
        """Serve until ``seconds`` have passed or ``count`` requests were
        taken; returns this round's ``(k, pair, t_submit, t_done, ok)``
        records once every answer is in."""
        until = time.monotonic() + seconds
        logs = [[] for _ in range(self.clients)]
        threads = [threading.Thread(target=self._client, args=(until, self._next + count, log),
                                    name=f"flowbench-client-{i}", daemon=True)
                   for i, log in enumerate(logs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return sorted(r for log in logs for r in log)


def build_server(cell, model, tel, mesh_cfg=None):
    from raft_ncup_tpu_torch.config import ServeConfig
    from raft_ncup_tpu_torch.serving.server import FlowServer

    mix = cell.mix
    scfg = ServeConfig(batch_sizes=tuple(mix["batch_sizes"]),
                       iter_levels=tuple(mix["iter_levels"]),
                       queue_capacity=int(mix["queue_capacity"]), mesh=mesh_cfg)
    return FlowServer(model, scfg, telemetry=tel)


def window_stats(records: list, t0: float, seconds: float) -> dict:
    t_end = t0 + seconds
    answered = sum(1 for r in records if r[4] and r[3] <= t_end)
    return {"serve_pairs_per_s": answered / seconds,
            "attempted": len(records), "failed": sum(1 for r in records if not r[4])}


def sample_checks(cell, loop: ClosedLoop, window: list) -> list:
    """``[(k, pair)]`` drawn from the seed among the window's kept answers."""
    kept = [(k, pair) for k, pair, _, _, ok in window if ok and k in loop.kept]
    rng = random.Random(sub_seed(cell.seed, 5))
    return sorted(rng.sample(kept, min(len(kept), int(cell.mix["check_answers"]))))


def reference_gaps(cell, weights, frames1, frames2, answers: list, device,
                   coords_log=None, tf32=False) -> list:
    """Per answer ``(k, pair, flow)``, the gap of ``flow`` to the
    reference's answer. With ``tf32`` the reference in TF32 stands in the
    program's place (the control): its gap to the float32 reference."""
    gaps = []
    cfg, mix = cell.config, cell.mix
    divisor = 8 * int(mix.get("mesh", [1, 1])[1])
    for k, pair, flow in answers:
        i1 = torch.from_numpy(frames1[pair][None]).to(device)
        i2 = torch.from_numpy(frames2[pair][None]).to(device)
        with torch.no_grad():
            with common.reference_precision(False):
                want = ref.serve(weights, cfg, i1, i2, mix["iter_levels"][0],
                                 mix.get("lookup", "volume"), divisor, on_coords=coords_log)
            if tf32:
                with common.reference_precision(True):
                    flow = ref.serve(weights, cfg, i1, i2, mix["iter_levels"][0],
                                     mix.get("lookup", "volume"), divisor)[0]
        got = torch.as_tensor(flow, device=device)
        gaps.append(common.rel_gap(got, want[0]))
        coords_log = None  # the lookup's work is read from the first answer
    return gaps


def lookup_row_work(cfg, coords: list, spatial: int = 1) -> tuple:
    """(bytes, operations) of kernel A for one row of one iteration,
    averaged over the reference's iterations; over a spatial axis, rank
    0's: its band of the queries against the whole pyramid."""
    tot = [0, 0]
    for c in coords:
        band = c[:, :c.shape[1] // spatial]
        b, o = work.lookup_work_from(band, cfg["corr_levels"], cfg["corr_radius"],
                                     cfg["fnet_dim"], grid_hw=tuple(c.shape[1:3]))
        tot[0] += b / c.shape[0]
        tot[1] += o / c.shape[0]
    return tot[0] / len(coords), tot[1] / len(coords)


def run(cell) -> harness.Outcome:
    from raft_ncup_tpu_torch.observability import Telemetry

    device = common.device_of(cell)
    mix, cfg = cell.mix, cell.config
    hw = tuple(mix["frame_hw"])
    weights = make_weights(ref.param_spec(cfg), cell.seed, device)
    model = common.port_model(cfg, weights, device)
    pairs = make_pairs(cell.seed, int(mix["distinct_pairs"]), hw, device)
    frames1, frames2 = pairs["image1"].cpu().numpy(), pairs["image2"].cpu().numpy()
    del pairs
    keep_every = int(mix["keep_every"])
    offset = sub_seed(cell.seed, 4) % keep_every
    tel = Telemetry(span_capacity=1 << 17)
    server = build_server(cell, model, tel)
    pair_order = order(cell.seed, int(mix["distinct_pairs"]), int(mix["distinct_pairs"]))
    try:
        server.warmup(hw)
        loop = ClosedLoop(server, frames1, frames2, pair_order, int(mix["clients"]))
        loop.run(count=int(mix["warm_requests"]))
        loop.keep = _KeepEvery(keep_every, offset)
        setup_s = time.monotonic() - cell.started_s
        common.reset_peak(device)
        with tracing.Trace(cell.trace) as tr:
            t0 = time.monotonic()
            window = loop.run(seconds=cell.seconds)
        t_drained = time.monotonic()
    finally:
        server.drain()
    peak = common.peak_bytes(device)
    stats = window_stats(window, t0, cell.seconds)
    checks = sample_checks(cell, loop, window)
    answers = [(k, pair, loop.kept[k]) for k, pair in checks]
    records = tel.tracer.records()
    del server, model, loop
    common.free(device)
    coords: list = []
    gaps = reference_gaps(cell, weights, frames1, frames2, answers, device,
                          coords_log=coords.append if cell.trace else None)
    context = {"kind": "serve", "config": cfg, "mix": mix, "t0": t0, "t1": t_drained,
               "spans": [r for r in records if t0 <= r.get("t_s", -1.0) <= t_drained],
               "window": window, "trace": tr, "device": device}
    if cell.trace and coords:
        context["lookup_row_work"] = lookup_row_work(cfg, coords)
    e2e = {"serve_pairs_per_s": stats["serve_pairs_per_s"],
           "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    checks_out, program = flow_checks(cell, weights, frames1, frames2, answers, gaps, device)
    info = common.device_info(device, int(cell.workload["chips"]), peak)
    if cell.trace:
        info["busy_s"] = tracing.busy_s(tr.ops)
        info["window_s"] = tr.window_s
    return harness.Outcome(attempted=stats["attempted"], failed=stats["failed"], e2e=e2e,
                           context=context, checks=checks_out, device=info,
                           breakdown=tracing.breakdown(tr.ops, tr.host) if cell.trace else None,
                           program_checks=program)


def flow_checks(cell, weights, frames1, frames2, answers: list, gaps: list, device) -> tuple:
    """``(checks, program_checks)``: the program's gaps held to the cell's
    limits; in a control run the TF32 reference's gaps on the same
    requests, with the program's kept as ``program_checks``."""

    def held(g):
        return [("flow_gap", max(g) if g else None, cell.limits["flow_gap"]),
                ("answers_unchecked", int(cell.mix["check_answers"]) - len(g), 0)]

    if not cell.mix.get("control"):
        return held(gaps), None
    return held(reference_gaps(cell, weights, frames1, frames2, answers, device,
                               tf32=True)), held(gaps)


class _KeepEvery:
    """The request indices ``k`` with ``k % every == offset``."""

    def __init__(self, every: int, offset: int):
        self.every, self.offset = every, offset

    def __contains__(self, k: int) -> bool:
        return k % self.every == self.offset
