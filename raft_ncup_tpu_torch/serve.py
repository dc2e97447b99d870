"""Serve a RAFT model: ``python -m raft_ncup_tpu_torch.serve``.

Port of the root ``serve.py``'s plain branch and its ``--stream`` branch.
The plain branch builds the model, wraps it in a :class:`FlowServer`,
warms it up, replays ``--num_requests`` synthetic requests at
``--interval_ms`` (``serving.SyntheticTraffic``), drains, and prints one
JSON report line. ``--stream`` stands up a
:class:`raft_ncup_tpu_torch.streaming.StreamEngine` instead, captures its
step per batch size, and replays ``--n_streams`` concurrent streams of
``--frames_per_stream`` frames (``streaming.StreamTraffic``).

The model comes from the JAX CLI's model flags. ``--model`` defaults to
``raft``, as in the JAX CLI; the flagship is ``--model raft_nc_dbl``
(NCUP). Both hand-written kernels run (``corr_impl="pallas"``,
``nconv_impl="pallas"``). The weights come from ``--restore_ckpt`` (a
port ``step_<N>.pt`` or run directory, or a reference ``.pth``) or are
drawn from ``--seed``. ``--precision`` (or ``--mixed_precision``) sets the
model's preset; ``--serve_precision`` and ``--stream_precision`` run the
server's or the engine's forwards under another preset with the same
weights. Early exit is on when ``RAFT_TORCH_EARLYEXIT=1`` (tolerance
``RAFT_TORCH_EARLYEXIT_TOL``, default 0.05).

Chaos (``--chaos``, comma-joined): ``burst@N``, ``poison@N`` and
``sigterm@N`` for the server; ``corruptframe@N``, ``abandon@N``,
``burst@N`` and ``sigterm@N`` with ``--stream``. SIGTERM or SIGINT stops
the submissions, everything admitted is answered, and the process exits
75 (``EXIT_PREEMPTED``); otherwise it exits 0, or 1 when a request got an
``error``.

Every forward runs through per-shape CUDA graphs
(``inference/pipeline.ShapeCachedForward``), captured at warm-up; the
report carries the cache's ``executables`` (captures, hits, evictions),
the graphs' pool bytes and the kernels' launches after warm-up.

Telemetry (``observability/``), as the root entry wires it: each run gets
a hub and a cost ledger of its own (``run`` is re-entrant in one process,
as the root entry's process is one run), disabled by
``RAFT_TORCH_TELEMETRY=0``. The declared SLOs (``serve_slos``, or
``stream_slos`` with ``--stream``; windows scaled by
``--slo_window_scale``) are evaluated every ``--telemetry_interval_s``, and
then ``--telemetry_jsonl`` gets a snapshot and ``--healthz_file`` is
rewritten atomically; fault triggers (poison quarantine, anomaly reset,
the SIGTERM drain, an SLO page) bank flight dumps in ``--flight_dir``
(default ``flight_recorder``, or ``RAFT_TORCH_FLIGHT_DIR``; '' disables).
The report always carries ``slo``; ``--report`` adds ``telemetry`` (the
registry, stage p50/p99, health) and ``cost_ledger`` (each captured key's
FLOPs, capture ms and pool bytes). The files keep the JAX package's
formats, so its ``scripts/trace_report.py`` and ``scripts/postmortem.py``
read them.

``--replica_socket ADDR`` runs one fleet replica (the root entry's
replica mode; ``fleet/``): the server and, unless ``--replica_streams
false``, a stream engine warm up, the healthz file advertises the replica's
identity (``replica``, ``mesh``, ``warmed``, ``stream_warmed``, pid), and
the process answers the wire's ``ping``, ``set_telemetry``, ``request`` and
``frame`` messages on ``ADDR`` (a Unix-domain-socket path or
``host:port``) under the runtime guards, until SIGTERM: then healthz reads
DRAINING before the flush, both tiers drain, and it exits 75 after
printing one JSON report. ``fleet.ReplicaSupervisor`` spawns exactly this.

``--mesh D,S`` serves over a mesh of D x S processes, one per card,
started by the launcher (``torchrun --nproc_per_node D*S -m
raft_ncup_tpu_torch.serve --mesh D,S ...``; two ranks sharing one card
need ``RAFT_TORCH_DIST_BACKEND=gloo``): each batch's rows split over the
D data indices and each image's rows over the S ranks of a data index, as
JAX's ``P("data", "spatial")``. Rank 0, the leader, runs the entry as
above (traffic, replica socket, healthz, telemetry, the report line) and
broadcasts every dispatch to the followers (``parallel/lockstep.py``),
which run the same cached entries and print one summary line on standard
error, not standard output. A signal to the leader drains it, then stops
the followers, and every rank exits 75; the followers ignore signals of
their own.

It runs on the card unless ``--device cpu`` is given; with no CUDA and
no ``--device`` it raises.

Examples::

    python -m raft_ncup_tpu_torch.serve --device cpu --size 32 48 --num_requests 4 \\
        --iter_levels 2,1 --serve_batch_sizes 1,2 --small
    python -m raft_ncup_tpu_torch.serve --model raft_nc_dbl --size 436 1024 --stream \\
        --n_streams 4 --frames_per_stream 8 --stream_iters 12 --chaos corruptframe@4
    python -m raft_ncup_tpu_torch.serve --device cpu --small --size 48 64 \\
        --replica_socket /tmp/r0.sock --healthz_file /tmp/r0.healthz.json
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from raft_ncup_tpu_torch.analysis.guards import (
    GuardStats,
    RecompileWatchdog,
    forbid_host_transfers,
)
from raft_ncup_tpu_torch.cli import (
    add_model_args,
    add_serve_args,
    add_stream_args,
    check_mesh,
    model_config_from_args,
    serve_config_from_args,
    str2bool,
    str2mesh,
    stream_config_from_args,
)
from raft_ncup_tpu_torch.evaluate import load_model
from raft_ncup_tpu_torch.fleet.wire import Transport, recv_msg, send_msg
from raft_ncup_tpu_torch.inference.costs import CostLedger, set_cost_ledger
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.observability import (
    FlightRecorder,
    JsonlSink,
    PeriodicSnapshot,
    SloEngine,
    Telemetry,
    TraceContext,
    get_telemetry,
    serve_slos,
    set_telemetry,
    stream_slos,
    telemetry_report,
    write_healthz,
)
from raft_ncup_tpu_torch.observability.export import TELEMETRY_ENV
from raft_ncup_tpu_torch.observability.flight import FLIGHT_ENV
from raft_ncup_tpu_torch.ops.corr_cuda import lookup_levels
from raft_ncup_tpu_torch.ops.nconv_cuda import nconv2d_fused
from raft_ncup_tpu_torch.parallel import mesh as mesh_mod
from raft_ncup_tpu_torch.parallel import multihost
from raft_ncup_tpu_torch.parallel.lockstep import Lockstep, lockstep_stats
from raft_ncup_tpu_torch.resilience import EXIT_PREEMPTED, ChaosSpec, PreemptionHandler
from raft_ncup_tpu_torch.serving import FlowServer, SyntheticTraffic, nearest_rank_ms, replay
from raft_ncup_tpu_torch.streaming import StreamEngine, StreamTraffic, replay_streams
from raft_ncup_tpu_torch.utils.knobs import knob_enabled, knob_raw


@contextlib.contextmanager
def _telemetry_export(args, tel: Telemetry):
    """The telemetry cadence for the run (root ``serve.py``'s): SLO
    evaluation always, a ``--telemetry_jsonl`` snapshot and a
    ``--healthz_file`` rewrite when asked. The snapshot thread's final tick
    runs before the sink closes, so the last report (the drained state)
    reaches the file."""
    with contextlib.ExitStack() as stack:
        sink = stack.enter_context(JsonlSink(args.telemetry_jsonl)) \
            if args.telemetry_jsonl else None
        stack.enter_context(PeriodicSnapshot(tel, sink, args.telemetry_interval_s,
                                             healthz_path=args.healthz_file))
        yield


def _attach_observability(args, tel: Telemetry, *, stream: bool) -> None:
    """Arm the hub's consumer half: the declared SLO set (serve or stream)
    and the flight recorder in ``--flight_dir`` ('' disables it)."""
    if args.flight_dir:
        tel.flight = FlightRecorder(args.flight_dir)
    specs = (stream_slos(args.stream_capacity, window_scale=args.slo_window_scale)
             if stream else serve_slos(window_scale=args.slo_window_scale))
    tel.slo = SloEngine(specs, tel)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--restore_ckpt", default=None,
                   help="a port step_<N>.pt or run directory, or a reference .pth "
                   "(default: weights drawn from --seed)")
    p.add_argument("--num_requests", type=int, default=32)
    p.add_argument("--interval_ms", type=float, default=0.0,
                   help="steady gap between arrivals (0: as fast as the submitter goes)")
    p.add_argument("--size", type=int, nargs=2, default=[96, 128],
                   metavar=("H", "W"), help="request frame size")
    p.add_argument("--burst_size", type=int, default=8,
                   help="requests (or streams) per burst@N chaos event")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the model weights and of the synthetic traffic")
    p.add_argument("--style", default="smooth", choices=["smooth", "rigid"],
                   help="synthetic traffic content")
    p.add_argument("--chaos", default=None,
                   help="deterministic faults: burst@N, poison@N, sigterm@N (serving) or "
                   "corruptframe@N, abandon@N, burst@N, sigterm@N (--stream)")
    p.add_argument("--stream", action="store_true",
                   help="drive the streaming video engine instead of the request server")
    p.add_argument("--n_streams", type=int, default=4,
                   help="[--stream] concurrent synthetic streams")
    p.add_argument("--frames_per_stream", type=int, default=8,
                   help="[--stream] frames submitted per stream")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    p.add_argument("--report", action="store_true",
                   help="add the telemetry report (registry, stage p50/p99, health) and the "
                   "cost ledger to the printed JSON")
    p.add_argument("--telemetry_jsonl", default=None, metavar="PATH",
                   help="write periodic telemetry snapshots to this bounded JSONL file")
    p.add_argument("--telemetry_interval_s", type=float, default=5.0,
                   help="cadence of the snapshots, the healthz rewrites and the SLO "
                   "evaluation")
    p.add_argument("--healthz_file", default=None, metavar="PATH",
                   help="rewrite this JSON file atomically on the telemetry cadence with "
                   "the health states and SLO verdicts (DRAINING rides the exit-75 drain)")
    p.add_argument("--flight_dir", default=knob_raw(FLIGHT_ENV, "flight_recorder"),
                   help="flight-recorder directory: every fault trigger (poison quarantine, "
                   "anomaly reset, SIGTERM drain, SLO page) banks one atomic "
                   "flight_<trigger>_<ts>.json here ('' disables)")
    p.add_argument("--slo_window_scale", type=float, default=1.0,
                   help="scale the declared SLOs' 5 min / 1 h burn-rate windows (e.g. 0.01 "
                   "for a run of seconds)")
    p.add_argument("--replica_socket", default=None, metavar="ADDR",
                   help="fleet replica mode: answer the wire's request and frame messages "
                   "on this address (a Unix-domain-socket path or host:port) through the "
                   "server and the stream engine until SIGTERM, then drain and exit 75")
    p.add_argument("--replica_index", type=int, default=0,
                   help="[--replica_socket] this replica's index in the fleet topology")
    p.add_argument("--replica_streams", type=str2bool, nargs="?", const=True, default=True,
                   help="[--replica_socket] also run a stream engine for frame messages "
                   "(false: a request-only replica)")
    p.add_argument("--mesh", type=str2mesh, default=None, metavar="DATA,SPATIAL",
                   help="serve over a mesh of DATA x SPATIAL processes, one per card, started "
                   "by the launcher: batches split over DATA, image rows over SPATIAL")
    add_serve_args(p)
    add_stream_args(p)
    add_model_args(p)
    return p


def make_pairs(size_hw, n: int, seed: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """``n`` (H, W, 3) float32 frame pairs in [0, 255]: a random frame and
    a copy shifted by a few pixels plus noise, from one numpy generator."""
    rng = np.random.default_rng(seed)
    h, w = size_hw
    pairs = []
    for _ in range(n):
        img1 = rng.uniform(0.0, 255.0, (h, w, 3)).astype(np.float32)
        dy, dx = (int(v) for v in rng.integers(-4, 5, size=2))
        img2 = np.roll(img1, (dy, dx), axis=(0, 1))
        img2 = np.clip(img2 + rng.normal(0.0, 2.0, img2.shape), 0.0, 255.0)
        pairs.append((img1, img2.astype(np.float32)))
    return pairs


def _launches() -> tuple:
    return lookup_levels.launches, nconv2d_fused.launches


def serve_traffic(model: RAFT, cfg, traffic, size_hw, *, preempt=None,
                  sigterm_after=None, export=contextlib.nullcontext,
                  lockstep=None) -> tuple[dict, list, bool]:
    """Warm a :class:`FlowServer` up for ``size_hw``, replay ``traffic``
    (``(due_s, image1, image2)`` items), drain, and return ``(report,
    responses, interrupted)``. The report counts the kernel launches made
    while serving (after the warm-up). The server binds the process's
    telemetry hub; ``export()`` encloses the replay and the drain (the
    entry's telemetry cadence), and a drain after a signal banks a
    ``preemption_drain`` flight dump. ``lockstep`` is the leader's group
    under a mesh of processes (``cfg.mesh``)."""
    tel = get_telemetry()
    server = FlowServer(model, cfg, lockstep=lockstep)
    t0 = time.monotonic()
    warmed = server.warmup(size_hw)
    warmup_s = time.monotonic() - t0
    # The identity the healthz file advertises: the warmed set and preset.
    tel.identity.update({"mesh": mesh_mod.mesh_fingerprint(server.mesh),
                         "precision": server.policy.name,
                         "warmed": [list(x) for x in server.warmed]})
    launches0 = _launches()
    t0 = time.monotonic()
    with export():
        handles, interrupted = replay(server, traffic, preempt=preempt,
                                      sigterm_after=sigterm_after)
        stats = server.drain()
        if interrupted:
            # Banked after the flush: the dump describes the drained state.
            tel.flight_dump("preemption_drain", completed=stats.completed, shed=stats.shed)
    wall = time.monotonic() - t0
    responses = [h.result(timeout=60.0) for h in handles]
    lat = [r.latency_s for r in responses if r.ok]
    report = {
        "serve_requests": len(handles),
        "serve_ok": len(lat),
        "serve_wall_s": wall,
        "serve_pairs_per_sec": stats.completed / wall if wall > 0 else None,
        "serve_p50_ms": nearest_rank_ms(lat, 0.50),
        "serve_p99_ms": nearest_rank_ms(lat, 0.99),
        "interrupted": interrupted,
        "warmup_configs": warmed,
        "warmup_s": warmup_s,
        "accepted": stats.accepted,
        "completed": stats.completed,
        "serve_batches": stats.batches,
        "shed": stats.shed,
        "timeouts": stats.timeouts,
        "rejected": stats.rejected,
        "errors": stats.errors,
        "corr_kernel_launches": lookup_levels.launches - launches0[0],
        "nconv_kernel_launches": nconv2d_fused.launches - launches0[1],
        **server.report(),
        "slo": tel.slo.snapshot() if tel.slo is not None else None,
    }
    return report, responses, interrupted


def serve_pairs(model: RAFT, cfg, pairs, size_hw) -> tuple[dict, list]:
    """:func:`serve_traffic` of ``pairs``, all due at once: ``(report,
    responses)``."""
    report, responses, _ = serve_traffic(model, cfg, [(0.0, a, b) for a, b in pairs], size_hw)
    return report, responses


def stream_traffic(model: RAFT, cfg, traffic, *, preempt=None, sigterm_after=None,
                   export=contextlib.nullcontext,
                   lockstep=None) -> tuple[dict, list, bool, StreamEngine]:
    """Stand up a :class:`StreamEngine`, capture its steps, replay
    ``traffic`` (``(due_s, stream_id, frame_index, image1, image2)``
    items), drain, and return ``(report, responses, interrupted,
    engine)``. The report counts the kernel launches made while streaming
    (after the warm-up). Telemetry and ``lockstep`` as in
    :func:`serve_traffic`."""
    tel = get_telemetry()
    engine = StreamEngine(model, cfg, lockstep=lockstep)
    t0 = time.monotonic()
    warmed = engine.warmup()
    warmup_s = time.monotonic() - t0
    tel.identity.update({"mesh": mesh_mod.mesh_fingerprint(engine.mesh),
                         "precision": engine._policy.name,
                         "warmed": [list(x) for x in engine.warmed]})
    launches0 = _launches()
    t0 = time.monotonic()
    with export():
        handles, interrupted = replay_streams(engine, traffic, preempt=preempt,
                                              sigterm_after=sigterm_after)
        stats = engine.drain()
        if interrupted:
            tel.flight_dump("preemption_drain", completed=stats.completed,
                            shed_frames=stats.shed_frames)
    wall = time.monotonic() - t0
    responses = [h.result(timeout=60.0) for h in handles]
    lat = [r.latency_s for r in responses if r.ok and r.latency_s is not None]
    report = {
        "stream_frames": len(handles),
        "stream_ok": len(lat),
        "stream_wall_s": wall,
        "stream_frames_per_sec": stats.completed / wall if wall > 0 else None,
        "stream_p50_ms": nearest_rank_ms(lat, 0.50),
        "stream_p99_ms": nearest_rank_ms(lat, 0.99),
        "interrupted": interrupted,
        "warmup_steps": warmed,
        "warmup_s": warmup_s,
        "accepted": stats.accepted,
        "completed": stats.completed,
        "resets": stats.resets,
        "shed_streams": stats.shed_streams,
        "shed_frames": stats.shed_frames,
        "errors": stats.errors,
        "stream_batches": stats.batches,
        "corr_kernel_launches": lookup_levels.launches - launches0[0],
        "nconv_kernel_launches": nconv2d_fused.launches - launches0[1],
        **engine.report(),
        "slo": tel.slo.snapshot() if tel.slo is not None else None,
    }
    return report, responses, interrupted, engine


def run(argv=None) -> tuple[int, dict, list, RAFT]:
    """Parse ``argv`` and serve: ``(exit code, report, responses,
    model)``; :func:`main` prints the report. The run's telemetry hub and
    cost ledger are the process defaults while it runs; the previous ones
    come back after."""
    args = build_parser().parse_args(argv)
    joined = False
    if args.mesh is not None:
        # The mesh against the launcher's world, which this process joins.
        check_mesh(args.mesh[0], args.mesh[1], args.mesh[2] if len(args.mesh) > 2 else 1)
        device = multihost.local_device(args.device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        args.device = str(device)
        already = multihost.initialized()
        joined = multihost.initialize_distributed(device=device) and not already
    tel, ledger = Telemetry(enabled=knob_enabled(TELEMETRY_ENV)), CostLedger()
    prev_tel, prev_ledger = set_telemetry(tel), set_cost_ledger(ledger)
    try:
        rc, report, responses, model = _run(args, tel)
    finally:
        set_telemetry(prev_tel)
        set_cost_ledger(prev_ledger)
        if joined:
            multihost.shutdown()
    if args.report:
        report["telemetry"] = telemetry_report(tel)
        # Each captured key's cost, recorded when it was built: host
        # dicts, nothing to wait for.
        report["cost_ledger"] = ledger.snapshot()
    return rc, report, responses, model


def _run(args, tel: Telemetry) -> tuple[int, dict, list, RAFT]:
    model = load_model(model_config_from_args(args, dataset="sintel"), args.restore_ckpt,
                       args.device, args.seed)
    group = None
    if args.mesh is not None:
        mesh = mesh_mod.make_mesh(*args.mesh, device=model.device)
        if mesh.processes > 1:
            group = Lockstep(mesh, model.device)
            if not group.leader:
                return _follow(args, model, group)
    try:
        rc, report, responses, model = _lead(args, tel, model, group)
    except BaseException:
        if group is not None:
            group.stop(1)
        raise
    if group is not None:
        group.stop(rc)
        report.update(rank=0, world=multihost.process_count(),
                      collectives=mesh_mod.collective_stats(), lockstep=lockstep_stats(),
                      lockstep_ops=dict(group.ops))
    return rc, report, responses, model


def _follow(args, model: RAFT, group: Lockstep) -> tuple[int, dict, list, RAFT]:
    """A follower of the leader's lockstep group: the server (and the
    stream engine, with ``--stream`` or a replica's streams) built as the
    leader's, the leader's dispatches run until it stops the group; no
    traffic, socket, healthz or telemetry export of its own. Returns the
    leader's exit code and this rank's summary: its mesh, the operations
    it ran, its kernel launches after the warm-up and its collectives."""
    size_hw = (args.size[0], args.size[1])
    handlers: dict = {}
    tiers = []
    server = None
    if not args.stream:
        server = FlowServer(model, serve_config_from_args(args), lockstep=group)
        tiers.append(server)
    if args.stream or (args.replica_socket and args.replica_streams):
        tiers.append(StreamEngine(model, stream_config_from_args(args, size_hw),
                                  lockstep=group))
    for tier in tiers:
        handlers.update(tier.lockstep_handlers())
    live: dict = {}
    # A signal here is the leader's to act on: it drains, then stops the group.
    with PreemptionHandler():
        rc = group.follow(handlers, on_live=lambda: live.update(launches=_launches()))
    for tier in tiers:
        tier.drain()
    start = live.get("launches", _launches())
    report = {
        "follower": True, "rank": multihost.process_index(),
        "world": multihost.process_count(), "mesh": mesh_mod.mesh_fingerprint(group.mesh),
        "lockstep_ops": dict(group.ops),
        "corr_kernel_launches": lookup_levels.launches - start[0],
        "nconv_kernel_launches": nconv2d_fused.launches - start[1],
        "collectives": mesh_mod.collective_stats(), "lockstep": lockstep_stats(),
        "earlyexit": None if server is None else server.report()["earlyexit"],
        "device": str(model.device),
    }
    return rc, report, [], model


def _lead(args, tel: Telemetry, model: RAFT, group) -> tuple[int, dict, list, RAFT]:
    """The entry's own run (one process, or a mesh's leader)."""
    _attach_observability(args, tel, stream=args.stream)
    if args.replica_socket:
        return run_replica(args, tel, model, group)

    def export():
        return _telemetry_export(args, tel)

    size_hw = (args.size[0], args.size[1])
    chaos = ChaosSpec.parse(args.chaos)
    if chaos.active:
        print(f"chaos: {chaos.render()}", file=sys.stderr)
    # The schedule is made before the clock starts: the rates measure the
    # server or the engine, not the synthetic frame generator.
    with PreemptionHandler() as preempt:
        if args.stream:
            traffic = list(StreamTraffic(size_hw, args.n_streams, args.frames_per_stream,
                                         seed=args.seed, interval_s=args.interval_ms / 1000.0,
                                         burst_size=args.burst_size, chaos=chaos,
                                         style=args.style))
            report, responses, interrupted, _ = stream_traffic(
                model, stream_config_from_args(args, size_hw), traffic, preempt=preempt,
                sigterm_after=chaos.sigterm_after, export=export, lockstep=group)
        else:
            traffic = list(SyntheticTraffic(size_hw, args.num_requests, seed=args.seed,
                                            interval_s=args.interval_ms / 1000.0,
                                            burst_size=args.burst_size, chaos=chaos,
                                            style=args.style))
            report, responses, interrupted = serve_traffic(
                model, serve_config_from_args(args), traffic, size_hw, preempt=preempt,
                sigterm_after=chaos.sigterm_after, export=export, lockstep=group)
    report.update(variant=model.cfg.variant, small=model.cfg.small)
    if model.device.type == "cuda":
        report["device_name"] = torch.cuda.get_device_name(model.device)
    if interrupted:
        print("serve: drained after a signal; every admitted request was answered; "
              f"exiting {EXIT_PREEMPTED}", file=sys.stderr)
        return EXIT_PREEMPTED, report, responses, model
    return (0 if report["errors"] == 0 else 1), report, responses, model


class _Responder:
    """One replica connection's writer: each response goes out whole under
    the connection's lock, from the thread that holds the handle."""

    def __init__(self, conn, tel: Telemetry):
        self.conn, self.tel, self.lock = conn, tel, threading.Lock()

    def send(self, header: dict, arrays=()) -> None:
        try:
            with self.lock:
                send_msg(self.conn, header, arrays)
        except OSError:
            # The router hung up (it failed the request over on its side):
            # nothing to deliver to.
            self.tel.inc("replica_response_undeliverable_total")

    def respond(self, rid: int, handle, t_recv: float, trace_id) -> None:
        """Wait for one request's terminal response and send it back with
        its receive and done instants on this process's monotonic clock
        and the flow as one numpy payload (the array the drain worker
        read; nothing here reads a tensor)."""
        try:
            r = handle.result(timeout=600.0)
        except TimeoutError:
            r = None
        header = {
            "kind": "response", "id": rid,
            "status": "error" if r is None else r.status,
            "iters": None if r is None else r.iters,
            "latency_s": None if r is None else r.latency_s,
            "retry_after_s": None if r is None else r.retry_after_s,
            "detail": "replica response timeout" if r is None else r.detail,
            "t_recv_s": t_recv, "t_done_s": time.monotonic(),
        }
        if trace_id is not None:
            header["trace"] = {"trace_id": trace_id}
        self.send(header, () if r is None or r.flow is None else (r.flow,))


def _serve_conn(conn, args, tel: Telemetry, server: FlowServer, engine, pool) -> None:
    """Answer one router connection's messages until it closes: ``ping``
    (the clock handshake), ``set_telemetry``, ``request`` and ``frame``;
    anything else, or a frame on a request-only replica, is ``rejected``."""
    out = _Responder(conn, tel)
    try:
        while True:
            msg = recv_msg(conn)
            if msg is None:
                break
            t_recv = time.monotonic()
            header, arrays = msg
            kind = header.get("kind")
            if kind == "ping":
                out.send({"kind": "pong", "pid": os.getpid(), "t0": header.get("t0"),
                          "t_mono": time.monotonic()})
                continue
            if kind == "set_telemetry":
                # The hub flips in place on the warm replica; the guards and
                # the servers' own counts go on either way.
                tel.enabled = bool(header.get("enabled", True))
                out.send({"kind": "telemetry_ack", "enabled": tel.enabled,
                          "replica": args.replica_index})
                continue
            rid = int(header.get("id", -1))
            # The router's trace (an optional header field): the replica's
            # spans carry its id, and the wire hop lands as a span under it.
            ctx = TraceContext.from_wire(header.get("trace"))
            tid = None if ctx is None else ctx.trace_id
            if ctx is not None and ctx.sent_s is not None:
                tel.observe_ms(
                    "fleet_wire_hop",
                    max(0.0, (t_recv - (ctx.sent_s + ctx.clock_offset_s)) * 1e3),
                    trace_id=tid, request_id=rid, parent_span_id=ctx.span_id,
                    replica=args.replica_index)
            if kind == "request" and len(arrays) == 2:
                handle = server.submit(arrays[0], arrays[1],
                                       deadline_s=header.get("deadline_s"),
                                       request_id=rid, trace_id=tid)
            elif kind == "frame" and len(arrays) == 2 and engine is not None:
                handle = engine.submit(str(header.get("stream_id")), arrays[0], arrays[1],
                                       frame_index=header.get("frame_index"),
                                       request_id=rid, trace_id=tid)
            else:
                detail = ("request-only replica (replica_streams=false)"
                          if kind == "frame" and engine is None
                          else f"bad message kind {kind!r}")
                out.send({"kind": "response", "id": rid, "status": "rejected",
                          "detail": detail})
                continue
            pool.submit(out.respond, rid, handle, t_recv, tid)
    except (ConnectionError, OSError, ValueError) as e:
        print(f"replica connection dropped: {e!r}", file=sys.stderr)
    finally:
        try:
            conn.close()
        except OSError:
            pass


def run_replica(args, tel: Telemetry, model: RAFT, group=None) -> tuple[int, dict, list, RAFT]:
    """``--replica_socket`` mode: one fleet replica (the root entry's
    ``run_replica`` step for step). Warm up the server (and the stream
    engine), advertise the identity in healthz, then answer the router's
    messages under the runtime guards (armed after the warm-up: a capture
    or a kernel load from here on is a recompile, an implicit read of a
    tensor a host transfer) until a signal; then DRAINING goes to healthz
    before the flush, both tiers drain, every connection closes, and the
    exit code is 75. Under a mesh this is the leader, and ``group`` its
    lockstep group, shared by both tiers. Returns ``(rc, report, [],
    model)``."""
    size_hw = (args.size[0], args.size[1])
    server = FlowServer(model, serve_config_from_args(args), lockstep=group)
    engine = None
    if args.replica_streams:
        # A replica serving both tiers declares both SLO sets: one that
        # sheds every stream frame must page and read degraded in healthz.
        tel.slo = SloEngine(
            serve_slos(window_scale=args.slo_window_scale)
            + stream_slos(args.stream_capacity, window_scale=args.slo_window_scale), tel)
        engine = StreamEngine(model, stream_config_from_args(args, size_hw), lockstep=group)
    t0 = time.monotonic()
    warmed = server.warmup(size_hw) + (engine.warmup() if engine is not None else 0)
    warmup_s = time.monotonic() - t0
    # The identity healthz advertises (write_healthz adds pid, start time
    # and stale_after_s): the warmed sets are what the router routes on.
    tel.identity.update({"replica": args.replica_index,
                         "mesh": mesh_mod.mesh_fingerprint(server.mesh),
                         "precision": server.policy.name,
                         "warmed": [list(x) for x in server.warmed]})
    if engine is not None:
        tel.identity["stream_warmed"] = [list(x) for x in engine.warmed]
    print(f"replica {args.replica_index}: {warmed} graphs captured in {warmup_s:.1f} s; "
          f"serving on {args.replica_socket}", file=sys.stderr, flush=True)

    # The address decides the socket family (a UDS path or host:port).
    transport = Transport.parse(args.replica_socket)
    lsock = transport.listen(16)
    lsock.settimeout(0.1)
    pool = ThreadPoolExecutor(max_workers=32, thread_name_prefix="replica-respond")
    conns: list = []
    stats = GuardStats()
    launches0 = _launches()
    with _telemetry_export(args, tel), PreemptionHandler() as preempt, \
            RecompileWatchdog() as wd, forbid_host_transfers(stats, raise_on_violation=False):
        while not preempt.requested:
            if group is not None and group.broken is not None:
                break  # the mesh's ranks no longer agree: this replica is dead
            try:
                conn, _ = lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conns.append(conn)
            threading.Thread(target=_serve_conn, args=(conn, args, tel, server, engine, pool),
                             name="replica-conn", daemon=True).start()
        interrupted = preempt.requested
        # The drain contract: DRAINING is in healthz before the flush, so
        # the router stops routing here while admitted work completes.
        server.health.draining("sigterm")
        if engine is not None:
            engine.health.draining("sigterm")
        if args.healthz_file:
            write_healthz(args.healthz_file, tel, interval_s=args.telemetry_interval_s)
        sstats = server.drain()
        estats = engine.drain() if engine is not None else None
        if interrupted:
            tel.flight_dump("preemption_drain", replica=args.replica_index,
                            completed=sstats.completed, shed=sstats.shed)
        pool.shutdown(wait=True)  # every handle is terminal: flush the responders
        for conn in conns:  # peers get EOF from the drain, not from the exit
            try:
                conn.close()
            except OSError:
                pass
    lsock.close()
    transport.cleanup()
    report = {
        "replica": args.replica_index,
        "interrupted": interrupted,
        "recompiles": wd.count,
        "host_transfers": stats.host_transfers,
        "warmup_configs": warmed,
        "warmup_s": warmup_s,
        "accepted": sstats.accepted,
        "completed": sstats.completed,
        "serve_batches": sstats.batches,
        "shed": sstats.shed,
        "timeouts": sstats.timeouts,
        "rejected": sstats.rejected,
        "errors": sstats.errors,
        # Both tiers' launches after the warm-up (replays count what their
        # capture launched).
        "corr_kernel_launches": lookup_levels.launches - launches0[0],
        "nconv_kernel_launches": nconv2d_fused.launches - launches0[1],
        **server.report(),
        "slo": tel.slo.snapshot() if tel.slo is not None else None,
    }
    if estats is not None:
        report.update(stream_completed=estats.completed, stream_resets=estats.resets,
                      stream_shed_frames=estats.shed_frames, stream_errors=estats.errors,
                      stream_batches=estats.batches, stream_report=engine.report())
    if model.device.type == "cuda":
        report["device_name"] = torch.cuda.get_device_name(model.device)
    if interrupted:
        print(f"replica {args.replica_index}: drained after a signal; everything admitted "
              f"was answered; exiting {EXIT_PREEMPTED}", file=sys.stderr)
        return EXIT_PREEMPTED, report, [], model
    return (0 if group is None or group.broken is None else 1), report, [], model


def main(argv=None) -> int:
    rc, report, _, _ = run(argv)
    if report.get("follower"):
        # Only the leader prints the report line.
        print(f"lockstep follower: {json.dumps(report)}", file=sys.stderr, flush=True)
    else:
        print(json.dumps(report), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
