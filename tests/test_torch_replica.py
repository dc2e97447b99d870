"""Real replica processes of the port's serve entry
(``python -m raft_ncup_tpu_torch.serve --replica_socket ...``) behind the
port's supervisor and router, on the CPU with the small model at 48x64.

Fast tier, one replica: its healthz carries the replica identity; a
request and two frames of a stream answer bit for bit what an in-process
``FlowServer`` and ``StreamEngine`` from the same seed and flags answer;
``set_telemetry`` is acked; SIGTERM shows DRAINING in healthz, exits 75,
and the replica's report holds ``recompiles == 0`` and
``host_transfers == 0``. Bit for bit needs one torch thread on both
sides: this process pins one, and the children get ``OMP_NUM_THREADS=1``.

Slow tier (the JAX package's ``TestFleetBlastRadius`` and
``TestElasticFleetChaos``): a 3-replica fleet through killreplica with a
frame in flight, drainreplica with work in flight and stallreplica, every
surviving answer bit for bit an in-process reference's; a 3-host TCP
fleet of host agents through partitionhost and killsupervisor; the
autoscaler's scale-down under load and scale-up on a real fleet.
"""

import os
import signal
import socket
import sys
import time

import jax  # noqa: F401  (JAX runs on the CPU platform in this test process)
import numpy as np
import pytest
import torch

from raft_ncup_tpu_torch import serve as serve_mod
from raft_ncup_tpu_torch.cli import model_config_from_args, serve_config_from_args, \
    stream_config_from_args
from raft_ncup_tpu_torch.config import ServeConfig, StreamConfig
from raft_ncup_tpu_torch.fleet import (
    FleetAutoscaler,
    FleetConfig,
    FleetManager,
    FleetRouter,
    ReplicaSupervisor,
    read_healthz,
)
from raft_ncup_tpu_torch.fleet.replica import UP
from raft_ncup_tpu_torch.observability import (
    Telemetry,
    collect_fleet_records,
    fleet_traces,
    load_dump,
)
from raft_ncup_tpu_torch.serving import FlowServer
from raft_ncup_tpu_torch.serving.request import (
    STATUS_ERROR, STATUS_OK, STATUS_REJECTED, STATUS_SHED, STATUS_TIMEOUT)
from raft_ncup_tpu_torch.streaming import StreamEngine

torch.set_num_threads(1)
TERMINAL_STATUSES = (STATUS_OK, STATUS_SHED, STATUS_TIMEOUT, STATUS_REJECTED, STATUS_ERROR)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = (48, 64)
WAIT_S = 120.0  # every result() wait


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=_REPO)


def _cfg(base, n=1, **kw):
    kw.setdefault("serve", ServeConfig(batch_sizes=(1, 2), iter_levels=(2,),
                                       queue_capacity=16))
    # A generous idle timeout: an idle-evicted stream re-admits cold, which
    # would make the reference comparison depend on the wall clock.
    kw.setdefault("stream", StreamConfig(capacity=4, iters=2, batch_sizes=(1, 2),
                                         frame_hw=SIZE, max_frame_gap=10,
                                         idle_timeout_s=600.0, cache_size=2))
    kw.setdefault("extra_args", ("--small", "--device", "cpu", "--seed", "0"))
    kw.setdefault("snapshot_interval_s", 0.25)
    kw.setdefault("poll_interval_s", 0.05)
    kw.setdefault("spawn_timeout_s", 120.0)
    return FleetConfig(base_dir=str(base), n_replicas=n, size_hw=SIZE, **kw)


class _Reference:
    """An in-process server and stream engine built from the argv the
    supervisor gives replica 0: the same model flags, seed and configs."""

    def __init__(self, cfg):
        args = serve_mod.build_parser().parse_args(cfg.replica_argv(0))
        self.model = serve_mod.load_model(model_config_from_args(args, dataset="sintel"),
                                          None, args.device, args.seed)
        self.server = FlowServer(self.model, serve_config_from_args(args))
        self.engine = StreamEngine(self.model, stream_config_from_args(args, SIZE))
        self.server.warmup(SIZE)
        self.engine.warmup()

    def request(self, a, b):
        return self.server.submit(a, b).result(WAIT_S)

    def frame(self, sid, fi, a, b):
        return self.engine.submit(sid, a, b, frame_index=fi).result(WAIT_S)

    def close(self):
        self.server.drain()
        self.engine.drain()


def _frames(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 255, (*SIZE, 3)).astype(np.float32) for _ in range(n)]


def test_one_replica_serves_bit_for_bit_and_drains_with_exit_75(tmp_path):
    cfg = _cfg(tmp_path / "fleet", max_restarts=0, stale_after_factor=8.0)
    ref = _Reference(cfg)
    tel = Telemetry(flight_dir=os.path.join(cfg.base_dir, "router_flight"))
    sup = ReplicaSupervisor(cfg, env=_env(), telemetry=tel).start()
    router = FleetRouter(cfg, sup, telemetry=tel)
    frames = _frames(3, 4)
    try:
        hz = read_healthz(cfg.replica(0).healthz_path)
        assert hz["overall"] == "ready" and hz["replica"] == 0 and hz["mesh"] == "nomesh"
        assert hz["pid"] == sup.replicas[0].child.pid
        assert sorted(map(tuple, hz["warmed"])) == [(48, 64, 1, 2), (48, 64, 2, 2)]
        assert len(hz["stream_warmed"]) == 2 and hz["stale_after_s"] == 0.5

        r = router.submit(frames[0], frames[1]).result(WAIT_S)
        want = ref.request(frames[0], frames[1])
        assert r.status == want.status == "ok" and r.iters == want.iters == 2
        assert r.flow.dtype == np.float32 and r.flow.tobytes() == want.flow.tobytes()
        for fi in range(2):  # a cold frame, then a warm one
            r = router.submit(frames[fi + 1], frames[fi + 2], stream_id="s",
                              frame_index=fi).result(WAIT_S)
            want = ref.frame("s", fi, frames[fi + 1], frames[fi + 2])
            assert r.status == want.status == "ok"
            assert r.flow.tobytes() == want.flow.tobytes(), f"frame {fi}"
        assert router.set_fleet_telemetry(False, timeout=10.0) == 1
        assert router.set_fleet_telemetry(True, timeout=10.0) == 1
        router.drain()
        out = sup.drain(0)
    finally:
        router.drain()
        reports = sup.stop(drain=False)
        ref.close()
    assert out["observed_draining"] is True and out["returncode"] == 75
    assert sup.report()["contract_violations"] == []
    rep = out["report"]
    assert rep["interrupted"] is True and rep["recompiles"] == 0 and rep["host_transfers"] == 0
    assert (rep["completed"], rep["stream_completed"], rep["errors"]) == (1, 2, 0)
    # The plain versions run on the CPU: no kernel launches.
    assert rep["corr_kernel_launches"] == rep["nconv_kernel_launches"] == 0
    assert reports[0]["drain_exit_75"] is True
    hz = read_healthz(cfg.replica(0).healthz_path)
    assert hz["draining"] is True
    dumps = os.listdir(cfg.replica(0).flight_dir)
    assert any(d.startswith("flight_preemption_drain_") for d in dumps)
    # One trace per request across the hop: the replica's queue, batch and
    # device spans carry the router's trace id (submit's trace_id), stitched
    # from the router's drain dump and the replica's.
    traces = fleet_traces(collect_fleet_records(cfg.base_dir))
    spanning = [t for t in traces if {"router", "replica_0"} <= set(t["origins"])]
    assert len(spanning) == 3
    for t in spanning:
        assert {"wire_ms", "replica_queue_ms", "device_ms"} <= set(t["hops"]), t["hops"]
        assert all(v >= 0.0 for v in t["hops"].values())


def test_replica_entry_refuses_a_frame_on_a_request_only_replica(tmp_path):
    """``--replica_streams false``: a frame answers ``rejected``, a request
    ``ok``, an unknown kind ``rejected``; SIGTERM exits 75."""
    from raft_ncup_tpu_torch.fleet import ChildProcess
    from raft_ncup_tpu_torch.fleet.replica import last_json_line
    from raft_ncup_tpu_torch.fleet.wire import Transport, recv_msg, send_msg

    cfg = _cfg(tmp_path / "fleet", stream=None)
    argv = [sys.executable, "-m", "raft_ncup_tpu_torch.serve"] + cfg.replica_argv(0)
    assert argv[argv.index("--replica_streams") + 1] == "false"
    os.makedirs(cfg.base_dir)
    child = ChildProcess(argv, env=_env(), cwd=_REPO).spawn()
    try:
        deadline = time.monotonic() + WAIT_S
        while (read_healthz(cfg.replica(0).healthz_path) or {}).get("overall") != "ready":
            assert child.running and time.monotonic() < deadline, child.stderr_so_far()[-2000:]
            time.sleep(0.05)
        sock = Transport.parse(cfg.replica(0).address).connect(timeout_s=10.0)
        a, b = _frames(5, 2)
        answers = {}
        for rid, header in enumerate(({"kind": "frame", "stream_id": "s", "frame_index": 0},
                                      {"kind": "request"}, {"kind": "bogus"})):
            send_msg(sock, {**header, "id": rid}, [a, b])
            hdr, arrays = recv_msg(sock)
            answers[hdr["id"]] = (hdr["status"], len(arrays))
        sock.close()
        assert answers == {0: ("rejected", 0), 1: ("ok", 1), 2: ("rejected", 0)}
        child.terminate()
        rc, out, err = child.reap(timeout=WAIT_S)
    finally:
        child.kill()
        child.reap(timeout=10.0)
    assert rc == 75, err[-2000:]
    rep = last_json_line(out)
    assert rep["completed"] == 1 and "stream_completed" not in rep
    assert rep["recompiles"] == 0 and rep["host_transfers"] == 0


def test_replica_without_a_card_raises_and_never_serves_from_the_cpu(monkeypatch, tmp_path):
    """No ``--device``: the replica wants the card and raises where there is
    none, before it listens or writes healthz."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sock, hz = str(tmp_path / "r.sock"), str(tmp_path / "r.healthz.json")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_mod.main(["--small", "--size", "48", "64", "--replica_socket", sock,
                        "--healthz_file", hz, "--flight_dir", ""])
    assert not os.path.exists(sock) and not os.path.exists(hz)


# --------------------------------------------------------------- slow tier


def _submitter(router, results, carried, frames):
    def submit_frame(s, fi, wait=True):
        with router._lock:
            rid = router._next_id
        h = router.submit(frames[s][fi], frames[s][fi + 1], stream_id=s, frame_index=fi)
        if not wait:
            return h, rid
        r = h.result(WAIT_S)
        results[(s, fi)], carried[(s, fi)] = r, router.replica_of(rid)
        return r
    return submit_frame


def _segments(results, carried, s):
    """Consecutive same-replica runs of a stream's answered frames."""
    segs = []
    for fi in sorted(fi for (ss, fi) in results if ss == s):
        if segs and segs[-1][0] == carried[(s, fi)]:
            segs[-1][1].append(fi)
        else:
            segs.append((carried[(s, fi)], [fi]))
    return segs


def _check_against_reference(cfg, results, carried, frames):
    """Every answered frame equals an uninjected in-process run: each
    same-replica segment replays on a fresh stream id (cold at its head,
    as the re-homed engine saw it; warm within)."""
    ref = _Reference(_cfg(cfg.base_dir + "_ref", stream=StreamConfig(
        capacity=16, iters=2, batch_sizes=(1, 2), frame_hw=SIZE, max_frame_gap=10,
        idle_timeout_s=600.0, cache_size=2)))
    try:
        for s in frames:
            for k, (rep, fis) in enumerate(_segments(results, carried, s)):
                for fi in fis:
                    r = results[(s, fi)]
                    if r.status != "ok":
                        continue
                    want = ref.frame(f"{s}#{k}", fi, frames[s][fi], frames[s][fi + 1])
                    assert want.status == "ok"
                    assert r.flow.tobytes() == want.flow.tobytes(), (s, fi, rep)
    finally:
        ref.close()


@pytest.mark.slow
def test_blast_radius_kill_drain_stall(tmp_path):
    cfg = _cfg(tmp_path / "fleet", n=3, max_restarts=1, restart_backoff_s=0.3,
               circuit_break_after=5)
    tel = Telemetry(flight_dir=os.path.join(cfg.base_dir, "router_flight"))
    sup = ReplicaSupervisor(cfg, env=_env(), telemetry=tel).start()
    router = FleetRouter(cfg, sup, telemetry=tel)
    frames = {s: _frames(i, 7) for i, s in enumerate(("s0", "s1", "s2", "s3"))}
    results, carried = {}, {}
    submit_frame = _submitter(router, results, carried, frames)
    try:
        for fi in range(2):
            for s in frames:
                assert submit_frame(s, fi).status == "ok"
        aff = dict(router.report()["affinity"])
        # killreplica with a frame in flight: the victim is s0's home,
        # stopped first so the frame never answers there.
        victim = aff["s0"]
        sup.replicas[victim].child.suspend()
        h, rid_inflight = submit_frame("s0", 2, wait=False)
        time.sleep(0.2)
        sup.kill(victim)
        r = h.result(WAIT_S)
        results[("s0", 2)], carried[("s0", 2)] = r, router.replica_of(rid_inflight)
        assert r.status == "ok" and router.stats["failovers"] >= 1
        assert carried[("s0", 2)] == router.report()["affinity"]["s0"] != victim
        assert submit_frame("s0", 3).status == "ok"
        for fi in (2, 3):
            for s in ("s1", "s2", "s3"):
                assert submit_frame(s, fi).status == "ok"
        deadline = time.monotonic() + WAIT_S
        while sup.replicas[victim].state != UP and time.monotonic() < deadline:
            time.sleep(0.1)
        assert (sup.replicas[victim].state, sup.replicas[victim].restarts) == (UP, 1)
        # drainreplica with work in flight on a live home: no loss, 75.
        live = router.report()["affinity"]
        s_drain = next(s for s in ("s1", "s2", "s3") if sup.replicas[live[s]].admittable())
        survivor = live[s_drain]
        sup.replicas[survivor].child.suspend()
        h1, rid1 = submit_frame(s_drain, 4, wait=False)
        h2, rid2 = submit_frame(s_drain, 5, wait=False)
        time.sleep(0.2)
        sup.replicas[survivor].child.resume()
        out = sup.drain(survivor)
        assert (out["observed_draining"], out["returncode"]) == (True, 75)
        for fi, hh, rid in ((4, h1, rid1), (5, h2, rid2)):
            results[(s_drain, fi)], carried[(s_drain, fi)] = hh.result(WAIT_S), \
                router.replica_of(rid)
            assert results[(s_drain, fi)].status == "ok"
        assert out["report"]["recompiles"] == 0 and out["report"]["host_transfers"] == 0
        # stallreplica: the process lingers, healthz goes stale, it dies.
        target = [x.index for x in sup.replicas if x.admittable()][0]
        sup.stall(target)
        deadline = time.monotonic() + 60
        while sup.replicas[target].stale_deaths < 1 and time.monotonic() < deadline:
            time.sleep(0.1)
        assert sup.replicas[target].stale_deaths == 1
    finally:
        router.drain()
        reports = sup.stop()
    assert all(r.status in TERMINAL_STATUSES for r in results.values())
    assert not any(r.status == "error" for r in results.values())
    dumps = [f for f in os.listdir(os.path.join(cfg.base_dir, "router_flight"))
             if f.startswith("flight_replica_failover_")]
    dump = load_dump(os.path.join(cfg.base_dir, "router_flight", sorted(dumps)[0]))
    assert rid_inflight in dump["context"]["request_ids"]
    traces = fleet_traces(collect_fleet_records(cfg.base_dir))
    assert any(len(t["origins"]) >= 2 and "router" in t["origins"] for t in traces)
    _check_against_reference(cfg, results, carried, frames)
    for rep in reports.values():
        body = rep.get("report")
        if body is not None:
            assert body["recompiles"] == 0 and body["host_transfers"] == 0


def _free_base_port(n, tries=50):
    rng = np.random.default_rng()
    for _ in range(tries):
        base = int(rng.integers(20000, 60000))
        socks = []
        try:
            for i in range(n):
                s = socket.socket()
                s.bind(("127.0.0.1", base + i))
                socks.append(s)
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no {n} consecutive free ports")


def _proc_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().split()[2] != "Z"
    except OSError:
        return True


@pytest.mark.slow
def test_partitionhost_and_killsupervisor_fence_and_fail_over(tmp_path):
    cfg = _cfg(tmp_path / "fleet", n=3, hosts=("hA", "hB", "hC"), transport="tcp",
               base_port=_free_base_port(6), stale_after_factor=8, max_restarts=0)
    tel = Telemetry(flight_dir=os.path.join(cfg.base_dir, "router_flight"))
    manager = FleetManager(cfg, env=_env(), telemetry=tel).start()
    router = FleetRouter(cfg, manager, telemetry=tel)
    frames = {s: _frames(10 + i, 7) for i, s in enumerate(("sa", "sb", "sc", "sd"))}
    results, carried = {}, {}
    submit_frame = _submitter(router, results, carried, frames)

    def wait_dead(host):
        deadline = time.monotonic() + 90
        while host not in manager.report()["dead_hosts"] and time.monotonic() < deadline:
            time.sleep(0.1)
        assert host in manager.report()["dead_hosts"], manager.report()

    try:
        for fi in range(2):
            for s in frames:
                assert submit_frame(s, fi).status == "ok"
        victim = router.report()["affinity"]["sa"]
        vhost, vpid = manager.host_of(victim), manager.handle(victim).remote_pid
        os.kill(vpid, signal.SIGSTOP)
        h, rid = submit_frame("sa", 2, wait=False)
        time.sleep(0.2)
        manager.partition(vhost)
        r = h.result(WAIT_S)
        results[("sa", 2)], carried[("sa", 2)] = r, router.replica_of(rid)
        assert r.status == "ok" and carried[("sa", 2)] != victim
        wait_dead(vhost)
        deadline = time.monotonic() + 30
        while _proc_alive(vpid) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not _proc_alive(vpid)  # fenced
        # killsupervisor: the agent dies, its replica lingers until fenced.
        live = [i for i in range(3) if manager.handle(i).state == UP]
        k_host = manager.host_of(live[0])
        k_pid = manager.handle(live[0]).remote_pid
        manager.kill_agent(k_host)
        wait_dead(k_host)
        deadline = time.monotonic() + 30
        while _proc_alive(k_pid) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not _proc_alive(k_pid)
        for s in frames:
            assert submit_frame(s, 3).status == "ok"
        assert len({carried[(s, 3)] for s in frames}) == 1  # one host left
    finally:
        router.drain()
        manager.stop()
    _check_against_reference(cfg, results, carried, frames)


@pytest.mark.slow
def test_autoscaler_cycle_on_a_real_fleet_loses_nothing(tmp_path):
    import threading

    cfg = _cfg(tmp_path / "fleet", n=2, min_replicas=1, max_replicas=2,
               scale_hysteresis_ticks=2, scale_cooldown_s=2.0, max_inflight_per_replica=4,
               stale_after_factor=480)
    tel = Telemetry()
    sup = ReplicaSupervisor(cfg, env=_env(), telemetry=tel).start()
    router = FleetRouter(cfg, sup, telemetry=tel)
    sc = FleetAutoscaler(cfg, sup, router, telemetry=tel)
    img = _frames(13, 1)[0]
    answers = []
    try:
        # Scale-down under load: one request pinned in flight on each
        # replica; the victim is the newest of the least-loaded tie, slot 1.
        for h in sup.replicas:
            h.child.suspend()
        h1, h2 = router.submit(img, img), router.submit(img, img)
        t1, t2 = sc.tick(), sc.tick()
        assert (t1["reason"], t2["decision"]) == ("hysteresis 1/2", "down")
        assert t2["reason"].startswith("draining slot 1")
        for h in sup.replicas:
            h.child.resume()
        answers += [h1.result(WAIT_S), h2.result(WAIT_S)]
        assert [r.status for r in answers] == ["ok", "ok"]  # no loss through the drain
        deadline = time.monotonic() + 150
        while sc.report()["scale_downs"] < 1 and time.monotonic() < deadline:
            sc.tick()
            time.sleep(0.2)
        retired = sup.retired[-1]
        assert (retired.index, retired.drain_observed_draining, retired.drain_exit_75) == (
            1, True, True)
        assert retired.contract_violations == [] and [h.index for h in sup.replicas] == [0]
        # A load step beats one replica: occupancy saturates, the overflow
        # sheds at the router, and the loop spawns slot 1 through the READY
        # gate; sheds while it warms carry the time-to-READY floor.
        time.sleep(2.1)  # the cooldown since the scale-down
        stop, surge, load = threading.Event(), threading.Event(), []
        surge.set()

        def _load():
            while not stop.is_set():
                load.append(router.submit(img, img))
                time.sleep(0.004 if surge.is_set() else 0.05)

        thread = threading.Thread(target=_load, daemon=True)
        thread.start()
        deadline = time.monotonic() + 240
        while sc.report()["scale_ups_completed"] < 1 and time.monotonic() < deadline:
            if sc.tick()["decision"] == "up":
                surge.clear()
            time.sleep(0.2)
        stop.set()
        thread.join(timeout=10)
        rep = sc.report()
        assert (rep["scale_ups"], rep["scale_ups_completed"], rep["failed_scale_ups"]) == (1, 1, 0)
        statuses = [h.result(WAIT_S) for h in load]
        answers += statuses
        assert {r.status for r in statuses} <= {"ok", "shed"}
        assert any(r.status == "ok" for r in statuses)
        assert any(r.status == "shed" and r.retry_after_s >= cfg.scale_eta_prior_s
                   for r in statuses)
        carriers = set()
        for _ in range(4):
            with router._lock:
                rid = router._next_id
            answers.append(router.submit(img, img).result(WAIT_S))
            assert answers[-1].status == "ok"
            carriers.add(router.replica_of(rid))
        assert 1 in carriers  # the new replica takes traffic once READY
        # Calm again: the capacity goes back, down to the floor.
        deadline = time.monotonic() + 150
        while sc.report()["scale_downs"] < 2 and time.monotonic() < deadline:
            sc.tick()
            time.sleep(0.2)
        assert sc.report()["scale_downs"] == 2 and [h.index for h in sup.replicas] == [0]
    finally:
        sc.stop()
        router.drain()
        reports = sup.stop()
    assert not any(r.status == "error" for r in answers)
    for body in [rep.get("report") for rep in reports.values()] + [
            h.final_report for h in sup.retired]:
        if body is not None:
            assert body["recompiles"] == 0 and body["host_transfers"] == 0
