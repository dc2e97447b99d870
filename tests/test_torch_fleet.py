"""The port's fleet tier (``raft_ncup_tpu_torch/fleet/``) against the JAX
package's (``raft_ncup_tpu/fleet/``), on the CPU, without a model.

- Topology: ``FleetConfig`` field for field, its derived replica specs
  and host manifests, ``replica_argv`` equal to JAX's apart from the
  device flag, the same refusals (and the port's of a malformed mesh),
  ``padded_shape`` against the port's ``InputPadder``.
- The wire: frames byte for byte the same in both directions (a frame one
  package sends parses with the other's ``recv_msg``), the same EOF,
  mid-frame and timeout behaviour, the same address parse.
- ``rendezvous_choice`` equal on 1000 keys.
- The supervisor against a crashing child: restarts, backoff and the
  circuit breaker count as JAX's do; once ``stop`` has begun, a restart
  that falls due spawns nothing.
- Each router scenario of the JAX package's fast tier (admission, shed
  hints, affinity, shape-aware routing, failover, drain, trace
  propagation, fleet chaos) runs through JAX's router and the port's
  against the same fake replicas, which speak the wire protocol, and the
  two must decide alike: the same statuses, per-replica dispatch counts,
  affinity and shed hints.
- The host agents: a ``FleetManager`` over two hosts whose agents
  supervise fake replicas; a partitioned host is fenced and its replica
  declared dead.
- No module under ``fleet/`` imports torch, jax or the JAX package.

Every wait is bounded by its own timeout; torch runs one thread.
"""

import ast
import os
import signal
import socket
import sys
import threading
import time
import types

import jax  # noqa: F401  (the reference package runs on the CPU platform)
import numpy as np
import pytest
import torch

import raft_ncup_tpu.fleet as jfleet
import raft_ncup_tpu.fleet.replica as jreplica
import raft_ncup_tpu.fleet.router as jrouter
import raft_ncup_tpu.fleet.wire as jwire
import raft_ncup_tpu.observability as jobs
import raft_ncup_tpu_torch.fleet as pfleet
import raft_ncup_tpu_torch.fleet.replica as preplica
import raft_ncup_tpu_torch.fleet.router as prouter
import raft_ncup_tpu_torch.fleet.wire as pwire
import raft_ncup_tpu_torch.observability as pobs
from raft_ncup_tpu.config import ServeConfig as JServeConfig
from raft_ncup_tpu.config import StreamConfig as JStreamConfig
from raft_ncup_tpu.resilience.chaos import ChaosSpec as JChaosSpec
from raft_ncup_tpu_torch.config import ServeConfig, StreamConfig
from raft_ncup_tpu_torch.ops.padding import InputPadder
from raft_ncup_tpu_torch.resilience.chaos import ChaosSpec

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 10.0  # every result() wait


def _pkg(name):
    """One package's fleet surface, so a scenario runs on either."""
    if name == "jax":
        return types.SimpleNamespace(
            name=name, fleet=jfleet, replica=jreplica, router=jrouter, obs=jobs,
            ServeConfig=JServeConfig, StreamConfig=JStreamConfig, ChaosSpec=JChaosSpec)
    return types.SimpleNamespace(
        name=name, fleet=pfleet, replica=preplica, router=prouter, obs=pobs,
        ServeConfig=ServeConfig, StreamConfig=StreamConfig, ChaosSpec=ChaosSpec)


def _both(scenario, *args):
    """``scenario(pkg, *args)`` on JAX's fleet and on the port's: the two
    outcomes, which the caller holds equal."""
    return scenario(_pkg("jax"), *args), scenario(_pkg("port"), *args)


# ------------------------------------------------------------- topology


def _topologies(tmp):
    return [
        dict(base_dir=tmp, n_replicas=3),
        dict(base_dir=tmp, n_replicas=2, size_hw=(48, 64), stream=None,
             serve=dict(batch_sizes=(1, 2), iter_levels=(4, 2), queue_capacity=7,
                        pad_bucket=64, precision="bf16_infer")),
        dict(base_dir=tmp, n_replicas=2, size_hw=(436, 1024),
             serve=dict(batch_sizes=(1, 2), iter_levels=(12,)),
             stream=dict(capacity=3, iters=2, batch_sizes=(1, 2), frame_hw=(436, 1024))),
        dict(base_dir=tmp, n_replicas=1, min_replicas=1, max_replicas=3, transport="tcp",
             base_port=7641, hosts=("hA", "hB"), scale_tick_s=0.25,
             max_inflight_per_replica=3),
        dict(base_dir=tmp, n_replicas=2, max_replicas=2, hosts=("a", "b"),
             placement=("b", "b"), meshes=(None, None)),
    ]


def _make_cfg(pkg, kw, extra=()):
    kw = dict(kw)
    if isinstance(kw.get("serve"), dict):
        kw["serve"] = pkg.ServeConfig(**kw["serve"])
    if isinstance(kw.get("stream"), dict):
        kw["stream"] = pkg.StreamConfig(**kw["stream"])
    return pkg.fleet.FleetConfig(**kw, extra_args=tuple(extra))


def _device_neutral(argv):
    """JAX's ``--platform cpu`` and the port's ``--device cpu`` as one."""
    return ["<device>" if a in ("--platform", "--device") else a for a in argv]


@pytest.mark.parametrize("which", range(5))
def test_config_fields_specs_and_argv_match_jax(tmp_path, which):
    kw = _topologies(str(tmp_path))[which]
    j = _make_cfg(_pkg("jax"), kw, ("--small", "--platform", "cpu"))
    p = _make_cfg(_pkg("port"), kw, ("--small", "--device", "cpu"))
    import dataclasses

    for f in dataclasses.fields(j):
        jv, pv = getattr(j, f.name), getattr(p, f.name)
        if f.name in ("serve", "stream"):
            assert (jv is None) == (pv is None)
            if jv is not None:
                for g in dataclasses.fields(pv):
                    assert getattr(pv, g.name) == getattr(jv, g.name), (f.name, g.name)
        elif f.name == "extra_args":
            assert _device_neutral(pv) == _device_neutral(jv)
        else:
            assert pv == jv, f.name
    for prop in ("stale_after_s", "scale_min", "scale_max"):
        assert getattr(p, prop) == getattr(j, prop)
    assert [dataclasses.asdict(s) for s in p.replicas()] == [
        dataclasses.asdict(s) for s in j.replicas()]
    for i in range(p.scale_max):
        assert dataclasses.asdict(p.replica(i)) == dataclasses.asdict(j.replica(i))
        assert p.replica_address(i) == j.replica_address(i)
        assert _device_neutral(p.replica_argv(i)) == _device_neutral(j.replica_argv(i))
        assert p.pad_divisor(i) == j.pad_divisor(i) == 8
        for hw in ((48, 64), (97, 130), (436, 1024)):
            assert p.shape_key(*hw, i) == j.shape_key(*hw, i)
    for host in p.hosts or ("",):
        pm, jm = p.host_manifest(host), j.host_manifest(host)
        for r in pm["replicas"] + jm["replicas"]:
            r["argv"] = _device_neutral(r["argv"])
        assert pm == jm
        assert p.host_control_address(host) == j.host_control_address(host)


def test_validation_refuses_what_jax_refuses_and_a_mesh(tmp_path):
    base = str(tmp_path)
    bad = [dict(n_replicas=0), dict(base_dir=""), dict(n_replicas=3, meshes=(None, None)),
           dict(circuit_break_after=0), dict(max_inflight_per_replica=0),
           dict(stale_after_factor=0.5), dict(max_failovers=-1), dict(snapshot_interval_s=0.0),
           dict(size_hw=(8, 8)), dict(transport="udp"), dict(transport="tcp"),
           dict(placement=("a", "a")), dict(hosts=("a",), placement=("z", "z")),
           dict(min_replicas=3), dict(scale_up_occupancy=0.2, scale_down_occupancy=0.3),
           dict(scale_hysteresis_ticks=0), dict(scale_fail_budget=0), dict(scale_tick_s=0)]
    for kw in bad:
        kw = {"base_dir": base, **kw}
        for pkg in (_pkg("jax"), _pkg("port")):
            with pytest.raises(ValueError):
                pkg.fleet.FleetConfig(**kw)
    # A mesh slice: both topologies take it; the port refuses a malformed one.
    for pkg_fleet in (jfleet, pfleet):
        pkg_fleet.FleetConfig(base_dir=base, n_replicas=2, meshes=(None, (1, 2)))
    assert pfleet.ReplicaSpec(index=0, socket_path="s", healthz_path="h", flight_dir="f",
                              mesh=(1, 2)).ranks == 2
    for mesh in ((0, 2), (1, 2, 1)):
        with pytest.raises(ValueError, match="positive sizes"):
            pfleet.FleetConfig(base_dir=base, n_replicas=2, meshes=(None, mesh))


def test_padded_shape_matches_the_ports_input_padder_and_jax():
    for h, w in ((48, 64), (97, 130), (100, 100), (437, 1023), (436, 1024)):
        for divisor in (8, 16):
            (t, b), (le, r) = InputPadder((h, w, 3), mode="sintel", divisor=divisor).pad_spec
            assert pfleet.padded_shape(h, w, divisor=divisor) == (h + t + b, w + le + r) \
                == jfleet.padded_shape(h, w, divisor=divisor)
        for bucket in (32, 64):
            (t, b), (le, r) = InputPadder((h, w, 3), mode="sintel", bucket=bucket).pad_spec
            assert pfleet.padded_shape(h, w, bucket=bucket) == (h + t + b, w + le + r) \
                == jfleet.padded_shape(h, w, bucket=bucket)


def test_fleet_package_imports_no_torch_and_no_jax():
    """Host-only by construction: an AST scan of every module under
    ``fleet/`` (imports at any depth)."""
    root = os.path.join(_REPO, "raft_ncup_tpu_torch", "fleet")
    names = sorted(n for n in os.listdir(root) if n.endswith(".py"))
    assert names == ["__init__.py", "autoscaler.py", "host_supervisor.py", "replica.py",
                     "router.py", "topology.py", "wire.py"]
    for name in names:
        path = os.path.join(root, name)
        tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("torch", "jax", "jaxlib", "flax", "raft_ncup_tpu"), \
                    f"{name} imports {mod}"


# ----------------------------------------------------------------- wire


def _frames():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (8, 12, 3)).astype(np.float32)
    return [
        ({"kind": "ping", "t0": 12.5}, ()),
        ({"kind": "request", "id": 7, "deadline_s": 1.5,
          "trace": {"trace_id": "abc", "span_id": "router-7", "clock_offset_s": 0.0,
                    "sent_s": 3.25}}, (img, np.roll(img, 1, 0))),
        ({"kind": "frame", "id": 8, "stream_id": "s1", "frame_index": 2},
         (img[:, ::2], rng.integers(0, 255, (4, 5, 3), dtype=np.uint8))),
        ({"kind": "response", "id": 9, "status": "ok", "iters": 12, "latency_s": None,
          "detail": "", "t_recv_s": 1.0, "t_done_s": 2.0},
         (rng.normal(size=(8, 12, 2)).astype(np.float32),)),
    ]


def _sent_bytes(send, header, arrays) -> bytes:
    a, b = socket.socketpair()
    try:
        send(a, dict(header), arrays)
        a.close()
        chunks = []
        while True:
            c = b.recv(1 << 16)
            if not c:
                return b"".join(chunks)
            chunks.append(c)
    finally:
        b.close()


@pytest.mark.parametrize("sender", ["jax", "port"])
def test_frames_are_byte_identical_and_parse_across_packages(sender):
    send, recv = ((jwire.send_msg, pwire.recv_msg) if sender == "jax"
                  else (pwire.send_msg, jwire.recv_msg))
    for header, arrays in _frames():
        raw = _sent_bytes(jwire.send_msg, header, arrays)
        assert _sent_bytes(pwire.send_msg, header, arrays) == raw
        a, b = socket.socketpair()
        try:
            send(a, dict(header), arrays)
            got_header, got = recv(b)
        finally:
            a.close()
            b.close()
        assert got_header == header
        assert len(got) == len(arrays)
        for x, y in zip(got, arrays):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == np.ascontiguousarray(y).tobytes()


def test_eof_mid_frame_timeouts_and_refusals_match_jax():
    for wire in (jwire, pwire):
        a, b = socket.socketpair()
        a.close()
        assert wire.recv_msg(b) is None  # clean EOF between frames
        b.close()
        raw = _sent_bytes(wire.send_msg, *_frames()[1])
        for cut in (2, 20, len(raw) - 3):  # torn in the length, the header, the payload
            a, b = socket.socketpair()
            a.sendall(raw[:cut])
            a.close()
            with pytest.raises(ConnectionError):
                wire.recv_msg(b)
            b.close()
        a, b = socket.socketpair()
        wire.set_read_timeout(b, 0.05)
        with pytest.raises(wire.FrameTimeout):
            wire.recv_msg(b)  # silence at a frame boundary
        a.sendall(raw[:30])
        with pytest.raises(ConnectionError):
            wire.recv_msg(b)  # a deadline mid-frame
        a.close()
        b.close()
        a, b = socket.socketpair()
        a.sendall((wire.MAX_HEADER_BYTES + 1).to_bytes(4, "big"))
        with pytest.raises(ValueError):
            wire.recv_msg(b)
        a.close()
        b.close()
        with pytest.raises(ValueError):
            wire.send_msg(None, {"kind": "x", "arrays": []})
        with pytest.raises(TypeError):
            wire.send_msg(None, {"kind": "x"}, [torch.zeros(2)])


def test_transport_parse_matches_jax(tmp_path):
    for addr in ("/tmp/r.sock", "127.0.0.1:7641", "host:80", "rel.sock", "a:b",
                 "dir/x:80", "[::1]:9", "localhost:0"):
        j, p = jwire.Transport.parse(addr), pwire.Transport.parse(addr)
        assert (p.family, p.path, p.host, p.port, p.is_inet, p.render()) == \
            (j.family, j.path, j.host, j.port, j.is_inet, j.render())
    with pytest.raises(ValueError):
        pwire.Transport.parse("")
    # A port listener takes a JAX client.
    path = str(tmp_path / "x.sock")
    lsock = pwire.Transport.parse(path).listen(2)
    try:
        c = jwire.Transport.parse(path).connect(timeout_s=WAIT_S)
        conn, _ = lsock.accept()
        jwire.send_msg(c, {"kind": "ping", "t0": 1.0})
        assert pwire.recv_msg(conn) == ({"kind": "ping", "t0": 1.0}, [])
        c.close()
        conn.close()
    finally:
        lsock.close()
        pwire.Transport.parse(path).cleanup()
    assert not os.path.exists(path)


def test_rendezvous_matches_jax_on_1000_keys():
    sets = ([0, 1], [0, 1, 2], [0, 2], [3, 1, 4, 5])
    for k in range(1000):
        key = f"stream-{k}"
        for c in sets:
            assert prouter.rendezvous_choice(key, c) == jrouter.rendezvous_choice(key, c)
    with pytest.raises(ValueError):
        prouter.rendezvous_choice("k", [])


# ------------------------------------------------- supervisor robustness


def _crash_loop(pkg, tmp, max_restarts, breaker):
    """A supervisor over children that exit 1 at once, pumped until the
    replica is BROKEN: (restarts, deaths, circuit open, report counts)."""
    cfg = pkg.fleet.FleetConfig(base_dir=os.path.join(tmp, pkg.name), n_replicas=1,
                                poll_interval_s=0.02, restart_backoff_s=0.02,
                                restart_backoff_max_s=0.05, max_restarts=max_restarts,
                                circuit_break_after=breaker)
    sup = pkg.fleet.ReplicaSupervisor(
        cfg, argv_prefix=[sys.executable, "-c", "import sys; sys.exit(1)"],
        telemetry=pkg.obs.Telemetry())
    sup.start(wait_ready=False)
    sup._poll_stop.set()  # drive poll() by hand
    handle = sup.replicas[0]
    deadline = time.monotonic() + 20.0
    while handle.state != pkg.replica.BROKEN and time.monotonic() < deadline:
        sup.poll()
        time.sleep(0.01)
    rep = sup.report()
    sup.stop(drain=False)
    assert handle.state == pkg.replica.BROKEN and not handle.admittable()
    return (handle.restarts, handle.deaths, handle.circuit_open, rep["restarts"],
            rep["deaths"], rep["circuits_open"])


@pytest.mark.parametrize("max_restarts,breaker,want", [
    (2, 10, (2, 3, False, 2, 3, 0)),  # the restart budget runs out
    (10, 3, (2, 3, True, 2, 3, 1)),  # the breaker opens first
])
def test_supervisor_crash_loop_counts_as_jax(tmp_path, max_restarts, breaker, want):
    j, p = _both(_crash_loop, str(tmp_path), max_restarts, breaker)
    assert p == j == want


def test_supervisor_spawns_nothing_once_stop_has_begun(tmp_path):
    """A replica that died with its restart due when ``stop`` begins is not
    restarted by a poll that runs after it (the poll thread's last pass):
    such a process would outlive the supervisor, since nothing reaps it."""
    cfg = pfleet.FleetConfig(base_dir=str(tmp_path), n_replicas=1, poll_interval_s=0.02,
                             restart_backoff_s=0.01, restart_backoff_max_s=0.02,
                             max_restarts=5, circuit_break_after=10)
    sup = pfleet.ReplicaSupervisor(
        cfg, argv_prefix=[sys.executable, "-c", "import sys; sys.exit(1)"],
        telemetry=pobs.Telemetry())
    sup.start(wait_ready=False)
    sup._poll_stop.set()  # drive poll() by hand
    handle = sup.replicas[0]
    deadline = time.monotonic() + WAIT_S
    while handle.state != preplica.DEAD and time.monotonic() < deadline:
        sup.poll()
        time.sleep(0.01)
    assert handle.state == preplica.DEAD and handle.restart_at is not None
    time.sleep(0.05)  # the restart is due
    first = handle.child
    sup.stop(drain=False)
    sup.poll()
    late = handle.child
    if late is not first:
        late.reap(timeout=WAIT_S)
    assert late is first and handle.restarts == 0 and handle.state == preplica.DEAD


def test_supervisor_delivers_a_death_outside_its_lock(tmp_path):
    """The router's death hook takes the router's lock, and the router
    calls back into the supervisor (``handle``) while it holds that lock:
    a hook run under the supervisor's lock deadlocks against a link reader
    failing the same replica over (the card's fleet phase hung so after a
    ``killreplica``). ``poll`` runs the hook after releasing its lock."""
    cfg = pfleet.FleetConfig(base_dir=str(tmp_path), n_replicas=1, poll_interval_s=0.02,
                             max_restarts=0)
    router_lock = threading.Lock()
    seen, got = [], []

    def on_death(i, why):
        with router_lock:
            seen.append(i)

    sup = pfleet.ReplicaSupervisor(
        cfg, argv_prefix=[sys.executable, "-c", "import sys; sys.exit(1)"],
        on_death=on_death, telemetry=pobs.Telemetry())
    sup.start(wait_ready=False)
    sup._poll_stop.set()  # drive poll() by hand
    deadline = time.monotonic() + WAIT_S
    while sup.replicas[0].child.running and time.monotonic() < deadline:
        time.sleep(0.01)
    router_lock.acquire()  # a link reader holds the router's lock ...

    def reader():  # ... and asks the supervisor for the replica
        try:
            got.append(sup.handle(0))
        finally:
            router_lock.release()

    poller = threading.Thread(target=sup.poll, daemon=True)
    poller.start()
    time.sleep(0.2)  # the poll has noted the death and calls the hook
    link = threading.Thread(target=reader, daemon=True)
    link.start()
    link.join(WAIT_S)
    poller.join(WAIT_S)
    # A deadlocked supervisor keeps its lock, so stop() would wait forever.
    assert not link.is_alive() and not poller.is_alive(), "deadlock"
    sup.stop(drain=False)
    assert got and seen == [0] and sup.replicas[0].deaths == 1


def test_child_process_lifecycle(tmp_path):
    child = pfleet.ChildProcess(
        [sys.executable, "-c", "import sys, time; print('{\"a\": 1}'); sys.stdout.flush(); "
         "time.sleep(30)"], name="t").spawn()
    assert child.running and child.pid
    assert child.suspend() and child.resume()
    deadline = time.monotonic() + WAIT_S
    while '{"a": 1}' not in child.stdout_so_far() and time.monotonic() < deadline:
        time.sleep(0.02)
    rc, out, _ = child.reap(timeout=0.2)  # escalates to SIGKILL
    assert rc == -signal.SIGKILL and preplica.last_json_line(out) == {"a": 1}
    assert not child.running and child.reap(timeout=1.0)[0] == rc
    assert preplica.last_json_line("noise\n{bad\n{\"b\": 2}\ntail") == {"b": 2}
    hz = {"time_unix_s": time.time()}
    assert preplica.healthz_fresh(hz, 0.5) and not preplica.healthz_fresh(hz, 0.5,
                                                                          time.time() + 1)
    assert not preplica.healthz_fresh(None, 1.0) and not preplica.healthz_fresh({}, 1.0)
    path = tmp_path / "h.json"
    assert preplica.read_healthz(str(path)) is None
    path.write_text('{"overall": "re')
    assert preplica.read_healthz(str(path)) is None


# ----------------------------- routers against fake in-process replicas


class _FakeReplica:
    """An in-process replica speaking the wire protocol: ``plan`` decides
    each request's fate in order ("ok" answers a zero flow, "shed" sheds
    with ``retry_after_s``, "hold" never answers); the last entry repeats.
    ``ping`` and ``set_telemetry`` never consume the plan."""

    def __init__(self, spec, plan, retry_after_s=1.0):
        self.spec, self.plan, self.retry_after = spec, list(plan), retry_after_s
        self.telemetry_enabled, self.seen, self._n = True, [], 0
        self._transport = pwire.Transport.parse(spec.address or spec.socket_path)
        self._lsock = self._transport.listen(4)
        self._lsock.settimeout(0.05)
        self._stop = threading.Event()
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn):
        try:
            while True:
                msg = pwire.recv_msg(conn)
                if msg is None:
                    return
                t_recv = time.monotonic()
                header, arrays = msg
                kind = header.get("kind")
                if kind == "ping":
                    pwire.send_msg(conn, {"kind": "pong", "pid": os.getpid(),
                                          "t0": header.get("t0"), "t_mono": time.monotonic()})
                    continue
                if kind == "set_telemetry":
                    self.telemetry_enabled = bool(header.get("enabled", True))
                    pwire.send_msg(conn, {"kind": "telemetry_ack",
                                          "enabled": self.telemetry_enabled,
                                          "replica": self.spec.index})
                    continue
                self.seen.append(header)
                behavior = self.plan[min(self._n, len(self.plan) - 1)]
                self._n += 1
                if behavior == "hold":
                    continue
                if behavior == "shed":
                    pwire.send_msg(conn, {"kind": "response", "id": header["id"],
                                          "status": "shed", "retry_after_s": self.retry_after,
                                          "detail": "fake shed"})
                    continue
                h, w = arrays[0].shape[:2]
                pwire.send_msg(conn, {"kind": "response", "id": header["id"], "status": "ok",
                                      "iters": 2, "latency_s": 0.001, "detail": "",
                                      "t_recv_s": t_recv, "t_done_s": time.monotonic()},
                               [np.zeros((h, w, 2), np.float32)])
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            conn.close()

    def close(self):
        self._stop.set()
        self._lsock.close()


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


class _Fleet:
    """A router over fake replicas: supervisor handles marked UP by hand
    (no processes), the fakes on the topology's addresses."""

    def __init__(self, pkg, tmp, plans, retry_afters=None, tel=None, **cfg_kw):
        self.pkg = pkg
        base = os.path.join(tmp, pkg.name)
        self.cfg = pkg.fleet.FleetConfig(base_dir=base, n_replicas=len(plans), **cfg_kw)
        os.makedirs(base, exist_ok=True)
        self.sup = pkg.fleet.ReplicaSupervisor(self.cfg, telemetry=pkg.obs.Telemetry())
        retry_afters = retry_afters or [1.0] * len(plans)
        self.fakes = [_FakeReplica(self.cfg.replica(i), plan, ra)
                      for i, (plan, ra) in enumerate(zip(plans, retry_afters))]
        for h in self.sup.replicas:
            h.state = pkg.replica.UP
            h.last_healthz = {"overall": "ready"}
        self.router = pkg.fleet.FleetRouter(self.cfg, self.sup,
                                            telemetry=tel or pkg.obs.Telemetry())

    def state(self, i, state):
        self.sup.replicas[i].state = getattr(self.pkg.replica, state)

    def submit(self, *a, **kw):
        return self.router.submit(*a, **kw)

    def close(self, timeout=0.2):
        self.router.drain(timeout=timeout)
        for f in self.fakes:
            f.close()


def _img(h=32, w=48, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (h, w, 3)).astype(np.float32)


def _brief(r):
    return (r.status, r.retry_after_s, None if r.flow is None else r.flow.shape)


def _ok_spread(pkg, tmp, transport):
    kw = {}
    if transport == "tcp":
        kw = dict(transport="tcp", base_port=_free_base_port(2))
    f = _Fleet(pkg, tmp, [["ok"], ["ok"]], **kw)
    try:
        rs = [f.submit(_img(), _img()).result(WAIT_S) for _ in range(4)]
        return [_brief(r) for r in rs], f.router.report()["per_replica_dispatched"]
    finally:
        f.close()


@pytest.mark.parametrize("transport", ["unix", "tcp"])
def test_roundtrip_and_least_loaded_spread_as_jax(tmp_path, transport):
    j, p = _both(_ok_spread, str(tmp_path), transport)
    assert p == j == ([("ok", None, (32, 48, 2))] * 4, {0: 2, 1: 2})


def _shed_hints(pkg, tmp):
    f = _Fleet(pkg, tmp, [["shed", "hold"], ["shed", "hold"]], [2.5, 0.5],
               max_inflight_per_replica=1, default_retry_after_s=0.25)
    try:
        r0 = f.submit(_img(), _img()).result(WAIT_S)
        r1 = f.submit(_img(), _img()).result(WAIT_S)
        f.submit(_img(), _img())  # held by replica 0
        f.submit(_img(), _img())  # held by replica 1
        r2 = f.submit(_img(), _img()).result(WAIT_S)  # shed at the router
        return [_brief(r) + (r.detail,) for r in (r0, r1, r2)], f.router.report()["shed_hints"]
    finally:
        f.close()


def test_fleet_shed_hint_is_the_max_over_consulted_replicas_as_jax(tmp_path):
    j, p = _both(_shed_hints, str(tmp_path))
    assert p == j
    (r0, r1, r2), hints = p
    assert r0[:2] == ("shed", 2.5) and r1[:2] == ("shed", 2.5)
    assert r2[0] == "shed" and r2[3].startswith("fleet at capacity") and r2[1] >= 2.5
    assert hints == {0: 2.5, 1: 0.5}


def _no_admittable(pkg, tmp):
    f = _Fleet(pkg, tmp, [["ok"]])
    try:
        f.state(0, "DEAD")
        r = f.submit(_img(), _img()).result(WAIT_S)
        bad = f.submit(np.zeros((4, 4)), np.zeros((4, 4))).result(WAIT_S)
        return _brief(r) + (r.detail,), (bad.status, bad.detail)
    finally:
        f.close()


def test_no_admittable_replica_sheds_and_bad_input_errors_as_jax(tmp_path):
    j, p = _both(_no_admittable, str(tmp_path))
    assert p == j
    assert p[0] == ("shed", 0.25, None, "no admittable replica")
    assert p[1][0] == "error"


def _scale_eta(pkg, tmp):
    f = _Fleet(pkg, tmp, [["hold"]], max_inflight_per_replica=1, default_retry_after_s=0.25,
               min_replicas=1, max_replicas=2)
    try:
        out = []
        f.submit(_img(), _img())  # held: at capacity
        out.append(f.submit(_img(), _img()).result(WAIT_S).retry_after_s)
        f.router.set_scale_eta(12.5)
        out.append(f.submit(_img(), _img()).result(WAIT_S).retry_after_s)
        f.router.set_scale_eta(None)
        out.append(f.submit(_img(), _img()).result(WAIT_S).retry_after_s)
        scaler = pkg.fleet.FleetAutoscaler(f.cfg, f.sup, f.router,
                                           telemetry=pkg.obs.Telemetry())
        rec = scaler.tick()
        out.append((rec["decision"], rec["occupancy"], rec["eta_published"]))
        out.append(f.submit(_img(), _img()).result(WAIT_S).retry_after_s)
        scaler.stop()
        out.append(f.submit(_img(), _img()).result(WAIT_S).retry_after_s)
        return out
    finally:
        f.close()


def test_shed_hint_floored_at_the_autoscalers_eta_as_jax(tmp_path):
    j, p = _both(_scale_eta, str(tmp_path))
    assert p == j == [0.25, 12.5, 0.25, ("hold", 1.0, True), 20.0, 0.25]


def _affinity(pkg, tmp):
    f = _Fleet(pkg, tmp, [["ok"], ["ok"], ["ok"]])
    try:
        for fi in range(3):
            for s in ("sa", "sb", "sc", "sd"):
                assert f.submit(_img(), _img(), stream_id=s,
                                frame_index=fi).result(WAIT_S).status == "ok"
        homes = {s: sorted(i for i, fk in enumerate(f.fakes)
                           if any(h.get("stream_id") == s for h in fk.seen))
                 for s in ("sa", "sb", "sc", "sd")}
        frames = {s: [h.get("frame_index") for fk in f.fakes for h in fk.seen
                      if h.get("stream_id") == s] for s in homes}
        return f.router.report()["affinity"], homes, frames
    finally:
        f.close()


def test_stream_affinity_is_sticky_rendezvous_as_jax(tmp_path):
    j, p = _both(_affinity, str(tmp_path))
    assert p == j
    aff, homes, frames = p
    for s, home in aff.items():
        assert homes[s] == [home] and home == prouter.rendezvous_choice(s, [0, 1, 2])
        assert frames[s] == [0, 1, 2]


def _warm_routing(pkg, tmp):
    f = _Fleet(pkg, tmp, [["ok"], ["ok"]])
    try:
        f.sup.replicas[1].last_healthz = {"overall": "ready",
                                          "warmed": [[32, 48, 1, 2], [32, 48, 2, 2]]}
        for _ in range(3):
            assert f.submit(_img(), _img()).result(WAIT_S).status == "ok"
        first = dict(f.router.report()["per_replica_dispatched"])
        assert f.submit(_img(40, 56), _img(40, 56)).result(WAIT_S).status == "ok"
        return first, f.router.report()["per_replica_dispatched"]
    finally:
        f.close()


def test_shape_aware_routing_prefers_the_warm_replica_as_jax(tmp_path):
    j, p = _both(_warm_routing, str(tmp_path))
    assert p == j == ({0: 0, 1: 3}, {0: 1, 1: 3})


def _draining(pkg, tmp):
    f = _Fleet(pkg, tmp, [["ok"], ["ok"]])
    try:
        f.state(0, "DRAINING")
        rs = [f.submit(_img(), _img()).result(WAIT_S).status for _ in range(3)]
        return rs, f.router.report()["per_replica_dispatched"]
    finally:
        f.close()


def test_draining_replica_gets_nothing_new_as_jax(tmp_path):
    j, p = _both(_draining, str(tmp_path))
    assert p == j == (["ok"] * 3, {0: 0, 1: 3})


def _failover(pkg, tmp, deadline_s, n_replicas):
    plans = [["hold"], ["ok"]][:n_replicas]
    f = _Fleet(pkg, tmp, plans, max_failovers=1)
    try:
        if n_replicas == 2:
            f.state(1, "DEAD")  # route the request to replica 0, which holds it
        h = f.submit(_img(), _img(), deadline_s=deadline_s)
        time.sleep(0.15)
        if n_replicas == 2:
            f.state(1, "UP")
        f.state(0, "DEAD")
        f.router._on_replica_death(0, "test kill")
        r = h.result(WAIT_S)
        st = f.router.stats
        return (r.status, r.detail.split(";")[-1].strip(), st["failovers"],
                st["failover_errors"], st["failover_sheds"])
    finally:
        f.close()


@pytest.mark.parametrize("deadline_s,n_replicas,want", [
    (30.0, 2, ("ok", "", 1, 0, 0)),  # re-dispatched to the survivor
    (0.05, 2, ("error", "deadline expired before failover", 0, 1, 0)),
    (30.0, 1, ("shed", "no admittable replica for failover", 0, 0, 1)),
])
def test_failover_within_deadline_and_budget_as_jax(tmp_path, deadline_s, n_replicas, want):
    j, p = _both(_failover, str(tmp_path), deadline_s, n_replicas)
    assert p == j == want


def _drain(pkg, tmp):
    f = _Fleet(pkg, tmp, [["hold"]])
    try:
        h = f.submit(_img(), _img())
        out = f.router.drain(timeout=0.3)
        r = h.result(WAIT_S)
        r2 = f.submit(_img(), _img()).result(WAIT_S)
        return r.status, r2.status, r2.detail, out["stats"]["routed"]
    finally:
        for fk in f.fakes:
            fk.close()


def test_router_drain_sheds_new_and_errors_the_stuck_as_jax(tmp_path):
    j, p = _both(_drain, str(tmp_path))
    assert p == j == ("error", "shed", "router draining", 1)


# ---------------------------------------------------- trace propagation


def _traces(pkg, tmp):
    f = _Fleet(pkg, tmp, [["ok"]])
    try:
        rs = [f.submit(_img(), _img()).result(WAIT_S) for _ in range(2)]
        ctxs = [pkg.obs.TraceContext.from_wire(h.get("trace")) for h in f.fakes[0].seen]
        roots = f.router._tel.tracer.records("fleet_request")
        journey = f.router._tel.tracer.for_attr(trace_id=ctxs[0].trace_id)
        deadline = time.monotonic() + WAIT_S
        while not f.router.clock_offsets() and time.monotonic() < deadline:
            time.sleep(0.01)
        offsets = f.router.clock_offsets()
        stages = pkg.obs.telemetry_report(f.router._tel)["stages"]
        return dict(
            statuses=[r.status for r in rs],
            distinct=len({c.trace_id for c in ctxs}),
            sent=all(c.sent_s is not None for c in ctxs),
            spans=[c.span_id for c in ctxs],
            roots=sorted(r["attrs"]["trace_id"] for r in roots) == sorted(
                c.trace_id for c in ctxs),
            journey=sorted({r["name"] for r in journey}),
            offsets=sorted(offsets), offset_small=abs(offsets[0]) < 0.25,
            hops=sorted(k for k in stages if k.startswith("fleet_")),
            hops_ok=all(stages[k]["count"] >= 1 and stages[k]["p50_ms"] >= 0
                        for k in stages if k.startswith("fleet_")))
    finally:
        f.close()


def test_one_trace_per_request_handshake_and_hops_as_jax(tmp_path):
    j, p = _both(_traces, str(tmp_path))
    assert p == j
    assert p["statuses"] == ["ok", "ok"] and p["distinct"] == 2 and p["sent"]
    assert p["spans"] == ["router-0", "router-1"] and p["roots"] and p["offset_small"]
    assert p["journey"] == ["fleet_dispatch", "fleet_request"]
    assert p["hops"] == ["fleet_e2e", "fleet_hop_replica", "fleet_hop_return",
                         "fleet_hop_router_queue",
                         "fleet_hop_wire", "fleet_request"] and p["hops_ok"]


def _toggle(pkg, tmp):
    f = _Fleet(pkg, tmp, [["ok"], ["ok"]])
    try:
        for _ in range(2):  # the toggle rides live links
            assert f.submit(_img(), _img()).result(WAIT_S).status == "ok"
        off = f.router.set_fleet_telemetry(False, timeout=WAIT_S)
        seen_off = [fk.telemetry_enabled for fk in f.fakes]
        on = f.router.set_fleet_telemetry(True, timeout=WAIT_S)
        return off, seen_off, on, [fk.telemetry_enabled for fk in f.fakes]
    finally:
        f.close()


def test_set_fleet_telemetry_toggles_replicas_in_place_as_jax(tmp_path):
    j, p = _both(_toggle, str(tmp_path))
    assert p == j == (2, [False, False], 2, [True, True])


def test_router_drain_and_failover_bank_dumps_the_fleet_readers_stitch(tmp_path):
    """The port router's ``replica_failover`` and ``router_drain`` dumps,
    read back with the port's aggregation and the repo's postmortem."""
    import importlib.util

    cfg = pfleet.FleetConfig(base_dir=str(tmp_path), n_replicas=2, max_failovers=1)
    sup = pfleet.ReplicaSupervisor(cfg, telemetry=pobs.Telemetry())
    fakes = [_FakeReplica(cfg.replica(0), ["hold"]), _FakeReplica(cfg.replica(1), ["ok"])]
    for h in sup.replicas:
        h.state, h.last_healthz = preplica.UP, {"overall": "ready"}
    tel = pobs.Telemetry(flight_dir=str(tmp_path / "router_flight"))
    router = pfleet.FleetRouter(cfg, sup, telemetry=tel)
    try:
        sup.replicas[1].state = preplica.DEAD
        h = router.submit(_img(), _img(), deadline_s=30.0)
        time.sleep(0.15)
        sup.replicas[1].state = preplica.UP
        sup.replicas[0].state = preplica.DEAD
        router._on_replica_death(0, "test kill")
        assert h.result(WAIT_S).status == "ok"
        deadline = time.monotonic() + WAIT_S
        while len(router.clock_offsets()) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        router.drain()
        for f in fakes:
            f.close()
    triggers = sorted(n.split("_20")[0] for n in os.listdir(tmp_path / "router_flight"))
    assert triggers == ["flight_replica_failover", "flight_router_drain"]
    collected = pobs.collect_fleet_records(str(tmp_path))
    assert "router" in collected["origins"] and set(collected["clock_offsets"]) == {0, 1}
    traces = pobs.fleet_traces(collected)
    assert len(traces) == 1 and traces[0]["origins"] == ["router"]
    spec = importlib.util.spec_from_file_location(
        "postmortem", os.path.join(_REPO, "scripts", "postmortem.py"))
    pm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pm)
    dump = pobs.load_dump(pm.select_dump(str(tmp_path / "router_flight")))
    assert dump["trigger"] == "router_drain"
    failover = [n for n in os.listdir(tmp_path / "router_flight") if "failover" in n][0]
    dump = pobs.load_dump(str(tmp_path / "router_flight" / failover))
    assert dump["context"]["request_ids"] == [0] and dump["context"]["replica"] == 0


# ---------------------------------------------------------- fleet chaos


def _replay_chaos(pkg, tmp):
    f = _Fleet(pkg, tmp, [["ok"], ["ok"]])
    calls = []
    f.sup.kill = lambda i: calls.append(("kill", i))
    f.sup.stall = lambda i: calls.append(("stall", i))
    f.sup.drain = lambda i: calls.append(("drain", i)) or {}
    try:
        spec = pkg.ChaosSpec.parse("killreplica@1,stallreplica@2,drainreplica@3")
        items = [{"image1": _img(), "image2": _img()} for _ in range(4)]
        handles = pkg.fleet.replay_fleet(f.router, items, supervisor=f.sup, chaos=spec)
        statuses = [h.result(WAIT_S).status for h in handles]
        deadline = time.monotonic() + WAIT_S
        while len(calls) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)  # the drain fires on a thread of its own
        # Which replica carries a submission depends on which answers came
        # back before it (least in flight first), so the two packages are
        # held to the rule, not to one routing.
        carriers = [f.router.replica_of(n) for n in range(4)]
        hit = dict(calls) == {"kill": carriers[1], "stall": carriers[2], "drain": carriers[3]}
        return statuses, sorted(kind for kind, _ in calls), hit
    finally:
        f.close()


def test_replay_fleet_fires_at_the_carrier_of_submission_n_as_jax(tmp_path):
    j, p = _both(_replay_chaos, str(tmp_path))
    assert p == j == (["ok"] * 4, ["drain", "kill", "stall"], True)


def _host_chaos(pkg, tmp):
    f = _Fleet(pkg, tmp, [["ok"], ["ok"]], hosts=("hA", "hB"))

    class _Manager:
        def __init__(self, cfg):
            self.cfg, self.calls = cfg, []

        def host_of(self, i):
            return self.cfg.host_of(i)

        def partition(self, host):
            self.calls.append(("partition", host))

        def kill_agent(self, host):
            self.calls.append(("kill_agent", host))

    mgr = _Manager(f.cfg)
    try:
        spec = pkg.ChaosSpec.parse("partitionhost@1,killsupervisor@2")
        items = [{"image1": _img(), "image2": _img()} for _ in range(4)]
        handles = pkg.fleet.replay_fleet(f.router, items, chaos=spec, manager=mgr)
        statuses = [h.result(WAIT_S).status for h in handles]
        hosts = [f.cfg.host_of(f.router.replica_of(n)) for n in range(4)]
        hit = mgr.calls == [("partition", hosts[1]), ("kill_agent", hosts[2])]
        return statuses, [kind for kind, _ in mgr.calls], hit
    finally:
        f.close()


def test_host_chaos_kinds_hit_the_carriers_host_as_jax(tmp_path):
    j, p = _both(_host_chaos, str(tmp_path))
    assert p == j == (["ok"] * 4, ["partition", "kill_agent"], True)


# ---------------------------------------------------------- host agents

# A fake replica process: rewrites its healthz file as ready every 50 ms
# until killed (the agents only read healthz files and send signals).
_FAKE_REPLICA = (
    "import json, os, sys, time\n"
    "path = sys.argv[sys.argv.index('--healthz_file') + 1]\n"
    "while True:\n"
    "    tmp = path + '.tmp'\n"
    "    with open(tmp, 'w') as fh:\n"
    "        json.dump({'overall': 'ready', 'time_unix_s': time.time(),\n"
    "                   'pid': os.getpid()}, fh)\n"
    "    os.replace(tmp, path)\n"
    "    time.sleep(0.05)\n"
)


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


def test_fleet_manager_fences_a_partitioned_host_and_fails_over(tmp_path):
    """Two host agents (``python -m raft_ncup_tpu_torch.fleet.host_supervisor``)
    over fake replicas: both republish ready; a partitioned host goes
    silent past the staleness bound, is declared dead, its replica's pid
    is killed (fenced) and the router's death hook fires for it."""
    cfg = pfleet.FleetConfig(base_dir=str(tmp_path), n_replicas=2, hosts=("hA", "hB"),
                             poll_interval_s=0.05, snapshot_interval_s=0.25,
                             stale_after_factor=4.0, spawn_timeout_s=60.0,
                             drain_timeout_s=10.0)
    deaths = []
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1")
    mgr = pfleet.FleetManager(cfg, argv_prefix=[sys.executable, "-c", _FAKE_REPLICA],
                              env=env, on_death=lambda i, why: deaths.append(i),
                              telemetry=pobs.Telemetry())
    try:
        mgr.start()
        assert [h.state for h in mgr.replicas] == [preplica.UP, preplica.UP]
        pids = [h.remote_pid for h in mgr.replicas]
        assert all(isinstance(p, int) and _proc_alive(p) for p in pids)
        assert [mgr.host_of(i) for i in range(2)] == ["hA", "hB"]
        mgr.partition("hB")
        deadline = time.monotonic() + WAIT_S
        while 1 not in deaths and time.monotonic() < deadline:
            time.sleep(0.05)
        assert deaths == [1]
        assert mgr.handle(1).state == preplica.DEAD and mgr.handle(0).state == preplica.UP
        deadline = time.monotonic() + WAIT_S
        while _proc_alive(pids[1]) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not _proc_alive(pids[1]) and _proc_alive(pids[0])
        rep = mgr.report()
        assert rep["dead_hosts"] == ["hB"] and rep["partitioned_hosts"] == ["hB"]
    finally:
        mgr.stop(drain=True)
    assert not any(_proc_alive(p) for p in pids)
