"""Multi-host fleet control plane: one agent per named host, one
manager beside the router (port of
``raft_ncup_tpu/fleet/host_supervisor.py``).

A UDS fleet is one supervisor and N replicas on one machine. A TCP fleet
spreads the replicas over named hosts, and the split this module
implements is the smallest one that keeps every single-host contract
intact:

- :class:`HostSupervisor` — the per-host AGENT. It wraps the
  UNMODIFIED :class:`~raft_ncup_tpu_torch.fleet.replica.ReplicaSupervisor`
  (spawn/healthz-staleness/drain/restart/circuit-breaker all reused,
  not re-implemented) around the replica slots its manifest places on
  this host, and REPUBLISHES their healthz over the wire — healthz
  files are host-local by design, so a remote manager can only see
  them through the agent. The agent is driven by a JSON manifest
  (:meth:`FleetConfig.host_manifest`) instead of the full FleetConfig:
  a host reconstructs only what it supervises.
- :class:`FleetManager` — the router-side view of the whole fleet. It
  spawns one agent per host (through the same :class:`ChildProcess`
  every other multi-process harness uses), polls each agent's control
  endpoint for the republished healthz, and mirrors the results into
  ordinary :class:`ReplicaHandle` objects — so ``FleetRouter`` and
  ``FleetAutoscaler`` run against a multi-host fleet unmodified (the
  manager duck-types the supervisor surface they read: ``replicas``,
  ``handle(i)``, ``add_replica``/``remove_replica``, ``_on_death``).

The fleet-level staleness contract is the per-replica one lifted one
level: a host whose agent has not successfully republished within
``stale_after_s`` is presumed DEAD — partitioned, agent-killed, or
wedged, the manager cannot tell and must not care. Every replica
placed there is declared dead (router failover fires through the same
``on_death`` hook as a local death), and the host is FENCED: the last
republished snapshot carries the replica pids, and the manager
SIGKILLs them (plus the agent child) so a replica on the far side of a
healed partition can never answer a request the router already
re-dispatched. Chaos drives exactly these paths: ``partitionhost@N``
(:meth:`FleetManager.partition` — both link directions drop, staleness
does the rest) and ``killsupervisor@N`` (:meth:`FleetManager.kill_agent`
— the agent dies, its replicas linger as orphans until the reap).

Host-only stdlib (no torch): agents and the manager move JSON frames and
signals; neither can touch a device tensor.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from raft_ncup_tpu_torch.fleet import wire
from raft_ncup_tpu_torch.fleet.replica import (
    DEAD,
    SPAWNING,
    UP,
    ChildProcess,
    ReplicaHandle,
    ReplicaSupervisor,
)
from raft_ncup_tpu_torch.fleet.topology import FleetConfig, ReplicaSpec

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


class ManifestConfig:
    """Adapter: a :meth:`FleetConfig.host_manifest` dict presented as
    the config surface :class:`ReplicaSupervisor` reads — ``replica(i)``
    / ``replica_argv(i)`` / the supervision scalars. The agent process
    never holds a FleetConfig; its manifest names only its own slots,
    and this adapter is what keeps the supervisor itself unmodified."""

    def __init__(self, manifest: dict):
        self._m = manifest
        self.base_dir = manifest["base_dir"]
        self.poll_interval_s = float(manifest["poll_interval_s"])
        self.spawn_timeout_s = float(manifest["spawn_timeout_s"])
        self.drain_timeout_s = float(manifest["drain_timeout_s"])
        self.snapshot_interval_s = float(manifest["snapshot_interval_s"])
        self.stale_after_s = float(manifest["stale_after_s"])
        self.max_restarts = int(manifest["max_restarts"])
        self.restart_backoff_s = float(manifest["restart_backoff_s"])
        self.restart_backoff_max_s = float(manifest["restart_backoff_max_s"])
        self.circuit_break_after = int(manifest["circuit_break_after"])
        self._slots: Dict[int, dict] = {
            int(r["index"]): r for r in manifest["replicas"]
        }
        self.n_replicas = len(self._slots)

    @property
    def host(self) -> str:
        return self._m.get("host", "")

    @property
    def control(self) -> str:
        return self._m["control"]

    def start_indices(self) -> List[int]:
        """The slots that spawn at agent startup (``n_replicas`` of the
        fleet topology); the rest are declared scale-up capacity."""
        return sorted(i for i, r in self._slots.items() if r.get("start"))

    def all_indices(self) -> List[int]:
        return sorted(self._slots)

    def replica(self, i: int) -> ReplicaSpec:
        r = self._slots[i]
        argv = r["argv"]
        # A mesh slot's (data, spatial) rides its argv's --mesh D,S.
        mesh = (tuple(int(x) for x in argv[argv.index("--mesh") + 1].split(","))
                if "--mesh" in argv else None)
        return ReplicaSpec(
            index=i,
            socket_path=r["socket_path"],
            healthz_path=r["healthz_path"],
            flight_dir=r["flight_dir"],
            mesh=mesh,
            address=r["address"],
            host=self.host,
        )

    def replica_argv(self, i: int) -> list:
        return list(self._slots[i]["argv"])


class HostSupervisor:
    """The per-host agent: an unmodified ReplicaSupervisor over this
    host's slots, plus a wire control server at ``manifest.control``.

    Control frames (JSON, no array payloads; one reply per request):

    - ``{"kind": "ping"}`` → ``{"kind": "pong", "host": ...}``
    - ``{"kind": "healthz"}`` → the republish: every supervised slot's
      supervisor snapshot + last healthz payload + pid, stamped with
      the agent's ``time_unix_s`` (the fleet-level staleness clock)
    - ``{"kind": "spawn", "index": i}`` → ``add_replica(i)``
    - ``{"kind": "drain", "index": i}`` → ``remove_replica(i)``
      (graceful: the replica drain contract, run host-locally)
    - ``{"kind": "stop"}`` → drain everything and shut the agent down
    """

    def __init__(
        self, manifest: dict, *,
        argv_prefix: Optional[List[str]] = None,
        env: Optional[dict] = None,
        telemetry=None,
    ):
        self.cfg = ManifestConfig(manifest)
        self.sup = ReplicaSupervisor(
            self.cfg,  # type: ignore[arg-type]  # duck-typed adapter
            argv_prefix=argv_prefix,
            env=env,
            telemetry=telemetry,
            indices=self.cfg.start_indices(),
        )
        self._transport = wire.Transport.parse(self.cfg.control)
        self._lsock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._conn_threads: List[threading.Thread] = []

    # ----------------------------------------------------------- serving

    def start(self, wait_ready: bool = True) -> "HostSupervisor":
        self.sup.start(wait_ready=wait_ready)
        self._lsock = self._transport.listen(16)
        self._lsock.settimeout(0.2)
        t = threading.Thread(
            target=self._accept_loop,
            name=f"host-agent-{self.cfg.host or 'local'}",
            daemon=True,
        )
        t.start()
        self._accept_thread = t
        return self

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # listener closed at stop()
            t = threading.Thread(
                target=self._serve_conn, args=(conn,),
                name="host-agent-conn", daemon=True,
            )
            t.start()
            self._conn_threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            with conn:
                while not self._stop.is_set():
                    msg = wire.recv_msg(conn)
                    if msg is None:
                        return
                    header, _ = msg
                    reply = self._handle(header)
                    wire.send_msg(conn, reply)
                    if header.get("kind") == "stop":
                        return
        except (ConnectionError, OSError, ValueError) as e:
            # A torn control connection is the MANAGER'S failure to
            # observe, not the agent's failure to serve — log and keep
            # supervising.
            print(f"host agent conn error: {e!r}", file=sys.stderr)

    def _handle(self, header: dict) -> dict:
        kind = header.get("kind")
        if kind == "ping":
            return {"kind": "pong", "host": self.cfg.host}
        if kind == "healthz":
            return self.republish()
        if kind == "spawn":
            raw_index = header.get("index")
            if raw_index is None:
                return {"kind": "error", "op": "spawn",
                        "error": "spawn frame missing 'index'"}
            i = int(raw_index)
            try:
                self.sup.add_replica(i, wait_ready=False)
                return {"kind": "ok", "op": "spawn", "index": i}
            except (ValueError, OSError) as e:
                return {"kind": "error", "op": "spawn", "index": i,
                        "error": repr(e)}
            except KeyError as e:
                return {"kind": "error", "op": "spawn", "index": i,
                        "error": f"slot not in manifest: {e!r}"}
        if kind == "drain":
            raw_index = header.get("index")
            if raw_index is None:
                return {"kind": "error", "op": "drain",
                        "error": "drain frame missing 'index'"}
            i = int(raw_index)
            try:
                result = self.sup.remove_replica(i, drain=True)
                return {"kind": "ok", "op": "drain", "index": i,
                        "returncode": result.get("returncode")}
            except KeyError as e:
                return {"kind": "error", "op": "drain", "index": i,
                        "error": repr(e)}
        if kind == "stop":
            self._stop.set()
            return {"kind": "ok", "op": "stop"}
        return {"kind": "error", "error": f"unknown control kind {kind!r}"}

    def republish(self) -> dict:
        """The wire republish: what a remote manager knows about this
        host. Every field a consumer reads with ``.get`` (the wire
        schema-evolution contract)."""
        replicas = {}
        with self.sup._lock:
            handles = list(self.sup.replicas)
        for h in handles:
            replicas[str(h.index)] = {
                **h.snapshot(),
                "healthz": h.last_healthz,
            }
        return {
            "kind": "healthz",
            "host": self.cfg.host,
            "time_unix_s": time.time(),
            "replicas": replicas,
        }

    def run(self) -> Dict[int, dict]:
        """Serve until a ``stop`` control frame or SIGTERM, then drain
        everything (the agent's own drain contract: its replicas exit
        75 before the agent does). Returns the final reports."""
        signal.signal(signal.SIGTERM, lambda *_: self._stop.set())
        while not self._stop.wait(0.2):
            pass
        return self.stop()

    def stop(self, drain: bool = True) -> Dict[int, dict]:
        self._stop.set()
        if self._lsock is not None:
            self._lsock.close()
            self._transport.cleanup()
        return self.sup.stop(drain=drain)


class FleetManager:
    """The router-side control plane of a multi-host fleet: spawns one
    :class:`HostSupervisor` agent per named host, mirrors their wire
    republishes into local :class:`ReplicaHandle` objects, and enforces
    the FLEET-level staleness contract (silent host ⇒ dead host ⇒
    fence + failover). Duck-types the supervisor surface ``FleetRouter``
    and ``FleetAutoscaler`` read."""

    def __init__(
        self,
        cfg: FleetConfig,
        *,
        argv_prefix: Optional[List[str]] = None,
        env: Optional[dict] = None,
        on_death: Optional[Callable[[int, str], None]] = None,
        telemetry=None,
    ):
        from raft_ncup_tpu_torch.observability import get_telemetry

        if not cfg.hosts:
            raise ValueError(
                "FleetManager needs named hosts (single-host fleets "
                "use ReplicaSupervisor directly)"
            )
        self.cfg = cfg
        self._argv_prefix = argv_prefix
        self._env = env
        self._on_death = on_death
        self._tel = telemetry if telemetry is not None else get_telemetry()
        self._lock = threading.RLock()
        self.replicas: List[ReplicaHandle] = [
            ReplicaHandle(cfg.replica(i)) for i in range(cfg.n_replicas)
        ]
        self.retired: List[ReplicaHandle] = []
        self.agents: Dict[str, ChildProcess] = {}
        self._last_heard: Dict[str, float] = {}  # host -> monotonic
        self._heard_once: set = set()  # hosts that have republished
        self._last_snapshot: Dict[str, dict] = {}  # host -> republish
        self._partitioned: set = set()
        self._dead_hosts: set = set()
        self._poll_stop = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- handles

    def handle(self, i: int) -> ReplicaHandle:
        with self._lock:
            for h in self.replicas:
                if h.index == i:
                    return h
        raise KeyError(f"no live replica handle for index {i}")

    def host_of(self, i: int) -> str:
        return self.cfg.host_of(i)

    # ------------------------------------------------------------- spawn

    def start(self, wait_ready: bool = True) -> "FleetManager":
        os.makedirs(self.cfg.base_dir, exist_ok=True)
        for host in self.cfg.hosts:
            manifest = self.cfg.host_manifest(host)
            path = os.path.join(
                self.cfg.base_dir, f"host_{host}.manifest.json"
            )
            with open(path, "w", encoding="utf-8") as fh:
                json.dump(manifest, fh, indent=2)
            argv = [
                sys.executable, "-m",
                "raft_ncup_tpu_torch.fleet.host_supervisor",
                "--manifest", path,
            ]
            if self._argv_prefix is not None:
                argv += ["--replica_argv_prefix",
                         json.dumps(self._argv_prefix)]
            self.agents[host] = ChildProcess(
                argv, name=f"host-agent-{host}", env=self._env,
                cwd=_REPO_ROOT,
            ).spawn()
            self._last_heard[host] = time.monotonic()
            self._tel.event(
                "fleet_host_agent_spawned", host=host,
                pid=self.agents[host].pid,
            )
        if wait_ready:
            self.wait_ready()
        self._poll_thread = threading.Thread(
            target=self._poll_loop, name="fleet-manager", daemon=True
        )
        self._poll_thread.start()
        return self

    def wait_ready(self, timeout: Optional[float] = None) -> None:
        """Block until every initially-started replica republishes UP
        (the agents run the real READY gates; the manager only needs to
        hear about it)."""
        deadline = time.monotonic() + (
            self.cfg.spawn_timeout_s if timeout is None else timeout
        )
        with self._lock:
            pending = {h.index for h in self.replicas}
        while pending:
            for host in self.cfg.hosts:
                agent = self.agents.get(host)
                if agent is not None and not agent.running:
                    rc, out, err = agent.reap(timeout=5.0)
                    self.stop(drain=False)
                    raise RuntimeError(
                        f"host agent {host!r} died during warmup "
                        f"(rc={rc}):\n{err[-2000:]}"
                    )
                self._poll_host(host)
            with self._lock:
                pending = {
                    h.index for h in self.replicas if h.state != UP
                }
            if not pending:
                return
            if time.monotonic() > deadline:
                self.stop(drain=False)
                raise TimeoutError(
                    f"replicas {sorted(pending)} not republished ready "
                    f"within {self.cfg.spawn_timeout_s}s"
                )
            time.sleep(self.cfg.poll_interval_s)

    # ----------------------------------------------------------- polling

    def _agent_call(self, host: str, header: dict,
                    timeout_s: float = 5.0) -> Optional[dict]:
        """One control request/reply to ``host``'s agent; None on any
        wire failure (the staleness clock, not the caller, decides what
        silence means)."""
        if host in self._partitioned:
            return None
        try:
            transport = wire.Transport.parse(
                self.cfg.host_control_address(host)
            )
            sock = transport.connect(timeout_s=timeout_s)
            try:
                wire.set_read_timeout(sock, timeout_s)
                wire.send_msg(sock, header)
                msg = wire.recv_msg(sock)
            finally:
                sock.close()
            return None if msg is None else msg[0]
        except (ConnectionError, OSError, ValueError) as e:
            self._tel.event(
                "fleet_host_agent_unreachable", host=host, error=repr(e)
            )
            return None

    def _poll_host(self, host: str) -> None:
        with self._lock:
            if host in self._dead_hosts:
                return
        reply = self._agent_call(host, {"kind": "healthz"})
        now = time.monotonic()
        if reply is not None and reply.get("kind") == "healthz":
            self._last_heard[host] = now
            self._heard_once.add(host)
            self._last_snapshot[host] = reply
            self._mirror(host, reply)
            return
        # Fleet-level staleness: steady-state silence past the
        # per-replica bound ⇒ dead host. A host that has NEVER
        # republished is still booting its agent (Python startup alone
        # beats a sub-second staleness bound) and gets the spawn bound
        # instead — warmup failures surface through wait_ready, which
        # watches the agent process itself.
        bound = (
            self.cfg.stale_after_s if host in self._heard_once
            else self.cfg.spawn_timeout_s
        )
        if now - self._last_heard.get(host, now) > bound:
            self._host_death(host, "fleet-level staleness: agent silent")

    def _mirror(self, host: str, republish: dict) -> None:
        """Fold one republish into the local handles. Supervisor-side
        states travel verbatim (the agent already ran the per-replica
        staleness/restart/breaker contracts); the manager adds only the
        fleet-level view."""
        snaps = republish.get("replicas") or {}
        died = []
        with self._lock:
            for h in self.replicas:
                if self.cfg.host_of(h.index) != host:
                    continue
                snap = snaps.get(str(h.index))
                if snap is None:
                    continue
                prev = h.state
                h.state = snap.get("state", h.state)
                h.circuit_open = bool(snap.get("circuit_open"))
                h.restarts = int(snap.get("restarts", h.restarts))
                h.deaths = int(snap.get("deaths", h.deaths))
                h.stale_deaths = int(
                    snap.get("stale_deaths", h.stale_deaths)
                )
                hz = snap.get("healthz")
                if hz is not None:
                    h.last_healthz = hz
                h.remote_pid = snap.get("pid")
                if prev not in (DEAD,) and h.state == DEAD:
                    # The agent detected the death; the router still
                    # needs its failover hook fired HERE, where the
                    # pending set lives.
                    died.append(h.index)
        # Outside the lock, as ReplicaSupervisor delivers deaths: the
        # router's hook takes its own lock and calls back into this one.
        if self._on_death is not None:
            for index in died:
                self._on_death(index, "republished death")

    def _poll_loop(self) -> None:
        while not self._poll_stop.wait(self.cfg.poll_interval_s):
            try:
                for host in list(self.cfg.hosts):
                    self._poll_host(host)
            except Exception as e:
                # Observation must be visible, never fatal.
                self._tel.event(
                    "fleet_manager_poll_error", error=repr(e)
                )
                print(f"fleet manager poll error: {e!r}", file=sys.stderr)

    def poll(self) -> None:
        """One synchronous supervision pass (deterministic tests)."""
        for host in list(self.cfg.hosts):
            self._poll_host(host)

    # ------------------------------------------------- fleet-level deaths

    def _host_death(self, host: str, reason: str) -> None:
        """The fleet-level staleness contract: declare every replica on
        ``host`` dead, FENCE the host (SIGKILL the lingering pids from
        its last republish + the agent child — a zombie on the far side
        of a healed partition must never answer a re-dispatched
        request), and fire the router's failover hook."""
        with self._lock:
            if host in self._dead_hosts:
                return
            self._dead_hosts.add(host)
        self._tel.event("fleet_host_death", host=host, reason=reason)
        print(f"fleet: host {host!r} dead ({reason})", file=sys.stderr)
        self._fence(host)
        with self._lock:
            victims = [
                h for h in self.replicas
                if self.cfg.host_of(h.index) == host
                and h.state not in (DEAD,)
            ]
            for h in victims:
                h.state = DEAD
                h.deaths += 1
        for h in victims:
            self._tel.event(
                "fleet_replica_death", replica=h.index,
                reason=f"host {host}: {reason}",
            )
            if self._on_death is not None:
                self._on_death(h.index, reason)

    def _fence(self, host: str) -> None:
        snapshot = self._last_snapshot.get(host) or {}
        pids = []
        for snap in (snapshot.get("replicas") or {}).values():
            pid = snap.get("pid")
            if isinstance(pid, int):
                pids.append(pid)
        agent = self.agents.get(host)
        for pid in pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError, OSError):
                pass  # already gone — fencing is idempotent
        if agent is not None and agent.running:
            agent.kill()
            agent.wait(timeout=10.0)
        self._tel.event(
            "fleet_host_fenced", host=host, replica_pids=pids,
        )

    # --------------------------------------------------------- chaos hooks

    def partition(self, host: str) -> None:
        """Chaos ``partitionhost``: drop the control link to ``host``
        (the manager stops hearing it — and refuses reconnects, which
        is what "both directions" means for a poll-driven link). The
        staleness contract takes it from here: silence past
        ``stale_after_s`` ⇒ host death ⇒ fence ⇒ failover."""
        self._tel.event("fleet_chaos_partition_host", host=host)
        self._partitioned.add(host)

    def kill_agent(self, host: str) -> None:
        """Chaos ``killsupervisor``: SIGKILL the agent; its replicas
        linger as orphans (still heartbeating their host-local files,
        which nobody republishes anymore). Detection and reaping ride
        the same staleness → fence path as a partition."""
        self._tel.event("fleet_chaos_kill_agent", host=host)
        agent = self.agents.get(host)
        if agent is not None:
            agent.kill()
            agent.wait(timeout=10.0)

    # ------------------------------------------------- elastic forwarding

    def add_replica(self, i: int, wait_ready: bool = False,
                    timeout: Optional[float] = None) -> ReplicaHandle:
        """Scale-up slot ``i``: forwarded to its host's agent; the
        local handle mirrors SPAWNING until the republish promotes it."""
        host = self.cfg.host_of(i)
        with self._lock:
            for h in self.replicas:
                if h.index == i:
                    raise ValueError(
                        f"replica slot {i} already managed "
                        f"(state={h.state})"
                    )
            handle = ReplicaHandle(self.cfg.replica(i))
            handle.state = SPAWNING
            self.replicas.append(handle)
        reply = self._agent_call(host, {"kind": "spawn", "index": i})
        if reply is None or reply.get("kind") != "ok":
            with self._lock:
                self.replicas = [
                    h for h in self.replicas if h.index != i
                ]
            raise RuntimeError(
                f"scale-up spawn of slot {i} on host {host!r} failed: "
                f"{reply!r}"
            )
        self._tel.event("fleet_scale_up_spawn", replica=i, host=host)
        if wait_ready:
            deadline = time.monotonic() + (
                self.cfg.spawn_timeout_s if timeout is None else timeout
            )
            while handle.state == SPAWNING:
                self._poll_host(host)
                if handle.state != SPAWNING:
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"scale-up replica {i} not republished ready "
                        f"within {self.cfg.spawn_timeout_s}s"
                    )
                time.sleep(self.cfg.poll_interval_s)
        return handle

    def remove_replica(self, i: int, drain: bool = True) -> dict:
        """Scale-down slot ``i``: the DRAIN RUNS ON THE HOST (the agent
        owns the SIGTERM → DRAINING → exit-75 contract); the manager
        retires its mirror handle when the agent reports back."""
        host = self.cfg.host_of(i)
        handle = self.handle(i)
        reply = self._agent_call(
            host, {"kind": "drain", "index": i},
            timeout_s=self.cfg.drain_timeout_s,
        )
        with self._lock:
            self.replicas = [h for h in self.replicas if h.index != i]
            self.retired.append(handle)
        self._tel.event(
            "fleet_scale_down_retired", replica=i, host=host,
            returncode=None if reply is None else reply.get("returncode"),
        )
        return reply or {"observed_draining": False, "returncode": None}

    # ----------------------------------------------------------- teardown

    def stop(self, drain: bool = True) -> Dict[str, Optional[dict]]:
        self._poll_stop.set()
        if self._poll_thread is not None and self._poll_thread.is_alive():
            self._poll_thread.join(timeout=10.0)
        results: Dict[str, Optional[dict]] = {}
        with self._lock:
            dead_hosts = set(self._dead_hosts)
        for host, agent in self.agents.items():
            if host not in dead_hosts and drain:
                results[host] = self._agent_call(
                    host, {"kind": "stop"},
                    timeout_s=self.cfg.drain_timeout_s,
                )
                agent.wait(timeout=self.cfg.drain_timeout_s)
            if agent.running:
                agent.kill()
            agent.reap(timeout=10.0)
            # Belt and braces: any replica pid the last republish knew
            # about must not outlive the fleet.
            self._fence_quietly(host)
        return results

    def _fence_quietly(self, host: str) -> None:
        for snap in (
            (self._last_snapshot.get(host) or {}).get("replicas") or {}
        ).values():
            pid = snap.get("pid")
            if isinstance(pid, int):
                try:
                    os.kill(pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError, OSError):
                    pass

    def report(self) -> dict:
        with self._lock:
            snaps = [h.snapshot() for h in self.replicas]
            retired = [h.snapshot() for h in self.retired]
            dead_hosts = sorted(self._dead_hosts)
        return {
            "replicas": snaps,
            "retired": retired,
            "dead_hosts": dead_hosts,
            "partitioned_hosts": sorted(self._partitioned),
            "deaths": sum(s["deaths"] for s in snaps + retired),
            "stale_deaths": sum(
                s["stale_deaths"] for s in snaps + retired
            ),
        }

    def __enter__(self) -> "FleetManager":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m raft_ncup_tpu_torch.fleet.host_supervisor --manifest M``:
    run one host agent until stopped (control frame or SIGTERM)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--manifest", required=True,
        help="Path to the host manifest JSON "
             "(FleetConfig.host_manifest).",
    )
    parser.add_argument(
        "--replica_argv_prefix", default=None,
        help="JSON list overriding the replica spawn prefix "
             "(tests substitute a fake replica).",
    )
    args = parser.parse_args(argv)
    with open(args.manifest, encoding="utf-8") as fh:
        manifest = json.load(fh)
    prefix = (
        None if args.replica_argv_prefix is None
        else json.loads(args.replica_argv_prefix)
    )
    agent = HostSupervisor(manifest, argv_prefix=prefix)
    agent.start(wait_ready=False)
    reports = agent.run()
    print(json.dumps({
        "kind": "host_agent_final", "host": agent.cfg.host,
        "replicas": {str(k): v for k, v in reports.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
