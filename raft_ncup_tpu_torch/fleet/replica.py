"""Replica process lifecycle: spawn, healthz/liveness wait, drain, reap
— and the supervisor that keeps N of them serving (port of
``raft_ncup_tpu/fleet/replica.py``).

:class:`ChildProcess` is the port's one process-lifecycle
implementation: spawn semantics, liveness checks, signal delivery and
reap-with-timeout. The supervisor runs each replica as
``python -m raft_ncup_tpu_torch.serve --replica_socket ...`` through it,
with the repository root as the child's working directory; a slot with a
mesh of ``data * spatial`` above 1 runs as a :class:`RankGroup` of that
many rank processes, one replica whose every rank dies, drains and is
reaped with it.

:class:`ReplicaSupervisor` owns the fleet's robustness contracts:

- **healthz staleness**: a replica's healthz file older than
  ``FleetConfig.stale_after_s`` means the replica is DEAD even if the
  process still exists — a SIGSTOPped or wedged process lingers but
  cannot serve, and a supervisor that trusts process existence over the
  heartbeat routes traffic into a black hole. Stale replicas are
  SIGKILLed (the lingering process must not wake up later and answer a
  request the router already failed over) and enter the death path.
- **drain orchestration**: SIGTERM ⇒ the replica's healthz must show
  ``draining: true`` (the DRAINING health state precedes the flush by
  construction: the serve entry writes healthz at once on the signal) ⇒
  the child must exit ``EXIT_PREEMPTED`` (75). Both observations are
  recorded; a replica that breaks the contract is counted, not ignored.
- **bounded counted restart-with-backoff**: an unexpected death
  schedules a respawn after ``restart_backoff_s * 2^k`` (capped),
  at most ``max_restarts`` times, every attempt counted.
- **circuit breaker**: ``circuit_break_after`` consecutive failures
  without an intervening READY opens the breaker — the replica gets no
  restart and no traffic. A crash-looping replica that kept being
  restarted and kept receiving requests would convert one bad process
  into fleet-wide tail latency.

Host-only stdlib (no torch): the supervisor reads JSON heartbeats and
sends signals; it can never touch a device tensor.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from raft_ncup_tpu_torch.fleet.topology import FleetConfig, ReplicaSpec

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

# Replica states (supervisor-side view; the replica's own health states
# live inside its healthz file).
SPAWNING = "spawning"   # process started, healthz not READY yet
UP = "up"               # fresh healthz, overall ready/degraded
DRAINING = "draining"   # SIGTERM sent, drain contract in progress
DEAD = "dead"           # unexpected death, restart pending
EXITED = "exited"       # clean exit (drain completed)
BROKEN = "broken"       # circuit open or restart budget exhausted


def read_healthz(path: str) -> Optional[dict]:
    """One healthz poll: the parsed dict, or None when the file is
    missing or unparsable (an atomically-replaced file is never torn,
    so unparsable means not-yet-written or foreign)."""
    try:
        with open(path, encoding="utf-8") as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def healthz_fresh(
    hz: Optional[dict], stale_after_s: float,
    now_unix: Optional[float] = None,
) -> bool:
    """The staleness contract: a healthz payload whose ``time_unix_s``
    is older than ``stale_after_s`` (default 2x the snapshot cadence —
    the schema's own ``stale_after_s`` field) describes a replica that
    must be presumed dead, even if its process lingers."""
    if hz is None:
        return False
    ts = hz.get("time_unix_s")
    if not isinstance(ts, (int, float)):
        return False
    now = time.time() if now_unix is None else now_unix
    return (now - ts) <= stale_after_s


class ChildProcess:
    """One spawned child: argv in, (returncode, stdout, stderr) out.

    Thin, deliberately boring wrapper over ``subprocess.Popen`` so every
    multi-process harness in the repo shares one spawn/liveness/signal/
    reap implementation. stdout/stderr are captured via pipes and
    harvested at :meth:`reap` (drainer threads keep the pipes from
    filling while the child lives).
    """

    def __init__(
        self,
        argv: List[str],
        *,
        name: str = "child",
        env: Optional[dict] = None,
        cwd: Optional[str] = None,
    ):
        self.argv = list(argv)
        self.name = name
        self.env = env
        self.cwd = cwd
        self.proc: Optional[subprocess.Popen] = None
        self._out_chunks: List[str] = []
        self._err_chunks: List[str] = []
        self._drainers: List[threading.Thread] = []

    # ------------------------------------------------------------ lifecycle

    def spawn(self) -> "ChildProcess":
        if self.proc is not None:
            raise RuntimeError(f"{self.name}: already spawned")
        self.proc = subprocess.Popen(
            self.argv,
            env=self.env,
            cwd=self.cwd,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for stream, chunks in (
            (self.proc.stdout, self._out_chunks),
            (self.proc.stderr, self._err_chunks),
        ):
            t = threading.Thread(
                target=self._drain_pipe, args=(stream, chunks),
                name=f"{self.name}-pipe", daemon=True,
            )
            t.start()
            self._drainers.append(t)
        return self

    @staticmethod
    def _drain_pipe(stream, chunks: List[str]) -> None:
        try:
            for line in stream:
                chunks.append(line)
        except ValueError:
            # Pipe closed under us at reap — everything readable was read.
            pass

    @property
    def pid(self) -> Optional[int]:
        return None if self.proc is None else self.proc.pid

    @property
    def running(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    @property
    def returncode(self) -> Optional[int]:
        return None if self.proc is None else self.proc.poll()

    # -------------------------------------------------------------- signals

    def _signal(self, sig: int) -> bool:
        if self.proc is None or self.proc.poll() is not None:
            return False
        try:
            self.proc.send_signal(sig)
            return True
        except (ProcessLookupError, OSError):
            return False

    def terminate(self) -> bool:
        """SIGTERM — the graceful-drain contract signal."""
        return self._signal(signal.SIGTERM)

    def kill(self) -> bool:
        """SIGKILL — no drain, no flush, no goodbye (chaos + staleness
        escalation)."""
        return self._signal(signal.SIGKILL)

    def suspend(self) -> bool:
        """SIGSTOP — the process lingers but cannot serve (the exact
        scenario the healthz staleness contract exists for)."""
        return self._signal(signal.SIGSTOP)

    def resume(self) -> bool:
        return self._signal(signal.SIGCONT)

    # ----------------------------------------------------------------- reap

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        if self.proc is None:
            return None
        try:
            return self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            return None

    def reap(self, timeout: Optional[float] = None):
        """Wait (bounded), escalating to SIGKILL on timeout; returns
        ``(returncode, stdout, stderr)``. Idempotent."""
        if self.proc is None:
            return None, "", ""
        rc = self.wait(timeout)
        if rc is None:
            self.kill()
            rc = self.proc.wait()
        for t in self._drainers:
            t.join(timeout=5.0)
        for stream in (self.proc.stdout, self.proc.stderr):
            if stream is not None:
                stream.close()
        return rc, "".join(self._out_chunks), "".join(self._err_chunks)

    def stdout_so_far(self) -> str:
        return "".join(self._out_chunks)

    def stderr_so_far(self) -> str:
        return "".join(self._err_chunks)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankGroup:
    """A mesh slot's ``ranks`` processes of one argv, supervised as one
    child with :class:`ChildProcess`'s interface. Each rank gets the
    launcher's environment (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, and a free port of this host as ``MASTER_PORT``);
    rank 0 is the leader, which alone binds the socket and writes healthz.
    The slot is one replica: it runs while every rank runs, and its exit
    code is the leader's, or, while the leader lives, that of the rank
    that died. ``terminate`` signals the leader (it drains, then stops the
    others); ``kill``, ``suspend`` and ``resume`` act on every rank;
    ``reap`` waits for all of them and kills what is left at the
    timeout."""

    def __init__(self, argv: List[str], ranks: int, *, name: str = "child",
                 env: Optional[dict] = None, cwd: Optional[str] = None):
        base = dict(os.environ if env is None else env)
        world = {"WORLD_SIZE": str(ranks), "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": str(_free_port())}
        self.children = [
            ChildProcess(argv, name=f"{name}-rank{r}", cwd=cwd,
                         env={**base, **world, "RANK": str(r), "LOCAL_RANK": str(r)})
            for r in range(int(ranks))
        ]

    def spawn(self) -> "RankGroup":
        for child in self.children:
            child.spawn()
        return self

    @property
    def pid(self) -> Optional[int]:
        return self.children[0].pid

    @property
    def pids(self) -> List[Optional[int]]:
        return [c.pid for c in self.children]

    @property
    def running(self) -> bool:
        return all(c.running for c in self.children)

    @property
    def returncode(self) -> Optional[int]:
        codes = [c.returncode for c in self.children]
        if codes[0] is not None:
            return codes[0]
        return next((rc for rc in codes[1:] if rc is not None), None)

    def terminate(self) -> bool:
        return self.children[0].terminate()

    def kill(self) -> bool:
        return any([c.kill() for c in self.children])

    def suspend(self) -> bool:
        return any([c.suspend() for c in self.children])

    def resume(self) -> bool:
        return any([c.resume() for c in self.children])

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        deadline = None if timeout is None else time.monotonic() + timeout
        for c in self.children:
            left = None if deadline is None else max(0.0, deadline - time.monotonic())
            if c.wait(left) is None:
                return None
        return self.children[0].returncode

    def reap(self, timeout: Optional[float] = None):
        """Wait (bounded) for every rank, SIGKILL what is left at the
        timeout; returns ``(leader's returncode, leader's stdout, every
        rank's stderr)``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for c in self.children:
            left = None if deadline is None else max(0.0, deadline - time.monotonic())
            out.append(c.reap(timeout=left))
        err = "".join(f"[rank {r}] {line}\n" for r, (_, _, e) in enumerate(out)
                      for line in e.splitlines())
        return out[0][0], out[0][1], err

    def stdout_so_far(self) -> str:
        return self.children[0].stdout_so_far()

    def stderr_so_far(self) -> str:
        return "".join(c.stderr_so_far() for c in self.children)


def last_json_line(text: str) -> Optional[dict]:
    """The last parseable JSON object line of a child's stdout — the
    replica's final drain report (the serve entry prints exactly one)."""
    for line in reversed(text.splitlines()):
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            return json.loads(line)
        except ValueError:
            continue
    return None


class ReplicaHandle:
    """Supervisor-side view of one replica: its spec, its current child
    process, and the counted robustness state."""

    def __init__(self, spec: ReplicaSpec):
        self.spec = spec
        self.child: Optional[ChildProcess] = None
        self.state = SPAWNING
        self.last_healthz: Optional[dict] = None
        self.spawned_at: Optional[float] = None  # monotonic, set by spawn
        self.restarts = 0
        self.deaths = 0
        self.stale_deaths = 0
        self.consecutive_failures = 0
        self.circuit_open = False
        self.restart_at: Optional[float] = None  # monotonic deadline
        self.drain_observed_draining = False
        self.drain_exit_75 = False
        self.contract_violations: List[str] = []
        self.final_report: Optional[dict] = None

    @property
    def index(self) -> int:
        return self.spec.index

    def admittable(self) -> bool:
        """May the router send NEW work here? UP only (a DRAINING
        replica finishes its in-flight work but gets nothing new; a
        DEAD/BROKEN one gets nothing at all). DEGRADED is a serving
        state and rides inside UP — the healthz 'overall' field says
        which."""
        return self.state == UP and not self.circuit_open

    def snapshot(self) -> dict:
        return {
            "index": self.index,
            "state": self.state,
            "pid": None if self.child is None else self.child.pid,
            "restarts": self.restarts,
            "deaths": self.deaths,
            "stale_deaths": self.stale_deaths,
            "consecutive_failures": self.consecutive_failures,
            "circuit_open": self.circuit_open,
            "drain_observed_draining": self.drain_observed_draining,
            "drain_exit_75": self.drain_exit_75,
            "contract_violations": list(self.contract_violations),
        }


class ReplicaSupervisor:
    """Keep ``FleetConfig.n_replicas`` serve entry replica processes
    serving; expose their liveness to the router; enforce the drain,
    staleness, restart, and circuit-breaker contracts.

    ``on_death(index, reason)`` is the router's hook: called exactly
    once per detected death (process exit, staleness escalation) so
    pending requests can fail over before their deadlines expire.
    """

    def __init__(
        self,
        cfg: FleetConfig,
        *,
        argv_prefix: Optional[List[str]] = None,
        env: Optional[dict] = None,
        on_death: Optional[Callable[[int, str], None]] = None,
        telemetry=None,
        indices: Optional[List[int]] = None,
    ):
        from raft_ncup_tpu_torch.observability import get_telemetry

        self.cfg = cfg
        self._argv_prefix = argv_prefix or [
            sys.executable, "-m", "raft_ncup_tpu_torch.serve",
        ]
        self._env = env
        self._on_death = on_death
        self._tel = telemetry if telemetry is not None else get_telemetry()
        # ``indices``: the replica slots THIS supervisor owns — a host
        # agent supervises only its host's placement, and the
        # autoscaler grows/shrinks the set via add_replica /
        # remove_replica. Default: the initial n_replicas.
        self.replicas: List[ReplicaHandle] = [
            ReplicaHandle(cfg.replica(i))
            for i in (
                range(cfg.n_replicas) if indices is None else indices
            )
        ]
        # Handles of replicas retired by remove_replica (scale-down):
        # their counters/violations stay in report() — elasticity must
        # not launder a replica's history by retiring it.
        self.retired: List[ReplicaHandle] = []
        self._lock = threading.RLock()
        # Deaths noted under the lock, delivered to ``on_death`` after it
        # is released (:meth:`_flush_deaths`).
        self._deaths: List[tuple] = []
        self._poll_stop = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None
        # Set by stop(): from then on no replica is (re)spawned, so a
        # restart that falls due while the fleet is torn down cannot
        # start a process that nothing reaps.
        self._stopping = False

    def handle(self, i: int) -> ReplicaHandle:
        """The live handle for GLOBAL replica index ``i`` (handles are
        keyed by slot index, not list position — a host agent's or an
        elastically-scaled supervisor's list is sparse)."""
        with self._lock:
            for h in self.replicas:
                if h.index == i:
                    return h
        raise KeyError(f"no live replica handle for index {i}")

    # ------------------------------------------------------------ spawning

    def _spawn(self, handle: ReplicaHandle) -> None:
        spec = handle.spec
        # A dead replica's stale socket/healthz must not satisfy the
        # next incarnation's liveness checks.
        for path in (spec.socket_path, spec.healthz_path):
            try:
                os.remove(path)
            except OSError:
                pass
        argv = self._argv_prefix + self.cfg.replica_argv(spec.index)
        if spec.ranks > 1:
            handle.child = RankGroup(
                argv, spec.ranks, name=f"replica-{spec.index}", env=self._env,
                cwd=_REPO_ROOT,
            ).spawn()
        else:
            handle.child = ChildProcess(
                argv, name=f"replica-{spec.index}", env=self._env,
                cwd=_REPO_ROOT,
            ).spawn()
        handle.state = SPAWNING
        handle.restart_at = None
        handle.spawned_at = time.monotonic()
        self._tel.event(
            "fleet_replica_spawned", replica=spec.index,
            pid=handle.child.pid,
        )

    def start(self, wait_ready: bool = True) -> "ReplicaSupervisor":
        os.makedirs(self.cfg.base_dir, exist_ok=True)
        with self._lock:
            for handle in self.replicas:
                self._spawn(handle)
        if wait_ready:
            self.wait_ready()
        self._poll_thread = threading.Thread(
            target=self._poll_loop, name="fleet-supervisor", daemon=True
        )
        self._poll_thread.start()
        return self

    def wait_ready(self, timeout: Optional[float] = None) -> None:
        """Block until every replica's healthz reads overall=ready (or
        a replica dies first, which raises with its stderr tail)."""
        deadline = time.monotonic() + (
            self.cfg.spawn_timeout_s if timeout is None else timeout
        )
        with self._lock:
            pending = {h.index for h in self.replicas}
        while pending:
            for i in sorted(pending):
                handle = self.handle(i)
                child = handle.child
                if child is not None and not child.running:
                    rc, out, err = child.reap(timeout=5.0)
                    # Kill + reap the SIBLINGS before raising: the
                    # documented `ReplicaSupervisor(cfg).start()`
                    # one-liner must not leak N-1 warmed replica
                    # orphans when one replica dies during warmup.
                    self.stop(drain=False)
                    raise RuntimeError(
                        f"replica {i} died during warmup (rc={rc}):\n"
                        f"{err[-2000:]}"
                    )
                hz = read_healthz(handle.spec.healthz_path)
                if hz is not None and hz.get("overall") == "ready":
                    handle.last_healthz = hz
                    handle.state = UP
                    handle.consecutive_failures = 0
                    pending.discard(i)
            if not pending:
                return
            if time.monotonic() > deadline:
                self.stop(drain=False)  # no orphans on timeout either
                raise TimeoutError(
                    f"replicas {sorted(pending)} not ready within "
                    f"{self.cfg.spawn_timeout_s}s"
                )
            time.sleep(self.cfg.poll_interval_s)

    # ------------------------------------------------------------- polling

    def _poll_loop(self) -> None:
        while not self._poll_stop.wait(self.cfg.poll_interval_s):
            try:
                self.poll()
            except Exception as e:
                # The supervisor reports on replicas; a poll error must
                # be visible, never fatal to the fleet.
                self._tel.event("fleet_supervisor_poll_error", error=repr(e))
                print(f"fleet supervisor poll error: {e!r}", file=sys.stderr)

    def poll(self) -> None:
        """One supervision pass: detect exits and stale heartbeats,
        run the restart schedule. Called by the background thread and
        directly by deterministic tests."""
        now = time.monotonic()
        with self._lock:
            for handle in self.replicas:
                self._poll_one(handle, now)
        self._flush_deaths()

    def _flush_deaths(self) -> None:
        """Deliver the deaths noted since the last flush to ``on_death``,
        outside the lock: the router's handler takes the router's lock,
        and the router calls back into this supervisor (``handle``,
        ``admittable``) while it holds that lock, so a callback under this
        lock deadlocks against a link reader failing the same replica
        over."""
        with self._lock:
            deaths, self._deaths = self._deaths, []
        if self._on_death is not None:
            for index, reason in deaths:
                self._on_death(index, reason)

    def _poll_one(self, handle: ReplicaHandle, now: float) -> None:
        if handle.state in (EXITED, BROKEN):
            return
        if handle.state == DEAD:
            if (
                handle.restart_at is not None
                and now >= handle.restart_at
                and not self._stopping
            ):
                handle.restarts += 1
                self._tel.inc("fleet_replica_restarts_total")
                self._tel.event(
                    "fleet_replica_restart", replica=handle.index,
                    attempt=handle.restarts,
                )
                self._spawn(handle)
            return
        child = handle.child
        if child is None:
            return
        if not child.running:
            if handle.state == DRAINING:
                # drain() owns the contract bookkeeping.
                return
            rc = child.returncode
            # A mesh slot's surviving ranks die with it (a no-op for one
            # process, which has exited).
            child.kill()
            child.wait(timeout=10.0)
            self._note_death(handle, f"process exited rc={rc}")
            return
        hz = read_healthz(handle.spec.healthz_path)
        if hz is not None:
            handle.last_healthz = hz
        if handle.state == SPAWNING:
            if hz is not None and hz.get("overall") == "ready":
                handle.state = UP
                handle.consecutive_failures = 0
                self._tel.event(
                    "fleet_replica_ready", replica=handle.index
                )
            elif (
                handle.spawned_at is not None
                and now - handle.spawned_at > self.cfg.spawn_timeout_s
            ):
                # A respawned replica that wedges DURING warmup (never
                # reaches ready) must not park in SPAWNING forever: the
                # spawn-timeout bound applies to every incarnation, not
                # just the initial wait_ready().
                child.kill()
                child.wait(timeout=10.0)
                self._note_death(handle, "warmup timeout")
            return
        if handle.state == UP and not healthz_fresh(
            hz, self.cfg.stale_after_s
        ):
            # The staleness contract: the process lingers, the replica
            # is dead. SIGKILL so it cannot answer after the failover.
            handle.stale_deaths += 1
            self._tel.inc("fleet_replica_stale_total")
            child.kill()
            child.wait(timeout=10.0)
            self._note_death(handle, "healthz stale")

    def _note_death(self, handle: ReplicaHandle, reason: str) -> None:
        handle.deaths += 1
        handle.consecutive_failures += 1
        self._tel.inc("fleet_replica_deaths_total")
        self._tel.event(
            "fleet_replica_death", replica=handle.index, reason=reason,
            consecutive=handle.consecutive_failures,
        )
        print(
            f"fleet: replica {handle.index} death #{handle.deaths} "
            f"({reason}); consecutive={handle.consecutive_failures}",
            file=sys.stderr,
        )
        if handle.consecutive_failures >= self.cfg.circuit_break_after:
            handle.circuit_open = True
            handle.state = BROKEN
            self._tel.inc("fleet_circuit_open_total")
            self._tel.event(
                "fleet_circuit_open", replica=handle.index,
                consecutive=handle.consecutive_failures,
            )
        elif handle.restarts >= self.cfg.max_restarts:
            handle.state = BROKEN
            self._tel.event(
                "fleet_restart_budget_exhausted", replica=handle.index,
                restarts=handle.restarts,
            )
        else:
            backoff = min(
                self.cfg.restart_backoff_max_s,
                self.cfg.restart_backoff_s
                * (2 ** max(0, handle.consecutive_failures - 1)),
            )
            handle.state = DEAD
            handle.restart_at = time.monotonic() + backoff
        self._deaths.append((handle.index, reason))

    # -------------------------------------------------- elastic membership

    def add_replica(
        self, i: int, wait_ready: bool = False,
        timeout: Optional[float] = None,
    ) -> ReplicaHandle:
        """Grow the supervised set by slot ``i`` (autoscaler scale-up /
        a host agent's spawn command). The new replica starts SPAWNING
        and is promoted to UP by the normal poll path once its healthz
        reads ready — the pre-warm gate: the router's shape-aware
        preference only ever sees it AFTER its warmed executable set is
        advertised. ``wait_ready=True`` blocks (autoscalers don't —
        they watch the handle across ticks)."""
        with self._lock:
            for h in self.replicas:
                if h.index == i:
                    raise ValueError(
                        f"replica slot {i} already supervised "
                        f"(state={h.state})"
                    )
            handle = ReplicaHandle(self.cfg.replica(i))
            self.replicas.append(handle)
            self._spawn(handle)
        self._tel.event("fleet_scale_up_spawn", replica=i)
        if wait_ready:
            deadline = time.monotonic() + (
                self.cfg.spawn_timeout_s if timeout is None else timeout
            )
            while handle.state == SPAWNING:
                with self._lock:
                    self._poll_one(handle, time.monotonic())
                self._flush_deaths()
                if handle.state != SPAWNING:
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"scale-up replica {i} not ready within "
                        f"{self.cfg.spawn_timeout_s}s"
                    )
                time.sleep(self.cfg.poll_interval_s)
        return handle

    def remove_replica(self, i: int, drain: bool = True) -> dict:
        """Shrink the supervised set by slot ``i`` (autoscaler
        scale-down): graceful drain (SIGTERM → DRAINING → exit 75,
        ZERO in-flight loss — the existing contract, reused, not
        re-implemented), then retire the handle so the slot is free
        for a future scale-up. The retired handle's counters stay in
        :meth:`report`."""
        handle = self.handle(i)
        result = (
            self.drain(i) if drain
            else {"observed_draining": False, "returncode": None}
        )
        if not drain and handle.child is not None:
            handle.child.kill()
            handle.child.reap(timeout=10.0)
            with self._lock:
                handle.state = EXITED
        with self._lock:
            self.replicas = [h for h in self.replicas if h.index != i]
            self.retired.append(handle)
        self._tel.event(
            "fleet_scale_down_retired", replica=i,
            returncode=result.get("returncode"),
        )
        return result

    # ------------------------------------------------------ orchestration

    def drain(self, i: int, timeout: Optional[float] = None) -> dict:
        """Orchestrate one replica's graceful drain: SIGTERM ⇒ expect
        ``draining: true`` in healthz ⇒ expect exit 75. Returns the
        contract observations + the replica's final report; violations
        are recorded on the handle, never swallowed."""
        handle = self.handle(i)
        child = handle.child
        timeout = self.cfg.drain_timeout_s if timeout is None else timeout
        with self._lock:
            handle.state = DRAINING
        self._tel.event("fleet_replica_drain", replica=i)
        if child is None or not child.terminate():
            handle.contract_violations.append(
                "drain requested but process already gone"
            )
            return {"observed_draining": False, "returncode": None}
        deadline = time.monotonic() + timeout
        observed = False
        while time.monotonic() < deadline:
            hz = read_healthz(handle.spec.healthz_path)
            if hz is not None and hz.get("draining"):
                observed = True
                handle.last_healthz = hz
            if not child.running:
                break
            if observed:
                break
            time.sleep(self.cfg.poll_interval_s)
        rc, out, err = child.reap(timeout=max(0.0, deadline - time.monotonic()))
        # The final healthz (written at teardown) must still read
        # draining — DRAINING is terminal short of HALTED.
        hz = read_healthz(handle.spec.healthz_path)
        if hz is not None and hz.get("draining"):
            observed = True
            handle.last_healthz = hz
        handle.drain_observed_draining = observed
        handle.drain_exit_75 = rc == 75
        if not observed:
            handle.contract_violations.append(
                "DRAINING never observed in healthz during drain"
            )
        if rc != 75:
            handle.contract_violations.append(
                f"drain exit contract violated: rc={rc} (want 75)"
            )
        handle.final_report = last_json_line(out)
        with self._lock:
            handle.state = EXITED
        self._tel.event(
            "fleet_replica_drained", replica=i, returncode=rc,
            observed_draining=observed,
        )
        return {
            "observed_draining": observed,
            "returncode": rc,
            "report": handle.final_report,
        }

    def kill(self, i: int) -> None:
        """SIGKILL replica ``i`` (chaos killreplica): no drain, no
        flush. The death is detected and handled by the normal poll
        path — restart budget, circuit breaker, router failover all
        apply exactly as for an organic crash."""
        handle = self.handle(i)
        self._tel.event("fleet_replica_kill", replica=i)
        if handle.child is not None:
            handle.child.kill()
            handle.child.wait(timeout=10.0)
        self.poll()

    def stall(self, i: int) -> None:
        """SIGSTOP replica ``i`` (chaos stallreplica): the process
        lingers but stops heartbeating — detection rides the healthz
        staleness contract, not process liveness."""
        self._tel.event("fleet_replica_stall", replica=i)
        handle = self.handle(i)
        if handle.child is not None:
            handle.child.suspend()

    def resume(self, i: int) -> None:
        handle = self.handle(i)
        if handle.child is not None:
            handle.child.resume()

    # ------------------------------------------------------------ teardown

    def stop(self, drain: bool = True) -> Dict[int, dict]:
        """Tear the fleet down: drain every live replica (unless
        ``drain=False``), reap everything, return per-replica final
        reports. No replica is (re)spawned once it has begun."""
        with self._lock:
            self._stopping = True
        self._poll_stop.set()
        if self._poll_thread is not None and self._poll_thread.is_alive():
            self._poll_thread.join(timeout=10.0)
        reports: Dict[int, dict] = {}
        with self._lock:
            handles = list(self.replicas)
        for handle in handles:
            if handle.state in (UP, SPAWNING) and drain:
                self.drain(handle.index)
            child = handle.child
            if child is not None:
                child.kill()  # every rank still there (a no-op once exited)
                rc, out, err = child.reap(timeout=10.0)
                if handle.final_report is None:
                    handle.final_report = last_json_line(out)
            reports[handle.index] = {
                **handle.snapshot(),
                "report": handle.final_report,
            }
        return reports

    def report(self) -> dict:
        """Supervisor accounting: per-replica snapshots + fleet totals
        (every restart/death/violation counted — the robustness story
        is only as honest as its bookkeeping)."""
        with self._lock:
            snaps = [h.snapshot() for h in self.replicas]
            retired = [h.snapshot() for h in self.retired]
        # Retired (scaled-down) replicas stay in the totals: elasticity
        # must not launder history by retiring a handle.
        everything = snaps + retired
        return {
            "replicas": snaps,
            "retired": retired,
            "deaths": sum(s["deaths"] for s in everything),
            "stale_deaths": sum(
                s["stale_deaths"] for s in everything
            ),
            "restarts": sum(s["restarts"] for s in everything),
            "circuits_open": sum(
                1 for s in everything if s["circuit_open"]
            ),
            "contract_violations": [
                v for s in everything for v in s["contract_violations"]
            ],
        }

    def __enter__(self) -> "ReplicaSupervisor":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
