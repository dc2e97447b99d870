"""The fleet topology object: one frozen declarative config every other
piece reads (port of ``raft_ncup_tpu/fleet/topology.py``; the JAX
package's docs/FLEET.md describes the fleet this mirrors name for name).

The supervisor spawns from it, the router routes from it, chaos replays
against it and the tests assert on it: nothing else defines how many
replicas exist, where their sockets and healthz files live, what each one
warms, or how much failover and restart budget the fleet has.

Host-only stdlib plus the port's own config dataclasses (which import no
torch): the router process holds this object without importing torch
(an AST scan in ``tests/test_torch_fleet.py`` holds ``fleet/`` to that).

The port serves on one card and has no mesh: a replica slot's mesh must
be None (ROADMAP.md, queue 1 item 9), so every pad divisor is 8. The
device is the serve entry's ``--device``, given through ``extra_args``
(``("--device", "cpu")`` on the CPU; nothing on the card).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

from raft_ncup_tpu_torch.config import ServeConfig, StreamConfig


def padded_shape(
    h: int, w: int, divisor: int = 8, bucket: int = 0
) -> Tuple[int, int]:
    """The padded (H, W) a native frame batches under: the pure-host
    mirror of ``ops/padding.InputPadder``'s pad arithmetic (height pads
    to a multiple of ``divisor``, width to a multiple of 8; a ``bucket``
    rounds both up to multiples of itself). The router uses it to match a
    request's shape key against the replicas' healthz-advertised warmed
    sets without importing torch (``tests/test_torch_fleet.py`` pins it
    against the port's ``InputPadder``)."""
    h, w = int(h), int(w)
    if bucket:
        return h + (-h % bucket), w + (-w % bucket)
    return h + (-h % divisor), w + (-w % 8)


@dataclass(frozen=True)
class ReplicaSpec:
    """One replica's addresses, derived from :class:`FleetConfig` —
    where its wire endpoint listens (``address``: a UDS path or
    ``host:port``, the string ``fleet/wire.Transport.parse`` decides
    the family from), where it rewrites its healthz file, and where its
    flight recorder banks fault dumps."""

    index: int
    socket_path: str
    healthz_path: str
    flight_dir: str
    # Periodic registry snapshots (the serve entry's --telemetry_jsonl): the
    # per-replica export observability/aggregate.py merges into the
    # fleet-wide registry view.
    telemetry_jsonl: str = ""
    # Always None in the port (one card, no mesh: ROADMAP.md item 9).
    mesh: Optional[Tuple[int, int]] = None
    # The wire address (the serve entry's --replica_socket): equals socket_path
    # under the UDS transport, "host:port" under TCP. Empty only when a
    # spec is constructed by hand without one (tests) — cfg-derived
    # specs always fill it.
    address: str = ""
    # The named host this replica is placed on ("" = the single
    # implicit local host of a UDS fleet).
    host: str = ""

    def __post_init__(self) -> None:
        _refuse_mesh(self.mesh)


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise ValueError(
            f"replica mesh {mesh!r}: the port serves on one card without "
            "a mesh (ROADMAP.md, queue 1 item 9)"
        )


@dataclass(frozen=True)
class FleetConfig:
    """The whole fleet as one validated object.

    ``serve`` / ``stream`` are the per-replica subsystem configs (every
    replica runs a :class:`~raft_ncup_tpu_torch.serving.server.FlowServer`;
    ``stream=None`` disables the per-replica StreamEngine for
    request-only fleets). ``meshes`` keeps the JAX field; every entry
    must be None here (no mesh in the port).
    """

    # Directory holding every replica's socket, healthz file, and
    # flight dir (one tree per fleet run: the postmortem surface).
    base_dir: str
    n_replicas: int = 2
    # Native frame size the replicas warm at (the serve entry's --size).
    size_hw: Tuple[int, int] = (96, 128)
    serve: ServeConfig = field(default_factory=ServeConfig)
    stream: Optional[StreamConfig] = None
    # Per-replica mesh slices: None, or None for every slot (the port has
    # no mesh; ROADMAP.md item 9).
    meshes: Optional[tuple] = None
    # Extra serve entry argv forwarded verbatim (model and device flags).
    extra_args: Tuple[str, ...] = ()

    # --- healthz cadence + the staleness contract -----------------------
    # Replicas rewrite healthz on this cadence; a consumer MUST treat a
    # file whose time_unix_s is older than ``stale_after_s`` as a dead
    # replica even if the process still exists (a SIGSTOPped or wedged
    # replica lingers but cannot serve). Default: 2x the cadence — the
    # schema contract pinned in tests/test_observability.py.
    snapshot_interval_s: float = 0.25
    stale_after_factor: float = 2.0
    # Supervisor poll cadence + lifecycle timeouts.
    poll_interval_s: float = 0.1
    spawn_timeout_s: float = 120.0
    drain_timeout_s: float = 90.0

    # --- router admission + failover budgets ----------------------------
    # Outstanding (dispatched, unanswered) requests the router allows
    # per replica before it sheds AT THE ROUTER — backpressure must bite
    # before work crosses a process boundary.
    max_inflight_per_replica: int = 16
    # Shed hint when no replica has advertised anything better.
    default_retry_after_s: float = 0.25
    # How many times one request may be re-dispatched after a replica
    # death before it terminates honestly (shed/error, never silence).
    max_failovers: int = 1

    # --- supervisor restart budgets + circuit breaker -------------------
    max_restarts: int = 2  # per replica, counted
    restart_backoff_s: float = 0.25  # doubles per consecutive failure
    restart_backoff_max_s: float = 5.0
    # K consecutive failures (death/staleness without an intervening
    # healthy serve) opens the replica's circuit breaker: no restart,
    # no traffic — a crash-looping replica must stop eating requests.
    circuit_break_after: int = 3

    # --- transport + host placement -------------------------------------
    # "unix": every replica listens on a UDS path under base_dir (one
    # host). "tcp": replica i listens on
    # tcp_host:(base_port + i) — the socket-family swap wire.py was
    # designed for; healthz/flight PATHS stay per-host-local and travel
    # to remote consumers via the HostSupervisor's wire republish.
    transport: str = "unix"
    tcp_host: str = "127.0.0.1"
    base_port: int = 0  # required > 0 under tcp; replica i = base + i
    # Named hosts and the per-replica placement over them. () = one
    # implicit host (every replica host ""). When given, placement maps
    # every replica slot 0..scale_max-1 to a host name (None =
    # round-robin over hosts); each host gets a HostSupervisor agent
    # that spawns/reaps its replicas and republishes their healthz over
    # the wire at host_control_address(host).
    hosts: Tuple[str, ...] = ()
    placement: Optional[Tuple[str, ...]] = None

    # --- elastic sizing (fleet/autoscaler.py) ---------------------------
    # n_replicas is the INITIAL size; the autoscaler moves the live
    # count inside [scale_min, scale_max] (None = pinned at n_replicas,
    # a fixed-N fleet). Addresses/meshes are declared for
    # every slot up to scale_max — capacity is topology, not a runtime
    # discovery.
    min_replicas: Optional[int] = None
    max_replicas: Optional[int] = None
    # Decision cadence + anti-flap: a scale decision needs the same
    # signal for scale_hysteresis_ticks consecutive ticks AND
    # scale_cooldown_s since the last topology change — an oscillating
    # signal whose period beats either bound cannot thrash the fleet.
    scale_tick_s: float = 1.0
    scale_cooldown_s: float = 10.0
    scale_hysteresis_ticks: int = 3
    # Occupancy (fleet-wide inflight / open capacity) thresholds.
    scale_up_occupancy: float = 0.8
    scale_down_occupancy: float = 0.25
    # Consecutive FAILED scale-ups (spawned replica dies/breaks before
    # READY) that open the autoscaler's own breaker: no further
    # scale-ups — a respawn storm must be bounded at the control loop
    # too, not only per replica.
    scale_fail_budget: int = 2
    # Prior for the time-to-READY estimate (seconds) before any
    # scale-up has been observed — what shed retry_after_s hints are
    # floored at while capacity is still warming.
    scale_eta_prior_s: float = 20.0

    # --- TCP wire hardening ---------------------------------------------
    connect_timeout_s: float = 10.0
    # Router link read deadline (TCP only): silence past this triggers
    # the link reader's ping probe — half-open detection (peer vanished
    # without FIN) folded into the normal link-down failover flush.
    link_read_timeout_s: float = 30.0

    def __post_init__(self) -> None:
        if self.n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1: {self.n_replicas}")
        if not self.base_dir:
            raise ValueError("base_dir is required (sockets/healthz live there)")
        h, w = self.size_hw
        if int(h) < 16 or int(w) < 16:
            raise ValueError(f"size_hw too small for the pyramid: {self.size_hw}")
        if self.meshes is not None:
            if len(self.meshes) != self.scale_max:
                raise ValueError(
                    f"meshes has {len(self.meshes)} entries for "
                    f"{self.scale_max} replica slots — the topology "
                    "object must name every slot's mesh slice "
                    "explicitly (scale_max slots, not just the initial "
                    "n_replicas)"
                )
            for mesh in self.meshes:
                _refuse_mesh(mesh)
        if self.transport not in ("unix", "tcp"):
            raise ValueError(
                f"transport must be 'unix' or 'tcp': {self.transport!r}"
            )
        if self.transport == "tcp" and self.base_port <= 0:
            raise ValueError(
                "tcp transport needs base_port > 0 (replica i listens "
                "on tcp_host:(base_port + i); ports are topology)"
            )
        if self.placement is not None:
            if not self.hosts:
                raise ValueError("placement given without named hosts")
            if len(self.placement) != self.scale_max:
                raise ValueError(
                    f"placement has {len(self.placement)} entries for "
                    f"{self.scale_max} replica slots"
                )
            unknown = sorted(set(self.placement) - set(self.hosts))
            if unknown:
                raise ValueError(
                    f"placement names unknown hosts {unknown} "
                    f"(hosts={list(self.hosts)})"
                )
        if not (
            self.scale_min <= self.n_replicas <= self.scale_max
        ) or self.scale_min < 1:
            raise ValueError(
                f"replica bounds must satisfy 1 <= min_replicas "
                f"({self.scale_min}) <= n_replicas ({self.n_replicas}) "
                f"<= max_replicas ({self.scale_max})"
            )
        if not (
            0.0 < self.scale_down_occupancy < self.scale_up_occupancy
            <= 1.0
        ):
            raise ValueError(
                "occupancy thresholds must satisfy 0 < "
                f"scale_down_occupancy ({self.scale_down_occupancy}) < "
                f"scale_up_occupancy ({self.scale_up_occupancy}) <= 1 "
                "— an inverted band would flap by construction"
            )
        if self.scale_hysteresis_ticks < 1:
            raise ValueError(
                f"scale_hysteresis_ticks must be >= 1: "
                f"{self.scale_hysteresis_ticks}"
            )
        if self.scale_fail_budget < 1:
            raise ValueError(
                f"scale_fail_budget must be >= 1: {self.scale_fail_budget}"
            )
        for name in (
            "scale_tick_s", "scale_cooldown_s", "scale_eta_prior_s",
            "connect_timeout_s", "link_read_timeout_s",
        ):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be > 0: {getattr(self, name)}")
        for name in (
            "snapshot_interval_s", "poll_interval_s", "spawn_timeout_s",
            "drain_timeout_s", "restart_backoff_s", "restart_backoff_max_s",
            "default_retry_after_s",
        ):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be > 0: {getattr(self, name)}")
        if self.stale_after_factor < 1.0:
            raise ValueError(
                "stale_after_factor < 1 declares a fresh file stale: "
                f"{self.stale_after_factor}"
            )
        if self.max_inflight_per_replica < 1:
            raise ValueError(
                f"max_inflight_per_replica must be >= 1: "
                f"{self.max_inflight_per_replica}"
            )
        if self.max_failovers < 0 or self.max_restarts < 0:
            raise ValueError("failover/restart budgets must be >= 0")
        if self.circuit_break_after < 1:
            raise ValueError(
                f"circuit_break_after must be >= 1: {self.circuit_break_after}"
            )

    # ------------------------------------------------------------ derived

    @property
    def stale_after_s(self) -> float:
        """The staleness bound: healthz older than this ⇒ replica
        presumed dead even if the process lingers."""
        return self.snapshot_interval_s * self.stale_after_factor

    @property
    def scale_min(self) -> int:
        """Autoscaler floor (``min_replicas``, default: pinned at
        ``n_replicas``)."""
        return (
            self.n_replicas if self.min_replicas is None
            else self.min_replicas
        )

    @property
    def scale_max(self) -> int:
        """Autoscaler ceiling AND the number of declared replica slots
        (addresses, meshes, placement all cover ``scale_max``)."""
        return (
            self.n_replicas if self.max_replicas is None
            else self.max_replicas
        )

    def host_of(self, i: int) -> str:
        """The named host replica slot ``i`` is placed on ("" for the
        single implicit host of an unplaced fleet). Default placement
        is round-robin over ``hosts``."""
        if not self.hosts:
            return ""
        if self.placement is not None:
            return self.placement[i]
        return self.hosts[i % len(self.hosts)]

    def replicas_on(self, host: str) -> list:
        """Replica slot indices placed on ``host`` (all scale_max
        slots, live or not — slots are topology)."""
        return [
            i for i in range(self.scale_max) if self.host_of(i) == host
        ]

    def replica_address(self, i: int) -> str:
        """Replica ``i``'s wire address — the one string both ends
        parse the socket family from (``wire.Transport.parse``)."""
        if self.transport == "tcp":
            return f"{self.tcp_host}:{self.base_port + i}"
        return os.path.join(self.base_dir, f"replica_{i}.sock")

    def host_control_address(self, host: str) -> str:
        """Where ``host``'s HostSupervisor agent listens for control
        frames (healthz republish, spawn/drain commands). TCP ports
        for agents sit directly above the replica-slot ports."""
        if self.transport == "tcp":
            hosts = self.hosts or ("",)
            return (
                f"{self.tcp_host}:"
                f"{self.base_port + self.scale_max + hosts.index(host)}"
            )
        tag = host or "local"
        return os.path.join(self.base_dir, f"host_{tag}.sock")

    def replica(self, i: int) -> ReplicaSpec:
        if not 0 <= i < self.scale_max:
            raise ValueError(
                f"replica {i} out of range 0..{self.scale_max - 1}"
            )
        return ReplicaSpec(
            index=i,
            socket_path=os.path.join(self.base_dir, f"replica_{i}.sock"),
            healthz_path=os.path.join(
                self.base_dir, f"replica_{i}.healthz.json"
            ),
            flight_dir=os.path.join(self.base_dir, f"replica_{i}_flight"),
            telemetry_jsonl=os.path.join(
                self.base_dir, f"replica_{i}_telemetry.jsonl"
            ),
            mesh=None if self.meshes is None else self.meshes[i],
            address=self.replica_address(i),
            host=self.host_of(i),
        )

    def replicas(self) -> list:
        return [self.replica(i) for i in range(self.n_replicas)]

    def host_manifest(self, host: str) -> dict:
        """The JSON-able slice of this topology one HostSupervisor
        agent needs: every replica slot placed on ``host`` (its argv,
        addresses, and whether it starts immediately or is a scale-up
        slot), plus the supervision policy — so the agent process
        reconstructs ONLY what it supervises, never the whole fleet
        (``fleet/host_supervisor.ManifestConfig`` adapts it back for
        the unmodified ReplicaSupervisor)."""
        return {
            "host": host,
            "control": self.host_control_address(host),
            "base_dir": self.base_dir,
            "poll_interval_s": self.poll_interval_s,
            "spawn_timeout_s": self.spawn_timeout_s,
            "drain_timeout_s": self.drain_timeout_s,
            "snapshot_interval_s": self.snapshot_interval_s,
            "stale_after_s": self.stale_after_s,
            "max_restarts": self.max_restarts,
            "restart_backoff_s": self.restart_backoff_s,
            "restart_backoff_max_s": self.restart_backoff_max_s,
            "circuit_break_after": self.circuit_break_after,
            "replicas": [
                {
                    "index": i,
                    "start": i < self.n_replicas,
                    "address": self.replica_address(i),
                    "socket_path": self.replica(i).socket_path,
                    "healthz_path": self.replica(i).healthz_path,
                    "flight_dir": self.replica(i).flight_dir,
                    "argv": self.replica_argv(i),
                }
                for i in self.replicas_on(host)
            ],
        }

    def pad_divisor(self, i: int) -> int:
        """Replica ``i``'s pad divisor: 8 (8 * spatial under a mesh, which
        the port does not have)."""
        self.replica(i)  # range check
        return 8

    def shape_key(self, h: int, w: int, i: int = 0) -> Tuple[int, int]:
        """The padded shape a native (h, w) request batches under on
        replica ``i`` — the key matched against the replica's
        healthz-advertised warmed executable set."""
        return padded_shape(
            h, w, divisor=self.pad_divisor(i), bucket=self.serve.pad_bucket
        )

    def replica_argv(self, i: int) -> list:
        """The serve entry's argument vector that realizes replica ``i`` of
        THIS topology: the supervisor spawns exactly this
        (``python -m raft_ncup_tpu_torch.serve`` + these), and the tests
        print it for reproduction. The device flag rides ``extra_args``."""
        spec = self.replica(i)
        s, st = self.serve, self.stream
        argv = [
            "--replica_socket", spec.address,
            "--replica_index", str(i),
            "--healthz_file", spec.healthz_path,
            "--flight_dir", spec.flight_dir,
            "--telemetry_jsonl", spec.telemetry_jsonl,
            "--telemetry_interval_s", str(self.snapshot_interval_s),
            "--size", str(self.size_hw[0]), str(self.size_hw[1]),
            "--queue_capacity", str(s.queue_capacity),
            "--serve_batch_sizes", ",".join(str(b) for b in s.batch_sizes),
            "--iter_levels", ",".join(str(x) for x in s.iter_levels),
            "--high_water", str(s.high_water),
            "--low_water", str(s.low_water),
            "--recover_patience", str(s.recover_patience),
            "--serve_pad_bucket", str(s.pad_bucket),
            "--serve_cache_size", str(s.cache_size),
        ]
        if s.precision is not None:
            argv += ["--serve_precision", s.precision]
        if st is None:
            argv += ["--replica_streams", "false"]
        else:
            argv += [
                "--replica_streams", "true",
                "--stream_capacity", str(st.capacity),
                "--stream_iters", str(st.iters),
                "--stream_batch_sizes", ",".join(
                    str(b) for b in st.batch_sizes
                ),
                "--stream_queue_capacity", str(st.queue_capacity),
                "--max_frame_gap", str(st.max_frame_gap),
                "--idle_timeout_s", str(st.idle_timeout_s),
                "--stream_pad_bucket", str(st.pad_bucket),
            ]
        argv += list(self.extra_args)
        return argv
