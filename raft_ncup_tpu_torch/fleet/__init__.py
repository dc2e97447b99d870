"""Fleet tier: a router over N replica processes of the port's serve
entry (port of ``raft_ncup_tpu/fleet/``; ROADMAP.md item 7).

Everything below this package is one process: one ``FlowServer``, one
``StreamEngine``, one card. A fleet is a process topology: N replica
processes (``python -m raft_ncup_tpu_torch.serve --replica_socket ADDR``),
each serving through its own ``FlowServer`` and ``StreamEngine`` (so the
hand-written kernels run in every replica), behind a router that admits,
routes and fails over without ever touching a device. The package is
host-only stdlib + numpy by construction (no ``import torch``; an AST
scan in ``tests/test_torch_fleet.py`` holds it to that): a router that
could touch a device tensor could add a device sync to every request it
routes. Names, wire format, healthz contract, terminal statuses and chaos
grammar are the JAX package's, so the frames are byte for byte the same.

- :mod:`topology` — one frozen :class:`FleetConfig`: replica count,
  per-replica serve/stream knobs, socket and healthz paths, router
  admission bounds, failover and restart budgets. Every other piece reads
  it. The port has no mesh: a replica slot's mesh must be None.
- :mod:`wire` — the frame protocol: a length-prefixed JSON header and raw
  C-order ndarray payloads over a Unix domain socket or TCP
  (:class:`wire.Transport` parses the family from the address).
- :mod:`replica` — :class:`ChildProcess` (spawn, liveness and healthz
  wait, drain, reap) and :class:`ReplicaSupervisor` (healthz staleness,
  the SIGTERM → DRAINING → exit-75 drain, bounded restart with backoff,
  the circuit breaker).
- :mod:`router` — :class:`FleetRouter`: admission that sheds before work
  crosses a process boundary, consistent-hash stream affinity,
  shape-aware routing on the replicas' advertised warmed sets,
  DRAINING/DEGRADED-aware rotation, one failover within the deadline,
  the clock handshake; :func:`replay_fleet` fires the fleet chaos kinds.
- :mod:`host_supervisor` — :class:`HostSupervisor` (one agent per host,
  its replicas' healthz republished over the wire) and
  :class:`FleetManager` (fleet-level staleness, fencing, partition).
- :mod:`autoscaler` — :class:`FleetAutoscaler`: SLO-driven elastic
  sizing with hysteresis, cooldown, a fail-budget breaker and the
  time-to-READY estimate published to the router's shed hints.

Chaos: ``killreplica@N`` / ``stallreplica@N`` / ``drainreplica@N`` and
the host kinds ``partitionhost@N`` / ``killsupervisor@N``
(``resilience/chaos.py``) act through :func:`replay_fleet`.
"""

from raft_ncup_tpu_torch.fleet.autoscaler import FleetAutoscaler  # noqa: F401
from raft_ncup_tpu_torch.fleet.host_supervisor import (  # noqa: F401
    FleetManager,
    HostSupervisor,
)

from raft_ncup_tpu_torch.fleet.replica import (  # noqa: F401
    ChildProcess,
    ReplicaHandle,
    ReplicaSupervisor,
    healthz_fresh,
    read_healthz,
)
from raft_ncup_tpu_torch.fleet.router import FleetRouter, replay_fleet  # noqa: F401
from raft_ncup_tpu_torch.fleet.topology import (  # noqa: F401
    FleetConfig,
    ReplicaSpec,
    padded_shape,
)
from raft_ncup_tpu_torch.fleet.wire import (  # noqa: F401
    Transport,
    recv_msg,
    send_msg,
)

__all__ = [
    "ChildProcess",
    "FleetAutoscaler",
    "FleetConfig",
    "FleetManager",
    "FleetRouter",
    "HostSupervisor",
    "Transport",
    "ReplicaHandle",
    "ReplicaSpec",
    "ReplicaSupervisor",
    "healthz_fresh",
    "padded_shape",
    "read_healthz",
    "recv_msg",
    "replay_fleet",
    "send_msg",
]
