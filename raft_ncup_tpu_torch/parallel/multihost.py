"""The process world of data parallelism: one process per card (port of
``raft_ncup_tpu/parallel/multihost.py``).

JAX runs one program over every chip and lets the process runtime
(``jax.distributed.initialize``) join the hosts. The port runs one process
per card, started by a launcher (``torchrun --nproc_per_node N -m
raft_ncup_tpu_torch.train ...``), and joins them with
``torch.distributed``: :func:`initialize_distributed` reads the launcher's
environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``) when its arguments are not given; a world of one with no
launcher does nothing.

The backend is ``nccl`` for ranks on cards and ``gloo`` for ranks on the
CPU; only an explicit ``backend=`` or the ``RAFT_TORCH_DIST_BACKEND`` knob
changes it. NCCL refuses two ranks on one card, so an NCCL world checks
its ranks' cards at once and raises when two share one, before any step.
gloo reduces on the host: a card tensor goes there and back through
:func:`analysis.guards.collective_read`, a named and counted
synchronisation. Every collective waits :data:`COLLECTIVE_TIMEOUT_S`
(1800 s) for the other ranks, long enough for cuDNN's autotuning
of a first step on each of them.

:func:`all_reduce_` is the port's reduction, over the world or a
subgroup; it counts each call and its bytes (``mesh.collective_stats``
reads them, with the spatial axis's halo exchanges and gathers of
``parallel/halo.py``), and :func:`all_reduce_grad` is its differentiable
form (sync-BN). Host-side
helpers: :func:`allreduce_sum_across_hosts` (numpy in and out, summed over
the ranks: validation's sums and counts), :func:`agreed_min`, :func:`agreed_any` and
:func:`barrier` on the process group's store.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
from typing import Optional

import numpy as np
import torch

from raft_ncup_tpu_torch.utils.knobs import knob_raw

_LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
BACKENDS = ("nccl", "gloo")
# Seconds a collective or a barrier waits for the other ranks.
COLLECTIVE_TIMEOUT_S = 1800.0

# Calls and bytes of the collectives this process issued, by JAX's op
# names (``mesh.collective_stats``).
_COUNTS: dict = {}
_barrier_calls: dict = {}


def _dist():
    import torch.distributed as dist

    return dist


def launched() -> bool:
    """Whether a launcher (``torchrun``) started this process: its
    environment names the world."""
    return all(k in os.environ for k in _LAUNCHER_ENV)


def initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The world size: the process group's, else 1."""
    return _dist().get_world_size() if initialized() else 1


def process_index() -> int:
    """This process's rank: the process group's, else 0."""
    return _dist().get_rank() if initialized() else 0


def world_size_hint() -> int:
    """The world this process is in or is about to join: the process
    group's size, else the launcher's ``WORLD_SIZE``, else 1. The CLI
    checks the mesh flags against it before the world is joined."""
    if initialized():
        return process_count()
    return int(os.environ["WORLD_SIZE"]) if launched() else 1


def local_rank() -> int:
    """This process's index among its host's ranks (``LOCAL_RANK``), 0
    without a launcher."""
    return int(os.environ.get("LOCAL_RANK", "0")) if launched() else 0


def is_multihost() -> bool:
    return process_count() > 1


def is_main_process() -> bool:
    """True on exactly one process of the world: the only one that writes
    what people read (the log, telemetry exports, flight dumps,
    checkpoints, submissions)."""
    return process_index() == 0


def backend() -> Optional[str]:
    """The process group's backend, None without one."""
    return str(_dist().get_backend()) if initialized() else None


def local_device(device=None) -> torch.device:
    """The card this rank feeds: ``device`` when given (a bare ``cuda`` as
    the current card's index), else ``cuda:LOCAL_RANK`` under a launcher,
    else the current card. With no
    CUDA and no ``device="cpu"`` it raises."""
    from raft_ncup_tpu_torch.utils.device import resolve_device

    if device is None and launched():
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for this rank; pass "
                               "--device cpu to train on the CPU explicitly")
        return torch.device("cuda", local_rank())
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:  # a bare "cuda": the current card
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_backend(backend_name: Optional[str], device) -> str:
    """The backend for a rank on ``device``: ``backend_name`` when given,
    else the ``RAFT_TORCH_DIST_BACKEND`` knob, else ``nccl`` on a card and
    ``gloo`` on the CPU. NCCL on a CPU rank raises."""
    name = backend_name or knob_raw("RAFT_TORCH_DIST_BACKEND")
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if not name:
        name = "nccl" if dev.type == "cuda" else "gloo"
    if name not in BACKENDS:
        raise ValueError(f"unknown process-group backend {name!r}; choose from {BACKENDS}")
    if name == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a rank on a card, this rank is on {dev}; "
                         "use gloo for ranks on the CPU")
    return name


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device=None,
) -> bool:
    """Join the process world; returns whether a process group is up.

    The arguments default to the launcher's environment:
    ``coordinator_address`` is ``MASTER_ADDR:MASTER_PORT``,
    ``num_processes`` ``WORLD_SIZE`` and ``process_id`` ``RANK``. With
    neither arguments nor a launcher (or ``num_processes=1`` given) it does
    nothing. ``device`` is this rank's card (or the CPU): its backend
    (:func:`resolve_backend`), and for NCCL the card made current. A
    failed join raises; it never carries on as a single process."""
    dist = _dist()
    if initialized():
        return True
    explicit = coordinator_address is not None or process_id is not None
    if num_processes == 1 or not (explicit or launched()):
        return False
    env = os.environ
    if num_processes is None:
        if "WORLD_SIZE" not in env:
            raise ValueError("num_processes is needed with an explicit coordinator_address "
                             "or process_id when no launcher set WORLD_SIZE")
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    dev = torch.device(device) if device is not None else torch.device("cpu")
    name = resolve_backend(backend, dev)
    if name == "nccl":
        torch.cuda.set_device(dev)
    try:
        dist.init_process_group(
            name, init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
            rank=int(process_id),
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    except Exception as e:
        raise RuntimeError(
            f"joining the process world failed: rank {process_id} of {num_processes} at "
            f"{coordinator_address} over {name}: {e}") from e
    if name == "nccl":
        _refuse_shared_cards(dev)
    return True


def _card_id(dev: torch.device) -> str:
    props = torch.cuda.get_device_properties(dev)
    uuid = getattr(props, "uuid", None)
    return str(uuid) if uuid is not None else f"{socket.gethostname()}:{dev.index}"


def _refuse_shared_cards(dev: torch.device) -> None:
    """Under NCCL, raise on every rank when two ranks share a card: NCCL
    refuses it ("Duplicate GPU detected") at the first collective, which
    on a card shared by time-slicing can hang rather than fail. The ranks
    publish their cards' UUIDs through the store."""
    dist = _dist()
    store = dist.distributed_c10d._get_default_store()
    rank, world = process_index(), process_count()
    store.set(f"raft_torch_card/{rank}", _card_id(dev))
    cards = [store.get(f"raft_torch_card/{r}").decode() for r in range(world)]
    shared = [(r, s) for r in range(world) for s in range(r + 1, world) if cards[r] == cards[s]]
    if shared:
        r, s = shared[0]
        dist.destroy_process_group()
        raise RuntimeError(
            f"two NCCL ranks on one card: ranks {r} and {s} are both on {cards[r]}, and NCCL "
            "refuses a card shared by two ranks; give each rank its own card "
            "(torchrun --nproc_per_node at most the card count), or choose gloo "
            "(RAFT_TORCH_DIST_BACKEND=gloo)")


def count_collective(op: str, nbytes: int) -> None:
    """Count one collective of JAX's op name ``op`` moving ``nbytes``."""
    c = _COUNTS.setdefault(op, {"count": 0, "bytes": 0})
    c["count"] += 1
    c["bytes"] += nbytes


def all_reduce_(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """Reduce ``t`` over the ranks of ``group`` (default: the world) in
    place (``op``: sum, min or max) and return it. Under gloo a card tensor
    goes to the host through :func:`analysis.guards.collective_read` and
    comes back by a non-blocking copy; under NCCL a host tensor goes
    through the current card. Without a process group it is ``t``
    itself."""
    if not initialized():
        return t
    from raft_ncup_tpu_torch.analysis.guards import collective_read, host_read

    dist = _dist()
    red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}[op]
    count_collective("all-reduce", t.numel() * t.element_size())
    name = backend()
    if name == "gloo" and t.device.type == "cuda":
        host = collective_read(t.detach())
        dist.all_reduce(host, op=red, group=group)
        t.copy_(host, non_blocking=True)
    elif name == "nccl" and t.device.type == "cpu":
        card = t.to(torch.device("cuda", torch.cuda.current_device()))
        dist.all_reduce(card, op=red, group=group)
        t.copy_(torch.from_numpy(host_read(card)))
    else:
        dist.all_reduce(t, op=red, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """A sum over the ranks whose gradient is the sum over the ranks of
    the output's gradient: each rank's share of a global statistic gets
    the gradient of every rank's loss through it."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone())


def all_reduce_grad(x: torch.Tensor) -> torch.Tensor:
    """:func:`all_reduce_` (sum) as a differentiable function."""
    return _AllReduceSum.apply(x)


def allreduce_sum_across_hosts(x, group=None) -> np.ndarray:
    """Sum a host-side accumulator over the ranks of ``group`` (default:
    the world; numpy in and out; the sums and counts of a sharded
    validation, never means), so every rank returns the same global
    values. The shape must agree across ranks. One process: ``x`` as an
    array."""
    x = np.asarray(x)
    if not is_multihost():
        return x
    t = torch.from_numpy(np.array(x, dtype=np.float64))
    return all_reduce_(t, group=group).numpy().astype(x.dtype, copy=False)


def agreed_min(n: int) -> int:
    """The smallest of the ranks' ``n``: a length every rank has."""
    if not is_multihost():
        return int(n)
    return int(all_reduce_(torch.tensor([int(n)], dtype=torch.int64), op="min")[0])


def agreed_any(flag: bool) -> bool:
    """Whether ``flag`` is set on any rank (a host-side sum over them)."""
    if not is_multihost():
        return bool(flag)
    return int(all_reduce_(torch.tensor([int(bool(flag))], dtype=torch.int64))[0]) > 0


def barrier(name: str, timeout_s: Optional[float] = None) -> bool:
    """Block until every rank reaches the barrier ``name`` (its n-th call
    on each rank meets the others' n-th), through the process group's
    store, with no collective on a card. Returns True; raises
    ``TimeoutError`` after ``timeout_s`` (default:
    :data:`COLLECTIVE_TIMEOUT_S`). One
    process: True at once."""
    if not is_multihost():
        return True
    store = _dist().distributed_c10d._get_default_store()
    n = _barrier_calls.get(name, 0)
    _barrier_calls[name] = n + 1
    key = f"raft_torch_barrier/{name}/{n}"
    store.add(key, 1)
    world = process_count()
    limit = time.monotonic() + (COLLECTIVE_TIMEOUT_S if timeout_s is None else timeout_s)
    while store.add(key, 0) < world:
        if time.monotonic() > limit:
            raise TimeoutError(f"barrier {name!r}: {store.add(key, 0)} of {world} ranks "
                               "arrived in time")
        time.sleep(0.005)
    return True


def shutdown() -> None:
    """Leave the process world (a no-op without one)."""
    if initialized():
        _dist().destroy_process_group()
