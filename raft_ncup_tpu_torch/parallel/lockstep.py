"""Lockstep dispatch of the served paths over a mesh of processes.

JAX serves a mesh as one program over many chips: one process admits,
batches and dispatches, and XLA runs the program on every chip. The port's
mesh is a world of processes, one per card (``parallel/mesh.py``), so the
server and the stream engine run in lockstep. Rank 0 of the world, the
leader, alone admits requests, batches them, sheds and times out, and
keeps the telemetry, healthz and the socket. On every dispatch it
broadcasts a small header to every rank (the operation, the padded shape
and size of its batch, the iterations, the early-exit tolerance, a stream
step's slot indices and cold flags, whether it is a warm-up), then the
staged frames. Each follower loops on the headers (:meth:`Lockstep.follow`)
and runs the same cached entry, in the same order, on its band and data
rows, so every rank issues the same collectives in the same order. An
operation holds the group's lock on the leader from its broadcast to its
end: the server's and the stream engine's dispatches (a fleet replica runs
both) never interleave their collectives.

Headers travel as host bytes over gloo (a gloo group of the world under
NCCL); the frames over the world's backend: under gloo the host copy that
``stage_frames`` already made (a card tensor is never read back to be
sent), under NCCL a copy on the card. Each broadcast counts under the
port's own op name ``lockstep-broadcast`` (:func:`lockstep_stats`), beside
JAX's five op names of ``mesh.collective_stats``, which keep their
meaning.

A batch's rows split over the data axis in contiguous blocks, as JAX's
``P("data", ...)`` lays them out: :func:`data_rows` takes this rank's
block, :func:`gather_data` joins an output's blocks on every rank (an
``all-gather`` over the data group of this rank's spatial and pipe
index). Under a pipe axis every pipe index runs the same ``(data,
spatial)`` forward on the same batch, JAX's replication over ``pipe``:
the header still goes to every rank of the world, and each pipe index's
halos, gathers and sums stay among its own ranks.

The group serves as one replica: an operation that fails on the leader
breaks it (every later dispatch raises), since the followers may have
issued collectives the leader did not. :meth:`Lockstep.stop` ends the
followers' loops with the leader's exit code.
"""

from __future__ import annotations

import contextlib
import json
import sys
import threading
from typing import Callable, Optional

import numpy as np
import torch

from raft_ncup_tpu_torch.parallel import halo, multihost
from raft_ncup_tpu_torch.parallel.mesh import Mesh, data_group, data_ranks

OPS = ("serve", "stream", "stop")
# Bytes of one header: its length (4 bytes, little-endian) and its JSON.
HEADER_BYTES = 8192
BROADCAST_OP = "lockstep-broadcast"


class Lockstep:
    """The lockstep group of a mesh of more than one process, on every
    rank of the world, built by every rank at the same point (under NCCL it
    builds a gloo group of the world, a collective). ``device`` is this
    rank's: under gloo a follower receives the frames in pinned host
    memory when it is a card."""

    def __init__(self, mesh: Mesh, device):
        if mesh is None or mesh.processes < 2 or not multihost.initialized():
            raise ValueError("a lockstep group needs a mesh of more than one process in a "
                             "joined world")
        self.mesh = mesh
        self.device = torch.device(device)
        self.leader = multihost.process_index() == 0
        self._nccl = multihost.backend() == "nccl"
        dist = multihost._dist()
        self._headers = dist.new_group(backend="gloo") if self._nccl else None
        self._lock = threading.Lock()
        self._broken: Optional[BaseException] = None
        self.stopped = False
        # Operations dispatched (leader) or run (follower), by op; a
        # warm-up's under "<op>_warmup".
        self.ops: dict = {}

    # ------------------------------------------------------------- leader

    @contextlib.contextmanager
    def dispatch(self, op: str, header: Optional[dict] = None, tensors: tuple = ()):
        """On the leader: broadcast ``op``'s header and ``tensors``, then
        run the body under the group's lock. Yields the tensors to run on
        (under NCCL their copies on the card). A body that raises breaks
        the group."""
        if not self.leader:
            raise RuntimeError("only the leader (rank 0) dispatches")
        if op not in OPS or op == "stop":
            raise ValueError(f"unknown lockstep operation {op!r}")
        header = dict(header or {})
        with self._lock:
            if self._broken is not None or self.stopped:
                state = "stopped" if self.stopped else "broken"
                raise RuntimeError(f"the lockstep group is {state}: {self._broken!r}")
            try:
                yield self._send(op, header, tensors)
            except BaseException as e:
                self._broken = e
                raise
            self._count(op, header)

    @property
    def broken(self) -> Optional[BaseException]:
        """The error that broke the group (an operation failed on the
        leader), or None."""
        return self._broken

    def stop(self, rc: int = 0) -> None:
        """On the leader: end the followers' loops, each returning ``rc``.
        Idempotent. A broken group sends nothing (its followers may wait
        in another collective): they fail when the leader's process ends.
        A group whose follower is gone reports it on stderr."""
        if not self.leader:
            raise RuntimeError("only the leader (rank 0) stops the group")
        with self._lock:
            if self.stopped:
                return
            self.stopped = True
            if self._broken is not None:
                print(f"lockstep: not stopping a broken group: {self._broken!r}",
                      file=sys.stderr)
                return
            try:
                self._send("stop", {"rc": int(rc)}, ())
            except Exception as e:  # noqa: BLE001 - the group is gone either way
                print(f"lockstep: stop not delivered: {e!r}", file=sys.stderr)

    def _send(self, op: str, header: dict, tensors: tuple) -> tuple:
        specs = [[list(t.shape), str(t.dtype).removeprefix("torch.")] for t in tensors]
        raw = json.dumps({**header, "op": op, "tensors": specs}).encode()
        if len(raw) > HEADER_BYTES - 4:
            raise ValueError(f"a lockstep header of {len(raw)} bytes exceeds {HEADER_BYTES - 4}")
        buf = np.zeros(HEADER_BYTES, np.uint8)
        buf[:4] = np.frombuffer(len(raw).to_bytes(4, "little"), np.uint8)
        buf[4: 4 + len(raw)] = np.frombuffer(raw, np.uint8)
        self._broadcast_header(buf)
        return tuple(self._broadcast(self._wire(t)) for t in tensors)

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        if self._nccl:
            return t.to(torch.device("cuda", torch.cuda.current_device()), non_blocking=True)
        if t.device.type == "cuda":
            from raft_ncup_tpu_torch.analysis.guards import collective_read

            return collective_read(t)
        return t

    # ----------------------------------------------------------- follower

    def receive(self) -> tuple:
        """On a follower: the next operation, ``(op, header, tensors)``."""
        buf = np.zeros(HEADER_BYTES, np.uint8)
        self._broadcast_header(buf)
        n = int.from_bytes(buf[:4].tobytes(), "little")
        header = json.loads(buf[4: 4 + n].tobytes())
        op = header.pop("op")
        tensors = tuple(self._broadcast(self._buffer(shape, dtype))
                        for shape, dtype in header.pop("tensors"))
        return op, header, tensors

    def _buffer(self, shape, dtype: str) -> torch.Tensor:
        dtype = getattr(torch, dtype)
        if self._nccl:
            return torch.empty(shape, dtype=dtype,
                               device=torch.device("cuda", torch.cuda.current_device()))
        return torch.empty(shape, dtype=dtype, pin_memory=self.device.type == "cuda")

    def follow(self, handlers: dict, on_live: Optional[Callable] = None) -> int:
        """On a follower: run each operation the leader dispatches, in
        order, as ``handlers[op](header, tensors)``, until the leader stops
        the group; returns the leader's exit code. ``on_live()``, when
        given, runs once, just before the handler of the first operation
        that is not a warm-up. A handler that raises ends the loop with its
        error (the group cannot go on)."""
        if self.leader:
            raise RuntimeError("the leader (rank 0) does not follow")
        while True:
            op, header, tensors = self.receive()
            if op == "stop":
                self.stopped = True
                return int(header.get("rc", 0))
            handler: Optional[Callable] = handlers.get(op)
            if handler is None:
                raise RuntimeError(f"lockstep: no handler for {op!r} on rank "
                                   f"{multihost.process_index()}")
            if on_live is not None and not header.get("warmup"):
                on_live()
                on_live = None
            handler(header, tensors)
            self._count(op, header)

    # -------------------------------------------------------------- shared

    def _broadcast_header(self, buf: np.ndarray) -> None:
        multihost.count_collective(BROADCAST_OP, buf.nbytes)
        multihost._dist().broadcast(torch.from_numpy(buf), src=0, group=self._headers)

    def _broadcast(self, t: torch.Tensor) -> torch.Tensor:
        multihost.count_collective(BROADCAST_OP, t.numel() * t.element_size())
        multihost._dist().broadcast(t, src=0)
        return t

    def _count(self, op: str, header: dict) -> None:
        key = f"{op}_warmup" if header.get("warmup") else op
        self.ops[key] = self.ops.get(key, 0) + 1


def lockstep_stats() -> dict:
    """The lockstep broadcasts this process issued since the last
    ``mesh.reset_collective_stats``: ``broadcasts`` and ``bytes``."""
    c = multihost._COUNTS.get(BROADCAST_OP, {"count": 0, "bytes": 0})
    return {"broadcasts": c["count"], "bytes": c["bytes"]}


def data_rows(t: Optional[torch.Tensor], mesh: Optional[Mesh]) -> Optional[torch.Tensor]:
    """This rank's block of a global batch ``t`` (its rows ``[d n, (d + 1)
    n)``, ``n = B / data``, for data index ``d``); ``t`` itself without a
    data axis above 1."""
    if t is None or mesh is None or mesh.data == 1:
        return t
    n = t.shape[0] // mesh.data
    return t[mesh.data_index * n: (mesh.data_index + 1) * n]


def gather_data(t: Optional[torch.Tensor], mesh: Optional[Mesh]) -> Optional[torch.Tensor]:
    """The global batch of which ``t`` is this rank's block, on every rank:
    an ``all-gather`` over this rank's data group, the ranks of its spatial
    and pipe index (the spatial ranks of a data index hold equal outputs,
    and so do the pipe indices); ``t`` itself without a data axis above
    1."""
    if t is None or mesh is None or mesh.data == 1:
        return t
    group = halo.SpatialGroup(size=mesh.data, index=mesh.data_index, ranks=data_ranks(mesh),
                              group=data_group(mesh))
    return halo.all_gather_rows(t.contiguous(), dim=0, group=group)
