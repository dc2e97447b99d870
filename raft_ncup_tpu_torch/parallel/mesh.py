"""The mesh of the port: the data, spatial and pipe axes over processes
(port of ``raft_ncup_tpu/parallel/mesh.py``).

JAX's mesh is a grid of devices with axes ``data``, ``spatial`` and
``pipe``, and XLA partitions one program over it. The port's mesh
describes the process world instead, one process per card, as a
``(data, spatial, pipe)`` grid with pipe fastest: rank ``(d * S + s) * P +
p`` is data index ``d``, spatial index ``s`` and pipe index ``p``, JAX's
device order (``np.asarray(devices).reshape(data, spatial, pipe)``).

- ``data``: each data index runs the whole model on its rows of the
  global batch, with the gradients, the loss and the metrics reduced
  across the data indices (``training/step.py``) and BatchNorm's
  statistics taken over the global batch (``nn/layers.BatchNorm2d``).
- ``spatial``: the ranks of one data index split the image height of the
  forward (``RAFT.forward(..., mesh=...)``): each holds a band of rows of
  every activation, the convolutions exchange row halos with the
  neighbours and the correlation reads the gathered fmap2
  (``parallel/halo.py``). Evaluation, the highres entry, the server, the
  stream engine and the fleet's slots run the test-mode forward so (the
  served paths in lockstep, ``parallel/lockstep.py``), training the
  train-mode forward and its backward (``training/step.py``).
- ``pipe``: the ranks of the pipe group split the refinement iterations
  into contiguous segments and stream micro-batches through them
  (``inference/pipe_schedule.PipelinedForward``, JAX's v1 rule: data and
  spatial of 1). The server, the stream engine and evaluation take any
  ``(D, S, P)``: each pipe index runs the ``(D, S)`` forward on the same
  batch, as XLA replicates a program over an axis that shards nothing, so
  the pipe indices are replicas of one another. The train and highres
  entries have no pipe axis (JAX has none there).

:func:`make_mesh` builds the process subgroups at once, on every rank in
the same order, each of them per pipe index: one per ``(d, p)`` (its
spatial ranks, for the halos and gathers, :func:`spatial_group`), one per
``(s, p)`` (its data ranks, for the metric sums and the outputs' gather,
:func:`data_group`) and one per ``(d, s)`` (its pipe ranks,
:func:`pipe_group`). A halo, gather or sum of pipe index ``p`` so runs
only among the ranks ``(d * S + s) * P + p``.

A data index holds the global batch's rows ``d::data`` (:func:`batch_sharding`):
the loader's shard of an epoch is every ``data``-th index, so the union of
the data indices' batches at a step is the one-process batch of that
step, and row ``j`` of data index ``d`` is its row ``j * data + d``. The
noise and dropout draws of the global shape take the same rows, so a
sample gets the draws it gets in one process.

:func:`mesh_fingerprint` gives JAX's strings (``nomesh``,
``mesh(data=1,spatial=2:gpu)``, ``mesh(data=2,spatial=1,pipe=2:gpu)``), and
:func:`collective_stats` counts the collectives this process issued in
JAX's format, from the counters of ``multihost.all_reduce_``, ``halo`` and
the pipe's hand-offs (the port has no HLO to parse).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from raft_ncup_tpu_torch.parallel import multihost

_COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "collective-permute",
    "all-to-all",
)


@dataclass(frozen=True)
class Mesh:
    """``data`` x ``spatial`` x ``pipe`` processes, this one ``rank``, on
    ``platform`` (``gpu`` or ``cpu``, JAX's platform names). ``shape``
    names ``pipe`` only above 1, as JAX's mesh does."""

    data: int
    rank: int
    platform: str
    spatial: int = 1
    pipe: int = 1

    @property
    def shape(self) -> dict:
        axes = {"data": self.data, "spatial": self.spatial}
        if self.pipe > 1:
            axes["pipe"] = self.pipe
        return axes

    @property
    def data_index(self) -> int:
        return self.rank // (self.spatial * self.pipe)

    @property
    def spatial_index(self) -> int:
        return (self.rank // self.pipe) % self.spatial

    @property
    def pipe_index(self) -> int:
        return self.rank % self.pipe

    @property
    def processes(self) -> int:
        return self.data * self.spatial * self.pipe


def check_axes(data: Optional[int] = None, spatial: int = 1, pipe: int = 1,
               world: Optional[int] = None) -> Optional[int]:
    """The port's mesh rule, which the mesh, the CLI and the train
    configuration all apply: every size is at least 1; with ``world``
    given, ``data`` (None: the world over ``spatial`` times ``pipe``) times
    ``spatial`` times ``pipe`` must equal it. Returns the data size."""
    if min(int(spatial), int(pipe), 1 if data is None else int(data)) < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data} spatial={spatial} "
                         f"pipe={pipe}")
    if world is None:
        return data
    spatial, pipe = int(spatial), int(pipe)
    data = world // (spatial * pipe) if data is None else int(data)
    if data * spatial * pipe != world:
        names = f"spatial size {spatial}" + (f" times pipe size {pipe}" if pipe > 1 else "")
        raise ValueError(
            f"mesh data size (--data_parallel / --mesh) {data} times {names} must equal the "
            f"world size {world}: the port's multi-GPU mesh is one process per card "
            f"(ROADMAP.md, queue 1 items 9a and 9b), started by the launcher (torchrun "
            f"--nproc_per_node {data * spatial * pipe} -m raft_ncup_tpu_torch.evaluate ...)")
    return data


def check_no_pipe(pipe: int, entry: str) -> None:
    """The train and highres entries have no pipe axis (nor has JAX)."""
    if int(pipe) > 1:
        raise ValueError(f"the {entry} entry has no pipe axis (got pipe={pipe}); the pipe "
                         "axis runs the pipelined test-mode forward "
                         "(inference/pipe_schedule.PipelinedForward), the server and "
                         "evaluation")


# Process subgroups by (data, spatial, pipe): the spatial groups by (d, p),
# the data groups by (s, p) and the pipe groups by (d, s).
# ``torch.distributed.new_group`` is collective, so every rank builds all
# of them once, in the same order.
_GROUPS: dict = {}


def _rank(d: int, s: int, p: int, spatial: int, pipe: int) -> int:
    return (d * spatial + s) * pipe + p


def _subgroups(data: int, spatial: int, pipe: int) -> Optional[dict]:
    if not multihost.initialized():
        return None
    key = (data, spatial, pipe)
    if key not in _GROUPS:
        new = multihost._dist().new_group
        D, S, P = key
        # A spatial or pipe axis of 1 has no group; the data groups exist
        # whenever they are not the world, of one rank each when D = 1.
        _GROUPS[key] = {
            "spatial": {(d, p): new([_rank(d, s, p, S, P) for s in range(S)])
                        for d in range(D) for p in range(P)} if S > 1 else {},
            "data": {(s, p): new([_rank(d, s, p, S, P) for d in range(D)])
                     for s in range(S) for p in range(P)},
            "pipe": {(d, s): new([_rank(d, s, p, S, P) for p in range(P)])
                     for d in range(D) for s in range(S)} if P > 1 else {},
        }
    return _GROUPS[key]


def _groups(mesh: Mesh, axis: str) -> dict:
    groups = _subgroups(mesh.data, mesh.spatial, mesh.pipe)
    if groups is None:
        raise RuntimeError(f"a mesh of {mesh.processes} processes needs the process world "
                           "joined (parallel.multihost.initialize_distributed)")
    return groups[axis]


def make_mesh(
    data: Optional[int] = None, spatial: int = 1, pipe: int = 1, device=None,
) -> Mesh:
    """The mesh of this process world (:func:`check_axes` against its
    size), with its subgroups built (a collective: every rank calls it)
    whenever a spatial or pipe axis is above 1; a mesh ``(D, 1, 1)`` needs
    none, its data group being the world. ``device`` (default: a card when
    CUDA is present) names the platform."""
    data = check_axes(data, spatial, pipe, multihost.process_count())
    if device is None:
        platform = "gpu" if torch.cuda.is_available() else "cpu"
    else:
        platform = "gpu" if torch.device(device).type == "cuda" else "cpu"
    mesh = Mesh(data=data, rank=multihost.process_index(), platform=platform,
                spatial=int(spatial), pipe=int(pipe))
    if mesh.spatial * mesh.pipe > 1:
        _groups(mesh, "data")
    return mesh


def pipe_group(mesh: Optional[Mesh]):
    """The process group of ``mesh.rank``'s pipe axis (the ``pipe`` ranks
    of its data and spatial index, in pipe order), or None without a pipe
    axis above 1."""
    if mesh is None or mesh.pipe <= 1:
        return None
    return _groups(mesh, "pipe")[(mesh.data_index, mesh.spatial_index)]


def spatial_group(mesh: Optional[Mesh]):
    """The ``halo.SpatialGroup`` of ``mesh.rank`` (the spatial ranks of its
    data and pipe index, whose neighbours are ``rank - pipe`` and ``rank +
    pipe``), or None without a spatial axis above 1."""
    from raft_ncup_tpu_torch.parallel.halo import SpatialGroup

    if mesh is None or mesh.spatial <= 1:
        return None
    d, p, S, P = mesh.data_index, mesh.pipe_index, mesh.spatial, mesh.pipe
    return SpatialGroup(size=S, index=mesh.spatial_index,
                        ranks=tuple(_rank(d, s, p, S, P) for s in range(S)),
                        group=_groups(mesh, "spatial")[(d, p)])


def data_ranks(mesh: Mesh) -> tuple:
    """The global ranks of ``mesh.rank``'s data group, in data order."""
    s, p, S, P = mesh.spatial_index, mesh.pipe_index, mesh.spatial, mesh.pipe
    return tuple(_rank(d, s, p, S, P) for d in range(mesh.data))


def data_group(mesh: Optional[Mesh]):
    """The process group of ``mesh.rank``'s spatial and pipe index (its
    data ranks), over which the metric sums and the outputs' gather run;
    None (the world) when that is the whole world: no mesh, or spatial and
    pipe sizes of 1."""
    if mesh is None or mesh.spatial * mesh.pipe == 1:
        return None
    return _groups(mesh, "data")[(mesh.spatial_index, mesh.pipe_index)]


def resolve_config_mesh(mesh: Optional[Mesh], cfg_mesh, device=None) -> tuple:
    """JAX's resolution rule: an explicit ``mesh`` wins, else a config's
    ``(data, spatial[, pipe])`` sizes build one (:func:`make_mesh`, its
    platform ``device``'s), else none. Returns ``(mesh or None, pad
    divisor)``, the divisor ``8 * spatial`` (the pipe axis shards no image
    dimension)."""
    if mesh is None and cfg_mesh is not None:
        mesh = make_mesh(data=int(cfg_mesh[0]), spatial=int(cfg_mesh[1]),
                         pipe=int(cfg_mesh[2]) if len(cfg_mesh) > 2 else 1, device=device)
    spatial = int(mesh.shape.get("spatial", 1)) if mesh is not None else 1
    return mesh, 8 * spatial


def mesh_fingerprint(mesh: Optional[Mesh]) -> str:
    """JAX's identity string of a mesh: ``nomesh``,
    ``mesh(data=N,spatial=1:gpu)``, or ``mesh(data=D,spatial=S,pipe=P:gpu)``
    with a pipe axis above 1."""
    if mesh is None:
        return "nomesh"
    axes = ",".join(f"{k}={v}" for k, v in mesh.shape.items())
    return f"mesh({axes}:{mesh.platform})"


def pad_divisor(mesh: Optional[Mesh]) -> int:
    """The height every image pads to a multiple of under ``mesh``: 8 times
    its spatial size (JAX's ``evaluation._pad_divisor``), so every band at
    1/8 resolution has the same whole number of rows."""
    return 8 * (mesh.spatial if mesh is not None else 1)


def batch_sharding(mesh: Mesh) -> slice:
    """The rows of the global batch that ``mesh.rank`` holds: those of its
    data index (every spatial rank of it holds the same rows)."""
    return slice(mesh.data_index, None, mesh.data)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """The rank's rows of each array of a global batch (lists, such as
    ``extra_info``, too)."""
    rows = batch_sharding(mesh)
    return {k: v[rows] for k, v in batch.items()}


def collective_stats() -> dict:
    """The collectives this process issued since the last
    :func:`reset_collective_stats`, in JAX's format: ``collectives``,
    ``collective_bytes`` and ``by_op`` (every op kind present)."""
    by_op = {op: dict(multihost._COUNTS.get(op, {"count": 0, "bytes": 0}))
             for op in _COLLECTIVE_OPS}
    return {
        "collectives": sum(v["count"] for v in by_op.values()),
        "collective_bytes": sum(v["bytes"] for v in by_op.values()),
        "by_op": by_op,
    }


def reset_collective_stats() -> None:
    multihost._COUNTS.clear()
