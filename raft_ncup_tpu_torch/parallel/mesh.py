"""The mesh of the port: the data and spatial axes over processes (port
of ``raft_ncup_tpu/parallel/mesh.py``).

JAX's mesh is a grid of devices with axes ``data``, ``spatial`` and
``pipe``, and XLA partitions one program over it. The port's mesh
describes the process world instead, one process per card, as a
``(data, spatial)`` grid with spatial fastest: rank ``d * S + s`` is data
index ``d`` and spatial index ``s``, JAX's device order
(``np.asarray(devices).reshape(data, spatial)``).

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
  train-mode forward and its backward (``training/step.py``). A pipe axis
  above 1 raises everywhere (ROADMAP.md queue 1 item 9b-iv).

:func:`make_mesh` builds the process subgroups at once, on every rank in
the same order: one per data index (its spatial ranks, for the halos and
gathers, :func:`spatial_group`) and one per spatial index (its data ranks,
for the metric sums, :func:`data_group`).

A data index holds the global batch's rows ``d::data`` (:func:`batch_sharding`):
the loader's shard of an epoch is every ``data``-th index, so the union of
the data indices' batches at a step is the one-process batch of that
step, and row ``j`` of data index ``d`` is its row ``j * data + d``. The
noise and dropout draws of the global shape take the same rows, so a
sample gets the draws it gets in one process.

:func:`mesh_fingerprint` gives JAX's strings (``nomesh``,
``mesh(data=1,spatial=2:gpu)``), and :func:`collective_stats` counts the
collectives this process issued in JAX's format, from the counters of
``multihost.all_reduce_`` and ``halo`` (the port has no HLO to parse).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from raft_ncup_tpu_torch.parallel import multihost

# The part of ROADMAP.md queue 1 item 9b still to come, named by the
# refusal.
ITEM_9B_PIPE = "ROADMAP.md, queue 1 item 9b-iv (the pipe axis)"
_COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "collective-permute",
    "all-to-all",
)


@dataclass(frozen=True)
class Mesh:
    """``data`` x ``spatial`` processes, this one ``rank``, on ``platform``
    (``gpu`` or ``cpu``, JAX's platform names)."""

    data: int
    rank: int
    platform: str
    spatial: int = 1

    @property
    def shape(self) -> dict:
        return {"data": self.data, "spatial": self.spatial}

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial

    @property
    def processes(self) -> int:
        return self.data * self.spatial


def check_axes(data: Optional[int] = None, spatial: int = 1, pipe: int = 1,
               world: Optional[int] = None) -> Optional[int]:
    """The port's mesh rule, which the mesh, the CLI and the train
    configuration all apply: every size is at least 1; a pipe axis above
    1 raises (not in the port yet); with ``world`` given, ``data`` (None:
    the world over ``spatial``) times ``spatial`` must equal it. Returns
    the data size."""
    if min(int(spatial), int(pipe), 1 if data is None else int(data)) < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data} spatial={spatial} "
                         f"pipe={pipe}")
    if int(pipe) > 1:
        raise ValueError(
            f"the multi-GPU pipe axis ({pipe}) is not in the port yet, only the data and "
            f"spatial axes across processes are: {ITEM_9B_PIPE} brings it")
    if world is None:
        return data
    spatial = int(spatial)
    data = world // spatial if data is None else int(data)
    if data * spatial != world:
        raise ValueError(
            f"mesh data size (--data_parallel / --mesh) {data} times spatial size "
            f"{spatial} must equal the world size {world}: the port's multi-GPU mesh is one "
            f"process per card (ROADMAP.md, queue 1 items 9a and 9b), started by the launcher "
            f"(torchrun --nproc_per_node {data * spatial} -m raft_ncup_tpu_torch.evaluate "
            "...)")
    return data


# Process subgroups by (data, spatial): (one per data index, one per
# spatial index). ``torch.distributed.new_group`` is collective, so every
# rank builds all of them once, in the same order.
_GROUPS: dict = {}


def _subgroups(data: int, spatial: int) -> tuple:
    if not multihost.initialized():
        return None, None
    key = (data, spatial)
    if key not in _GROUPS:
        dist = multihost._dist()
        by_data = [dist.new_group([d * spatial + s for s in range(spatial)])
                   for d in range(data)]
        by_spatial = [dist.new_group([d * spatial + s for d in range(data)])
                      for s in range(spatial)]
        _GROUPS[key] = (by_data, by_spatial)
    return _GROUPS[key]


def make_mesh(
    data: Optional[int] = None, spatial: int = 1, pipe: int = 1, device=None,
) -> Mesh:
    """The mesh of this process world (:func:`check_axes` against its
    size), with its subgroups built (a collective when ``spatial`` is
    above 1: every rank calls it). ``device`` (default: a card when CUDA is
    present) names the platform."""
    data = check_axes(data, spatial, pipe, multihost.process_count())
    if device is None:
        platform = "gpu" if torch.cuda.is_available() else "cpu"
    else:
        platform = "gpu" if torch.device(device).type == "cuda" else "cpu"
    if int(spatial) > 1:
        _subgroups(data, int(spatial))
    return Mesh(data=data, rank=multihost.process_index(), platform=platform,
                spatial=int(spatial))


def spatial_group(mesh: Optional[Mesh]):
    """The ``halo.SpatialGroup`` of ``mesh.rank`` (its data index's spatial
    ranks), or None without a spatial axis above 1."""
    from raft_ncup_tpu_torch.parallel.halo import SpatialGroup

    if mesh is None or mesh.spatial <= 1:
        return None
    by_data, _ = _subgroups(mesh.data, mesh.spatial)
    if by_data is None:
        raise RuntimeError(f"a mesh with spatial={mesh.spatial} needs the process world "
                           "joined (parallel.multihost.initialize_distributed)")
    d, S = mesh.data_index, mesh.spatial
    return SpatialGroup(size=S, index=mesh.spatial_index,
                        ranks=tuple(d * S + s for s in range(S)), group=by_data[d])


def data_group(mesh: Optional[Mesh]):
    """The process group of ``mesh.rank``'s spatial index (its data ranks),
    over which the metric sums reduce; None (the world) without a spatial
    axis above 1."""
    if mesh is None or mesh.spatial <= 1:
        return None
    _, by_spatial = _subgroups(mesh.data, mesh.spatial)
    return None if by_spatial is None else by_spatial[mesh.spatial_index]


def resolve_config_mesh(mesh: Optional[Mesh], cfg_mesh, device=None) -> tuple:
    """JAX's resolution rule: an explicit ``mesh`` wins, else a config's
    ``(data, spatial[, pipe])`` sizes build one (:func:`make_mesh`, its
    platform ``device``'s), else none. Returns ``(mesh or None, pad
    divisor)``, the divisor ``8 * spatial``."""
    if mesh is None and cfg_mesh is not None:
        mesh = make_mesh(data=int(cfg_mesh[0]), spatial=int(cfg_mesh[1]),
                         pipe=int(cfg_mesh[2]) if len(cfg_mesh) > 2 else 1, device=device)
    spatial = int(mesh.shape.get("spatial", 1)) if mesh is not None else 1
    return mesh, 8 * spatial


def mesh_fingerprint(mesh: Optional[Mesh]) -> str:
    """JAX's identity string of a mesh: ``nomesh``, or
    ``mesh(data=N,spatial=1:gpu)``."""
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
