"""The mesh of the port: the data axis over processes (port of
``raft_ncup_tpu/parallel/mesh.py``).

JAX's mesh is a grid of devices with axes ``data``, ``spatial`` and
``pipe``, and XLA partitions one program over it. The port's mesh
describes the process world instead: ``data`` ranks, one process per
card, each running the whole model on its rows of the global batch, with
the gradients, the loss and the metrics reduced across the ranks
(``training/step.py``) and BatchNorm's statistics taken over the global
batch (``nn/layers.BatchNorm2d``). The spatial axis (a halo exchange for
every convolution) and the pipe axis (``PipelinedForward``) are not in
the port: ``spatial > 1`` and ``pipe > 1`` raise, naming ROADMAP.md queue
1 item 9b.

A rank holds the global batch's rows ``rank::data`` (:func:`batch_sharding`):
the loader's shard of an epoch is every ``data``-th index, so the union of
the ranks' batches at a step is the one-process batch of that step, and
row ``j`` of rank ``r`` is its row ``j * data + r``. The noise and dropout
draws of the global shape take the same rows, so a sample gets the draws
it gets in one process.

:func:`mesh_fingerprint` gives JAX's strings (``nomesh``,
``mesh(data=2,spatial=1:gpu)``), and :func:`collective_stats` counts the
collectives this process issued in JAX's format, from the counters of
``multihost.all_reduce_`` (the port has no HLO to parse).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from raft_ncup_tpu_torch.parallel import multihost

ITEM_9B = "ROADMAP.md, queue 1 item 9b"
_COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "collective-permute",
    "all-to-all",
)


@dataclass(frozen=True)
class Mesh:
    """``data`` processes, this one ``rank``, on ``platform`` (``gpu`` or
    ``cpu``, JAX's platform names)."""

    data: int
    rank: int
    platform: str
    spatial: int = 1

    @property
    def shape(self) -> dict:
        return {"data": self.data, "spatial": self.spatial}


def check_axes(data: Optional[int] = None, spatial: int = 1, pipe: int = 1,
               world: Optional[int] = None) -> Optional[int]:
    """The port's mesh rule, which the mesh, the CLI and the train
    configuration all apply: every size is at least 1; a spatial or pipe
    axis above 1 raises (not in the port yet); with ``world`` given,
    ``data`` (None: the world size) must equal it. Returns the data size."""
    if min(int(spatial), int(pipe), 1 if data is None else int(data)) < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data} spatial={spatial} "
                         f"pipe={pipe}")
    if int(spatial) > 1 or int(pipe) > 1:
        raise ValueError(
            f"the multi-GPU spatial axis ({spatial}) and pipe axis ({pipe}) are not in the "
            f"port yet, only the data axis across processes is: {ITEM_9B} brings them")
    if world is None:
        return data
    data = world if data is None else int(data)
    if data != world:
        raise ValueError(
            f"mesh data size (--data_parallel / --mesh) {data} must equal the world size "
            f"{world}: the port's data axis is one process per card (ROADMAP.md, queue 1 "
            f"item 9a), started by the launcher (torchrun --nproc_per_node {data} -m "
            "raft_ncup_tpu_torch.train ...)")
    return data


def make_mesh(
    data: Optional[int] = None, spatial: int = 1, pipe: int = 1, device=None,
) -> Mesh:
    """The mesh of this process world (:func:`check_axes` against its
    size). ``device`` (default: a card when CUDA is present) names the
    platform."""
    data = check_axes(data, spatial, pipe, multihost.process_count())
    if device is None:
        platform = "gpu" if torch.cuda.is_available() else "cpu"
    else:
        platform = "gpu" if torch.device(device).type == "cuda" else "cpu"
    return Mesh(data=data, rank=multihost.process_index(), platform=platform)


def resolve_config_mesh(mesh: Optional[Mesh], cfg_mesh) -> tuple:
    """JAX's resolution rule: an explicit ``mesh`` wins, else a config's
    ``(data, spatial[, pipe])`` sizes build one, else none. Returns
    ``(mesh or None, pad divisor)``, the divisor ``8 * spatial``."""
    if mesh is None and cfg_mesh is not None:
        mesh = make_mesh(data=int(cfg_mesh[0]), spatial=int(cfg_mesh[1]),
                         pipe=int(cfg_mesh[2]) if len(cfg_mesh) > 2 else 1)
    spatial = int(mesh.shape.get("spatial", 1)) if mesh is not None else 1
    return mesh, 8 * spatial


def mesh_fingerprint(mesh: Optional[Mesh]) -> str:
    """JAX's identity string of a mesh: ``nomesh``, or
    ``mesh(data=N,spatial=1:gpu)``."""
    if mesh is None:
        return "nomesh"
    axes = ",".join(f"{k}={v}" for k, v in mesh.shape.items())
    return f"mesh({axes}:{mesh.platform})"


def batch_sharding(mesh: Mesh) -> slice:
    """The rows of the global batch that ``mesh.rank`` holds."""
    return slice(mesh.rank, None, mesh.data)


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
