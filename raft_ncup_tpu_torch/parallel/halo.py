"""Row halos of the spatial axis: the image height split over the ranks of
a spatial group, one process per card.

JAX shards the height over the mesh's ``spatial`` axis and lets XLA insert
a halo exchange (``collective-permute``) at every convolution that reads
across a shard's edge. The port does the same by hand. Rank ``s`` of a
group of ``S`` holds rows ``[s h, (s + 1) h)`` of every activation, ``h =
H / S`` at each resolution, so a band's global first row is ``s h``. While
a :func:`spatial` context is active (``RAFT.forward(..., mesh=...)`` sets
it), ``nn.layers.Conv2d`` pads its input's height with the neighbours'
rows (:func:`extend`) instead of zeros; the rank at the image's top or
bottom edge gets zero rows there, which are the zero padding of the
whole-image convolution. The NConv layers (``ops/nconv.py``) and the
convex upsampler (``ops/geometry.py``) do the same.

:func:`halo_rows` is the arithmetic, a pure function: the rows a band
needs above and below it for one convolution. :func:`extend` moves them,
with ``torch.distributed.batch_isend_irecv`` between neighbours.
:func:`all_gather_rows` gathers the bands of a tensor (the correlation's
fmap2 and the outputs), :func:`group_sum_` sums over the group (the
instance norm's statistics). Each counts its calls and bytes under JAX's
op name (``collective-permute``, ``all-gather``, ``all-reduce``:
``mesh.collective_stats`` reads them); a halo's bytes are its rows above
and below, as the shape of JAX's permute result. Under gloo a card tensor
goes through the host, as ``multihost.all_reduce_`` does: the copy is
``analysis.guards.collective_read``, a sanctioned and counted read.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from raft_ncup_tpu_torch.parallel import multihost


@dataclass(frozen=True)
class SpatialGroup:
    """This rank's place in its spatial group: ``index`` of ``size``, the
    group's global ``ranks`` in spatial order, and its process ``group``."""

    size: int
    index: int
    ranks: tuple
    group: object = None


_tl = threading.local()


def current() -> Optional[SpatialGroup]:
    """The spatial group of the forward running on this thread, or None."""
    return getattr(_tl, "group", None)


@contextlib.contextmanager
def spatial(group: Optional[SpatialGroup]):
    """Within this context (on this thread) the layers exchange row halos
    over ``group``; None, or a group of one, makes them local."""
    prev = current()
    _tl.group = group if group is not None and group.size > 1 else None
    try:
        yield
    finally:
        _tl.group = prev


@contextlib.contextmanager
def local():
    """Within this context the layers run on whole tensors, no halos."""
    prev = current()
    _tl.group = None
    try:
        yield
    finally:
        _tl.group = prev


def first_row(rows: int) -> int:
    """The global first row of this rank's band of ``rows`` rows (0 with no
    active group)."""
    sp = current()
    return 0 if sp is None else sp.index * int(rows)


def halo_rows(kernel: int, stride: int, padding: int, dilation: int, first: int,
              rows: int) -> tuple[int, int]:
    """Rows a band needs above and below it (negative: rows it can drop)
    for a convolution of height ``kernel``, ``stride``, zero ``padding``
    and ``dilation`` over the whole image, when the band is the ``rows``
    rows from global row ``first``. The band owns the output rows ``o``
    with ``first <= o * stride < first + rows``; output row ``o`` reads
    input rows ``o * stride - padding + j * dilation``, ``j < kernel``."""
    kernel, stride, padding, dilation = int(kernel), int(stride), int(padding), int(dilation)
    o0 = -(-int(first) // stride)
    o1 = -(-(int(first) + int(rows)) // stride) - 1
    top = int(first) - (o0 * stride - padding)
    bottom = o1 * stride - padding + (kernel - 1) * dilation - (int(first) + int(rows) - 1)
    return top, bottom


def band(x: Optional[torch.Tensor], dim: int = 1) -> Optional[torch.Tensor]:
    """This rank's band of the whole tensor ``x`` along ``dim`` (``x`` itself
    with no active group, None for None)."""
    sp = current()
    if x is None or sp is None:
        return x
    n = x.shape[dim]
    if n % sp.size:
        raise ValueError(f"{n} rows do not split into {sp.size} equal bands")
    h = n // sp.size
    return x.narrow(dim, sp.index * h, h)


def _on_host(t: torch.Tensor) -> bool:
    """Whether a collective on ``t`` goes through the host: gloo with a
    card tensor."""
    return t.device.type == "cuda" and multihost.backend() == "gloo"


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    if _on_host(t):
        from raft_ncup_tpu_torch.analysis.guards import collective_read

        return collective_read(t)
    return t


def _wire_buffer(like: torch.Tensor, shape) -> torch.Tensor:
    if _on_host(like):
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def extend(x: torch.Tensor, top: int, bottom: int, dim: int = 2) -> torch.Tensor:
    """``x``, this rank's band, with ``top`` rows of the rank above it and
    ``bottom`` rows of the rank below it joined along ``dim`` (zeros at the
    image's edges); a negative count drops that many of the band's own
    rows. One exchange with the neighbours, counted as a
    ``collective-permute`` of the halo's bytes; none when both counts are
    at most 0. Every rank of the group must call it with the same counts."""
    sp = current()
    if sp is None:
        raise RuntimeError("halo.extend needs an active spatial group")
    h = x.shape[dim]
    if top < 0:
        x, h, top = x.narrow(dim, -top, h + top), h + top, 0
    if bottom < 0:
        x, h, bottom = x.narrow(dim, 0, h + bottom), h + bottom, 0
    if top == 0 and bottom == 0:
        return x
    if top > h or bottom > h:
        raise ValueError(f"a halo of {top} rows above and {bottom} below is more than the "
                         f"band's {h} rows: split the height over fewer ranks")
    shape = list(x.shape)
    row_bytes = x.numel() // max(h, 1) * x.element_size()
    multihost.count_collective("collective-permute", (top + bottom) * row_bytes)
    dist = multihost._dist()
    s, ranks = sp.index, sp.ranks
    ops, above, below = [], None, None
    if top and s > 0:
        shape[dim] = top
        above = _wire_buffer(x, shape)
        ops.append(dist.P2POp(dist.irecv, above, ranks[s - 1], sp.group))
    if bottom and s > 0:
        ops.append(dist.P2POp(dist.isend, _to_wire(x.narrow(dim, 0, bottom)), ranks[s - 1],
                              sp.group))
    if top and s < sp.size - 1:
        ops.append(dist.P2POp(dist.isend, _to_wire(x.narrow(dim, h - top, top)), ranks[s + 1],
                              sp.group))
    if bottom and s < sp.size - 1:
        shape[dim] = bottom
        below = _wire_buffer(x, shape)
        ops.append(dist.P2POp(dist.irecv, below, ranks[s + 1], sp.group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()

    def rows(buf, n):
        if n == 0:
            return None
        if buf is None:  # the image's edge: the whole-image op's zero padding
            shape[dim] = n
            return x.new_zeros(shape)
        return buf.to(x.device, non_blocking=True)

    parts = [rows(above, top), x, rows(below, bottom)]
    return torch.cat([p for p in parts if p is not None], dim=dim)


def all_gather_rows(x: torch.Tensor, dim: int = 1,
                    group: Optional[SpatialGroup] = None) -> torch.Tensor:
    """The whole tensor of which ``x`` is this rank's band along ``dim``, on
    every rank of ``group`` (default: the active group; ``x`` itself with
    none). Counted as an ``all-gather`` of the whole tensor's bytes."""
    sp = group if group is not None else current()
    if sp is None:
        return x
    dist = multihost._dist()
    wire = _to_wire(x)
    parts = [torch.empty_like(wire) for _ in range(sp.size)]
    multihost.count_collective("all-gather", sp.size * x.numel() * x.element_size())
    dist.all_gather(parts, wire, group=sp.group)
    whole = torch.cat(parts, dim=dim)
    return whole.to(x.device, non_blocking=True) if whole.device != x.device else whole


def group_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the group in place (``multihost.all_reduce_`` on the
    group: an ``all-reduce``) and return it; ``t`` itself with no active
    group."""
    sp = current()
    if sp is None:
        return t
    return multihost.all_reduce_(t, group=sp.group)


def on_whole(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
             dim: int = 2) -> torch.Tensor:
    """``fn`` of the whole tensor, this rank's band of the result: for an op
    that reads the whole height at once (a resize with aligned corners),
    whose input is small. ``fn`` runs on the gathered ``x``, with no halos."""
    if current() is None:
        return fn(x)
    whole = all_gather_rows(x, dim)
    with local():
        out = fn(whole)
    return band(out, dim)
