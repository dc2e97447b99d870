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
fmap2 and the outputs), :func:`group_sum` sums over the group (the
instance norm's statistics). Each counts its calls and bytes under JAX's
op name (``collective-permute``, ``all-gather``, ``all-reduce``:
``mesh.collective_stats`` reads them); a halo's bytes are its rows above
and below, as the shape of JAX's permute result.

The three are differentiable, so the train-mode forward runs on bands
(``RAFT.forward(..., mesh=...)`` in training mode): the backward of
:func:`extend` sends each halo row's gradient back to the rank that owns
it, that of :func:`all_gather_rows` reduce-scatters (each rank keeps the
group's sum of the whole tensor's gradient over its band), that of
:func:`group_sum` sums the gradient over the group, and :func:`on_whole`'s
follows from the gather's. Each backward issues its collectives in the
same order on every rank, as autograd runs the same graph on each; the
recompute of a checkpointed iteration, which autograd may run on a thread
of its own, enters the forward's group again (``models/raft.py``'s
remat contexts). Under gloo a card tensor
goes through the host, as ``multihost.all_reduce_`` does: the copy is
``analysis.guards.collective_read``, a sanctioned and counted read, and a
bf16 tensor crosses as float32 (:func:`_wire_dtype`), cast back on arrival.

:func:`resize_rows` is the banded linear resize (the PAC and DJIF heads'
half-pixel bilinear): the band with the halo rows :func:`resize_halo`
counts, and the block of the whole resize's weights for those rows.
"""

from __future__ import annotations

import contextlib
import math
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


def resize_halo(in_rows: int, out_rows: int, size: int) -> tuple[int, int]:
    """Rows a band of ``in_rows`` input rows needs above and below it for a
    linear resize with half-pixel centres of the whole height ``size *
    in_rows`` to ``size * out_rows`` (``jax.image.resize``'s 'bilinear': a
    triangle of radius 1, widened by the factor when it shrinks), when the
    band owns the output rows from ``index * out_rows``: the most over the
    ``size`` bands, so that every rank of the group asks the same. Output
    row ``o`` reads the input rows strictly within ``radius`` of its sample
    ``(o + 1/2) * scale - 1/2``; exact, in rationals."""
    from fractions import Fraction

    in_rows, out_rows, size = int(in_rows), int(out_rows), int(size)
    scale = Fraction(in_rows, out_rows)
    radius = max(Fraction(1), scale)
    half = Fraction(1, 2)
    top = bottom = 0
    for s in range(size):
        i0, o0 = s * in_rows, s * out_rows
        first = math.floor((o0 + half) * scale - half - radius) + 1
        last = math.ceil((o0 + out_rows - half) * scale - half + radius) - 1
        top = max(top, i0 - first)
        bottom = max(bottom, last - (i0 + in_rows - 1))
    return top, bottom


def resize_rows(x: torch.Tensor, out_rows: int, weights: Callable, dim: int = 1) -> tuple:
    """The rows of this rank's band of a linear resize along ``dim``:
    ``x``, the band, joined with the halo rows the resize reads
    (:func:`resize_halo`; zeros past the image's edges), and the ``(rows
    in, out_rows)`` block of the whole resize's weights for those input rows
    and the band's ``out_rows`` output rows, from ``weights(in_size,
    out_size, in_first, in_count, out_first, out_count)`` (global sizes and
    first rows; the block's rows past the image's edges must weigh 0). The
    caller contracts the two along the rows. One halo exchange."""
    sp = current()
    rows, out_rows = x.shape[dim], int(out_rows)
    top, bottom = resize_halo(rows, out_rows, sp.size)
    wide = extend(x, top, bottom, dim=dim)
    w = weights(rows * sp.size, out_rows * sp.size, first_row(rows) - top, wide.shape[dim],
                first_row(out_rows), out_rows)
    return wide, w


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


def _wire_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a card tensor of ``dtype`` crosses gloo in: the host copy
    of ``collective_read`` holds bf16 as float32 (numpy has no bfloat16),
    so a bf16 halo, gather or hand-off travels as float32, which round
    trips exactly; the receiver casts it back."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _wire_buffer(like: torch.Tensor, shape) -> torch.Tensor:
    if _on_host(like):
        return torch.empty(shape, dtype=_wire_dtype(like.dtype), pin_memory=True)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def _exchange(sp: SpatialGroup, up: Optional[torch.Tensor], down: Optional[torch.Tensor],
              from_above: int, from_below: int, like: torch.Tensor, dim: int) -> tuple:
    """One exchange with the neighbours: ``up`` goes to the rank above and
    ``down`` to the rank below (None: nothing), and ``from_above`` and
    ``from_below`` rows shaped as ``like`` come back from them; None for a
    count of 0 or at the image's edge. Every rank of the group calls it
    with the same counts."""
    dist = multihost._dist()
    s, ranks = sp.index, sp.ranks
    shape = list(like.shape)
    ops, above, below = [], None, None
    if from_above and s > 0:
        shape[dim] = from_above
        above = _wire_buffer(like, shape)
        ops.append(dist.P2POp(dist.irecv, above, ranks[s - 1], sp.group))
    if up is not None and s > 0:
        ops.append(dist.P2POp(dist.isend, _to_wire(up), ranks[s - 1], sp.group))
    if down is not None and s < sp.size - 1:
        ops.append(dist.P2POp(dist.isend, _to_wire(down), ranks[s + 1], sp.group))
    if from_below and s < sp.size - 1:
        shape[dim] = from_below
        below = _wire_buffer(like, shape)
        ops.append(dist.P2POp(dist.irecv, below, ranks[s + 1], sp.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    back = (lambda buf: None if buf is None else buf.to(like.device, like.dtype,
                                                         non_blocking=True))
    return back(above), back(below)


class _Extend(torch.autograd.Function):
    """The halo exchange of :func:`extend` (counts at least 0). Its
    backward sends each halo row's gradient back to the rank that owns the
    row, which adds it into its edge rows: one exchange, in the reverse
    direction, of the same bytes."""

    @staticmethod
    def forward(ctx, x, sp, top, bottom, dim):
        ctx.sp, ctx.top, ctx.bottom, ctx.dim = sp, top, bottom, dim
        h = x.shape[dim]
        multihost.count_collective("collective-permute", _halo_bytes(x, top + bottom, dim))
        above, below = _exchange(sp, x.narrow(dim, 0, bottom) if bottom else None,
                                 x.narrow(dim, h - top, top) if top else None,
                                 top, bottom, x, dim)

        def rows(buf, n):
            if n == 0:
                return None
            if buf is None:  # the image's edge: the whole-image op's zero padding
                shape = list(x.shape)
                shape[dim] = n
                return x.new_zeros(shape)
            return buf

        parts = [rows(above, top), x, rows(below, bottom)]
        return torch.cat([p for p in parts if p is not None], dim=dim)

    @staticmethod
    def backward(ctx, g):
        sp, top, bottom, dim = ctx.sp, ctx.top, ctx.bottom, ctx.dim
        h = g.shape[dim] - top - bottom
        multihost.count_collective("collective-permute", _halo_bytes(g, top + bottom, dim))
        g = g.contiguous()
        # The rank above owns my top halo: its rows' gradient goes up; the
        # rank above's bottom halo (my first rows) comes down, and so on.
        from_above, from_below = _exchange(
            sp, g.narrow(dim, 0, top) if top else None,
            g.narrow(dim, top + h, bottom) if bottom else None, bottom, top, g, dim)
        gx = g.narrow(dim, top, h).clone()
        if from_above is not None:
            gx.narrow(dim, 0, bottom).add_(from_above)
        if from_below is not None:
            gx.narrow(dim, h - top, top).add_(from_below)
        return gx, None, None, None, None


def _halo_bytes(x: torch.Tensor, rows: int, dim: int) -> int:
    return rows * (x.numel() // max(x.shape[dim], 1)) * x.element_size()


def extend(x: torch.Tensor, top: int, bottom: int, dim: int = 2) -> torch.Tensor:
    """``x``, this rank's band, with ``top`` rows of the rank above it and
    ``bottom`` rows of the rank below it joined along ``dim`` (zeros at the
    image's edges); a negative count drops that many of the band's own
    rows. One exchange with the neighbours, counted as a
    ``collective-permute`` of the halo's bytes; none when both counts are
    at most 0. Differentiable: the backward is one exchange of the halos'
    gradients back to their owners. Every rank of the group must call it
    with the same counts."""
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
    return _Extend.apply(x.contiguous(), sp, int(top), int(bottom), dim)


class _GatherRows(torch.autograd.Function):
    """The all-gather of :func:`all_gather_rows`. Its backward is a
    reduce-scatter: each rank keeps, for its own band, the sum over the
    group of the whole tensor's gradient (every rank's loss reads the
    whole tensor)."""

    @staticmethod
    def forward(ctx, x, sp, dim):
        ctx.sp, ctx.dim = sp, dim
        dist = multihost._dist()
        wire = _to_wire(x)
        parts = [torch.empty_like(wire) for _ in range(sp.size)]
        multihost.count_collective("all-gather", sp.size * x.numel() * x.element_size())
        dist.all_gather(parts, wire, group=sp.group)
        whole = torch.cat(parts, dim=dim)
        return whole.to(x.device, x.dtype, non_blocking=True)

    @staticmethod
    def backward(ctx, g):
        sp, dim = ctx.sp, ctx.dim
        dist = multihost._dist()
        multihost.count_collective("reduce-scatter", g.numel() * g.element_size())
        h = g.shape[dim] // sp.size
        if multihost.backend() == "nccl":
            parts = [p.contiguous() for p in g.chunk(sp.size, dim)]
            out = torch.empty_like(parts[sp.index])
            dist.reduce_scatter(out, parts, group=sp.group)
            return out, None, None
        # gloo has no reduce-scatter: a sum of the whole, then the band.
        wire = _to_wire(g)
        wire = wire.clone() if wire.data_ptr() == g.data_ptr() else wire
        dist.all_reduce(wire, group=sp.group)
        band_ = wire.narrow(dim, sp.index * h, h).contiguous()
        return band_.to(g.device, g.dtype, non_blocking=True), None, None


def all_gather_rows(x: torch.Tensor, dim: int = 1,
                    group: Optional[SpatialGroup] = None) -> torch.Tensor:
    """The whole tensor of which ``x`` is this rank's band along ``dim``, on
    every rank of ``group`` (default: the active group; ``x`` itself with
    none). Counted as an ``all-gather`` of the whole tensor's bytes; its
    gradient as a ``reduce-scatter`` of the same bytes."""
    sp = group if group is not None else current()
    if sp is None:
        return x
    return _GatherRows.apply(x, sp, dim)


class _GroupSum(torch.autograd.Function):
    """A sum over the group whose gradient is the sum over the group of the
    output's gradient (``multihost.all_reduce_grad`` on a subgroup)."""

    @staticmethod
    def forward(ctx, t, sp):
        ctx.sp = sp
        return multihost.all_reduce_(t.clone(), group=sp.group)

    @staticmethod
    def backward(ctx, g):
        return multihost.all_reduce_(g.clone(), group=ctx.sp.group), None


def group_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the group (``multihost.all_reduce_`` on the group:
    an ``all-reduce``), a new tensor whose gradient is summed over the group
    too; ``t`` itself with no active group."""
    sp = current()
    return t if sp is None else _GroupSum.apply(t, sp)


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
