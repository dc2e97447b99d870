"""Iteration-pipelined inference over the pipe axis of a mesh of processes
(port of ``raft_ncup_tpu/inference/pipe_schedule.py``; docs/SHARDING.md
"Pipeline axis").

RAFT's refinement is a chain of N identical iterations. The pipelined
forward splits them into S contiguous segments of ``N / S`` iterations on
the S ranks of the pipe axis (``parallel.mesh.make_mesh(1, 1, S)``, one
process per card) and streams micro-batches through them: while rank 1
refines micro-batch A's second segment, rank 0 encodes B and refines its
first.

**The tick**, JAX's table (docs/SHARDING.md): at tick t rank p holds
micro-batch ``t - p``. Rank 0 encodes it and refines ``seg_len``
iterations; every other rank receives its carry from rank p - 1 and
refines it; each rank but the last sends the refined carry on to rank p +
1; rank S - 1 finalizes (the upsampling, NCUP's kernel B for
``raft_nc_dbl``), and from tick S - 1 on the finished micro-batch ``t - S
+ 1`` reaches every rank in one broadcast from rank S - 1. M micro-batches
take M + S - 1 ticks. JAX's flush ticks refine zeros that are never read;
the port skips that work, so each rank refines exactly M segments (kernel
A ``seg_len`` launches per micro-batch on every rank), rank 0 alone
encodes and rank S - 1 alone finalizes.

**The carry** is ``RAFT.encode``'s dict: ``net``, ``coords1``, ``inp``,
``fmap1`` and ``fmap2``, plus ``converged`` and ``exec_iters`` under early
exit. A hand-off sends all of it (``refine_segment`` rebuilds the
correlation pyramid from the feature maps, as JAX's does) in one batch of
point-to-point sends over the pipe group, counted as one
``collective-permute`` of its bytes (``mesh.collective_stats``) by the
sender: S - 1 per micro-batch. That is the counterpart of JAX's HLO
fingerprint (at least S - 1 permutes per tick); the port has no HLO, so
JAX's ``tick_text`` and ``tick_hlo`` have no counterpart here. The output
broadcasts count under the port's own op name ``pipe-output``
(:func:`output_stats`), beside JAX's five names.

**Transport**: under NCCL the carry goes card to card as CUDA tensors;
under gloo (two ranks sharing one card, the CPU tests) through host wire
buffers (``parallel/halo.py``'s ``_to_wire`` and ``_wire_buffer``: on the
card each send is a sanctioned ``guards.collective_read``).

**Stage programs**: the encode, the ``seg_len``-iteration segment and the
finalize, each holding no collective. They run through the pipe mesh's
``ShapeCachedForward`` (``entry``/``custom``), so on the card each is a CUDA
graph captured per shape, keyed as JAX's programs are: ``("custom",
"pipe_encode", shape, policy)`` and ``("custom", "pipe_segment" |
"pipe_finalize", shape, iters, segments, policy)``, plus ``("earlyexit",
tol)``. A hand-off is received straight into the segment graph's static
inputs (on the CPU into buffers kept per key), so a second stream of the
same shape allocates no carry buffers, captures nothing and replays hits:
the port's counterpart of JAX's donated state.

``segments == 1`` (or no mesh) is exactly the monolithic path:
:meth:`PipelinedForward.forward_many` calls ``ShapeCachedForward.forward``
per pair, with no pipe machinery.

Early exit (``early_exit_tol``): each stage freezes converged rows per
iteration, and a row active at a segment's entry pays the whole segment
(``RAFT.refine_segment``), so ``exec_pipe == ceil(exec_mono / seg_len) *
seg_len``.

**v1 scope**, JAX's: the pipe axis composes with data and spatial sizes of
1 only.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional, Sequence

import torch

from raft_ncup_tpu_torch.inference.pipeline import ShapeCachedForward, _GraphEntry
from raft_ncup_tpu_torch.parallel import halo, multihost
from raft_ncup_tpu_torch.parallel import mesh as mesh_mod

# The carry's tensors in hand-off order, the early-exit pair after them,
# and the ones a segment changes.
CARRY_KEYS = ("net", "coords1", "inp", "fmap1", "fmap2")
EARLY_EXIT_KEYS = ("converged", "exec_iters")
HANDOFF_OP = "collective-permute"
OUTPUT_OP = "pipe-output"
# The flows leave every preset as f32 (PrecisionPolicy.output), so the
# finished micro-batch crosses the ranks as one f32 buffer.
OUTPUT_DTYPE = torch.float32


def split_iters(iters: int, segments: int) -> int:
    """Iteration count -> per-segment length. Segments are equal-length
    contiguous blocks, so ``segments`` must divide ``iters``."""
    iters, segments = int(iters), int(segments)
    if segments < 1:
        raise ValueError(f"segments must be >= 1, got {segments}")
    if iters < 1 or iters % segments:
        raise ValueError(
            f"iters={iters} does not split into {segments} equal scan "
            f"segments; pipelined budgets must be multiples of "
            f"{segments} (see serving/budget.py segment quantization)"
        )
    return iters // segments


def validate_segment_levels(levels: Sequence[int], segments: int) -> None:
    """Every iteration level must be a multiple of the segment length
    ``levels[0] / segments``: a reduced budget runs fewer segments of the
    same segment program. ``(24, 16, 8)`` with 2 segments (length 12) is
    refused; ``(24, 12)`` is valid. One segment imposes nothing."""
    segments = int(segments)
    if segments < 1:
        raise ValueError(f"segments must be >= 1, got {segments}")
    if segments == 1:
        return
    levels = tuple(int(x) for x in levels)
    if not levels:
        raise ValueError("empty iteration level set")
    if levels[0] % segments:
        raise ValueError(
            f"top iteration level {levels[0]} does not split into "
            f"{segments} equal segments"
        )
    seg_len = levels[0] // segments
    bad = [x for x in levels if x % seg_len]
    if bad:
        raise ValueError(
            f"iteration levels {bad} do not quantize to the segment "
            f"boundary (multiples of {levels[0]}/{segments} = {seg_len} "
            f"iterations) required by pipe segments={segments}; with a "
            "pipelined mesh a budget level must run a whole number of "
            f"scan segments — e.g. {tuple(seg_len * k for k in range(segments, 0, -1))}"
        )


def output_stats() -> dict:
    """The output broadcasts this process issued since the last
    ``mesh.reset_collective_stats``: ``broadcasts`` and ``bytes``."""
    c = multihost._COUNTS.get(OUTPUT_OP, {"count": 0, "bytes": 0})
    return {"broadcasts": c["count"], "bytes": c["bytes"]}


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class PipelinedForward:
    """Micro-batch streaming driver of the iteration pipeline, one per rank
    of the pipe axis. Its constructor follows JAX's: ``mesh`` (built from
    ``segments`` over the world when absent) and ``segments`` must agree,
    and a pipe axis beside a data or spatial axis above 1 raises. Where
    JAX takes a ``variables`` dict, the port takes the model, which holds
    its weights. ``timing`` (card only) records each stage program's device
    time and the hand-offs' waits in :attr:`last_timing`."""

    def __init__(self, model, mesh=None, segments: Optional[int] = None,
                 cache_size: int = 8, policy=None, telemetry=None, cost_ledger=None,
                 timing: bool = False):
        if mesh is None and segments is not None and int(segments) > 1:
            mesh = mesh_mod.make_mesh(data=1, spatial=1, pipe=int(segments),
                                      device=model.device)
        s = int(mesh.shape.get("pipe", 1)) if mesh is not None else 1
        if segments is not None and int(segments) != s:
            raise ValueError(f"segments={segments} disagrees with mesh pipe axis {s}")
        if s > 1:
            extra = {k: v for k, v in mesh.shape.items() if k != "pipe" and int(v) > 1}
            if extra:
                raise ValueError(
                    f"pipe axis composes with data/spatial sizes of 1 only (got "
                    f"{dict(mesh.shape)}); the pipelined forward's v1 rule, as in the JAX "
                    f"package: its stages are not sharded by batch or rows")
        self.segments = s
        self.mesh = mesh if s > 1 else None
        self.model = model
        self.device = model.device
        self.cache = ShapeCachedForward(
            model, cache_size=cache_size, policy=policy, telemetry=telemetry,
            cost_ledger=cost_ledger, mesh=self.mesh)
        self.stage = self.mesh.pipe_index if s > 1 else 0
        self._handoffs = mesh_mod.pipe_group(self.mesh)
        # The buffers a hand-off is received into, by segment key: a graph's
        # static inputs once built, on the CPU buffers of their own.
        self._inputs: dict = {}
        self.timing = bool(timing) and self.device.type == "cuda"
        self.last_timing: dict = {}
        # This rank's work over its life: micro-batches per stage program,
        # hand-offs sent and received (with their bytes) and the outputs it
        # broadcast or received.
        self.stats = {"encodes": 0, "segments": 0, "finalizes": 0, "handoffs_sent": 0,
                      "handoffs_received": 0, "handoff_bytes": 0, "outputs": 0}

    @property
    def is_pipelined(self) -> bool:
        return self.segments > 1

    # ------------------------------------------------------------ programs

    def _carry_specs(self, model, shape: tuple, early_exit: bool) -> list:
        """(shape, dtype) of each carry tensor of a (B, H, W, 3) image pair,
        in hand-off order."""
        B, H, W = shape[:3]
        h, w = H // 8, W // 8
        cfg, pol = model.cfg, model.policy
        specs = [((B, cfg.hidden_dim, h, w), pol.compute), ((B, h, w, 2), pol.coord),
                 ((B, cfg.context_dim, h, w), pol.compute),
                 ((B, h, w, cfg.fnet_dim), pol.corr), ((B, h, w, cfg.fnet_dim), pol.corr)]
        if early_exit:
            specs += [((B,), torch.bool), ((B,), torch.int32)]
        return specs

    def _programs(self, model, pol, shape: tuple, iters: int, tol: Optional[float]):
        """The three stage programs' (key, build) pairs."""
        seg_len = split_iters(iters, self.segments)
        ee = tol is not None
        ee_key = (("earlyexit", float(tol)),) if ee else ()
        keys = CARRY_KEYS + (EARLY_EXIT_KEYS if ee else ())
        changed = ("net", "coords1") + (EARLY_EXIT_KEYS if ee else ())

        def encode(i1, i2):
            carry = model.encode(i1, i2, early_exit=ee)
            return tuple(carry[k] for k in keys)

        def segment(*carry):
            out = model.refine_segment(dict(zip(keys, carry)), seg_len, early_exit_tol=tol)
            return tuple(out[k] for k in changed)

        def finalize(net, coords1, *exec_iters):
            flow_lr, flow_up = model.finalize({"net": net, "coords1": coords1})
            return (flow_lr, flow_up) + tuple(e.clone() for e in exec_iters)

        name = pol.name
        return (
            (("pipe_encode", shape, name) + ee_key, lambda: encode),
            (("pipe_segment", shape, int(iters), self.segments, name) + ee_key, lambda: segment),
            (("pipe_finalize", shape, int(iters), self.segments, name) + ee_key,
             lambda: finalize),
        )

    # ------------------------------------------------------------- driving

    def forward_many(self, pairs: Sequence[tuple], iters: int, policy=None,
                     early_exit_tol: Optional[float] = None) -> list:
        """Stream ``pairs`` (same-shape ``(image1, image2)`` micro-batches,
        the same on every rank) through the pipeline; returns, on every
        rank, the per-micro-batch ``(flow_lr, flow_up)`` on the model's
        device in submission order, or ``(flow_lr, flow_up, exec_iters)``
        with ``early_exit_tol``. ``iters`` must split into the segments,
        checked before any work."""
        if self.segments == 1:
            return [self.cache.forward(i1, i2, iters, policy=policy,
                                       early_exit_tol=early_exit_tol)
                    for i1, i2 in pairs]
        split_iters(iters, self.segments)
        pairs = list(pairs)
        if not pairs:
            return []
        model, pol = self.cache.model_for(policy)
        shape = tuple(pairs[0][0].shape)
        ee = early_exit_tol is not None
        (enc_key, enc_build), (seg_key, seg_build), (fin_key, fin_build) = self._programs(
            model, pol, shape, iters, early_exit_tol)
        specs = self._carry_specs(model, shape, ee)
        S, p, M = self.segments, self.stage, len(pairs)
        clock = _Clock(self.timing)
        pending: list = []  # this rank's unfinished sends (and their wires)
        outs: list = [None] * M
        finished = None
        for t in range(M + S - 1):
            m = t - p
            if 0 <= m < M:
                # Nothing may overwrite the segment's inputs while a send of
                # the previous micro-batch still reads them.
                self._wait_sends(pending, clock)
                inputs = self._inputs.get(seg_key)
                if inputs is None:
                    inputs = tuple(torch.empty(shape_, dtype=dtype, device=self.device)
                                   for shape_, dtype in specs)
                if p == 0:
                    i1, i2 = pairs[m]
                    args = (self.cache._tensor(i1), self.cache._tensor(i2))
                    with clock("encode"):
                        carry = self.cache.entry(enc_key, enc_build, args)(*args)
                    self.stats["encodes"] += 1
                    self._check_specs(carry, specs)
                    for dst, src in zip(inputs, carry):
                        dst.copy_(src, non_blocking=True)
                else:
                    self._receive(inputs, clock)
                # Built on the first micro-batch's carry; a graph's static
                # inputs take the hand-offs from then on.
                seg = self.cache.entry(seg_key, seg_build, inputs)
                graph = isinstance(seg, _GraphEntry)
                inputs = self._inputs[seg_key] = seg.static_in if graph else inputs
                with clock("segment"):
                    changed = seg.replay() if graph else seg(*inputs)
                self.stats["segments"] += 1
                # changed: net, coords1 (and converged, exec_iters).
                if p < S - 1:
                    pending.append(self._send([*changed[:2], *inputs[2:5], *changed[2:]]))
                else:
                    fin_args = (*changed[:2], *changed[3:])
                    with clock("finalize"):
                        finished = self.cache.entry(fin_key, fin_build, fin_args)(*fin_args)
                    self.stats["finalizes"] += 1
            if t >= S - 1:
                outs[t - (S - 1)] = self._broadcast_output(finished, shape, ee)
                finished = None
        self._wait_sends(pending, clock)
        self.last_timing = clock.summary()
        return outs

    @staticmethod
    def _check_specs(carry, specs) -> None:
        got = [(tuple(t.shape), t.dtype) for t in carry]
        if got != [(tuple(s), d) for s, d in specs]:
            raise RuntimeError(f"the encode's carry {got} is not the one the pipe stages "
                               f"receive {specs}")

    def _peer(self, stage: int) -> int:
        """The global rank of this rank's pipe group's stage ``stage``."""
        return self.mesh.rank - self.stage + int(stage)

    def _send(self, carry: list) -> tuple:
        """Send a refined carry to the next stage: one batch of
        point-to-point sends, one ``collective-permute`` of its bytes."""
        dist = multihost._dist()
        nbytes = _nbytes(carry)
        multihost.count_collective(HANDOFF_OP, nbytes)
        wires = [halo._to_wire(t) for t in carry]
        ops = [dist.P2POp(dist.isend, w, self._peer(self.stage + 1), self._handoffs)
               for w in wires]
        self.stats["handoffs_sent"] += 1
        self.stats["handoff_bytes"] += nbytes
        return dist.batch_isend_irecv(ops), wires

    def _wait_sends(self, pending: list, clock) -> None:
        with clock("send_wait", host=True):
            while pending:
                works, _wires = pending.pop(0)
                for w in works:
                    w.wait()

    def _receive(self, inputs: tuple, clock) -> None:
        """Receive the previous stage's carry into ``inputs`` (through host
        wire buffers under gloo on the card)."""
        dist = multihost._dist()
        bufs = [halo._wire_buffer(d, d.shape) if halo._on_host(d) else d for d in inputs]
        ops = [dist.P2POp(dist.irecv, b, self._peer(self.stage - 1), self._handoffs)
               for b in bufs]
        with clock("receive_wait", host=True):
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        for dst, buf in zip(inputs, bufs):
            if buf is not dst:
                dst.copy_(buf, non_blocking=True)
        self.stats["handoffs_received"] += 1

    def _broadcast_output(self, finished, shape: tuple, ee: bool) -> tuple:
        """The finished micro-batch's flows (and executed iterations) on
        every rank: one broadcast from the last stage of one packed f32
        buffer."""
        B, H, W = shape[:3]
        parts = [((B, H // 8, W // 8, 2), OUTPUT_DTYPE), ((B, H, W, 2), OUTPUT_DTYPE)]
        if ee:
            parts.append(((B,), torch.int32))
        sizes = [torch.Size(s).numel() for s, _ in parts]
        src = self.segments - 1
        if self.stage == src:
            packed = torch.cat([t.reshape(-1).to(OUTPUT_DTYPE) for t in finished])
        else:
            packed = torch.empty(sum(sizes), dtype=OUTPUT_DTYPE, device=self.device)
        if self.stage == src:
            wire = halo._to_wire(packed)
        else:
            wire = halo._wire_buffer(packed, packed.shape)
        multihost.count_collective(OUTPUT_OP, _nbytes([packed]))
        multihost._dist().broadcast(wire, src=self._peer(src))
        if self.stage != src and wire is not packed:
            packed.copy_(wire, non_blocking=True)
        self.stats["outputs"] += 1
        out, at = [], 0
        for (s, dtype), n in zip(parts, sizes):
            out.append(packed[at: at + n].view(s).to(dtype))
            at += n
        return tuple(out)


class _Clock:
    """Per-stage-program device milliseconds (CUDA events on the current
    stream) and host milliseconds spent waiting on hand-offs, when on."""

    def __init__(self, on: bool):
        self.on = on
        self._events: dict = {}
        self._host: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str, host: bool = False):
        if not self.on:
            yield
        elif host:
            t0 = time.perf_counter()
            yield
            self._host[name] = self._host.get(name, 0.0) + 1e3 * (time.perf_counter() - t0)
        else:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            yield
            end.record()
            self._events.setdefault(name, []).append((start, end))

    def summary(self) -> dict:
        if not self.on:
            return {}
        out = {f"{k}_host_ms": round(v, 3) for k, v in self._host.items()}
        for name, pairs in self._events.items():
            pairs[-1][1].synchronize()
            out[f"{name}_device_ms"] = [round(a.elapsed_time(b), 3) for a, b in pairs]
        return out
