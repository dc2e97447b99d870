"""The multi-stream video engine: warm start on the card over a slot table
of fixed capacity, with per-stream fault isolation (port of
``raft_ncup_tpu/streaming/engine.py``).

Data path (one dispatcher thread; clients submit from their own threads):

1. **stream admission** (in ``submit``): an unknown ``stream_id`` claims
   the lowest free slot; a full table first evicts idle-expired streams,
   then sheds with ``retry_after_s``, the time until the soonest slot is
   reclaimable. A stream without a slot cannot make progress, so stream
   overload sheds instead of queueing.
2. **frame admission**: shape and dtype checks (the padded shape must be
   the slot table's), frame indices strictly increasing per stream, the
   staleness rule (an index gap above ``max_frame_gap`` makes the frame
   cold), then a non-blocking ``AdmissionQueue.offer``.
3. **assemble**: ``pop_batch(..., distinct_fn=stream)`` pops a FIFO run
   of frames of distinct streams (two frames of one stream are chained
   through the slot table, never batched) and pads with zero rows up to
   the nearest batch size; pad rows target the scratch slot.
4. **step** (one CUDA graph per batch size, through
   ``ShapeCachedForward.custom``): gather each row's previous state by
   slot index, upcast it to the f32 coordinate dtype and splat it
   (``ops/warmstart.forward_interpolate_batch``, free of host
   synchronisation) where the row is warm, run the forward with that
   ``flow_init`` (and ``net_init``/``net_warm`` under ``carry_net``),
   flag each row whose low-res flow is not finite or exceeds
   ``anomaly_max_flow``, and write the new state back in place
   (``index_copy_``), a flagged row reset to cold. The slot table is
   allocated at construction, before any capture and outside the graphs'
   pool, and the graphs read and write it by address.
   The frames are staged as the server's are (``stage_frames``: pinned
   memory on the card, non-blocking copies in), and the
   ``DispatchThrottle`` (``cfg.inflight``) lets the dispatcher stage and
   launch batch n+1 while the card runs batch n: the slot table stays on
   the card, and stream order keeps step n+1 reading what step n wrote.
5. **deliver** (drain worker): the batch's flow and ``bad`` flags ride one
   ``AsyncDrain`` read (the sanctioned ``analysis.guards.host_read``); a
   flagged row answers ``rejected`` and its reset is accounted there (its
   stream's next frame is cold on the card through the table's ``warm``
   flag, whatever the host knew when it dispatched), the others answer
   ``ok`` with the flow cropped to their native shape. A failed read or
   delivery answers that batch's frames with ``error`` at once.

Isolation: a corrupt frame affects one batch row and one slot. Its
batch-mates' flows are bit for bit those of a run without it (test-mode
rows are independent, and every mask is a select), and its stream's next
frame is a cold start. Kernel A clamps a NaN query's window into its
level and a tile's box and path rule never span batch rows
(``csrc/corr_lookup.cu``), so a NaN row cannot change a batch-mate's
lookup. Eviction and slot reuse touch no device memory, so the engine's
graphs are exactly ``len(batch_sizes)``, all captured at ``warmup`` (or,
without it, at a batch size's first use), and always on scratch-slot,
all-cold rows: a capture's eager run writes the slot table.

The mesh (``mesh=``, else ``StreamConfig.mesh``), as the server's
(``serving/server.py``): frames pad to ``8 * spatial``, rank 0 (the
leader) admits, batches and delivers and broadcasts each step (its slot
indices, cold flags and staged frames, ``parallel/lockstep.py``) to the
followers, which run :meth:`follow`. The slot table stays whole and
identical on every rank (JAX replicates it when ``capacity + 1`` does not
divide by ``data``): the step reads each row's previous state from it,
each data index runs its block of the rows, split by rows over its
spatial ranks (on each pipe index alike: the pipe indices are replicas),
and the outputs are gathered over the data axis before
the anomaly test and the write back, so every rank writes the same
values.

Drain: ``drain()`` stops stream and frame admission, answers every
admitted frame through compute, stops the dispatcher, waits for the
throttle's steps, closes the drain worker and returns the stats (the serve
entry's ``--stream`` wires it to SIGTERM: exit 75).

Telemetry (``telemetry=``, the process's hub by default), as the JAX
engine's: ``StreamStats`` mirrors through ``LEGACY_KEY_ALIASES["stream"]``;
slot admissions, sheds, evictions and releases are ring events; each
frame's queue wait and end-to-end latency are observed, each batch's host
staging (``stream_pad_stage``), launch (``stream_dispatch``, also a
``stage_annotation``) and dispatch-to-delivery (``stream_drain``) are host
spans; the slot occupancy is the gauge ``stream_slot_occupancy`` that
``stream_slos`` reads; an anomaly reset is an event and a
``stream_anomaly_reset`` flight dump. Every value is a host number (the
delivery's are taken on the drain worker after the batch's one read). ``health`` is the hub's ``stream``
tracker (WARMING then READY through ``warmup``, DRAINING in ``drain``).
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from raft_ncup_tpu_torch.config import StreamConfig
from raft_ncup_tpu_torch.inference.pipeline import (
    AsyncDrain,
    DispatchThrottle,
    ShapeCachedForward,
    stage_frames,
    stage_pinned,
)
from raft_ncup_tpu_torch.observability import get_telemetry
from raft_ncup_tpu_torch.observability.telemetry import LEGACY_KEY_ALIASES
from raft_ncup_tpu_torch.ops.padding import InputPadder
from raft_ncup_tpu_torch.ops.warmstart import forward_interpolate_batch
from raft_ncup_tpu_torch.parallel.lockstep import Lockstep, data_rows, gather_data
from raft_ncup_tpu_torch.parallel.mesh import resolve_config_mesh
from raft_ncup_tpu_torch.serving.admission import AdmissionQueue
from raft_ncup_tpu_torch.serving.request import (
    STATUS_ERROR,
    STATUS_OK,
    STATUS_REJECTED,
    STATUS_SHED,
    FlowResponse,
    ServeHandle,
    trace_attr,
    trace_ids_attr,
)
from raft_ncup_tpu_torch.streaming.slots import SlotRegistry, init_slot_table
from raft_ncup_tpu_torch.utils.profiling import stage_annotation

_POLL_S = 0.05  # dispatcher wake cadence while the queue is idle


@dataclass
class FrameRequest:
    """One admitted frame of one stream, queued for dispatch."""

    request_id: int
    stream_id: str
    slot: int
    frame_index: int
    image1: np.ndarray
    image2: np.ndarray
    cold: bool  # forced cold start (first frame, or a gap above max_frame_gap)
    submit_time: float
    pad_spec: tuple
    shape_key: Tuple[int, int]  # padded (H, W): the queue's batching key
    trace_id: Optional[str] = None  # a fleet router's trace, adopted from the wire


@dataclass(eq=False)
class StreamStats:
    """Counts of one run; clients, the dispatcher and ``drain`` write them
    through :meth:`note`, which also mirrors each into the telemetry
    registry under its canonical name (``LEGACY_KEY_ALIASES["stream"]``)."""

    submitted: int = 0
    accepted: int = 0
    completed: int = 0
    shed_streams: int = 0  # stream admission refused (table full)
    shed_frames: int = 0  # frame admission refused (queue full, draining)
    rejected: int = 0  # malformed frames (admission checks)
    resets: int = 0  # anomaly resets delivered
    errors: int = 0
    batches: int = 0
    padded_rows: int = 0
    streams_opened: int = 0
    streams_closed: int = 0
    streams_evicted: int = 0
    cold_starts: int = 0  # frames admitted cold (first frame, gap)
    telemetry: object = field(default=None, repr=False, compare=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def note(self, field_name: str, delta: int = 1) -> None:
        with self._lock:
            setattr(self, field_name, getattr(self, field_name) + delta)
        if self.telemetry is not None and delta:
            self.telemetry.inc(LEGACY_KEY_ALIASES["stream"][field_name], delta)

    def summary(self) -> str:
        return (
            f"submitted={self.submitted} accepted={self.accepted} "
            f"completed={self.completed} shed_streams={self.shed_streams} "
            f"shed_frames={self.shed_frames} rejected={self.rejected} "
            f"resets={self.resets} errors={self.errors} "
            f"batches={self.batches} padded_rows={self.padded_rows} "
            f"opened={self.streams_opened} closed={self.streams_closed} "
            f"evicted={self.streams_evicted} cold_starts={self.cold_starts}"
        )


class StreamEngine:
    """Serve many concurrent video streams with one port ``RAFT`` model, on
    the model's device. ``clock`` is injectable and must be monotonic. The
    engine owns one dispatcher thread from construction until
    :meth:`drain`. ``mesh`` and ``lockstep`` as ``FlowServer``'s."""

    def __init__(self, model, cfg: Optional[StreamConfig] = None, *, mesh=None,
                 lockstep: Optional[Lockstep] = None,
                 clock: Callable[[], float] = time.monotonic, telemetry=None):
        self.cfg = cfg or StreamConfig()
        self._clock = clock
        self.device = model.device
        self._tel = telemetry if telemetry is not None else get_telemetry()
        self.stats = StreamStats(telemetry=self._tel)
        self.health = self._tel.health("stream", fresh=True)
        self.mesh, self._pad_divisor = resolve_config_mesh(mesh, self.cfg.mesh, self.device)
        self._owns_group = lockstep is None and self.mesh is not None \
            and self.mesh.processes > 1
        self._group = Lockstep(self.mesh, self.device) if self._owns_group else lockstep
        h, w = self.cfg.frame_hw
        (t, b), (le, r) = self._pad_spec_for((int(h), int(w)))
        self._ph, self._pw = int(h) + t + b, int(w) + le + r
        self._hidden = model.cfg.hidden_dim if self.cfg.carry_net else 0
        # The step entries, one per batch size, under the engine's preset.
        self._fwd = ShapeCachedForward(model, cache_size=self.cfg.cache_size,
                                       policy=self.cfg.precision, telemetry=self._tel,
                                       mesh=self.mesh)
        self._policy = self._fwd.policy
        # Before any capture and outside the graphs' pool: the step graphs
        # read and write it by address.
        self._table = init_slot_table(self.cfg.capacity, self._ph // 8, self._pw // 8,
                                      self._hidden, dtype=self._policy.state,
                                      device=self.device)
        # Held around every step run: the dispatcher's batches and warmup's
        # captures (a capture fails if another thread uses the card).
        self._step_lock = threading.Lock()
        self._captured: set = set()  # batch sizes whose step entry is built
        self._queue = AdmissionQueue(self.cfg.queue_capacity, telemetry=self._tel,
                                     name="stream")
        self._throttle = DispatchThrottle(self.cfg.inflight)
        self._drainer = AsyncDrain(depth=self.cfg.drain_depth)
        self.registry = SlotRegistry(self.cfg.capacity)
        self._reg_lock = threading.Lock()
        self._handles: dict[int, ServeHandle] = {}
        # Batches handed to the drain worker and not yet delivered, by
        # batch id: what a failed read or delivery answers with `error`.
        self._inflight: dict[int, list] = {}
        self._inflight_lock = threading.Lock()
        self._service_ema: Optional[float] = None
        self._ema_lock = threading.Lock()
        self._next_id = 0
        self._id_lock = threading.Lock()
        self.warmed: list = []  # (padded H, padded W, batch, iters), see warmup()
        self._occupancy_sum = 0  # sampled at each dispatched batch
        self._batch_seq = 0  # batch correlation ids (the dispatcher's only)
        self._draining = threading.Event()
        self._drained = False
        self._thread = threading.Thread(target=self._dispatch_loop, name="stream-dispatch",
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ admission

    def submit(self, stream_id: str, image1, image2, *,
               frame_index: Optional[int] = None, request_id: Optional[int] = None,
               trace_id: Optional[str] = None) -> ServeHandle:
        """Submit the next frame pair of ``stream_id``; returns a handle at
        once, which completes with one terminal status. An unknown stream
        is admitted on first use (a slot, or a shed). ``frame_index``
        defaults to the last admitted + 1; indices must increase, and a
        gap above ``max_frame_gap`` starts the frame cold. ``request_id``
        and ``trace_id`` mean what they mean for ``FlowServer.submit``: a
        fleet router's id as the frame's identity, and its trace carried
        on the frame's queue, batch and device spans."""
        self.stats.note("submitted")
        handle = ServeHandle()
        if request_id is not None:
            rid = int(request_id)
        else:
            with self._id_lock:
                rid = self._next_id
                self._next_id += 1
        if self._draining.is_set():
            self.stats.note("shed_frames")
            handle.complete(FlowResponse(rid, STATUS_SHED, retry_after_s=self._retry_after(),
                                         detail="draining"))
            return handle
        err = self._frame_error(image1) or self._frame_error(image2)
        if err is None and image1.shape != image2.shape:
            err = f"frame shapes differ: {image1.shape} vs {image2.shape}"
        if err is not None:
            self.stats.note("rejected")
            handle.complete(FlowResponse(rid, STATUS_REJECTED, detail=err))
            return handle

        now = self._clock()
        native_hw = (int(image1.shape[0]), int(image1.shape[1]))
        with self._reg_lock:
            state = self.registry.get(stream_id)
            if state is None:
                evicted = self.registry.evict_expired(now, self.cfg.idle_timeout_s)
                self._note_evicted(evicted)
                state = self.registry.admit(stream_id, native_hw, now)
                if state is None:
                    self.stats.note("shed_streams")
                    self._tel.event("stream_slot_shed", stream_id=stream_id)
                    hint = self.registry.soonest_expiry_s(now, self.cfg.idle_timeout_s)
                    handle.complete(FlowResponse(rid, STATUS_SHED,
                                                 retry_after_s=round(hint, 4),
                                                 detail="stream table full"))
                    return handle
                self.stats.note("streams_opened")
                self._tel.event("stream_slot_admitted", stream_id=stream_id, slot=state.slot)
            if state.native_hw != native_hw:
                self.stats.note("rejected")
                handle.complete(FlowResponse(
                    rid, STATUS_REJECTED,
                    detail=f"stream {stream_id!r} is {state.native_hw}, got frame {native_hw}"))
                return handle
            if state.closing:
                self.stats.note("shed_frames")
                handle.complete(FlowResponse(rid, STATUS_SHED, detail="stream closing"))
                return handle
            last = state.last_frame_index
            idx = frame_index if frame_index is not None else (0 if last is None else last + 1)
            if last is not None and idx <= last:
                self.stats.note("rejected")
                handle.complete(FlowResponse(
                    rid, STATUS_REJECTED,
                    detail=(f"out-of-order frame index {idx} (last admitted {last}) "
                            f"for stream {stream_id!r}")))
                return handle
            cold = last is None or (idx - last) > self.cfg.max_frame_gap
            req = FrameRequest(
                request_id=rid, stream_id=stream_id, slot=state.slot, frame_index=idx,
                image1=image1, image2=image2, cold=cold, submit_time=now,
                pad_spec=self._pad_spec_for(native_hw), shape_key=(self._ph, self._pw),
                trace_id=None if trace_id is None else str(trace_id),
            )
            self._handles[rid] = handle
            if not self._queue.offer(req):
                self._handles.pop(rid, None)
                self.stats.note("shed_frames")
                handle.complete(FlowResponse(rid, STATUS_SHED,
                                             retry_after_s=self._retry_after(),
                                             detail="frame queue full"))
                return handle
            # Only once the offer holds: a shed frame must not advance its
            # stream's index or keep it warm.
            state.last_frame_index = idx
            state.last_activity = now
            state.pending += 1
            state.frames_admitted += 1
        if cold:
            self.stats.note("cold_starts")
        self.stats.note("accepted")
        return handle

    def close_stream(self, stream_id: str) -> bool:
        """Stop admitting frames of ``stream_id``; its slot frees once every
        admitted frame is answered. False for an unknown stream."""
        with self._reg_lock:
            state = self.registry.get(stream_id)
            if state is None:
                return False
            state.closing = True
            if state.pending == 0:
                slot = self.registry.release(stream_id)
                self.stats.note("streams_closed")
                self._tel.event("stream_slot_released", stream_id=stream_id, slot=slot)
        return True

    def _note_evicted(self, evicted: list) -> None:
        for s in evicted:
            self.stats.note("streams_evicted")
            self._tel.event("stream_slot_evicted", stream_id=s.stream_id, slot=s.slot)

    def _frame_error(self, image) -> Optional[str]:
        shape = getattr(image, "shape", None)
        dtype = getattr(image, "dtype", None)
        if shape is None or dtype is None:
            return f"not an array: {type(image).__name__}"
        if len(shape) != 3 or shape[-1] != 3:
            return f"want (H, W, 3), got shape {tuple(shape)}"
        if np.dtype(dtype).kind not in "uif":
            return f"non-numeric dtype {dtype}"
        h, w = int(shape[0]), int(shape[1])
        (t, b), (le, r) = self._pad_spec_for((h, w))
        if (h + t + b, w + le + r) != (self._ph, self._pw):
            return (f"frame {h}x{w} pads to {(h + t + b, w + le + r)}, but this engine "
                    f"serves the {(self._ph, self._pw)} slot table (one padded shape an "
                    "engine)")
        return None

    def _pad_spec_for(self, native_hw: Tuple[int, int]) -> tuple:
        h, w = native_hw
        return InputPadder((h, w, 3), mode="sintel", divisor=self._pad_divisor,
                           bucket=self.cfg.pad_bucket).pad_spec

    def _retry_after(self) -> float:
        with self._ema_lock:
            per_frame = self._service_ema
        if per_frame is None:
            return self.cfg.default_retry_after_s
        return round((len(self._queue) + 1) * per_frame, 4)

    # ------------------------------------------------------------- dispatch

    def _dispatch_loop(self) -> None:
        while True:
            batch = self._queue.pop_batch(self.cfg.max_batch, timeout=_POLL_S,
                                          distinct_fn=lambda r: r.stream_id)
            if not batch:
                if self._queue.closed and not len(self._queue):
                    return
                # Idle tick: abandoned streams lose their slots even when no
                # admission forces the scan.
                with self._reg_lock:
                    evicted = self.registry.evict_expired(self._clock(),
                                                          self.cfg.idle_timeout_s)
                self._note_evicted(evicted)
                continue
            try:
                self._process(batch)
            except BaseException as e:  # noqa: BLE001 - per-frame status
                # The fault is the engine's: every frame of the batch still
                # pending answers `error`, and the engine keeps serving.
                detail = f"{e!r}\n{traceback.format_exc()}"
                for req in batch:
                    if self._complete(req.request_id, FlowResponse(
                            req.request_id, STATUS_ERROR, detail=detail)):
                        self._finish_frame(req)
                        self.stats.note("errors")

    def _step_fn(self):
        """The step of one batch: ``(img1, img2, slot_idx, cold) ->
        (flow_up, bad)``, updating the slot table in place. Under a mesh
        the model runs on this rank's block of the rows and its outputs are
        gathered before the anomaly test."""
        model, policy = self._fwd.model_for()
        table, cfg, mesh = self._table, self.cfg, self.mesh
        carry_net = bool(self._hidden)

        def step(img1, img2, slot_idx, cold):
            # Storage may be bf16; the splat is coordinate arithmetic, f32.
            prev = table["flow"].index_select(0, slot_idx).to(policy.coord)
            warm = table["warm"].index_select(0, slot_idx) * (1.0 - cold) > 0.5
            splat = forward_interpolate_batch(prev, cfg.splat_chunk)
            finit = torch.where(warm[:, None, None, None], splat, torch.zeros_like(splat))
            kw = {}
            if carry_net:
                kw = {"net_init": data_rows(table["net"].index_select(0, slot_idx), mesh),
                      "net_warm": data_rows(warm, mesh)}
            out = model(data_rows(img1, mesh), data_rows(img2, mesh), iters=cfg.iters,
                        flow_init=data_rows(finit, mesh), return_net=True, mesh=mesh, **kw)
            flow_lr, flow_up, net = (gather_data(t, mesh) for t in out)
            bad = (~torch.isfinite(flow_lr).flatten(1).all(1)
                   | ~torch.isfinite(flow_up).flatten(1).all(1)
                   | (flow_lr.abs().flatten(1).amax(1) > cfg.anomaly_max_flow))
            good = ~bad[:, None, None, None]
            # Pad rows all write the scratch row: with duplicate indices the
            # winner of index_copy_ is undefined on CUDA, which is harmless,
            # since a pad row is cold and the scratch row is never read warm.
            table["flow"].index_copy_(0, slot_idx, torch.where(
                good, flow_lr, torch.zeros_like(flow_lr)).to(table["flow"].dtype))
            table["warm"].index_copy_(0, slot_idx, (~bad).to(table["warm"].dtype))
            if carry_net:
                net = net.to(table["net"].dtype)
                table["net"].index_copy_(0, slot_idx, torch.where(good, net,
                                                                  torch.zeros_like(net)))
            return flow_up, bad

        return step

    def _step(self, img1: torch.Tensor, img2: torch.Tensor, slot_idx, cold,
              warmup: bool = False) -> tuple:
        """One step through the cache; returns ``(flow_up, bad)`` on the
        card. ``img1``/``img2`` are staged batches (``stage_frames``); the
        slot indices and cold flags are staged beside them, so on the card
        every input reaches it by a non-blocking copy. Under a lockstep
        group the leader broadcasts the step first. The caller holds the
        step lock."""
        if self._group is None:
            return self._run(img1, img2, slot_idx, cold)
        header = {"slots": [int(i) for i in slot_idx], "cold": [float(c) for c in cold],
                  "warmup": warmup}
        with self._group.dispatch("stream", header, (img1, img2)) as (img1, img2):
            return self._run(img1, img2, slot_idx, cold)

    def lockstep_handlers(self) -> dict:
        """A follower's handler of the leader's ``stream`` dispatches."""
        def stream(header, tensors):
            with self._step_lock:
                self._run(*tensors, header["slots"], header["cold"])

        return {"stream": stream}

    def follow(self) -> int:
        """On a follower of the engine's own lockstep group: run the
        leader's steps until it drains; returns its exit code."""
        return self._group.follow(self.lockstep_handlers())

    def _run(self, img1: torch.Tensor, img2: torch.Tensor, slot_idx, cold) -> tuple:
        idx = stage_pinned(np.asarray(slot_idx, np.int64), torch.int64, self.device)
        cold_t = stage_pinned(np.asarray(cold, np.float32), torch.float32, self.device)
        return self._fwd.custom(("stream", img1.shape[0], self._policy.name), self._step_fn,
                                (img1, img2, idx, cold_t))

    def _ensure_captured(self, n: int) -> None:
        """Build the step entry of batch size ``n`` on scratch-slot,
        all-cold rows. A capture runs the step once eagerly before
        capturing it, and that run writes the slot table: built on a live
        batch, it would hand each warm row its own new flow as the previous
        state. ``cache_size >= len(batch_sizes)`` keeps every entry once
        built. The caller holds the step lock."""
        if n in self._captured:
            return
        zeros = stage_frames([], [], n, (self._ph, self._pw), self.device)
        self._step(zeros, zeros, [self.cfg.capacity] * n, [1.0] * n, warmup=True)
        self._captured.add(n)

    def _run_step(self, img1: torch.Tensor, img2: torch.Tensor, slot_idx, cold,
                  span=contextlib.nullcontext) -> tuple:
        """One step of a live batch (its batch size's entry built first if
        need be), pushed to the dispatch throttle; returns ``(flow_up,
        bad)`` on the card. ``span()`` makes the context that encloses the
        launch and the throttle's wait, not the build."""
        with self._step_lock:
            self._ensure_captured(img1.shape[0])
            with span():
                flow_up, bad = self._step(img1, img2, slot_idx, cold)
                self._throttle.push(flow_up)
            return flow_up, bad

    def _process(self, batch: list) -> None:
        token = self._batch_seq  # the batch's correlation id
        self._batch_seq += 1
        now = self._clock()
        for req in batch:
            self._tel.observe_ms("stream_queue_wait", (now - req.submit_time) * 1e3,
                                 request_id=req.request_id, stream_id=req.stream_id,
                                 batch_id=token, **trace_attr(req))
        # An engine that never warmed up is READY at its first batch (only
        # from the states before READY: an SLO's DEGRADED stays).
        if self.health.state in ("starting", "warming"):
            self.health.ready("serving")
        n_rows = next(b for b in self.cfg.batch_sizes if b >= len(batch))
        pad_rows = n_rows - len(batch)
        with self._tel.span("stream_pad_stage", batch_id=token, rows=len(batch),
                            pad_rows=pad_rows):
            specs = [r.pad_spec for r in batch]
            shape = (self._ph, self._pw)
            img1 = stage_frames([r.image1 for r in batch], specs, n_rows, shape, self.device)
            img2 = stage_frames([r.image2 for r in batch], specs, n_rows, shape, self.device)
            slot_idx = [r.slot for r in batch] + [self.cfg.capacity] * pad_rows
            cold = [1.0 if r.cold else 0.0 for r in batch] + [1.0] * pad_rows
        self.stats.note("batches")
        self.stats.note("padded_rows", pad_rows)
        with self._reg_lock:
            self._occupancy_sum += self.registry.occupancy
            self._tel.gauge_set("stream_slot_occupancy", self.registry.occupancy)
        t_dispatch = self._clock()
        trace_attrs = trace_ids_attr(batch)

        def dispatch_span():
            # The launch: the copies in, the replay, the clones out of the
            # graph's outputs and the throttle's wait (host time).
            stack = contextlib.ExitStack()
            stack.enter_context(self._tel.span(
                "stream_dispatch", batch_id=token, request_ids=[r.request_id for r in batch],
                stream_ids=[r.stream_id for r in batch], mesh=self._fwd.mesh_fp,
                policy=self._policy.name, **trace_attrs))
            stack.enter_context(stage_annotation("stream.dispatch"))
            return stack

        flow_up, bad = self._run_step(img1, img2, slot_idx, cold, dispatch_span)

        def deliver(host, batch=batch, token=token):
            host_flow, host_bad = host
            done = self._clock()
            # One read on the host a batch (the flow and the anomaly flags).
            self._tel.inc("stream_drain_pulls_total")
            self._tel.observe_ms("stream_drain", (done - t_dispatch) * 1e3, batch_id=token,
                                 request_ids=[r.request_id for r in batch], **trace_attrs)
            for k, req in enumerate(batch):
                reset = bool(host_bad[k])
                if reset:
                    resp = FlowResponse(req.request_id, STATUS_REJECTED,
                                        latency_s=done - req.submit_time,
                                        detail="anomaly in the step: stream reset to a cold "
                                               "start")
                else:
                    (t, b), (le, r) = req.pad_spec
                    hh, ww = host_flow.shape[1], host_flow.shape[2]
                    resp = FlowResponse(req.request_id, STATUS_OK,
                                        flow=host_flow[k, t: hh - b, le: ww - r, :],
                                        iters=self.cfg.iters, latency_s=done - req.submit_time)
                # Only a completion that happens is accounted: a frame a
                # failure already answered must not finish twice.
                if not self._complete(req.request_id, resp):
                    continue
                self._finish_frame(req, reset=reset)
                self.stats.note("resets" if reset else "completed")
                if reset:
                    self._tel.event("stream_anomaly_reset", stream_id=req.stream_id,
                                    slot=req.slot, frame_index=req.frame_index, batch_id=token)
                    # The reset and the timeline that led to it (the frame's
                    # whole journey is still in the ring).
                    self._tel.flight_dump("stream_anomaly_reset", stream_id=req.stream_id,
                                          slot=req.slot, frame_index=req.frame_index,
                                          batch_id=token)
                else:
                    # Submit -> delivered: the stream_p99_latency SLO's SLI.
                    self._tel.hist_observe("stream_e2e_ms", (done - req.submit_time) * 1e3)
            self._note_service((done - t_dispatch) / max(1, len(batch)))
            with self._inflight_lock:  # delivered: nothing left to strand
                self._inflight.pop(token, None)

        with self._inflight_lock:
            self._inflight[token] = batch
        try:
            self._drainer.submit((flow_up, bad), deliver,
                                 on_error=lambda e: self._fail_batch(token, e))
        except BaseException:
            with self._inflight_lock:
                self._inflight.pop(token, None)
            raise

    def _fail_batch(self, token: int, exc: BaseException) -> None:
        """Answer ``error`` to every still-pending frame of the in-flight
        batch ``token`` (its read or its delivery failed on the drain
        worker)."""
        with self._inflight_lock:
            batch = self._inflight.pop(token, [])
        self._fail_frames(batch, exc)

    def _fail_inflight(self, exc: BaseException) -> None:
        """Complete every batch still in flight with an explicit ``error``
        (the drain worker itself broke)."""
        with self._inflight_lock:
            stranded = list(self._inflight.values())
            self._inflight.clear()
        for batch in stranded:
            self._fail_frames(batch, exc)

    def _fail_frames(self, batch: list, exc: BaseException) -> None:
        for req in batch:
            if self._complete(req.request_id, FlowResponse(
                    req.request_id, STATUS_ERROR, detail=f"result drain failed: {exc!r}")):
                self._finish_frame(req)
                self.stats.note("errors")

    def _finish_frame(self, req: FrameRequest, reset: bool = False) -> None:
        """A frame's terminal bookkeeping: its stream's pending count, a
        deferred close, its reset count."""
        with self._reg_lock:
            state = self.registry.get(req.stream_id)
            if state is None:
                return
            state.pending = max(0, state.pending - 1)
            state.frames_completed += 1
            if reset:
                state.resets += 1
            if state.closing and state.pending == 0:
                slot = self.registry.release(req.stream_id)
                self.stats.note("streams_closed")
                self._tel.event("stream_slot_released", stream_id=req.stream_id, slot=slot)

    def _complete(self, rid: int, response: FlowResponse) -> bool:
        handle = self._handles.pop(rid, None)
        if handle is None:
            return False
        handle.complete(response)
        return True

    def _note_service(self, per_frame_s: float) -> None:
        with self._ema_lock:
            prev = self._service_ema
            self._service_ema = per_frame_s if prev is None else 0.8 * prev + 0.2 * per_frame_s
            ema = self._service_ema
        self._tel.gauge_set("stream_service_time_ema_ms", ema * 1e3)

    # ------------------------------------------------------------ lifecycle

    def warmup(self) -> int:
        """Capture the step of every batch size against the scratch slot
        (cold pad rows only, so no stream's state moves), with the
        dispatcher held: new batches wait (pause) and one already popped
        finishes first (the step lock). Returns the captures made. Health
        goes WARMING, then READY."""
        self.health.warming()
        before = self._fwd.stats["compiles"]
        self._queue.set_paused(True)
        try:
            for n in self.cfg.batch_sizes:
                with self._step_lock:
                    self._ensure_captured(n)
                self.warmed.append((self._ph, self._pw, n, self.cfg.iters))
        finally:
            self._queue.set_paused(False)
        captured = self._fwd.stats["compiles"] - before
        self.health.ready(f"warmup captured {captured} graphs")
        return captured

    def pause(self) -> None:
        """Stop assembling new batches; queued and new frames wait."""
        self._queue.set_paused(True)

    def resume(self) -> None:
        self._queue.set_paused(False)

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def drain(self, timeout: Optional[float] = None) -> StreamStats:
        """Stop admitting, answer every admitted frame, stop the dispatcher
        and return the stats. Idempotent. Health goes DRAINING at once,
        before the flush."""
        self.health.draining()
        self._draining.set()
        self._queue.close()  # also clears a pause: the drain must finish
        if self._thread.is_alive():
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(f"stream dispatcher did not drain within {timeout}s "
                                   f"({len(self._queue)} frames still queued)")
        if not self._drained:
            self._drained = True
            self._throttle.drain()
            try:
                self._drainer.close()
            except Exception as e:
                print(f"stream drain worker failed: {e!r}", file=sys.stderr)
                self._fail_inflight(e)
            if self._owns_group and self._group.leader:
                self._group.stop(0)
        return self.stats

    def report(self) -> dict:
        """One JSON-able summary: the stats, the slot table's occupancy and
        bytes, the step entries' captures, the stream stages' p50/p99 from
        the span tracer and the health snapshot."""
        stages = {k: v for k, v in self._tel.tracer.stage_summary().items()
                  if k.startswith("stream_")}
        with self._reg_lock:
            occupancy = self.registry.occupancy
            peak = self.registry.peak_occupancy
            evicted = self.registry.evicted_total
        return {
            "stats": self.stats.summary(),
            "capacity": self.cfg.capacity,
            "occupancy": occupancy,
            "peak_occupancy": peak,
            "mean_occupancy": round(self._occupancy_sum / max(1, self.stats.batches), 2),
            "evicted": evicted,
            "executables": dict(self._fwd.stats),
            "precision": self._policy.name,
            "slot_table_bytes": sum(t.numel() * t.element_size()
                                    for t in self._table.values()),
            "graph_pool_bytes": sum(self._fwd.pool_bytes.values()),
            "device": str(self.device),
            "mesh": self._fwd.mesh_fp,
            "stages": stages,
            "health": self.health.snapshot(),
        }

    def __enter__(self) -> "StreamEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.drain()
