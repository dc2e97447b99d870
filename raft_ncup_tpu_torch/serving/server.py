"""The flow-serving front end: dynamic micro-batching with admission
control, deadlines, an anytime iteration budget, poison quarantine and a
graceful drain (port of ``raft_ncup_tpu/serving/server.py``).

Data path (one dispatcher thread; clients submit from their own threads):

1. **submit**: cheap metadata validation (ndim, dtype, size limits), the
   ``InputPadder`` pad spec (the request batches under its PADDED shape),
   then a non-blocking ``AdmissionQueue.offer``; a full queue sheds with a
   ``retry_after_s`` hint from the live service-time EMA.
2. **assemble**: pop a FIFO run of same-shape requests, answer the ones
   past their deadline with ``timeout``, and quarantine a request with
   non-finite pixels alone (``rejected``) while its batch-mates proceed.
3. **budget**: one ``IterationBudgetController.decide`` per batch.
4. **stage and dispatch**: each frame edge-padded on the host and written
   straight into one batch tensor, zero rows up to the nearest allowed
   batch size (``inference.pipeline.stage_frames``: in pinned memory on
   the card), and one test-mode forward through the server's
   ``ShapeCachedForward``: a captured CUDA graph per (padded shape, batch
   size, iteration level) on the card, whose input copies from pinned
   memory queue without a wait; the eager forward on the CPU. The
   ``DispatchThrottle`` (``cfg.inflight``, 2 on the card) then waits only
   for the batch before the previous one, so the dispatcher stages and
   launches batch n+1 while the card still runs batch n.
5. **complete** (drain worker): the flow (and, with early exit, the
   executed iterations) is copied into pinned host memory behind the
   replay, and ``AsyncDrain``'s worker reads it with the sanctioned
   ``analysis.guards.host_read`` (one per batch), crops each row back to
   its native shape and completes its handle. A batch handed to the worker
   stays in the in-flight registry until it is delivered: a failed read
   or delivery answers that batch's requests with ``error`` at once.

Steady-state serving reads nothing else on the host and captures nothing
(``tests/test_torch_guards.py`` holds a window to that under the
runtime guards). ``inflight=1`` is the waiting server: each push waits
for its own batch, with the same answers. Meshes land with a later slice
(ROADMAP.md, queue 1 item 9).

**Telemetry** (``telemetry=``, the process's hub by default): the stats
mirror into the registry under the JAX package's counter names; each
batch's assembly, host staging (``serve_pad_stage``), launch
(``serve_dispatch``, also a ``stage_annotation`` on a profiler's
timeline) and dispatch-to-delivery (``serve_drain``) are host spans with
request and batch ids, and each request's queue wait and end-to-end
latency are observed. Every recorded value is a host number (the drain's
are taken on its worker after the batch's one read): telemetry adds no
synchronisation. A
poison quarantine banks a ``poison_quarantine`` flight dump. ``health``
is the hub's ``serve`` tracker: STARTING at construction, WARMING then
READY through ``warmup`` (or READY at the first batch), READY <-> DEGRADED
by the SLO verdicts, DRAINING in ``drain``. The budget reads the hub's
``slo_paging("serve")`` as its second degrade input.

**Early exit** (``RAFT_TORCH_EARLYEXIT=1``, tolerance
``RAFT_TORCH_EARLYEXIT_TOL``, read once at construction by
``inference.pipeline.env_earlyexit_tol``): each batch runs the early-exit
forward of its dispatched level, a response's ``iters`` is that level,
and the batch's mean executed iterations over its live rows (the zero pad
rows converge at once) feed ``budget.note_executed``. ``warmup`` captures
the early-exit entries then, so no request pays a capture. The report's
``earlyexit`` counts the forwards, the segments they replayed and the
flags they read on the host.

**Precision**: ``ServeConfig.precision`` names the preset the server's
forwards run under; ``None`` inherits the model's own. Another preset runs
the model's own parameters at that preset's dtypes
(``RAFT.with_policy``): no weight is copied. The report names the
resolved preset and carries the cache's ``executables`` stats (captures,
hits, evictions) and the device memory its graphs reserved.

**Drain contract** (``drain()``, also on leaving a ``with FlowServer(...)``
block): stop admitting (new submits shed with
``detail="draining"``), flush every admitted request through compute,
stop the dispatcher, wait for the throttle's batches, close the drain
worker (delivering what it holds) and return the final ``ServeStats``.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Callable, Optional

import numpy as np

from raft_ncup_tpu_torch.config import ServeConfig
from raft_ncup_tpu_torch.inference.pipeline import (
    MESH_FP,
    AsyncDrain,
    DispatchThrottle,
    ShapeCachedForward,
    env_earlyexit_tol,
    stage_frames,
)
from raft_ncup_tpu_torch.observability import get_telemetry
from raft_ncup_tpu_torch.ops.padding import InputPadder
from raft_ncup_tpu_torch.serving.admission import AdmissionQueue
from raft_ncup_tpu_torch.serving.budget import IterationBudgetController
from raft_ncup_tpu_torch.serving.request import (
    STATUS_ERROR,
    STATUS_OK,
    STATUS_REJECTED,
    STATUS_SHED,
    STATUS_TIMEOUT,
    FlowRequest,
    FlowResponse,
    ServeHandle,
    ServeStats,
    trace_attr,
    trace_ids_attr,
)
from raft_ncup_tpu_torch.utils.profiling import stage_annotation

_POLL_S = 0.05  # dispatcher wake cadence while the queue is idle


class FlowServer:
    """Serve flow requests with one port ``RAFT`` model, on the model's
    device. ``clock`` is injectable and must be monotonic. The server owns
    one dispatcher thread from construction until :meth:`drain`."""

    def __init__(
        self,
        model,
        cfg: Optional[ServeConfig] = None,
        *,
        clock: Callable[[], float] = time.monotonic,
        telemetry=None,
    ):
        self.cfg = cfg or ServeConfig()
        self.model = model
        self._tel = telemetry if telemetry is not None else get_telemetry()
        self.stats = ServeStats(telemetry=self._tel)
        self.health = self._tel.health("serve", fresh=True)
        # One cached forward per (padded shape, batch size, iterations),
        # under the server's preset (the model's own when it inherits).
        self._fwd = ShapeCachedForward(model, cache_size=self.cfg.cache_size,
                                       policy=self.cfg.precision, telemetry=self._tel)
        self.policy = self._fwd.policy
        self.device = model.device
        self._earlyexit_tol = env_earlyexit_tol()
        self._clock = clock
        self._queue = AdmissionQueue(self.cfg.queue_capacity, telemetry=self._tel,
                                     name="serve")
        self.budget = IterationBudgetController(
            self.cfg.iter_levels,
            capacity=self.cfg.queue_capacity,
            high_water=self.cfg.high_water,
            low_water=self.cfg.low_water,
            recover_patience=self.cfg.recover_patience,
        )
        self._throttle = DispatchThrottle(self.cfg.inflight)
        self._drainer = AsyncDrain(depth=self.cfg.drain_depth)
        self._handles: dict[int, ServeHandle] = {}
        self._handles_lock = threading.Lock()
        # Batches handed to the drain worker and not yet delivered, by
        # batch id: what a failed read or delivery answers with `error`.
        self._inflight: dict[int, list] = {}
        self._inflight_lock = threading.Lock()
        self._service_ema: Optional[float] = None  # seconds per pair
        self._ema_lock = threading.Lock()
        self._next_id = 0
        self._id_lock = threading.Lock()
        self._batch_seq = 0  # batch correlation ids (the dispatcher's only)
        # The warmed (padded H, padded W, batch, iters) set, see warmup():
        # the identity the serve entry's healthz file advertises.
        self.warmed: list = []
        self._draining = threading.Event()
        self._drained = False
        self._thread = threading.Thread(
            target=self._dispatch_loop, name="flow-serve-dispatch", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------ admission

    def submit(
        self,
        image1,
        image2,
        *,
        deadline_s: Optional[float] = None,
        request_id: Optional[int] = None,
        trace_id: Optional[str] = None,
    ) -> ServeHandle:
        """Submit one (H, W, 3) frame pair; returns a handle at once. The
        handle completes with exactly one terminal status. ``deadline_s``
        is seconds from now (default ``cfg.default_deadline_s``).
        ``request_id`` lets a fleet router supply its correlation id as
        the request's identity (the response and the replica-side spans
        carry it; the caller owns uniqueness). ``trace_id`` adopts an
        inbound trace: the admission, batch and device spans of this
        request carry it."""
        self.stats.note_submitted()
        handle = ServeHandle()
        if request_id is not None:
            rid = int(request_id)
        else:
            with self._id_lock:
                rid = self._next_id
                self._next_id += 1
        if self._draining.is_set():
            self.stats.note_shed()
            handle.complete(FlowResponse(
                rid, STATUS_SHED, retry_after_s=self._retry_after(),
                detail="draining",
            ))
            return handle
        err = self._admission_error(image1) or self._admission_error(image2)
        if err is None and image1.shape != image2.shape:
            err = f"frame shapes differ: {image1.shape} vs {image2.shape}"
        if err is not None:
            self.stats.note_rejected(rid)
            handle.complete(FlowResponse(rid, STATUS_REJECTED, detail=err))
            return handle
        h, w = int(image1.shape[0]), int(image1.shape[1])
        padder = InputPadder((h, w, 3), mode="sintel", bucket=self.cfg.pad_bucket)
        (t, b), (le, r) = padder.pad_spec
        if deadline_s is None:
            deadline_s = self.cfg.default_deadline_s
        now = self._clock()
        req = FlowRequest(
            request_id=rid,
            image1=image1,
            image2=image2,
            deadline=None if deadline_s is None else now + deadline_s,
            submit_time=now,
            shape_key=(h + t + b, w + le + r),
            pad_spec=padder.pad_spec,
            trace_id=None if trace_id is None else str(trace_id),
        )
        with self._handles_lock:
            self._handles[rid] = handle
        if not self._queue.offer(req):
            with self._handles_lock:
                self._handles.pop(rid, None)
            self.stats.note_shed()
            handle.complete(FlowResponse(
                rid, STATUS_SHED, retry_after_s=self._retry_after(),
                detail="admission queue full",
            ))
            return handle
        self.stats.note_accepted()
        return handle

    def _admission_error(self, image) -> Optional[str]:
        shape = getattr(image, "shape", None)
        dtype = getattr(image, "dtype", None)
        if shape is None or dtype is None:
            return f"not an array: {type(image).__name__}"
        if len(shape) != 3 or shape[-1] != 3:
            return f"want (H, W, 3), got shape {tuple(shape)}"
        if np.dtype(dtype).kind not in "uif":
            return f"non-numeric dtype {dtype}"
        h, w = int(shape[0]), int(shape[1])
        mh, mw = self.cfg.max_image_hw
        if h < self.cfg.min_image_hw or w < self.cfg.min_image_hw:
            return f"image {h}x{w} below minimum {self.cfg.min_image_hw}"
        if h > mh or w > mw:
            return f"image {h}x{w} exceeds maximum {mh}x{mw}"
        return None

    def _retry_after(self) -> float:
        with self._ema_lock:
            per_pair = self._service_ema
        if per_pair is None:
            return self.cfg.default_retry_after_s
        # The time the current backlog needs to clear.
        return round((len(self._queue) + 1) * per_pair, 4)

    # ------------------------------------------------------------- dispatch

    def _dispatch_loop(self) -> None:
        while True:
            batch = self._queue.pop_batch(self.cfg.max_batch, timeout=_POLL_S)
            if not batch:
                if self._queue.closed and not len(self._queue):
                    return
                continue
            depth = len(self._queue) + len(batch)
            try:
                self._process(batch, depth)
            except BaseException as e:  # noqa: BLE001 - per-request status
                # The fault is the server's: every still-pending request of
                # the batch gets an `error` response (those the batch already
                # answered keep theirs) and the loop serves the next batch.
                detail = f"{e!r}\n{traceback.format_exc()}"
                for req in batch:
                    if self._complete(req.request_id, FlowResponse(
                        req.request_id, STATUS_ERROR, detail=detail,
                    )):
                        self.stats.note_error()

    def _process(self, batch: list, depth: int) -> None:
        token = self._batch_seq  # the batch's correlation id
        self._batch_seq += 1
        now = self._clock()
        live = []
        with self._tel.span("serve_batch_assembly", batch_id=token, batch_size=len(batch)):
            for req in batch:
                if req.deadline is not None and now > req.deadline:
                    self.stats.note_timeout()
                    self._complete(req.request_id, FlowResponse(
                        req.request_id, STATUS_TIMEOUT,
                        latency_s=now - req.submit_time,
                        detail="deadline expired in queue",
                    ))
                    continue
                # Submit -> assembly, also for a request about to be
                # quarantined: the flight dump must hold its journey.
                self._tel.observe_ms("serve_queue_wait", (now - req.submit_time) * 1e3,
                                     request_id=req.request_id, batch_id=token,
                                     **trace_attr(req))
                poison = self._poison_error(req)
                if poison is not None:
                    self.stats.note_rejected(req.request_id, quarantine=True)
                    self._tel.flight_dump("poison_quarantine", request_id=req.request_id,
                                          batch_id=token, detail=poison)
                    self._complete(req.request_id, FlowResponse(
                        req.request_id, STATUS_REJECTED, detail=poison,
                    ))
                    continue
                live.append(req)
        if not live:
            return
        # A server that never warmed up is READY at its first batch (only
        # from the states before READY: an SLO's DEGRADED stays).
        if self.health.state in ("starting", "warming"):
            self.health.ready("serving")
        iters = self.budget.decide(depth, slo_degraded=self._tel.slo_paging("serve"))
        self._tel.gauge_set("serve_iter_budget", iters)
        ph, pw = live[0].shape_key
        with self._tel.span("serve_pad_stage", batch_id=token, rows=len(live)) as stage_span:
            n_rows = next(b for b in self.cfg.batch_sizes if b >= len(live))
            pad_rows = n_rows - len(live)
            specs = [r.pad_spec for r in live]
            img1 = stage_frames([r.image1 for r in live], specs, n_rows, (ph, pw), self.device)
            img2 = stage_frames([r.image2 for r in live], specs, n_rows, (ph, pw), self.device)
            stage_span.set(pad_rows=pad_rows)
        self.stats.note_batch(pad_rows)
        t_dispatch = self._clock()
        ee_tol = self._earlyexit_tol
        # The launch and the throttle's bounded wait (host time; the card's
        # time is not a span; the drain span covers dispatch -> delivery).
        trace_attrs = trace_ids_attr(live)
        with self._tel.span(
                "serve_dispatch", batch_id=token, request_ids=[r.request_id for r in live],
                iters=iters, mesh=MESH_FP, policy=self.policy.name, **trace_attrs,
                **({"earlyexit_tol": ee_tol} if ee_tol is not None else {})), \
                stage_annotation("serve.dispatch"):
            flow_up, exec_iters = self._forward(img1, img2, iters)
            self._throttle.push(flow_up)

        def deliver(host_out, live=live, iters=iters, token=token):
            done = self._clock()
            host_flow, host_exec = host_out if exec_iters is not None else (host_out, None)
            # Dispatch -> delivered on the host: the card's compute and the
            # batch's one sanctioned read on this worker.
            self._tel.inc("serve_drain_pulls_total")
            exec_attrs = {}
            if host_exec is not None:
                live_exec = host_exec[: len(live)]  # pad rows converge at once
                exec_attrs = {"iters_budgeted": iters,
                              "iters_executed_mean": round(float(live_exec.mean()), 3)}
            self._tel.observe_ms("serve_drain", (done - t_dispatch) * 1e3, batch_id=token,
                                 request_ids=[r.request_id for r in live], **trace_attrs,
                                 **exec_attrs)
            if host_exec is not None:
                for k in range(len(live)):
                    self._tel.hist_observe("serve_exec_iters", float(live_exec[k]))
                self.budget.note_executed(float(live_exec.mean()))
            for k, req in enumerate(live):
                (t, b), (le, r) = req.pad_spec
                hh, ww = host_flow.shape[1], host_flow.shape[2]
                flow = host_flow[k, t: hh - b, le: ww - r, :]
                self.stats.note_completed()
                # Submit -> delivered: the serve_p99_latency SLO's SLI
                # (histogram only, no ring record).
                self._tel.hist_observe("serve_e2e_ms", (done - req.submit_time) * 1e3)
                self._complete(req.request_id, FlowResponse(
                    req.request_id, STATUS_OK, flow=flow, iters=iters,
                    latency_s=done - req.submit_time,
                ))
            # Dispatch -> delivery per pair: the service time behind the
            # shed hint (measuring from submit would count the queue wait
            # twice).
            self._note_service((done - t_dispatch) / len(live))
            with self._inflight_lock:  # delivered: nothing left to strand
                self._inflight.pop(token, None)

        with self._inflight_lock:
            self._inflight[token] = live
        try:
            self._drainer.submit(flow_up if exec_iters is None else (flow_up, exec_iters),
                                 deliver, on_error=lambda e: self._fail_batch(token, e))
        except BaseException:
            with self._inflight_lock:
                self._inflight.pop(token, None)
            raise

    def _forward(self, img1, img2, iters: int) -> tuple:
        """Launch one test-mode forward through the cached forward, the
        early-exit one when detection is on: ``(flow_up, exec_iters)`` on
        the model's device, the (B, H, W, 2) full-resolution flow and the
        (B,) executed iterations (None without detection). Nothing is read
        on the host (early exit's flag reads aside)."""
        if self._earlyexit_tol is None:
            return self._fwd.forward(img1, img2, iters)[1], None
        _, flow_up, exec_iters = self._fwd.forward(img1, img2, iters,
                                                   early_exit_tol=self._earlyexit_tol)
        return flow_up, exec_iters

    def _fail_batch(self, token: int, exc: BaseException) -> None:
        """Answer ``error`` to every still-pending request of the in-flight
        batch ``token`` (its read or its delivery failed on the drain
        worker; requests it already answered keep their answer)."""
        with self._inflight_lock:
            live = self._inflight.pop(token, [])
        self._fail_requests(live, exc)

    def _fail_inflight(self, exc: BaseException) -> None:
        """Complete every batch still in flight with an explicit ``error``:
        the no-silent-loss half of the drain contract when the drain worker
        itself broke."""
        with self._inflight_lock:
            stranded = list(self._inflight.values())
            self._inflight.clear()
        for live in stranded:
            self._fail_requests(live, exc)

    def _fail_requests(self, live: list, exc: BaseException) -> None:
        for req in live:
            if self._complete(req.request_id, FlowResponse(
                    req.request_id, STATUS_ERROR, detail=f"result drain failed: {exc!r}")):
                self.stats.note_error()

    def _poison_error(self, req: FlowRequest) -> Optional[str]:
        for name, img in (("image1", req.image1), ("image2", req.image2)):
            arr = np.asarray(img)
            if arr.dtype.kind == "f" and not np.isfinite(arr).all():
                return f"non-finite pixels in {name}"
        return None

    def _complete(self, rid: int, response: FlowResponse) -> bool:
        """Deliver ``response`` if ``rid`` is still pending; True when a
        handle was completed (each request resolves once)."""
        with self._handles_lock:
            handle = self._handles.pop(rid, None)
        if handle is None:
            return False
        handle.complete(response)
        return True

    def _note_service(self, per_pair_s: float) -> None:
        with self._ema_lock:
            prev = self._service_ema
            self._service_ema = (
                per_pair_s if prev is None else 0.8 * prev + 0.2 * per_pair_s
            )
            ema = self._service_ema
        # The basis of the shed hint, observable as a gauge.
        self._tel.gauge_set("serve_service_time_ema_ms", ema * 1e3)

    # ------------------------------------------------------------- lifecycle

    def warmup(self, size_hw: tuple) -> int:
        """Capture every (batch size, iteration level) the dispatcher may
        use, at the padded shape of ``size_hw``, so no request pays a
        first-use cost (kernel build, cuDNN's autotuning, which the cache
        runs at each capture, the capture itself); with early exit on,
        the early-exit entries. Returns the number of entries captured.
        Health goes WARMING, then READY."""
        self.health.warming()
        h, w = (int(v) for v in size_hw)
        padder = InputPadder((h, w, 3), mode="sintel", bucket=self.cfg.pad_bucket)
        (t, b), (le, r) = padder.pad_spec
        ph, pw = h + t + b, w + le + r
        before = self._fwd.stats["compiles"]
        warmed = []
        for n in self.cfg.batch_sizes:
            zeros = stage_frames([], [], n, (ph, pw), self.device)
            for iters in self.cfg.iter_levels:
                self._forward(zeros, zeros, iters)
                warmed.append((ph, pw, n, iters))
        self.warmed = warmed
        captured = self._fwd.stats["compiles"] - before
        self.health.ready(f"warmup captured {captured} graphs")
        return captured

    def pause(self) -> None:
        """Stop assembling new batches; queued requests wait."""
        self._queue.set_paused(True)

    def resume(self) -> None:
        self._queue.set_paused(False)

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def drain(self, timeout: Optional[float] = None) -> ServeStats:
        """Stop admitting, flush everything admitted, stop the dispatcher
        and return the final stats. Idempotent. Health goes DRAINING at
        once, before the flush: a healthz poller stops routing here."""
        self.health.draining()
        self._draining.set()
        self._queue.close()  # also clears a pause: the drain must finish
        if self._thread.is_alive():
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"dispatcher did not drain within {timeout}s "
                    f"({len(self._queue)} requests still queued)"
                )
        if not self._drained:
            self._drained = True
            self._throttle.drain()
            try:
                self._drainer.close()
            except Exception as e:
                # The drain worker died with batches in flight: their
                # requests answer `error` (nothing admitted is lost silently).
                print(f"serve drain worker failed: {e!r}", file=sys.stderr)
                self._fail_inflight(e)
        return self.stats

    def report(self) -> dict:
        """One JSON-able summary of the stats and the budget, the serve
        stages' p50/p99 from the span tracer and the health snapshot."""
        stages = {k: v for k, v in self._tel.tracer.stage_summary().items()
                  if k.startswith("serve_")}
        return {
            "stats": self.stats.summary(),
            "budget": self.budget.summary(),
            "budget_drops": self.budget.drops,
            "budget_recoveries": self.budget.recoveries,
            "budget_slo_drops": self.budget.slo_drops,
            "device": str(self.device),
            "precision": self.policy.name,
            "budget_expected_iters": round(self.budget.expected_iters, 3),
            "executables": dict(self._fwd.stats),
            "graph_pool_bytes": sum(self._fwd.pool_bytes.values()),
            "earlyexit_tol": self._earlyexit_tol,
            "earlyexit": dict(self._fwd.earlyexit),
            "mesh": MESH_FP,
            "stages": stages,
            "health": self.health.snapshot(),
        }

    def __enter__(self) -> "FlowServer":
        return self

    def __exit__(self, *exc) -> None:
        self.drain()
