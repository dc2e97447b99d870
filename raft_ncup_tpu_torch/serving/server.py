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
4. **dispatch**: host-side edge pad, zero rows up to the nearest allowed
   batch size, and one test-mode forward through the server's
   ``ShapeCachedForward``: a captured CUDA graph per (padded shape, batch
   size, iteration level) on the card, the eager forward on the CPU.
5. **complete**: copy the flow to the host (out of the graph's outputs,
   before the next replay), crop each row back to its native shape and
   complete its handle.

The dispatcher waits for the batch's result (the copy to the host) and
completes its handles itself: the JAX package's dispatch throttle and
asynchronous drain worker have no counterpart here. Telemetry, meshes
and early exit land with later slices.

**Precision**: ``ServeConfig.precision`` names the preset the server's
forwards run under; ``None`` inherits the model's own. Another preset runs
the model's own parameters at that preset's dtypes
(``RAFT.with_policy``): no weight is copied. The report names the
resolved preset and carries the cache's ``executables`` stats (captures,
hits, evictions) and the device memory its graphs reserved.

**Drain contract** (``drain()``, also on leaving a ``with FlowServer(...)``
block): stop admitting (new submits shed with
``detail="draining"``), flush every admitted request through compute,
stop the dispatcher and return the final ``ServeStats``.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Callable, Optional

import numpy as np
import torch

from raft_ncup_tpu_torch.config import ServeConfig
from raft_ncup_tpu_torch.inference.pipeline import ShapeCachedForward
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
)

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
    ):
        self.cfg = cfg or ServeConfig()
        self.model = model
        # One cached forward per (padded shape, batch size, iterations),
        # under the server's preset (the model's own when it inherits).
        self._fwd = ShapeCachedForward(model, cache_size=self.cfg.cache_size,
                                       policy=self.cfg.precision)
        self.policy = self._fwd.policy
        self.device = model.device
        self._clock = clock
        self.stats = ServeStats()
        self._queue = AdmissionQueue(self.cfg.queue_capacity)
        self.budget = IterationBudgetController(
            self.cfg.iter_levels,
            capacity=self.cfg.queue_capacity,
            high_water=self.cfg.high_water,
            low_water=self.cfg.low_water,
            recover_patience=self.cfg.recover_patience,
        )
        self._handles: dict[int, ServeHandle] = {}
        self._handles_lock = threading.Lock()
        self._service_ema: Optional[float] = None  # seconds per pair
        self._ema_lock = threading.Lock()
        self._next_id = 0
        self._id_lock = threading.Lock()
        self._draining = threading.Event()
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
    ) -> ServeHandle:
        """Submit one (H, W, 3) frame pair; returns a handle at once. The
        handle completes with exactly one terminal status. ``deadline_s``
        is seconds from now (default ``cfg.default_deadline_s``)."""
        self.stats.note_submitted()
        handle = ServeHandle()
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
        now = self._clock()
        live = []
        for req in batch:
            if req.deadline is not None and now > req.deadline:
                self.stats.note_timeout()
                self._complete(req.request_id, FlowResponse(
                    req.request_id, STATUS_TIMEOUT,
                    latency_s=now - req.submit_time,
                    detail="deadline expired in queue",
                ))
                continue
            poison = self._poison_error(req)
            if poison is not None:
                self.stats.note_rejected(req.request_id, quarantine=True)
                self._complete(req.request_id, FlowResponse(
                    req.request_id, STATUS_REJECTED, detail=poison,
                ))
                continue
            live.append(req)
        if not live:
            return
        iters = self.budget.decide(depth)
        ph, pw = live[0].shape_key
        n_rows = next(b for b in self.cfg.batch_sizes if b >= len(live))
        pad_rows = n_rows - len(live)
        rows1 = [self._stage(r.image1, r.pad_spec) for r in live]
        rows2 = [self._stage(r.image2, r.pad_spec) for r in live]
        zeros = np.zeros((ph, pw, 3), np.float32)
        rows1 += [zeros] * pad_rows
        rows2 += [zeros] * pad_rows
        self.stats.note_batch(pad_rows)
        t_dispatch = self._clock()
        host_flow = self._forward(np.stack(rows1), np.stack(rows2), iters)
        done = self._clock()
        for k, req in enumerate(live):
            (t, b), (le, r) = req.pad_spec
            hh, ww = host_flow.shape[1], host_flow.shape[2]
            flow = host_flow[k, t: hh - b, le: ww - r, :]
            self.stats.note_completed()
            self._complete(req.request_id, FlowResponse(
                req.request_id, STATUS_OK, flow=flow, iters=iters,
                latency_s=done - req.submit_time,
            ))
        # Dispatch -> delivery per pair: the service time behind the shed
        # hint (measuring from submit would count the queue wait twice).
        self._note_service((done - t_dispatch) / len(live))

    def _forward(self, img1: np.ndarray, img2: np.ndarray, iters: int) -> np.ndarray:
        """One test-mode forward through the cached forward; returns the
        (B, H, W, 2) full-resolution flow on the host."""
        _, flow_up = self._fwd.forward(torch.from_numpy(img1), torch.from_numpy(img2), iters)
        return flow_up.cpu().numpy()

    def _poison_error(self, req: FlowRequest) -> Optional[str]:
        for name, img in (("image1", req.image1), ("image2", req.image2)):
            arr = np.asarray(img)
            if arr.dtype.kind == "f" and not np.isfinite(arr).all():
                return f"non-finite pixels in {name}"
        return None

    def _stage(self, image, pad_spec) -> np.ndarray:
        (t, b), (le, r) = pad_spec
        arr = np.asarray(image, np.float32)
        if t or b or le or r:
            arr = np.pad(arr, ((t, b), (le, r), (0, 0)), mode="edge")
        return arr

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

    # ------------------------------------------------------------- lifecycle

    def warmup(self, size_hw: tuple) -> int:
        """Capture every (batch size, iteration level) the dispatcher may
        use, at the padded shape of ``size_hw``, so no request pays a
        first-use cost (kernel build, cuDNN's autotuning, which the cache
        runs at each capture, the capture itself). Returns the number of
        forwards captured."""
        h, w = (int(v) for v in size_hw)
        padder = InputPadder((h, w, 3), mode="sintel", bucket=self.cfg.pad_bucket)
        (t, b), (le, r) = padder.pad_spec
        ph, pw = h + t + b, w + le + r
        before = self._fwd.stats["compiles"]
        for n in self.cfg.batch_sizes:
            zeros = np.zeros((n, ph, pw, 3), np.float32)
            for iters in self.cfg.iter_levels:
                self._forward(zeros, zeros, iters)
        return self._fwd.stats["compiles"] - before

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
        and return the final stats. Idempotent."""
        self._draining.set()
        self._queue.close()  # also clears a pause: the drain must finish
        if self._thread.is_alive():
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"dispatcher did not drain within {timeout}s "
                    f"({len(self._queue)} requests still queued)"
                )
        return self.stats

    def report(self) -> dict:
        """One JSON-able summary of the stats and the budget."""
        return {
            "stats": self.stats.summary(),
            "budget": self.budget.summary(),
            "budget_drops": self.budget.drops,
            "budget_recoveries": self.budget.recoveries,
            "device": str(self.device),
            "precision": self.policy.name,
            "executables": dict(self._fwd.stats),
            "graph_pool_bytes": sum(self._fwd.pool_bytes.values()),
        }

    def __enter__(self) -> "FlowServer":
        return self

    def __exit__(self, *exc) -> None:
        self.drain()
