"""The evaluation pipeline (port of ``raft_ncup_tpu/inference/pipeline.py``):
decode ahead, stage and copy ahead, a bounded cache of per-shape CUDA
graphs of the forward, a bounded dispatch queue and a device-to-host
drain off the dispatch thread.

- **decode ahead** (:class:`SamplePrefetcher`): a thread pool decodes
  samples ahead of use, in order; a decode error re-raises from
  ``next()``, ``close()`` cancels what is queued.
- **stage and copy ahead** (:class:`EvalPipeline`): a worker thread
  groups samples into batches (:func:`uniform_batches`), stacks and pads
  them on the host, and copies each batch to the card from pinned memory
  on a side stream, ``depth`` batches ahead; ``next()`` makes the current
  stream wait on the copy's event.
- **compute** (:class:`ShapeCachedForward`): one captured CUDA graph per
  (padded shape, batch, iterations, warm start, metric kind and pad,
  precision preset), in an LRU of ``cache_size`` entries. A graph holds
  the test-mode forward and, for validation, the metric fold
  (``inference/metrics.py``), so a validation pass replays one graph per
  batch and pulls a few sums at its end. It is PyTorch's counterpart of
  the JAX package's per-shape compiled executable: the host queues one
  graph launch where the eager forward queues every kernel.
- **bounded dispatch** (:class:`DispatchThrottle`): a ring of CUDA
  events caps the forwards in flight (2 on the card, 1 on the CPU).
- **drain** (:class:`AsyncDrain`): submissions need whole flow fields;
  each is copied to pinned host memory behind the dispatch, and a worker
  thread hands it to a callback once its event has completed.

The JAX package's mesh, cost ledger and telemetry arguments are not
ported.
"""

from __future__ import annotations

import queue
import sys
import threading
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from raft_ncup_tpu_torch.inference import metrics as metrics_mod
from raft_ncup_tpu_torch.ops.corr_cuda import lookup_levels
from raft_ncup_tpu_torch.ops.nconv_cuda import nconv2d_fused
from raft_ncup_tpu_torch.precision import resolve_policy
from raft_ncup_tpu_torch.utils.device import cudnn_autotune


class SamplePrefetcher:
    """Decode ``dataset.sample(0..n-1)`` ahead of use, in order.

    A decode error re-raises from ``next()`` (after closing the pool);
    ``close()`` cancels queued decodes and joins the pool, and runs on
    exhaustion and on leaving a ``with`` block."""

    def __init__(self, dataset, num_workers: int = 4, lookahead: int = 8):
        self._ds = dataset
        self._n = len(dataset)
        self._pool = ThreadPoolExecutor(max(1, num_workers), thread_name_prefix="eval-decode")
        self._futures: deque = deque()
        self._submitted = 0
        self._closed = False
        for _ in range(min(max(1, lookahead), self._n)):
            self._submit_next()

    def _submit_next(self) -> None:
        self._futures.append(self._pool.submit(self._ds.sample, self._submitted))
        self._submitted += 1

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        if self._closed or not self._futures:
            self.close()
            raise StopIteration
        fut = self._futures.popleft()
        try:
            sample = fut.result()
        except BaseException:
            self.close()
            raise
        if self._submitted < self._n:
            self._submit_next()
        return sample

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for fut in self._futures:
            fut.cancel()
        self._futures.clear()
        self._pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self) -> "SamplePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def uniform_batches(samples: Iterable[dict], batch_size: int) -> Iterator[list]:
    """Group an ordered sample stream into batches of one image shape: a
    short batch on a shape change and at the end."""
    pending: list = []
    shape = None
    for s in samples:
        if shape is not None and tuple(s["image1"].shape) != shape:
            if pending:
                yield pending
            pending = []
        shape = tuple(s["image1"].shape)
        pending.append(s)
        if len(pending) == batch_size:
            yield pending
            pending = []
    if pending:
        yield pending


_END = object()


class _Failed:
    def __init__(self, exc: BaseException):
        self.exc = exc


class EvalPipeline:
    """Decode, stage and copy to ``device``, all off the dispatch thread.

    ``stage_fn(group) -> (arrays, meta)`` turns a list of samples into a
    dict of host numpy arrays (stacked and padded) and a small host meta
    dict. A worker thread stages each batch and, on the card, copies it
    from pinned memory on a side stream and records an event; iterating
    yields ``(device_batch, meta)`` pairs in order, with the current
    stream made to wait on the batch's copy. At most ``depth`` batches
    wait staged. Decode and staging errors re-raise from ``next()``;
    ``close()`` (or leaving a ``with`` block) stops the worker and the
    decode pool, also mid-pass."""

    def __init__(self, dataset, stage_fn: Callable[[list], tuple], *, device,
                 batch_size: int = 1, depth: int = 2, num_workers: int = 4):
        self.device = torch.device(device)
        self._stage = stage_fn
        self._batch_size = batch_size
        self._sp = SamplePrefetcher(dataset, num_workers, max(2 * batch_size, num_workers))
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(target=self._worker, name="eval-stage", daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        try:
            side = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
            for group in uniform_batches(self._sp, self._batch_size):
                if self._stop.is_set():
                    return
                arrays, meta = self._stage(group)
                self._put((*self._transfer(arrays, side), meta))
            self._put(_END)
        except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
            self._put(_Failed(e))
        finally:
            self._sp.close()

    def _transfer(self, arrays: dict, side) -> tuple:
        tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}
        if side is None:
            return tensors, None
        with torch.cuda.device(self.device), torch.cuda.stream(side):
            moved = {k: t.pin_memory().to(self.device, non_blocking=True)
                     for k, t in tensors.items()}
            event = torch.cuda.Event()
            event.record(side)
        return moved, event

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[tuple]:
        return self

    def __next__(self) -> tuple:
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is _END:
            self.close()
            raise StopIteration
        if isinstance(item, _Failed):
            self.close()
            raise item.exc
        batch, event, meta = item
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in batch.values():
                t.record_stream(current)  # allocated on the side stream
        return batch, meta

    def close(self) -> None:
        self._done = True
        self._stop.set()
        while True:  # unblock a worker waiting to put
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join()
        self._sp.close()

    def __enter__(self) -> "EvalPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def default_inflight(device) -> int:
    """Forwards to keep in flight: 2 on the card, where one queued graph
    rides out the host's gap between dispatches; 1 on the CPU, where
    PyTorch runs each forward to its end anyway."""
    return 1 if torch.device(device).type == "cpu" else 2


class DispatchThrottle:
    """Bound the device work in flight in a dispatch loop: ``push(x)``
    records an event after the work that produced ``x`` and, once
    :func:`default_inflight` events are pending, waits for the oldest. On
    the CPU it waits for nothing."""

    def __init__(self):
        self._pending: deque = deque()

    def push(self, x: torch.Tensor) -> None:
        if x.device.type != "cuda":
            return
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(x.device))
        self._pending.append(event)
        while len(self._pending) >= default_inflight(x.device):
            self._pending.popleft().synchronize()

    def drain(self) -> None:
        while self._pending:
            self._pending.popleft().synchronize()


class AsyncDrain:
    """Device-to-host copies behind the dispatch, callbacks on a worker.

    ``submit(tensors, callback)`` queues a copy of one tensor (or a tuple)
    into pinned host memory on the current stream and records an event; a
    worker thread waits for the event and calls ``callback`` with the
    numpy array(s), in submission order. The queue bound (``depth``)
    bounds the pinned buffers in flight. A callback error re-raises from
    the next ``submit()`` or from ``close()``, which flushes the queue and
    joins the worker."""

    def __init__(self, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, name="eval-drain", daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._exc is not None:
                continue  # keep consuming so the producer never blocks
            host, event, single, callback = item
            try:
                if event is not None:
                    event.synchronize()
                arrays = tuple(t.numpy() for t in host)
                callback(arrays[0] if single else arrays)
            except BaseException as e:  # noqa: BLE001 - surfaced to the producer
                self._exc = e

    def _raise_pending(self) -> None:
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def submit(self, tensors, callback: Callable) -> None:
        self._raise_pending()
        single = isinstance(tensors, torch.Tensor)
        seq = (tensors,) if single else tuple(tensors)
        event = None
        if seq[0].device.type == "cuda":
            host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in seq)
            for h, t in zip(host, seq):
                h.copy_(t, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(seq[0].device))
        else:
            host = tuple(t.detach().clone() for t in seq)
        self._q.put((host, event, single, callback))

    def close(self) -> None:
        """Flush the queued work, stop the worker, re-raise its error."""
        if self._thread.is_alive():
            self._q.put(None)
            self._thread.join()
        self._raise_pending()

    def __enter__(self) -> "AsyncDrain":
        return self

    def __exit__(self, et, ev, tb) -> None:
        if et is not None:
            try:  # the body already failed: do not mask its error
                self.close()
            except Exception as e:
                print(f"AsyncDrain close after error: {e}", file=sys.stderr)
            return
        self.close()


# ---------------------------------------------------------------- the cache


def _launch_counts() -> tuple:
    """The kernel wrappers' launch counters (A in all and by feature
    dtype, B)."""
    return (lookup_levels.launches, dict(lookup_levels.launches_by_dtype),
            nconv2d_fused.launches)


def _set_launch_counts(counts: tuple) -> None:
    lookup_levels.launches, by_dtype, nconv2d_fused.launches = counts
    lookup_levels.launches_by_dtype.clear()
    lookup_levels.launches_by_dtype.update(by_dtype)


def _launch_delta(after: tuple, before: tuple) -> tuple:
    by_dtype = {k: n - before[1].get(k, 0) for k, n in after[1].items()
                if n != before[1].get(k, 0)}
    return after[0] - before[0], by_dtype, after[2] - before[2]


def _add_launches(delta: tuple) -> None:
    lookup_levels.launches += delta[0]
    by_dtype = lookup_levels.launches_by_dtype
    for k, n in delta[1].items():
        by_dtype[k] = by_dtype.get(k, 0) + n
    nconv2d_fused.launches += delta[2]


class _EagerEntry:
    """A CPU model's entry: the forward run as it is."""

    pool_bytes = 0

    def __init__(self, fn: Callable):
        self._fn = fn

    def __call__(self, *args):
        return self._fn(*args)


class _GraphEntry:
    """One captured CUDA graph of ``fn`` over static copies of ``args``.

    ``fn`` runs once eagerly on a side stream first (the kernels' libraries
    load, cuDNN's autotuner times its algorithms, the lookup's path
    counters are created), then once under capture, into the memory
    ``pool``. Both run under ``utils.device.cudnn_autotune``: cuDNN keeps
    the algorithm it timed for each convolution's shape, so the graph, and
    any later eager forward at that shape, runs it. Its heuristic would
    pick FFT algorithms for the flagship's f32 convolutions, which hold a
    workspace of gigabytes in the graph's pool.

    The kernel wrappers count their launches while ``fn`` is captured,
    though the capture launches nothing: those counts are taken back, and
    every replay adds them (``launches``). A call copies its arguments into
    the static inputs, replays the graph and returns copies of the static
    outputs, so a result outlives the next replay. A failed capture raises;
    nothing falls back to the eager forward."""

    def __init__(self, key, fn: Callable, args: tuple, pool):
        device = args[0].device
        # Contiguous whatever the first call's strides: cuDNN picks its
        # algorithms by the layout too, so every key computes one way.
        self.static_in = tuple(a.clone(memory_format=torch.contiguous_format) for a in args)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with cudnn_autotune():
            with torch.cuda.stream(side):
                fn(*self.static_in)
            torch.cuda.current_stream(device).wait_stream(side)
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(device)
            before = _launch_counts()
            self.graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
                    out = fn(*self.static_in)
            except Exception as e:
                raise RuntimeError(f"CUDA graph capture of {key} failed: {e!r}") from e
            finally:
                after = _launch_counts()
                _set_launch_counts(before)
        self.static_out = out if isinstance(out, tuple) else (out,)
        self._single = not isinstance(out, tuple)
        self.launches = _launch_delta(after, before)
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved

    def __call__(self, *args):
        for dst, src in zip(self.static_in, args):
            dst.copy_(src, non_blocking=True)
        self.graph.replay()
        _add_launches(self.launches)
        outs = tuple(t.clone() for t in self.static_out)
        return outs[0] if self._single else outs


class ShapeCachedForward:
    """A bounded LRU of the test-mode forward per key: (padded shape and
    batch, iterations, warm start, metric kind and pad, precision preset),
    the JAX package's key without its mesh.

    On a CUDA model an entry is a captured CUDA graph (:class:`_GraphEntry`);
    on a CPU model it is the eager forward, which is the tests' path and
    the one the caller asked for. Either way a new key counts a capture in
    ``stats["compiles"]`` (the JAX name), a known key a hit, and a key
    pushed out of the LRU an eviction, so keys, LRU and stats behave alike
    on both devices. ``pool_bytes`` maps each cached key to the device
    memory its capture added to the pool.

    The graphs of one cache share one memory pool, so the cache holds
    about one forward's intermediates, not one per entry. That is safe
    because replays run one at a time in the order of one stream, a
    graph's static inputs live outside the pool, and a replay's outputs are
    copied out right after it, before another graph may reuse their memory
    for its intermediates.

    A graph holds the addresses of the model's parameters: a weight load
    after capture must copy in place (``load_state_dict`` without
    ``assign``), or call :meth:`clear`.

    ``policy`` (a preset name; default the model's own) names the preset
    the forwards run under; ``forward`` and ``metrics`` take a per-call
    override. Another preset runs the model's parameters through
    ``RAFT.with_policy``."""

    def __init__(self, model, cache_size: int = 8, policy=None):
        self.model = model
        self.device = model.device
        self.policy = resolve_policy(policy) if policy is not None else model.policy
        self.cache_size = max(1, int(cache_size))
        self._entries: OrderedDict = OrderedDict()
        self._models: dict = {}
        self._pool = None  # the graphs' shared memory pool, made at the first capture
        self.stats = {"compiles": 0, "hits": 0, "evictions": 0}

    @property
    def pool_bytes(self) -> dict:
        return {key: entry.pool_bytes for key, entry in self._entries.items()}

    def model_for(self, policy=None):
        """``(model, policy)`` of one call: the model under the requested
        preset (itself for its own), memoized."""
        pol = resolve_policy(policy) if policy is not None else self.policy
        model = self._models.get(pol.name)
        if model is None:
            model = self._models[pol.name] = self.model.with_policy(pol)
        return model, pol

    def clear(self) -> None:
        """Drop every entry, its graph and the pool."""
        self._entries.clear()
        self._pool = None

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device, dtype)

    def _run(self, key: tuple, fn: Callable, args: tuple):
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
            self.stats["hits"] += 1
            return entry(*args)
        if self.device.type == "cuda":
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            entry = _GraphEntry(key, fn, args, self._pool)
        else:
            entry = _EagerEntry(fn)
        self._entries[key] = entry
        self.stats["compiles"] += 1
        if len(self._entries) > self.cache_size:
            evicted, _ = self._entries.popitem(last=False)
            self.stats["evictions"] += 1
            print(f"ShapeCachedForward: evicting {evicted} (LRU bound {self.cache_size}); "
                  "recurring evictions re-pay captures: raise eval_cache_size or bucket "
                  "the pads (eval_pad_bucket)", file=sys.stderr)
        return entry(*args)

    def forward(self, image1, image2, iters: int, flow_init=None, policy=None):
        """Test-mode forward of (B, H, W, 3) images (padded to a stride of
        8; numpy or tensors): ``(flow_lr, flow_up)`` on the model's
        device."""
        model, pol = self.model_for(policy)
        args = (self._tensor(image1), self._tensor(image2))
        if flow_init is not None:
            args += (self._tensor(flow_init),)
        key = (tuple(args[0].shape), int(iters), flow_init is not None, pol.name)

        def fn(i1, i2, finit=None):
            return model(i1, i2, iters=iters, flow_init=finit)

        return self._run(key, fn, args)

    def metrics(self, batch: dict, *, iters: int, acc, kind: str, pad=None,
                flow_init=None, policy=None):
        """The forward and the metric fold in one entry. ``batch`` holds
        ``image1``/``image2`` (padded) and ``flow`` with optional
        ``valid``/``band`` at the native shape; ``pad`` is the static
        ``InputPadder.pad_spec``. Returns the updated accumulator, or
        ``(acc, flow_lr)`` with a ``flow_init`` (warm-start validation
        carries the low-res flow to the next frame)."""
        model, pol = self.model_for(policy)
        names = tuple(k for k in ("flow", "valid", "band") if k in batch)
        args = (self._tensor(batch["image1"]), self._tensor(batch["image2"]),
                *(self._tensor(batch[k]) for k in names), self._tensor(acc))
        warm = flow_init is not None
        if warm:
            args += (self._tensor(flow_init),)
        key = ("metrics", tuple(args[0].shape), tuple(args[2].shape), names, int(iters),
               kind, pad, warm, pol.name)

        def fn(i1, i2, *rest):
            extra = dict(zip(names, rest))
            acc_in = rest[len(names)]
            finit = rest[len(names) + 1] if warm else None
            flow_lr, flow_up = model(i1, i2, iters=iters, flow_init=finit)
            acc_out = metrics_mod.accumulate(
                kind, acc_in, flow_up, extra["flow"], valid=extra.get("valid"),
                band=extra.get("band"), pad=pad)
            return (acc_out, flow_lr) if warm else acc_out

        return self._run(key, fn, args)
