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
  precision preset, early-exit tolerance), in an LRU of ``cache_size``
  entries, beside the entries a caller builds (``custom``: the stream
  engine's step). A graph holds
  the test-mode forward and, for validation, the metric fold
  (``inference/metrics.py``), so a validation pass replays one graph per
  batch and pulls a few sums at its end. It is PyTorch's counterpart of
  the JAX package's per-shape compiled executable: the host queues one
  graph launch where the eager forward queues every kernel.
- **bounded dispatch** (:class:`DispatchThrottle`): a ring of CUDA
  events caps the forwards in flight (``inflight``; by default 2 on the
  card, 1 on the CPU). The server and the stream engine use it as
  evaluation does.
- **drain** (:class:`AsyncDrain`): each result is copied to pinned host
  memory behind the dispatch, and a worker thread reads it with the
  runtime guards' sanctioned ``host_read`` once its event has completed
  and hands it to a callback.
- **staging** (:func:`stage_frames`, :func:`stage_pinned`): a batch's
  frames are written straight into pinned host memory, so every copy to
  the card is non-blocking (a blocking copy from pageable memory waits
  for the card).

**Early exit** (``forward(..., early_exit_tol=...)``): JAX's batch exit is
a ``lax.while_loop`` whose condition stays on the device, and a captured
CUDA graph cannot stop early. The early-exit entry is three graphs over
one set of carry buffers that live outside the graphs' pool: the encode
(with the pair's prepared correlation pyramid), one segment of
``segment_length(iters)`` iterations that freezes and detects per
iteration, and the finalize. The host replays the segment until every
row has converged or the level is reached, reading one flag byte after
each segment but the last: a synchronisation each (counted in
``earlyexit``). The flow and each row's executed iterations equal the
monolithic early exit's, since a frozen row neither moves nor pays; a
fully converged batch wastes at most ``segment - 1`` iterations. The
knobs ``RAFT_TORCH_EARLYEXIT`` and ``RAFT_TORCH_EARLYEXIT_TOL`` are read
by :func:`env_earlyexit_tol`, which ``FlowServer`` calls once.

**Telemetry and the cost ledger** (``telemetry=`` and ``cost_ledger=``,
the process defaults when not given): the cache's hits, captures and
evictions land as the JAX package's canonical counters
(``LEGACY_KEY_ALIASES["inference"]``), and a capture or an eviction as a
ring event carrying the key. Every new key's counted run
(:func:`_capture`'s eager run on the card, the eager entry's first call on
the CPU) records its cost in the ledger (``inference/costs.py``) under the
cache's key; an early-exit entry records its three graphs.

**The mesh** (``mesh=``, ``parallel.mesh.make_mesh``): every key starts
with its fingerprint (``mesh_fingerprint``, JAX's), so a sharded and an
unsharded entry of one shape never collide. With a spatial axis above 1
the forward is split by rows over this rank's spatial group, the spatial
ranks of its data and pipe index (``RAFT.forward(..., mesh=...)``,
``parallel/halo.py``): every rank of the group passes the same whole
frames and gets the same whole flow; the early-exit entry runs its three
stages on the rank's band, its flag summed over that group and so the
same on every rank. Under a mesh with a data or spatial axis above 1
every entry runs eagerly, not as a CUDA graph: its halo exchanges and
gathers (and a stream step's gather over the data axis) are collectives
between processes, which a graph would have to capture (NCCL
point-to-point capture: open, ROADMAP.md's held list). A pipe axis adds
no collective inside an entry (the pipelined forward's hand-offs sit
between its stage programs, ``inference/pipe_schedule.py``), so under a
mesh ``(1, 1, P)`` the entries are CUDA graphs. Under gloo each one is a
``guards.collective_read``, a sanctioned read, so a guarded window around
a sharded forward counts no implicit transfer. The callers split the data
axis: evaluation shards the frames across the data indices
(``evaluation._HostShard``), the server and the stream engine a batch's
rows (``parallel/lockstep.py``).
"""

from __future__ import annotations

import math
import queue
import sys
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from raft_ncup_tpu_torch.analysis.guards import (
    flag_read,
    host_read,
    mark_host_thread,
    note_compile,
    stage_out,
)
from raft_ncup_tpu_torch.inference import metrics as metrics_mod
from raft_ncup_tpu_torch.inference.costs import counting_flops, get_cost_ledger
from raft_ncup_tpu_torch.observability import get_telemetry
from raft_ncup_tpu_torch.observability.telemetry import LEGACY_KEY_ALIASES
from raft_ncup_tpu_torch.ops.corr_cuda import lookup_levels
from raft_ncup_tpu_torch.ops.nconv_cuda import nconv2d_fused
from raft_ncup_tpu_torch.parallel import halo
from raft_ncup_tpu_torch.parallel.mesh import mesh_fingerprint, pad_divisor, spatial_group
from raft_ncup_tpu_torch.precision import resolve_policy
from raft_ncup_tpu_torch.utils.device import cudnn_autotune, f32_precision
from raft_ncup_tpu_torch.utils.knobs import knob_raw

_EXEC_CANON = LEGACY_KEY_ALIASES["inference"]

# Iterations per replayed segment of the early-exit forward: it divides
# every default level (the server's 24, 16 and 8, the stream's 12). A level
# it does not divide replays segments of ``gcd(level, 4)``.
EARLYEXIT_SEGMENT = 4
# Images are staged, and enter every preset's forward, as f32: the model
# normalizes them in f32 and casts to PrecisionPolicy.compute inside.
IMAGE_DTYPE = torch.float32


def segment_length(iters: int) -> int:
    """Iterations per segment graph of an early-exit forward of ``iters``."""
    return math.gcd(int(iters), EARLYEXIT_SEGMENT)


def env_earlyexit_tol() -> Optional[float]:
    """The early-exit knobs as a tolerance, or None when detection is off:
    ``RAFT_TORCH_EARLYEXIT=1`` turns it on (default off) and
    ``RAFT_TORCH_EARLYEXIT_TOL`` sets the tolerance in low-res pixels
    (default 0.05), the JAX package's ``RAFT_NCUP_EARLYEXIT`` and
    ``RAFT_NCUP_EARLYEXIT_TOL`` under the port's prefix. The model and the
    cache take the tolerance as an argument and never read the
    environment."""
    if knob_raw("RAFT_TORCH_EARLYEXIT") != "1":
        return None
    return float(knob_raw("RAFT_TORCH_EARLYEXIT_TOL"))


class SamplePrefetcher:
    """Decode ``dataset.sample(0..n-1)`` ahead of use, in order.

    A decode error re-raises from ``next()`` (after closing the pool);
    ``close()`` cancels queued decodes and joins the pool, and runs on
    exhaustion and on leaving a ``with`` block."""

    def __init__(self, dataset, num_workers: int = 4, lookahead: int = 8):
        self._ds = dataset
        self._n = len(dataset)
        self._pool = ThreadPoolExecutor(max(1, num_workers), thread_name_prefix="eval-decode",
                                        initializer=mark_host_thread)
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
        mark_host_thread()  # host data only: the guards do not count its reads
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
    """Bound the device work in flight in a dispatch loop (the JAX
    package's bound): ``push(x)`` records an event after the work that
    produced ``x`` and, once ``inflight`` events are pending, waits for the
    oldest, so at most ``inflight`` batches are ever in flight and
    ``inflight - 1`` stay queued between pushes (``inflight=1``: every push
    waits for its own work). ``None`` means :func:`default_inflight` of the
    pushed tensor's device. The wait is an event's, which the guards'
    native layer allows: no value reaches the host. On the CPU it waits for
    nothing."""

    def __init__(self, inflight: Optional[int] = None):
        self.inflight = inflight
        self._pending: deque = deque()

    def push(self, x: torch.Tensor) -> None:
        if x.device.type != "cuda":
            return
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(x.device))
        self._pending.append(event)
        bound = self.inflight if self.inflight is not None else default_inflight(x.device)
        while len(self._pending) >= max(1, bound):
            self._pending.popleft().synchronize()

    def drain(self) -> None:
        while self._pending:
            self._pending.popleft().synchronize()


class AsyncDrain:
    """Device-to-host copies behind the dispatch, callbacks on a worker.

    ``submit(tensors, callback)`` queues a copy of one tensor (or a tuple)
    into pinned host memory on the current stream and records an event
    (``guards.stage_out``); a worker thread reads them with the sanctioned
    ``guards.host_read`` (one per submission, waiting on the event) and
    calls ``callback`` with the numpy array(s), in submission order. The
    queue bound (``depth``) bounds the pinned buffers in flight.

    A failed submission (its read or its callback) goes to its own
    ``on_error(exc)`` on the worker when one was given, and the worker
    goes on with the next: the server and the stream engine answer that
    batch with ``error`` at once. Without ``on_error`` (the JAX package's
    contract) the error re-raises from the next ``submit()`` or from
    ``close()``, and later submissions are skipped. ``close()`` flushes
    the queue and joins the worker."""

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
            host, event, callback, on_error = item
            if self._exc is not None and on_error is None:
                continue  # keep consuming so the producer never blocks
            try:
                callback(host_read(host, ready=event))
            except BaseException as e:  # noqa: BLE001 - handed on or surfaced
                if on_error is None:
                    self._exc = e
                    continue
                try:
                    on_error(e)
                except BaseException as e2:  # noqa: BLE001 - surfaced to the producer
                    self._exc = e2

    def _raise_pending(self) -> None:
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def submit(self, tensors, callback: Callable,
               on_error: Optional[Callable] = None) -> None:
        self._raise_pending()
        tree = tensors if isinstance(tensors, torch.Tensor) else tuple(tensors)
        self._q.put((*stage_out(tree), callback, on_error))

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


def stage_pinned(x, dtype=IMAGE_DTYPE, device="cuda") -> torch.Tensor:
    """``x`` (numpy or a host tensor) as a new host tensor of ``dtype``, in
    pinned memory when ``device`` is a card, ready for a non-blocking copy
    to it. The caching host allocator keeps a pinned buffer until every
    copy queued from it has run, so a fresh buffer a batch needs no event
    of its own."""
    src = torch.as_tensor(x)
    out = torch.empty(src.shape, dtype=dtype,
                      pin_memory=torch.device(device).type == "cuda")
    out.copy_(src)
    return out


def stage_frames(images: list, pad_specs: list, n_rows: int, shape_hw: tuple,
                 device) -> torch.Tensor:
    """One dispatch batch on the host: each (H, W, 3) frame of ``images``
    edge-padded by its ``InputPadder.pad_spec`` to ``shape_hw`` (as
    ``np.pad(mode="edge")``: rows first, then columns, corners from the
    corner pixel) and written at float32 straight into one (n_rows, H, W,
    3) tensor, zero rows after the frames. For a card ``device`` the tensor
    lies in pinned memory (a fresh buffer: :func:`stage_pinned`), so the
    entry's copy to the card queues without a wait."""
    ph, pw = shape_hw
    out = torch.empty((n_rows, ph, pw, 3), dtype=IMAGE_DTYPE,
                      pin_memory=torch.device(device).type == "cuda")
    for row, img, ((t, b), (le, r)) in zip(out, images, pad_specs):
        h, w = ph - t - b, pw - le - r
        row[t: t + h, le: le + w].copy_(torch.from_numpy(np.ascontiguousarray(img)))
        if t:
            row[:t, le: le + w].copy_(row[t: t + 1, le: le + w].expand(t, w, 3))
        if b:
            row[t + h:, le: le + w].copy_(row[t + h - 1: t + h, le: le + w].expand(b, w, 3))
        if le:
            row[:, :le].copy_(row[:, le: le + 1].expand(ph, le, 3))
        if r:
            row[:, le + w:].copy_(row[:, le + w - 1: le + w].expand(ph, r, 3))
    out[len(images):].zero_()
    return out


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
    """A CPU model's entry: the forward run as it is. Its first call is
    counted and handed to ``record(flops, ms, pool bytes)`` (the cost
    ledger's entry)."""

    pool_bytes = 0

    def __init__(self, fn: Callable, record: Callable):
        self._fn = fn
        self._record = record

    def __call__(self, *args):
        if self._record is None:
            return self._fn(*args)
        record, self._record = self._record, None
        t0 = time.perf_counter()
        with counting_flops() as flops:
            out = self._fn(*args)
        record(flops, 1e3 * (time.perf_counter() - t0), 0)
        return out


def _static_inputs(args: tuple, device) -> tuple:
    """Contiguous copies on ``device`` of a first call's arguments (on the
    card, or staged in pinned host memory): an entry's static inputs, which
    every later call copies its arguments into. Contiguous whatever the
    first call's strides: cuDNN picks its algorithms by the layout too, so
    every key computes one way."""
    out = tuple(torch.empty(a.shape, dtype=a.dtype, device=device) for a in args)
    for dst, src in zip(out, args):
        dst.copy_(src, non_blocking=True)
    return out


def _capture(key, fn: Callable, args: tuple, pool, device, record: Callable):
    """Run ``fn(*args)`` once eagerly on a side stream, then capture it
    into a CUDA graph in ``pool``, both under ``cudnn_autotune``. Returns
    ``(graph, outputs, launches, pool bytes added)``; the wrappers' launch
    counts moved by the capture are taken back (``launches`` is what each
    replay adds). A failed capture raises. The eager run, and only it, is
    counted (``inference.costs.counting_flops``), and ``record(flops, ms,
    pool bytes added)`` gets the count, the wall time of the whole build
    and the pool's growth (the cost ledger's entry)."""
    t0 = time.perf_counter()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with cudnn_autotune():
        with torch.cuda.stream(side), counting_flops() as flops:
            fn(*args)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                out = fn(*args)
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of {key} failed: {e!r}") from e
        finally:
            after = _launch_counts()
            _set_launch_counts(before)
    grown = torch.cuda.memory_reserved(device) - reserved
    record(flops, 1e3 * (time.perf_counter() - t0), grown)
    return graph, out, _launch_delta(after, before), grown


class _GraphEntry:
    """One captured CUDA graph of ``fn`` over static copies of ``args``.

    ``fn`` runs once eagerly on a side stream first (the kernels' libraries
    load, cuDNN's autotuner times its algorithms, the lookup's path
    counters are created), then once under capture, into the memory
    ``pool`` (:func:`_capture`). Both run under
    ``utils.device.cudnn_autotune``: cuDNN keeps the algorithm it timed for
    each convolution's shape, so the graph, and any later eager forward at
    that shape, runs it. Its heuristic would pick FFT algorithms for the
    flagship's f32 convolutions, which hold a workspace of gigabytes in the
    graph's pool.

    The kernel wrappers count their launches while ``fn`` is captured,
    though the capture launches nothing: those counts are taken back, and
    every replay adds them (``launches``). A call copies its arguments into
    the static inputs, replays the graph and returns copies of the static
    outputs, so a result outlives the next replay. A failed capture raises;
    nothing falls back to the eager forward. Tensors ``fn`` reaches other
    than through its arguments (the stream engine's slot table) are
    captured by address and updated in place.

    Arguments may lie on the card or in pinned host memory: a call's copies
    into the static inputs are non-blocking either way, so from pinned
    memory the host queues them and returns at once. The copies in, the
    replay and the clones out run in the order of the caller's stream, so
    replay n+1 cannot overwrite what replay n reads, nor its outputs before
    they are cloned."""

    def __init__(self, key, fn: Callable, args: tuple, pool, record: Callable, device):
        self.static_in = _static_inputs(args, device)
        self.graph, out, self.launches, self.pool_bytes = _capture(
            key, fn, self.static_in, pool, device, record)
        self.static_out = out if isinstance(out, tuple) else (out,)
        self._single = not isinstance(out, tuple)

    def __call__(self, *args):
        for dst, src in zip(self.static_in, args):
            dst.copy_(src, non_blocking=True)
        return self.replay()

    def replay(self):
        """Replay on what the static inputs hold now (a caller that writes
        them itself, as the pipe's hand-offs are received into them), and
        return copies of the static outputs."""
        self.graph.replay()
        _add_launches(self.launches)
        outs = tuple(t.clone() for t in self.static_out)
        return outs[0] if self._single else outs


class _EarlyExitEntry:
    """The early-exit forward of one key: ``(flow_lr, flow_up,
    exec_iters)``.

    Three stages work on one set of carry buffers: ``encode`` fills them
    (the GRU state, coordinates, context, the prepared correlation
    pyramid, an all-False ``converged`` and zero ``exec_iters``), each
    ``segment`` advances them in place by ``segment_length(iters)``
    iterations with per-iteration freeze and detection
    (``RAFT._advance``) and writes ``converged.all()`` into a flag byte,
    and ``finalize`` upsamples them. The host runs the segment until the
    flag is set or the level is reached. On the card each stage is a
    CUDA graph (:func:`_capture`) and the buffers, allocated before the
    captures and outside the pool, are read and written by address, so
    no graph's pool memory holds state another graph reads. On the CPU
    and under a data or spatial axis of processes the stages run eagerly;
    with a spatial ``group`` (``halo.SpatialGroup``) each runs on this
    rank's band under it, the encode taking the band of the whole frames
    and the finalize gathering the whole flows. ``counters`` gains each call's forwards,
    replayed segments and flag reads; ``last`` holds the latest call's.
    ``record(stage)`` returns the cost ledger's recorder of one stage: each
    stage's counted run is recorded under a key of its own."""

    def __init__(self, key, model, iters: int, tol: float, args: tuple, pool, counters: dict,
                 record: Callable, group=None):
        self.seg = segment_length(iters)
        self.n_seg = int(iters) // self.seg
        self.counters = counters
        self.last: dict = {}
        device = model.device
        self.static_in = _static_inputs(args, device)
        bufs: dict = {}
        self._bufs = bufs

        def encode(i1, i2, finit=None):
            carry = model.encode(halo.band(i1), halo.band(i2), flow_init=halo.band(finit),
                                 early_exit=True)
            vals = {k: carry[k] for k in ("net", "coords1", "inp", "converged", "exec_iters")}
            with torch.no_grad():
                vals["corr"] = model.corr_state(carry["fmap1"], carry["fmap2"])
            vals["done"] = carry["converged"].all()
            if not bufs:  # the first, eager run sizes the buffers
                bufs.update({k: tuple(torch.empty_like(t) for t in v) if k == "corr"
                             else torch.empty_like(v) for k, v in vals.items()})
            for k, v in vals.items():
                for dst, src in zip(*((bufs[k], v) if k == "corr" else ((bufs[k],), (v,)))):
                    dst.copy_(src)

        def segment():
            corr_fn = model.corr_fn_from(bufs["corr"])
            carry = {k: bufs[k] for k in ("net", "coords1", "inp", "converged", "exec_iters")}
            with torch.no_grad(), f32_precision():
                out = model._advance(carry, self.seg, corr_fn, tol)
            for k in ("net", "coords1", "converged", "exec_iters"):
                bufs[k].copy_(out[k])
            bufs["done"].copy_(out["converged"].all())

        def finalize():
            flows = model.finalize({"net": bufs["net"], "coords1": bufs["coords1"]})
            return (*(halo.all_gather_rows(t.contiguous(), dim=1) for t in flows),
                    bufs["exec_iters"])

        def banded(fn):
            def run(*a):
                with halo.spatial(group):
                    return fn(*a)
            return run

        stages = (("encode", banded(encode), self.static_in), ("segment", banded(segment), ()),
                  ("finalize", banded(finalize), ()))
        if pool is None:
            # Eager on the card (a data or spatial axis of processes): cuDNN's autotuner
            # picks the algorithms, as a capture's would.
            tune = cudnn_autotune() if device.type == "cuda" else (lambda fn: fn)
            self._encode, self._segment, self._finalize = (
                _EagerEntry(tune(fn), record(name)) for name, fn, _ in stages)
            self.pool_bytes = 0
            return
        graphs = []
        self.pool_bytes = 0
        for name, fn, fn_args in stages:
            graph, out, launches, grown = _capture((*key, name), fn, fn_args, pool, device,
                                                   record(name))
            graphs.append((graph, launches))
            self.pool_bytes += grown
            if name == "finalize":
                self.static_out = out

        def replayer(graph, launches):
            def replay(*_):
                graph.replay()
                _add_launches(launches)
            return replay

        self._encode, self._segment, self._finalize = (replayer(*g) for g in graphs)

    def __call__(self, *args):
        for dst, src in zip(self.static_in, args):
            dst.copy_(src, non_blocking=True)
        self._encode(*self.static_in)
        segments = syncs = 0
        for s in range(self.n_seg):
            self._segment()
            segments += 1
            if s + 1 == self.n_seg:
                break
            syncs += 1
            if flag_read(self._bufs["done"]):  # one byte to the host: a synchronisation
                break
        out = self._finalize()
        if out is None:
            out = self.static_out
        self.last = {"segments": segments, "syncs": syncs, "iters_run": segments * self.seg}
        self.counters["forwards"] += 1
        self.counters["segments"] += segments
        self.counters["syncs"] += syncs
        return tuple(t.clone() for t in out)


class ShapeCachedForward:
    """A bounded LRU of the test-mode forward per key: (mesh fingerprint,
    padded shape and batch, iterations, warm start, metric kind and pad,
    precision preset, early-exit tolerance), the JAX package's key, and of
    the entries callers build (:meth:`custom`).

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
    for its intermediates. On the card, host inputs (numpy or host tensors)
    are staged in pinned memory and copied non-blocking (:meth:`_tensor`):
    a blocking copy from pageable memory would wait for the card.

    A graph holds the addresses of the model's parameters: a weight load
    after capture must copy in place (``load_state_dict`` without
    ``assign``), or call :meth:`clear`.

    ``policy`` (a preset name; default the model's own) names the preset
    the forwards run under; ``forward`` and ``metrics`` take a per-call
    override. Another preset runs the model's parameters through
    ``RAFT.with_policy``.

    ``telemetry`` and ``cost_ledger`` default to the process's hub and
    ledger (see the module docstring)."""

    def __init__(self, model, cache_size: int = 8, policy=None, telemetry=None,
                 cost_ledger=None, mesh=None):
        self.model = model
        self.device = model.device
        self.mesh = mesh
        # Part of every key (see _get): a sharded and an unsharded entry of
        # one shape never collide.
        self.mesh_fp = mesh_fingerprint(mesh)
        # The ranks that split each forward by rows; images pad to a
        # multiple of 8 times it.
        self.spatial = mesh.spatial if mesh is not None else 1
        # Ranks that hold a collective inside an entry (data and spatial; a
        # pipe axis has none): their entries run eagerly.
        self.sharded = mesh is not None and mesh.data * mesh.spatial > 1
        self.pad_divisor = pad_divisor(mesh)
        self.policy = resolve_policy(policy) if policy is not None else model.policy
        self.cache_size = max(1, int(cache_size))
        self._entries: OrderedDict = OrderedDict()
        self._models: dict = {}
        self._pool = None  # the graphs' shared memory pool, made at the first capture
        self.stats = {"compiles": 0, "hits": 0, "evictions": 0}
        # Early-exit forwards, the segments they replayed and the flags
        # they read on the host (one synchronisation each), and the
        # latest forward's.
        self.earlyexit = {"forwards": 0, "segments": 0, "syncs": 0}
        self.last_earlyexit: dict = {}
        self._tel = telemetry if telemetry is not None else get_telemetry()
        self.costs = cost_ledger if cost_ledger is not None else get_cost_ledger()

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

    def _tensor(self, x, dtype=IMAGE_DTYPE) -> torch.Tensor:
        """``x`` as an entry argument: a tensor on the model's device; on
        the card a host input instead stays on the host, in pinned memory
        (already pinned at ``dtype``, as the server stages its batches, it
        is taken as it is), and the entry copies it in without a wait."""
        if self.device.type != "cuda":
            return torch.as_tensor(x).to(self.device, dtype)
        if isinstance(x, torch.Tensor) and x.device.type == "cuda":
            return x.to(self.device, dtype)
        if isinstance(x, torch.Tensor) and x.is_pinned() and x.dtype == dtype:
            return x
        return stage_pinned(x, dtype)

    def _pool_for_capture(self):
        """The graphs' shared pool on the card (made at the first capture),
        None on the CPU and under a mesh with a data or spatial axis above 1
        (eager entries)."""
        if self.device.type != "cuda" or self.sharded:
            return None
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def _get(self, key: tuple, build: Callable):
        """The entry of ``key``, built by ``build()`` on a miss; counts a
        capture, a hit or an eviction, in ``stats`` and in the telemetry
        registry. Hits are counters only: a ring event per replayed batch
        would crowd out the events the ring exists to keep. The key is
        stored behind the mesh fingerprint."""
        key = (self.mesh_fp,) + tuple(key)
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
            self.stats["hits"] += 1
            self._tel.inc(_EXEC_CANON["hits"])
            return entry
        note_compile("capture", str(key))
        entry = build()
        self._entries[key] = entry
        self.stats["compiles"] += 1
        self._tel.inc(_EXEC_CANON["compiles"])
        self._tel.event("inference_executable_compile", key=str(key))
        if len(self._entries) > self.cache_size:
            evicted, _ = self._entries.popitem(last=False)
            self.stats["evictions"] += 1
            self._tel.inc(_EXEC_CANON["evictions"])
            self._tel.event("inference_executable_evict", key=str(evicted))
            print(f"ShapeCachedForward: evicting {evicted} (LRU bound {self.cache_size}); "
                  "recurring evictions re-pay captures: raise eval_cache_size or bucket "
                  "the pads (eval_pad_bucket)", file=sys.stderr)
        return entry

    def _recorder(self, key: tuple) -> Callable:
        """The cost ledger's recorder of ``key``'s counted run:
        ``record(flops, ms, pool bytes)``."""
        ledger_key = (f"{self.device.type}|{key}" if self.mesh is None
                      else f"{self.device.type}|{self.mesh_fp}|{key}")
        meta = _ledger_meta(key)

        def record(flops: dict, ms: float, pool_bytes: int) -> None:
            self.costs.record(ledger_key, flops=flops, capture_ms=ms, pool_bytes=pool_bytes,
                              backend=self.device.type, **meta)

        return record

    def _graph_or_eager(self, key: tuple, fn: Callable, args: tuple):
        pool = self._pool_for_capture()
        record = self._recorder(key)
        if pool is None and self.device.type == "cuda":
            # An entry under a data or spatial axis of processes runs eagerly: its staged host
            # arguments go to the card first, and cuDNN's autotuner picks the
            # algorithms, as a capture's would.
            eager, device = cudnn_autotune()(fn), self.device

            def fn(*a):
                return eager(*(t.to(device, non_blocking=True) for t in a))
        return (_EagerEntry(fn, record) if pool is None
                else _GraphEntry(key, fn, args, pool, record, self.device))

    def _run(self, key: tuple, fn: Callable, args: tuple):
        return self._get(key, lambda: self._graph_or_eager(key, fn, args))(*args)

    def custom(self, key: tuple, build: Callable, args: tuple):
        """Run a caller's function through this cache: ``build()`` returns
        the function, called on ``args`` (tensors on the model's device or,
        on the card, staged in pinned host memory: :func:`stage_pinned`),
        captured as a CUDA graph on the card at the key's first use and
        replayed after, run eagerly on the CPU and under a data or spatial
        axis of processes. The key is namespaced as ``("custom", *key)``; the stream
        engine's step per batch size is one. Returns the function's
        result."""
        return self.entry(key, build, args)(*args)

    def entry(self, key: tuple, build: Callable, args: tuple):
        """The entry :meth:`custom` runs, without running it: built on
        ``args`` at the key's first use (counted as a capture), a hit after.
        A :class:`_GraphEntry` exposes its static inputs, which a caller may
        fill itself before :meth:`_GraphEntry.replay`."""
        full = ("custom",) + tuple(key)
        return self._get(full, lambda: self._graph_or_eager(full, build(), args))

    def forward(self, image1, image2, iters: int, flow_init=None, policy=None,
                early_exit_tol: Optional[float] = None):
        """Test-mode forward of (B, H, W, 3) images (padded to a stride of
        8; numpy or tensors): ``(flow_lr, flow_up)`` on the model's
        device. With ``early_exit_tol`` the key grows ``("earlyexit",
        tol)`` and the result is ``(flow_lr, flow_up, exec_iters)``
        (:class:`_EarlyExitEntry`)."""
        model, pol = self.model_for(policy)
        args = (self._tensor(image1), self._tensor(image2))
        if flow_init is not None:
            args += (self._tensor(flow_init),)
        key = (tuple(args[0].shape), int(iters), flow_init is not None, pol.name)
        if early_exit_tol is not None:
            key += (("earlyexit", float(early_exit_tol)),)

            def build():
                return _EarlyExitEntry(key, model, iters, float(early_exit_tol), args,
                                       self._pool_for_capture(), self.earlyexit,
                                       lambda stage: self._recorder((*key, stage)),
                                       spatial_group(self.mesh))

            entry = self._get(key, build)
            out = entry(*args)
            self.last_earlyexit = entry.last
            return out

        mesh = self.mesh

        def fn(i1, i2, finit=None):
            return model(i1, i2, iters=iters, flow_init=finit, mesh=mesh)

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
        mesh = self.mesh

        def fn(i1, i2, *rest):
            extra = dict(zip(names, rest))
            acc_in = rest[len(names)]
            finit = rest[len(names) + 1] if warm else None
            flow_lr, flow_up = model(i1, i2, iters=iters, flow_init=finit, mesh=mesh)
            acc_out = metrics_mod.accumulate(
                kind, acc_in, flow_up, extra["flow"], valid=extra.get("valid"),
                band=extra.get("band"), pad=pad)
            return (acc_out, flow_lr) if warm else acc_out

        return self._run(key, fn, args)


def _ledger_meta(key: tuple) -> dict:
    """The structured identity of a cache key for its ledger entry
    (``raft_ncup_tpu/inference/pipeline.py``'s ``_ledger_meta`` for the
    port's keys): kind, shape, iterations and preset, the early-exit
    tolerance and, for an early-exit graph, its stage."""
    if key and isinstance(key[0], tuple):
        # forward: (shape, iters, warm, policy[, ("earlyexit", tol)][, stage])
        meta = {"kind": "forward", "shape": key[0], "iters": key[1], "policy": key[3]}
        for part in key[4:]:
            if isinstance(part, tuple) and len(part) == 2 and part[0] == "earlyexit":
                meta["earlyexit_tol"] = part[1]
            elif isinstance(part, str):
                meta["stage"] = part
        return meta
    if key and key[0] == "metrics":
        # ("metrics", img_shape, flow_shape, extras, iters, kind, pad, warm, policy)
        return {"kind": "metrics", "shape": key[1], "iters": key[4], "policy": key[8]}
    if key and key[0] == "custom":
        # The pipelined forward's stage programs (inference/pipe_schedule.py)
        # carry JAX's structured identity: ("custom", "pipe_encode", shape,
        # policy) and ("custom", "pipe_segment" | "pipe_finalize", shape,
        # iters, segments, policy), each with an optional ("earlyexit", tol).
        meta = None
        if len(key) >= 6 and key[1] in ("pipe_segment", "pipe_finalize"):
            meta = {"kind": key[1], "shape": key[2], "iters": key[3], "segments": key[4],
                    "policy": key[5]}
        elif len(key) >= 4 and key[1] == "pipe_encode":
            meta = {"kind": "pipe_encode", "shape": key[2], "policy": key[3]}
        if meta is None:
            return {"kind": "custom", "name": key[1] if len(key) > 1 else None}
        for part in key[4:]:
            if isinstance(part, tuple) and len(part) == 2 and part[0] == "earlyexit":
                meta["earlyexit_tol"] = part[1]
        return meta
    return {}
