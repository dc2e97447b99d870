"""Copy batches to the card ahead of compute (port of
``raft_ncup_tpu/data/device_prefetch.py``).

:class:`DevicePrefetcher` wraps an iterator of host batches (the
loader's dicts of numpy arrays). One worker thread pulls each batch,
copies its arrays into pinned host buffers, issues non-blocking copies to
the card on a side stream and records an event after them; up to
``depth`` batches wait in a bounded queue. ``next()`` makes the consumer's
current stream wait on that event, so no kernel reads a batch before its
copy lands, and calls ``record_stream`` on each tensor, so the caching
allocator does not hand a batch's memory to another tensor while work of
the consumer's stream may still read it. The pinned buffers come from
PyTorch's caching host allocator, which keeps each one until its copy
has completed.

Contracts, as in the JAX package:

- order: one worker and one FIFO queue, so batches come out in the
  wrapped iterator's order, their contents untouched (``drop_keys``
  removed);
- exceptions: an error in the worker (one the wrapped iterator raised
  included) re-raises from the consumer's ``next()``;
- shutdown: ``close()`` (or leaving a ``with`` block) stops the worker
  even while it waits on a full queue, joins it and closes the wrapped
  iterator; it may be called more than once.

On a CPU device the batches are handed through as they are: each array
becomes a tensor that shares its memory (``torch.from_numpy``), with no
copy. ``waits`` and ``wait_ms`` count how often, and how long, ``next()``
found no batch ready. Inside ``with prefetcher.paused():`` the worker makes
no CUDA call (it finishes the copy it is issuing first): a CUDA graph
captured meanwhile on another thread, as validation captures one, must
not see another thread allocate.
"""

from __future__ import annotations

import contextlib
import queue
import sys
import threading
import time
from typing import Any, Iterable, Iterator, Mapping

import numpy as np
import torch

# Queue sentinel: the wrapped iterator is exhausted.
_END = object()


def _as_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))


class DevicePrefetcher:
    """Yield the batches of ``batches`` on ``device``, ``depth`` ahead of
    the consumer."""

    def __init__(
        self,
        batches: Iterable[Mapping[str, Any]],
        *,
        depth: int = 2,
        device=None,
        drop_keys: tuple[str, ...] = ("extra_info",),
    ):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.device = torch.device("cuda" if device is None else device)
        self._it = iter(batches)
        self._drop_keys = frozenset(drop_keys or ())
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._stop = threading.Event()
        self._cuda_lock = threading.Lock()
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self.waits = 0
        self.wait_ms = 0.0
        self._thread = threading.Thread(target=self._worker, name="device-prefetch",
                                        daemon=True)
        self._thread.start()

    # ---------------------------------------------------------- worker side

    def _transfer(self, batch: Mapping[str, Any]):
        host = {k: _as_tensor(v) for k, v in batch.items() if k not in self._drop_keys}
        if not self._cuda:
            return host, None
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            out = {}
            for k, t in host.items():
                pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                pinned.copy_(t)
                out[k] = pinned.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def _put(self, item) -> bool:
        """A bounded put that keeps checking for shutdown: a consumer that
        stopped pulling must not strand the worker on a full queue."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self) -> None:
        try:
            while not self._stop.is_set():
                try:
                    batch = next(self._it)
                except StopIteration:
                    self._put(_END)
                    return
                with self._cuda_lock:
                    item = self._transfer(batch)
                if not self._put(item):
                    return
        except BaseException as e:  # noqa: BLE001 - the consumer re-raises it
            self._put(e)
        finally:
            # The worker is the only thread that runs the wrapped generator,
            # and it is suspended here, so closing it is always legal.
            close = getattr(self._it, "close", None)
            if close is not None:
                try:
                    close()
                except Exception as e:
                    print(f"device-prefetch: closing the wrapped iterator failed: {e}",
                          file=sys.stderr)

    # -------------------------------------------------------- consumer side

    def __iter__(self) -> Iterator[dict]:
        return self

    def _get(self):
        try:
            return self._q.get_nowait()
        except queue.Empty:
            pass
        self.waits += 1
        t0 = time.perf_counter()
        try:
            while True:
                if self._stop.is_set():
                    return _END
                try:
                    return self._q.get(timeout=0.5)
                except queue.Empty:
                    if not self._thread.is_alive():
                        raise RuntimeError("device-prefetch worker died without delivering "
                                           "a batch or an exception") from None
        finally:
            self.wait_ms += 1e3 * (time.perf_counter() - t0)

    def __next__(self) -> dict:
        if self._stop.is_set():
            raise StopIteration
        item = self._get()
        if item is _END:
            self._stop.set()  # exhausted: later calls stay StopIteration
            raise StopIteration
        if isinstance(item, BaseException):
            self.close()
            raise item
        batch, done = item
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in batch.values():
                t.record_stream(stream)
        return batch

    @contextlib.contextmanager
    def paused(self):
        """No CUDA call from the worker while inside."""
        with self._cuda_lock:
            yield

    def close(self) -> None:
        """Stop the worker, join it, close the wrapped iterator."""
        self._stop.set()
        # Drain, so a worker waiting on a full queue sees the stop flag at
        # its next put.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10.0)

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
