"""Threaded, sharded batch loader (port of ``raft_ncup_tpu/data/loader.py``).

The reference feeds training from a 4-worker PyTorch DataLoader
(reference: core/datasets.py:240-241). :class:`FlowLoader` is a plain
iterator instead: it yields dicts of stacked numpy arrays (one batch,
images uint8), decodes and augments in a thread pool (numpy and zlib
release the GIL on large arrays) and keeps a bounded queue of ready
batches. The sample indices are sharded over the processes of
``torch.distributed`` when it is initialized: each rank reads every
``world``-th index of an epoch's order, from its rank on, in batches of the
global batch over ``world`` (the train entry's ``--batch_size // world``),
and with ``drop_last`` every rank makes the same number of batches an epoch,
the one-process count of the global batch. So the ranks' batches at a step
are, together, the one-process batch of that step: rank ``r``'s row ``j`` is
its row ``j * world + r``.

Determinism: each sample's augmentation generator is
``np.random.default_rng(SeedSequence([seed, epoch, index]))``,
independent of the workers' scheduling and stable across restarts, so
``batches(start_epoch, start_batch)`` resumes the exact stream of an
uninterrupted run without loading the batches it skips.
"""

from __future__ import annotations

import queue
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

from raft_ncup_tpu_torch.analysis.guards import mark_host_thread
from raft_ncup_tpu_torch.resilience.retry import RetryStats, retry_io


def _default_shard() -> tuple[int, int]:
    """This process's rank and the world size when ``torch.distributed``
    is initialized, else 0 of 1."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _stack_batch(samples: list[dict]) -> dict:
    # Native dtypes: images stay uint8 (a quarter of float32's host memory
    # and copy to the card; the model casts on the card), flow and valid
    # float32. CPU tensors (the procedural pairs) stack as arrays too.
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if key == "extra_info":
            out[key] = vals
        else:
            out[key] = np.stack([np.asarray(v) for v in vals])
            if out[key].dtype not in (np.uint8, np.float32):
                out[key] = out[key].astype(np.float32)
    return out


class FlowLoader:
    """Iterate shuffled, augmented, sharded batches forever.

    ``shard_index``/``num_shards`` default to this process's rank and the
    world size of ``torch.distributed`` when it is initialized (0 of 1
    otherwise), so each process reads a disjoint slice of every epoch.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 1234,
        num_workers: int = 4,
        prefetch: int = 2,
        shard_index: Optional[int] = None,
        num_shards: Optional[int] = None,
        io_retries: int = 3,
        io_retry_backoff_s: float = 0.05,
    ):
        if shard_index is None or num_shards is None:
            shard_index, num_shards = _default_shard()
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        # 0 means "no parallelism" (torch DataLoader semantics); the
        # thread-pool producer still needs one worker thread.
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.shard_index = shard_index
        self.num_shards = num_shards
        # Reads retry with bounded backoff (resilience/retry.py); samples
        # that keep failing are quarantined for the rest of the run and
        # substituted, so batches keep their shape. `retry_stats` is the
        # run's accounting (log.txt).
        self.io_retries = io_retries
        self.io_retry_backoff_s = io_retry_backoff_s
        self.retry_stats = RetryStats()
        # Guarded by _io_lock: pool workers fail concurrently, and the
        # check-then-quarantine must not double-quarantine an index.
        self._quarantined: set = set()
        self._io_lock = threading.Lock()
        # Host seconds spent reading and augmenting samples, and how many.
        self.read_seconds = 0.0
        self.samples_read = 0
        if len(self) == 0:
            raise ValueError(
                f"dataset of {len(dataset)} samples yields zero batches for "
                f"shard {shard_index}/{num_shards} at batch_size={batch_size}"
                f" (drop_last={drop_last}) — check the dataset roots"
            )

    def _shard_size(self) -> int:
        return len(
            range(self.shard_index, len(self.dataset), self.num_shards)
        )

    def __len__(self) -> int:
        if self.drop_last:
            # The global batch's count, the same on every shard.
            return len(self.dataset) // (self.batch_size * self.num_shards)
        n = self._shard_size()
        return (n + self.batch_size - 1) // self.batch_size

    def _limit(self, idx: np.ndarray) -> int:
        """How many of an epoch shard's indices make batches."""
        return len(self) * self.batch_size if self.drop_last else len(idx)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch])
            ).permutation(n)
        else:
            order = np.arange(n)
        return order[self.shard_index :: self.num_shards]

    def _read_sample(self, epoch: int, index: int) -> dict:
        """One retried dataset read. The augmentation generator is rebuilt
        from (seed, epoch, index) inside every attempt: a read that drew
        from it before failing would otherwise hand its retry an advanced
        generator, and the batch would no longer depend on (seed, epoch,
        index) alone, nor a resumed run equal an uninterrupted one."""

        def attempt() -> dict:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch, index])
            )
            t0 = time.perf_counter()
            sample = self.dataset.sample(index, rng)
            with self._io_lock:
                self.read_seconds += time.perf_counter() - t0
                self.samples_read += 1
            return sample

        return retry_io(
            attempt,
            attempts=self.io_retries,
            base_delay_s=self.io_retry_backoff_s,
            stats=self.retry_stats,
            desc=f"dataset read index={index}",
            log=self._log_retry,
        )

    def _quarantine(self, index: int, why: str) -> None:
        with self._io_lock:
            already = index in self._quarantined
            self._quarantined.add(index)
        if not already:
            self.retry_stats.quarantine(index)
            self._log_retry(f"dataset read index={index} {why}; quarantined")

    def _load_one(self, epoch: int, index: int) -> dict:
        index = int(index)
        with self._io_lock:
            quarantined = index in self._quarantined
        if quarantined:
            return self._substitute(epoch, index)
        try:
            return self._read_sample(epoch, index)
        except OSError as e:
            # The read failed through every retry: quarantine the index
            # (not read again this run) and substitute a neighbour, so the
            # batch keeps its shape; retry_stats accounts it.
            self._quarantine(index, f"failed permanently ({e})")
            return self._substitute(epoch, index)

    def _substitute(self, epoch: int, index: int) -> dict:
        """The stand-in for a quarantined sample: the next index of this
        process's epoch shard that is not quarantined (wrapping, in shard
        order), never an index another process serves. It is read through
        the same retry and quarantine policy with its own (seed, epoch,
        sub) generator. When every index of the shard is quarantined the
        data source is gone, not flaky: that raises."""
        shard = self._epoch_indices(epoch)
        hits = np.nonzero(shard == index)[0]
        pos = int(hits[0]) if len(hits) else 0
        for off in range(1, len(shard)):
            sub = int(shard[(pos + off) % len(shard)])
            with self._io_lock:
                quarantined = sub in self._quarantined
            if quarantined:
                continue
            try:
                return self._read_sample(epoch, sub)
            except OSError as e:
                self._quarantine(sub, f"failed permanently ({e})")
        raise RuntimeError(
            f"all {len(self._quarantined)} reachable shard samples are "
            "quarantined after exhausting IO retries — the data source "
            "is unavailable, not flaky "
            f"({self.retry_stats.summary()})"
        )

    @staticmethod
    def _log_retry(msg: str) -> None:
        # stderr: the trainer's stdout ends in its JSON summary line.
        print(f"FlowLoader {msg}", file=sys.stderr)

    def batches(
        self, start_epoch: int = 0, start_batch: int = 0
    ) -> Iterator[dict]:
        """Infinite stream of batches, epoch after epoch.

        ``start_batch`` skips the first k batches of the start epoch
        without loading them — the loader is deterministic per
        (seed, epoch, index), so resuming at (epoch, batch) reproduces the
        exact stream an uninterrupted run would have seen."""
        stop = threading.Event()
        out: queue.Queue = queue.Queue(maxsize=max(1, self.prefetch))

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    out.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            mark_host_thread()  # host data only: the guards do not count its reads
            try:
                with ThreadPoolExecutor(self.num_workers, initializer=mark_host_thread) as pool:
                    epoch = start_epoch
                    skip = start_batch * self.batch_size
                    while not stop.is_set():
                        idx = self._epoch_indices(epoch)
                        limit = self._limit(idx)
                        first = min(skip, limit)
                        skip = 0
                        for s in range(first, limit, self.batch_size):
                            chunk = idx[s : s + self.batch_size]
                            samples = list(
                                pool.map(
                                    lambda i: self._load_one(epoch, i), chunk
                                )
                            )
                            if not _put(_stack_batch(samples)):
                                return
                        epoch += 1
            except BaseException as e:  # the consumer re-raises it
                _put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out.get()
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

    def one_epoch(self, epoch: int = 0) -> Iterator[dict]:
        """A single pass over this process's shard."""
        idx = self._epoch_indices(epoch)
        limit = self._limit(idx)
        with ThreadPoolExecutor(self.num_workers) as pool:
            for s in range(0, limit, self.batch_size):
                chunk = idx[s : s + self.batch_size]
                samples = list(
                    pool.map(lambda i: self._load_one(epoch, i), chunk)
                )
                yield _stack_batch(samples)
