"""Runtime guards: hold the hot paths to zero implicit host reads and zero
captures while they run (port of ``raft_ncup_tpu/analysis/guards.py``).

The serving, streaming, validation and training loops read the card's
results on the host at a few sanctioned points only (a batch's drain, a
pass's sums, a logger window) and capture their CUDA graphs and load their
kernels before the steady state. One stray ``.item()`` puts a wait for the
card back on the dispatch path, and one shape that drifts captures a graph
per batch. Three primitives check this on the running loop:

- :func:`forbid_host_transfers`: a context that intercepts implicit reads
  of a tensor's value by the host and raises :class:`GuardViolation` (or
  counts, with ``raise_on_violation=False``). Intercepted on
  ``torch.Tensor``: ``item``, ``tolist``, ``numpy``, ``__array__``,
  ``__float__``, ``__int__``, ``__bool__``, ``__complex__``; ``cpu`` and
  ``to`` toward the host, for a tensor on the card; numpy's ``asarray`` and
  ``array`` applied to a tensor. Every tensor counts, on the CPU too: there
  the model's tensors are the CPU's, and a read of one is the read the card
  would wait for, so the CPU tests cannot pass vacuously. A thread that
  handles only the host's own data (the loader's, the decode pool's and
  the prefetchers' workers) marks itself with :func:`mark_host_thread`:
  its reads of host tensors are not transfers, its reads of card tensors
  still are. The sanctioned
  read is :func:`host_read`, the counterpart of ``jax.device_get``: each
  call counts in ``sanctioned_gets``. :func:`flag_read` is the early-exit
  entry's named read of one flag byte, counted apart
  (``guard_flag_reads_total``), never as an implicit transfer;
  :func:`collective_read` is a gloo collective's copy of a card tensor to
  the host, counted as ``guard_collective_reads_total``. The second,
  native layer is ``torch.cuda.set_sync_debug_mode("error")`` while a scope
  is armed (``native_guard``), JAX's ``transfer_guard_device_to_host``:
  PyTorch then raises on an operation that waits for the card (``item``,
  a blocking copy either way, ``Stream.synchronize``), but not on
  ``Event.synchronize``, ``torch.cuda.synchronize`` or a non-blocking copy
  through pinned memory, so the dispatch throttle and the sanctioned reads
  wait on events. The mode is process-wide, so it is switched on with the
  first armed scope and off with the last; on the CPU it is not touched.
- :class:`RecompileWatchdog` / :func:`max_recompiles`: count the port's
  compile events while armed: a new key of any ``ShapeCachedForward``
  (a CUDA-graph capture on the card, the eager entry's first run on the
  CPU) and a kernel library built or loaded by ``ops/cuda_build.py``
  (:func:`note_compile` is their one hook).
- :class:`StepGuard`: the train entry's ``--strict_guards``: registered
  once around the loop, armed per step (:meth:`StepGuard.scope`), so
  validation and checkpoints stay outside.

The patches are process-wide while a scope exists (a read from any thread
is a violation); the sanctioned flag is thread-local, so the drain worker's
read does not cover the dispatcher. A violation mirrors into the telemetry
hub as the ``guard_host_transfer_violation`` event and the
``guard_violation`` flight trigger; sanctioned reads and recompiles count
as ``guard_sanctioned_gets_total`` and ``guard_recompiles_total``.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Iterator, List, Optional

import numpy as np
import torch

# Reads of a tensor's value, intercepted on any tensor. ``__array__`` covers
# numpy's conversion; numpy's module-level asarray/array are wrapped as
# well, as the JAX package does.
_PULL_METHODS = (
    "__array__",
    "__float__",
    "__int__",
    "__bool__",
    "__complex__",
    "item",
    "tolist",
    "numpy",
)
# Copies that read a card tensor on the host (toward the CPU only).
_MOVE_METHODS = ("cpu", "to")
_NUMPY_FUNCS = ("asarray", "array")


class GuardViolation(RuntimeError):
    """A guarded invariant (no implicit host reads, a capture budget) broke."""


@dataclass(eq=False)  # a counter object: identity, not value, equality
class GuardStats:
    """Counters a guard scope fills in; ``--strict_guards`` reports them."""

    host_transfers: int = 0  # forbidden implicit reads observed
    sanctioned_gets: int = 0  # host_read calls
    recompiles: int = 0  # steady-state compile events (see StepGuard)
    warmup_compiles: int = 0  # compile events of the warm-up scopes
    violations: List[str] = field(default_factory=list)


def _telemetry():
    from raft_ncup_tpu_torch.observability import get_telemetry

    return get_telemetry()


# ----------------------------------------------------------- read guard

# .sanctioned: inside host_read / flag_read; .inside: inside an intercepted
# call already judged (its nested intercepted calls are the same read).
_tl = threading.local()
_lock = threading.RLock()
_active: list = []  # stack of _ScopeEntry (patches installed while non-empty)
_saved: dict = {}
_native = {"depth": 0, "prev": 0}


class _ScopeEntry:
    """One active guard scope. ``armed=False`` keeps the patches installed
    but inert: StepGuard's state between steps."""

    __slots__ = ("stats", "raise_on_violation", "armed")

    def __init__(self, stats, raise_on_violation: bool, armed: bool = True):
        self.stats = stats
        self.raise_on_violation = raise_on_violation
        self.armed = armed


def _push_scope(stats: GuardStats, raise_on_violation: bool,
                armed: bool = True) -> _ScopeEntry:
    with _lock:
        if not _active:
            _install()
        entry = _ScopeEntry(stats, raise_on_violation, armed)
        _active.append(entry)
        return entry


def _pop_scope(entry: _ScopeEntry) -> None:
    with _lock:
        _active.remove(entry)  # identity: plain object equality
        if not _active:
            _uninstall()


def _armed_entry() -> Optional[_ScopeEntry]:
    return next((e for e in reversed(_active) if e.armed), None)


def _exempt(t: torch.Tensor) -> bool:
    """Whether a read of ``t`` on this thread is not a transfer: inside a
    sanctioned read or an intercepted call already judged, or a host
    tensor on a host data thread."""
    return (getattr(_tl, "sanctioned", False) or getattr(_tl, "inside", False)
            or (getattr(_tl, "host_data", False) and t.device.type == "cpu"))


def mark_host_thread() -> None:
    """Mark the calling thread as one that handles only the host's own
    data (a loader, decode or prefetch worker: numpy and host tensors it
    made itself, never a model's output). Its reads of host tensors are
    then not transfers; its reads of card tensors still are. Call it first
    thing in the thread (a pool's ``initializer``)."""
    _tl.host_data = True


def _record_violation(desc: str) -> None:
    with _lock:
        entry = _armed_entry()
        if entry is None:
            return
        entry.stats.host_transfers += 1
        entry.stats.violations.append(desc)
        raise_on_violation = entry.raise_on_violation
    tel = _telemetry()
    tel.event("guard_host_transfer_violation", desc=desc)
    # A read leaked onto the hot path: bank the timeline that led to it
    # (rate-limited in the recorder, a no-op without one).
    tel.flight_dump("guard_violation", desc=desc)
    if raise_on_violation:
        raise GuardViolation(
            f"implicit device->host transfer under forbid_host_transfers: {desc}. "
            "Keep values on the device between window boundaries and read them "
            "through one guards.host_read."
        )


def _to_host(args: tuple, kwargs: dict) -> bool:
    """Whether ``Tensor.to(*args, **kwargs)`` names the CPU as its target."""
    dev = kwargs.get("device")
    if dev is None:
        for a in args:
            if isinstance(a, torch.Tensor):
                dev = a.device
                break
            if isinstance(a, (str, torch.device)):
                dev = a
                break
    return dev is not None and torch.device(dev).type == "cpu"


@contextlib.contextmanager
def _judged():
    prev = getattr(_tl, "inside", False)
    _tl.inside = True
    try:
        yield
    finally:
        _tl.inside = prev


def _install() -> None:
    t_cls = torch.Tensor

    def patch(target, name, make):
        _saved[(target, name)] = (name in vars(target), getattr(target, name))
        setattr(target, name, make(name, getattr(target, name)))

    def make_pull(nm, orig):
        def patched(self, *a, **kw):
            if not _exempt(self):
                _record_violation(f"torch.Tensor.{nm} on {self.device} tensor of shape "
                                  f"{tuple(self.shape)}")
            with _judged():
                return orig(self, *a, **kw)

        return patched

    def make_move(nm, orig):
        def patched(self, *a, **kw):
            if (self.device.type != "cpu" and not _exempt(self)
                    and (nm == "cpu" or _to_host(a, kw))):
                _record_violation(f"torch.Tensor.{nm} to the host of a {self.device} tensor "
                                  f"of shape {tuple(self.shape)}")
            return orig(self, *a, **kw)

        return patched

    def make_np(nm, orig):
        def patched(obj, *a, **kw):
            if not isinstance(obj, torch.Tensor):
                return orig(obj, *a, **kw)
            if not _exempt(obj):
                _record_violation(f"np.{nm} on a {obj.device} tensor of shape "
                                  f"{tuple(obj.shape)}")
            with _judged():
                return orig(obj, *a, **kw)

        return patched

    for name in _PULL_METHODS:
        patch(t_cls, name, make_pull)
    for name in _MOVE_METHODS:
        patch(t_cls, name, make_move)
    for name in _NUMPY_FUNCS:
        patch(np, name, make_np)


def _uninstall() -> None:
    for (target, name), (own, orig) in _saved.items():
        if own:
            setattr(target, name, orig)
        else:  # inherited (torch.Tensor's from its C base): drop the shadow
            delattr(target, name)
    _saved.clear()


@contextlib.contextmanager
def _native_layer(on: bool) -> Iterator[None]:
    """``torch.cuda.set_sync_debug_mode("error")`` from the first armed
    scope to the last (the mode is process-wide); nothing on a machine
    without CUDA."""
    if not on or not torch.cuda.is_available():
        yield
        return
    with _lock:
        if _native["depth"] == 0:
            _native["prev"] = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
        _native["depth"] += 1
    try:
        yield
    finally:
        with _lock:
            _native["depth"] -= 1
            if _native["depth"] == 0:
                torch.cuda.set_sync_debug_mode(_native["prev"])


@contextlib.contextmanager
def forbid_host_transfers(
    stats: Optional[GuardStats] = None,
    raise_on_violation: bool = True,
    native_guard: bool = True,
) -> Iterator[GuardStats]:
    """Forbid implicit device-to-host reads inside the scope.

    Yields the :class:`GuardStats` being filled. With
    ``raise_on_violation=False`` violations only count. ``native_guard``
    also arms PyTorch's sync debug mode on the card (see the module
    docstring); on the CPU it does nothing."""
    stats = stats if stats is not None else GuardStats()
    entry = _push_scope(stats, raise_on_violation)
    try:
        with _native_layer(native_guard):
            yield stats
    finally:
        _pop_scope(entry)


# ------------------------------------------------------- sanctioned reads


def _wait(ready) -> None:
    """Wait on the host for ``ready`` (a CUDA event, or None). An event's
    synchronize is not flagged by the sync debug mode."""
    if ready is not None:
        ready.synchronize()


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A staged copy's values: a pinned buffer's are copied out, so the
    buffer goes back to the caching host allocator at once; a host clone
    is handed over as it is."""
    return t.numpy().copy() if t.is_pinned() else t.numpy()


def _copy_out(tree, devices: list):
    """Queue a non-blocking copy of every card tensor of ``tree`` into new
    pinned host memory (the caching host allocator keeps each buffer until
    its copy has run); a host tensor is cloned, so either way the values
    are those at the call (bf16 as float32: numpy has no bfloat16)."""
    if isinstance(tree, torch.Tensor):
        src = tree.detach()
        if tree.device.type == "cpu":
            return src.float() if src.dtype == torch.bfloat16 else src.clone()
        if src.dtype == torch.bfloat16:
            src = src.float()
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        host.copy_(src, non_blocking=True)
        devices.append(src.device)
        return host
    if isinstance(tree, (tuple, list)):
        return type(tree)(_copy_out(x, devices) for x in tree)
    if isinstance(tree, dict):
        return {k: _copy_out(v, devices) for k, v in tree.items()}
    return tree


def _as_host(tree):
    if isinstance(tree, torch.Tensor):
        return _to_numpy(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_as_host(x) for x in tree)
    if isinstance(tree, dict):
        return {k: _as_host(v) for k, v in tree.items()}
    return tree


def stage_out(tree):
    """Queue the copies of :func:`host_read` without waiting: ``(host
    tree, event)``, where the event (None when nothing was on the card) is
    recorded on the current stream after the copies. The ``AsyncDrain``
    dispatcher side; the worker then calls ``host_read(host, ready=event)``.
    Queuing a copy reads nothing on the host."""
    devices: list = []
    host = _copy_out(tree, devices)
    if not devices:
        return host, None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(devices[0]))
    return host, event


def host_read(tree, ready=None):
    """The sanctioned read (``jax.device_get``'s counterpart): the numpy
    values of a tensor or of a tuple, list or dict of them (bf16 as
    float32). Card tensors are copied through pinned memory and waited for
    with an event; with ``ready`` (from :func:`stage_out`) the copies are
    already queued. Inside an armed scope it counts one ``sanctioned_gets``
    there and one ``guard_sanctioned_gets_total``."""
    with _lock:
        entry = _armed_entry()
        if entry is not None:
            entry.stats.sanctioned_gets += 1
    if entry is not None:
        _telemetry().inc("guard_sanctioned_gets_total")
    prev = getattr(_tl, "sanctioned", False)
    _tl.sanctioned = True
    try:
        if ready is None:
            tree, ready = stage_out(tree)
        _wait(ready)
        return _as_host(tree)
    finally:
        _tl.sanctioned = prev


def flag_read(flag: torch.Tensor) -> bool:
    """The early-exit entry's named read of one flag (a 0-d or 1-element
    tensor): a one-byte copy through pinned memory and an event wait on
    the card. It is a synchronisation by design, counted as
    ``guard_flag_reads_total`` and never as an implicit transfer."""
    _telemetry().inc("guard_flag_reads_total")
    prev = getattr(_tl, "sanctioned", False)
    _tl.sanctioned = True
    try:
        host, ready = stage_out(flag.reshape(1))
        _wait(ready)
        return bool(host.numpy()[0])
    finally:
        _tl.sanctioned = prev


def collective_read(t: torch.Tensor) -> torch.Tensor:
    """A collective's copy of a card tensor to the host, for a backend that
    reduces on the host (gloo): a non-blocking copy into pinned memory and
    an event wait on the card. It is a synchronisation by design, counted
    as ``guard_collective_reads_total`` and never as an implicit transfer.
    Returns the host tensor (pinned for a card tensor, a clone for a host
    one), whose values the caller may reduce and copy back."""
    _telemetry().inc("guard_collective_reads_total")
    prev = getattr(_tl, "sanctioned", False)
    _tl.sanctioned = True
    try:
        host, ready = stage_out(t)
        _wait(ready)
        return host
    finally:
        _tl.sanctioned = prev


# ----------------------------------------------------- recompile watchdog

_compile_listeners: list = []


def note_compile(kind: str, what: str) -> None:
    """A compile event: ``kind`` ``"capture"`` (a new ``ShapeCachedForward``
    key) or ``"kernel_load"`` (a kernel library built or loaded). Every
    registered :class:`RecompileWatchdog` hears it."""
    for listener in list(_compile_listeners):
        listener(kind, what)


class RecompileWatchdog:
    """Counts compile events (:func:`note_compile`) while armed.

    Use as a context manager; ``.count`` is the number observed inside
    the scope. ``arm()``/``disarm()`` gate counting within a longer
    registration (StepGuard counts step-scope events only)."""

    def __init__(self) -> None:
        self.count = 0
        self.events: List[tuple] = []
        self._armed = True

    def _listener(self, kind: str, what: str) -> None:
        if self._armed:
            self.count += 1
            self.events.append((kind, what))
            _telemetry().inc("guard_recompiles_total")

    def arm(self) -> None:
        self._armed = True

    def disarm(self) -> None:
        self._armed = False

    def __enter__(self) -> "RecompileWatchdog":
        with _lock:
            _compile_listeners.append(self._listener)
        return self

    def __exit__(self, *exc) -> None:
        with _lock:
            if self._listener in _compile_listeners:
                _compile_listeners.remove(self._listener)


@contextlib.contextmanager
def max_recompiles(n: int = 1) -> Iterator[RecompileWatchdog]:
    """Assert at most ``n`` compile events inside the scope; raises
    :class:`GuardViolation` at exit otherwise."""
    with RecompileWatchdog() as wd:
        yield wd
    if wd.count > n:
        raise GuardViolation(
            f"{wd.count} compile events inside a max_recompiles({n}) scope "
            f"({wd.events}) - an input shape or dtype is drifting between steps"
        )


# --------------------------------------------------------- loop integration


class StepGuard:
    """``--strict_guards`` for a training loop.

    Register once around the loop (context manager), then wrap each
    steady-state iteration in :meth:`scope`::

        with StepGuard() as guard:
            while step_i < total:
                with guard.scope():
                    batch = next(prefetcher)   # on the card already
                    metrics = step_fn(state, batch)
                    logger.push(...)           # host_read at its boundary
                if step_i % val_freq == 0:
                    validate(...)              # outside: may read, capture
            guard.check()

    Inside ``scope()`` implicit host reads raise at once (and, on the
    card, so does any operation that waits for it) and compile events
    count. The first ``warmup_scopes`` scopes' events (the kernels' loads
    at the first step) are ``stats.warmup_compiles``; those of a later
    scope are ``stats.recompiles``, which :meth:`check` holds to
    ``max_steady_recompiles``."""

    def __init__(self, max_steady_recompiles: int = 0, raise_on_violation: bool = True,
                 warmup_scopes: int = 2) -> None:
        self.max_steady_recompiles = max_steady_recompiles
        self.raise_on_violation = raise_on_violation
        self.warmup_scopes = warmup_scopes
        self.stats = GuardStats()
        self._watchdog = RecompileWatchdog()
        self._entry: Optional[_ScopeEntry] = None
        self._scopes = 0

    def __enter__(self) -> "StepGuard":
        self._watchdog.__enter__()
        self._watchdog.disarm()
        # The patches install once and stay, disarmed, between scopes.
        self._entry = _push_scope(self.stats, self.raise_on_violation, armed=False)
        return self

    def __exit__(self, *exc) -> None:
        if self._entry is not None:
            _pop_scope(self._entry)
            self._entry = None
        self._watchdog.__exit__(*exc)

    @contextlib.contextmanager
    def scope(self) -> Iterator[None]:
        """One guarded steady-state iteration."""
        before = self._watchdog.count
        self._watchdog.arm()
        self._entry.armed = True
        try:
            with _native_layer(True):
                yield
        finally:
            self._entry.armed = False
            self._watchdog.disarm()
            delta = self._watchdog.count - before
            if self._scopes < self.warmup_scopes:
                self.stats.warmup_compiles += delta
            else:
                self.stats.recompiles += delta
            self._scopes += 1

    def check(self) -> None:
        """Enforce the steady-state compile budget over all scopes so far."""
        if self.stats.recompiles > self.max_steady_recompiles:
            raise GuardViolation(
                f"train step recompiled {self.stats.recompiles}x after its warm-up "
                f"scopes (budget {self.max_steady_recompiles}) - an input shape or "
                "dtype is drifting between steps"
            )

