"""The stream engine's state: a slot table on the device and a registry on
the host (port of ``raft_ncup_tpu/streaming/slots.py``).

- **Device** (:func:`init_slot_table`): the recurrent state itself, each
  slot's previous low-res flow, its warm flag and (``carry_net``) its GRU
  state, in tensors of ``capacity + 1`` rows allocated once. Only the
  engine's step reads them (a gather by slot index) and writes them (an
  in-place ``index_copy_``), so state never leaves the card between
  frames. Row ``capacity`` is the scratch slot that pad rows read and
  write, so padding never touches a stream's state. The warm flag lives on
  the device because the step's anomaly check resets it.
- **Host** (:class:`SlotRegistry`): bookkeeping only: which stream owns
  which slot, its last admitted frame index (staleness), its last
  activity (idle eviction) and its frames in flight (eviction safety).
  The lowest free slot is assigned, and idle eviction scans in
  (last_activity, stream_id) order, so a replayed chaos schedule evicts
  the same streams into the same slots. Freeing a slot touches no device
  memory: the next owner's first frame is dispatched cold, which ignores
  and overwrites what the previous owner left.

The engine's lock guards every registry call; the registry has none.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch


def init_slot_table(capacity: int, h8: int, w8: int, hidden_dim: int = 0, dtype=None,
                    device=None) -> dict:
    """An all-cold slot table for ``capacity`` streams on ``device``:
    ``flow`` (capacity + 1, h8, w8, 2) and, with ``hidden_dim``, ``net``
    (capacity + 1, h8, w8, hidden_dim) at the state dtype ``dtype``
    (default f32; the policy's ``state``, so the bf16 presets halve the
    table), and ``warm`` (capacity + 1,) f32 0/1 flags. The last row is the
    scratch slot."""
    dtype = dtype or torch.float32
    table = {
        "flow": torch.zeros((capacity + 1, h8, w8, 2), dtype=dtype, device=device),
        "warm": torch.zeros((capacity + 1,), dtype=torch.float32, device=device),
    }
    if hidden_dim:
        table["net"] = torch.zeros((capacity + 1, h8, w8, hidden_dim), dtype=dtype,
                                   device=device)
    return table


@dataclass
class StreamState:
    """The host's metadata of one admitted stream (one slot)."""

    stream_id: str
    slot: int
    native_hw: Tuple[int, int]
    opened_at: float
    last_activity: float
    last_frame_index: Optional[int] = None
    pending: int = 0  # admitted frames not yet answered
    frames_admitted: int = 0
    frames_completed: int = 0
    resets: int = 0  # anomaly resets delivered
    closing: bool = False


@dataclass
class SlotRegistry:
    """Host bookkeeping: stream id -> slot, and each stream's lifecycle."""

    capacity: int
    streams: Dict[str, StreamState] = field(default_factory=dict)
    evicted_total: int = 0
    peak_occupancy: int = 0
    _free: List[int] = field(default_factory=list)

    def __post_init__(self) -> None:
        self._free = sorted(range(self.capacity), reverse=True)

    def get(self, stream_id: str) -> Optional[StreamState]:
        return self.streams.get(stream_id)

    @property
    def occupancy(self) -> int:
        return self.capacity - len(self._free)

    def soonest_expiry_s(self, now: float, idle_timeout_s: float) -> float:
        """The retry hint of a shed stream: seconds until the stream idle
        longest becomes evictable (0 when one already is)."""
        if not self.streams:
            return idle_timeout_s
        return min(max(0.0, s.last_activity + idle_timeout_s - now)
                   for s in self.streams.values())

    def admit(self, stream_id: str, native_hw: Tuple[int, int],
              now: float) -> Optional[StreamState]:
        """The lowest free slot for a new stream, or ``None`` when the table
        is full (the caller sheds)."""
        if not self._free:
            return None
        state = StreamState(stream_id=stream_id, slot=self._free.pop(),
                            native_hw=tuple(native_hw), opened_at=now, last_activity=now)
        self.streams[stream_id] = state
        self.peak_occupancy = max(self.peak_occupancy, self.occupancy)
        return state

    def release(self, stream_id: str) -> Optional[int]:
        """Free a stream's slot (close or eviction); returns the slot."""
        state = self.streams.pop(stream_id, None)
        if state is None:
            return None
        self._free.append(state.slot)
        self._free.sort(reverse=True)  # keep the lowest slot first
        return state.slot

    def evict_expired(self, now: float, idle_timeout_s: float) -> List[StreamState]:
        """Evict every stream idle past ``idle_timeout_s`` with nothing in
        flight, oldest activity first (stream id breaks ties)."""
        expired = sorted(
            (s for s in self.streams.values()
             if s.pending == 0 and now - s.last_activity > idle_timeout_s),
            key=lambda s: (s.last_activity, s.stream_id),
        )
        for s in expired:
            self.release(s.stream_id)
            self.evicted_total += 1
        return expired
