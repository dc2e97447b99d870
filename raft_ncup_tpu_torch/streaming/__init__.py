"""The streaming video engine: many concurrent streams, each with its
recurrent state (the previous low-res flow, optionally the GRU state) in a
slot table on the card (``slots``), batched through one captured step per
batch size (``engine``), and a deterministic multi-stream schedule with
chaos events to drive it (``traffic``)."""

from raft_ncup_tpu_torch.config import StreamConfig
from raft_ncup_tpu_torch.streaming.engine import FrameRequest, StreamEngine, StreamStats
from raft_ncup_tpu_torch.streaming.slots import SlotRegistry, StreamState, init_slot_table
from raft_ncup_tpu_torch.streaming.traffic import StreamTraffic, replay_streams

__all__ = [
    "FrameRequest",
    "SlotRegistry",
    "StreamConfig",
    "StreamEngine",
    "StreamState",
    "StreamStats",
    "StreamTraffic",
    "init_slot_table",
    "replay_streams",
]
