"""Online flow serving: admission, iteration budget, the server and its
synthetic traffic."""

from raft_ncup_tpu_torch.serving.admission import AdmissionQueue  # noqa: F401
from raft_ncup_tpu_torch.serving.budget import IterationBudgetController  # noqa: F401
from raft_ncup_tpu_torch.serving.request import (  # noqa: F401
    FlowRequest,
    FlowResponse,
    ServeHandle,
    ServeStats,
    nearest_rank_ms,
)
from raft_ncup_tpu_torch.serving.server import FlowServer  # noqa: F401
from raft_ncup_tpu_torch.serving.traffic import SyntheticTraffic, replay  # noqa: F401
