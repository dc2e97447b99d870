from raft_ncup_tpu_torch.models.raft import RAFT  # noqa: F401
