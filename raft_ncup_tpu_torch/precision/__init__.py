"""The precision policy: presets ``f32``, ``bf16_infer`` and ``bf16_train``
(``policy.py``), selected by ``ModelConfig.precision``,
``ServeConfig.precision`` and ``TrainConfig.precision``."""

from raft_ncup_tpu_torch.precision.policy import (  # noqa: F401
    BF16_INFER,
    BF16_TRAIN,
    EARLYEXIT_EPE_BUDGET,
    F32,
    FORWARD_EPE_BUDGET,
    PRESET_NAMES,
    PRESETS,
    TRAIN_LOSS_RTOL,
    PrecisionPolicy,
    resolve_policy,
)
