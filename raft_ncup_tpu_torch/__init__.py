"""PyTorch/CUDA port of raft_ncup_tpu for NVIDIA Hopper (H100).

The JAX package ``raft_ncup_tpu`` is the reference this package is held
against; nothing here imports it (or JAX). The layout mirrors it module
for module (``config``, ``ops``, ``nn``, ``models``, ``serving``,
``training``, ``data``), and public functions keep its layouts: NHWC
images, flows and feature maps, ``(B, H, W, 2)`` coordinates with x
first.

The two Pallas kernels of the JAX package are hand-written CUDA C++
here (``csrc/``), built with ``nvcc`` for ``sm_90a`` at first use, each
with a hand-written backward kernel where the JAX package differentiates
its XLA path:

- the fused correlation-window lookup (``ops/corr_cuda.py``), for
  ``ModelConfig.corr_impl == "pallas"``;
- the fused normalized convolution (``ops/nconv_cuda.py``), for
  ``ModelConfig.nconv_impl == "pallas"``.

Entry points: ``python -m raft_ncup_tpu_torch.serve`` and
``python -m raft_ncup_tpu_torch.train``.
"""

from raft_ncup_tpu_torch.config import (  # noqa: F401
    ModelConfig,
    ServeConfig,
    TrainConfig,
    UpsamplerConfig,
    flagship_config,
)
