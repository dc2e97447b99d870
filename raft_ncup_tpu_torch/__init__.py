"""PyTorch/CUDA port of raft_ncup_tpu for NVIDIA Hopper (H100).

The JAX package ``raft_ncup_tpu`` is the reference this package is held
against; nothing here imports it (or JAX). The layout mirrors it module
for module (``config``, ``ops``, ``nn``, ``models``, ``serving``,
``streaming``, ``training``, ``data``), and public functions keep its layouts: NHWC
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

Models: the flagship ``raft_nc_dbl`` (NCUP or bilinear upsampling),
the ``raft`` baseline with convex upsampling, and the small model of
either variant (``small_model_config``), each under the precision
presets ``f32`` (the default), ``bf16_infer`` and ``bf16_train``
(``precision/policy.py``).

Entry points: ``python -m raft_ncup_tpu_torch.serve`` (requests, or
video streams with ``--stream``), ``python -m raft_ncup_tpu_torch.train``,
``evaluate`` and ``demo``.
"""

# The config's names, imported at their first use: importing the package
# imports no torch, so its pure-stdlib tools (the static lint,
# ``python -m raft_ncup_tpu_torch.analysis``) start without it.
_CONFIG_EXPORTS = (
    "ModelConfig",
    "ServeConfig",
    "StreamConfig",
    "TrainConfig",
    "UpsamplerConfig",
    "flagship_config",
    "small_model_config",
)
__all__ = list(_CONFIG_EXPORTS)


def __getattr__(name: str):
    if name in _CONFIG_EXPORTS:
        from raft_ncup_tpu_torch import config

        return getattr(config, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
