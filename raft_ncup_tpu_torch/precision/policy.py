"""The precision policy: the one authority for dtypes on the hot path
(port of ``raft_ncup_tpu/precision/policy.py``, with ``torch.dtype``
properties in place of the ``jnp`` ones).

A frozen :class:`PrecisionPolicy` names a param, compute and output
dtype, and pins the dtypes that stay float32 under every preset:

- ``coord`` (f32): the query coordinates and the low-res flow carry.
  RAFT re-reads them every GRU iteration, so bf16 compute error in one
  iteration perturbs the next one's inputs but never narrows the carried
  state; bf16 cannot even hold integer pixel positions above 256.
- ``acc`` (f32): metric accumulators.
- ``norm`` (f32): normalization statistics (``nn.layers.Norm`` computes
  in f32 and returns the input's dtype).
- ``upsampler`` (f32): NCUP and the convex upsampler. The reference runs
  them outside its autocast region, and NConv's confidences are ratios
  of sums. So kernels B and B' always take f32 operands.
- ``param`` (f32 in every preset): master weights. ``bf16_train`` is
  bf16 compute with f32 master weights: the parameters, gradients,
  optimizer moments, loss, gradient norm and sentinel stay f32.

Presets: ``f32`` (everything float32, the default), ``bf16_infer`` (bf16
activations and correlation features in the test-mode forward) and
``bf16_train`` (the same compute dtypes, named for training).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch

_ALLOWED = ("float32", "bfloat16")

# The error budgets the bf16 presets are held to against the f32 preset:
# the mean end-point error between the two test-mode forwards, in pixels,
# and the relative per-step tolerance of the train-loss trajectory. The
# JAX package's values (``raft_ncup_tpu/precision/policy.py:75-76``).
FORWARD_EPE_BUDGET = 0.5  # px: test-mode forward / serving
TRAIN_LOSS_RTOL = 0.15  # relative per-step loss-trajectory tolerance
# The mean end-point error an early-exit forward may add against its own
# full-budget twin (same inputs, same weights, no detection), in pixels
# (``raft_ncup_tpu/precision/policy.py:87``).
EARLYEXIT_EPE_BUDGET = 0.5  # px: early exit vs the full budget

_F32 = torch.float32


@dataclass(frozen=True)
class PrecisionPolicy:
    """Immutable dtype policy. ``name`` identifies it: two policies with
    different dtypes have different names."""

    name: str
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    output_dtype: str = "float32"

    def __post_init__(self) -> None:
        for field in ("param_dtype", "compute_dtype", "output_dtype"):
            v = getattr(self, field)
            if v not in _ALLOWED:
                raise ValueError(
                    f"{field}={v!r} not in {_ALLOWED} (policy {self.name!r})"
                )
        if self.param_dtype != "float32":
            raise ValueError(
                f"param_dtype must be 'float32' (master weights); "
                f"policy {self.name!r} asked for {self.param_dtype!r}"
            )
        if self.output_dtype != "float32":
            raise ValueError(
                f"output_dtype must be 'float32' (metrics/serving "
                f"contract); policy {self.name!r} asked for "
                f"{self.output_dtype!r}"
            )

    @property
    def param(self) -> torch.dtype:
        """Master-weight storage dtype (f32 in every preset)."""
        return getattr(torch, self.param_dtype)

    @property
    def compute(self) -> torch.dtype:
        """Activation and convolution dtype."""
        return getattr(torch, self.compute_dtype)

    @property
    def output(self) -> torch.dtype:
        """The flow fields' dtype (f32)."""
        return getattr(torch, self.output_dtype)

    @property
    def corr(self) -> torch.dtype:
        """Correlation feature dtype: the compute dtype. Under bf16 the
        lookup kernel reads bf16 f1 rows and f2 levels and accumulates in
        f32."""
        return self.compute

    @property
    def state(self) -> torch.dtype:
        """The streaming slot table's recurrent-state dtype (the previous
        low-res flow and the optional GRU state): the compute dtype, so the
        bf16 presets halve the table. The stream step upcasts to ``coord``
        before the warm-start splat."""
        return self.compute

    @property
    def coord(self) -> torch.dtype:
        return _F32

    @property
    def acc(self) -> torch.dtype:
        return _F32

    @property
    def norm(self) -> torch.dtype:
        return _F32

    @property
    def upsampler(self) -> torch.dtype:
        return _F32

    @property
    def module_dtype(self) -> Optional[torch.dtype]:
        """The ``dtype`` the trunk's convolutions compute in: ``None``
        under f32 (they follow their input, so the f32 model adds no
        cast), else the compute dtype."""
        return None if self.is_f32 else self.compute

    @property
    def corr_itemsize(self) -> int:
        """Bytes per correlation feature element."""
        return torch.empty((), dtype=self.corr).element_size()

    @property
    def is_f32(self) -> bool:
        return self.compute_dtype == "float32"


F32 = PrecisionPolicy(name="f32")
BF16_INFER = PrecisionPolicy(name="bf16_infer", compute_dtype="bfloat16")
BF16_TRAIN = PrecisionPolicy(name="bf16_train", compute_dtype="bfloat16")

PRESETS: dict[str, PrecisionPolicy] = {p.name: p for p in (F32, BF16_INFER, BF16_TRAIN)}

PRESET_NAMES = tuple(PRESETS)


def resolve_policy(spec: Union[str, PrecisionPolicy, None]) -> PrecisionPolicy:
    """A preset name, a policy or ``None`` (f32) -> a policy."""
    if spec is None:
        return F32
    if isinstance(spec, PrecisionPolicy):
        return spec
    try:
        return PRESETS[spec]
    except KeyError:
        raise ValueError(
            f"unknown precision preset {spec!r}; known: {PRESET_NAMES}"
        ) from None
