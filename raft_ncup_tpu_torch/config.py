"""Typed, immutable configuration for the port's model and server.

The port's own copy of ``raft_ncup_tpu/config.py``'s ``UpsamplerConfig``,
``ModelConfig``, ``ServeConfig`` and ``flagship_config`` (the port imports
nothing of the JAX package). Field names and defaults are the JAX
package's, so one configuration means the same in both packages, with
these differences of this slice:

- ``ModelConfig.precision`` accepts only ``"f32"``; the bf16 presets are
  a later slice and raise here. The model's forward keeps TF32 off
  (``utils.device.f32_precision``), so f32 means f32 on the card too.
- ``ModelConfig`` has no ``align_corners`` (read only by the bilinear
  upsampler) and no ``freeze_raft`` (a training mask); they return with
  the slices that read them, so no field here is silently ignored.
- ``ModelConfig.nconv_impl`` carries the normalized-convolution switch
  that the JAX package reads from its ``RAFT_NCUP_NCONV_IMPL`` knob:
  ``"xla"`` (plain composition of two convolutions) or ``"pallas"``
  (the fused kernel, CUDA in the port). Its default is the JAX default.
- ``ServeConfig`` has no ``mesh`` and no ``precision`` (one card, f32).
"""

from __future__ import annotations

from dataclasses import dataclass, field

CORR_IMPLS = ("volume", "onthefly", "pallas")
NCONV_IMPLS = ("xla", "pallas")


@dataclass(frozen=True)
class UpsamplerConfig:
    """Configuration of the final flow upsampler (NCUP by default).

    Same fields and defaults as the JAX package's ``UpsamplerConfig``.
    """

    kind: str = "nconv"
    # The NCUP path does nearest x2 first and NCUP x4 after.
    scale: int = 4
    use_data_for_guidance: bool = True
    channels_to_batch: bool = True
    use_residuals: bool = False
    est_on_high_res: bool = False

    # --- interpolation (NConvUNet) net
    channels_multiplier: int = 2
    num_downsampling: int = 1
    encoder_filter_sz: int = 5
    decoder_filter_sz: int = 3
    out_filter_sz: int = 1
    use_bias: bool = False
    data_pooling: str = "conf_based"  # 'conf_based' | 'max_pooling'
    shared_encoder: bool = True
    use_double_conv: bool = False
    pos_fn: str = "softplus"  # 'softplus' | 'exp' | 'sigmoid' | 'softmax'

    # --- weights estimation net
    weights_est_net: str = "simple"  # 'simple' | 'unet' | 'binary'
    weights_est_num_ch: tuple[int, ...] = (64, 32)
    weights_est_filter_sz: tuple[int, ...] = (3, 3, 1)
    weights_est_dilation: tuple[int, ...] = (1, 1, 1)


@dataclass(frozen=True)
class ModelConfig:
    """Model architecture configuration ('raft' | 'raft_nc_dbl')."""

    variant: str = "raft_nc_dbl"
    small: bool = False
    dropout: float = 0.0
    precision: str = "f32"
    mixed_precision: bool = False
    corr_levels: int = 4
    corr_radius: int = 4
    # 'volume' materializes the all-pairs volume; 'onthefly' samples
    # fmap2 per lookup; 'pallas' = the fused lookup kernel (CUDA here).
    corr_impl: str = "volume"
    # 'xla' = two plain convolutions + divide; 'pallas' = the fused
    # NConv2d kernel (CUDA here).
    nconv_impl: str = "xla"
    # BatchNorm in the NCUP weights-estimation net: ON for sintel only.
    dataset: str = "sintel"
    upsampler: UpsamplerConfig = field(default_factory=UpsamplerConfig)

    def __post_init__(self) -> None:
        if self.variant not in ("raft", "raft_nc_dbl"):
            raise ValueError(f"unknown model variant: {self.variant!r}")
        if self.precision != "f32" or self.mixed_precision:
            raise NotImplementedError(
                f"precision {self.precision!r} (mixed_precision="
                f"{self.mixed_precision}): the port runs f32 only; the bf16 "
                "presets land with a later slice"
            )
        if self.corr_impl not in CORR_IMPLS:
            raise ValueError(f"unknown corr_impl: {self.corr_impl!r}")
        if self.nconv_impl not in NCONV_IMPLS:
            raise ValueError(f"unknown nconv_impl: {self.nconv_impl!r}")

    @property
    def hidden_dim(self) -> int:
        return 96 if self.small else 128

    @property
    def context_dim(self) -> int:
        return 64 if self.small else 128

    @property
    def fnet_dim(self) -> int:
        return 128 if self.small else 256

    @property
    def resolved_corr_radius(self) -> int:
        # The small model overrides the radius.
        return 3 if self.small else self.corr_radius

    @property
    def corr_planes(self) -> int:
        r = self.resolved_corr_radius
        return self.corr_levels * (2 * r + 1) ** 2


@dataclass(frozen=True)
class ServeConfig:
    """Online flow-serving knobs (see ``serving/server.py``).

    Same fields and defaults as the JAX package's ``ServeConfig`` except
    ``mesh`` and ``precision``, which this slice does not have, and
    ``cache_size``, ``inflight`` and ``drain_depth``, which belong to the
    JAX executable cache and async drain the port does not need (PyTorch
    runs eagerly).
    """

    # Admission-queue capacity: a full queue sheds with retry_after_s.
    queue_capacity: int = 64
    # Allowed batch sizes, ascending; a micro-batch pads up with zero rows.
    batch_sizes: tuple[int, ...] = (1, 2, 4)
    # Anytime iteration budget levels, descending quality.
    iter_levels: tuple[int, ...] = (24, 16, 8)
    high_water: float = 0.75
    low_water: float = 0.25
    recover_patience: int = 4
    default_deadline_s: float | None = None
    default_retry_after_s: float = 0.25
    # Round padded request shapes up to multiples of this (0 = off).
    pad_bucket: int = 0
    min_image_hw: int = 16
    max_image_hw: tuple[int, int] = (2176, 3840)

    def __post_init__(self) -> None:
        bs = tuple(int(b) for b in self.batch_sizes)
        if not bs or any(b <= 0 for b in bs) or list(bs) != sorted(set(bs)):
            raise ValueError(
                f"batch_sizes must be ascending unique positives: {bs!r}"
            )
        if self.pad_bucket and self.pad_bucket % 8:
            raise ValueError(
                f"pad_bucket {self.pad_bucket} must be a multiple of 8"
            )
        lv = tuple(int(x) for x in self.iter_levels)
        if not lv or any(x <= 0 for x in lv) or list(lv) != sorted(
            lv, reverse=True
        ) or len(set(lv)) != len(lv):
            raise ValueError(
                f"iter_levels must be strictly descending positives: {lv!r}"
            )

    @property
    def max_batch(self) -> int:
        return self.batch_sizes[-1]


def flagship_config(dataset: str = "sintel", **overrides) -> ModelConfig:
    """raft_nc_dbl with the NCUP upsampler: the configuration every
    shipped reference script trains and evaluates."""
    return ModelConfig(variant="raft_nc_dbl", dataset=dataset, **overrides)
