"""Typed, immutable configuration for the port's model, server and trainer.

The port's own copy of ``raft_ncup_tpu/config.py``'s ``UpsamplerConfig``,
``ModelConfig``, ``ServeConfig``, ``TrainConfig`` and ``flagship_config``
(the port imports nothing of the JAX package). Field names and defaults
are the JAX package's, so one configuration means the same in both
packages, with these differences of this slice:

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
- ``TrainConfig`` holds only the fields the port's trainer reads: no
  ``validation``/``val_freq`` (validation during training), ``add_noise``,
  ``load_pretrained``, ``data_parallel``/``spatial_parallel`` (the mesh),
  ``sentinel_halt_after`` (the halt-and-rollback policy) or ``precision``;
  they return with the slices that read them. The divergence sentinel
  always runs, so there is no ``anomaly_sentinel`` switch, and its spike
  factor, EMA decay and warm-up (``training/sentinel.py``) and the loss's
  ``max_flow`` (``training/loss.py``) are constants at the JAX defaults,
  since no flag of the JAX CLI that the port takes sets them. It carries
  ``synthetic_style``, a field of the JAX package's ``DataConfig``: the
  port trains on synthetic pairs only, so it needs no ``DataConfig`` yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

CORR_IMPLS = ("volume", "onthefly", "pallas")
STAGES = ("chairs", "things", "sintel", "kitti")
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


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters; names and defaults are the JAX package's
    ``TrainConfig`` (the reference's train.py defaults)."""

    name: str = "raft"
    stage: str = "chairs"  # 'chairs' (BatchNorm trains) | 'things' | 'sintel' | 'kitti'
    lr: float = 2e-5
    num_steps: int = 100_000
    batch_size: int = 6
    image_size: tuple[int, int] = (384, 512)
    iters: int = 12
    wdecay: float = 5e-5
    epsilon: float = 1e-8
    clip: float = 1.0
    gamma: float = 0.8
    optimizer: str = "adamw"  # 'adamw' | 'adam'
    scheduler: str = "cyclic"  # 'cyclic' (OneCycle-linear) | 'step'
    scheduler_step: int = 20_000
    sum_freq: int = 100
    seed: int = 1234
    restore_ckpt: str | None = None
    checkpoint_dir: str = "checkpoints"
    synthetic_style: str = "smooth"  # 'smooth' | 'rigid'

    def __post_init__(self) -> None:
        if self.stage not in STAGES:
            raise ValueError(f"unknown stage: {self.stage!r}")
        if self.optimizer.lower() not in ("adamw", "adam"):
            raise NotImplementedError(f"{self.optimizer} optimizer is not implemented!")
        if self.scheduler.lower() not in ("cyclic", "step"):
            raise NotImplementedError(f"{self.scheduler} scheduler is not implemented!")
        if self.synthetic_style not in ("smooth", "rigid"):
            raise ValueError(f"unknown synthetic style: {self.synthetic_style!r}")

    @property
    def freeze_bn(self) -> bool:
        # Every stage but chairs keeps BatchNorm in eval mode.
        return self.stage != "chairs"

    @property
    def total_schedule_steps(self) -> int:
        # OneCycle over num_steps + 100, as the reference configures it.
        return self.num_steps + 100


def flagship_config(dataset: str = "sintel", **overrides) -> ModelConfig:
    """raft_nc_dbl with the NCUP upsampler: the configuration every
    shipped reference script trains and evaluates."""
    return ModelConfig(variant="raft_nc_dbl", dataset=dataset, **overrides)
