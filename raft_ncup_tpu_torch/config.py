"""Typed, immutable configuration for the port's model, server and trainer.

The port's own copy of ``raft_ncup_tpu/config.py``'s ``UpsamplerConfig``,
``ModelConfig``, ``ServeConfig``, ``TrainConfig`` and ``flagship_config``
(the port imports nothing of the JAX package). Field names and defaults
are the JAX package's, so one configuration means the same in both
packages, with these differences:

- Settings of later slices raise here rather than being ignored: the
  ``pac`` and ``djif`` upsampler kinds (the PAC slice).
- ``ModelConfig.nconv_impl`` carries the normalized-convolution switch
  that the JAX package reads from its ``RAFT_NCUP_NCONV_IMPL`` knob:
  ``"xla"`` (plain composition of two convolutions) or ``"pallas"``
  (the fused kernel, CUDA in the port). Its default is the JAX default.
- ``ServeConfig`` has no ``mesh`` (one card).
- ``TrainConfig`` has no ``data_parallel``/``spatial_parallel`` (the
  mesh: one card).

Precision (``precision/policy.py``): ``ModelConfig.precision`` names a
preset (``f32``, ``bf16_infer``, ``bf16_train``); the legacy
``mixed_precision`` bool alone resolves to ``bf16_infer``, and an explicit
preset wins (``ModelConfig.precision_policy``). Under f32 the model's
forward keeps TF32 off (``utils.device.f32_precision``), so f32 means f32
on the card too.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

from raft_ncup_tpu_torch.precision import PrecisionPolicy, resolve_policy

CORR_IMPLS = ("volume", "onthefly", "pallas")
STAGES = ("chairs", "things", "sintel", "kitti")
NCONV_IMPLS = ("xla", "pallas")
UPSAMPLER_KINDS = ("nconv", "bilinear")
WEIGHTS_EST_NETS = ("simple", "unet", "binary")


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

    def __post_init__(self) -> None:
        if self.kind in ("pac", "djif"):
            raise NotImplementedError(
                f"upsampler kind {self.kind!r} lands with the PAC slice of the port"
            )
        if self.kind not in UPSAMPLER_KINDS:
            raise ValueError(f"unknown upsampler kind: {self.kind!r}")
        if self.weights_est_net not in WEIGHTS_EST_NETS:
            raise ValueError(f"unknown weights_est_net: {self.weights_est_net!r}")


@dataclass(frozen=True)
class ModelConfig:
    """Model architecture configuration ('raft' | 'raft_nc_dbl')."""

    variant: str = "raft_nc_dbl"
    small: bool = False
    dropout: float = 0.0
    # Precision preset: 'f32' | 'bf16_infer' | 'bf16_train'.
    precision: str = "f32"
    # Legacy bool: True with the default precision resolves to
    # 'bf16_infer'; an explicit preset wins.
    mixed_precision: bool = False
    # align_corners of the bilinear x8 upsampling of the small model's
    # flow (``ops.geometry.upflow``).
    align_corners: bool = True
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
    # Train only the upsampler, the RAFT trunk frozen.
    freeze_raft: bool = False
    upsampler: UpsamplerConfig = field(default_factory=UpsamplerConfig)

    def __post_init__(self) -> None:
        if self.variant not in ("raft", "raft_nc_dbl"):
            raise ValueError(f"unknown model variant: {self.variant!r}")
        resolve_policy(self.precision)  # raises on an unknown preset
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1): {self.dropout!r}")
        if self.corr_impl not in CORR_IMPLS:
            raise ValueError(f"unknown corr_impl: {self.corr_impl!r}")
        if self.nconv_impl not in NCONV_IMPLS:
            raise ValueError(f"unknown nconv_impl: {self.nconv_impl!r}")

    @property
    def precision_policy(self) -> PrecisionPolicy:
        """The resolved policy: the legacy ``mixed_precision`` bool maps
        onto 'bf16_infer' when no explicit preset was chosen."""
        if self.precision == "f32" and self.mixed_precision:
            return resolve_policy("bf16_infer")
        return resolve_policy(self.precision)

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
    ``mesh``, which the port does not have, and ``inflight`` and
    ``drain_depth``, which belong to the JAX dispatch throttle and async
    drain the server does not use (it waits for each batch's result).
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
    # The precision preset the server's forwards run under; None inherits
    # the model's own policy.
    precision: str | None = None
    # Bound on the cached CUDA graphs (LRU), one per (padded shape, batch
    # size, iteration level): at least their product for one shape.
    cache_size: int = 16

    def __post_init__(self) -> None:
        if self.precision is not None:
            resolve_policy(self.precision)  # raises on an unknown preset
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
    # Ground truth at least this large (pixels) is left out of the loss.
    max_flow: float = 400.0
    optimizer: str = "adamw"  # 'adamw' | 'adam'
    scheduler: str = "cyclic"  # 'cyclic' (OneCycle-linear) | 'step'
    scheduler_step: int = 20_000
    # Gaussian noise on both frames, its stddev drawn from U(0, 5) per step.
    add_noise: bool = False
    # Validators (``evaluation.VALIDATORS``) run every ``val_freq`` steps.
    validation: tuple[str, ...] = ()
    val_freq: int = 5000
    sum_freq: int = 100
    seed: int = 1234
    restore_ckpt: str | None = None
    # A reference .pth or a port run directory whose trunk warm-starts the model.
    load_pretrained: str | None = None
    checkpoint_dir: str = "checkpoints"
    # The divergence sentinel (``training/sentinel.py``): a step with a
    # non-finite loss or gradient norm, or a norm above
    # ``sentinel_spike_factor`` times its average (armed after
    # ``sentinel_warmup`` good steps), keeps the old state; the trainer halts
    # and rolls back after ``sentinel_halt_after`` bad steps in a row.
    anomaly_sentinel: bool = True
    sentinel_spike_factor: float = 20.0
    sentinel_ema_decay: float = 0.99
    sentinel_warmup: int = 10
    sentinel_halt_after: int = 10
    # Training precision preset: 'f32' or 'bf16_train' (bf16 compute, f32
    # master weights). It names the model's resolved preset: the train
    # entry derives it from the model's flags (or a resumed checkpoint),
    # and a train state raises when the two differ.
    precision: str = "f32"

    def __post_init__(self) -> None:
        resolve_policy(self.precision)  # raises on an unknown preset
        if self.stage not in STAGES:
            raise ValueError(f"unknown stage: {self.stage!r}")
        if self.optimizer.lower() not in ("adamw", "adam"):
            raise NotImplementedError(f"{self.optimizer} optimizer is not implemented!")
        if self.scheduler.lower() not in ("cyclic", "step"):
            raise NotImplementedError(f"{self.scheduler} scheduler is not implemented!")
        if self.val_freq < 1 or self.sum_freq < 1:
            raise ValueError("val_freq and sum_freq must be positive")

    @property
    def freeze_bn(self) -> bool:
        # Every stage but chairs keeps BatchNorm in eval mode.
        return self.stage != "chairs"

    @property
    def total_schedule_steps(self) -> int:
        # OneCycle over num_steps + 100, as the reference configures it.
        return self.num_steps + 100


@dataclass(frozen=True)
class DataConfig:
    """Dataset roots and the evaluation pipeline's settings; names and
    defaults are the JAX package's ``DataConfig``."""

    root_chairs: str = "datasets/FlyingChairs_release/data"
    root_things: str = "datasets/FlyingThings3D"
    root_sintel: str = "datasets/Sintel"
    root_kitti: str = "datasets/KITTI"
    root_hd1k: str = "datasets/HD1k"
    chairs_split_file: str = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "data", "chairs_split.txt")
    # FlyingThings3D's webp frames and npz flows.
    compressed_ft: bool = False
    num_workers: int = 2
    # Ready host batches the loader queues ahead of the trainer.
    prefetch: int = 2
    # Batches staged and copied to the card ahead of compute.
    device_prefetch: int = 2
    # A failed dataset read retries this many times, its delay doubling
    # from io_retry_backoff_s, before the sample is quarantined.
    io_retries: int = 3
    io_retry_backoff_s: float = 0.05
    # Bound on the cached per-shape CUDA graphs (LRU); each distinct
    # (padded shape, iterations, metric kind) captures once.
    eval_cache_size: int = 8
    # Round padded eval shapes up to multiples of this (0 = off); KITTI.
    eval_pad_bucket: int = 0
    # Train on procedural pairs when no dataset is on disk.
    synthetic_ok: bool = False
    synthetic_style: str = "smooth"  # 'smooth' | 'rigid'

    def __post_init__(self) -> None:
        if self.synthetic_style not in ("smooth", "rigid"):
            raise ValueError(f"unknown synthetic style: {self.synthetic_style!r}")
        if self.eval_pad_bucket % 8:
            raise ValueError(f"eval_pad_bucket {self.eval_pad_bucket} must be a multiple of 8")


def small_model_config(variant: str = "raft", **overrides) -> ModelConfig:
    """The RAFT-small preset: hidden 96, context 64, fnet 128, radius 3."""
    return ModelConfig(variant=variant, small=True, **overrides)


def flagship_config(dataset: str = "sintel", **overrides) -> ModelConfig:
    """raft_nc_dbl with the NCUP upsampler: the configuration every
    shipped reference script trains and evaluates."""
    return ModelConfig(variant="raft_nc_dbl", dataset=dataset, **overrides)
