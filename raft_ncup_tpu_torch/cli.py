"""The command-line surface of the port's entry points, with the JAX
CLI's names (``raft_ncup_tpu/cli.py``).

:func:`add_model_args` takes every flag of the JAX package's
``add_model_args`` with the same names, types, choices and defaults
(``--model`` defaults to ``raft``), the reference's reflective upsampler
flags included (``--final_upsampling=NConvUpsampler``,
``--interp_net_*``, ``--weights_est_net_*``), so the shipped scripts'
flag lines parse as they are written. ``--corr_impl`` is left out: the
port's model always runs the hand-written kernels (``corr_impl="pallas"``,
``nconv_impl="pallas"``), on the card kernels A and B and their backward
kernels. The PAC and DJIF upsamplers raise (ROADMAP.md, queue 1 item 5).

The train entry's parser (:func:`build_train_parser`, :func:`parse_train`)
and the evaluate entry's (:func:`build_eval_parser`, :func:`parse_eval`)
take the JAX CLI's flags, with ``--device`` in place of ``--platform``.
Flags of slices the port does not have yet raise with the ROADMAP item
that brings them: the mesh (``--data_parallel``, ``--spatial_parallel``
and ``--mesh`` above one card: queue 1 item 9), ``--profile_steps``
(item 8) and ``--strict_guards`` (item 10).
"""

from __future__ import annotations

import argparse
import ast
from typing import Optional, Sequence

from raft_ncup_tpu_torch.config import (
    STAGES,
    DataConfig,
    ModelConfig,
    TrainConfig,
    UpsamplerConfig,
)
from raft_ncup_tpu_torch.precision import PRESET_NAMES


def str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def str2intlist(v: str) -> tuple[int, ...]:
    """The reference's quoted list syntax, ``"[3, 3, 1]"``."""
    out = ast.literal_eval(v)
    if not isinstance(out, (list, tuple)):
        raise argparse.ArgumentTypeError(f"int list expected, got {v!r}")
    return tuple(int(x) for x in out)


# The reference's upsampler class names and the kinds they select.
_UPSAMPLER_CLASSES = {
    "NConvUpsampler": "nconv",
    "Bilinear": "bilinear",
    "PacJointUpsampleFull": "pac",
    "DjifOriginal": "djif",
}


def add_model_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--model", default="raft",
                        help="model variant: raft (the default, as in the JAX CLI) or "
                        "raft_nc_dbl (the flagship, RAFT with NCUP)")
    parser.add_argument("--small", action="store_true",
                        help="the small model: hidden 96, context 64, fnet 128, radius 3")
    parser.add_argument("--dropout", type=float, default=0.0,
                        help="channel dropout after both encoders while training")
    parser.add_argument("--mixed_precision", action="store_true",
                        help="the legacy switch: bf16_infer unless --precision is given")
    parser.add_argument("--precision", default=None, choices=list(PRESET_NAMES),
                        help="precision preset: f32 (default), bf16_infer for serving, "
                        "bf16_train for bf16 compute with f32 master weights; "
                        "coordinates, the upsampler and the outputs stay f32. "
                        "Overrides --mixed_precision when given")
    parser.add_argument("--align_corners", action="store_true",
                        help="align_corners of the small raft model's bilinear x8 upsampling")
    parser.add_argument("--upsampler_bi", action="store_true",
                        help="bilinear final upsampling in place of NCUP (raft_nc_dbl)")
    parser.add_argument("--freeze_raft", action="store_true",
                        help="train the upsampler only, the RAFT trunk frozen")
    parser.add_argument("--load_pretrained", default=None,
                        help="warm-start the trunk from a reference .pth or a port run "
                        "directory; the upsampler stays at its initial values")
    # The reference's reflective upsampler flags.
    parser.add_argument("--final_upsampling", default="NConvUpsampler",
                        choices=sorted(_UPSAMPLER_CLASSES))
    parser.add_argument("--final_upsampling_scale", type=int, default=4)
    parser.add_argument("--final_upsampling_use_data_for_guidance", type=str2bool,
                        default=True)
    parser.add_argument("--final_upsampling_channels_to_batch", type=str2bool, default=True)
    parser.add_argument("--final_upsampling_use_residuals", type=str2bool, default=False)
    parser.add_argument("--final_upsampling_est_on_high_res", type=str2bool, default=False)
    parser.add_argument("--interp_net", default="NConvUNet", choices=["NConvUNet"])
    parser.add_argument("--interp_net_channels_multiplier", type=int, default=2)
    parser.add_argument("--interp_net_num_downsampling", type=int, default=1)
    parser.add_argument("--interp_net_data_pooling", default="conf_based",
                        choices=["conf_based", "max_pooling"])
    parser.add_argument("--interp_net_encoder_filter_sz", type=int, default=5)
    parser.add_argument("--interp_net_decoder_filter_sz", type=int, default=3)
    parser.add_argument("--interp_net_out_filter_sz", type=int, default=1)
    parser.add_argument("--interp_net_shared_encoder", type=str2bool, default=True)
    parser.add_argument("--interp_net_use_double_conv", type=str2bool, default=False)
    parser.add_argument("--interp_net_use_bias", type=str2bool, default=False)
    parser.add_argument("--interp_net_pos_fn", default="softplus")
    parser.add_argument("--weights_est_net", default="Simple", choices=["Simple", "UNet"])
    parser.add_argument("--weights_est_net_num_ch", type=str2intlist, default=(64, 32))
    parser.add_argument("--weights_est_net_filter_sz", type=str2intlist, default=(3, 3, 1))
    parser.add_argument("--weights_est_net_dilation", type=str2intlist, default=(1, 1, 1))


def upsampler_config_from_args(args: argparse.Namespace) -> UpsamplerConfig:
    """The reference's upsampler flags, field by field, as the JAX CLI maps
    them; ``--upsampler_bi`` selects the bilinear upsampler."""
    kind = "bilinear" if args.upsampler_bi else _UPSAMPLER_CLASSES[args.final_upsampling]
    if kind in ("pac", "djif"):
        raise NotImplementedError(
            f"--final_upsampling={args.final_upsampling} is not in the port yet: the PAC "
            "and DJIF upsamplers land with ROADMAP.md queue 1 item 5")
    return UpsamplerConfig(
        kind=kind,
        scale=args.final_upsampling_scale,
        use_data_for_guidance=args.final_upsampling_use_data_for_guidance,
        channels_to_batch=args.final_upsampling_channels_to_batch,
        use_residuals=args.final_upsampling_use_residuals,
        est_on_high_res=args.final_upsampling_est_on_high_res,
        channels_multiplier=args.interp_net_channels_multiplier,
        num_downsampling=args.interp_net_num_downsampling,
        encoder_filter_sz=args.interp_net_encoder_filter_sz,
        decoder_filter_sz=args.interp_net_decoder_filter_sz,
        out_filter_sz=args.interp_net_out_filter_sz,
        use_bias=args.interp_net_use_bias,
        data_pooling=args.interp_net_data_pooling,
        shared_encoder=args.interp_net_shared_encoder,
        use_double_conv=args.interp_net_use_double_conv,
        pos_fn=args.interp_net_pos_fn.lower(),
        weights_est_net=args.weights_est_net.lower(),
        weights_est_num_ch=tuple(args.weights_est_net_num_ch),
        weights_est_filter_sz=tuple(args.weights_est_net_filter_sz),
        weights_est_dilation=tuple(args.weights_est_net_dilation),
    )


def model_config_from_args(args: argparse.Namespace, dataset: str) -> ModelConfig:
    """The model configuration the flags select. ``dataset`` decides
    BatchNorm in NCUP's weights net: the training stage, or ``sintel``
    when serving. An explicit ``--precision`` (``f32`` included) wins over
    ``--mixed_precision``; only without it does the bool map to
    ``bf16_infer``."""
    return ModelConfig(
        variant=args.model, small=args.small, dropout=args.dropout,
        align_corners=args.align_corners,
        precision=args.precision or "f32",
        mixed_precision=args.mixed_precision and args.precision is None,
        corr_impl="pallas", nconv_impl="pallas", dataset=dataset,
        freeze_raft=args.freeze_raft, upsampler=upsampler_config_from_args(args),
    )


def add_data_args(parser: argparse.ArgumentParser) -> None:
    """The ``DataConfig`` flags, with the JAX CLI's names."""
    d = DataConfig()
    parser.add_argument("--root_chairs", default=d.root_chairs)
    parser.add_argument("--root_things", default=d.root_things)
    parser.add_argument("--root_sintel", default=d.root_sintel)
    parser.add_argument("--root_kitti", default=d.root_kitti)
    parser.add_argument("--root_hd1k", default=d.root_hd1k)
    parser.add_argument("--chairs_split_file", default=d.chairs_split_file)
    parser.add_argument("--compressed_ft", action="store_true",
                        help="FlyingThings3D's webp frames and npz flows (the port has "
                        "no webp decoder yet: reading a frame raises)")
    parser.add_argument("--num_workers", type=int, default=4,
                        help="threads decoding and augmenting samples ahead")
    parser.add_argument("--device_prefetch", type=int, default=d.device_prefetch,
                        help="batches staged and copied to the card ahead of compute")
    parser.add_argument("--io_retries", type=int, default=d.io_retries,
                        help="retries of a failed dataset read, with doubling backoff, "
                        "before the sample is quarantined")
    parser.add_argument("--eval_cache_size", type=int, default=d.eval_cache_size,
                        help="bound on the cached per-shape CUDA graphs (LRU)")
    parser.add_argument("--eval_pad_bucket", type=int, default=d.eval_pad_bucket,
                        help="round padded KITTI shapes up to multiples of this (0 = off)")
    parser.add_argument("--synthetic_ok", action="store_true",
                        help="train on procedural pairs when no dataset is on disk")
    parser.add_argument("--synthetic_style", default=d.synthetic_style,
                        choices=["smooth", "rigid"])


def data_config_from_args(args: argparse.Namespace) -> DataConfig:
    return DataConfig(
        root_chairs=args.root_chairs, root_things=args.root_things,
        root_sintel=args.root_sintel, root_kitti=args.root_kitti,
        root_hd1k=args.root_hd1k, chairs_split_file=args.chairs_split_file,
        compressed_ft=args.compressed_ft, num_workers=args.num_workers,
        device_prefetch=args.device_prefetch, io_retries=args.io_retries,
        eval_cache_size=args.eval_cache_size, eval_pad_bucket=args.eval_pad_bucket,
        synthetic_ok=args.synthetic_ok, synthetic_style=args.synthetic_style,
    )


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default=None,
                        help="torch device (default: the current CUDA device)")


def _refuse_mesh(sizes: Sequence[Optional[int]]) -> None:
    if any(n is not None and n > 1 for n in sizes):
        raise ValueError(
            "--data_parallel, --spatial_parallel and --mesh above one card are not in the "
            "port yet: they land with its multi-GPU slice (ROADMAP.md, queue 1 item 9)")


# ------------------------------------------------------------------ train


def add_train_args(parser: argparse.ArgumentParser) -> None:
    d = TrainConfig()
    parser.add_argument("--name", default=d.name)
    parser.add_argument("--stage", required=True, choices=list(STAGES))
    parser.add_argument("--restore_ckpt", default=None,
                        help="a run directory (its latest step_<N>.pt) or one such file")
    parser.add_argument("--validation", type=str, nargs="+", default=[])
    parser.add_argument("--lr", type=float, default=d.lr)
    parser.add_argument("--num_steps", type=int, default=d.num_steps)
    parser.add_argument("--batch_size", type=int, default=d.batch_size)
    parser.add_argument("--image_size", type=int, nargs="+", default=list(d.image_size))
    parser.add_argument("--gpus", type=int, nargs="+", default=None,
                        help="accepted for the reference scripts; ignored")
    parser.add_argument("--iters", type=int, default=d.iters)
    parser.add_argument("--wdecay", type=float, default=d.wdecay)
    parser.add_argument("--epsilon", type=float, default=d.epsilon)
    parser.add_argument("--clip", type=float, default=d.clip)
    parser.add_argument("--add_noise", action="store_true")
    parser.add_argument("--gamma", type=float, default=d.gamma)
    parser.add_argument("--optimizer", default=d.optimizer, type=str.lower)
    parser.add_argument("--scheduler", default=d.scheduler)
    parser.add_argument("--scheduler_step", type=int, default=d.scheduler_step)
    parser.add_argument("--val_freq", type=int, default=d.val_freq)
    parser.add_argument("--sum_freq", type=int, default=d.sum_freq)
    parser.add_argument("--seed", type=int, default=d.seed)
    parser.add_argument("--checkpoint_dir", default=d.checkpoint_dir)
    parser.add_argument("--data_parallel", type=int, default=None,
                        help="data-parallel cards (above 1: not in the port yet)")
    parser.add_argument("--spatial_parallel", type=int, default=1,
                        help="spatial cards (above 1: not in the port yet)")
    parser.add_argument("--profile_steps", type=int, default=0,
                        help="trace early steps (not in the port yet: ROADMAP queue 1 item 8)")
    parser.add_argument("--strict_guards", action="store_true",
                        help="live sync and recompile guards (not in the port yet: "
                        "ROADMAP queue 1 item 10)")
    parser.add_argument("--anomaly_sentinel", type=str2bool, default=d.anomaly_sentinel,
                        help="skip-update steps with a non-finite loss or gradient, or a "
                        "gradient-norm spike; K consecutive bad steps halt the run")
    parser.add_argument("--sentinel_spike_factor", type=float,
                        default=d.sentinel_spike_factor,
                        help="a gradient norm above this multiple of its average is bad")
    parser.add_argument("--sentinel_ema_decay", type=float, default=d.sentinel_ema_decay)
    parser.add_argument("--sentinel_warmup", type=int, default=d.sentinel_warmup,
                        help="good steps before spike detection arms")
    parser.add_argument("--sentinel_halt_after", type=int, default=d.sentinel_halt_after,
                        help="consecutive bad steps that halt the run (exit 76, rolled "
                        "back to the latest checkpoint)")
    parser.add_argument("--chaos", default=None,
                        help="fault injection: comma-joined nan@STEP, ioerror@READ, "
                        "sigterm@STEP (resilience/chaos.py)")


def build_train_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train RAFT / RAFT-NCUP on the card")
    add_train_args(parser)
    add_model_args(parser)
    add_data_args(parser)
    add_device_arg(parser)
    return parser


def train_config_from_args(args: argparse.Namespace) -> TrainConfig:
    """The train configuration the flags select; its ``precision`` is the
    model flags' resolved preset (``--mixed_precision`` alone gives
    ``bf16_infer``)."""
    size = args.image_size
    return TrainConfig(
        name=args.name, stage=args.stage, lr=args.lr, num_steps=args.num_steps,
        batch_size=args.batch_size, image_size=(size[0], size[1]), iters=args.iters,
        wdecay=args.wdecay, epsilon=args.epsilon, clip=args.clip, gamma=args.gamma,
        optimizer=args.optimizer, scheduler=args.scheduler,
        scheduler_step=args.scheduler_step, add_noise=args.add_noise,
        validation=tuple(args.validation), val_freq=args.val_freq,
        sum_freq=args.sum_freq, seed=args.seed, restore_ckpt=args.restore_ckpt,
        load_pretrained=args.load_pretrained, checkpoint_dir=args.checkpoint_dir,
        anomaly_sentinel=args.anomaly_sentinel,
        sentinel_spike_factor=args.sentinel_spike_factor,
        sentinel_ema_decay=args.sentinel_ema_decay,
        sentinel_warmup=args.sentinel_warmup,
        sentinel_halt_after=args.sentinel_halt_after,
        precision=model_config_from_args(args, args.stage).precision_policy.name,
    )


def parse_train(argv: Optional[Sequence[str]] = None):
    """``(args, model_cfg, train_cfg, data_cfg)`` of the train entry, as
    the JAX CLI's ``parse_train`` returns them."""
    args = build_train_parser().parse_args(argv)
    _refuse_mesh((args.data_parallel, args.spatial_parallel))
    if args.profile_steps:
        raise ValueError("--profile_steps is not in the port yet: tracing lands with "
                         "its telemetry slice (ROADMAP.md, queue 1 item 8)")
    if args.strict_guards:
        raise ValueError("--strict_guards is not in the port yet: it lands with the "
                         "analysis slice (ROADMAP.md, queue 1 item 10)")
    model_cfg = model_config_from_args(args, dataset=args.stage)
    return args, model_cfg, train_config_from_args(args), data_config_from_args(args)


# --------------------------------------------------------------- evaluate


EVAL_DATASETS = ("chairs", "sintel", "sintel_warm", "kitti", "synthetic", "synthetic_rigid")


def build_eval_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Evaluate RAFT / RAFT-NCUP on the card")
    parser.add_argument("--restore_ckpt", default=None,
                        help="a port train state (step_<N>.pt or its run directory) or a "
                        "reference .pth; loaded strictly. Without it, weights from --seed")
    parser.add_argument("--dataset", required=True, choices=list(EVAL_DATASETS))
    parser.add_argument("--submission", action="store_true",
                        help="write leaderboard files instead of validating (sintel, kitti)")
    parser.add_argument("--warm_start", action="store_true",
                        help="submission: warm-start each Sintel sequence from the splat "
                        "of the previous frame's flow (validator: --dataset sintel_warm)")
    parser.add_argument("--write_png", action="store_true")
    parser.add_argument("--output_path", default=None)
    parser.add_argument("--export_pth", default=None, metavar="PATH",
                        help="write the loaded weights as a reference-keyed .pth and exit")
    parser.add_argument("--spatial_parallel", type=int, default=1,
                        help="shard the height over this many cards (not in the port yet)")
    parser.add_argument("--mesh", default=None, metavar="DATA,SPATIAL",
                        help="a (data, spatial) mesh of cards (not in the port yet)")
    parser.add_argument("--iters", type=int, default=None,
                        help="GRU iterations; default each validator's own (sintel 32, "
                        "chairs and kitti 24, synthetic 12)")
    parser.add_argument("--batch_size", type=int, default=None,
                        help="validation batch size; default each validator's own")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the model weights when no checkpoint is given")
    add_device_arg(parser)
    add_model_args(parser)
    add_data_args(parser)
    return parser


def parse_eval(argv: Optional[Sequence[str]] = None):
    """``(args, model_cfg, data_cfg)`` of the evaluate entry. The dataset
    decides BatchNorm in NCUP's weights net, as in the JAX CLI."""
    args = build_eval_parser().parse_args(argv)
    mesh = tuple(int(x) for x in args.mesh.split(",")) if args.mesh else (1, 1)
    _refuse_mesh((args.spatial_parallel, *mesh))
    dataset = "sintel" if args.dataset.startswith("sintel") else args.dataset
    return args, model_config_from_args(args, dataset=dataset), data_config_from_args(args)
