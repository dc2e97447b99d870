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
kernels. ``--final_upsampling PacJointUpsampleFull | DjifOriginal`` selects
the PAC or DJIF head (``nn/pac.py``), as the JAX CLI does.

The serve entry's serving and streaming knobs (:func:`add_serve_args`,
:func:`add_stream_args`) take the JAX CLI's names and defaults.

The train entry's parser (:func:`build_train_parser`, :func:`parse_train`)
and the evaluate entry's (:func:`build_eval_parser`, :func:`parse_eval`)
take the JAX CLI's flags, with ``--device`` in place of ``--platform``.
The mesh flags name the axes across processes, one per card
(``parallel/``). The train entry takes ``--data_parallel D`` when D is the
world size the launcher started over the spatial size (``torchrun
--nproc_per_node D``; 1 without one), its default, and ``--mesh D,S`` (or
``--spatial_parallel S``) when D times S is the world size: S ranks split
each training image by rows. The evaluate entry takes ``--mesh D,S``
(or ``--spatial_parallel S`` for ``1,S``) when D times S is the world
size: S ranks split each forward by image rows; so does the serve entry
(``--mesh D,S``, which :func:`serve_config_from_args` and
:func:`stream_config_from_args` carry into the configurations). The
evaluate and serve entries also take ``--mesh D,S,P`` over D times S times
P ranks: each pipe index runs the ``(D, S)`` forward on the same batch (JAX
replicates it over ``pipe``), and the train entry refuses a pipe size above
1. Any other size raises.
"""

from __future__ import annotations

import argparse
import ast
from typing import Optional, Sequence

from raft_ncup_tpu_torch.config import (
    STAGES,
    DataConfig,
    ModelConfig,
    ServeConfig,
    StreamConfig,
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


def str2ints(v: str) -> tuple[int, ...]:
    """A bare comma list, ``"24,16,8"`` (the serving flags)."""
    try:
        return tuple(int(x) for x in v.split(","))
    except ValueError:
        raise argparse.ArgumentTypeError(f"comma-joined ints expected: {v!r}")


# The reference's upsampler class names and the kinds they select.
UPSAMPLER_CLASSES = {
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
                        choices=sorted(UPSAMPLER_CLASSES))
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
    kind = "bilinear" if args.upsampler_bi else UPSAMPLER_CLASSES[args.final_upsampling]
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
                        help="FlyingThings3D's WebP frames (frames_*_webp) and npz flows, "
                        "decoded on the host by the port's C++ WebP decoder")
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


def check_mesh(data: Optional[int], spatial: int = 1, pipe: int = 1) -> int:
    """The data-parallel size the mesh flags ask for: ``parallel.mesh``'s
    rule (:func:`~raft_ncup_tpu_torch.parallel.mesh.check_axes`) against
    the world this process runs in or is about to join."""
    from raft_ncup_tpu_torch.parallel.mesh import check_axes
    from raft_ncup_tpu_torch.parallel.multihost import world_size_hint

    return check_axes(data, spatial, pipe, world_size_hint())


def str2mesh(v: str) -> tuple[int, ...]:
    """The ``--mesh DATA,SPATIAL[,PIPE]`` spec (the JAX CLI's)."""
    out = str2ints(v)
    if len(out) not in (2, 3) or any(x < 1 for x in out):
        raise argparse.ArgumentTypeError(
            f"mesh spec must be DATA,SPATIAL[,PIPE] positive sizes: {v!r}")
    return out


# ------------------------------------------------------------------ serve


def add_serve_args(parser: argparse.ArgumentParser) -> None:
    """The request server's knobs (``ServeConfig``)."""
    d = ServeConfig()
    parser.add_argument("--queue_capacity", type=int, default=d.queue_capacity,
                        help="bounded admission queue; a full queue sheds with a "
                        "retry-after hint")
    parser.add_argument("--serve_batch_sizes", type=str2ints, default=d.batch_sizes,
                        help="allowed micro-batch sizes, ascending (e.g. '1,2,4'); a batch "
                        "pads up to the nearest")
    parser.add_argument("--iter_levels", type=str2ints, default=d.iter_levels,
                        help="anytime GRU iteration levels, descending (e.g. '24,16,8')")
    parser.add_argument("--high_water", type=float, default=d.high_water,
                        help="queue occupancy that degrades the budget one level")
    parser.add_argument("--low_water", type=float, default=d.low_water,
                        help="occupancy counting toward the budget's recovery")
    parser.add_argument("--recover_patience", type=int, default=d.recover_patience,
                        help="consecutive calm decisions before the budget recovers a level")
    parser.add_argument("--deadline_s", type=float, default=d.default_deadline_s,
                        help="default per-request deadline in seconds (unset: none)")
    parser.add_argument("--serve_pad_bucket", type=int, default=d.pad_bucket,
                        help="round padded request shapes up to multiples of this (0: off)")
    parser.add_argument("--serve_cache_size", type=int, default=d.cache_size,
                        help="bound of the cached CUDA graphs (LRU)")
    parser.add_argument("--serve_precision", default=d.precision,
                        choices=list(PRESET_NAMES),
                        help="precision preset the server's forwards run under "
                        "(default: the model's own, from --precision)")


def serve_config_from_args(args: argparse.Namespace) -> ServeConfig:
    return ServeConfig(
        queue_capacity=args.queue_capacity,
        batch_sizes=tuple(args.serve_batch_sizes),
        iter_levels=tuple(args.iter_levels),
        high_water=args.high_water,
        low_water=args.low_water,
        recover_patience=args.recover_patience,
        default_deadline_s=args.deadline_s,
        pad_bucket=args.serve_pad_bucket,
        cache_size=args.serve_cache_size,
        precision=args.serve_precision,
        mesh=getattr(args, "mesh", None),
    )


def add_stream_args(parser: argparse.ArgumentParser) -> None:
    """The stream engine's knobs (``StreamConfig``)."""
    d = StreamConfig()
    parser.add_argument("--stream_capacity", type=int, default=d.capacity,
                        help="slot-table size, the bound on concurrent streams; admission "
                        "beyond it sheds with a retry hint")
    parser.add_argument("--stream_batch_sizes", type=str2ints, default=d.batch_sizes,
                        help="allowed step batch sizes, ascending; one graph each, "
                        "captured at warm-up")
    parser.add_argument("--stream_iters", type=int, default=d.iters,
                        help="GRU iterations per frame")
    parser.add_argument("--stream_queue_capacity", type=int, default=d.queue_capacity,
                        help="bounded frame admission queue (frames, all streams)")
    parser.add_argument("--max_frame_gap", type=int, default=d.max_frame_gap,
                        help="frame-index gap beyond which the warm state is stale and "
                        "the frame starts cold")
    parser.add_argument("--idle_timeout_s", type=float, default=d.idle_timeout_s,
                        help="idle or abandoned streams lose their slot after this long "
                        "with nothing in flight")
    parser.add_argument("--carry_net", type=str2bool, nargs="?", const=True,
                        default=d.carry_net,
                        help="also carry the GRU state across frames (an extension of the "
                        "reference's flow-only warm start)")
    parser.add_argument("--anomaly_max_flow", type=float, default=d.anomaly_max_flow,
                        help="a low-res flow beyond this resets its stream to a cold start")
    parser.add_argument("--stream_pad_bucket", type=int, default=d.pad_bucket,
                        help="round padded frame shapes up to multiples of this (0: off)")
    parser.add_argument("--stream_precision", default=d.precision,
                        choices=list(PRESET_NAMES),
                        help="precision preset of the engine's forwards and of the slot "
                        "table's state (default: the model's own)")


def stream_config_from_args(args: argparse.Namespace, frame_hw: tuple[int, int]) -> StreamConfig:
    return StreamConfig(
        capacity=args.stream_capacity,
        frame_hw=tuple(frame_hw),
        pad_bucket=args.stream_pad_bucket,
        iters=args.stream_iters,
        batch_sizes=tuple(args.stream_batch_sizes),
        queue_capacity=args.stream_queue_capacity,
        max_frame_gap=args.max_frame_gap,
        idle_timeout_s=args.idle_timeout_s,
        carry_net=args.carry_net,
        anomaly_max_flow=args.anomaly_max_flow,
        precision=args.stream_precision,
        mesh=getattr(args, "mesh", None),
    )


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
                        help="data-parallel processes, one per card (default and only "
                        "value: the launcher's world size); --batch_size is the global "
                        "batch, split across them")
    parser.add_argument("--spatial_parallel", type=int, default=1,
                        help="split each training image's rows over this many cards "
                        "(the mesh D,S with D the world over S)")
    parser.add_argument("--mesh", type=str2mesh, default=None, metavar="DATA,SPATIAL[,PIPE]",
                        help="the mesh: DATA x SPATIAL processes, one per card; each data "
                        "index trains on its rows of the global batch, its SPATIAL ranks "
                        "split each image by rows (DATA x SPATIAL must be the launcher's "
                        "world size; PIPE above 1 is not in the port yet)")
    parser.add_argument("--profile_steps", type=int, default=0,
                        help="trace this many steps after the first with torch.profiler "
                        "into <checkpoint_dir>/<name>/profile (a Chrome trace)")
    parser.add_argument("--strict_guards", action="store_true",
                        help="run each step under the runtime guards (analysis/guards.py): "
                        "an implicit host read raises, a recompile after warm-up fails "
                        "the run")
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
    parser.add_argument("--chaos_rank", type=int, default=None,
                        help="the data-parallel rank whose process --chaos acts on "
                        "(default: every rank)")


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
    data, spatial = train_mesh_axes(args)
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
        data_parallel=data, spatial_parallel=spatial,
    )


def train_mesh_axes(args: argparse.Namespace) -> tuple[int, int]:
    """The train entry's ``(data, spatial)`` sizes: ``--mesh`` or
    ``--data_parallel`` and ``--spatial_parallel``, against the world."""
    from raft_ncup_tpu_torch.parallel.mesh import check_no_pipe

    mesh = args.mesh or (args.data_parallel, 1)
    spatial = max(mesh[1], args.spatial_parallel)
    check_no_pipe(mesh[2] if len(mesh) > 2 else 1, "train")
    return check_mesh(mesh[0], spatial, 1), spatial


def parse_train(argv: Optional[Sequence[str]] = None):
    """``(args, model_cfg, train_cfg, data_cfg)`` of the train entry, as
    the JAX CLI's ``parse_train`` returns them."""
    args = build_train_parser().parse_args(argv)
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
                        help="split each forward's image height over this many cards "
                        "(the mesh 1,N)")
    parser.add_argument("--mesh", type=str2mesh, default=None, metavar="DATA,SPATIAL[,PIPE]",
                        help="the mesh: DATA x SPATIAL processes, one per card; each data "
                        "index validates its share of the frames, its SPATIAL ranks split "
                        "each forward by image rows (DATA x SPATIAL must be the launcher's "
                        "world size; PIPE above 1 is not in the port yet)")
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
    decides BatchNorm in NCUP's weights net, as in the JAX CLI. The mesh
    the flags resolve to is ``args.mesh_axes``, ``(data, spatial)``, and
    ``args.mesh_pipe``, the pipe size."""
    args = build_eval_parser().parse_args(argv)
    mesh = args.mesh or (None, 1)
    spatial = max(mesh[1], args.spatial_parallel)
    pipe = mesh[2] if len(mesh) > 2 else 1
    data = check_mesh(mesh[0], spatial, pipe)
    args.mesh_axes, args.mesh_pipe = (data, spatial), pipe
    dataset = "sintel" if args.dataset.startswith("sintel") else args.dataset
    return args, model_config_from_args(args, dataset=dataset), data_config_from_args(args)
