"""The model flags the serve, train, evaluate and demo entry points
share, with the JAX CLI's names (``raft_ncup_tpu/cli.py``'s
``add_model_args``) for what the port runs: ``--model``, ``--small``,
``--align_corners``, ``--upsampler_bi``, ``--precision`` and
``--mixed_precision``. The model always takes both hand-written kernels
(``corr_impl="pallas"``, ``nconv_impl="pallas"``); f32 is the default.

The evaluate entry's parser (:func:`build_eval_parser`,
:func:`parse_eval`) takes the JAX eval CLI's flags, with ``--device`` in
place of ``--platform``; ``--spatial_parallel`` and ``--mesh`` above one
card raise."""

from __future__ import annotations

import argparse

from typing import Optional, Sequence

from raft_ncup_tpu_torch.config import DataConfig, ModelConfig, UpsamplerConfig
from raft_ncup_tpu_torch.precision import PRESET_NAMES


def add_model_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--model", default="raft_nc_dbl", choices=["raft", "raft_nc_dbl"],
                        help="model variant (default raft_nc_dbl, the flagship)")
    parser.add_argument("--small", action="store_true",
                        help="the small model: hidden 96, context 64, fnet 128, radius 3")
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


def model_config_from_args(args: argparse.Namespace, dataset: str) -> ModelConfig:
    """The model configuration the flags select. ``dataset`` decides
    BatchNorm in NCUP's weights net: the training stage, or ``sintel``
    when serving. An explicit ``--precision`` (``f32`` included) wins over
    ``--mixed_precision``; only without it does the bool map to
    ``bf16_infer``."""
    return ModelConfig(
        variant=args.model, small=args.small, align_corners=args.align_corners,
        precision=args.precision or "f32",
        mixed_precision=args.mixed_precision and args.precision is None,
        corr_impl="pallas", nconv_impl="pallas", dataset=dataset,
        upsampler=UpsamplerConfig(kind="bilinear" if args.upsampler_bi else "nconv"),
    )


def add_data_args(parser: argparse.ArgumentParser) -> None:
    """The ``DataConfig`` fields the validators read, with the JAX CLI's
    names."""
    d = DataConfig()
    parser.add_argument("--root_chairs", default=d.root_chairs)
    parser.add_argument("--root_sintel", default=d.root_sintel)
    parser.add_argument("--root_kitti", default=d.root_kitti)
    parser.add_argument("--chairs_split_file", default=d.chairs_split_file)
    parser.add_argument("--num_workers", type=int, default=4,
                        help="threads decoding samples ahead")
    parser.add_argument("--device_prefetch", type=int, default=d.device_prefetch,
                        help="batches staged and copied to the card ahead of compute")
    parser.add_argument("--eval_cache_size", type=int, default=d.eval_cache_size,
                        help="bound on the cached per-shape CUDA graphs (LRU)")
    parser.add_argument("--eval_pad_bucket", type=int, default=d.eval_pad_bucket,
                        help="round padded KITTI shapes up to multiples of this (0 = off)")
    parser.add_argument("--synthetic_style", default=d.synthetic_style,
                        choices=["smooth", "rigid"])


def data_config_from_args(args: argparse.Namespace) -> DataConfig:
    return DataConfig(
        root_chairs=args.root_chairs, root_sintel=args.root_sintel,
        root_kitti=args.root_kitti, chairs_split_file=args.chairs_split_file,
        num_workers=args.num_workers, device_prefetch=args.device_prefetch,
        eval_cache_size=args.eval_cache_size, eval_pad_bucket=args.eval_pad_bucket,
        synthetic_style=args.synthetic_style,
    )


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
    parser.add_argument("--device", default=None,
                        help="torch device (default: the current CUDA device)")
    add_model_args(parser)
    add_data_args(parser)
    return parser


def parse_eval(argv: Optional[Sequence[str]] = None):
    """``(args, model_cfg, data_cfg)`` of the evaluate entry. The dataset
    decides BatchNorm in NCUP's weights net, as in the JAX CLI."""
    args = build_eval_parser().parse_args(argv)
    mesh = tuple(int(x) for x in args.mesh.split(",")) if args.mesh else (1, 1)
    if args.spatial_parallel > 1 or any(n > 1 for n in mesh):
        raise ValueError(
            "--spatial_parallel and --mesh above one card are not in the port yet: they "
            "land with its multi-GPU slice (ROADMAP.md, queue 1 item 9)")
    dataset = "sintel" if args.dataset.startswith("sintel") else args.dataset
    return args, model_config_from_args(args, dataset=dataset), data_config_from_args(args)
