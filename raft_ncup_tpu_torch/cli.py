"""The model flags the serve and train entry points share, with the JAX
CLI's names (``raft_ncup_tpu/cli.py``'s ``add_model_args``) for what the
port runs: ``--model``, ``--small``, ``--align_corners``,
``--upsampler_bi``, ``--precision`` and ``--mixed_precision``. The model
always takes both hand-written kernels (``corr_impl="pallas"``,
``nconv_impl="pallas"``); f32 is the default."""

from __future__ import annotations

import argparse

from raft_ncup_tpu_torch.config import ModelConfig, UpsamplerConfig
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
