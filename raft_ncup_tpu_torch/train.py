"""Train a RAFT model: ``python -m raft_ncup_tpu_torch.train``.

Port of the root ``train.py`` with ``raft_ncup_tpu/cli.py``'s
``parse_train``, for what the port supports: the model the flags
``--model``, ``--small``, ``--align_corners`` and ``--upsampler_bi``
select (by default the flagship ``raft_nc_dbl`` with NCUP), with both
hand-written kernels (``corr_impl="pallas"``, ``nconv_impl="pallas"``)
and their backward kernels, f32 with TF32 off unless ``--precision
bf16_train`` (bf16 compute with f32 master weights) or
``--mixed_precision`` asks for bf16, trained on procedural
pairs (``data/synthetic.py``, the JAX trainer's ``--synthetic_ok`` data)
from weights drawn from ``--seed``. NCUP's simple weights net has
BatchNorm for the sintel stage only, and BatchNorm trains in the chairs
stage only, as in the JAX trainer. The flags keep the JAX CLI's names:

    python -m raft_ncup_tpu_torch.train --name raft_nc_things --stage things \\
        --num_steps 100000 --batch_size 6 --lr 0.000125 --image_size 400 720 \\
        --wdecay 0.00005 --gamma 0.8

Metrics go to stdout and ``<checkpoint_dir>/<name>/log.txt`` every
``--sum_freq`` steps; the whole train state is saved at the end to
``<checkpoint_dir>/<name>/step_<N>.pt``, which ``--restore_ckpt`` (the
file or its directory) resumes exactly, with the model configuration it
saved (the model flags are then not read, and a ``--precision`` that
differs from the checkpoint's raises). The last line of stdout is one
JSON summary. It runs on the card unless ``--device cpu`` is given; with
no CUDA and no ``--device`` it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

from raft_ncup_tpu_torch.cli import add_model_args, model_config_from_args
from raft_ncup_tpu_torch.config import STAGES, ModelConfig, TrainConfig
from raft_ncup_tpu_torch.data.synthetic import SyntheticFlowDataset
from raft_ncup_tpu_torch.training import checkpoint
from raft_ncup_tpu_torch.training.logger import Logger
from raft_ncup_tpu_torch.training.state import create_train_state
from raft_ncup_tpu_torch.training.step import make_train_step
from raft_ncup_tpu_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    d = TrainConfig()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--name", default=d.name)
    p.add_argument("--stage", required=True, choices=list(STAGES))
    p.add_argument("--restore_ckpt", default=None,
                   help="a step_<N>.pt file or a run directory (its latest file)")
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--num_steps", type=int, default=d.num_steps)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--image_size", type=int, nargs=2, default=list(d.image_size))
    p.add_argument("--iters", type=int, default=d.iters)
    p.add_argument("--wdecay", type=float, default=d.wdecay)
    p.add_argument("--epsilon", type=float, default=d.epsilon)
    p.add_argument("--clip", type=float, default=d.clip)
    p.add_argument("--gamma", type=float, default=d.gamma)
    p.add_argument("--optimizer", default=d.optimizer, type=str.lower)
    p.add_argument("--scheduler", default=d.scheduler)
    p.add_argument("--sum_freq", type=int, default=d.sum_freq)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--checkpoint_dir", default=d.checkpoint_dir)
    p.add_argument("--synthetic_style", default=d.synthetic_style,
                   choices=["smooth", "rigid"])
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    add_model_args(p)
    return p


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    """The train configuration the flags select; its ``precision`` is the
    model flags' resolved preset (``--mixed_precision`` alone gives
    ``bf16_infer``)."""
    return TrainConfig(
        name=args.name, stage=args.stage, lr=args.lr, num_steps=args.num_steps,
        batch_size=args.batch_size, image_size=tuple(args.image_size),
        iters=args.iters, wdecay=args.wdecay, epsilon=args.epsilon,
        clip=args.clip, gamma=args.gamma, optimizer=args.optimizer,
        scheduler=args.scheduler, sum_freq=args.sum_freq, seed=args.seed,
        restore_ckpt=args.restore_ckpt, checkpoint_dir=args.checkpoint_dir,
        synthetic_style=args.synthetic_style,
        precision=model_config_from_args(args, args.stage).precision_policy.name,
    )


def resumed_precision(args: argparse.Namespace, saved: ModelConfig) -> str:
    """The preset a resumed run trains under: its checkpoint's. A
    ``--precision`` or ``--mixed_precision`` that asks for another raises."""
    ours = saved.precision_policy.name
    if args.precision is not None or args.mixed_precision:
        asked = model_config_from_args(args, args.stage).precision_policy.name
        if asked != ours:
            raise ValueError(f"the flags ask for precision {asked!r}, but the checkpoint "
                             f"was trained under {ours!r}; a resumed run keeps its own")
    return ours


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(args.device)
    if cfg.restore_ckpt:
        saved = checkpoint.saved_model_config(cfg.restore_ckpt)
        cfg = dataclasses.replace(cfg, precision=resumed_precision(args, saved))
        state = checkpoint.restore(cfg.restore_ckpt, cfg, device)
    else:
        state = create_train_state(model_config_from_args(args, cfg.stage), cfg, device)
    run_dir = os.path.join(cfg.checkpoint_dir, cfg.name)
    logger = Logger(run_dir, dataclasses.asdict(cfg), cfg.sum_freq)
    data = SyntheticFlowDataset(cfg.image_size, seed=cfg.seed, style=cfg.synthetic_style)
    step = make_train_step(cfg)
    first = state.step
    t0 = time.perf_counter()
    metrics = {}
    while state.step < cfg.num_steps:
        batch = data.batch(state.step, cfg.batch_size, device)
        lr = state.optimizer.lr()
        metrics = step(state, batch)
        logger.push(state.step - 1, metrics, lr)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    path = checkpoint.save(state, cfg)
    logger.close()
    summary = {
        "steps": state.step - first, "step": state.step, "checkpoint": path,
        "variant": state.model.cfg.variant, "small": state.model.cfg.small,
        "precision": state.model.policy.name,
        "seconds": seconds, "device": str(device),
        "skipped": int(state.sentinel["skipped"]),
        **{k: float(v) for k, v in metrics.items()},
    }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
