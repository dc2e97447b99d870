"""Train a RAFT model: ``python -m raft_ncup_tpu_torch.train``.

Port of the root ``train.py`` (the JAX trainer's loop on one card) with
the JAX CLI's whole train surface (``cli.parse_train``): the shipped
scripts' flag lines parse as written, with ``--device`` in place of
``--platform``. The model the flags select (``--model raft_nc_dbl`` is
the flagship, RAFT with NCUP) runs the hand-written kernels and their
backward kernels, f32 with TF32 off unless ``--precision bf16_train``
asks for bf16 compute with f32 master weights. For example, the shipped
FlyingThings3D script's configuration:

    python -m raft_ncup_tpu_torch.train --name raft_nc_things --model raft_nc_dbl \\
        --load_pretrained models/raft-things.pth --stage things --validation sintel \\
        --num_steps 100000 --batch_size 6 --lr 0.000125 --image_size 400 720 \\
        --root_things datasets/FlyingThings3D --root_sintel datasets/Sintel

In order, the trainer:

1. builds the model from ``--seed`` and warm-starts its trunk from
   ``--load_pretrained`` (a reference ``.pth`` or a port run directory);
2. restores ``--restore_ckpt`` (a run directory or a ``step_<N>.pt``) in
   place, after checking the resume metadata beside it (variant, model
   configuration, seed); a resumed run keeps its checkpoint's model
   configuration, so the model flags are then not read, and a
   ``--precision`` that differs from the checkpoint's raises;
3. reads the stage's training mixture (``data.datasets.fetch_training_set``;
   procedural pairs with ``--synthetic_ok`` when no dataset is on disk),
   augmented on the host by ``--num_workers`` threads (``data.loader``),
   resumed at the (epoch, batch) of the restored step, and copied to the
   card ahead of compute (``data.device_prefetch``, ``--device_prefetch``
   batches deep);
4. applies ``--chaos`` (``nan@S``, ``ioerror@N``, ``sigterm@S``);
5. runs the step; reads the preemption flag at each step boundary, and
   the sentinel's counters every ``--sum_freq`` steps (its only read back
   to the host);
6. saves ``<checkpoint_dir>/<name>/step_<N>.pt`` (the latest five kept)
   and runs each ``--validation`` validator every ``--val_freq`` steps and
   at the last step, logging the results to ``log.txt``.

Exits: 0 when the run completes; 75 (``EXIT_PREEMPTED``) after a SIGTERM
or SIGINT, with one checkpoint saved at the step it stopped at; 76
(``EXIT_DIVERGED``) when ``--sentinel_halt_after`` bad steps come in a
row, with the state rolled back in place to the latest checkpoint. The
last line of stdout is one JSON summary with the ``status``. It runs on
the card unless ``--device cpu`` is given; with no CUDA and no
``--device`` it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import statistics
import sys
import time

import torch

from raft_ncup_tpu_torch import cli
from raft_ncup_tpu_torch.config import ModelConfig, TrainConfig
from raft_ncup_tpu_torch.data.datasets import fetch_training_set
from raft_ncup_tpu_torch.data.device_prefetch import DevicePrefetcher
from raft_ncup_tpu_torch.data.loader import FlowLoader
from raft_ncup_tpu_torch.evaluation import VALIDATORS
from raft_ncup_tpu_torch.inference.pipeline import ShapeCachedForward
from raft_ncup_tpu_torch.resilience import (
    EXIT_DIVERGED,
    EXIT_PREEMPTED,
    ChaosDataset,
    ChaosSpec,
    PreemptionHandler,
    chaos_batches,
    resume_metadata,
)
from raft_ncup_tpu_torch.training import checkpoint
from raft_ncup_tpu_torch.training.checkpoint import CheckpointManager, load_pretrained_trunk
from raft_ncup_tpu_torch.training.logger import Logger
from raft_ncup_tpu_torch.training.state import TrainState, create_train_state
from raft_ncup_tpu_torch.training.step import make_train_step
from raft_ncup_tpu_torch.utils.device import resolve_device


def resumed_precision(args: argparse.Namespace, saved: ModelConfig) -> str:
    """The preset a resumed run trains under: its checkpoint's. A
    ``--precision`` or ``--mixed_precision`` that asks for another raises."""
    ours = saved.precision_policy.name
    if args.precision is not None or args.mixed_precision:
        asked = cli.model_config_from_args(args, args.stage).precision_policy.name
        if asked != ours:
            raise ValueError(f"the flags ask for precision {asked!r}, but the checkpoint "
                             f"was trained under {ours!r}; a resumed run keeps its own")
    return ours


def _restore(state: TrainState, path: str, ckpt: CheckpointManager, meta: dict) -> None:
    """``--restore_ckpt`` into ``state`` in place, its directory's metadata
    checked first."""
    if os.path.isfile(path):
        CheckpointManager(os.path.dirname(path), metadata=meta).verify_metadata()
        checkpoint.restore_into(state, path)
    elif os.path.abspath(path) == ckpt.directory:
        ckpt.restore(state)
    else:
        CheckpointManager(path, metadata=meta).restore(state)


def _validate(state: TrainState, cfg: TrainConfig, data_cfg, logger: Logger, step: int,
              prefetcher: DevicePrefetcher):
    """Each of ``cfg.validation``'s validators on the model in eval mode,
    through one per-shape graph cache whose graphs and memory pool are
    released afterwards; the model goes back to training mode. The
    prefetcher makes no CUDA call meanwhile (the graphs' captures)."""
    model = state.model
    model.eval()
    fwd = ShapeCachedForward(model, cache_size=data_cfg.eval_cache_size)
    try:
        with prefetcher.paused():
            for name in cfg.validation:
                logger.write_dict(step, VALIDATORS[name](model, data_cfg, fwd=fwd))
    finally:
        fwd.clear()
        model.train()


def main(argv=None) -> int:
    args, model_cfg, cfg, data_cfg = cli.parse_train(argv)
    unknown = sorted(set(cfg.validation) - set(VALIDATORS))
    if unknown:
        raise ValueError(f"unknown --validation {unknown}; choose from {sorted(VALIDATORS)}")
    device = resolve_device(args.device)
    chaos = ChaosSpec.parse(args.chaos)
    if cfg.restore_ckpt:
        model_cfg = checkpoint.saved_model_config(cfg.restore_ckpt)
        cfg = dataclasses.replace(cfg, precision=resumed_precision(args, model_cfg))
    state = create_train_state(model_cfg, cfg, device)
    run_dir = os.path.join(cfg.checkpoint_dir, cfg.name)
    logger = Logger(run_dir, dataclasses.asdict(cfg), cfg.sum_freq)
    if chaos.active:
        logger.write_text(f"chaos: {chaos.render()}")
    if cfg.load_pretrained:
        load_pretrained_trunk(cfg.load_pretrained, state.model)
        logger.write_text(f"warm-started trunk from {cfg.load_pretrained}")
    meta = resume_metadata(model_cfg, cfg)
    ckpt = CheckpointManager(run_dir, max_to_keep=5, metadata=meta)
    if cfg.restore_ckpt:
        _restore(state, cfg.restore_ckpt, ckpt, meta)
        logger.write_text(f"restored step {state.step} from {cfg.restore_ckpt}")

    dataset = fetch_training_set(cfg.stage, cfg.image_size, data_cfg)
    if chaos.ioerror_reads:
        dataset = ChaosDataset(dataset, chaos.ioerror_reads)
    loader = FlowLoader(dataset, cfg.batch_size, seed=cfg.seed,
                        num_workers=data_cfg.num_workers, prefetch=data_cfg.prefetch,
                        io_retries=data_cfg.io_retries,
                        io_retry_backoff_s=data_cfg.io_retry_backoff_s)
    logger.write_text(f"training with {len(dataset)} pairs ({len(loader)} batches/epoch)")
    step_fn = make_train_step(cfg)

    # The data stream resumes where the restored run stood: the loader is
    # deterministic per (seed, epoch, index), so the batches of the epoch
    # already consumed are skipped without being read.
    step_i = first = state.step
    total = cfg.num_steps
    per_epoch = len(loader)
    batches = loader.batches(start_epoch=step_i // per_epoch, start_batch=step_i % per_epoch)
    if chaos.nan_steps:
        batches = chaos_batches(batches, chaos.nan_steps, start_step=step_i,
                                log=logger.write_text)
    prefetcher = DevicePrefetcher(batches, depth=data_cfg.device_prefetch, device=device)
    preempt = PreemptionHandler()
    status = 0
    preempted = halted = False
    metrics: dict = {}
    iteration_ms = []
    t0 = time.perf_counter()
    try:
        with preempt:
            while step_i < total:
                if preempt.poll(step_i):
                    preempted = True
                    break
                t_it = time.perf_counter()
                batch = next(prefetcher)
                lr = state.optimizer.lr()
                metrics = step_fn(state, batch)
                step_i += 1
                logger.push(step_i - 1, metrics, lr)
                iteration_ms.append(1e3 * (time.perf_counter() - t_it))
                if chaos.sigterm_after == step_i:
                    # A real signal through the real handler, at a step boundary.
                    os.kill(os.getpid(), signal.SIGTERM)
                if cfg.anomaly_sentinel and step_i % cfg.sum_freq == 0:
                    # The sentinel's only read back to the host.
                    skipped, consecutive = (int(v) for v in torch.stack(
                        [state.sentinel["skipped"], state.sentinel["consecutive"]]).tolist())
                    if skipped:
                        logger.write_text(f"sentinel @ {step_i}: skipped={skipped} "
                                          f"consecutive={consecutive}")
                    if consecutive >= cfg.sentinel_halt_after:
                        halted = True
                        break
                if step_i % cfg.val_freq == 0 or step_i == total:
                    ckpt.save(state, cfg)
                    if cfg.validation:
                        _validate(state, cfg, data_cfg, logger, step_i, prefetcher)
        if preempted:
            if ckpt.latest_step != step_i:
                ckpt.save(state, cfg)
            logger.write_text(f"preempted @ {step_i}: checkpoint saved, exiting "
                              f"{EXIT_PREEMPTED}")
            status = EXIT_PREEMPTED
        elif halted:
            logger.write_text(f"sentinel halt @ {step_i}: >={cfg.sentinel_halt_after} "
                              "consecutive bad steps")
            if ckpt.latest_step is not None:
                ckpt.restore(state)  # in place: the live tensors take the saved values
                logger.write_text(f"rolled back to the last good checkpoint (step {state.step})")
            else:
                logger.write_text("no checkpoint to roll back to")
            status = EXIT_DIVERGED
        if not loader.retry_stats.clean:
            logger.write_text("io-retry: " + loader.retry_stats.summary())
        if not ckpt.retry_stats.clean:
            logger.write_text("ckpt-retry: " + ckpt.retry_stats.summary())
    finally:
        # Teardown only; each closer shielded, so that a failure here never
        # hides the error that ended the loop.
        for closer in (prefetcher.close, logger.close):
            try:
                closer()
            except Exception as e:
                print(f"teardown ({closer.__qualname__}): {e}", file=sys.stderr)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    summary = {
        "status": status, "steps": step_i - first, "step": state.step,
        "checkpoint": ckpt.path(ckpt.latest_step) if ckpt.latest_step is not None else None,
        "variant": state.model.cfg.variant, "small": state.model.cfg.small,
        "precision": state.model.policy.name, "seconds": time.perf_counter() - t0,
        "device": str(device), "skipped": int(state.sentinel["skipped"]),
        # Host wall of each iteration (its batch, the step's dispatch, the
        # logging), the first left out.
        "median_iteration_ms": statistics.median(iteration_ms[1:]) if len(iteration_ms) > 1
        else None,
        "loader": {"samples": loader.samples_read,
                   "host_ms_per_sample": 1e3 * loader.read_seconds / max(loader.samples_read, 1),
                   "retry": loader.retry_stats.summary()},
        "prefetch": {"waits": prefetcher.waits, "wait_ms": prefetcher.wait_ms},
        **{k: float(v) for k, v in metrics.items()},
    }
    print(json.dumps(summary), flush=True)
    return status


if __name__ == "__main__":
    sys.exit(main())
