"""Train a RAFT model: ``python -m raft_ncup_tpu_torch.train``.

Port of the root ``train.py`` (the JAX trainer's loop) with
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

Data-parallel across cards, one process per card, as the JAX trainer
runs data-parallel over every chip: ``torchrun --nproc_per_node N -m
raft_ncup_tpu_torch.train <the same flags>``. The trainer joins the
launcher's world (``parallel.multihost.initialize_distributed``; NCCL on
cards, gloo on the CPU, or ``RAFT_TORCH_DIST_BACKEND``), each rank feeds
``--device`` or ``cuda:LOCAL_RANK``, ``--batch_size`` is the global batch
(each rank loads ``batch_size // N`` of it, and a batch N does not divide
raises), ``--data_parallel`` defaults to N and any other value raises
(``--gpus`` is accepted and ignored, as in JAX). Over the spatial axis,
``--mesh D,S`` (or ``--spatial_parallel S``) with D times S ranks: the S
ranks of a data index load the same rows of the global batch (the loader
shards by data index only), draw the same augmentation and noise, and
each trains on its band of every image's rows (the crop's height must
divide by 8 S); for example ``torchrun --nproc_per_node 2 -m
raft_ncup_tpu_torch.train ... --mesh 1,2 --device cpu`` on the CPU. Each
step reduces the gradients, the loss and the metrics across the ranks
(``training.step.make_train_step(mesh=...)``), so every rank logs,
checkpoints and halts on the same global numbers; only the main process
writes the log, the flight dumps, the profile and the checkpoints (rank 0
writes, every rank waits at a barrier). Validation runs sharded: each
rank validates its share of the frames and the sums are reduced
(``evaluation._shard_for_validation``; whole frames, over the world, also
under a spatial axis). A SIGTERM to any rank stops every
rank at the same step (the ranks agree on it every 16 steps,
``resilience.preemption.CHECK_EVERY``), and all exit 75; a sentinel
halt happens on every rank at once (exit 76). ``--chaos_rank R`` limits
``--chaos`` to rank R's process.

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
   to the host, through the sanctioned ``analysis.guards.host_read``, as
   the logger's window read is);
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

Telemetry, as the root trainer wires it: the process hub's ``train``
health (READY while training, DRAINING on preemption, HALTED on the
sentinel's halt), the sentinel's counters as gauges at each read, and a
flight recorder under ``<run_dir>/flight`` for this run (detached at
teardown) that banks a ``sentinel_halt`` dump (exit 76) and a
``preemption_drain`` dump (exit 75). ``--profile_steps N`` traces the N
steps after the first (which pays cuDNN's autotuning) with
``torch.profiler`` into ``<run_dir>/profile`` (``utils.profiling.trace``,
a Chrome trace) and logs "profile trace written to ...".

``--strict_guards`` runs each step (its batch, the step, the logger's
push) inside ``analysis.guards.StepGuard.scope()``, with validation and
checkpoints outside it: an implicit read of a tensor on the host raises
``GuardViolation`` at once (on the card, so does any operation that waits
for it), and a capture or kernel load after the warm-up scopes counts as a
recompile. A completed run logs JAX's line ``strict_guards:
warmup_compiles=... steady_recompiles=... host_transfers=...
sanctioned_gets=...`` (also under ``strict_guards`` in the JSON summary),
then fails if the step recompiled.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import signal
import statistics
import sys
import time

import torch

from raft_ncup_tpu_torch import cli
from raft_ncup_tpu_torch.analysis.guards import StepGuard, host_read
from raft_ncup_tpu_torch.config import ModelConfig, TrainConfig
from raft_ncup_tpu_torch.data.datasets import fetch_training_set
from raft_ncup_tpu_torch.data.device_prefetch import DevicePrefetcher
from raft_ncup_tpu_torch.data.loader import FlowLoader
from raft_ncup_tpu_torch.evaluation import VALIDATORS
from raft_ncup_tpu_torch.inference.pipeline import ShapeCachedForward
from raft_ncup_tpu_torch.observability import FlightRecorder, get_telemetry
from raft_ncup_tpu_torch.parallel import mesh as mesh_mod
from raft_ncup_tpu_torch.parallel import multihost
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
from raft_ncup_tpu_torch.utils.profiling import trace


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
    device = multihost.local_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # Join the launcher's world (a no-op for one process without one); a
    # world joined here is left at the end.
    already = multihost.initialized()
    joined = multihost.initialize_distributed(device=device) and not already
    try:
        return _train(args, model_cfg, cfg, data_cfg, device)
    finally:
        if joined:
            multihost.shutdown()


def _train(args, model_cfg, cfg, data_cfg, device) -> int:
    world, rank = multihost.process_count(), multihost.process_index()
    main_process = multihost.is_main_process()
    # cfg.data_parallel times cfg.spatial_parallel is the world's size
    # (cli.check_mesh), and the data size divides the global batch
    # (TrainConfig checks it).
    mesh = (mesh_mod.make_mesh(cfg.data_parallel, cfg.spatial_parallel, device=device)
            if multihost.initialized() else None)
    mesh_mod.reset_collective_stats()  # the summary counts this run's
    chaos = ChaosSpec.parse(
        args.chaos if args.chaos_rank is None or args.chaos_rank == rank else None)
    if cfg.restore_ckpt:
        model_cfg = checkpoint.saved_model_config(cfg.restore_ckpt)
        cfg = dataclasses.replace(cfg, precision=resumed_precision(args, model_cfg))
    state = create_train_state(model_cfg, cfg, device)
    run_dir = os.path.join(cfg.checkpoint_dir, cfg.name)
    logger = Logger(run_dir, dataclasses.asdict(cfg), cfg.sum_freq, active=main_process)
    logger.write_text(f"world={world} mesh={mesh_mod.mesh_fingerprint(mesh)} "
                      f"backend={multihost.backend()}")
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
    # --batch_size is the global batch; each data index loads its share
    # (FlowLoader shards the indices over the data indices), the same on
    # each of its spatial ranks.
    shard, shards = (mesh.data_index, mesh.data) if mesh is not None else (0, 1)
    loader = FlowLoader(dataset, cfg.batch_size // shards, seed=cfg.seed,
                        shard_index=shard, num_shards=shards,
                        num_workers=data_cfg.num_workers, prefetch=data_cfg.prefetch,
                        io_retries=data_cfg.io_retries,
                        io_retry_backoff_s=data_cfg.io_retry_backoff_s)
    logger.write_text(f"training with {len(dataset)} pairs ({len(loader)} batches/epoch)")
    step_fn = make_train_step(cfg, mesh=mesh)

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
    # --strict_guards: registered for the loop, armed per step.
    step_guard = StepGuard() if args.strict_guards else None
    guard_scope = step_guard.scope if step_guard is not None else contextlib.nullcontext
    loop_scope = contextlib.ExitStack()
    if step_guard is not None:
        loop_scope.enter_context(step_guard)
    # This run's flight recorder on the process hub, beside the
    # checkpoints; detached at teardown (a later run in this process must
    # not dump into this run's directory).
    tel = get_telemetry()
    prev_flight = tel.flight
    tel.flight = FlightRecorder(os.path.join(run_dir, "flight")) if main_process else None
    train_health = tel.health("train", fresh=True)
    train_health.ready(f"training from step {step_i}")
    profile_scope = contextlib.ExitStack()
    profiling = False
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
                if args.profile_steps and step_i == first + 1 and main_process:
                    # The first step paid the autotuning; trace the next ones,
                    # and only theirs (the first step's kernels finish first).
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    profile_scope.enter_context(trace(os.path.join(run_dir, "profile")))
                    profiling = True
                t_it = time.perf_counter()
                with guard_scope():
                    batch = next(prefetcher)
                    lr = state.optimizer.lr()
                    metrics = step_fn(state, batch)
                    step_i += 1
                    logger.push(step_i - 1, metrics, lr)
                iteration_ms.append(1e3 * (time.perf_counter() - t_it))
                if step_i == first + 1:
                    # The ranks' first steps (cuDNN's autotuning) drift
                    # apart; the barrier realigns them once.
                    multihost.barrier("train_warmup")
                if chaos.sigterm_after == step_i:
                    # A real signal through the real handler, at a step boundary.
                    os.kill(os.getpid(), signal.SIGTERM)
                if profiling and step_i >= first + 1 + args.profile_steps:
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)  # the last step's kernels
                    profile_scope.close()
                    profiling = False
                    logger.write_text(f"profile trace written to {run_dir}/profile")
                if cfg.anomaly_sentinel and step_i % cfg.sum_freq == 0:
                    # The sentinel's only read back to the host; its host
                    # numbers land as gauges, no further read.
                    skipped, consecutive, ema = (float(v) for v in host_read(torch.stack(
                        [state.sentinel["skipped"].float(),
                         state.sentinel["consecutive"].float(),
                         state.sentinel["ema_grad_norm"].float()])))
                    skipped, consecutive = int(skipped), int(consecutive)
                    tel.gauge_set("train_sentinel_skipped", skipped)
                    tel.gauge_set("train_sentinel_consecutive", consecutive)
                    tel.gauge_set("train_sentinel_ema_grad_norm", ema)
                    if skipped:
                        logger.write_text(f"sentinel @ {step_i}: skipped={skipped} "
                                          f"consecutive={consecutive}")
                    if consecutive >= cfg.sentinel_halt_after:
                        tel.event("train_sentinel_halt", step=step_i, consecutive=consecutive)
                        train_health.halted(f"sentinel: {consecutive} consecutive bad steps "
                                            f"@ {step_i}")
                        # The timeline that led here, banked before the
                        # rollback.
                        tel.flight_dump("sentinel_halt", step=step_i, consecutive=consecutive,
                                        skipped=skipped, mesh=mesh_mod.mesh_fingerprint(mesh))
                        halted = True
                        break
                if step_i % cfg.val_freq == 0 or step_i == total:
                    ckpt.save(state, cfg)
                    if cfg.validation:
                        _validate(state, cfg, data_cfg, logger, step_i, prefetcher)
        if preempted:
            if ckpt.last_saved != step_i:
                ckpt.save(state, cfg)
            train_health.draining(f"preempted @ {step_i}")
            # Banked after the checkpoint, so the dump names a saved step.
            tel.flight_dump("preemption_drain", step=step_i, checkpoint_step=ckpt.latest_step,
                            mesh=mesh_mod.mesh_fingerprint(mesh))
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
        if step_guard is not None and status == 0:
            s = step_guard.stats
            logger.write_text(f"strict_guards: warmup_compiles={s.warmup_compiles} "
                              f"steady_recompiles={s.recompiles} "
                              f"host_transfers={s.host_transfers} "
                              f"sanctioned_gets={s.sanctioned_gets}")
            step_guard.check()  # raises on steady-state recompilation
        if not loader.retry_stats.clean:
            logger.write_text("io-retry: " + loader.retry_stats.summary())
        if not ckpt.retry_stats.clean:
            logger.write_text("ckpt-retry: " + ckpt.retry_stats.summary())
    finally:
        # Teardown only; each closer shielded, so that a failure here never
        # hides the error that ended the loop.
        for closer in (loop_scope.close, profile_scope.close, prefetcher.close, logger.close):
            try:
                closer()
            except Exception as e:
                print(f"teardown ({closer.__qualname__}): {e}", file=sys.stderr)
        tel.flight = prev_flight
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # Every rank leaves together: a launcher tears the world down when one
    # rank exits.
    multihost.barrier("train_exit")
    summary = {
        "status": status, "steps": step_i - first, "step": state.step,
        "checkpoint": ckpt.path(ckpt.latest_step) if ckpt.latest_step is not None else None,
        "variant": state.model.cfg.variant, "small": state.model.cfg.small,
        "precision": state.model.policy.name, "seconds": time.perf_counter() - t0,
        "device": str(device), "skipped": int(state.sentinel["skipped"]),
        "world": world, "rank": rank, "mesh": mesh_mod.mesh_fingerprint(mesh),
        "backend": multihost.backend(),
        "collectives": mesh_mod.collective_stats(),
        # Host wall of each iteration (its batch, the step's dispatch, the
        # logging), the first left out.
        "median_iteration_ms": statistics.median(iteration_ms[1:]) if len(iteration_ms) > 1
        else None,
        "loader": {"samples": loader.samples_read,
                   "host_ms_per_sample": 1e3 * loader.read_seconds / max(loader.samples_read, 1),
                   "retry": loader.retry_stats.summary()},
        "prefetch": {"waits": prefetcher.waits, "wait_ms": prefetcher.wait_ms},
        "strict_guards": None if step_guard is None else {
            "warmup_compiles": step_guard.stats.warmup_compiles,
            "steady_recompiles": step_guard.stats.recompiles,
            "host_transfers": step_guard.stats.host_transfers,
            "sanctioned_gets": step_guard.stats.sanctioned_gets},
        **{k: float(v) for k, v in metrics.items()},
    }
    print(json.dumps(summary), flush=True)
    return status


if __name__ == "__main__":
    sys.exit(main())
