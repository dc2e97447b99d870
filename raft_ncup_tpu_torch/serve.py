"""Serve a RAFT model: ``python -m raft_ncup_tpu_torch.serve``.

Port of the plain (non-stream, non-replica) branch of the root
``serve.py``: build the model, wrap it in a :class:`FlowServer`, warm it
up, submit ``--num_requests`` frame pairs, drain, and print one JSON
report line. The model comes from the JAX CLI's flags ``--model``,
``--small``, ``--align_corners`` and ``--upsampler_bi``; by default it is
the flagship ``raft_nc_dbl`` with NCUP (the JAX CLI defaults to
``raft``). It runs both hand-written kernels (``corr_impl="pallas"``,
``nconv_impl="pallas"``), with random weights drawn from
``--seed``. Request pairs come from a numpy generator seeded by
``--seed``. ``--precision`` (or ``--mixed_precision``) sets the model's
preset, f32 by default; ``--serve_precision`` runs the server's forwards
under another preset with the same weights.

Every forward runs through the server's per-shape CUDA graphs
(``inference/pipeline.ShapeCachedForward``), captured at warm-up; the
report line carries the cache's ``executables`` stats (captures, hits,
evictions) and ``graph_pool_bytes``, as the JAX entry's report carries its
executables.

It runs on the card unless ``--device cpu`` is given; with no CUDA and
no ``--device`` it raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from raft_ncup_tpu_torch.cli import add_model_args, model_config_from_args
from raft_ncup_tpu_torch.config import ServeConfig
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.ops.corr_cuda import lookup_levels
from raft_ncup_tpu_torch.ops.nconv_cuda import nconv2d_fused
from raft_ncup_tpu_torch.precision import PRESET_NAMES
from raft_ncup_tpu_torch.serving import FlowServer, nearest_rank_ms


def _ints(s: str) -> tuple[int, ...]:
    return tuple(int(x) for x in s.split(",") if x.strip())


def build_parser() -> argparse.ArgumentParser:
    d = ServeConfig()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, nargs=2, default=[96, 128],
                   metavar=("H", "W"), help="request frame size")
    p.add_argument("--num_requests", type=int, default=32)
    p.add_argument("--iter_levels", type=_ints, default=d.iter_levels,
                   help="anytime GRU iteration levels, descending (e.g. 24,16,8)")
    p.add_argument("--serve_batch_sizes", type=_ints, default=d.batch_sizes,
                   help="allowed micro-batch sizes, ascending (e.g. 1,2,4)")
    p.add_argument("--queue_capacity", type=int, default=d.queue_capacity,
                   help="bounded admission queue; a full queue sheds")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the model weights and of the request pairs")
    p.add_argument("--serve_precision", default=d.precision, choices=list(PRESET_NAMES),
                   help="precision preset the server's forwards run under "
                   "(default: the model's own, from --precision)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    add_model_args(p)
    return p


def make_pairs(size_hw, n: int, seed: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """``n`` (H, W, 3) float32 frame pairs in [0, 255]: a random frame and
    a copy shifted by a few pixels plus noise, from one numpy generator."""
    rng = np.random.default_rng(seed)
    h, w = size_hw
    pairs = []
    for _ in range(n):
        img1 = rng.uniform(0.0, 255.0, (h, w, 3)).astype(np.float32)
        dy, dx = (int(v) for v in rng.integers(-4, 5, size=2))
        img2 = np.roll(img1, (dy, dx), axis=(0, 1))
        img2 = np.clip(img2 + rng.normal(0.0, 2.0, img2.shape), 0.0, 255.0)
        pairs.append((img1, img2.astype(np.float32)))
    return pairs


def serve_pairs(model: RAFT, cfg: ServeConfig, pairs, size_hw) -> tuple[dict, list]:
    """Warm a :class:`FlowServer` up for ``size_hw``, submit every pair,
    drain, and return ``(report, responses)``. The report counts the
    kernel launches made while serving (after the warm-up)."""
    server = FlowServer(model, cfg)
    t0 = time.monotonic()
    warmed = server.warmup(size_hw)
    warmup_s = time.monotonic() - t0
    launches0 = (lookup_levels.launches, nconv2d_fused.launches)
    t0 = time.monotonic()
    handles = [server.submit(a, b) for a, b in pairs]
    stats = server.drain()
    wall = time.monotonic() - t0
    responses = [h.result(timeout=60.0) for h in handles]
    lat = [r.latency_s for r in responses if r.ok]
    report = {
        "serve_requests": len(handles),
        "serve_ok": len(lat),
        "serve_wall_s": wall,
        "serve_pairs_per_sec": stats.completed / wall if wall > 0 else None,
        "serve_p50_ms": nearest_rank_ms(lat, 0.50),
        "serve_p99_ms": nearest_rank_ms(lat, 0.99),
        "warmup_configs": warmed,
        "warmup_s": warmup_s,
        "completed": stats.completed,
        "serve_batches": stats.batches,
        "shed": stats.shed,
        "timeouts": stats.timeouts,
        "rejected": stats.rejected,
        "errors": stats.errors,
        "corr_kernel_launches": lookup_levels.launches - launches0[0],
        "nconv_kernel_launches": nconv2d_fused.launches - launches0[1],
        **server.report(),
    }
    return report, responses


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = ServeConfig(
        queue_capacity=args.queue_capacity,
        batch_sizes=args.serve_batch_sizes,
        iter_levels=args.iter_levels,
        precision=args.serve_precision,
    )
    model = RAFT(
        model_config_from_args(args, dataset="sintel"), device=args.device, seed=args.seed,
    )
    size_hw = (args.size[0], args.size[1])
    pairs = make_pairs(size_hw, args.num_requests, args.seed)
    report, _ = serve_pairs(model, cfg, pairs, size_hw)
    report.update(variant=model.cfg.variant, small=model.cfg.small)
    if model.device.type == "cuda":
        report["device_name"] = torch.cuda.get_device_name(model.device)
    print(json.dumps(report), flush=True)
    return 0 if report["errors"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
