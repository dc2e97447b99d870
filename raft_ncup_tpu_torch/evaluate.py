"""Evaluate a RAFT model: ``python -m raft_ncup_tpu_torch.evaluate``.

Port of the root ``evaluate.py``: validate on chairs, sintel,
sintel_warm, kitti, synthetic or synthetic_rigid, or write the Sintel or
KITTI leaderboard files (``--submission``), with the JAX CLI's flags
(``cli.build_eval_parser``). The weights come from ``--restore_ckpt``:
a port train state (``step_<N>.pt`` or its run directory) or a
reference ``.pth`` (what the JAX package's ``--export_pth`` writes),
each loaded strictly into the model the flags select; without it they
are drawn from ``--seed``. ``--export_pth PATH`` writes the loaded
weights as a reference ``.pth`` and exits.

Every forward runs through a per-shape CUDA graph with both
hand-written kernels inside (``inference/pipeline.ShapeCachedForward``).
It runs on the card unless ``--device cpu`` is given; with no CUDA and
no ``--device`` it raises. The last line of stdout is one JSON object:
the results, the cache's captures, hits and evictions, and the device.

Data-parallel across cards: ``torchrun --nproc_per_node N -m
raft_ncup_tpu_torch.evaluate ...`` joins the launcher's world, each rank
on ``--device`` or ``cuda:LOCAL_RANK``; each validates its share of the
frames through its own graphs and every rank reports the global metrics
(``evaluation._shard_for_validation``). ``--mesh D,S`` (or
``--spatial_parallel S``, the mesh ``1,S``) is accepted when D times S is
the world size: the S ranks of each data index see the same frames and
split each forward by image rows (``RAFT.forward(..., mesh=...)``, row
halos over ``parallel/halo.py``), padded to a multiple of 8 S, eagerly,
without a CUDA graph; the metric sums reduce over the data indices only.
``--mesh D,S,P`` runs that ``(D, S)`` evaluation on each of the P pipe
indices (JAX replicates the forward over ``pipe``), each summing its
metrics over its own data group only, so no frame counts twice; under
``1,1,P`` each rank runs the whole evaluation through its own graphs,
with no reduction. Only the main process writes submissions and
``--export_pth``.

Examples::

    python -m raft_ncup_tpu_torch.evaluate --model raft_nc_dbl --dataset sintel \\
        --restore_ckpt models/raft_nc-sintel.pth
    python -m raft_ncup_tpu_torch.evaluate --model raft_nc_dbl --dataset synthetic
"""

from __future__ import annotations

import json
import os
import sys

import torch

from raft_ncup_tpu_torch.cli import parse_eval
from raft_ncup_tpu_torch.evaluation import (
    VALIDATORS,
    create_kitti_submission,
    create_sintel_submission,
)
from raft_ncup_tpu_torch.inference.pipeline import ShapeCachedForward
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.parallel import mesh as mesh_mod
from raft_ncup_tpu_torch.parallel import multihost
from raft_ncup_tpu_torch.training import checkpoint


def load_model(model_cfg, restore_ckpt, device=None, seed: int = 0) -> RAFT:
    """The model of ``model_cfg`` on ``device`` with the weights of
    ``restore_ckpt``, loaded strictly: a ``.pth`` file is a reference
    state dict, anything else a port train state. Without a checkpoint
    the weights come from ``seed``."""
    model = RAFT(model_cfg, device=device, seed=seed)
    if not restore_ckpt:
        return model
    if os.path.isfile(restore_ckpt) and restore_ckpt.endswith(".pth"):
        return checkpoint.load_reference_pth(model, restore_ckpt)
    return checkpoint.load_model_weights(model, restore_ckpt)


def main(argv=None) -> int:
    args, model_cfg, data_cfg = parse_eval(argv)
    device = multihost.local_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    already = multihost.initialized()
    joined = multihost.initialize_distributed(device=device) and not already
    try:
        return _evaluate(args, model_cfg, data_cfg, device)
    finally:
        if joined:
            multihost.shutdown()


def _evaluate(args, model_cfg, data_cfg, device) -> int:
    model = load_model(model_cfg, args.restore_ckpt, device, args.seed)
    if args.export_pth:
        if multihost.is_main_process():
            checkpoint.save_reference_pth(model, args.export_pth)
            print(f"exported reference-keyed checkpoint to {args.export_pth}")
        return 0

    data, spatial = args.mesh_axes
    pipe = getattr(args, "mesh_pipe", 1)
    mesh = (mesh_mod.make_mesh(data, spatial, pipe, device=device)
            if spatial > 1 or pipe > 1 else None)
    fwd = ShapeCachedForward(model, cache_size=data_cfg.eval_cache_size, mesh=mesh)
    kw = {"fwd": fwd}
    if args.iters is not None:
        kw["iters"] = args.iters
    if args.submission:
        if args.output_path:
            kw["output_path"] = args.output_path
        if args.dataset == "sintel":
            create_sintel_submission(model, data_cfg, warm_start=args.warm_start,
                                     write_png=args.write_png, **kw)
        elif args.dataset == "kitti":
            create_kitti_submission(model, data_cfg, write_png=args.write_png, **kw)
        else:
            raise SystemExit("--submission supports sintel and kitti only")
        results = {}
    else:
        if args.batch_size:
            kw["batch_size"] = args.batch_size
        results = VALIDATORS[args.dataset](model, data_cfg, **kw)
    report = {"results": results, "cache": dict(fwd.stats), "device": str(model.device),
              "world": multihost.process_count(), "rank": multihost.process_index(),
              "mesh": mesh_mod.mesh_fingerprint(mesh), "collectives": mesh_mod.collective_stats()}
    if model.device.type == "cuda":
        report["device_name"] = torch.cuda.get_device_name(model.device)
        report["graph_pool_bytes"] = sum(fwd.pool_bytes.values())
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
