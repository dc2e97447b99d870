"""One high-resolution test-mode forward of the flagship, optionally split by
image rows over cards: ``python -m raft_ncup_tpu_torch.highres_forward``.

Port of ``scripts/highres_forward.py``. It runs the flagship
``raft_nc_dbl`` (Sintel configuration, seeded weights, both hand-written
kernels) on one pair of seeded random frames at ``--size`` (1088x1920 by
default; 2176x3840 is the 4K case) for ``--iters`` iterations, eagerly,
with cuDNN's autotuner on: a first forward (the kernels' load, the
autotuning), then the timed one.

``--final_upsampling PacJointUpsampleFull | DjifOriginal`` swaps NCUP for
the PAC or DJIF head, which splits by rows as every other layer does.

``--spatial S`` (or ``--spatial_parallel S``, or ``--mesh D,S`` with D
times S processes) above 1 splits the height over S processes, one per
card, started by a launcher::

    torchrun --nproc_per_node S -m raft_ncup_tpu_torch.highres_forward \\
        --size 1088 1920 --iters 32 --spatial S

Each rank holds a band of rows of every activation, the convolutions
exchange row halos, the correlation reads the gathered fmap2
(``parallel/halo.py``) and every rank ends with the whole flow. The world
is a ``(data, spatial)`` mesh; each data index runs the same pair. Two
ranks may share one card under gloo (``RAFT_TORCH_DIST_BACKEND=gloo``,
``--device cuda:0``): a check of memory per rank and of the answers, not
of scaling.

Each rank prints one JSON line with the JAX script's keys where they carry
over (``shape``, ``iters``, ``precision``, ``platform``, ``mesh``,
``devices``, ``finite``, ``collectives``, ``collective_bytes``) and the
port's: ``first_s`` (the first forward, build included), ``wall_ms`` and
``device_ms`` of the timed forward, ``peak_bytes`` (this rank's card
memory at its peak during it), the collectives by op and the kernels'
launches in it. ``--save DIR`` writes the rank's flows to
``DIR/flows_rank<r>.pt``. It runs on the card unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from raft_ncup_tpu_torch.cli import UPSAMPLER_CLASSES, add_device_arg, str2mesh
from raft_ncup_tpu_torch.config import UpsamplerConfig, flagship_config, small_model_config
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.ops.corr_cuda import lookup_levels
from raft_ncup_tpu_torch.ops.nconv_cuda import nconv2d_fused
from raft_ncup_tpu_torch.parallel import mesh as mesh_mod
from raft_ncup_tpu_torch.parallel import multihost
from raft_ncup_tpu_torch.utils.device import cudnn_autotune


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, nargs=2, default=[1088, 1920], metavar=("H", "W"))
    p.add_argument("--iters", type=int, default=32)
    p.add_argument("--spatial", "--spatial_parallel", type=int, default=1,
                   help="split the image height over this many processes, one per card")
    p.add_argument("--mesh", type=str2mesh, default=None, metavar="DATA,SPATIAL",
                   help="the mesh: DATA x SPATIAL processes, each data index running the "
                   "same pair (DATA x SPATIAL must be the launcher's world size)")
    p.add_argument("--precision", default="f32", choices=["f32", "bf16_infer"])
    p.add_argument("--small", action="store_true",
                   help="the small raft_nc_dbl (a quick drive on the CPU)")
    p.add_argument("--final_upsampling", default="NConvUpsampler",
                   choices=sorted(UPSAMPLER_CLASSES),
                   help="the final upsampler: NCUP (the flagship's), or the PAC or DJIF "
                   "head (PacJointUpsampleFull, DjifOriginal), each on a band under a mesh")
    p.add_argument("--save", default=None, metavar="DIR",
                   help="write this rank's flows to DIR/flows_rank<r>.pt")
    add_device_arg(p)
    return p


# The seed of the weights and of the frames.
SEED = 0


def frames(h: int, w: int, seed: int = SEED) -> tuple[torch.Tensor, torch.Tensor]:
    """The pair: a seeded random frame and the same frame shifted by a few
    pixels, float32 in [0, 255], (1, H, W, 3) on the host."""
    g = np.random.default_rng(seed)
    img1 = g.uniform(0, 255, (1, h, w, 3)).astype(np.float32)
    img2 = np.roll(img1, (3, 5), axis=(1, 2)).copy()
    return torch.from_numpy(img1), torch.from_numpy(img2)


def model_config(small: bool, precision: str, final_upsampling: str = "NConvUpsampler"):
    kw = dict(corr_impl="pallas", nconv_impl="pallas", precision=precision,
              upsampler=UpsamplerConfig(kind=UPSAMPLER_CLASSES[final_upsampling]))
    if small:
        return small_model_config("raft_nc_dbl", dataset="sintel", **kw)
    return flagship_config(dataset="sintel", **kw)


def _launches() -> dict:
    return {"corr_lookup": lookup_levels.launches, "nconv": nconv2d_fused.launches}


def run(args, device: torch.device) -> dict:
    """The two forwards on this rank and its report."""
    h, w = args.size
    mesh = None
    data, spatial = args.mesh_axes
    if spatial > 1:
        mesh = mesh_mod.make_mesh(data, spatial, device=device)
        if h % mesh_mod.pad_divisor(mesh):
            raise SystemExit(f"--size height {h} must divide by 8 * spatial = "
                             f"{mesh_mod.pad_divisor(mesh)} (pad with "
                             "InputPadder(divisor=...) first)")
    model = RAFT(model_config(args.small, args.precision, args.final_upsampling),
                 device=device, seed=SEED)
    img1, img2 = (t.to(device) for t in frames(h, w))
    cuda = device.type == "cuda"

    @cudnn_autotune()
    def forward():
        return model(img1, img2, iters=args.iters, mesh=mesh)

    t0 = time.perf_counter()
    forward()
    if cuda:
        torch.cuda.synchronize(device)
    first_s = time.perf_counter() - t0
    mesh_mod.reset_collective_stats()
    before = _launches()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    flow_lr, flow_up = forward()
    if cuda:
        end.record()
        torch.cuda.synchronize(device)
    wall_ms = 1e3 * (time.perf_counter() - t0)
    after = _launches()
    coll = mesh_mod.collective_stats()
    if args.save:
        os.makedirs(args.save, exist_ok=True)
        torch.save({"flow_lr": flow_lr.cpu(), "flow_up": flow_up.cpu()},
                   os.path.join(args.save, f"flows_rank{multihost.process_index()}.pt"))
    return {
        "shape": [1, h, w, 3], "iters": args.iters, "precision": args.precision,
        "final_upsampling": args.final_upsampling,
        "small": args.small, "platform": "gpu" if cuda else "cpu",
        "mesh": mesh_mod.mesh_fingerprint(mesh), "devices": multihost.process_count(),
        "rank": multihost.process_index(),
        "card": torch.cuda.get_device_name(device) if cuda else None,
        "first_s": first_s, "wall_ms": wall_ms,
        "device_ms": start.elapsed_time(end) if cuda else None,
        "finite": bool(torch.isfinite(flow_up).all()) and bool(torch.isfinite(flow_lr).all()),
        "peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
        **coll,
        "launches": {k: after[k] - before[k] for k in after},
    }


def mesh_axes(args) -> tuple[int, int]:
    """``(data, spatial)`` of the flags against the world the launcher
    started: ``--mesh`` and ``--spatial`` as the evaluate entry takes them,
    without a pipe axis (JAX's highres forward has none)."""
    mesh = args.mesh or (None, 1)
    spatial = max(mesh[1], args.spatial)
    mesh_mod.check_no_pipe(mesh[2] if len(mesh) > 2 else 1, "highres")
    return mesh_mod.check_axes(mesh[0], spatial, 1, multihost.world_size_hint()), spatial


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = multihost.local_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    args.mesh_axes = mesh_axes(args)
    already = multihost.initialized()
    joined = multihost.initialize_distributed(device=device) and not already
    try:
        report = run(args, device)
    finally:
        if joined:
            multihost.shutdown()
    print(json.dumps(report), flush=True)
    return 0 if report["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
