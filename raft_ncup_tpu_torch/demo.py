"""Flow on a folder of frames: ``python -m raft_ncup_tpu_torch.demo``.

Port of the root ``demo.py``: for each pair of consecutive frames
(PNG, JPEG or PPM; the JAX demo globs PNG and JPEG) in ``--path``, one
test-mode forward and a PNG under ``--output`` of the first frame above
the colour-coded flow, written with the port's own codec. The model comes from the model flags and
``--restore_ckpt`` (or ``--model`` naming a checkpoint file or directory,
as in the reference's demo, which then runs ``raft``), loaded as the
evaluate entry loads it. ``--show`` raises: the card has no display.

It runs on the card unless ``--device cpu`` is given. Example::

    python -m raft_ncup_tpu_torch.demo --path demo-frames --output demo_out
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

from raft_ncup_tpu_torch.cli import add_model_args, model_config_from_args
from raft_ncup_tpu_torch.evaluate import load_model
from raft_ncup_tpu_torch.inference.pipeline import ShapeCachedForward
from raft_ncup_tpu_torch.io import read_image, write_png
from raft_ncup_tpu_torch.ops.padding import InputPadder
from raft_ncup_tpu_torch.viz import flow_to_image


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--path", required=True, help="folder of frames")
    p.add_argument("--output", default="demo_out")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--show", action="store_true",
                   help="display each result (not supported: no display on the card)")
    p.add_argument("--restore_ckpt", default=None,
                   help="a port train state or a reference .pth")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the model weights when no checkpoint is given")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    add_model_args(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.show:
        raise SystemExit("--show needs a display; the results are written to --output")
    ckpt = args.restore_ckpt
    if os.path.exists(args.model):  # the reference demo's --model is the checkpoint
        ckpt, args.model = args.model, "raft"
    model = load_model(model_config_from_args(args, dataset="sintel"), ckpt, args.device,
                       args.seed)
    files = sorted(glob.glob(os.path.join(args.path, "*.png"))
                   + glob.glob(os.path.join(args.path, "*.jpg"))
                   + glob.glob(os.path.join(args.path, "*.ppm")))
    if len(files) < 2:
        raise SystemExit(f"need >= 2 frames in {args.path}")
    os.makedirs(args.output, exist_ok=True)
    fwd = ShapeCachedForward(model)
    for f1, f2 in zip(files[:-1], files[1:]):
        img1 = read_image(f1).astype(np.float32)[None]
        img2 = read_image(f2).astype(np.float32)[None]
        padder = InputPadder(img1.shape)
        (t, b), (le, r) = padder.pad_spec
        spec = ((0, 0), (t, b), (le, r), (0, 0))
        _, flow_up = fwd.forward(np.pad(img1, spec, mode="edge"),
                                 np.pad(img2, spec, mode="edge"), args.iters)
        flow = padder.unpad(flow_up)[0].cpu().numpy()
        vis = np.concatenate([img1[0].astype(np.uint8), flow_to_image(flow)], axis=0)
        out = os.path.join(args.output,
                           os.path.splitext(os.path.basename(f1))[0] + "_flow.png")
        write_png(out, vis)
        print(f"{f1} -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
