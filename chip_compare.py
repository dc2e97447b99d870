#!/usr/bin/env python3
"""Times the correlation-lookup kernel (A), its backward (A') and the
NConv2d backward (B') of several checkouts of this repository on the
same inputs, on one NVIDIA card.

    python3 chip_compare.py DIR [DIR ...]

Each DIR is the root of a checkout of the repository (``.`` is this one;
``git archive`` another commit into a directory that ``.gitignore``
lists). Every checkout runs in a process of its own, first in the order
given and then in reverse (A, B, B, A), so that a drift of the card
over the run shows as a difference between a checkout's two runs. A
process builds its checkout's kernel, draws the inputs from seed 0 with
this script's ``chip_smoke.py`` (so every checkout sees the same
inputs; the A' and B' rows draw from ``chip_smoke.backward_generator``,
so they are the inputs that ``chip_smoke.py`` checks and times), and
for each row

- holds the kernel against its plain version, within ``CORR_TOL`` for A
  and within ``GRAD_TOL`` of each gradient's largest value for A' and B';
- times it as ``chip_smoke.py`` does (CUDA events over 20 runs, 10 for
  A', a cold L2 before each);
- reads the tiles of each of the kernel's paths (and A''s d f2 row
  adds), where the checkout counts them.

The rows: A at the served shape (random and smooth flow) and at
1088x1920; A' at the training shape (B=6, 50x90, C=256) with random and
smooth flow, as the model launches it (d f1s and d f2); B' at each of the
four NCUP layers of a training batch (12 planes of 400x720), with the
upstream gradients the model gives them. For the served shape with
smooth flow it also times each pyramid level alone, and the host's time
per call of the kernel's wrapper (ctypes and launch, with the card busy
behind it). Each result is one JSON line starting ``compare:``; the
card's name and power limit come first. Any failed check exits
non-zero.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROWS = [  # (name, B, H, W, mix): level-0 query sizes as in chip_smoke.py
    ("served random", 2, 55, 128, "random"),
    ("served smooth", 2, 55, 128, "smooth"),
    ("1088x1920 random", 1, 136, 240, "random"),
]
RADIUS, CHANNELS, LEVELS = 4, 256, 4
HOST_CALLS = 200
BWD_MIXES = ("random", "smooth")  # kernel A' rows, at chip_smoke.TRAIN_CORR


def _chip_smoke():
    """This script's chip_smoke.py, whatever checkout is first on the path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_inputs", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(tree: str) -> int:
    """Times the kernels of the checkout at ``tree``; prints a JSON line
    per row."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    cs = _chip_smoke()
    from raft_ncup_tpu_torch.ops import corr_cuda, cuda_build

    cuda_build.build()
    registers = {name: [ln.strip() for ln in cuda_build.build_log(name).splitlines()
                        if "registers" in ln or "spill" in ln]
                 for name in cuda_build.KERNELS}
    if any(registers.values()):  # built in this process
        print("compare: " + json.dumps(dict(tree=tree, row="build", ptxas=registers)),
              flush=True)

    gen = torch.Generator().manual_seed(0)
    flush = torch.empty(64 * 2**20 // 4, device="cuda")
    ok = True
    for name, B, H, W, mix in ROWS:
        f1s, lv, coords = cs.corr_inputs(torch, gen, B, H, W, CHANNELS, LEVELS, mix)

        def run(levels=lv, c=coords):
            return corr_cuda.lookup_levels(f1s, levels, c, RADIUS)

        counted = hasattr(corr_cuda, "path_tiles")
        if counted:
            corr_cuda.reset_path_tiles()
        out = run()
        paths = corr_cuda.path_tiles() if counted else None
        ref = corr_cuda.lookup_pyramid(f1s, lv, coords, RADIUS)
        err, good = cs.max_err(torch, out, ref, **cs.CORR_TOL)
        del out, ref
        ok = ok and good
        row = dict(tree=tree, row=name, max_abs_err=err, ms=cs.cuda_ms(torch, run, 20, flush),
                   path_tiles=paths)
        if mix == "smooth" and B == 2:
            row["level_ms"] = [
                cs.cuda_ms(torch, lambda l=l: run([lv[l]], (coords / 2**l).contiguous()),
                           20, flush)
                for l in range(LEVELS)]
            torch.cuda.synchronize()
            torch.cuda._sleep(400_000_000)  # keeps the card busy behind the calls
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                run()
            row["host_us_per_call"] = 1e6 * (time.perf_counter() - t0) / HOST_CALLS
            torch.cuda.synchronize()
        print("compare: " + json.dumps(row), flush=True)
    ok = backward_rows(torch, cs, flush, tree) and ok
    return 0 if ok else 1


def backward_rows(torch, cs, flush, tree) -> bool:
    """The A' rows (both mixes) and the B' rows (the four layers), each
    set drawn from its own ``backward_generator`` as ``chip_smoke.py``
    draws them; whether every row agreed with its plain version."""
    ok = True
    gen = cs.backward_generator(torch)
    for mix in BWD_MIXES:
        ok = corr_bwd_row(torch, cs, gen, flush, tree, mix) and ok
    gen = cs.backward_generator(torch)
    for name, k, cin, cout in cs.NCUP_LAYERS:
        ok = nconv_bwd_row(torch, cs, gen, flush, tree, name, k, cin, cout) and ok
    return ok


def corr_bwd_row(torch, cs, gen, flush, tree, mix) -> bool:
    """Kernel A' of the checkout at the training shape, as the model
    launches it (d f1s and d f2), against the plain autograd; timed."""
    from raft_ncup_tpu_torch.ops import corr_cuda

    s = cs.TRAIN_CORR
    f1s, lv, coords, g = cs.corr_bwd_inputs(torch, gen, mix)
    needs = (True, True, False)

    def run():
        return corr_cuda.lookup_levels_backward(f1s, lv, coords, s["radius"], g, needs)

    counted = hasattr(corr_cuda, "backward_counts")
    if counted:
        corr_cuda.reset_backward_counts()
    got = run()
    counts = corr_cuda.backward_counts() if counted else None
    ref = cs.corr_bwd_ref(torch, f1s, lv, coords, s["radius"], g, needs)
    errs = [cs.grad_err(torch, got[0], ref[0])]
    errs += [cs.grad_err(torch, a, b) for a, b in zip(got[1], ref[1])]
    del got, ref
    good = all(same and e <= cs.GRAD_TOL for e, same, _ in errs)
    row = dict(tree=tree, row=f"A' training {mix}", max_rel_err=max(e for e, _, _ in errs),
               ms=cs.cuda_ms(torch, run, 10, flush), counts=counts)
    print("compare: " + json.dumps(row), flush=True)
    return good


def nconv_bwd_row(torch, cs, gen, flush, tree, name, k, cin, cout) -> bool:
    """Kernel B' of the checkout at one NCUP layer of a training batch,
    against its plain version in float64; timed."""
    from raft_ncup_tpu_torch.ops import nconv_cuda

    args = cs.nconv_bwd_inputs(torch, gen, name, k, cin, cout)
    errs = cs.nconv_bwd_errs(torch, nconv_cuda.nconv2d_backward(*args), args)
    good = all(same and e <= cs.GRAD_TOL for e, same, _ in errs)
    row = dict(tree=tree, row=f"B' {name}", max_rel_err=max(e for e, _, _ in errs),
               ms=cs.cuda_ms(torch, lambda: nconv_cuda.nconv2d_backward(*args), 20, flush))
    print("compare: " + json.dumps(row), flush=True)
    return good


def main(trees: list[str]) -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_compare: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device; this comparison runs only on the card",
              file=sys.stderr)
        return 2
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    print("card: " + _chip_smoke().card_line(), flush=True)
    failed = []
    for tree in trees + trees[::-1]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree],
                              capture_output=True, text=True, timeout=900)
        for line in proc.stdout.splitlines():
            if line.startswith("compare: "):
                print(line, flush=True)
        if proc.returncode != 0:
            failed.append(tree)
            print(f"chip_compare: {tree} failed ({proc.returncode}):\n"
                  f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        sys.exit(child(sys.argv[2]))
    sys.exit(main(sys.argv[1:]))
