"""A tiny rank for the launcher's test: joins a gloo world from the
launcher's environment, sums its rank over the world, and rank 0 prints
the sum as its last line. ``--fail R`` makes rank R exit with code 7 after
joining; ``--hang R`` makes rank R sleep, so the others wait for it in
their collective."""

import argparse
import os
import sys
import time

import torch
import torch.distributed as dist


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fail", type=int, default=-1)
    ap.add_argument("--hang", type=int, default=-1)
    ap.add_argument("--rank", type=int, required=True)
    args = ap.parse_args()
    assert args.rank == int(os.environ["RANK"])
    dist.init_process_group("gloo", init_method="env://")
    rank = dist.get_rank()
    with open(os.path.join(os.environ["FLOWBENCH_PIDS"], str(os.getpid())), "w"):
        pass
    if rank == args.fail:
        return 7
    if rank == args.hang:
        time.sleep(3600)
    t = torch.tensor([float(rank)])
    dist.all_reduce(t)
    dist.destroy_process_group()
    if rank == 0:
        print(f"sum {int(t.item())}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
