"""One rank of the held 4K mesh cell (``flowbench/held``) run small on the CPU over gloo (the
launcher's ``--rank`` as its argument), ended as ``flowbench/run.py``
ends a rank: rank 0 prints the result line. ``--fault no_exchange`` makes
every halo exchange bring zeros, as if the exchange between the cards
were left out; ``--fault jax_on_follower`` puts a module named ``jax``
into rank 2's ``sys.modules``."""

import argparse
import os
import sys
import types

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from flowbench import harness, run  # noqa: E402

SMALL = {"frame_hw": [128, 64], "distinct_pairs": 3, "iter_levels": [3], "warm_requests": 2,
         "keep_every": 1, "check_answers": 2}


def _zero_halos():
    from raft_ncup_tpu_torch.parallel import halo

    def extend(x, top, bottom, dim=2):
        h = x.shape[dim]
        if top < 0:
            x, h, top = x.narrow(dim, -top, h + top), h + top, 0
        if bottom < 0:
            x, h, bottom = x.narrow(dim, 0, h + bottom), h + bottom, 0
        shape = list(x.shape)
        parts = []
        for rows in (top, bottom):
            shape[dim] = rows
            parts.append(x.new_zeros(shape))
        return torch.cat([parts[0], x, parts[1]], dim=dim)

    halo.extend = extend


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fault", default=None)
    ap.add_argument("--rank", type=int, required=True)
    args = ap.parse_args()
    harness.scrub_environment()
    if args.fault == "no_exchange":
        _zero_halos()
    if args.fault == "jax_on_follower" and args.rank == 2:
        sys.modules["jax"] = types.ModuleType("jax")
    bm = harness.with_held(harness.load_benchmark(), "ncup.uhd.mesh4")
    outcome, result = harness.run_cell("ncup.uhd.mesh4", 2 ** 32 + 3, 2.0, False, device="cpu",
                                       overrides=SMALL, bm=bm)
    return run.finish(outcome, result)


if __name__ == "__main__":
    sys.exit(main())
