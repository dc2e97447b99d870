#!/usr/bin/env python3
"""Where a served and a streamed batch's host time goes: the serve entry's
``--report`` span p50s of one checkout on the card.

    python3 chip_spans.py TREE LABEL

runs ``python3 -m raft_ncup_tpu_torch.serve`` from the checkout ``TREE``
(a ``git archive`` of a commit, or ``.``) four times: the flagship served
(8 requests at 436x1024, batch sizes 1 and 2, level 12) and streamed (4
streams of 8 frames, batch sizes 1, 2 and 4, 12 iterations), each in f32
and under ``bf16_infer``. For each it prints one ``spans LABEL ...:`` line
with pairs/s or frames/s, p50/p99 and the report's ``stages`` (p50/p99 of
``serve_pad_stage``, ``serve_dispatch``, ``serve_drain`` and the stream's
counterparts), beside the card's name and power limit. Run two checkouts
in one chip call to compare them.
"""
import json
import os
import subprocess
import sys


def main() -> int:
    if len(sys.argv) != 3:
        print("usage: python3 chip_spans.py TREE LABEL", file=sys.stderr)
        return 2
    tree, label = sys.argv[1], sys.argv[2]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    flight = os.path.join(os.path.abspath(tree), "flight_recorder")
    serve = ["--size", "436", "1024", "--num_requests", "8", "--iter_levels", "12",
             "--serve_batch_sizes", "1,2", "--queue_capacity", "16", "--report",
             "--flight_dir", flight]
    stream = ["--stream", "--model", "raft_nc_dbl", "--size", "436", "1024", "--n_streams", "4",
              "--frames_per_stream", "8", "--stream_iters", "12", "--stream_batch_sizes", "1,2,4",
              "--stream_capacity", "8", "--report", "--flight_dir", flight]
    runs = [("serve f32", serve), ("serve bf16_infer", serve + ["--serve_precision", "bf16_infer"]),
            ("stream f32", stream),
            ("stream bf16_infer", stream + ["--stream_precision", "bf16_infer"])]
    rc = 0
    for name, argv in runs:
        p = subprocess.run([sys.executable, "-m", "raft_ncup_tpu_torch.serve", "--device", "cuda",
                            *argv], cwd=tree, capture_output=True, text=True)
        lines = p.stdout.strip().splitlines()
        try:
            rep = json.loads(lines[-1])
        except (IndexError, ValueError):
            print(f"spans {label} {name}: rc {p.returncode}\n{p.stderr[-3000:]}", flush=True)
            rc = 1
            continue
        keep = {k: rep.get(k) for k in ("serve_pairs_per_sec", "serve_p50_ms", "serve_p99_ms",
                                        "stream_frames_per_sec", "stream_p50_ms", "stream_p99_ms",
                                        "serve_batches", "stream_batches", "errors", "stages")}
        print(f"spans {label} {name}: rc {p.returncode} {json.dumps(keep)} | {card}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
