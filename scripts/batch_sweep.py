"""Steps/s of the bench's closed loop across batch sizes, on one GPU.

Trains the bench model once, then runs ``bench.measure`` for each batch
size, one JSON line each (stdout, and appended to ``--out`` when given).
The card's name and power limit come first.

Run:  python scripts/batch_sweep.py --batches 8192,32768,131072,262144
          [--qp-iters 4] [--steps 301] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import bench  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="8192,32768,131072,262144")
    ap.add_argument("--qp-iters", type=int, default=bench.QP_ITERS)
    ap.add_argument("--steps", type=int, default=bench.STEPS)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    bench.require_gpu()
    bench.setup_compile_cache()
    print(bench.card(), flush=True)
    sim, ref_y = bench.build_sim(args.qp_iters)
    for batch in (int(b) for b in args.batches.split(",")):
        res = bench.measure(batch, args.steps, args.qp_iters,
                            reps=args.reps, sim=sim, ref_y=ref_y)
        line = json.dumps(res)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
