"""Regenerate an arm training corpus (reference ``Arm_setup.m`` +
``Arm.simulate_rampNhold`` + ``Data.get_data4sysid``).

All excitation trials run as one vmapped batch
(``koopman_realizations.utils.data.generate_arm_data``).

Run:  python examples/generate_arm_data.py [--trials 15] [--tf 60] [--out PATH]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from koopman_realizations.utils.data import generate_arm_data


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=15)
    ap.add_argument("--tf", type=float, default=60.0)
    ap.add_argument("--val", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    ds = generate_arm_data(args.trials, args.tf, n_val=args.val)
    print(f"generated {len(ds.train)} train + {len(ds.val)} val trials, "
          f"T={ds.train[0].T}, y dim {ds.train[0].n}")
    if args.out:
        payload = {
            "train": [{"t": tr.t, "y": tr.y, "u": tr.u, "x": tr.x, "w": tr.w}
                      for tr in ds.train],
            "val": [{"t": tr.t, "y": tr.y, "u": tr.u, "x": tr.x, "w": tr.w}
                    for tr in ds.val],
        }
        import scipy.io as sio

        sio.savemat(args.out, payload)
        print("saved ->", args.out)


if __name__ == "__main__":
    main()
