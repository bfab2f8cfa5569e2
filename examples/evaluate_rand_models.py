"""Model-class comparison over random-system ensembles (reference
``evaluate_rand_models.m``): 13 linear + 6 bilinear + 4 nonlinear model fits
per system, all systems trained simultaneously per configuration.

Run:  python examples/evaluate_rand_models.py [--folder PATH] [--generate S]
"""

import argparse
import glob
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from koopman_realizations.models.rsys import construct_systems, simulate_systems
from koopman_realizations.utils.matio import load_rsys_all
from koopman_realizations.workflows import evaluate_rand_models


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--folder", default=None,
                    help="a rand-systems_* folder holding rsys-all_*.mat")
    ap.add_argument("--generate", type=int, default=0,
                    help="instead, generate this many fresh random systems")
    args = ap.parse_args()

    if args.generate:
        rng = np.random.default_rng(0)
        ens = construct_systems(args.generate, num_terms=5, degree_x=4,
                                degree_u=1, rng=rng)
        datasets = simulate_systems(ens, t_end=50.0, Ts=0.05, num_trials=11,
                                    rng=rng)
        print(f"generated {args.generate} random systems")
    else:
        folder, datasets = args.folder, None
        if folder is not None:
            files = glob.glob(folder + "/rsys-all_*.mat")
            if files:
                datasets = load_rsys_all(files[0])
        if datasets is None:
            sys.exit("no rsys-all_*.mat ensemble found; pass --folder or "
                     "--generate N")
        print(f"loaded {len(datasets)} systems from {folder}")

    t0 = time.time()
    out = evaluate_rand_models(datasets)
    n_fits = (13 + 6 + 4) * len(datasets)
    print(f"{n_fits} model fits in {time.time() - t0:.1f}s")
    for fam in ("linear", "bilinear", "nonlinear"):
        o = out[fam]
        print(f"\n{fam} (kept {o['kept']}/{len(datasets)} systems):")
        for d, e in zip(o["dims"], o["median"]):
            bar = "#" * int(min(e, 1.0) * 50)
            print(f"  N={d:3d}  median normed err {e:8.4f}  {bar}")


if __name__ == "__main__":
    main()
