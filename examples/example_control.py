"""Closed-loop trajectory tracking with K-MPC / K-BMPC / K-NMPC on the
blockM trajectory (reference ``example_control.m``).

Trains on the in-repo arm corpus (``utils.data.generate_arm_data``) unless
``--datafile`` names a reference datafile; ``--golden DIR`` adds the
reference's golden blockM result structs for comparison.

Run:  python examples/example_control.py [--steps N] [--batch B]
          [--datafile PATH] [--golden DIR]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from koopman_realizations.config import ArmConfig, MpcConfig, SysidConfig
from koopman_realizations.control import Ksim, make_kmpc
from koopman_realizations.models.arm import Arm
from koopman_realizations.models.edmd import Ksysid
from koopman_realizations.utils.data import generate_arm_data
from koopman_realizations.utils.matio import (
    load_data4sysid,
    load_sim_results,
)
from koopman_realizations.utils.trajectories import (
    get_blockM,
    make_trajectory,
)

GOLD_FILES = {
    "linear": "linear_poly-3_n-6_m-3_del-0_2020-06-09_16-42.mat",
    "bilinear": "bilinear_poly-3_n-6_m-3_del-0_2020-06-09_16-43.mat",
    "nonlinear": "nonlinear_poly-3_n-6_m-3_del-0_2020-06-13_14-10.mat",
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=0,
                    help="additionally run a batch of B perturbed scenarios")
    ap.add_argument("--datafile", default=None,
                    help="train on this datafile instead of the in-repo "
                         "corpus")
    ap.add_argument("--golden", default=None,
                    help="directory of the reference's golden blockM "
                         "result structs")
    args = ap.parse_args()

    data = load_data4sysid(args.datafile) if args.datafile \
        else generate_arm_data(seed=0)
    ref = make_trajectory(get_blockM([0.45, -0.35], 0.5, 0.5), T=15.0,
                          Ts=0.05, flip_y=True)
    arm = Arm(ArmConfig(Nmods=3, nlinks=1, L=1.0, m=0.1,
                        output_type="markers", substeps=5))
    mpc_cfg = MpcConfig(
        horizon=10, input_bounds=(-7 * np.pi / 8, 7 * np.pi / 8),
        input_slopeConst=1e-1, cost_running=10.0, cost_terminal=100.0,
        cost_input=(0.1 * 3e-2, 0.1 * 2e-2, 0.1 * 1e-2), proj_idx=(4, 5))

    for model_type in ("linear", "bilinear", "nonlinear"):
        # nonlinear: 99.99% PCA keeps the vector field accurate enough for
        # the SQP transient (the 99% default truncation creates false
        # optima; see tests/test_closed_loop.py::test_nonlinear_kmpc_blockM)
        pca = 99.99 if model_type == "nonlinear" else 99.0
        ks = Ksysid(data, SysidConfig(model_type=model_type,
                                      obs_type=("poly",), obs_degree=(3,),
                                      dim_red=True,
                                      pca_explained=pca)).train_models()
        sim = Ksim(arm, make_kmpc(ks.model, ks.scaler, mpc_cfg))
        t0 = time.time()
        res = sim.run_trial_mpc(ref["y"], steps=args.steps)
        dt = time.time() - t0
        line = (f"{model_type:9s}: err mean {res['err'].mean():.4f} "
                f"max {res['err'].max():.4f}  "
                f"({res['err'].shape[0]} steps, {dt:.1f}s)")
        gold_path = os.path.join(args.golden or "", GOLD_FILES[model_type])
        if args.golden and os.path.exists(gold_path):
            g = load_sim_results(gold_path)
            line += (f"   [reference: mean {g['err'].mean():.4f} "
                     f"max {g['err'].max():.4f}]")
        print(line)

        if args.batch and model_type == "bilinear":
            X0 = np.zeros((args.batch, 6))
            X0[:, :3] = np.random.default_rng(0).uniform(
                -0.2, 0.2, (args.batch, 3))
            t0 = time.time()
            out = sim.run_batch(ref["y"], X0, steps=args.steps)
            dt = time.time() - t0
            n_steps = out["err"].shape[0] * out["err"].shape[1]
            print(f"  batch {args.batch}: {n_steps / dt:,.0f} MPC steps/s, "
                  f"err mean {out['err'].mean():.4f}, "
                  f"alive {out['alive'][:, -1].mean():.2f}")


if __name__ == "__main__":
    main()
