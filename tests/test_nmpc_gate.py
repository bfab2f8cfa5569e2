"""Batched-NMPC quality gate.

A silent regression in the batched SQP path must fail CI.  This is the
bench-style workload --
full 301-step blockM, spread initial conditions, production bench knobs
(substeps=3, newton_iters=2, jac_mode='step') -- at B=64 on the virtual CPU
mesh.  Calibration at B=64: err_mean 0.029-0.031, worst lane ~0.078;
golden single-lane K-NMPC is 0.0192
(``Ksim.m`` results).

Measured chaos floor (round 3): perturbing X0 by 1e-6 on an UNCHANGED
controller moves err_mean by up to ~0.003 at B=64 (per-lane mean |delta|
0.0065, max 0.049) -- the 301-step closed loop is chaotic at f32, so this
gate's margin (0.033) absorbs reordering-level numerical changes while
still catching real regressions (a broken QP route shifts err by >10x the
floor or kills lanes).
"""

import numpy as np
import pytest

from koopman_realizations.config import ArmConfig, MpcConfig, SysidConfig
from koopman_realizations.control import Ksim, make_kmpc
from koopman_realizations.models.arm import Arm
from koopman_realizations.models.edmd import Ksysid


@pytest.mark.slow
def test_batched_nmpc_spread_x0_gate(arm_dataset, blockM_ref):
    import jax

    ks = Ksysid(arm_dataset, SysidConfig(
        model_type="nonlinear", obs_type=("poly",), obs_degree=(3,),
        dim_red=True, pca_explained=99.99, dtype="float32")).train_models()
    cfg = MpcConfig(
        horizon=10, input_bounds=(-7 * np.pi / 8, 7 * np.pi / 8),
        input_slopeConst=1e-1, cost_running=10.0, cost_terminal=100.0,
        cost_input=(0.1 * 3e-2, 0.1 * 2e-2, 0.1 * 1e-2), proj_idx=(4, 5))
    arm = Arm(ArmConfig(Nmods=3, nlinks=1, L=1.0, m=0.1,
                        output_type="markers", substeps=3, newton_iters=2,
                        jac_mode="step"))
    B = 64
    X0 = np.zeros((B, 6), np.float32)
    X0[:, 0] = np.linspace(-0.2, 0.2, B)       # the bench's spread
    W = np.zeros((B, 2), np.float32)

    sim = Ksim(arm, make_kmpc(ks.model, ks.scaler, cfg))
    runner = sim.batched_runner(blockM_ref["y"], steps=301,
                                record=("Y", "R", "alive"))
    out = jax.block_until_ready(runner(X0, W))

    alive = np.asarray(out["alive"])[:, -1]
    assert alive.all(), f"lanes died: {np.flatnonzero(~alive)}"
    Y, R = np.asarray(out["Y"]), np.asarray(out["R"])
    err = np.sqrt(((R - Y[..., 4:6]) ** 2).sum(-1))
    assert err.mean() <= 0.033, f"err_mean {err.mean():.4f} > gate 0.033"
    assert err.mean(1).max() <= 0.12, \
        f"worst lane {err.mean(1).max():.4f} > gate 0.12"
