"""Closed-loop lasso sweep: all candidate models vmapped in one batch."""

import numpy as np

from koopman_realizations.config import ArmConfig, MpcConfig, SysidConfig
from koopman_realizations.models.arm import Arm
from koopman_realizations.models.edmd import Ksysid
from koopman_realizations.workflows.lasso_sweep import lasso_sweep_closed_loop


def test_lasso_sweep_closed_loop(arm_dataset, blockM_ref):
    ks = Ksysid(arm_dataset, SysidConfig(
        model_type="bilinear", obs_type=("poly",), obs_degree=(3,),
        dim_red=True, lasso=(8.0, float("inf")), lasso_iters=500)
    ).train_models()
    assert len(ks.candidates) == 2
    arm = Arm(ArmConfig(Nmods=3, nlinks=1, L=1.0, m=0.1,
                        output_type="markers", substeps=5))
    cfg = MpcConfig(horizon=10, input_bounds=(-7 * np.pi / 8, 7 * np.pi / 8),
                    input_slopeConst=1e-1, cost_running=10.0,
                    cost_terminal=100.0, cost_input=(3e-3, 2e-3, 1e-3),
                    proj_idx=(4, 5))
    out = lasso_sweep_closed_loop(ks, arm, cfg, blockM_ref["y"], steps=100)
    assert out["err"].shape[0] == 2
    assert out["alive"][:, -1].all()
    # the unregularized candidate tracks in the golden bilinear class
    errs = dict(zip(out["lasso"], out["err"].mean(axis=1)))
    assert errs[float("inf")] < 0.05
    # the L1-constrained candidate still controls (bounded error)
    assert errs[8.0] < 0.15
