"""Input move-blocking (MpcConfig.input_blocks).

No reference counterpart (a standard real-time MPC technique); here it is a
throughput lever: the condensed QP's decision dim and constraint count
shrink with the number of free moves, and the dense interior-point cost is
~quadratic in both.
"""

import numpy as np
import pytest

from koopman_realizations.config import ArmConfig, MpcConfig, SysidConfig
from koopman_realizations.control import Ksim, make_kmpc
from koopman_realizations.control.kmpc import (
    dual_shift_perm_blocked,
    move_blocking,
)
from koopman_realizations.models.arm import Arm
from koopman_realizations.models.edmd import Ksysid


def _cfg(**kw):
    return MpcConfig(
        horizon=10, input_bounds=(-7 * np.pi / 8, 7 * np.pi / 8),
        input_slopeConst=1e-1, cost_running=10.0, cost_terminal=100.0,
        cost_input=(0.1 * 3e-2, 0.1 * 2e-2, 0.1 * 1e-2), proj_idx=(4, 5),
        **kw)


def _sim(arm_dataset, cfg):
    ks = Ksysid(arm_dataset, SysidConfig(model_type="bilinear",
                                         obs_type=("poly",), obs_degree=(3,),
                                         dim_red=True,
                                         dtype="float32")).train_models()
    arm = Arm(ArmConfig(Nmods=3, nlinks=1, L=1.0, m=0.1,
                        output_type="markers", substeps=3, newton_iters=2,
                        jac_mode="step"))
    return Ksim(arm, make_kmpc(ks.model, ks.scaler, cfg))


def test_move_blocking_structure():
    """Tb/Sel algebra and the reduced-row layout move_blocking promises:
    Sel is a left inverse of Tb, vacuous intra-group slope rows are gone,
    and the surviving rows are the builder's box-then-slope order with
    one 2m block per group (what dual_shift_perm_blocked relies on)."""
    from koopman_realizations.control.kmpc import input_constraint_rows

    m, Np, blocks = 3, 10, (1, 1, 2, 5)
    cfg = _cfg(input_blocks=blocks)

    class S:  # minimal scaler stub
        u_factor = np.ones(m)

        def u_down(self, u):
            return np.asarray(u)

    F, cF = input_constraint_rows(cfg, m, Np, S())
    Tb, Sel, Fr, F0, cr, kept = move_blocking(blocks, m, Np, F, cF)
    # kept indices match the independently derived structural ground truth
    from koopman_realizations.control.kmpc import expected_blocked_keep
    np.testing.assert_array_equal(kept, expected_blocked_keep(cfg, m, Np,
                                                              blocks))
    nf = len(blocks)
    assert Tb.shape == ((Np - 1) * m, nf * m)
    np.testing.assert_allclose(Sel @ Tb, np.eye(nf * m))
    # full U tail reconstructed from free moves is constant within groups
    V = np.arange(nf * m, dtype=float)
    U = (Tb @ V).reshape(Np - 1, m)
    s = 0
    for L in blocks:
        for k in range(s, s + L):
            np.testing.assert_allclose(U[k], U[s])
        s += L
    # no zero rows survive; box section = nf blocks of 2m, then slope ditto
    assert (np.abs(Fr).sum(axis=1) + np.abs(F0).sum(axis=1) > 0).all()
    assert Fr.shape[0] == 2 * 2 * m * nf
    # feasibility is preserved: any V satisfying the reduced stack expands
    # to a U satisfying every surviving full-stack row by construction
    perm = dual_shift_perm_blocked(cfg, m, nf)
    assert perm.size == Fr.shape[0]
    assert perm.max() < Fr.shape[0]


def test_identity_blocking_matches_unblocked(arm_dataset, blockM_ref):
    """blocks=(1,)*9 changes nothing mathematically; the closed loop must
    reproduce the unblocked trajectory (same QP in a permuted-identity
    basis, same warm starts)."""
    sim_u = _sim(arm_dataset, _cfg(qp_iters=10))
    sim_b = _sim(arm_dataset, _cfg(qp_iters=10, input_blocks=(1,) * 9))
    r_u = sim_u.run_trial_mpc(blockM_ref["y"], steps=60)
    r_b = sim_b.run_trial_mpc(blockM_ref["y"], steps=60)
    np.testing.assert_allclose(np.asarray(r_b["Y"]), np.asarray(r_u["Y"]),
                               rtol=0, atol=2e-4)


def test_blocked_tracking_quality(arm_dataset, blockM_ref):
    """Aggressive blocking (4 free moves of 9) must hold bilinear-class
    blockM tracking (golden mean is 0.0203 over the full trajectory)."""
    sim = _sim(arm_dataset, _cfg(qp_iters=10, input_blocks=(1, 1, 2, 5)))
    res = sim.run_trial_mpc(blockM_ref["y"], steps=150)
    err = np.asarray(res["err"])
    assert np.isfinite(err).all()
    assert err.mean() < 0.032, err.mean()   # transient-weighted 150 steps


def test_blocked_rti_regime(arm_dataset, blockM_ref):
    """The blocked RTI config (qp_iters=3 + dual warm) must match the
    converged blocked run -- the CI pin of the round-3 multi-ref finding."""
    sim10 = _sim(arm_dataset, _cfg(qp_iters=10, input_blocks=(1, 1, 2, 5)))
    sim3 = _sim(arm_dataset, _cfg(qp_iters=3, qp_dual_warm=True,
                                  input_blocks=(1, 1, 2, 5)))
    X0 = np.zeros((4, 6))
    X0[:, 0] = np.linspace(-0.2, 0.2, 4)
    o10 = sim10.run_batch(blockM_ref["y"], X0, steps=150)
    o3 = sim3.run_batch(blockM_ref["y"], X0, steps=150)
    assert o3["alive"][:, -1].all()
    e10 = o10["err"].mean(axis=1)
    e3 = o3["err"].mean(axis=1)
    assert e3.mean() <= e10.mean() * 1.05 + 1e-4


def test_blocking_rejects_unsupported():
    with pytest.raises(ValueError):
        move_blocking((1, 2), 3, 10, np.zeros((0, 30)), np.zeros(0))
    # zero/negative group lengths that happen to sum to Np-1 must be loud
    # errors, not silently-singular reduced problems
    with pytest.raises(ValueError):
        move_blocking((0, 1, 3, 5), 3, 10, np.zeros((0, 30)), np.zeros(0))
    with pytest.raises(ValueError):
        move_blocking((2, -1, 8), 3, 10, np.zeros((0, 30)), np.zeros(0))


def test_identity_blocking_linear_and_nmpc(arm_dataset, blockM_ref):
    """All three controller types accept input_blocks; identity blocking
    must reproduce the unblocked trajectory for each."""
    for mt, steps, atol in (("linear", 40, 2e-4), ("nonlinear", 25, 5e-4)):
        ks = Ksysid(arm_dataset, SysidConfig(
            model_type=mt, obs_type=("poly",), obs_degree=(3,),
            dim_red=True, pca_explained=99.99 if mt == "nonlinear" else 99.0,
            dtype="float32")).train_models()
        arm = Arm(ArmConfig(Nmods=3, nlinks=1, L=1.0, m=0.1,
                            output_type="markers", substeps=3,
                            newton_iters=2, jac_mode="step"))
        r_u = Ksim(arm, make_kmpc(ks.model, ks.scaler, _cfg(qp_iters=10))) \
            .run_trial_mpc(blockM_ref["y"], steps=steps)
        r_b = Ksim(arm, make_kmpc(ks.model, ks.scaler, _cfg(
            qp_iters=10, input_blocks=(1,) * 9))) \
            .run_trial_mpc(blockM_ref["y"], steps=steps)
        np.testing.assert_allclose(np.asarray(r_b["Y"]),
                                   np.asarray(r_u["Y"]), rtol=0, atol=atol,
                                   err_msg=mt)


def test_blocked_nmpc_tracking_quality(arm_dataset, blockM_ref):
    """Blocked NMPC must stay in the golden-beating class (unblocked
    full-trajectory mean is 0.0142 vs the 0.0192 golden; blocked (1,1,2,5)
    measured 0.0143)."""
    ks = Ksysid(arm_dataset, SysidConfig(
        model_type="nonlinear", obs_type=("poly",), obs_degree=(3,),
        dim_red=True, pca_explained=99.99, dtype="float32")).train_models()
    arm = Arm(ArmConfig(Nmods=3, nlinks=1, L=1.0, m=0.1,
                        output_type="markers", substeps=3, newton_iters=2,
                        jac_mode="step"))
    sim = Ksim(arm, make_kmpc(ks.model, ks.scaler,
                              _cfg(input_blocks=(1, 1, 2, 5))))
    res = sim.run_trial_mpc(blockM_ref["y"], steps=120)
    err = np.asarray(res["err"])
    assert np.isfinite(err).all()
    assert err.mean() < 0.035, err.mean()   # transient-weighted 120 steps
