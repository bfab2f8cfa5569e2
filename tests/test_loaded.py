"""Loaded-system pipeline: data gen with loads -> loaded model -> observer.

The reference's loaded experiments (circle trajectory, end-effector mass +
tilted gravity, ``BASELINE.md`` row 5) used a training set that is not
shipped, so this test regenerates a loaded dataset with the JAX arm and
checks the qualitative golden result: the load observer recovers the true
load and improves closed-loop tracking under load.
"""

import numpy as np
import pytest

from koopman_realizations.config import ArmConfig, MpcConfig, SysidConfig
from koopman_realizations.control import Ksim, make_kmpc, make_load_observer
from koopman_realizations.models.arm import Arm
from koopman_realizations.models.edmd import Ksysid
from koopman_realizations.types import DataSet, Trial
from koopman_realizations.utils.trajectories import get_circle, make_trajectory


@pytest.fixture(scope="module")
def loaded_setup():
    arm = Arm(ArmConfig(Nmods=2, nlinks=1, L=1.0, m=0.1, output_type="markers",
                        substeps=5))
    rng = np.random.default_rng(7)
    # dense load-grid excitation: sparse grids leave the loaded operator
    # unstable in open loop (rho(A) > 1)
    loads = [(a, b) for a in (0.0, 0.33, 0.66, 1.0)
             for b in (-1.0, -0.33, 0.33, 1.0)]
    sims = arm.simulate_rampNhold_batch(rng, tf=30.0, Tramp=2.0,
                                        W=np.asarray(loads))
    trials = [Trial(t=s["t"], y=s["y"], u=s["u"], x=s["x"], w=s["w"])
              for s in sims]
    ds = DataSet(train=trials[:-1], val=trials[-1:], params={"sysName": "test"})
    ks = Ksysid(ds, SysidConfig(model_type="bilinear", obs_type=("poly",),
                                obs_degree=(2,), loaded=True, dim_red=True)
                ).train_models()
    return arm, ks, ds


def _mpc_cfg():
    return MpcConfig(horizon=10, input_bounds=(-7 * np.pi / 8, 7 * np.pi / 8),
                     input_slopeConst=1e-1, cost_running=10.0,
                     cost_terminal=100.0, cost_input=(3e-3, 2e-3),
                     proj_idx=(2, 3),       # end effector of the 2-module arm
                     load_obs_horizon=10, load_obs_period=2)


def test_loaded_model_validates(loaded_setup):
    arm, ks, _ = loaded_setup
    assert ks.nw == 2
    res = ks.val_model(ks.model, ks.valdata[0])
    # corner-load open-loop rollout: stable and bounded (the controller only
    # needs short-horizon accuracy; closed-loop quality is tested below)
    assert float(res["error"]["euclid_mean"]) < 0.6
    assert np.isfinite(res["sim"]["y"]).all()


def test_loaded_linear_model_and_observer(loaded_setup):
    """The loaded LINEAR realization + its observer variant (which pins the
    last load component to zero, ``Kmpc.m:1349``)."""
    arm, _, ds = loaded_setup
    # same corpus as the fixture, LINEAR loaded model
    ks = Ksysid(ds, SysidConfig(model_type="linear", obs_type=("poly",),
                                obs_degree=(2,), loaded=True, dim_red=True)
                ).train_models()
    cfg = _mpc_cfg()
    mpc = make_kmpc(ks.model, ks.scaler, cfg)
    obs = make_load_observer(ks.model, cfg)
    circle = get_circle([0.0, -0.7], 0.3)
    ref = make_trajectory(circle, T=15.0, Ts=0.05, flip_y=True,
                          preamble_from=(0.0, 1.0))
    res = Ksim(arm, mpc, observer=obs).run_trial_mpc(
        ref["y"], load=np.array([0.8, 0.0]), steps=150)
    assert res["alive"].all()
    # the linear estimator pins the LAST load component to exactly zero
    assert np.abs(res["What"][:, -1]).max() < 1e-9
    assert np.isfinite(res["err"]).all()


def test_observer_recovers_load_and_improves_tracking(loaded_setup):
    arm, ks, _ = loaded_setup
    cfg = _mpc_cfg()
    mpc = make_kmpc(ks.model, ks.scaler, cfg)

    # same convention as the reference's circle_c0-0p7 file: waypoints at
    # center (0, -0.7) are y-flipped into the arm workspace (y in [0.4, 1.0])
    circle = get_circle([0.0, -0.7], 0.3)
    ref = make_trajectory(circle, T=15.0, Ts=0.05, flip_y=True,
                          preamble_from=(0.0, 1.0))

    true_w = np.array([0.9, -0.6])
    # without observer: controller assumes zero load
    sim0 = Ksim(arm, mpc)
    res0 = sim0.run_trial_mpc(ref["y"], load=true_w)

    obs = make_load_observer(ks.model, cfg)
    sim1 = Ksim(arm, mpc, observer=obs)
    res1 = sim1.run_trial_mpc(ref["y"], load=true_w)

    assert res0["alive"].all() and res1["alive"].all()
    # the estimate is a surrogate load, bounded in [-1, 1] (the reference's
    # What also differs from the true w -- e.g. [0.76, -0.01] for true [1, 0]
    # in the shipped circle results); the contract is better tracking:
    assert np.all(np.abs(res1["What"]) <= 1.0 + 1e-9)
    assert res1["err"].mean() < res0["err"].mean() * 0.8
    # absolute quality in the class of the golden loaded results (0.02-0.04)
    assert res1["err"].mean() < 0.1


def _rti_grid(arm, ks, cfg, use_obs: bool):
    mpc = make_kmpc(ks.model, ks.scaler, cfg)
    obs = make_load_observer(ks.model, cfg) if use_obs else None
    sim = Ksim(arm, mpc, observer=obs)
    circle = get_circle([0.0, -0.7], 0.3)
    ref = make_trajectory(circle, T=15.0, Ts=0.05, flip_y=True,
                          preamble_from=(0.0, 1.0))
    X0s, Ws = [], []
    for ld in ((0.9, -0.6), (0.4, 0.2), (0.0, 0.0)):   # spanning load cases
        for x00 in (-0.15, 0.15):
            x0 = np.zeros(4)
            x0[0] = x00
            X0s.append(x0)
            Ws.append(ld)
    out = sim.run_batch(ref["y"], np.stack(X0s), load=np.asarray(Ws),
                        steps=200)
    return out["alive"][:, -1], out["err"].mean(axis=1)


def test_observer_at_rti_regime_loaded_floor(loaded_setup):
    """Observer ON at the blocked RTI regime (round-4 verdict #3), with the
    MEASURED loaded-model floor.  Swept finding (this grid, 6 lanes =
    3 load cases x X0 spread, 200 steps): the qp_iters=3 + dual warm +
    stage shift regime that ships for the UNLOADED bench kills lanes on
    loaded models -- observer ON (dead lane at qp=3) and, notably, even
    observer OFF (2 dead lanes), so the fragility is the warm-started
    duals on the loaded lifted state (NL = 3N, larger dynamic range), not
    the estimate-update interaction alone.  Both measured floors hold
    alive 1.0 at converged-class tracking (qp15 reference err 0.028):

      qp_iters=5 + dual warm + shift + blocking   (err 0.027)
      qp_iters=3 NO dual warm    + blocking       (err 0.031)

    The library default (qp_iters=10, no warm) keeps ample margin.
    """
    import dataclasses

    arm, ks, _ = loaded_setup
    # floor A: dual-warm regime needs qp_iters=5 on loaded models
    cfgA = dataclasses.replace(_mpc_cfg(), qp_iters=5, qp_dual_warm=True,
                               qp_dual_shift=True, input_blocks=(1, 1, 2, 5))
    aliveA, errA = _rti_grid(arm, ks, cfgA, use_obs=True)
    assert aliveA.all(), f"lanes died (qp5+warm): {np.where(~aliveA)[0]}"
    # floor B: qp_iters=3 holds without the dual warm start
    cfgB = dataclasses.replace(_mpc_cfg(), qp_iters=3,
                               input_blocks=(1, 1, 2, 5))
    aliveB, errB = _rti_grid(arm, ks, cfgB, use_obs=True)
    assert aliveB.all(), f"lanes died (qp3 nowarm): {np.where(~aliveB)[0]}"
    # converged-class tracking on every lane for both floors
    cfgR = dataclasses.replace(_mpc_cfg(), qp_iters=15)
    aliveR, errR = _rti_grid(arm, ks, cfgR, use_obs=True)
    assert aliveR.all()
    for err in (errA, errB):
        assert err.max() < 0.12, err
        assert err.mean() <= errR.mean() * 1.25 + 1e-4, (err.mean(),
                                                         errR.mean())


def test_observer_slope_constraint(loaded_setup):
    """``load_obs_slope``: each update moves the estimate at most +-slope
    from the previous one (``Kmpc.m:1336-1345``, reference value 0.01)."""
    import dataclasses

    arm, ks, _ = loaded_setup
    slope = 0.05
    cfg = dataclasses.replace(_mpc_cfg(), load_obs_slope=slope)
    mpc = make_kmpc(ks.model, ks.scaler, cfg)
    obs = make_load_observer(ks.model, cfg)

    circle = get_circle([0.0, -0.7], 0.3)
    ref = make_trajectory(circle, T=15.0, Ts=0.05, flip_y=True,
                          preamble_from=(0.0, 1.0))
    res = Ksim(arm, mpc, observer=obs).run_trial_mpc(
        ref["y"], load=np.array([0.9, -0.6]), steps=200)
    assert res["alive"].all()
    # What is recorded in scaled space == estimate space here (w in [-1,1])
    dW = np.abs(np.diff(res["What"], axis=0))
    assert dW.max() <= slope + 1e-6
    # slope-limited estimates must still converge toward a useful load
    assert np.abs(res["What"][-1]).max() > 0.1


def test_delayed_loaded_observer_recovers_exact_model_load(loaded_setup):
    """Delay-embedded load estimation (round-4 verdict #6).

    The reference's estimators build their regression rows through
    ``get_zeta``, which embeds delays (``Kmpc.m:1315,1377`` + ``:389-400``)
    -- so a delays>0 loaded configuration is in-scope.  Ground truth here
    is the LEARNED model itself: roll the delays=1 loaded bilinear model
    at a known scaled load and the estimator must recover that load
    near-exactly (the regression is then consistent by construction).
    """
    from koopman_realizations.control.observer import make_load_observer
    import jax.numpy as jnp

    _, _, ds = loaded_setup
    ks = Ksysid(ds, SysidConfig(model_type="bilinear", obs_type=("poly",),
                                obs_degree=(2,), loaded=True, delays=1,
                                dim_red=True)).train_models()
    model = ks.model
    meta = model.meta
    assert meta.nd == 1 and meta.nw == 2
    n, m, nd = meta.n, meta.m, meta.nd
    basis = model.basis
    cfg = _mpc_cfg()
    obs = make_load_observer(model, cfg)
    hor = cfg.load_obs_horizon

    rng = np.random.default_rng(3)
    w_sc = jnp.asarray([0.55, -0.4])
    T = hor + nd + 1
    us = jnp.asarray(0.3 * rng.standard_normal((T, m)), jnp.float64)
    ys = [jnp.asarray(0.05 * rng.standard_normal(n))] * (nd + 1)
    for i in range(nd, T - 1):
        parts = [ys[i]]
        for j in range(1, nd + 1):
            parts.append(ys[i - j])
        for j in range(1, nd + 1):
            parts.append(us[i - j])
        zeta = jnp.concatenate(parts)
        znext = model.step(basis.lift_loaded(zeta, w_sc), us[i])
        ys.append(znext[:n])
    ywin = jnp.stack(ys)
    what = np.asarray(obs.estimate(ywin, us))
    assert np.abs(what - np.asarray(w_sc)).max() < 0.05, what
