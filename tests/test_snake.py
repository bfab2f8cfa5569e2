"""Soft-robot (snake) dataset: fourier observables with delay embedding.

Covers the reference's fifth headline config (BASELINE.json): system ID on
``snake-data.mat`` (y in R^3, u in R^1, Ts = 0.01) with delays and fourier
dictionaries, plus an MPC build on the learned model.
"""

import os

import numpy as np
import pytest

from koopman_realizations.config import MpcConfig, SysidConfig
from koopman_realizations.control import make_kmpc
from koopman_realizations.models.edmd import Ksysid
from koopman_realizations.utils.data import chop, get_data4sysid
from koopman_realizations.utils.matio import load_data4sysid

SNAKE = "/root/reference/datafiles/snake-data.mat"


@pytest.fixture(scope="module")
def snake_dataset():
    if not os.path.exists(SNAKE):
        pytest.skip("snake-data.mat not available")
    ds = load_data4sysid(SNAKE)
    # one long 200 s recording: chop into trials like Data.chop
    train = chop(ds.train[0], num=6, length_s=40.0)
    # short validation window: unregularized open-loop rollouts of soft-robot
    # dictionaries drift over thousands of steps (controller use only needs
    # short-horizon accuracy)
    val = [ds.val[0].replace(y=ds.val[0].y[:500], u=ds.val[0].u[:500],
                             t=ds.val[0].t[:500])]
    return get_data4sysid(train, val)


def test_snake_fourier_bilinear_model(snake_dataset):
    cfg = SysidConfig(model_type="bilinear", obs_type=("fourier_sparser",),
                      obs_degree=(1,))
    ks = Ksysid(snake_dataset, cfg).train_models()
    res = ks.val_model(ks.model, ks.valdata[0])
    assert np.isfinite(res["sim"]["y"]).all()
    assert float(res["error"]["euclid_mean"]) < 0.3


def test_snake_fourier_delay_linear(snake_dataset):
    """Delay embedding on the soft robot (bilinear+delays drifts open-loop,
    both here and in the reference, where delay-shift pinning exists only for
    linear models -- Ksysid.m:1139)."""
    cfg = SysidConfig(model_type="linear", obs_type=("fourier_sparser",),
                      obs_degree=(1,), delays=1)
    ks = Ksysid(snake_dataset, cfg).train_models()
    # nzeta = n(nd+1) + m*nd = 3*2 + 1 = 7
    assert ks.nzeta == 7
    res = ks.val_model(ks.model, ks.valdata[0])
    assert np.isfinite(res["sim"]["y"]).all()
    assert float(res["error"]["euclid_mean"]) < 1.5


def test_snake_model_in_loop_mpc(snake_dataset):
    """Soft-robot closed loop against its own learned model (no physical
    simulator exists for the snake; `Kmpc.run_simulation` semantics)."""
    from koopman_realizations.control import run_model_simulation

    cfg = SysidConfig(model_type="bilinear", obs_type=("fourier_sparser",),
                      obs_degree=(1,))
    ks = Ksysid(snake_dataset, cfg).train_models()
    mpc = make_kmpc(ks.model, ks.scaler, MpcConfig(
        horizon=10, input_bounds=(-10.0, 10.0), input_slopeConst=0.5,
        cost_running=10.0, cost_terminal=100.0, cost_input=(1e-3,),
        proj_idx=(0, 1)))
    # track a small circle in the first two output dims
    t = np.linspace(0, 2 * np.pi, 200)
    y0 = np.asarray(ks.scaler.y_up(np.zeros(3)))
    ref = np.stack([y0[0] + 0.1 * np.cos(t) - 0.1, y0[1] + 0.1 * np.sin(t)],
                   axis=1)
    res = run_model_simulation(mpc, ref, steps=120)
    assert res["alive"].all()
    assert np.isfinite(res["err"]).all()
    # tracks the moving target with bounded error (slope-limited single
    # input chasing a 2-D circle cannot settle to zero)
    assert res["err"].max() < 0.5


def test_snake_mpc_builds_and_solves(snake_dataset):
    cfg = SysidConfig(model_type="bilinear", obs_type=("poly",),
                      obs_degree=(2,), delays=1)
    ks = Ksysid(snake_dataset, cfg).train_models()
    mpc = make_kmpc(ks.model, ks.scaler, MpcConfig(
        horizon=10, input_bounds=(-10.0, 10.0), input_slopeConst=1e-1,
        cost_running=10.0, cost_terminal=100.0, cost_input=(1e-3,),
        proj_idx=(0, 1)))
    import jax.numpy as jnp
    z = ks.basis.lift(jnp.zeros(ks.nzeta))
    refhor = jnp.zeros((11, 2))
    U, ok = mpc.solve(z, jnp.zeros(1), refhor)
    assert U.shape == (10, 1)
    assert bool(ok)
