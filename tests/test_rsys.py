"""Random-system ensemble generation and the model-class comparison sweep."""

import glob

import numpy as np
import pytest

from koopman_realizations.models.rsys import (
    RsysEnsemble,
    construct_systems,
    generate_input_steps,
    simulate_systems,
)
from koopman_realizations.utils.matio import load_rsys_all
from koopman_realizations.workflows import evaluate_rand_models


def test_construct_systems_shapes(rng):
    ens = construct_systems(num_sys=5, num_terms=4, degree_x=3, degree_u=2,
                            rng=rng)
    assert ens.coeffs.shape == (5, 4)
    assert ens.px.max() <= 3 and ens.pu.max() <= 2
    # vector field is bounded-ish: exp(-x^4) envelope + atan
    v = float(ens.vf(0, 5.0, 1.0))
    assert abs(v) < np.pi  # exp(-625) kills the polynomial part


def test_generate_input_steps(rng):
    u = generate_input_steps(rng, T=201, num_steps=50)
    assert u.shape == (201,)
    # piecewise constant: 5 step values + the trailing partial block,
    # which must stay exactly 0 (rsys.py docstring contract)
    assert len(np.unique(u)) <= 6
    assert np.all(u[200:] == 0.0)
    assert np.abs(u).max() <= 1.0


def test_simulate_systems_batched(rng):
    ens = construct_systems(num_sys=3, num_terms=4, degree_x=3, degree_u=1,
                            rng=rng)
    datasets = simulate_systems(ens, t_end=5.0, Ts=0.05, num_trials=4, rng=rng)
    assert len(datasets) == 3
    assert len(datasets[0].train) == 3 and len(datasets[0].val) == 1
    y = datasets[0].train[0].y
    assert y.shape == (101, 1)
    assert np.all(np.isfinite(y))
    # boundedness: the exp(-x^4)/-atan(x) construction keeps |x| moderate
    assert np.abs(y).max() < 5.0


@pytest.fixture(scope="module")
def shipped_rsys():
    for folder in sorted(glob.glob("/root/reference/datafiles/rand-systems_*")):
        files = glob.glob(folder + "/rsys-all_*.mat")
        if files:
            ds = load_rsys_all(files[0])
            if len(ds) >= 20:
                return ds
    pytest.skip("no shipped rsys-all ensembles found")


def test_evaluate_rand_models_on_shipped_data(shipped_rsys):
    out = evaluate_rand_models(shipped_rsys, max_degree_linear=6,
                               max_degree_bilinear=3, max_degree_nonlinear=2,
                               lasso_iters=300)
    for fam in ("linear", "bilinear", "nonlinear"):
        o = out[fam]
        assert o["err"].shape[1] == len(shipped_rsys)
        assert o["kept"] >= len(shipped_rsys) - 2
        # the paper's headline trend: error drops as the basis grows
        assert o["median"][-1] < o["median"][0]
    # dims follow the reference's basis-count bookkeeping
    np.testing.assert_array_equal(out["linear"]["dims"], [2, 3, 4, 5, 6, 7])
    np.testing.assert_array_equal(out["bilinear"]["dims"], [4, 6, 8])
    np.testing.assert_array_equal(out["nonlinear"]["dims"], [3, 6])


def test_evaluate_rand_models_sharded_matches(shipped_rsys):
    """System-axis sharding over the 8-device mesh changes nothing numerically."""
    from koopman_realizations.parallel import make_mesh

    mesh = make_mesh(n_data=8)
    kw = dict(max_degree_linear=3, max_degree_bilinear=2,
              max_degree_nonlinear=1, lasso_iters=200)
    a = evaluate_rand_models(shipped_rsys, **kw)
    b = evaluate_rand_models(shipped_rsys, mesh=mesh, **kw)
    for fam in ("linear", "bilinear", "nonlinear"):
        np.testing.assert_allclose(a[fam]["err"], b[fam]["err"],
                                   rtol=1e-8, atol=1e-10)


def test_evaluate_rand_models_on_generated_data(rng):
    ens = construct_systems(num_sys=6, num_terms=5, degree_x=3, degree_u=1,
                            rng=rng)
    datasets = simulate_systems(ens, t_end=25.0, Ts=0.05, num_trials=6,
                                rng=rng)
    out = evaluate_rand_models(datasets, max_degree_linear=4,
                               max_degree_bilinear=2, max_degree_nonlinear=2,
                               lasso_iters=300)
    assert np.isfinite(out["linear"]["median"]).all()
    assert out["linear"]["median"][-1] < 1.0


def _pin_to_production(datasets, rtol=1e-6, atol=1e-9):
    """Pin ``workflows.rand_models._fit_and_val`` to per-system Ksysid fits.

    The batched path re-implements scaling, poly lifting, and the Gram
    solve for the stacked system axis; both are deterministic on the same
    data and agree to ~1e-8 relative once the batched path drops the final
    snapshot pair like Ksysid's P-1 subsample quirk (the round-2 10%
    tolerance was masking exactly that one-pair mismatch).  The remaining
    differences (Ksysid's duplicated-zeta basis column + min-norm lstsq vs
    the bespoke ridge Gram solve) are span-equivalent and measure below
    1e-8 on the shipped ensembles.
    """
    import jax.numpy as jnp

    from koopman_realizations.config import SysidConfig
    from koopman_realizations.models.edmd import Ksysid
    from koopman_realizations.workflows.rand_models import (
        _fit_and_val,
        _scale_params,
        _stack_ensemble,
    )

    Ytr, Utr, Yval, Uval = _stack_ensemble(datasets)
    y_fac, y_off, u_fac, u_off = _scale_params(Ytr, Utr)
    args = [jnp.asarray(v) for v in (
        (Ytr - y_off[:, None, None]) / y_fac[:, None, None],
        (Utr - u_off[:, None, None]) / u_fac[:, None, None],
        (Yval - y_off[:, None]) / y_fac[:, None],
        (Uval - u_off[:, None]) / u_fac[:, None])]

    for family, degree in (("linear", 3), ("bilinear", 2), ("nonlinear", 2)):
        err_batched = np.asarray(_fit_and_val(
            *args, degree=degree, family=family))
        err_prod = []
        for ds in datasets:
            ks = Ksysid(ds, SysidConfig(model_type=family, obs_type=("poly",),
                                        obs_degree=(degree,))).train_models()
            res = ks.val_model(ks.model, ks.valdata[0])
            ysim = np.asarray(res["sim"]["y"])[:, 0]
            yreal = np.asarray(res["real"]["y"])[:, 0]
            err_prod.append(np.mean(np.abs(ysim - yreal))
                            / np.mean(np.abs(yreal)))
        err_prod = np.asarray(err_prod)
        assert np.allclose(err_batched, err_prod, rtol=rtol, atol=atol), \
            (family, degree, err_batched, err_prod)


def test_rand_models_matches_production_trainer(shipped_rsys):
    _pin_to_production(shipped_rsys[:3])


def test_rand_models_pin_on_generated_data(rng):
    """Same pin on generated ensembles, so it cannot silently skip when the
    shipped rsys folders are absent."""
    ens = construct_systems(num_sys=3, num_terms=5, degree_x=3, degree_u=1,
                            rng=rng)
    datasets = simulate_systems(ens, t_end=25.0, Ts=0.05, num_trials=5,
                                rng=rng)
    _pin_to_production(datasets)
