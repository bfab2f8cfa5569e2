"""Property tests from SURVEY section 4: structural invariants of the stack."""

import jax.numpy as jnp
import numpy as np
import pytest

from koopman_realizations.config import SysidConfig
from koopman_realizations.models.edmd import Ksysid
from koopman_realizations.ops.observables import build_basis
from koopman_realizations.ops.scaling import fit_scaler
from koopman_realizations.types import DataSet, Trial


@pytest.mark.parametrize("family,degree", [
    ("poly", 3), ("fourier", 1), ("fourier_sparser", 2),
    ("gaussian", 6), ("hermite", 2),
])
def test_first_nzeta_entries_are_zeta(family, degree, rng):
    """C selects zeta exactly: lift(zeta)[:nzeta] == zeta for every family."""
    cfg = SysidConfig(obs_type=(family,), obs_degree=(degree,), seed=1)
    basis = build_basis(cfg, n=3, m=2)
    z = rng.uniform(-1, 1, basis.nzeta)
    g = np.asarray(basis.lift(jnp.asarray(z)))
    np.testing.assert_allclose(g[: basis.nzeta], z, rtol=1e-12)
    assert g[-1] == 1.0


def test_zeta_scaling_round_trip_with_delays(arm_dataset):
    ks = Ksysid(arm_dataset, SysidConfig(obs_type=("poly",), obs_degree=(1,),
                                         delays=2))
    rngv = np.random.default_rng(0)
    zeta = rngv.uniform(-2, 2, ks.nzeta)
    down = np.asarray(ks.scaler.zeta_down(zeta, 2))
    up = np.asarray(ks.scaler.zeta_up(down, 2))
    np.testing.assert_allclose(up, zeta, rtol=1e-12)
    # y-block scaling equals the plain y scaling
    np.testing.assert_allclose(down[:6], np.asarray(ks.scaler.y_down(zeta[:6])),
                               rtol=1e-12)


def test_delay_pin_structure_in_lasso_mode(rng):
    """The lasso path pins delay-shift entries of K to exactly 1
    (``Ksysid.solve_KoopmanQP:1139-1164``)."""
    T, n, m = 300, 2, 1
    trials = []
    for s in range(3):
        y = np.zeros((T, n))
        u = rng.uniform(-1, 1, (T, m))
        A = np.array([[0.9, 0.05], [-0.05, 0.85]])
        for k in range(T - 1):
            y[k + 1] = A @ y[k] + [0.1 * u[k, 0], 0.2 * u[k, 0]]
        trials.append(Trial(t=np.arange(T) * 0.1, y=y, u=u))
    ds = DataSet(train=trials[:-1], val=trials[-1:])
    cfg = SysidConfig(model_type="linear", obs_type=("poly",), obs_degree=(1,),
                      delays=1, lasso=(5.0,), lasso_iters=300)
    ks = Ksysid(ds, cfg).train_models()
    K = np.asarray(ks.model.K)
    mask = ks._delay_pin_mask(K.shape[0])
    assert mask.sum() == n + m            # one y-delay block + one u-delay block
    np.testing.assert_allclose(K[mask], 1.0, atol=1e-12)


def test_scaling_round_trip_random_data(rng):
    tr = Trial(t=np.arange(50) * 0.1,
               y=rng.uniform(-7, 3, (50, 4)),
               u=rng.uniform(0, 9, (50, 2)))
    sc = fit_scaler(tr)
    down = sc.trial_down(tr)
    assert np.asarray(down.y).min() >= -1 - 1e-12
    assert np.asarray(down.y).max() <= 1 + 1e-12
    np.testing.assert_allclose(np.asarray(sc.y_up(down.y)), tr.y, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(sc.u_up(down.u)), tr.u, rtol=1e-12)


def test_bilinear_regression_layout_consistency(arm_dataset):
    """Px row blocks follow [g; u1 g; ...] so B column blocks map per input."""
    ks = Ksysid(arm_dataset, SysidConfig(model_type="bilinear",
                                         obs_type=("poly",), obs_degree=(1,)))
    Px, _ = ks.lift_snapshot_matrices()
    N = ks.N
    sp = ks.snapshot_pairs
    g0 = np.asarray(ks.basis.lift(jnp.asarray(sp.alpha[5])))
    row = np.asarray(Px[5])
    np.testing.assert_allclose(row[:N], g0, rtol=1e-12)
    np.testing.assert_allclose(row[N: 2 * N], sp.u[5][0] * g0, rtol=1e-12)


def test_rebuilt_model_shares_jit_cache(arm_dataset):
    """Model pytrees carry meta/basis as STATIC aux; a rebuilt-but-equal
    model must pass through the same jitted function without raising from
    aux hashing/equality (KoopmanBasis is eq=False / identity-hashed --
    regression: the auto-generated dataclass __eq__/__hash__ raised on the
    numpy PCA tables)."""
    import jax

    from koopman_realizations.config import SysidConfig
    from koopman_realizations.models.edmd import Ksysid

    cfg = SysidConfig(model_type="linear", obs_type=("poly",),
                      obs_degree=(2,), dim_red=True, snapshots=400)
    m1 = Ksysid(arm_dataset, cfg).train_models().model
    m2 = Ksysid(arm_dataset, cfg).train_models().model
    f = jax.jit(lambda m: m.A.sum())
    f(m1)
    f(m2)       # distinct basis objects: retrace, never raise
