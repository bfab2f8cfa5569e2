"""Continuous-time model path: matrix-log extraction + ZOH/rk4 rollouts."""

import numpy as np
import pytest

from koopman_realizations.config import SysidConfig
from koopman_realizations.models.edmd import Ksysid
from koopman_realizations.models.koopman import as_discrete, zoh_discretize
from koopman_realizations.types import DataSet, Trial


def _cts_linear_dataset(rng, Ts=0.05, T=400, trials=4):
    """Ground truth: continuous LTI xdot = Ac x + Bc u sampled with ZOH."""
    import scipy.linalg

    Ac = np.array([[-0.5, 2.0], [-2.0, -0.5]])
    Bc = np.array([[0.5], [1.0]])
    Ad = scipy.linalg.expm(Ac * Ts)
    Bd = np.linalg.solve(Ac, (Ad - np.eye(2)) @ Bc)
    out = []
    for _ in range(trials):
        y = np.zeros((T, 2))
        u = rng.uniform(-1, 1, (T, 1))
        for k in range(T - 1):
            y[k + 1] = Ad @ y[k] + (Bd @ u[k])
        out.append(Trial(t=np.arange(T) * Ts, y=y, u=u))
    return DataSet(train=out[:-1], val=out[-1:]), Ac


def test_zoh_discretize_matches_scipy(rng):
    import scipy.linalg

    A = rng.standard_normal((4, 4)) * 0.5
    B = rng.standard_normal((4, 2))
    Ad, Bd = map(np.asarray, zoh_discretize(A, B, 0.1))
    Ad_ref = scipy.linalg.expm(A * 0.1)
    Bd_ref = np.linalg.solve(A, (Ad_ref - np.eye(4)) @ B)
    np.testing.assert_allclose(Ad, Ad_ref, atol=1e-10)
    np.testing.assert_allclose(Bd, Bd_ref, atol=1e-10)


def test_continuous_linear_model_recovers_generator(rng):
    ds, Ac = _cts_linear_dataset(rng)
    cfg = SysidConfig(model_type="linear", obs_type=("poly",), obs_degree=(1,),
                      time_type="continuous")
    ks = Ksysid(ds, cfg).train_models()
    # the logm-extracted A acts on scaled coordinates: S Ac S^-1; check the
    # eigenvalues instead (similarity-invariant): -0.5 +- 2i and ~0 rows for
    # the input/constant block
    eig = np.linalg.eigvals(np.asarray(ks.model.A))
    eig_phys = sorted(eig, key=lambda z: -abs(z.imag))[:2]
    np.testing.assert_allclose(sorted(np.real(eig_phys)), [-0.5, -0.5],
                               atol=1e-3)
    np.testing.assert_allclose(sorted(np.imag(eig_phys)), [-2.0, 2.0],
                               atol=1e-3)
    # rollout through the ZOH-discretized equivalent is near exact
    res = ks.val_model(ks.model, ks.valdata[0])
    assert float(res["error"]["euclid_mean"]) < 1e-6


def test_as_discrete_passthrough(arm_dataset):
    ks = Ksysid(arm_dataset, SysidConfig(obs_type=("poly",), obs_degree=(1,))
                ).train_models()
    assert as_discrete(ks.model) is ks.model


def test_zoh_step_bilinear_exact(rng):
    """The u-dependent matrix-exponential stepper (``zoh_step_bilinear``)
    is EXACT for a continuous bilinear system under ZOH input: it must
    match a very fine rk4 integration of the same vector field and beat
    the default-resolution rk4 stepper."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from koopman_realizations.models.koopman import (
        BilinearModel,
        ModelMeta,
        rollout_bilinear,
        zoh_step_bilinear,
    )
    from koopman_realizations.ops.integrators import rk4

    NL, m, Ts = 5, 2, 0.1
    A = rng.normal(size=(NL, NL)) * 0.8
    A = A - 1.2 * np.eye(NL)            # comfortably stable generator
    B = rng.normal(size=(NL, m, NL)) * 0.3
    meta = ModelMeta(n=NL, m=m, nw=0, nd=0, N=NL, nzeta=NL, Ts=Ts,
                     model_type="bilinear", time_type="continuous")
    model = BilinearModel(A=jnp.asarray(A), B=jnp.asarray(B),
                          C=jnp.asarray(np.eye(NL)), K=None, meta=meta)
    z0 = jnp.asarray(rng.normal(size=NL) * 0.5)
    U = jnp.asarray(rng.uniform(-1, 1, (12, m)))

    step_zoh = zoh_step_bilinear(model)
    fine = lambda z, u: rk4(lambda zz: model.step(zz, u), z, Ts, 512)

    z_z, z_f = z0, z0
    for k in range(U.shape[0] - 1):
        z_z = step_zoh(z_z, U[k])
        z_f = fine(z_f, U[k])
    np.testing.assert_allclose(np.asarray(z_z), np.asarray(z_f), rtol=0,
                               atol=1e-8)

    # rollout plumbing: the 'zoh' stepper option threads through
    Y_z, _ = rollout_bilinear(model, z0, U, continuous_stepper="zoh")
    Y_r, _ = rollout_bilinear(model, z0, U)          # rk4 substeps
    assert np.all(np.isfinite(np.asarray(Y_z)))
    # both near the fine truth; zoh at machine-level accuracy
    np.testing.assert_allclose(np.asarray(Y_z)[-1], np.asarray(z_f),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(np.asarray(Y_r)[-1], np.asarray(z_f),
                               rtol=0, atol=1e-4)
