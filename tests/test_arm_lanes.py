"""Parity: struct-of-arrays batched arm path vs the per-lane autodiff path.

The SoA module replaces the autodiff Lagrangian with closed-form
planar-chain reductions (Coriolis telescoping, suffix-sum gravity); these
tests pin it to the validated per-lane dynamics (``models.arm.Arm.rhs``,
itself cross-checked against the reference's symbolic EOM and shipped ode45
data in ``tests/test_arm.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from koopman_realizations.config import ArmConfig
from koopman_realizations.models.arm import Arm
from koopman_realizations.models.arm_lanes import rhs_soa, sdirk2_soa


def _rand_batch(rng, arm, B):
    cfg = arm.cfg
    X = rng.normal(size=(B, cfg.nx)) * np.array(
        [0.5] * cfg.Nlinks + [2.0] * cfg.Nlinks)
    U = cfg.umax * (2 * rng.random((B, cfg.Nmods)) - 1)
    W = np.stack([0.2 * rng.random(B), 0.5 * rng.normal(size=B)], axis=1)
    return jnp.asarray(X), jnp.asarray(U), jnp.asarray(W)


@pytest.mark.parametrize("Nmods,nlinks", [(3, 1), (3, 2), (2, 3)])
def test_rhs_soa_matches_autodiff(Nmods, nlinks):
    arm = Arm(ArmConfig(Nmods=Nmods, nlinks=nlinks))
    rng = np.random.default_rng(0)
    X, U, W = _rand_batch(rng, arm, 64)
    ref = jax.vmap(arm.rhs)(X, U, W)

    N = arm.cfg.Nlinks
    a = [X[:, i] for i in range(N)]
    ad = [X[:, N + i] for i in range(N)]
    us = [U[:, j] for j in range(arm.cfg.Nmods)]
    addot = rhs_soa(arm.cfg, arm._G, arm._b, a, ad, us, W[:, 0], W[:, 1])
    got = jnp.stack(list(ad) + list(addot), axis=1)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("jac_mode", ["step", "substep"])
def test_sdirk2_soa_matches_per_lane(jac_mode):
    arm = Arm(ArmConfig(Nmods=3, nlinks=1, substeps=3, newton_iters=2,
                        jac_mode=jac_mode))
    rng = np.random.default_rng(1)
    X, U, W = _rand_batch(rng, arm, 32)
    ref = jax.vmap(lambda x, u, w: arm._simulate_Ts_lane(
        x, u, w, arm.cfg.Ts))(X, U, W)
    got = sdirk2_soa(arm.cfg, arm._G, arm._b, X, U, W, arm.cfg.Ts,
                     arm.cfg.substeps, arm.cfg.newton_iters, jac_mode)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-8, atol=1e-8)


def test_custom_vmap_routes_batch():
    """vmapped simulate_Ts == per-lane path (the custom_vmap rule)."""
    arm = Arm(ArmConfig(Nmods=3, nlinks=1, substeps=3, newton_iters=2,
                        jac_mode="step"))
    rng = np.random.default_rng(2)
    X, U, W = _rand_batch(rng, arm, 16)
    got = jax.jit(jax.vmap(arm.simulate_Ts))(X, U, W)
    ref = jnp.stack([arm._simulate_Ts_lane(X[i], U[i], W[i], arm.cfg.Ts)
                     for i in range(16)])
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-8, atol=1e-8)


def test_unbatched_call_unchanged():
    arm = Arm(ArmConfig(Nmods=3, nlinks=1, substeps=3))
    x = jnp.asarray(np.linspace(-0.3, 0.4, arm.cfg.nx))
    u = jnp.asarray([0.1, -0.2, 0.3])
    got = arm.simulate_Ts(x, u)
    ref = arm._simulate_Ts_lane(x, u, jnp.zeros(2, x.dtype), arm.cfg.Ts)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-12, atol=1e-12)


def test_lu_soa_matches_numpy():
    """The lane-wise LU solve behind the SDIRK2 Newton systems."""
    from koopman_realizations.models.arm_lanes import (
        lu_soa,
        lu_solve_soa,
    )
    rng = np.random.default_rng(3)
    n, B = 4, 8
    S = np.eye(n)[None] + 0.3 * rng.standard_normal((B, n, n))
    b = rng.standard_normal((B, n))
    F = lu_soa([[jnp.asarray(S[:, i, j]) for j in range(n)]
                for i in range(n)], n)
    x = lu_solve_soa(F, [jnp.asarray(b[:, i]) for i in range(n)], n)
    np.testing.assert_allclose(np.stack([np.asarray(v) for v in x], 1),
                               np.linalg.solve(S, b[..., None])[..., 0],
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("newton_iters", [1, 2])
def test_sdirk2_f32_matches_f64(newton_iters):
    """In f32 the plant step stays at f32 rounding of the f64 step even
    with ONE chord-Newton iteration per stage (the bench setting): the
    block-eliminated Newton solve keeps the conditioning of the N x N
    second-order system (normal equations squared it, ~1e-3 error)."""
    arm = Arm(ArmConfig(Nmods=3, nlinks=1, substeps=3,
                        newton_iters=newton_iters, jac_mode="step"))
    cfg = arm.cfg
    B = 64
    X = np.zeros((B, cfg.nx))
    X[:, 0] = np.linspace(-0.2, 0.2, B)
    U = np.tile([0.2, -0.1, 0.3], (B, 1))
    W = np.zeros((B, 2))

    def step(dt):
        return np.asarray(sdirk2_soa(
            cfg, arm._G, arm._b, jnp.asarray(X, dt), jnp.asarray(U, dt),
            jnp.asarray(W, dt), cfg.Ts, cfg.substeps, cfg.newton_iters,
            cfg.jac_mode))

    err = np.abs(step(jnp.float32) - step(jnp.float64)).max()
    assert err < 5e-6, err
