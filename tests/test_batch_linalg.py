"""Unrolled small-matrix solvers vs the standard jnp routines."""

import jax
import jax.numpy as jnp
import numpy as np

from koopman_realizations.ops.batch_linalg import (
    chol_solve_unrolled,
    chol_unrolled,
    solve_spd_unrolled,
    solve_via_normal_unrolled,
)


def _spd(rng, n):
    G = rng.standard_normal((n, n))
    return G @ G.T + n * np.eye(n)


def test_chol_matches_jnp(rng):
    for n in (3, 6, 27):
        M = _spd(rng, n)
        L1 = np.asarray(chol_unrolled(jnp.asarray(M)))
        L2 = np.asarray(jnp.linalg.cholesky(jnp.asarray(M)))
        np.testing.assert_allclose(L1, L2, rtol=1e-10, atol=1e-12)


def test_chol_solve_matches(rng):
    n = 27
    M = _spd(rng, n)
    b = rng.standard_normal(n)
    x1 = np.asarray(solve_spd_unrolled(jnp.asarray(M), jnp.asarray(b)))
    x2 = np.linalg.solve(M, b)
    np.testing.assert_allclose(x1, x2, rtol=1e-9, atol=1e-11)


def test_batched_via_vmap(rng):
    n, B = 12, 64
    Ms = np.stack([_spd(rng, n) for _ in range(B)])
    bs = rng.standard_normal((B, n))
    xs = np.asarray(jax.vmap(solve_spd_unrolled)(jnp.asarray(Ms),
                                                 jnp.asarray(bs)))
    ref = np.stack([np.linalg.solve(M, b) for M, b in zip(Ms, bs)])
    np.testing.assert_allclose(xs, ref, rtol=1e-8, atol=1e-10)


def test_normal_equation_solve(rng):
    n = 6
    A = rng.standard_normal((n, n)) + 3 * np.eye(n)   # well-conditioned
    b = rng.standard_normal(n)
    x = np.asarray(solve_via_normal_unrolled(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(x, np.linalg.solve(A, b), rtol=1e-7, atol=1e-9)
