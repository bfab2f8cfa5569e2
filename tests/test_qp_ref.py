"""Cross-validation of the batched QP solver against the native oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from koopman_realizations.ops import qp_ref
from koopman_realizations.ops.qp import solve_qp
from test_qp import random_qp

pytestmark = pytest.mark.skipif(not qp_ref.available(),
                                reason="native toolchain unavailable")


def test_native_matches_brute_force():
    from tests.test_qp import brute_force_qp

    rng = np.random.default_rng(11)
    for _ in range(10):
        P, q, A, b = random_qp(rng, 4, 6)
        x_ref = brute_force_qp(P, q, A, b)
        x, lam, status = qp_ref.solve_qp_ref(P, q, A, b)
        assert status == 0
        np.testing.assert_allclose(x, x_ref, atol=1e-8)


def test_batched_solver_matches_native_at_mpc_scale():
    """Paper-config scale: 27-30 vars, ~115 constraint rows."""
    rng = np.random.default_rng(12)
    for _ in range(10):
        P, q, A, b = random_qp(rng, 27, 114)
        x_ref, _, status = qp_ref.solve_qp_ref(P, q, A, b)
        assert status == 0
        sol = solve_qp(jnp.asarray(P), jnp.asarray(q), jnp.asarray(A),
                       jnp.asarray(b), iters=25)
        assert bool(sol.ok)
        # BASELINE parity target: control accuracy 1e-4
        np.testing.assert_allclose(np.asarray(sol.x), x_ref, atol=1e-5)


def test_native_multipliers_satisfy_kkt():
    rng = np.random.default_rng(13)
    P, q, A, b = random_qp(rng, 8, 12)
    x, lam, status = qp_ref.solve_qp_ref(P, q, A, b)
    assert status == 0
    assert np.abs(P @ x + q + A.T @ lam).max() < 1e-7
    assert lam.min() >= -1e-12
    assert (A @ x - b).max() < 1e-8
