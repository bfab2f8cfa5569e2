"""QP solver correctness: KKT checks, brute-force active-set parity, batching."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np

from koopman_realizations.ops.qp import solve_qp, solve_qp_batch, solve_qp_eq


def brute_force_qp(P, q, A, b):
    """Reference solution by active-set enumeration (small problems only)."""
    n = len(q)
    mc = len(b)
    best, best_val = None, np.inf
    for k in range(mc + 1):
        for active in itertools.combinations(range(mc), k):
            Aa = A[list(active)]
            KKT = np.block([[P, Aa.T], [Aa, np.zeros((k, k))]])
            rhs = np.concatenate([-q, b[list(active)]])
            try:
                sol = np.linalg.solve(KKT, rhs)
            except np.linalg.LinAlgError:
                continue
            x, lam = sol[:n], sol[n:]
            if np.any(lam < -1e-9):
                continue
            if np.any(A @ x - b > 1e-9):
                continue
            val = 0.5 * x @ P @ x + q @ x
            if val < best_val - 1e-12:
                best_val, best = val, x
    return best


def random_qp(rng, n, mc):
    G = rng.standard_normal((n, n))
    P = G @ G.T + 0.1 * np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((mc, n))
    # make feasible region nonempty and bounded-ish around a random point
    x_feas = rng.standard_normal(n) * 0.1
    b = A @ x_feas + np.abs(rng.standard_normal(mc)) + 0.1
    return P, q, A, b


def test_matches_brute_force(rng):
    for _ in range(20):
        P, q, A, b = random_qp(rng, 4, 6)
        x_ref = brute_force_qp(P, q, A, b)
        sol = solve_qp(jnp.asarray(P), jnp.asarray(q), jnp.asarray(A),
                       jnp.asarray(b), iters=30)
        assert bool(sol.ok)
        np.testing.assert_allclose(np.asarray(sol.x), x_ref, atol=1e-6)


def test_unconstrained_interior():
    P = np.diag([2.0, 4.0])
    q = np.array([-2.0, -4.0])
    A = np.array([[1.0, 0.0], [0.0, 1.0]])
    b = np.array([10.0, 10.0])     # constraints inactive
    sol = solve_qp(P, q, A, b)
    np.testing.assert_allclose(np.asarray(sol.x), [1.0, 1.0], atol=1e-7)


def test_zero_constraint_rows():
    """mc == 0 (all MpcConfig constraints None) solves P x = -q directly,
    vmapped lanes included (the interior point's reductions would be over
    zero rows)."""
    import jax
    import jax.numpy as jnp

    from koopman_realizations.ops.qp import solve_qp_factored

    P = np.diag([2.0, 4.0])
    q = np.array([-2.0, -4.0])
    A = np.zeros((0, 2))
    b = np.zeros((0,))
    sol = solve_qp(P, q, A, b)
    assert bool(sol.ok)
    np.testing.assert_allclose(np.asarray(sol.x), [1.0, 1.0], atol=1e-6)
    # factored form, vmapped over lanes (the closed-loop shape):
    # P = 2 W^T W = diag(2, 4), q = 2 W^T v = (-2, -4) -> x* = (1, 1)
    W = jnp.asarray(np.tile(np.diag([1.0, np.sqrt(2.0)]), (8, 1, 1)),
                    jnp.float32)
    v = jnp.asarray(np.tile([-1.0, -np.sqrt(2.0)], (8, 1)), jnp.float32)
    r = jnp.zeros((2,), jnp.float32)
    out = jax.vmap(lambda Wi, vi: solve_qp_factored(
        Wi, vi, r, jnp.zeros((0, 2), jnp.float32),
        jnp.zeros((0,), jnp.float32)))(W, v)
    assert bool(out.ok.all())
    np.testing.assert_allclose(np.asarray(out.x),
                               np.tile([1.0, 1.0], (8, 1)), atol=1e-4)


def test_active_box_constraint():
    P = np.eye(2)
    q = np.array([-10.0, 0.0])
    A = np.array([[1.0, 0.0]])
    b = np.array([2.0])
    sol = solve_qp(P, q, A, b)
    np.testing.assert_allclose(np.asarray(sol.x), [2.0, 0.0], atol=1e-7)
    assert float(sol.lam[0]) > 1.0  # active multiplier


def test_semidefinite_hessian():
    """MPC Hessians with cost_input=0 are only PSD; regularization handles it."""
    P = np.array([[1.0, 0.0], [0.0, 0.0]])
    q = np.array([0.0, 1.0])
    A = np.array([[0.0, -1.0]])
    b = np.array([5.0])           # x2 >= -5; objective pushes x2 down
    sol = solve_qp(P, q, A, b, iters=40)
    np.testing.assert_allclose(np.asarray(sol.x), [0.0, -5.0], atol=1e-5)


def test_infeasible_flags_not_ok():
    P = np.eye(1)
    q = np.zeros(1)
    A = np.array([[1.0], [-1.0]])
    b = np.array([-1.0, -1.0])    # x <= -1 and x >= 1: infeasible
    sol = solve_qp(P, q, A, b)
    assert not bool(sol.ok)


def test_batched_solver(rng):
    Ps, qs, As, bs, refs = [], [], [], [], []
    for _ in range(8):
        P, q, A, b = random_qp(rng, 3, 5)
        refs.append(brute_force_qp(P, q, A, b))
        Ps.append(P); qs.append(q); As.append(A); bs.append(b)
    sol = solve_qp_batch(jnp.asarray(np.stack(Ps)), jnp.asarray(np.stack(qs)),
                         jnp.asarray(np.stack(As)), jnp.asarray(np.stack(bs)),
                         iters=30)
    assert bool(jnp.all(sol.ok))
    np.testing.assert_allclose(np.asarray(sol.x), np.stack(refs), atol=1e-6)


def test_equality_constrained(rng):
    P, q, A, b = random_qp(rng, 4, 4)
    E = np.array([[1.0, 1.0, 0.0, 0.0]])
    d = np.array([0.7])
    sol = solve_qp_eq(jnp.asarray(P), jnp.asarray(q), jnp.asarray(A),
                      jnp.asarray(b), jnp.asarray(E), jnp.asarray(d), iters=30)
    assert bool(sol.ok)
    x = np.asarray(sol.x)
    assert abs(x[0] + x[1] - 0.7) < 1e-8
    # KKT stationarity projected on the equality null space
    g = P @ x + q + A.T @ np.asarray(sol.lam)
    Z = np.linalg.svd(E)[2][1:].T
    assert np.abs(Z.T @ g).max() < 1e-5


def test_mpc_like_qp_dimensions(rng):
    """Shapes of the paper config: 30 vars, ~130 constraint rows."""
    n, mc = 30, 132
    G = rng.standard_normal((n, n))
    P = G @ G.T + np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((mc, n))
    b = A @ (0.01 * rng.standard_normal(n)) + np.abs(rng.standard_normal(mc)) + 0.05
    sol = solve_qp(P, q, A, b, iters=30)
    assert bool(sol.ok)
    x = np.asarray(sol.x)
    lam = np.asarray(sol.lam)
    kkt = P @ x + q + A.T @ lam
    assert np.abs(kkt).max() < 1e-5
