"""Stage-wise Riccati solvers vs the condensed QP (long-horizon path)."""

import jax.numpy as jnp
import numpy as np
import pytest

from koopman_realizations.ops.qp import solve_qp
from koopman_realizations.ops.riccati import (
    solve_lq_box_barrier,
    solve_lq_stagewise,
)


def _problem(n=8, m=2, Np=12, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)) / np.sqrt(n)
    A = 0.9 * A / max(1.0, np.max(np.abs(np.linalg.eigvals(A))))
    B = rng.normal(size=(n, m))
    Qs = np.tile(np.diag(rng.uniform(0.1, 1.0, n))[None], (Np + 1, 1, 1))
    Qs[-1] *= 10.0
    Rs = np.tile(np.diag(rng.uniform(0.1, 0.5, m))[None], (Np, 1, 1))
    qs = rng.normal(size=(Np + 1, n))
    rs = rng.normal(size=(Np, m)) * 0.1
    z0 = rng.normal(size=n)
    return map(jnp.asarray, (A, B, Qs, Rs, qs, rs, z0))


def _condense(A, B, Qs, Rs, qs, rs, z0):
    """Dense equivalent: J(U) = 1/2 U'P U + f'U (+const)."""
    A, B, Qs, Rs, qs, rs, z0 = map(np.asarray, (A, B, Qs, Rs, qs, rs, z0))
    n, m = B.shape
    Np = Rs.shape[0]
    powers = [np.eye(n)]
    for _ in range(Np):
        powers.append(powers[-1] @ A)
    Abig = np.concatenate(powers, axis=0)
    Bbig = np.zeros((n * (Np + 1), m * Np))
    for i in range(1, Np + 1):
        for j in range(i):
            Bbig[i * n:(i + 1) * n, j * m:(j + 1) * m] = powers[i - 1 - j] @ B
    Qblk = np.zeros((n * (Np + 1), n * (Np + 1)))
    for k in range(Np + 1):
        Qblk[k * n:(k + 1) * n, k * n:(k + 1) * n] = Qs[k]
    Rblk = np.zeros((m * Np, m * Np))
    for k in range(Np):
        Rblk[k * m:(k + 1) * m, k * m:(k + 1) * m] = Rs[k]
    P = Bbig.T @ Qblk @ Bbig + Rblk
    f = Bbig.T @ (Qblk @ (Abig @ z0) + qs.reshape(-1)) + rs.reshape(-1)
    return P, f


def test_lq_stagewise_matches_condensed():
    A, B, Qs, Rs, qs, rs, z0 = _problem()
    U, Z = solve_lq_stagewise(A, B, Qs, Rs, qs, rs, z0)
    P, f = _condense(A, B, Qs, Rs, qs, rs, z0)
    U_dense = np.linalg.solve(P, -f).reshape(np.asarray(Rs).shape[0], -1)
    assert np.abs(np.asarray(U) - U_dense).max() < 1e-8
    # the returned Z is the rollout of U
    z = np.asarray(z0)
    for k, u in enumerate(np.asarray(U)):
        assert np.allclose(np.asarray(Z)[k], z, atol=1e-10)
        z = np.asarray(A) @ z + np.asarray(B) @ u


def test_box_barrier_matches_condensed_qp():
    A, B, Qs, Rs, qs, rs, z0 = _problem(seed=3)
    Np, m = np.asarray(Rs).shape[0], np.asarray(B).shape[1]
    u_lo, u_hi = -0.6, 0.6
    U, ok = solve_lq_box_barrier(A, B, Qs, Rs, qs, rs, z0, u_lo, u_hi,
                                 outer_iters=16, newton_iters=2)
    assert bool(ok)
    U = np.asarray(U)
    assert U.min() >= u_lo - 1e-9 and U.max() <= u_hi + 1e-9
    # some bound must actually be active or the test is vacuous
    assert (np.abs(np.abs(U) - u_hi) < 1e-2).any()

    P, f = _condense(A, B, Qs, Rs, qs, rs, z0)
    nU = m * Np
    Abox = np.concatenate([np.eye(nU), -np.eye(nU)], axis=0)
    bbox = np.concatenate([np.full(nU, u_hi), np.full(nU, -u_lo)])
    sol = solve_qp(jnp.asarray(P), jnp.asarray(f), jnp.asarray(Abox),
                   jnp.asarray(bbox), iters=30)
    assert bool(sol.ok)
    U_qp = np.asarray(sol.x).reshape(Np, m)
    assert np.abs(U - U_qp).max() < 5e-3


def test_long_horizon_scales():
    """Np = 200: the condensed Hessian would be 400x400 dense with a
    (n(Np+1) x mNp) Toeplitz assembly; the stage-wise path stays O(Np)."""
    A, B, Qs, Rs, qs, rs, z0 = _problem(Np=200, seed=7)
    U, ok = solve_lq_box_barrier(A, B, Qs, Rs, qs, rs, z0, -0.6, 0.6)
    assert bool(ok)
    U = np.asarray(U)
    assert np.isfinite(U).all()
    assert U.min() >= -0.6 - 1e-9 and U.max() <= 0.6 + 1e-9

    # constrained optimum beats naive clipping of the unconstrained optimum
    U_free, _ = solve_lq_stagewise(A, B, Qs, Rs, qs, rs, z0)
    U_clip = np.clip(np.asarray(U_free), -0.6, 0.6)

    def cost(Uv):
        An, Bn = np.asarray(A), np.asarray(B)
        z = np.asarray(z0)
        J = 0.0
        for k in range(Uv.shape[0]):
            J += 0.5 * z @ np.asarray(Qs)[k] @ z + np.asarray(qs)[k] @ z
            J += 0.5 * Uv[k] @ np.asarray(Rs)[k] @ Uv[k] + np.asarray(rs)[k] @ Uv[k]
            z = An @ z + Bn @ Uv[k]
        J += 0.5 * z @ np.asarray(Qs)[-1] @ z + np.asarray(qs)[-1] @ z
        return J

    assert cost(U) <= cost(U_clip) + 1e-6
