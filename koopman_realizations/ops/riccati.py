"""Stage-wise (Riccati) solvers for long-horizon MPC.

The condensed QP (``control.kmpc``) is the right shape for the reference's
short horizons (Np <= 20, decision dim m*Np ~ 30): one small dense solve.
Its Hessian is (m Np)^2 though, so cost grows cubically with the horizon.
These solvers keep the block-tridiagonal KKT structure instead: a backward
Riccati recursion + forward rollout solves the same problem in O(Np (n+m)^3)
-- the honest way to ever scale Np (SURVEY section 5 "long-horizon
stage-wise QP"), expressed as ``lax.scan`` passes that jit and vmap like
everything else here.

Problem (discrete LQ tracking, z0 fixed):

    min  sum_{k=0}^{Np} 1/2 z_k' Qk z_k + qk' z_k
       + sum_{k=0}^{Np-1} 1/2 u_k' Rk u_k + rk' u_k
    s.t. z_{k+1} = A z_k + B u_k

``solve_lq_stagewise`` solves it exactly; ``solve_lq_box_barrier`` adds
stage-local input box constraints via a log-barrier path whose Newton steps
are themselves LQ problems (the barrier only modifies Rk, rk per stage, so
the Riccati structure survives -- an interior-point method that never forms
a dense Hessian).  Stage-coupling constraints (input slope) can be handled
by augmenting the state with u_{k-1}; not done here.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from koopman_realizations.ops.batch_linalg import (
    chol_solve_unrolled,
    chol_unrolled,
)


def _solve_spd(M, X):
    """M^{-1} X for SPD M; X may be a matrix (columns solved together)."""
    L = chol_unrolled(M)
    if X.ndim == 1:
        return chol_solve_unrolled(L, X)
    return jax.vmap(lambda col: chol_solve_unrolled(L, col),
                    in_axes=1, out_axes=1)(X)


@partial(jax.jit, static_argnames=())
def solve_lq_stagewise(A, B, Qs, Rs, qs, rs, z0):
    """Backward Riccati + forward rollout for the LQ tracking problem.

    A (n, n), B (n, m) time-invariant dynamics; Qs (Np+1, n, n) /
    qs (Np+1, n) state costs; Rs (Np, m, m) / rs (Np, m) input costs;
    z0 (n,).  Returns (U [Np, m], Z [Np+1, n]).
    """
    with jax.default_matmul_precision("highest"):
        A = jnp.asarray(A)
        B = jnp.asarray(B)

        def backward(carry, inp):
            V, v = carry                        # cost-to-go 1/2 z'Vz + v'z
            Qk, qk, Rk, rk = inp
            VB = V @ B
            Guu = Rk + B.T @ VB
            Gux = VB.T @ A                      # (m, n)
            gu = rk + B.T @ v
            K = -_solve_spd(Guu, Gux)           # (m, n)
            d = -_solve_spd(Guu, gu)            # (m,)
            V1 = Qk + A.T @ V @ A + Gux.T @ K
            v1 = qk + A.T @ v + Gux.T @ d
            # symmetrize: roundoff asymmetry compounds over long horizons
            V1 = 0.5 * (V1 + V1.T)
            return (V1, v1), (K, d)

        (V0, v0), (Ks, ds) = jax.lax.scan(
            backward, (Qs[-1], qs[-1]),
            (Qs[:-1][::-1], qs[:-1][::-1], Rs[::-1], rs[::-1]))
        Ks = Ks[::-1]
        ds = ds[::-1]

        def forward(z, inp):
            K, d = inp
            u = K @ z + d
            z1 = A @ z + B @ u
            return z1, (u, z)

        zT, (U, Zpre) = jax.lax.scan(forward, jnp.asarray(z0), (Ks, ds))
        Z = jnp.concatenate([Zpre, zT[None]], axis=0)
        return U, Z


@partial(jax.jit, static_argnames=("outer_iters", "newton_iters"))
def solve_lq_box_barrier(A, B, Qs, Rs, qs, rs, z0, u_lo, u_hi,
                         outer_iters: int = 12, newton_iters: int = 1,
                         mu0: float = 1.0, mu_decay: float = 0.4):
    """LQ tracking with u_lo <= u_k <= u_hi via a log-barrier Riccati path.

    Each barrier Newton step is an LQ problem in the STEP du: the barrier
    Hessian/gradient only add stage-local diagonal terms to (Rk, rk), so the
    O(Np) Riccati solve does all the work -- no dense (m Np)^2 Hessian ever
    exists.  Fixed iteration counts (jit/vmap/scan friendly); fractional
    step-to-boundary keeps iterates strictly interior.

    Returns (U [Np, m], ok) with ok False if any non-finite appeared.
    """
    with jax.default_matmul_precision("highest"):
        A = jnp.asarray(A)
        B = jnp.asarray(B)
        Npp = Rs.shape[0]
        u_lo = jnp.broadcast_to(jnp.asarray(u_lo), (Rs.shape[-1],))
        u_hi = jnp.broadcast_to(jnp.asarray(u_hi), (Rs.shape[-1],))
        u_mid = 0.5 * (u_lo + u_hi)
        U = jnp.tile(u_mid[None], (Npp, 1))     # strictly interior start

        def rollout(U):
            def step(z, u):
                z1 = A @ z + B @ u
                return z1, z
            zT, Zpre = jax.lax.scan(step, jnp.asarray(z0), U)
            return jnp.concatenate([Zpre, zT[None]], axis=0)

        def newton_step(U, mu):
            Z = rollout(U)
            slo = U - u_lo                      # (Np, m) strictly positive
            shi = u_hi - U
            # barrier-augmented stage costs in the STEP variable du:
            #   grad_u = R u + r - mu (1/slo - 1/shi)
            #   hess_u = R + mu diag(1/slo^2 + 1/shi^2)
            Dk = mu * (1.0 / slo ** 2 + 1.0 / shi ** 2)          # (Np, m)
            Rbar = Rs + jax.vmap(jnp.diag)(Dk)
            gu = (jnp.einsum("kij,kj->ki", Rs, U) + rs
                  - mu * (1.0 / slo - 1.0 / shi))
            gz = jnp.einsum("kij,kj->ki", Qs, Z) + qs            # (Np+1, n)
            # LQ subproblem in (dz, du) about the feasible rollout
            dU, _ = solve_lq_stagewise(A, B, Qs, Rbar, gz, gu,
                                       jnp.zeros_like(Z[0]))
            # fractional step to the boundary (stay strictly interior)
            ratio = jnp.where(dU < 0, -slo / dU,
                              jnp.where(dU > 0, shi / dU, jnp.inf))
            alpha = jnp.minimum(1.0, 0.995 * jnp.min(ratio))
            return U + alpha * dU

        def outer(U, i):
            mu = mu0 * (mu_decay ** i)
            for _ in range(newton_iters):
                U = newton_step(U, mu)
            return U, None

        U, _ = jax.lax.scan(outer, U, jnp.arange(outer_iters))
        ok = jnp.all(jnp.isfinite(U))
        return jnp.where(ok, U, jnp.nan), ok
