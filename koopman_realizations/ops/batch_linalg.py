"""Unrolled dense solvers for small matrices at huge batch sizes.

XLA's batched ``cholesky``/``triangular_solve`` lower to blocked
loop-heavy routines tuned for LARGE matrices; the MPC stack solves tens of
thousands of 20-40-dim SPD systems per second, where those routines are
pipeline-bubble-bound.  These solvers unroll the factorization over the
(static, small) matrix dimension so every step is a plain vector op over the
batch -- elementwise work that XLA fuses into the surrounding scan.

All functions operate on a single matrix and vmap/vectorize over leading
batch dims like any jnp op.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _highest_precision(fn):
    """Accelerator matmuls may default to reduced-precision inputs (TF32 on
    the GPU); factorizations need true f32 accumulation or diagonals go
    negative and sqrt returns NaN."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


@_highest_precision
def chol_unrolled(M):
    """Lower Cholesky factor of an SPD matrix, unrolled over n.

    M: (..., n, n) with static n (intended n <= ~64).  No pivoting (SPD).
    """
    n = M.shape[-1]
    rows = [None] * n            # rows[i]: (..., n) row i of L (zero-padded)
    cols = []
    M_work = M
    for j in range(n):
        d = jnp.sqrt(M_work[..., j, j])
        col = M_work[..., :, j] / d[..., None]          # (..., n); rows < j junk
        cols.append(col)
        # rank-1 downdate of the trailing block (full matrix: cheap & fused)
        M_work = M_work - col[..., :, None] * col[..., None, :]
    L = jnp.stack(cols, axis=-1)                        # (..., n, n)
    # zero the strict upper triangle
    tri = jnp.tril(jnp.ones((n, n), M.dtype))
    return L * tri


@_highest_precision
def chol_solve_unrolled(L, b):
    """Solve L L^T x = b given the unrolled factor; b: (..., n).

    Each substitution step is ONE dot product over the full row: entries of
    the running solution that are not yet computed are zero, and the strict
    triangle of L is zero, so the full dot equals the partial sum -- n steps
    of vector ops instead of O(n^2) scalar updates.
    """
    n = L.shape[-1]
    y = jnp.zeros_like(b)
    for i in range(n):                      # L y = b (forward)
        dot = jnp.einsum("...k,...k->...", L[..., i, :], y)
        y = y.at[..., i].set((b[..., i] - dot) / L[..., i, i])
    x = jnp.zeros_like(b)
    for i in reversed(range(n)):            # L^T x = y (backward)
        dot = jnp.einsum("...k,...k->...", L[..., :, i], x)
        x = x.at[..., i].set((y[..., i] - dot) / L[..., i, i])
    return x


def solve_spd_unrolled(M, b):
    """x = M^-1 b for SPD M via the unrolled Cholesky."""
    return chol_solve_unrolled(chol_unrolled(M), b)


@_highest_precision
def solve_via_normal_unrolled(A, b):
    """Solve a small nonsymmetric system via its SPD normal equations.

    x = (A^T A)^-1 A^T b.  Squares the condition number -- fine for the
    well-scaled Newton systems it serves (implicit-integrator stages), where
    it avoids XLA's slow batched LU path.
    """
    AtA = jnp.swapaxes(A, -1, -2) @ A
    Atb = jnp.einsum("...ji,...j->...i", A, b)
    return solve_spd_unrolled(AtA, Atb)
