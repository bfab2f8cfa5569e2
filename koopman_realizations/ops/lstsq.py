"""Least-squares kernels.

The reference leans on MATLAB ``\\`` (``Ksysid.m:1069`` K = Px\\Py and the
M-projection ``Ksysid.m:1216``) and ``lsqlin`` for constrained problems.
Here:

- ``lstsq``             : SVD min-norm solve (pinv semantics; dictionary
                          Grams are routinely rank-deficient), works in f64
                          (CPU parity) and f32 (accelerator) with optional
                          iterative refinement.
- ``gram_lstsq``        : normal-equation solve from accumulated Gram
                          matrices -- the psum-friendly multi-chip path
                          (PxT Px and PxT Py are reduced over the snapshot
                          shard axis with a single collective).
(Constrained least squares -- the reference's ``lsqlin`` -- is solved by
the load observer directly through ``ops.qp.solve_qp``.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def lstsq(A, B, refine: int = 1, rcond: float | None = None):
    """Minimum-norm solve of min ||A X - B||_F via SVD.

    Dictionary Gram matrices are routinely rank-deficient (collinear
    observables), where plain QR produces huge spurious coefficients; the
    SVD min-norm solution matches numpy/MATLAB pinv semantics and keeps the
    extracted models bounded.  ``refine`` extra passes recover accuracy when
    running in float32.
    """
    A = jnp.asarray(A)
    B = jnp.asarray(B)
    U, s, Vt = jnp.linalg.svd(A, full_matrices=False)
    eps = jnp.finfo(A.dtype).eps
    if rcond is None:
        rcond = eps * max(A.shape)
    cutoff = rcond * s[0]
    s_inv = jnp.where(s > cutoff, 1.0 / s, 0.0)

    def solve(RHS):
        return Vt.T @ (s_inv[:, None] * (U.T @ RHS))

    X = solve(B)
    for _ in range(refine):
        X = X + solve(B - A @ X)
    return X


def gram_lstsq(AtA, AtB, ridge: float = 0.0, psum_axis: str | None = None):
    """Solve (AtA) X = AtB by Cholesky with a tiny diagonal ridge.

    When ``psum_axis`` is given the Gram matrices are first summed across
    that mesh axis (data-parallel EDMD: each chip lifts its shard of
    snapshots and contributes a rank-|shard| update; one psum replaces any
    gather of the raw snapshot matrix across devices).
    """
    if psum_axis is not None:
        AtA = jax.lax.psum(AtA, psum_axis)
        AtB = jax.lax.psum(AtB, psum_axis)
    n = AtA.shape[-1]
    eye = jnp.eye(n, dtype=AtA.dtype)
    scale = jnp.maximum(jnp.trace(AtA) / n, 1.0)
    Lc = jnp.linalg.cholesky(AtA + (ridge * scale) * eye)
    Y = jax.scipy.linalg.solve_triangular(Lc, AtB, lower=True)
    return jax.scipy.linalg.solve_triangular(Lc.T, Y, lower=False)


def ridge_for_dtype(dtype) -> float:
    """Default normal-equation jitter: ~1e-12 in f64, ~1e-6 in f32.

    Mirrors the reference's PSD repair of PxTPx (``Ksysid.m:1117-1120``);
    dictionary Gram matrices are often singular, so even the f64 path keeps a
    tiny ridge to make the Cholesky well-defined.
    """
    return 1e-12 if jnp.dtype(dtype) == jnp.float64 else 1e-6
