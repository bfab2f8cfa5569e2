"""L1-constrained Koopman regression (the reference's LASSO QP).

``Ksysid.solve_KoopmanQP:1095-1176`` solves

    min ||Px K - Py||_F^2   s.t.  ||vec(K)||_1 <= t,
    (+ delay constraints pinning shift-structure entries of K to 1)

by splitting vec(K) into +/- parts and calling ``quadprog`` on a dense QP in
2(N+m)^2 variables (15k+ for the paper config).  Here the same problem is
solved directly as projected accelerated gradient (FISTA) on the matrix
variable: gradient = 2 (PxTPx K - PxTPy) (one N x N matmul per iteration), projection = Duchi L1-ball projection (sort + prefix sum).
Semantics match the reference formulation; the method does not.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def project_l1_ball(v, t):
    """Euclidean projection of v onto {x : ||x||_1 <= t} (Duchi et al.)."""
    v = jnp.asarray(v)
    abs_v = jnp.abs(v)
    inside = jnp.sum(abs_v) <= t

    u = jnp.sort(abs_v)[::-1]
    css = jnp.cumsum(u)
    k = jnp.arange(1, v.shape[0] + 1, dtype=v.dtype)
    cond = u * k > (css - t)
    rho = jnp.max(jnp.where(cond, jnp.arange(v.shape[0]), -1))
    theta = (css[rho] - t) / (rho + 1.0)
    proj = jnp.sign(v) * jnp.maximum(abs_v - theta, 0.0)
    return jnp.where(inside, v, proj)


@partial(jax.jit, static_argnames=("iters",))
def lasso_constrained_lstsq(Px, Py, t, pin_mask=None, pin_value=1.0,
                            iters: int = 2000):
    """FISTA for min ||Px K - Py||_F^2 s.t. ||vec(K)||_1 <= t.

    pin_mask: optional boolean (Nm, Nm) matrix of entries held at
    ``pin_value`` (the reference's delay constraints,
    ``Ksysid.m:1139-1164``); their absolute values consume L1 budget.
    """
    Px = jnp.asarray(Px)
    Py = jnp.asarray(Py)
    G = Px.T @ Px
    H = Px.T @ Py
    nm = G.shape[0]

    # Lipschitz constant of the gradient: 2 * lambda_max(G), via power iter.
    def pw(v, _):
        v = G @ v
        return v / jnp.linalg.norm(v), None
    v0 = jnp.ones((nm,), G.dtype) / jnp.sqrt(nm)
    v, _ = jax.lax.scan(pw, v0, None, length=30)
    L = 2.0 * jnp.maximum(v @ (G @ v), 1e-12)

    if pin_mask is not None:
        pin_mask = jnp.asarray(pin_mask)
        budget = t - pin_value * jnp.sum(pin_mask)
    else:
        budget = t

    def proj(K):
        if pin_mask is not None:
            free = jnp.where(pin_mask, 0.0, K)
            free = project_l1_ball(free.reshape(-1), budget).reshape(K.shape)
            return jnp.where(pin_mask, pin_value, free)
        return project_l1_ball(K.reshape(-1), t).reshape(K.shape)

    K0 = proj(jnp.zeros_like(H))

    def body(carry, _):
        K_prev, Z, tk = carry
        grad = 2.0 * (G @ Z - H)
        K_new = proj(Z - grad / L)
        t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * tk ** 2))
        Z_new = K_new + ((tk - 1.0) / t_new) * (K_new - K_prev)
        return (K_new, Z_new, t_new), None

    (K, _, _), _ = jax.lax.scan(body, (K0, K0, jnp.asarray(1.0, G.dtype)), None,
                                length=iters)
    return K


def lasso_constrained_lstsq_f64(Px, Py, t, pin_mask=None, pin_value=1.0,
                                iters: int = 2000, tol: float = None):
    """Host numpy float64 mirror of ``lasso_constrained_lstsq``.

    The Koopman regression must run in float64 (f32 visibly degrades
    models); with x64 off -- the default accelerator session -- the JAX FISTA above
    silently runs f32, so Ksysid routes through this host implementation,
    exactly like ``Ksysid._lstsq64`` does for the plain least squares.
    Same algorithm step for step; parity-tested against the JAX version
    under the x64 test env.

    ``tol``: optional convergence stop -- every 100 iterations the Gram-form
    objective is evaluated and the loop exits once its change falls below
    ``tol * max(obj, 1)``.  The paper-scale poly-3 Gram is conditioned at
    ~1e17, where 2000 fixed iterations leave a measured 2.4e-4 relative
    objective gap vs the certified oracle; converged FISTA (~30k iters,
    certified by ``tests/test_lasso_cert.py``) closes it, and ``tol`` keeps
    small well-conditioned problems from paying the full cap.
    """
    import numpy as np

    def proj_ball(v, tt):
        av = np.abs(v)
        if av.sum() <= tt:
            return v
        u = np.sort(av)[::-1]
        css = np.cumsum(u)
        k = np.arange(1, v.shape[0] + 1, dtype=v.dtype)
        cond = u * k > (css - tt)
        rho = np.max(np.where(cond, np.arange(v.shape[0]), -1))
        theta = (css[rho] - tt) / (rho + 1.0)
        return np.sign(v) * np.maximum(av - theta, 0.0)

    Px = np.asarray(Px, np.float64)
    Py = np.asarray(Py, np.float64)
    G = Px.T @ Px
    H = Px.T @ Py
    nm = G.shape[0]
    v = np.ones((nm,)) / np.sqrt(nm)
    for _ in range(30):
        v = G @ v
        v = v / np.linalg.norm(v)
    L = 2.0 * max(float(v @ (G @ v)), 1e-12)

    if pin_mask is not None:
        pin_mask = np.asarray(pin_mask)
        budget = float(t) - pin_value * float(pin_mask.sum())
    else:
        budget = float(t)

    def proj(K):
        if pin_mask is not None:
            free = np.where(pin_mask, 0.0, K)
            free = proj_ball(free.reshape(-1), budget).reshape(K.shape)
            return np.where(pin_mask, pin_value, free)
        return proj_ball(K.reshape(-1), float(t)).reshape(K.shape)

    K = proj(np.zeros_like(H))
    Z, tk = K, 1.0
    const = float((Py ** 2).sum())
    obj = lambda Kc: float(np.vdot(Kc, G @ Kc) - 2.0 * np.vdot(Kc, H)) + const
    f_prev = obj(K)
    for it in range(iters):
        grad = 2.0 * (G @ Z - H)
        K_new = proj(Z - grad / L)
        t_new = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * tk ** 2))
        Z = K_new + ((tk - 1.0) / t_new) * (K_new - K)
        K, tk = K_new, t_new
        if tol is not None and (it + 1) % 100 == 0:
            f = obj(K)
            if abs(f_prev - f) <= tol * max(abs(f), 1.0):
                break
            f_prev = f
    return K


# --------------------------------------------------------------------------
# certification oracle (tests/scripts only; not a production path)
# --------------------------------------------------------------------------


def lasso_oracle_penalized(G, H, mu, K0, pin_mask=None, pin_value=1.0,
                           tol: float = 1e-13, max_sweeps: int = 4000):
    """Cyclic coordinate descent on  min ||Px K - Py||_F^2 + mu ||K||_1.

    Independent oracle for certifying the FISTA path against the
    reference's +/- split quadprog semantics (``Ksysid.m:1095-1176``): the
    split QP's Hessian kron(I, Px^T Px) is block-diagonal over the columns
    of K, so for a fixed L1 multiplier each column is an independent lasso
    -- solved here to machine precision, vectorized over columns (shared
    Gram G = Px^T Px, H = Px^T Py).  Pinned entries (the delay constraints)
    are held at ``pin_value`` and excluded from both the penalty update and
    the free-budget accounting, matching ``lasso_constrained_lstsq``.
    """
    import numpy as np

    K = np.array(K0, np.float64, copy=True)
    d = np.diag(G)
    for _ in range(max_sweeps):
        delta = 0.0
        for i in range(G.shape[0]):
            c = H[i] - G[i] @ K + d[i] * K[i]
            new = np.sign(c) * np.maximum(np.abs(c) - 0.5 * mu, 0.0) / d[i]
            if pin_mask is not None:
                new = np.where(pin_mask[i], pin_value, new)
            delta = max(delta, float(np.max(np.abs(new - K[i]))))
            K[i] = new
        if delta < tol:
            break
    return K


def lasso_oracle_constrained(G, H, budget, mu_lo, mu_hi, K_warm,
                             pin_mask=None, pin_value=1.0,
                             bisect_steps: int = 25, cd_tol: float = 1e-13):
    """Budget-constrained oracle: bisection on the L1 multiplier, each
    step solving the penalized problem exactly (``lasso_oracle_penalized``)
    with warm starts.  ``[mu_lo, mu_hi]`` must bracket the multiplier
    (callers seed it from the candidate solution's own KKT gradient).
    Returns (K, mu) with K the solve at the final FEASIBLE (upper) end --
    so ``f(K) + mu (||K||_1 - budget)`` is a rigorous weak-duality lower
    bound on the constrained optimum.
    """
    import numpy as np

    def free_l1(K):
        if pin_mask is not None:
            return float(np.abs(np.where(pin_mask, 0.0, K)).sum())
        return float(np.abs(K).sum())

    K = np.array(K_warm, np.float64, copy=True)
    for _ in range(bisect_steps):
        mu = 0.5 * (mu_lo + mu_hi)
        K = lasso_oracle_penalized(G, H, mu, K, pin_mask, pin_value,
                                   tol=cd_tol)
        if free_l1(K) > budget:
            mu_lo = mu
        else:
            mu_hi = mu
    K = lasso_oracle_penalized(G, H, mu_hi, K, pin_mask, pin_value,
                               tol=cd_tol)
    return K, mu_hi
