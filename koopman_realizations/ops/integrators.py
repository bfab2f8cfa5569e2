"""ODE integrators for plant simulation.

The reference integrates with adaptive ``ode45`` + mass-matrix options
(``Arm.m:899-900, 951-952``).  On the accelerator a fixed-substep RK4 inside
``lax.scan``
is the throughput path (static shapes, fuses into the closed-loop scan); an
adaptive RKF45 with a bounded step count is provided for accuracy parity
checks against the shipped trajectories.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp


def rk4_step(f, x, dt):
    k1 = f(x)
    k2 = f(x + 0.5 * dt * k1)
    k3 = f(x + 0.5 * dt * k2)
    k4 = f(x + dt * k3)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def rk4(f, x0, T: float, substeps: int):
    """Integrate dx/dt = f(x) over [0, T] with ``substeps`` fixed RK4 steps."""
    dt = T / substeps

    def body(x, _):
        x1 = rk4_step(f, x, dt)
        return x1, None

    x, _ = jax.lax.scan(body, x0, None, length=substeps)
    return x


def sdirk2(f, x0, T: float, substeps: int, newton_iters: int = 3,
           jac_mode: str = "substep"):
    """L-stable 2-stage SDIRK (gamma = 1 - 1/sqrt(2)) with Newton stages.

    The arm plant is stiff (joint damping d=10 against mass-matrix
    eigenvalues ~1e-3 gives |lambda| up to ~7.4e3/s, SURVEY section 7
    "ode45 vs fixed-step"): explicit RK4 needs dt < 4e-4 s and still sits at
    the stability edge.  SDIRK2 is unconditionally stable and L-stable, so a
    few substeps per 50 ms control period suffice.

    ``jac_mode``:
    - 'substep' (default): MODIFIED Newton -- the iteration matrix
      I - gamma dt J is built and factored ONCE per substep (J at the
      substep's entry state) and the factor is reused across both stages and
      all Newton iterations.  Stale-Jacobian Newton converges linearly on
      the residual; the closed-loop plant step was 63% of the whole MPC step
      with exact Newton, and the Jacobian (autodiff through the mass-matrix
      solve) was most of that.
    - 'step': one Jacobian + factorization for the WHOLE [0, T] interval
      (evaluated at x0).  Cheapest; accuracy/stability depend on how much
      the state moves over T -- validate per plant before adopting.
    - 'stage': exact Newton (fresh Jacobian every iteration), the reference
      behavior for accuracy studies.
    """
    gamma = 1.0 - 1.0 / jnp.sqrt(2.0)
    dt = T / substeps
    n = x0.shape[-1]
    eye = jnp.eye(n, dtype=x0.dtype)

    from koopman_realizations.ops.batch_linalg import (
        chol_solve_unrolled,
        chol_unrolled,
        solve_via_normal_unrolled,
    )

    if jac_mode in ("substep", "step"):
        def _factor(x):
            J = jax.jacfwd(f)(x)
            M = eye - gamma * dt * J
            # normal-equation factor of the (nonsymmetric) iteration matrix
            with jax.default_matmul_precision("highest"):
                L = chol_unrolled(M.T @ M)
            return M, L

        def _substep(x, M, L):
            with jax.default_matmul_precision("highest"):
                def solve(rhs):
                    return chol_solve_unrolled(L, M.T @ rhs)

                def stage(x_base, k_init):
                    def newton(k, _):
                        fx = f(x_base + gamma * dt * k)
                        return k - solve(k - fx), None

                    k, _ = jax.lax.scan(newton, k_init, None,
                                        length=newton_iters)
                    return k

                k1 = stage(x, f(x))
                k2 = stage(x + (1.0 - gamma) * dt * k1, k1)
            return x + dt * ((1.0 - gamma) * k1 + gamma * k2)

        if jac_mode == "step":
            M0, L0 = _factor(jnp.asarray(x0))

            def body(x, _):
                return _substep(x, M0, L0), None
        else:
            def body(x, _):
                M, L = _factor(x)
                return _substep(x, M, L), None
    else:
        def stage_exact(x_base, k_init):
            def newton(k, _):
                xs = x_base + gamma * dt * k
                fx = f(xs)
                J = jax.jacfwd(f)(xs)
                # r = k - fx ; dr/dk = I - gamma dt J.  Normal-equation solve
                # avoids XLA's slow batched LU for these tiny systems.
                delta = solve_via_normal_unrolled(eye - gamma * dt * J, k - fx)
                return k - delta, None

            k, _ = jax.lax.scan(newton, k_init, None, length=newton_iters)
            return k

        def body(x, _):
            k1 = stage_exact(x, f(x))
            k2 = stage_exact(x + (1.0 - gamma) * dt * k1, k1)
            x1 = x + dt * ((1.0 - gamma) * k1 + gamma * k2)
            return x1, None

    x, _ = jax.lax.scan(body, jnp.asarray(x0), None, length=substeps)
    return x


# Dormand-Prince 5(4) coefficients (same pair as MATLAB ode45)
_DP_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
# numpy (not jnp): module-level device constants would force backend
# initialization at import time
import numpy as _np

_DP_B5 = _np.array([35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0])
_DP_B4 = _np.array([5179 / 57600, 0, 7571 / 16695, 393 / 640,
                    -92097 / 339200, 187 / 2100, 1 / 40])


def _dp_step(f, x, h):
    ks = []
    for row in _DP_A:
        xi = x
        for a, k in zip(row, ks):
            xi = xi + h * a * k
        ks.append(f(xi))
    K = jnp.stack(ks)
    x5 = x + h * jnp.tensordot(_DP_B5.astype(x.dtype), K, axes=1)
    x4 = x + h * jnp.tensordot(_DP_B4.astype(x.dtype), K, axes=1)
    err = jnp.max(jnp.abs(x5 - x4))
    return x5, err


def rk45(f, x0, T: float, rtol: float = 1e-3, atol: float = 1e-6,
         max_steps: int = 1000):
    """Adaptive Dormand-Prince over [0, T] (ode45 tolerances by default).

    Bounded-iteration ``while_loop``: jit-safe, used for parity validation
    of the arm plant against ode45-generated golden trajectories.
    """
    x0 = jnp.asarray(x0)

    def tol(x):
        return atol + rtol * jnp.max(jnp.abs(x))

    def cond(state):
        t, x, h, i = state
        return jnp.logical_and(t < T, i < max_steps)

    def body(state):
        t, x, h, i = state
        h = jnp.minimum(h, T - t)
        x_new, err = _dp_step(f, x, h)
        tol_v = tol(x)
        accept = err <= tol_v
        t = jnp.where(accept, t + h, t)
        x = jax.tree_util.tree_map(lambda a, b: jnp.where(accept, b, a), x, x_new)
        # standard step-size controller with safety factor
        ratio = jnp.where(err > 0, tol_v / err, 10.0)
        h = jnp.clip(h * jnp.clip(0.9 * ratio ** 0.2, 0.2, 5.0), 1e-10, T)
        return (t, x, h, i + 1)

    t0 = jnp.asarray(0.0, x0.dtype)
    h0 = jnp.asarray(T / 50.0, x0.dtype)
    _, x, _, _ = jax.lax.while_loop(cond, body, (t0, x0, h0, 0))
    return x
