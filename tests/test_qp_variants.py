"""Every QP front end of ``ops.qp`` against the native float64 oracle.

Each case builds an MPC-shaped problem (move-blocked input box + slope
rows, factored least-squares objective), assembles the dense (P, q, A, b)
independently in numpy, solves it with ``native/qp_ref.cpp`` and checks
the front end's converged solution against it.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from koopman_realizations.ops import qp_ref
from koopman_realizations.ops.observables import poly_parent_tables
from koopman_realizations.ops.qp import (
    solve_qp,
    solve_qp_bilinear,
    solve_qp_bilinear_lifted,
    solve_qp_factored,
    solve_qp_nmpc,
)

pytestmark = pytest.mark.skipif(not qp_ref.available(),
                                reason="native toolchain unavailable")

ITERS = 30


def box_slope(m, groups, umax=1.0, slope=0.3):
    """Input box rows on every move and slope rows between consecutive
    moves, the first against u_prev: A x <= cF - F0 u_prev."""
    n = m * groups
    rows, c, f0 = [], [], []
    for i in range(n):
        for sgn in (1.0, -1.0):
            r = np.zeros(n)
            r[i] = sgn
            rows.append(r), c.append(umax), f0.append(np.zeros(m))
    for g in range(groups):
        for j in range(m):
            for sgn in (1.0, -1.0):
                r = np.zeros(n)
                r[g * m + j] = sgn
                f = np.zeros(m)
                if g == 0:
                    f[j] = -sgn
                else:
                    r[(g - 1) * m + j] = -sgn
                rows.append(r), c.append(slope), f0.append(f)
    return np.asarray(rows), np.asarray(c), np.asarray(f0)


def factored_dense(W, v, r, q0=None):
    P = 2.0 * (W.T @ W + np.diag(r))
    q = 2.0 * W.T @ v
    return P, q if q0 is None else q + q0


def case_factored(rng, q0=False):
    m, groups, p = 3, 4, 22
    n = m * groups
    A, cF, F0 = box_slope(m, groups)
    W = rng.standard_normal((p, n))
    v = rng.standard_normal(p)
    r = rng.uniform(0.01, 0.1, n)
    u = rng.uniform(-0.5, 0.5, m)
    b = cF - F0 @ u
    q0v = rng.standard_normal(n) if q0 else None
    sol = solve_qp_factored(jnp.asarray(W), jnp.asarray(v), jnp.asarray(r),
                            jnp.asarray(A), jnp.asarray(b), iters=ITERS,
                            x0=jnp.tile(jnp.asarray(u), groups),
                            q0=None if q0v is None else jnp.asarray(q0v))
    return sol, (*factored_dense(W, v, r, q0v), A, b)


def case_dense_shared(rng):
    m, groups = 3, 4
    n = m * groups
    A, cF, F0 = box_slope(m, groups)
    M = rng.standard_normal((n, n))
    P = M @ M.T + 0.1 * np.eye(n)
    q = 3.0 * rng.standard_normal(n)
    b = cF - F0 @ rng.uniform(-0.5, 0.5, m)
    sol = solve_qp(jnp.asarray(P), jnp.asarray(q), jnp.asarray(A),
                   jnp.asarray(b), iters=ITERS, shared_A=True)
    return sol, (P, q, A, b)


def case_warm_dual(rng):
    """A dual warm start from a converged solve of a nearby problem."""
    m, groups = 3, 4
    n = m * groups
    A, cF, F0 = box_slope(m, groups)
    M = rng.standard_normal((n, n))
    P = M @ M.T + 0.1 * np.eye(n)
    q = 3.0 * rng.standard_normal(n)
    b = cF - F0 @ rng.uniform(-0.5, 0.5, m)
    _, lam_prev, status = qp_ref.solve_qp_ref(P, q + 0.1, A, b)
    assert status == 0
    sol = solve_qp(jnp.asarray(P), jnp.asarray(q), jnp.asarray(A),
                   jnp.asarray(b), iters=ITERS, shared_A=True,
                   lam0=jnp.asarray(lam_prev))
    return sol, (P, q, A, b)


def case_bilinear(rng):
    m, groups, p, NL = 3, 4, 22, 8
    n = m * groups
    A, cF, F0 = box_slope(m, groups)
    PGW = rng.standard_normal((p * n, NL)) / NL
    PG0 = rng.standard_normal((m * p, NL)) / NL
    PAsq = rng.standard_normal((p, NL))
    sq = rng.uniform(1.0, 3.0, p)
    z, u, Yr = (rng.standard_normal(NL), rng.uniform(-0.5, 0.5, m),
                rng.standard_normal(p))
    r = rng.uniform(0.01, 0.1, n)
    sol = solve_qp_bilinear(*(jnp.asarray(a) for a in (
        z, u, Yr, PGW, PG0, PAsq, sq, r, A, cF, F0)), iters=ITERS)
    W = (PGW @ z).reshape(p, n)
    CB0 = (PG0 @ z).reshape(m, p).T
    v = PAsq @ z - sq * Yr + CB0 @ u
    return sol, (*factored_dense(W, v, r), A, cF - F0 @ u)


def case_lifted(rng):
    m, groups, p, nz = 3, 4, 22, 3
    n = m * groups
    A, cF, F0 = box_slope(m, groups)
    _, tables = poly_parent_tables(nz, 3)
    tables = tuple((tuple(int(x) for x in pi), tuple(int(x) for x in di))
                   for pi, di in tables)
    nmono = sum(len(pi) for pi, _ in tables)
    gen = {}
    for k, rows in (("G", p * n), ("H", m * p), ("P", p)):
        gen[k + "z"] = rng.standard_normal((rows, nz)) / 4
        gen[k + "m"] = rng.standard_normal((rows, nmono)) / 8
        gen[k + "b"] = rng.standard_normal(rows) / 4
    zeta, u = rng.uniform(-1, 1, nz), rng.uniform(-0.5, 0.5, m)
    sqYr, r = rng.standard_normal(p), rng.uniform(0.01, 0.1, n)
    sol = solve_qp_bilinear_lifted(
        jnp.asarray(zeta), jnp.asarray(u), jnp.asarray(sqYr),
        {k: jnp.asarray(a) for k, a in gen.items()}, jnp.asarray(r),
        jnp.asarray(A), jnp.asarray(cF), jnp.asarray(F0), tables,
        iters=ITERS)
    # monomials of degree 2 and 3 by exponent enumeration, in the
    # parent-recurrence order of the tables
    monos, prev = [], zeta
    for pi, di in tables:
        prev = np.asarray([prev[a] * zeta[d] for a, d in zip(pi, di)])
        monos.append(prev)
    g = np.concatenate(monos)
    lin = {k: gen[k + "z"] @ zeta + gen[k + "m"] @ g + gen[k + "b"]
           for k in "GHP"}
    W = lin["G"].reshape(p, n)
    v = lin["P"] - sqYr + lin["H"].reshape(m, p).T @ u
    return sol, (*factored_dense(W, v, r), A, cF - F0 @ u)


def case_nmpc_condense(rng):
    """SQP pass: condensation of the stage Jacobians (stage k >= 1 moves
    by block; columns [u_0 | one move per group])."""
    Np, nz, m, nproj, nstate = 4, 4, 2, 2, 3
    cols = (0, 2, 4, 4)
    nU = max(cols) + m
    A, cF, F0 = box_slope(m, (nU - m) // m)
    jz = 0.5 * rng.standard_normal((Np, nz, nz))
    ju = rng.standard_normal((Np, nz, m))
    cv = 0.1 * rng.standard_normal((Np, nz))
    zeta, u = rng.standard_normal(nz), rng.uniform(-0.5, 0.5, m)
    Cz = rng.standard_normal((nproj, nstate))
    p = (Np + 1) * nproj
    sq, sqRef = rng.uniform(1, 2, p), rng.standard_normal(p)
    r = rng.uniform(0.01, 0.1, nU - m)
    sol = solve_qp_nmpc(*(jnp.asarray(a) for a in (
        jz, ju, cv, zeta, u, sq, sqRef, Cz, r, A, cF, F0)), cols,
        iters=ITERS)
    # explicit stacked prediction zeta_k = s_k + S_k [u_0; moves]
    S, s = np.zeros((nz, nU)), zeta.copy()
    Ys, ys = [], []
    for k in range(Np + 1):
        Ys.append(Cz @ S[:nstate])
        ys.append(Cz @ s[:nstate])
        if k < Np:
            E = np.zeros((m, nU))
            E[:, cols[k]:cols[k] + m] = np.eye(m)
            S, s = jz[k] @ S + ju[k] @ E, jz[k] @ s + cv[k]
    Sy, sy = np.concatenate(Ys), np.concatenate(ys)
    W = sq[:, None] * Sy[:, m:]
    v = sq * (sy + Sy[:, :m] @ u) - sqRef
    return sol, (*factored_dense(W, v, r), A, cF - F0 @ u)


CASES = {
    "factored": case_factored,
    "factored_q0": lambda rng: case_factored(rng, q0=True),
    "dense_shared_A": case_dense_shared,
    "warm_dual": case_warm_dual,
    "bilinear": case_bilinear,
    "lifted_bilinear": case_lifted,
    "nmpc_condense": case_nmpc_condense,
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_qp_front_end_matches_native(name, seed):
    sol, (P, q, A, b) = CASES[name](np.random.default_rng(seed))
    x_ref, _, status = qp_ref.solve_qp_ref(P, q, A, b)
    assert status == 0
    assert bool(sol.ok)
    x = np.asarray(sol.x)
    # control accuracy of the fixed-iteration f64 solve (BASELINE: 1e-4)
    np.testing.assert_allclose(x, x_ref, atol=1e-5)
    # and it is a KKT point of the independently assembled problem
    lam = np.asarray(sol.lam)
    assert np.abs(P @ x + q + A.T @ lam).max() < 1e-4 * max(
        1.0, np.abs(q).max())
    assert (A @ x - b).max() < 1e-6
