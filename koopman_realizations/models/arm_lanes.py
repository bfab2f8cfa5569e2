"""Lane-structured (struct-of-arrays) batched arm plant step.

Why this exists: under plain ``vmap`` every intermediate of the per-lane
dynamics carries the tiny physics dims in the TRAILING axes: a ``(B, 3, 3)``
mass-matrix op is a batch of tiny matrix ops, and the autodiff Lagrangian
(``jacfwd`` over the mass matrix) materializes a ``(B, N, N, N)`` tensor
per RHS eval.

Here every scalar component is its OWN flat ``(B,)`` array (struct of
arrays): each op is one vector op over the batch and XLA fuses the whole
chain.  The Euler-Lagrange terms use the closed-form planar-chain reduction
instead of autodiff:

    th = J a (J lower-triangular ones),  thd = J ad
    M_th[p][q] = cf[p][q] cos(th_p - th_q) + i delta_pq,
                 cf[p][q] = l^2 (m G[p][q] + w1)
    Dq = J^T M_th J                                  (suffix sums)
    (Dq_dt ad - dKE/da)[k] = sum_{p>=k, q} S[p][q] thd_q^2      (Coriolis)
                 S[p][q] = cf[p][q] sin(th_p - th_q)
    dPE/da[k] = g l sum_{j>=k} (m b[j] + w1) sin(th_j - w2) + k_spring a_k

(the Coriolis line follows from S antisymmetric: Dq_dt ad = J^T dM_th/dt thd
with dM_th[p][q]/dt = -S[p][q](thd_p - thd_q), and dKE/da_k =
-sum_{p>=k,q} S[p][q] thd_p thd_q; their difference telescopes to
sum S thd_q^2).  Cross-validated against the autodiff path
(``models.arm.Arm.rhs``, itself validated vs the reference's symbolic EOM,
``Arm.set_EOM:111-222``) in ``tests/test_arm_lanes.py``.

The SDIRK2 here mirrors ``ops.integrators.sdirk2`` (same gamma, stage
structure, modified-Newton semantics for jac_mode 'step'/'substep'); the
stage Jacobian comes from n forward-mode ``jax.jvp`` basis passes through
the closed-form RHS -- still tuples of (B,) arrays throughout.

Routed automatically: ``Arm.simulate_Ts`` is a ``custom_vmap`` -- unbatched
calls take the per-lane autodiff path, vmapped calls (the closed-loop
scenario batch) land here with the whole batch at once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


# ------------------------------------------------------------- small solvers


def chol_soa(M, n):
    """Cholesky of an SPD matrix given as list-of-lists of (B,) entries."""
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = M[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = jnp.sqrt(s)
        L[j][j] = d
        for i in range(j + 1, n):
            s = M[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / d
    return L


def chol_solve_soa(L, rhs, n):
    """Solve L L^T x = rhs; rhs and result are lists of (B,) entries."""
    y = [None] * n
    for i in range(n):
        s = rhs[i]
        for j in range(i):
            s = s - L[i][j] * y[j]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for j in range(i + 1, n):
            s = s - L[j][i] * x[j]
        x[i] = s / L[i][i]
    return x


def lu_soa(S, n):
    """LU factors (no pivoting) of a matrix given as list-of-lists of
    (B,) entries; L unit-lower and U packed into one list-of-lists."""
    F = [list(r) for r in S]
    for k in range(n):
        for i in range(k + 1, n):
            lik = F[i][k] / F[k][k]
            F[i][k] = lik
            for j in range(k + 1, n):
                F[i][j] = F[i][j] - lik * F[k][j]
    return F


def lu_solve_soa(F, rhs, n):
    """Solve S x = rhs from ``lu_soa`` factors."""
    y = []
    for i in range(n):
        acc = rhs[i]
        for k in range(i):
            acc = acc - F[i][k] * y[k]
        y.append(acc)
    x = [None] * n
    for i in reversed(range(n)):
        acc = y[i]
        for k in range(i + 1, n):
            acc = acc - F[i][k] * x[k]
        x[i] = acc / F[i][i]
    return x


# ------------------------------------------------------------------ dynamics


def rhs_soa(cfg, G, bvec, a, ad, u, w1, w2):
    """Joint accelerations, all components (B,) arrays.

    a, ad: length-N lists; u: length-Nmods list; w1/w2: (B,) load mass and
    gravity tilt.  G, bvec: the host numpy inertia/lever coefficient tables
    from ``Arm.__init__``.  Returns the length-N accel list.
    """
    N = cfg.Nlinks
    l2 = cfg.l ** 2
    i_rot = cfg.i

    th, thd = [], []
    run_a = None
    run_d = None
    for i in range(N):
        run_a = a[i] if run_a is None else run_a + a[i]
        run_d = ad[i] if run_d is None else run_d + ad[i]
        th.append(run_a)
        thd.append(run_d)

    # pairwise trig, computed once per unordered pair
    cos_pq = [[None] * N for _ in range(N)]
    sin_pq = [[None] * N for _ in range(N)]
    for p in range(N):
        cos_pq[p][p] = None                     # cos(0)=1 handled inline
        for q in range(p):
            dth = th[p] - th[q]
            cos_pq[p][q] = cos_pq[q][p] = jnp.cos(dth)
            s = jnp.sin(dth)
            sin_pq[p][q] = s
            sin_pq[q][p] = -s

    def cf(p, q):
        return l2 * (cfg.m * float(G[p, q])) + l2 * w1

    # M_th entries (symmetric)
    M_th = [[None] * N for _ in range(N)]
    for p in range(N):
        M_th[p][p] = cf(p, p) + i_rot
        for q in range(p):
            M_th[p][q] = M_th[q][p] = cf(p, q) * cos_pq[p][q]

    # Dq = J^T M_th J via double suffix sums
    T1 = [[None] * N for _ in range(N)]         # T1[p][j] = sum_{q>=j} M_th
    for p in range(N):
        run = None
        for j in reversed(range(N)):
            run = M_th[p][j] if run is None else run + M_th[p][j]
            T1[p][j] = run
    Dq = [[None] * N for _ in range(N)]         # Dq[i][j] = sum_{p>=i} T1
    for j in range(N):
        run = None
        for i in reversed(range(N)):
            run = T1[i][j] if run is None else run + T1[i][j]
            Dq[i][j] = run

    # Coriolis: C[k] = sum_{p>=k} sum_q S[p][q] thd_q^2
    thd2 = [t * t for t in thd]
    s_row = []
    for p in range(N):
        acc = None
        for q in range(N):
            if q == p:
                continue
            term = cf(p, q) * sin_pq[p][q] * thd2[q]
            acc = term if acc is None else acc + term
        s_row.append(acc if acc is not None else jnp.zeros_like(th[0]))
    C = [None] * N
    run = None
    for k in reversed(range(N)):
        run = s_row[k] if run is None else run + s_row[k]
        C[k] = run

    # gravity + springs: dPE/da[k]
    grav = []
    for j in range(N):
        lever = cfg.m * float(bvec[j]) + w1
        grav.append(lever * jnp.sin(th[j] - w2))
    dPE = [None] * N
    run = None
    for k in reversed(range(N)):
        run = grav[k] if run is None else run + grav[k]
        dPE[k] = cfg.g * cfg.l * run + cfg.k * a[k]

    # input torque tau = -ku (kron(u, 1_nlinks) - a)  (Arm.m:211-213)
    rhs = []
    for k in range(N):
        tau_k = -cfg.ku * (u[k // cfg.nlinks] - a[k])
        non_inert = C[k] + dPE[k] + cfg.d * ad[k] + tau_k
        rhs.append(-non_inert)

    L = chol_soa(Dq, N)
    return chol_solve_soa(L, rhs, N)


def make_rhs_tuple(cfg, G, bvec, us, w1, w2):
    """RHS over the state tuple xs = (a_0..a_{N-1}, ad_0..ad_{N-1})."""
    N = cfg.Nlinks

    def f(*xs):
        a = list(xs[:N])
        ad = list(xs[N:])
        addot = rhs_soa(cfg, G, bvec, a, ad, us, w1, w2)
        return tuple(ad) + tuple(addot)

    return f


# ---------------------------------------------------------------- integrator


def sdirk2_soa(cfg, G, bvec, X, U, W, Ts, substeps, newton_iters, jac_mode):
    """Batched SDIRK2 step over one control period; X (B, nx) -> (B, nx).

    Thin layout adapter over ``sdirk2_rows`` (the tuple-level integrator).
    """
    n = 2 * cfg.Nlinks
    xs0 = tuple(X[:, i] for i in range(n))
    us = [U[:, j] for j in range(cfg.Nmods)]
    xs = sdirk2_rows(cfg, G, bvec, xs0, us, W[:, 0], W[:, 1], Ts, substeps,
                     newton_iters, jac_mode)
    return jnp.stack(xs, axis=1)


def sdirk2_rows(cfg, G, bvec, xs0, us, w1, w2, Ts, substeps, newton_iters,
                jac_mode):
    """SDIRK2 over one control period on TUPLES of same-shape arrays.

    Layout-agnostic core: components may be (B,) struct-of-arrays columns
    (``sdirk2_soa``) or rows of any common shape.  Same method as
    ``ops.integrators.sdirk2`` (gamma = 1 - 1/sqrt(2), modified Newton,
    jac_mode 'step' = one factor per Ts / 'substep' = one per substep); the
    Newton systems are solved by block elimination of the second-order
    structure (see ``factor``) instead of normal equations.
    """
    N = cfg.Nlinks
    n = 2 * N
    # gamma pinned to the component dtype: a weak/64-bit scalar would
    # promote every stage op of an f32 plant under x64 configs
    gamma = 1.0 - 1.0 / jnp.sqrt(jnp.asarray(2.0, xs0[0].dtype))
    dt = Ts / substeps

    f = make_rhs_tuple(cfg, G, bvec, list(us), w1, w2)

    zeros = jnp.zeros_like(xs0[0])
    ones = jnp.ones_like(xs0[0])

    h = gamma * dt

    def factor(xs):
        # The state is (a, ad) with f = (ad, addot(a, ad)), so the
        # iteration matrix I - h J is [[I, -h I], [-h Ja, I - h Jad]].
        # Eliminating the first block leaves the N x N system
        #   S dad = r2 + h Ja r1,  S = I - h Jad - h^2 Ja,  da = r1 + h dad
        # whose LU (no pivoting: S = I + h M^-1 (damping) + h^2 M^-1
        # (stiffness) is strongly diagonal) keeps the f32 solve at the
        # conditioning of S -- the 2N normal equations squared it, which
        # left one chord-Newton step with ~1e-3 of f32 rounding error.
        cols = []
        for i in range(n):
            tang = tuple(ones if j == i else zeros for j in range(n))
            _, jc = jax.jvp(f, xs, tang)
            cols.append(jc[N:])              # d addot / d x_i, tuple of rows
        Ja = [[cols[c][r] for c in range(N)] for r in range(N)]
        S = [[(1.0 if r == c else 0.0) - h * cols[N + c][r]
              - (h * h) * Ja[r][c] for c in range(N)] for r in range(N)]
        return Ja, lu_soa(S, N)

    def solve_newton(Ja, LU, r):
        r1, r2 = r[:N], r[N:]
        rhs = []
        for i in range(N):
            acc = r2[i]
            for c in range(N):
                acc = acc + h * (Ja[i][c] * r1[c])
            rhs.append(acc)
        dad = lu_solve_soa(LU, rhs, N)
        return [r1[i] + h * dad[i] for i in range(N)] + dad

    def substep(xs, M, L):
        def stage(x_base, k_init):
            def newton(k, _):
                xk = tuple(x_base[i] + gamma * dt * k[i] for i in range(n))
                fx = f(*xk)
                res = [k[i] - fx[i] for i in range(n)]
                delta = solve_newton(M, L, res)
                return tuple(k[i] - delta[i] for i in range(n)), None

            k, _ = jax.lax.scan(newton, k_init, None, length=newton_iters)
            return k

        k1 = stage(xs, f(*xs))
        k2 = stage(tuple(xs[i] + (1.0 - gamma) * dt * k1[i]
                         for i in range(n)), k1)
        return tuple(xs[i] + dt * ((1.0 - gamma) * k1[i] + gamma * k2[i])
                     for i in range(n))

    if jac_mode == "step":
        M0, L0 = factor(xs0)

        def body(xs, _):
            return substep(xs, M0, L0), None
    else:                                        # 'substep'

        def body(xs, _):
            M, L = factor(xs)
            return substep(xs, M, L), None

    xs, _ = jax.lax.scan(body, xs0, None, length=substeps)
    return xs
