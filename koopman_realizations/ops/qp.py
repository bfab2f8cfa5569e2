"""Batched dense QP solver (replaces MATLAB ``quadprog``/Gurobi).

Solves   min_x  1/2 x^T P x + q^T x   s.t.  A x <= b

with a Mehrotra predictor-corrector primal-dual interior-point method run for
a FIXED number of iterations -- no data-dependent control flow, so the whole
solve jits into the closed-loop scan and batches over thousands of scenarios
with vmap (decision dims here are tiny: m*Np ~ 30, constraint rows ~100, so
each iteration is one small Cholesky).

The reference calls ``quadprog(2H, f, A, b)`` per control step
(``Kmpc.get_mpcInput:383``, ``:810``, ``:883``); infeasible solves there
return NaN and Ksim breaks the loop (``Ksim.m:220-222``).  Here infeasible /
diverged lanes are flagged in the returned ``ok`` mask instead of crashing,
so one bad scenario cannot kill a 10k-lane batch.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class QPSolution(NamedTuple):
    x: jnp.ndarray       # primal solution
    lam: jnp.ndarray     # inequality multipliers
    ok: jnp.ndarray      # scalar bool: converged + finite
    gap: jnp.ndarray     # final complementarity gap


@partial(jax.jit, static_argnames=("iters", "shared_A"))
def solve_qp(P, q, A, b, iters: int = 25, x0=None,
             shared_A: bool = False, lam0=None) -> QPSolution:
    """Interior-point solve of min 1/2 x'Px + q'x s.t. Ax <= b.

    P must be symmetric PSD (the MPC Hessian is PSD by construction; a small
    primal regularization is added for the semidefinite case).  ``x0`` warm
    starts the primal iterate -- MPC solves pass the feasible "hold the
    previous input" plan, which matters when slope constraints make the
    feasible set a narrow band far from the origin.

    ``shared_A`` promises that A is NOT batched under an enclosing vmap
    (lane-shared constraint rows, the no-state-bounds MPC case): the Newton
    matrix then forms as one (B, mc) @ (mc, n^2) GEMM over precomputed row
    outer products.  Do not set it when A varies per lane.

    ``lam0`` (mc,): optional multiplier warm start in original units (the
    previous receding-horizon solve's ``lam``); floored internally so stale
    rows cannot start the predictor-corrector off the central path.

    The Newton systems need true f32 accumulation, so the solve runs at
    Precision.HIGHEST (no TF32 on the GPU).
    """
    with jax.default_matmul_precision("highest"):
        return _solve_qp_impl(P, q, A, b, iters, x0, shared_A, lam0)


def _factored_Pq(W, v, r_diag, q0=None):
    """Dense (P, q) of the objective ||W x + v||^2 + x'diag(r)x + q0'x."""
    P = 2.0 * (W.T @ W + jnp.diag(r_diag))
    q = 2.0 * (W.T @ v)
    if q0 is not None:
        q = q + q0
    return P, q


@partial(jax.jit, static_argnames=("iters",))
def solve_qp_factored(W, v, r_diag, A, b, iters: int = 25, x0=None,
                      lam0=None, q0=None) -> QPSolution:
    """Least-squares-form QP: min ||W x + v||_2^2 + x^T diag(r) x + q0^T x
    s.t. A x <= b  (dense form P = 2 (W^T W + diag(r)), q = 2 W^T v + q0).

    The factored objective is what condensed MPC assembly naturally
    produces (W = sqrt(Q) CB, v = sqrt(Q) (CA z - Yr + ...)).  A is
    lane-shared.  Semantics otherwise match ``solve_qp``.

    ``q0`` (n,): optional additive linear term.  Diagonal-quadratic +
    linear extras (e.g. the SQP's Levenberg term rho||x - x_prev||^2)
    fold into (r_diag + rho, q0 = -2 rho x_prev) instead of materializing
    sqrt(rho) I least-squares rows -- n fewer Gram rows per solve.
    """
    with jax.default_matmul_precision("highest"):
        P, q = _factored_Pq(jnp.asarray(W), jnp.asarray(v),
                            jnp.asarray(r_diag), q0)
        return _solve_qp_impl(P, q, A, b, iters, x0, True, lam0)


def _bilin_assemble(z, u_prev, Yr, PGW, PG0, PAsq, sq, cF, F0):
    """(W, v, b) of the shared-Beta bilinear QP, linear in the lane's lifted
    state z and previous input u_prev against lane-shared generators."""
    p = PAsq.shape[0]
    n = PGW.shape[0] // p
    m = u_prev.shape[-1]
    W = (PGW @ z).reshape(p, n)
    CB0 = (PG0 @ z).reshape(m, p).T
    v = PAsq @ z - sq * Yr + CB0 @ u_prev
    b = cF - F0 @ u_prev
    return W, v, b


@partial(jax.jit, static_argnames=("iters",))
def solve_qp_bilinear(z, u_prev, Yr, PGW, PG0, PAsq, sq, r_diag, A, cF, F0,
                      iters: int = 25, x0=None, lam0=None) -> QPSolution:
    """Bilinear-MPC solve from (z, u_prev) and the lane-shared generators
    (``BilinearKmpc.PGWb/PG0/PAsq``): assembles (W, v, b) and calls the
    factored solve.  Semantics are lane-for-lane those of assembling
    (W, v, b) and calling ``solve_qp_factored``.
    """
    with jax.default_matmul_precision("highest"):
        W, v, b = _bilin_assemble(z, u_prev, Yr, PGW, PG0, PAsq, sq, cF, F0)
        P, q = _factored_Pq(W, v, r_diag)
        return _solve_qp_impl(P, q, A, b, iters, x0, True, lam0)


def _bilin_lift_assemble(zeta, up, sqYr, Gz, Gm, Gb, Hz, Hm, Hb,
                         Pz, Pm, Pb, tables, p):
    """One lane's poly lift + assembly against the z-section-folded
    generators (``BilinearKmpc._lift_gens``).  Returns (W (p, n), v (p,))."""
    feats = []
    prev = zeta
    for parent_idx, dim_idx in tables:
        prev = prev[jnp.asarray(parent_idx)] * zeta[jnp.asarray(dim_idx)]
        feats.append(prev)
    monos = jnp.concatenate(feats) if feats else \
        jnp.zeros((0,), zeta.dtype)
    n = Gz.shape[0] // p
    m = up.shape[-1]
    W = (Gz @ zeta + Gm @ monos + Gb).reshape(p, n)
    CB0 = (Hz @ zeta + Hm @ monos + Hb).reshape(m, p).T
    v = Pz @ zeta + Pm @ monos + Pb - sqYr + CB0 @ up
    return W, v


def solve_qp_bilinear_lifted(zeta, u_prev, sqYr, lifted: dict, r_diag, A,
                             cF, F0, tables, iters: int = 25, x0=None,
                             lam0=None) -> QPSolution:
    """Lift-fused bilinear solve: the POLY LIFT and the QP assembly run
    against the z-section-folded generators.

    ``lifted`` carries the folded generators (Gz/Gm/Gb for W, Hz/Hm/Hb for
    CB0, Pz/Pm/Pb for v -- ``BilinearKmpc`` precomputes them in f64);
    ``tables`` the ``poly_parent_tables`` gather pairs as nested tuples.
    The lane ships its RAW zeta.  Semantics are lane-for-lane those of
    lifting and calling ``solve_qp_factored``.
    """
    return _solve_qp_bilinear_lifted(
        zeta, u_prev, sqYr, lifted["Gz"], lifted["Gm"], lifted["Gb"],
        lifted["Hz"], lifted["Hm"], lifted["Hb"], lifted["Pz"],
        lifted["Pm"], lifted["Pb"], r_diag, A, cF, F0, tables, iters, x0,
        lam0)


@partial(jax.jit, static_argnames=("tables", "iters"))
def _solve_qp_bilinear_lifted(zeta, u_prev, sqYr, Gz, Gm, Gb, Hz, Hm, Hb,
                              Pz, Pm, Pb, r_diag, A, cF, F0, tables, iters,
                              x0, lam0=None) -> QPSolution:
    with jax.default_matmul_precision("highest"):
        W, v = _bilin_lift_assemble(zeta, u_prev, sqYr, Gz, Gm, Gb,
                                    Hz, Hm, Hb, Pz, Pm, Pb, tables,
                                    Pz.shape[0])
        b = cF - F0 @ u_prev
        P, q = _factored_Pq(W, v, r_diag)
        return _solve_qp_impl(P, q, A, b, iters, x0, True, lam0)


def _nmpc_condense_assemble(jz, ju, cv, zeta, u_prev, sq, sqRef, Cz, cols,
                            m):
    """One lane's condensation + factored assembly (the SQP's sensitivity
    recursion).  jz (Np, nz, nz), ju (Np, nz, m), cv (Np, nz);
    returns (W (p, n), v (p,))."""
    Np, nz = jz.shape[0], jz.shape[1]
    nstate = Cz.shape[1]
    nproj = Cz.shape[0]
    nU = max(cols) + m            # decision columns: [u0 | reduced moves]
    W_rows, v_rows = [], []
    S = jnp.zeros((nz, nU), jz.dtype)
    s = zeta                      # s_0 = current state (S_0 = 0)
    for k in range(Np + 1):
        proj = Cz @ S[:nstate]                     # (nproj, nU)
        sproj = Cz @ s[:nstate]
        for r in range(nproj):
            sqk = sq[k * nproj + r]
            W_rows.append(sqk * proj[r, m:])
            v_rows.append(sqk * sproj[r] - sqRef[k * nproj + r]
                          + sqk * (proj[r, :m] @ u_prev))
        if k < Np:
            S = jz[k] @ S
            S = S.at[:, cols[k]:cols[k] + m].add(ju[k])
            s = jz[k] @ s + cv[k]
    return jnp.stack(W_rows), jnp.stack(v_rows)


def solve_qp_nmpc(jz, ju, cv, zeta, u_prev, sq, sqRef, Cz, r_diag, A, cF,
                  F0, cols, iters: int = 25, x0=None, q0=None, lam0=None
                  ) -> QPSolution:
    """NMPC-pass solve from the per-stage Jacobians and defects: the SQP's
    sensitivity recursion and W/v assembly (``_nmpc_condense_assemble``),
    then the factored solve.  ``cols`` is the static per-stage
    decision-column table (move blocking folds to repeated offsets).
    """
    return _solve_qp_nmpc(jz, ju, cv, zeta, u_prev, sq, sqRef, Cz, r_diag,
                          A, cF, F0, tuple(int(c) for c in cols), iters,
                          x0, q0, lam0)


@partial(jax.jit, static_argnames=("cols", "iters"))
def _solve_qp_nmpc(jz, ju, cv, zeta, u_prev, sq, sqRef, Cz, r_diag, A, cF,
                   F0, cols, iters, x0, q0, lam0) -> QPSolution:
    with jax.default_matmul_precision("highest"):
        W, v = _nmpc_condense_assemble(jz, ju, cv, zeta, u_prev, sq,
                                       sqRef, Cz, cols, u_prev.shape[-1])
        b = cF - F0 @ u_prev
        P, q = _factored_Pq(W, v, r_diag, q0)
        return _solve_qp_impl(P, q, A, b, iters, x0, True, lam0)


def build_stage_jac_ops(A1, G, tables, pos_x, nz: int, nza: int,
                        degree: int):
    """Host-side generator operands for the stage-Jacobian NMPC solve
    (``solve_qp_nmpc_stages`` / ``_stage_jacs_xla``).

    From the analytic-Jacobian statics (``kmpc._poly_jacobian_static``):
    reorders G's rows to COLUMN-major (J column j = contiguous rows
    j*nz..(j+1)*nz), splits its columns per g_low section (x coordinates
    -> zeta|u column groups via ``pos_x``; one block per low monomial
    degree) and builds the one-hot monomial selectors.  Returns (jac_ops
    tuple, jlayout).
    """
    import numpy as np

    m = nza - nz
    perm = np.empty(nza * nz, np.int64)
    for i in range(nza):
        for o in range(nz):
            perm[i * nz + o] = o * nza + i
    Gc = np.asarray(G, np.float64)[perm]               # (nza*nz, n_low)
    A1c = np.asarray(A1, np.float64).T.reshape(-1, 1)  # [(i, o)] = A1[o, i]
    xsec = Gc[:, np.asarray(pos_x)]                    # (nza*nz, nza)
    ops = [jnp.asarray(A1c, jnp.float32)]
    ops += [jnp.asarray(xsec[:, :nz], jnp.float32),
            jnp.asarray(xsec[:, nz:], jnp.float32)]
    jlayout = []
    off = nza
    mono_tables = tables[: degree - 2]
    prev_rows = nza
    for b, (p_idx, d_idx) in enumerate(mono_tables):
        r = len(p_idx)
        Sdz = np.zeros((r, nz), np.float32)
        Sdu = np.zeros((r, max(m, 1)), np.float32)
        for row_i, di in enumerate(d_idx):
            if int(di) < nz:
                Sdz[row_i, int(di)] = 1.0
            else:
                Sdu[row_i, int(di) - nz] = 1.0
        if b == 0:
            Spz = np.zeros((r, nz), np.float32)
            Spu = np.zeros((r, max(m, 1)), np.float32)
            for row_i, pi in enumerate(p_idx):
                if int(pi) < nz:
                    Spz[row_i, int(pi)] = 1.0
                else:
                    Spu[row_i, int(pi) - nz] = 1.0
            ops += [jnp.asarray(Spz), jnp.asarray(Spu)]
        else:
            Spar = np.zeros((r, prev_rows), np.float32)
            for row_i, pi in enumerate(p_idx):
                Spar[row_i, int(pi)] = 1.0
            ops += [jnp.asarray(Spar)]
        ops += [jnp.asarray(Sdz), jnp.asarray(Sdu)]
        ops += [jnp.asarray(Gc[:, off:off + r], jnp.float32)]
        jlayout.append(r)
        off += r
        prev_rows = r
    return tuple(ops), tuple(jlayout)


def build_stage_roll_ops(A1, A2, a0, tables, nz: int, nza: int):
    """Host-side composed-dynamics generators for the SQP rollout
    (``_stage_roll_xla``): F(x) = A1 x + A2 feats(x) + a0 with x = [zeta; u],
    feats the full degree-blocked monomials.  A1/A2 split per x-section /
    per block; selectors one-hot.  Returns (roll_ops tuple, flayout)."""
    import numpy as np
    m = nza - nz
    A1 = np.asarray(A1, np.float64)
    A2 = np.asarray(A2, np.float64)
    ops = [jnp.asarray(A1[:, :nz], jnp.float32),
           jnp.asarray(A1[:, nz:], jnp.float32),
           jnp.asarray(np.asarray(a0, np.float64).reshape(-1, 1),
                       jnp.float32)]
    flayout = []
    off = 0
    prev_rows = nza
    for b, (p_idx, d_idx) in enumerate(tables):
        r = len(p_idx)
        Sdz = np.zeros((r, nz), np.float32)
        Sdu = np.zeros((r, max(m, 1)), np.float32)
        for row_i, di in enumerate(d_idx):
            if int(di) < nz:
                Sdz[row_i, int(di)] = 1.0
            else:
                Sdu[row_i, int(di) - nz] = 1.0
        if b == 0:
            Spz = np.zeros((r, nz), np.float32)
            Spu = np.zeros((r, max(m, 1)), np.float32)
            for row_i, pi in enumerate(p_idx):
                if int(pi) < nz:
                    Spz[row_i, int(pi)] = 1.0
                else:
                    Spu[row_i, int(pi) - nz] = 1.0
            ops += [jnp.asarray(Spz), jnp.asarray(Spu)]
        else:
            Spar = np.zeros((r, prev_rows), np.float32)
            for row_i, pi in enumerate(p_idx):
                Spar[row_i, int(pi)] = 1.0
            ops += [jnp.asarray(Spar)]
        ops += [jnp.asarray(Sdz), jnp.asarray(Sdu),
                jnp.asarray(A2[:, off:off + r], jnp.float32)]
        flayout.append(r)
        off += r
        prev_rows = r
    return tuple(ops), tuple(flayout)


def _stage_roll_xla(zeta, Ul, roll_ops, flayout, nz, m, Np, mode):
    """Single-lane trajectory generation from the composed-dynamics
    generators (``build_stage_roll_ops``).  Returns
    (Zl (Np, nz), Ul (Np, m), Fv (Np, nz))."""
    A1z, A1u, a0 = roll_ops[0], roll_ops[1], roll_ops[2][:, 0]

    def F_eval(z, u):
        acc = A1z @ z + A1u @ u + a0
        idx = 3
        prev = None
        for b in range(len(flayout)):
            if b == 0:
                Spz, Spu, Sdz, Sdu, A2b = roll_ops[idx:idx + 5]
                idx += 5
                par = Spz @ z + Spu @ u
            else:
                Spar, Sdz, Sdu, A2b = roll_ops[idx:idx + 4]
                idx += 4
                par = Spar @ prev
            mono = par * (Sdz @ z + Sdu @ u)
            acc = acc + A2b @ mono
            prev = mono
        return acc

    if mode == "hold":
        F0v = F_eval(zeta, Ul[0])
        return (jnp.tile(zeta[None], (Np, 1)), Ul,
                jnp.tile(F0v[None], (Np, 1)))
    zs, fs = [], []
    z = zeta
    for k in range(Np):
        Fk = F_eval(z, Ul[k])
        zs.append(z)
        fs.append(Fk)
        z = Fk
    return jnp.stack(zs), Ul, jnp.stack(fs)


def _stage_jacs_xla(Zl, Ul, jac_ops, jlayout, nz, m):
    """Single-lane evaluation of the stage Jacobians from the generator
    operands of ``build_stage_jac_ops``.
    Zl (Np, nz), Ul (Np, m) -> (jz (Np, nz, nz), ju (Np, nz, m))."""
    nza = nz + m
    A1c = jac_ops[0][:, 0]
    Jc = A1c[None, :] + Zl @ jac_ops[1].T + Ul @ jac_ops[2].T  # (Np, nza*nz)
    idx = 3
    prev = None
    for b in range(len(jlayout)):
        if b == 0:
            Spz, Spu, Sdz, Sdu, Gm = jac_ops[idx:idx + 5]
            idx += 5
            par = Zl @ jnp.asarray(Spz).T + Ul @ jnp.asarray(Spu).T
        else:
            Spar, Sdz, Sdu, Gm = jac_ops[idx:idx + 4]
            idx += 4
            par = prev @ jnp.asarray(Spar).T
        dim = Zl @ jnp.asarray(Sdz).T + Ul @ jnp.asarray(Sdu).T
        mono = par * dim
        Jc = Jc + mono @ Gm.T
        prev = mono
    Np = Zl.shape[0]
    J = Jc.reshape(Np, nza, nz).transpose(0, 2, 1)     # [k, o, i]
    return J[..., :nz], J[..., nz:]


def solve_qp_nmpc_stages(Zl, Ul, Fv, zeta, u_prev, sq, sqRef, Cz, r_diag,
                         A, cF, F0, cols, jac_ops, jlayout,
                         iters: int = 25, x0=None, q0=None, lam0=None,
                         roll_mode: str = "ship", roll_ops=(), flayout=()
                         ) -> QPSolution:
    """Stage-Jacobian NMPC-pass solve: Jacobian/defect GENERATION from the
    SQP linearization trajectory (Zl (Np, nz), Ul (Np, m)) and rollout
    dynamics values Fv (Np, nz), then the ``solve_qp_nmpc`` condensation
    and solve.  ``jac_ops``/``jlayout`` come from ``build_stage_jac_ops``.

    ``roll_mode`` 'roll'/'hold' (with ``roll_ops``/``flayout`` from
    ``build_stage_roll_ops``) generates the linearization trajectory
    itself from the plan / held state.  Zl/Fv (and for 'hold' Ul) are
    ignored then.
    """
    dummy = jnp.zeros((0,), jnp.float32)
    if roll_mode != "ship":
        Zl, Fv = dummy, dummy
        if roll_mode == "hold":
            Ul = dummy
    return _solve_qp_nmpc_stages(
        Zl, Ul, Fv, zeta, u_prev, sq, sqRef, Cz, r_diag, A, cF, F0,
        tuple(int(c) for c in cols), jac_ops, tuple(jlayout), iters, x0,
        q0, lam0, roll_mode, tuple(roll_ops), tuple(flayout))


@partial(jax.jit,
         static_argnames=("cols", "jlayout", "iters", "roll_mode",
                          "flayout"))
def _solve_qp_nmpc_stages(Zl, Ul, Fv, zeta, u_prev, sq, sqRef, Cz, r_diag,
                          A, cF, F0, cols, jac_ops, jlayout, iters, x0,
                          q0, lam0, roll_mode="ship", roll_ops=(),
                          flayout=()) -> QPSolution:
    with jax.default_matmul_precision("highest"):
        nz = zeta.shape[-1]
        m = u_prev.shape[-1]
        Np = len(cols)
        if roll_mode != "ship":
            Ul_eff = Ul if roll_mode == "roll" else \
                jnp.tile(u_prev[None], (Np, 1))
            Zl, Ul, Fv = _stage_roll_xla(zeta, Ul_eff, roll_ops,
                                         flayout, nz, m, Np, roll_mode)
        jz, ju = _stage_jacs_xla(Zl, Ul, jac_ops, jlayout, nz, m)
        cv = Fv - jnp.einsum("kij,kj->ki", jz, Zl) \
            - jnp.einsum("kij,kj->ki", ju, Ul)
        W, v = _nmpc_condense_assemble(jz, ju, cv, zeta, u_prev, sq,
                                       sqRef, Cz, cols, m)
        b = cF - F0 @ u_prev
        P, q = _factored_Pq(W, v, r_diag, q0)
        return _solve_qp_impl(P, q, A, b, iters, x0, True, lam0)


def solve_qp_nmpc_multipass(zeta, u_prev, sq, sqRef, Cz, r_diag, A, cF,
                            F0, cols, jac_ops, jlayout, roll_ops, flayout,
                            Gup, q0c, n_passes: int, hold0: bool,
                            iters: int = 25) -> QPSolution:
    """Whole-SQP solve: ALL relinearization passes in one jitted function.
    Applies in the default SQP regime (cold per-pass duals, constant
    damping, no line-search/best-of-passes); the inter-pass warm start,
    Levenberg term, and rollout inputs are all functions of the previous
    pass's solution.  Returns the FINAL pass's solution/ok."""
    return _solve_qp_nmpc_multipass(
        zeta, u_prev, sq, sqRef, Cz, r_diag, A, cF, F0,
        tuple(int(c) for c in cols), tuple(jac_ops), tuple(jlayout),
        tuple(roll_ops), tuple(flayout), Gup, q0c, int(n_passes),
        bool(hold0), iters)


@partial(jax.jit,
         static_argnames=("cols", "jlayout", "flayout", "n_passes",
                          "hold0", "iters"))
def _solve_qp_nmpc_multipass(zeta, u_prev, sq, sqRef, Cz, r_diag, A, cF,
                             F0, cols, jac_ops, jlayout, roll_ops,
                             flayout, Gup, q0c, n_passes, hold0,
                             iters) -> QPSolution:
    with jax.default_matmul_precision("highest"):
        return _nmpc_multipass_pure(
            zeta, u_prev, sq, sqRef, Cz, r_diag, A, cF, F0, cols,
            jac_ops, jlayout, roll_ops, flayout, Gup, q0c, n_passes,
            hold0, iters)


def _nmpc_multipass_pure(zeta, u_prev, sq, sqRef, Cz, r_diag, A, cF, F0,
                         cols, jac_ops, jlayout, roll_ops, flayout, Gup,
                         q0c, n_passes, hold0, iters):
    """The SQP passes of ``solve_qp_nmpc_multipass`` for one lane."""
    nz = zeta.shape[-1]
    m = u_prev.shape[-1]
    Np = len(cols)
    group_row = [cols[k] - m for k in range(1, Np)]
    xp = jnp.asarray(Gup) @ u_prev
    sol = None
    b = cF - F0 @ u_prev
    for p in range(n_passes):
        Ul = jnp.stack([u_prev] + [xp[g:g + m] for g in group_row])
        mode = "hold" if (p == 0 and hold0) else "roll"
        Zl, Ul, Fv = _stage_roll_xla(zeta, Ul, roll_ops, flayout, nz, m,
                                     Np, mode)
        jz, ju = _stage_jacs_xla(Zl, Ul, jac_ops, jlayout, nz, m)
        cv = Fv - jnp.einsum("kij,kj->ki", jz, Zl) \
                - jnp.einsum("kij,kj->ki", ju, Ul)
        W, v = _nmpc_condense_assemble(jz, ju, cv, zeta, u_prev, sq,
                                       sqRef, Cz, cols, m)
        P, q = _factored_Pq(W, v, r_diag, jnp.asarray(q0c).reshape(-1) * xp)
        sol = _solve_qp_impl(P, q, A, b, iters, xp, True, None)
        xp = sol.x
    return sol


def _solve_qp_impl(P, q, A, b, iters, x0, shared_A, lam0=None):
    P = jnp.asarray(P)
    q = jnp.asarray(q)
    A = jnp.asarray(A)
    b = jnp.asarray(b)
    n = q.shape[-1]
    mc = b.shape[-1]
    dtype = P.dtype

    from koopman_realizations.ops.batch_linalg import (
        chol_solve_unrolled,
        chol_unrolled,
    )

    if mc == 0:
        # unconstrained QP (all MpcConfig constraints None): quadprog with
        # empty A just solves P x = -q; the IPM reductions over zero rows
        # would be 0/0, so solve the Newton system directly
        obj_scale = jnp.maximum(jnp.max(jnp.abs(P)), 1e-8)
        reg = 1e-11 if dtype == jnp.float64 else 1e-7
        L = chol_unrolled(P / obj_scale + reg * jnp.eye(n, dtype=dtype))
        x = chol_solve_unrolled(L, -q / obj_scale)
        ok = jnp.all(jnp.isfinite(x))
        return QPSolution(x=jnp.where(ok, x, jnp.nan),
                          lam=jnp.zeros((0,), dtype), ok=ok,
                          gap=jnp.zeros((), dtype))

    # equilibrate: normalize the objective scale and constraint rows so the
    # interior-point tolerances are absolute (MPC Hessians scale with the
    # lifted state magnitude and can swing many orders within one batch)
    obj_scale = jnp.maximum(jnp.max(jnp.abs(P)), 1e-8)
    P = P / obj_scale
    q = q / obj_scale
    row = jnp.maximum(jnp.max(jnp.abs(A), axis=1), 1e-10)
    A = A / row[:, None]
    b = b / row

    # primal regularization: keeps the Newton system SPD when P is singular
    reg = 1e-11 if dtype == jnp.float64 else 1e-7
    Pr = P + reg * jnp.eye(n, dtype=dtype)

    # cold starts need a well-centered slack (floor 1); warm starts are
    # near-feasible, so a small floor preserves the head start
    slack_floor = 1.0 if x0 is None else 1e-2
    x0 = jnp.zeros((n,), dtype) if x0 is None else jnp.asarray(x0, dtype)
    s0 = jnp.maximum(b - A @ x0, slack_floor)
    if lam0 is None:
        lam0 = jnp.ones((mc,), dtype)
    else:
        # original -> equilibrated units; the square root damps the start
        # halfway (geometrically) toward the cold lam = 1 -- raw previous
        # multipliers start the predictor-corrector too far off the central
        # path when the problem shifts between receding-horizon steps
        # (observed: a load-estimate update at step k stalls the next solve)
        lam0 = jnp.sqrt(jnp.clip(jnp.asarray(lam0, dtype) * row / obj_scale,
                                 1e-4, 1e4))

    if shared_A:
        # row outer products a_c a_c^T flattened: (mc, n*n); lane-shared
        O_flat = jnp.einsum("ci,cj->cij", A, A).reshape(mc, n * n)

    def max_step(v, dv):
        # largest alpha in (0,1] with v + alpha dv >= (1-tau) v
        ratio = jnp.where(dv < 0, -v / dv, jnp.inf)
        return jnp.minimum(1.0, 0.99 * jnp.min(ratio))

    # once the gap is at the numerical floor, further Newton systems go
    # singular (s*lam denormal) -- freeze converged iterates instead.
    mu_floor = 1e-13 if dtype == jnp.float64 else 1e-8

    def body(carry, _):
        x, s, lam = carry
        mu = (s @ lam) / mc
        r_p = A @ x + s - b
        r_d = Pr @ x + q + A.T @ lam
        active = (mu > mu_floor) | (jnp.max(jnp.abs(r_p)) > mu_floor)

        # the Newton matrix depends only on D = lam/s, so it is factored ONCE
        # per iteration and the factor reused for the predictor and corrector
        # directions (quadprog's predictor-corrector does the same)
        D = jnp.clip(lam / s, 1e-14, 1e14)
        if shared_A:
            M = Pr + (D @ O_flat).reshape(n, n)
        else:
            M = Pr + (A.T * D) @ A
        # unrolled small-matrix Cholesky: every step is one vector op over
        # the batch, which XLA fuses into the surrounding scan
        L = chol_unrolled(M)

        def direction(r_slam):
            rhs = -r_d - A.T @ ((-r_slam + lam * r_p) / s)
            dx = chol_solve_unrolled(L, rhs)
            ds = -r_p - A @ dx
            dlam = (-r_slam - lam * ds) / s
            return dx, ds, dlam

        # affine (predictor) direction
        dx_a, ds_a, dlam_a = direction(s * lam)
        alpha_a = jnp.minimum(max_step(s, ds_a), max_step(lam, dlam_a))
        mu_aff = ((s + alpha_a * ds_a) @ (lam + alpha_a * dlam_a)) / mc
        sigma = (mu_aff / (mu + 1e-30)) ** 3

        # corrector direction
        dx, ds, dlam = direction(s * lam + ds_a * dlam_a - sigma * mu)
        alpha = jnp.where(active,
                          jnp.minimum(max_step(s, ds), max_step(lam, dlam)), 0.0)
        step = lambda v, dv: jnp.where(jnp.isfinite(dv), v + alpha * dv, v)
        return (step(x, dx), step(s, ds), step(lam, dlam)), None

    (x, s, lam), _ = jax.lax.scan(body, (x0, s0, lam0), None, length=iters)

    gap = (s @ lam) / mc
    r_p = jnp.max(jnp.maximum(A @ x - b, 0.0))
    finite = jnp.all(jnp.isfinite(x))
    # "ok" mirrors quadprog's failure semantics (Ksim breaks only on NaN):
    # the lane survives as long as the iterate is finite and primal-feasible
    # to control accuracy; `gap` carries the exact convergence level for
    # callers that need certified optima.
    tol = 1e-4 if dtype == jnp.float64 else 3e-3
    gap_sane = 1e-2 if dtype == jnp.float64 else 5e-2
    ok = finite & (gap < gap_sane) & (r_p < tol * jnp.maximum(jnp.max(jnp.abs(b)), 1.0))
    x = jnp.where(finite, x, jnp.nan)
    # multipliers of the original (un-equilibrated) problem
    lam_orig = lam * obj_scale / row
    return QPSolution(x=x, lam=lam_orig, ok=ok, gap=gap)


def solve_qp_batch(P, q, A, b, iters: int = 25) -> QPSolution:
    """vmapped solve over leading batch axes of (P, q, A, b)."""
    return jax.vmap(lambda Pi, qi, Ai, bi: solve_qp(Pi, qi, Ai, bi, iters=iters))(
        P, q, A, b)


def solve_qp_eq(P, q, A, b, E, d, iters: int = 25):
    """QP with additional equality constraints E x = d.

    Handled by null-space elimination: x = x_p + Z v with E x_p = d and
    Z = null(E); the reduced problem is an inequality-only QP in v.
    Shapes must be static; E is assumed full row rank.
    """
    P = jnp.asarray(P); q = jnp.asarray(q)
    A = jnp.asarray(A); b = jnp.asarray(b)
    E = jnp.asarray(E); d = jnp.asarray(d)
    ne, n = E.shape
    # QR-based particular solution and null-space basis
    Qf, Rf = jnp.linalg.qr(E.T, mode="complete")
    R1 = Rf[:ne, :ne]
    x_p = Qf[:, :ne] @ jax.scipy.linalg.solve_triangular(R1.T, d, lower=True)
    Z = Qf[:, ne:]
    Pz = Z.T @ P @ Z
    qz = Z.T @ (q + P @ x_p)
    Az = A @ Z
    bz = b - A @ x_p
    sol = solve_qp(Pz, qz, Az, bz, iters=iters)
    return QPSolution(x=x_p + Z @ sol.x, lam=sol.lam, ok=sol.ok, gap=sol.gap)
