"""Horizon-condensed MPC on Koopman realizations (reference class ``Kmpc``).

Three controller types, mirroring ``Kmpc.m``:
- ``LinearKmpc``    : all cost/constraint matrices precomputed once
  (``get_costMatrices:157-211``, ``get_constraintMatrices:214-326``); one QP
  per control step (``get_mpcInput:329-387``).
- ``BilinearKmpc``  : prediction matrices depend on the current lifted state
  through Beta(z); rebuilt per solve from precomputed powers of A
  (``get_costB_bilinear:569-596``, ``get_mpcInput_bilinear_iter:817-904``),
  with ``iter`` relinearization passes (Ksim uses iter=1).
- ``NonlinearKmpc`` : SQP by iterated linearization of the discrete vector
  field F(zeta, u) with autodiff Jacobians, condensed to an input-only QP
  (semantics of ``get_mpcInput_nonlinear:1114-1181``; fmincon's sqp becomes
  a fixed-iteration Gauss-Newton real-time iteration).

Batched-accelerator mechanics shared by all three:
- the "memory" equality u_0 = u_prev (``Kmpc.m:374-379``) is eliminated from
  the decision variable instead of appended as constraint rows,
- prediction matrices use precomputed A-powers (associative, static shapes),
- the per-step QP is ``ops.qp.solve_qp`` -- fixed-iteration interior point,
  jitted into the closed-loop scan and vmapped over scenario lanes,
- infeasible lanes surface as ``ok=False`` masks, not NaN crashes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from koopman_realizations.config import MpcConfig
from koopman_realizations.models.koopman import (
    BilinearModel,
    LinearModel,
    NonlinearModel,
)
from koopman_realizations.ops.qp import (
    solve_qp,
    solve_qp_bilinear,
    solve_qp_bilinear_lifted,
    solve_qp_factored,
    solve_qp_nmpc,
    solve_qp_nmpc_stages,
)


# --------------------------------------------------------------------------
# static constraint stacking (host-side numpy; Kmpc.get_constraintMatrices)
# --------------------------------------------------------------------------


def input_constraint_rows(cfg: MpcConfig, m: int, Np: int, scaler):
    """(F, c) rows acting on the stacked input U in scaled units.

    Unlike the reference we omit the all-zero padding rows (0 <= 0 rows are
    vacuous and break interior-point slacks).
    Blocks: input bounds (``Kmpc.m:230-253``), slope (``:256-277``),
    smoothness (``:280-297``).

    Bounds start at k=1: u_0 is pinned to the previously applied input by the
    memory constraint and eliminated from the decision variable, so its bound
    rows would become all-zero rows of the reduced QP (vacuous, and they
    poison the interior-point row equilibration).
    """
    F_rows, c_rows = [], []
    if cfg.input_bounds is not None:
        ib = np.asarray(cfg.input_bounds, float)
        if ib.ndim == 1:
            ib = np.tile(ib, (m, 1))                      # expand_props
        lo = np.asarray(scaler.u_down(ib[:, 0]))
        hi = np.asarray(scaler.u_down(ib[:, 1]))
        eye = np.eye(m)
        for k in range(1, Np):
            sel = np.zeros((m, m * Np))
            sel[:, k * m:(k + 1) * m] = eye
            F_rows += [-sel, sel]
            c_rows += [-lo, hi]
    if cfg.input_slopeConst is not None:
        lim = cfg.input_slopeConst * float(np.mean(scaler.u_factor))
        for k in range(Np - 1):
            sel = np.zeros((m, m * Np))
            sel[:, (k + 1) * m:(k + 2) * m] = np.eye(m)
            sel[:, k * m:(k + 1) * m] = -np.eye(m)
            F_rows += [sel, -sel]
            c_rows += [np.full(m, lim), np.full(m, lim)]
    if cfg.input_smoothConst is not None:
        # the caller applies the reference's Ts^2 factor to these rows
        lim = cfg.input_smoothConst * float(np.mean(scaler.u_factor))
        for k in range(Np - 2):
            sel = np.zeros((m, m * Np))
            sel[:, k * m:(k + 1) * m] = np.eye(m)
            sel[:, (k + 1) * m:(k + 2) * m] = -2 * np.eye(m)
            sel[:, (k + 2) * m:(k + 3) * m] = np.eye(m)
            F_rows += [sel, -sel]
            c_rows += [np.full(m, lim), np.full(m, lim)]
    if not F_rows:
        return np.zeros((0, m * Np)), np.zeros((0,))
    return np.concatenate(F_rows, axis=0), np.concatenate(c_rows)


def move_blocking(blocks, m: int, Np: int, F, cF):
    """Input move-blocking basis + reduced constraint stack.

    ``blocks`` are group lengths over the free stages 1..Np-1: the stacked
    input tail U[1:] = Tb @ V with V one free move per group (u_0 stays
    pinned/eliminated as always).  Returns
    (Tb ((Np-1)m, nf m), Sel (nf m, (Np-1)m), Fr, F0, cr) where the reduced
    inequality stack is Fr @ V <= cr - F0 @ u_prev.

    Row reduction is done by ALGEBRA on the full stack (F @ [I_m (+) Tb]),
    then dropping rows made vacuous by the blocking: intra-group slope rows
    lose all coefficients (u_{k+1} = u_k by construction; all-zero rows
    poison interior-point equilibration, same invariant as the builders),
    and a group's stages share identical bound rows (exact duplicates; the
    first occurrence is kept, so the surviving layout is the builder's
    box-then-slope block order with 'stages' = groups -- the layout
    ``dual_shift_perm``-style maps rely on).
    """
    blocks = tuple(int(b) for b in blocks)
    if any(b < 1 for b in blocks):
        # zero/negative group lengths would pass the sum check but produce
        # all-zero Tb columns (singular reduced Hessian) or aliased Sel rows
        raise ValueError(f"input_blocks {blocks} must all be >= 1")
    if sum(blocks) != Np - 1:
        raise ValueError(f"input_blocks {blocks} must sum to Np-1={Np - 1}")
    nf = len(blocks)
    Tb = np.zeros(((Np - 1) * m, nf * m))
    Sel = np.zeros((nf * m, (Np - 1) * m))
    s = 0
    for g, L in enumerate(blocks):
        for k in range(s, s + L):
            Tb[k * m:(k + 1) * m, g * m:(g + 1) * m] = np.eye(m)
        Sel[g * m:(g + 1) * m, s * m:(s + 1) * m] = np.eye(m)
        s += L
    Fr_full = F[:, m:] @ Tb
    F0_full = F[:, :m]
    keep = []
    seen = set()
    for i in range(Fr_full.shape[0]):
        if not Fr_full[i].any() and not F0_full[i].any():
            continue                              # vacuous intra-group row
        key = (np.round(Fr_full[i], 9).tobytes()
               + np.round(F0_full[i], 9).tobytes()
               + np.round(cF[i], 9).tobytes())
        if key in seen:
            continue                              # duplicated group row
        seen.add(key)
        keep.append(i)
    keep = np.asarray(keep, np.int64)
    return Tb, Sel, Fr_full[keep], F0_full[keep], cF[keep], keep


def expected_blocked_keep(cfg: MpcConfig, m: int, Np: int, blocks):
    """Kept-row indices ``move_blocking`` MUST produce for the builders'
    box-then-slope stack -- the structural ground truth the blocked dual
    shift layout (``dual_shift_perm_blocked``) relies on.

    Derivation: bound rows of the stages inside a group fold to identical
    reduced rows (first stage survives the dedup); a slope row u_{k+1}-u_k
    survives iff it crosses a group boundary (k+1 is a group's first stage)
    or pins against u_prev (k=0).  Recomputed independently here so a future
    reorder of ``move_blocking``'s reduction that happens to preserve the
    row COUNT still fails loudly instead of silently mis-seeding the
    warm-started duals.
    """
    blocks = tuple(int(b) for b in blocks)
    idx = []
    base = 0
    if cfg.input_bounds is not None:
        starts = np.concatenate([[0], np.cumsum(blocks)[:-1]])
        for s in starts:                 # group's first stage is 1 + s
            idx.extend(range(base + int(s) * 2 * m,
                             base + (int(s) + 1) * 2 * m))
        base += 2 * m * (Np - 1)
    if cfg.input_slopeConst is not None:
        boundary_ks = np.concatenate([[0], np.cumsum(blocks)[:-1]])
        for k in sorted(int(v) for v in boundary_ks):
            idx.extend(range(base + k * 2 * m, base + (k + 1) * 2 * m))
        base += 2 * m * (Np - 1)
    return np.asarray(idx, np.int64)


def dual_shift_perm_blocked(cfg: MpcConfig, m: int, nf: int):
    """Stage-advance map for the move-blocked reduced constraint rows.

    After ``move_blocking``'s reduction the surviving layout is the
    builder's block order with groups in place of stages: bounds nf groups
    x 2m rows, slope nf blocks (the k=0 row vs u_prev plus nf-1 group
    boundaries) x 2m.  A one-STAGE receding shift advances one group
    exactly while the leading groups have length 1 (the intended blocking
    shape); for longer tail groups it is the same heuristic seed the
    unblocked shift is.
    """
    idx = []
    base = 0

    def block(num):
        nonlocal base
        for k in range(num):
            src = min(k + 1, num - 1)
            idx.extend(range(base + src * 2 * m, base + (src + 1) * 2 * m))
        base += num * 2 * m

    if cfg.input_bounds is not None:
        block(nf)
    if cfg.input_slopeConst is not None:
        block(nf)
    return np.asarray(idx, np.int32)


def dual_shift_perm(cfg: MpcConfig, m: int, Np: int):
    """Row permutation advancing input-constraint multipliers one stage.

    Receding horizon: the new problem's u_k sits where the old problem's
    u_{k+1} sat, so the multiplier for a stage-k row is best seeded from the
    old stage-(k+1) row (same input index, same inequality side); the last
    stage reuses itself.  Block layout mirrors ``input_constraint_rows``:
    bounds (stages 1..Np-1), slope (diffs 0..Np-2), smoothness (0..Np-3),
    each stage 2m rows.
    """
    idx = []
    base = 0

    def block(num_stages):
        nonlocal base
        for k in range(num_stages):
            src = min(k + 1, num_stages - 1)
            idx.extend(range(base + src * 2 * m, base + (src + 1) * 2 * m))
        base += num_stages * 2 * m

    if cfg.input_bounds is not None:
        block(Np - 1)
    if cfg.input_slopeConst is not None:
        block(Np - 1)
    if cfg.input_smoothConst is not None:
        block(Np - 2)
    return np.asarray(idx, np.int32)


def state_constraint_rows(cfg: MpcConfig, n: int, NL: int, Np: int, scaler):
    """(E, c) rows bounding the first n lifted coords (``Kmpc.m:300-318``).

    The k=0 and k=1 blocks are omitted: the current state is fixed and z_1
    depends only on the pinned input u_0, so those rows have zero
    coefficients in the reduced decision variable (vacuous, and they poison
    the interior-point equilibration exactly like the pinned-input bound
    rows).  A current state violating its own bound therefore does not make
    the QP infeasible here (the reference's quadprog would fail).
    """
    if cfg.state_bounds is None:
        return np.zeros((0, NL * (Np + 1))), np.zeros((0,))
    sb = np.asarray(cfg.state_bounds, float)
    if sb.ndim == 1:
        sb = np.tile(sb, (n, 1))
    lo = np.asarray(scaler.y_down(sb[:, 0]))
    hi = np.asarray(scaler.y_down(sb[:, 1]))
    E_rows, c_rows = [], []
    for k in range(2, Np + 1):
        sel = np.zeros((n, NL * (Np + 1)))
        sel[:, k * NL:k * NL + n] = np.eye(n)
        E_rows += [-sel, sel]
        c_rows += [-lo, hi]
    return np.concatenate(E_rows, axis=0), np.concatenate(c_rows)


def _pad_ref(refhor, Np: int, nproj: int):
    """Pad/truncate a reference window to Np+1 rows (``Kmpc.m:354-362``)."""
    refhor = jnp.asarray(refhor)
    K = refhor.shape[0]
    if K == Np + 1:
        return refhor
    if K > Np + 1:
        return refhor[: Np + 1]
    pad = jnp.tile(refhor[-1:], (Np + 1 - K, 1))
    return jnp.concatenate([refhor, pad], axis=0)


def _smooth_ts2(cfg: MpcConfig, Ts: float, c_in: np.ndarray, m: int, Np: int):
    """Apply the reference's Ts^2 factor to the smoothness rows."""
    if cfg.input_smoothConst is None:
        return c_in
    c = c_in.copy()
    # bound rows cover k = 1..Np-1 only (u_0 is pinned/eliminated), so the
    # smooth block starts after 2m(Np-1) + 2m(Np-1) rows
    n_b = 0 if cfg.input_bounds is None else 2 * m * (Np - 1)
    n_s = 0 if cfg.input_slopeConst is None else 2 * m * (Np - 1)
    start = n_b + n_s
    assert start + 2 * m * (Np - 2) == c.size, "smooth rows must be last"
    c[start:] *= Ts ** 2
    return c


class _KmpcBase:
    """Shared setup: dims, projection, scaling, constraint stacks."""

    def __init__(self, model, scaler, cfg: MpcConfig):
        self.model = model
        self.meta = model.meta
        self.scaler = scaler
        self.cfg = cfg
        self.Np = cfg.horizon or int(np.floor(1.0 / self.meta.Ts))
        self.n, self.m = self.meta.n, self.meta.m
        self.NL = self.meta.NL

        # projection: row indices of y tracked by the reference
        self.proj_idx = tuple(cfg.proj_idx) if cfg.proj_idx is not None \
            else tuple(range(self.n))
        self.nproj = len(self.proj_idx)
        C = np.asarray(model.C)
        self.projmtx = C[list(self.proj_idx), :]          # (nproj, NL)

        # Q, R diagonal weights over the stacked horizon
        q_diag = np.full((self.Np + 1, self.nproj), cfg.cost_running)
        q_diag[-1] = cfg.cost_terminal
        self.q_diag = q_diag.reshape(-1)
        r = np.asarray(cfg.cost_input, float).reshape(-1)
        if r.size == 1:
            r = np.full(self.m, r[0])
        self.r_diag = np.tile(r, self.Np)

        # static input-constraint rows
        F, cF = input_constraint_rows(cfg, self.m, self.Np, scaler)
        cF = _smooth_ts2(cfg, self.meta.Ts, cF, self.m, self.Np)
        self.F, self.cF = F, cF
        self._Tb = None
        if cfg.input_blocks is not None:
            if cfg.input_smoothConst is not None \
                    or cfg.state_bounds is not None:
                raise NotImplementedError(
                    "input_blocks with input_smoothConst/state_bounds is "
                    "not supported")
            (self._Tb, self._Sel, self.F_red, self.F0_red,
             self.cF_red, kept) = move_blocking(cfg.input_blocks, self.m,
                                                self.Np, F, cF)
            # structural ground truth, not just a row count: the kept-row
            # indices must be exactly the box-then-slope group layout that
            # dual_shift_perm_blocked assumes -- a reduction reorder that
            # preserves the count must still fail loudly here
            exp = expected_blocked_keep(cfg, self.m, self.Np,
                                        cfg.input_blocks)
            if kept.shape != exp.shape or (kept != exp).any():
                raise AssertionError(
                    f"move_blocking kept-row layout drift: got {kept}, "
                    f"expected box-then-slope group layout {exp}")
        # optional stage-advance of carried multipliers (qp_dual_shift);
        # extended with identity over any appended state-bound rows by
        # _extend_dual_shift once the controller knows its full row count
        self._dual_shift = None
        if getattr(cfg, "qp_dual_shift", False) and F.shape[0]:
            if self._Tb is not None:
                self._dual_shift = dual_shift_perm_blocked(
                    cfg, self.m, len(cfg.input_blocks))
                assert self._dual_shift.size == self.F_red.shape[0], (
                    f"blocked dual_shift layout drift: perm covers "
                    f"{self._dual_shift.size} rows, reduced F has "
                    f"{self.F_red.shape[0]}")
            else:
                self._dual_shift = dual_shift_perm(cfg, self.m, self.Np)
                # dual_shift_perm re-derives input_constraint_rows' block
                # layout independently; a reorder/resize of the constraint
                # blocks must fail loudly, not silently mis-seed the
                # qp_iters=2 regime
                assert self._dual_shift.size == F.shape[0], (
                    f"dual_shift_perm layout drift: perm covers "
                    f"{self._dual_shift.size} rows, F has {F.shape[0]}")

    def _extend_dual_shift(self, n_con: int):
        """Pad the F-row shift permutation with identity to ``n_con`` rows
        (state-bound rows keep their own multiplier) and move it on-device."""
        if self._dual_shift is None:
            return
        perm = self._dual_shift
        if n_con > perm.size:
            perm = np.concatenate(
                [perm, np.arange(perm.size, n_con, dtype=np.int32)])
        self._dual_shift = jnp.asarray(perm)

    def _shift_lam(self, lam_init):
        """Apply the receding-horizon stage shift to a carried dual start."""
        if lam_init is None or self._dual_shift is None:
            return lam_init
        return jnp.take(lam_init, self._dual_shift, axis=-1)

    # memory-constraint elimination helpers -------------------------------

    def _eliminate_u0(self, P, f, A, b, u0):
        """Pin the first input block to u0 and reduce the QP.

        Replaces the reference's tacked-on equality rows (``Kmpc.m:374-379``).
        """
        m = self.m
        P22 = P[m:, m:]
        fz = f[m:] + P[m:, :m] @ u0
        Az = A[:, m:]
        bz = b - A[:, :m] @ u0
        return P22, fz, Az, bz

    def _assemble_U(self, u0, z):
        return jnp.concatenate([u0, z]).reshape(self.Np, self.m)

    def _warm_start(self, u0, U_init=None):
        """Primal start for the reduced decision [u_1..u_{Np-1}].

        Default: hold u0 across the horizon (always feasible for the
        bound/slope/smooth rows).  With ``U_init`` (the previous step's plan,
        (Np, m)), use its shifted tail -- the classic receding-horizon warm
        start.
        """
        if U_init is None:
            return jnp.tile(u0, self.Np - 1)
        shifted = jnp.concatenate([U_init[2:], U_init[-1:]], axis=0)
        return shifted.reshape(-1)


class LinearKmpc(_KmpcBase):
    """Linear-model MPC with fully static condensed matrices."""

    def __init__(self, model: LinearModel, scaler, cfg: MpcConfig):
        super().__init__(model, scaler, cfg)
        A = np.asarray(model.A)
        B = np.asarray(model.B)
        NL, m, Np = self.NL, self.m, self.Np

        powers = [np.eye(NL)]
        for _ in range(Np):
            powers.append(powers[-1] @ A)

        # stacked prediction: z_i = A^i z0 + sum_j A^(i-1-j) B u_j
        Abig = np.concatenate(powers, axis=0)                    # (NL(Np+1), NL)
        Bbig = np.zeros((NL * (Np + 1), m * Np))
        for i in range(1, Np + 1):
            for j in range(i):
                Bbig[i * NL:(i + 1) * NL, j * m:(j + 1) * m] = powers[i - 1 - j] @ B

        Cbig = np.kron(np.eye(Np + 1), self.projmtx)             # ((Np+1)p, NL(Np+1))
        CA = Cbig @ Abig
        CB = Cbig @ Bbig

        if self._Tb is not None:
            # move blocking: fold Tfull = blockdiag(I_m, Tb) into the STATIC
            # condensed matrices (decision = [u_0 | one move per group]);
            # constraints use the pre-reduced/deduped stack, re-stacked as
            # [F0 | Fr] so the u_0 elimination below applies unchanged
            Tfull = np.zeros((Np * m, m + self._Tb.shape[1]))
            Tfull[:m, :m] = np.eye(m)
            Tfull[m:, m:] = self._Tb
            CB = CB @ Tfull
            L = np.concatenate([self.F0_red, self.F_red], axis=1)
            M = np.zeros((L.shape[0], NL))
            c = self.cF_red
        else:
            E, cE = state_constraint_rows(cfg, self.n, NL, Np, scaler)
            L = np.concatenate([self.F, E @ Bbig], axis=0)
            M = np.concatenate([np.zeros((self.F.shape[0], NL)), E @ Abig],
                               axis=0)
            c = np.concatenate([self.cF, cE])
        H = CB.T @ (self.q_diag[:, None] * CB)
        if self._Tb is not None:
            H += np.diag(np.concatenate(
                [self.r_diag[:m], self._Tb.T @ self.r_diag[m:]]))
        else:
            H += np.diag(self.r_diag)

        self.CA = jnp.asarray(CA)
        self.CB = jnp.asarray(CB)
        self.H = jnp.asarray(H)
        self.L = jnp.asarray(L)
        self.Mc = jnp.asarray(M)
        self.c = jnp.asarray(c)
        self.Qd = jnp.asarray(self.q_diag)
        if self._Tb is not None:
            self._Tbj = jnp.asarray(self._Tb, jnp.float32)
            self._Selj = jnp.asarray(self._Sel, jnp.float32)
        self._extend_dual_shift(L.shape[0])

    @property
    def n_con(self) -> int:
        """Constraint-row count of the reduced QP (for dual-warm carries)."""
        return self.L.shape[0]

    def solve(self, z, u_prev, refhor, U_init=None, lam_init=None):
        """One MPC solve (``Kmpc.get_mpcInput:329-387``), jittable.

        z: current lifted state (NL,); u_prev: last applied input (m,);
        refhor: scaled reference window (<=Np+1, nproj); U_init: optional
        previous plan for warm starting; lam_init: optional dual warm start
        (previous step's lam).  Returns (U [Np, m], ok), or (U, ok, lam)
        when lam_init is given.
        """
        ref = _pad_ref(refhor, self.Np, self.nproj)
        Yr = ref.reshape(-1)
        # f = 2 CB^T Q (CA z - Yr)   (== (z'G + Yr'D)' of the reference)
        f = 2.0 * self.CB.T @ (self.Qd * (self.CA @ z - Yr))
        P = 2.0 * self.H
        b = self.c - self.Mc @ z
        Pz, fz, Az, bz = self._eliminate_u0(P, f, self.L, b, u_prev)
        # L (hence the reduced Az) is a static per-model constant even with
        # state bounds -- only b varies per lane -- so the lane-shared
        # Newton-matrix form always applies (unlike BilinearKmpc, whose
        # state-bound rows depend on the per-lane linearization)
        x0 = self._warm_start(u_prev, U_init)
        if self._Tb is not None:
            x0 = self._Selj @ x0
        sol = solve_qp(Pz, fz, Az, bz, iters=self.cfg.qp_iters,
                       x0=x0, shared_A=True,
                       lam0=self._shift_lam(lam_init))
        xfull = self._Tbj @ sol.x if self._Tb is not None else sol.x
        if lam_init is None:
            return self._assemble_U(u_prev, xfull), sol.ok
        return self._assemble_U(u_prev, xfull), sol.ok, sol.lam


def bilinear_consts(mpc: "BilinearKmpc") -> dict:
    """Pytree of per-model constants for ``bilinear_solve_pure``.

    Stacking these over a candidate axis (jax.tree_map + stack) lets a whole
    lasso sweep's controllers run as ONE vmapped closed loop
    (``workflows.lasso_sweep``).
    """
    c = {
        "Bm": mpc.model.B,            # (NL, m, NL)
        "A": mpc.powers[1],           # (NL, NL) -- for iters>1 re-rolls
        "PA": mpc.PA,                 # (Np+1, p, NL)
        "PAt": mpc.PAt,               # (Np+1, Np, p, NL) Toeplitz-gathered
        "PG": mpc.PG,                 # ((Np+1) p Np m, NL) fused shared-Beta
        "EA": mpc.EA, "EAt": mpc.EAt,
        "Fj": mpc.Fj, "cFj": mpc.cFj,
        "Qd": mpc.Qd, "Rd": mpc.Rd,
    }
    if mpc._Tb is not None:
        # move-blocked reduced problem (see MpcConfig.input_blocks)
        c.update({"Tb": jnp.asarray(mpc._Tb, jnp.float32),
                  "Sel": jnp.asarray(mpc._Sel, jnp.float32),
                  "FjT": jnp.asarray(mpc.F_red, jnp.float32),
                  "cFjT": jnp.asarray(mpc.cF_red, jnp.float32),
                  "F0T": jnp.asarray(mpc.F0_red, jnp.float32),
                  # Tb^T diag(Rd) Tb is diagonal (disjoint groups): each
                  # held stage still pays its input cost
                  "RdT": jnp.asarray(mpc._Tb.T @ mpc.r_diag[mpc.m:],
                                     jnp.float32)})
        # blocked shared-Beta first pass from (z, u_prev): W/v/b are linear
        # in them against Tb-folded generators (see BilinearKmpc)
        c.update({"PGWb": mpc.PGWb, "PAsq": mpc.PAsq, "sqq": mpc.sqq,
                  "PG0": mpc.PG0})
        if mpc._lift_gens is not None:
            # lift-fused variant (see BilinearKmpc lift-gens build): only
            # consumed when the caller passes the matching static
            # ``lift_tables`` (BilinearKmpc.solve does; the lasso sweep
            # does not and keeps the z-consuming route)
            c.update({"LF_" + k: v for k, v in mpc._lift_gens.items()})
    if mpc._sb_lo is not None:
        c["sb_lo"] = mpc._sb_lo
        c["sb_hi"] = mpc._sb_hi
        c["EG"] = mpc.EG
    return c


def bilinear_solve_pure(c: dict, z, u_prev, refhor, U_init, *, Np: int,
                        m: int, n: int, nproj: int, qp_iters: int,
                        iters: int = 1, warm: bool = True,
                        lam_init=None, lift_tables=None):
    """Stateless iter-relinearized bilinear MPC solve
    (``get_mpcInput_bilinear_iter:817-904``); the single implementation
    behind both ``BilinearKmpc.solve`` and the vmapped lasso sweep.

    c: constants pytree from ``bilinear_consts`` (state bounds present iff
    the keys exist); z (NL,) lifted state; u_prev (m,) scaled; refhor scaled
    reference window; U_init previous plan (Np, m) or None; lam_init
    optional multiplier warm start (the previous step's returned ``lam``).
    Returns (U, ok, lam).
    """
    has_sb = "sb_lo" in c
    ref = _pad_ref(refhor, Np, nproj)
    Yr = ref.reshape(-1)

    def block_toeplitz(powers_toep, Beta_j):
        # blocks (i, j) = proj_powers[i-1-j] @ Beta_j[j]; r in {nproj, n}.
        # ``powers_toep`` is the PREgathered, PREmasked constant tensor
        # proj_powers[tidx] * tvalid of shape (Np+1, Np, r, NL), so no
        # per-lane gather runs at solve time.
        # Only the per-stage-Beta (iters>1 relinearization) case lands
        # here; the shared-Beta case uses the fused PG/EG constants.
        r = powers_toep.shape[2]
        g = jnp.einsum("ijrb,jbm->ijrm", powers_toep, Beta_j)
        return g.transpose(0, 2, 1, 3).reshape((Np + 1) * r, Np * m)

    def qp_data(zhor, shared: bool):
        # HIGH (3-pass bf16) instead of the loop-wide HIGHEST (6-pass) for
        # the QP assembly: these GEMMs only build the (already equilibrated-
        # downstream) cost matrices, and 3-pass recovers f32 to ~1e-6 --
        # closed-loop tracking is bitwise-stable at bench tolerances while
        # the batched-small-GEMM assembly cost halves.
        with jax.default_matmul_precision("high"):
            return _qp_data_inner(zhor, shared)

    def _qp_data_inner(zhor, shared: bool):
        if shared:
            # fused path: one lane-shared GEMM (see BilinearKmpc.PG); the
            # staged form below is the same contraction reassociated
            Beta_j = None
            CB = (c["PG"] @ zhor[0]).reshape((Np + 1) * nproj, Np * m)
        else:
            Beta_j = jnp.einsum("kmj,pj->pkm", c["Bm"], zhor)  # (Np, NL, m)
            CB = block_toeplitz(c["PAt"], Beta_j)
        CAz = (c["PA"] @ z).reshape(-1)
        if not has_sb:
            # factored objective: the reduced-QP Hessian/gradient are
            # Pz = 2 (W^T W + diag(Rd[m:])), fz = 2 W^T v with
            # W = sqrt(Q) CB[:, m:] and v = sqrt(Q)(CAz - Yr + CB0 u_prev)
            # (the Rd cross-block is zero, so u0 elimination folds entirely
            # into v).
            sq = jnp.sqrt(c["Qd"])
            W = sq[:, None] * CB[:, m:]
            v = sq * (CAz - Yr + CB[:, :m] @ u_prev)
            return W, v, None, None
        H = CB.T @ (c["Qd"][:, None] * CB) + jnp.diag(c["Rd"])
        f = 2.0 * CB.T @ (c["Qd"] * (CAz - Yr))
        # k = 2..Np blocks only; k=0 is the fixed state and z_1 depends
        # only on the pinned u_0 (see state_constraint_rows)
        if shared:
            EW = (c["EG"] @ zhor[0]).reshape((Np + 1) * n, Np * m)[2 * n:]
        else:
            EW = block_toeplitz(c["EAt"], Beta_j)[2 * n:]
        zn = (c["EA"] @ z).reshape(-1)[2 * n:]
        L = jnp.concatenate([c["Fj"], -EW, EW], axis=0)
        b = jnp.concatenate([
            c["cFj"],
            -jnp.tile(c["sb_lo"], Np - 1) + zn,
            jnp.tile(c["sb_hi"], Np - 1) - zn,
        ])
        return 2.0 * H, f, L, b

    if U_init is None:
        x0 = jnp.tile(u_prev, Np - 1)
    else:
        x0 = jnp.concatenate([U_init[2:], U_init[-1:]], axis=0).reshape(-1)
    blocked = "Tb" in c
    if blocked:
        # free move per group: the group's first stage from the shifted plan
        x0 = c["Sel"] @ x0

    zhor = jnp.tile(z[None, :], (Np, 1))
    U, ok = None, None
    for it in range(iters):
        # first pass linearizes about Beta(z) held constant over the horizon
        # (the reference's choice at Ksim.m:210); later passes re-roll zhor
        if has_sb:
            P, f, L, b = qp_data(zhor, shared=(it == 0))
            Pz = P[m:, m:]
            fz = f[m:] + P[m:, :m] @ u_prev
            Az = L[:, m:]
            bz = b - L[:, :m] @ u_prev
            sol = solve_qp(Pz, fz, Az, bz, iters=qp_iters,
                           x0=x0 if warm else None, shared_A=False, lam0=lam_init)
        elif it == 0 and blocked and lift_tables is not None \
                and "LF_Gz" in c and c["cFjT"].shape[-1] > 0:
            # blocked LIFT-fused first pass: the solve consumes the RAW
            # zeta (``z`` here IS zeta -- the controller advertises
            # wants_zeta and Ksim skips the lift); the PCA projection is
            # folded into the generators
            sol = solve_qp_bilinear_lifted(
                z, u_prev, c["sqq"] * Yr,
                {k: c["LF_" + k] for k in ("Gz", "Gm", "Gb", "Hz", "Hm",
                                           "Hb", "Pz", "Pm", "Pb")},
                c["RdT"], c["FjT"], c["cFjT"], c["F0T"], lift_tables,
                iters=qp_iters, x0=x0 if warm else None, lam0=lam_init)
        elif it == 0 and blocked and "PGWb" in c \
                and c["cFjT"].shape[-1] > 0:
            # blocked shared-Beta first pass, assembly-fused: the reduced
            # W_b/v/b are linear in (z, u_prev) against the Tb-folded
            # generators (see bilinear_consts)
            sol = solve_qp_bilinear(
                z, u_prev, Yr, c["PGWb"], c["PG0"], c["PAsq"], c["sqq"],
                c["RdT"], c["FjT"], c["cFjT"], c["F0T"],
                iters=qp_iters, x0=x0 if warm else None, lam0=lam_init)
        else:
            W, v, _, _ = qp_data(zhor, shared=(it == 0))
            if blocked:
                # reduce to one free move per group: W (p, (Np-1)m) @ Tb and
                # the pre-reduced/deduped constraint stack (move_blocking)
                W = W @ c["Tb"]
                sol = solve_qp_factored(
                    W, v, c["RdT"], c["FjT"],
                    c["cFjT"] - c["F0T"] @ u_prev, iters=qp_iters,
                    x0=x0 if warm else None, lam0=lam_init)
            else:
                Az = c["Fj"][:, m:]
                bz = c["cFj"] - c["Fj"][:, :m] @ u_prev
                sol = solve_qp_factored(
                    W, v, c["Rd"][m:], Az, bz, iters=qp_iters,
                    x0=x0 if warm else None, lam0=lam_init)
        xfull = c["Tb"] @ sol.x if blocked else sol.x
        U, ok = jnp.concatenate([u_prev, xfull]).reshape(Np, m), sol.ok
        lam_init = sol.lam            # later passes re-warm from this pass
        if it + 1 == iters:
            break

        # re-roll the lifted state under the new inputs (``:891-895``)
        def roll(zc, u):
            z1 = c["A"] @ zc + jnp.einsum("kmj,j,m->k", c["Bm"], zc, u)
            return z1, zc

        _, zhor = jax.lax.scan(roll, z, U)
    return U, ok, lam_init


class BilinearKmpc(_KmpcBase):
    """Bilinear-model MPC: B depends on the current lifted state.

    The reference materializes the full stacked input matrix
    (NL(Np+1) x mNp, ``get_costB_bilinear:569-596``) per solve; only its
    projections ever reach the QP, so here the per-solve work is Np small
    matmuls W_k = A^k Beta(z) followed by tiny projected gathers -- the
    largest live intermediate is (Np, NL, m).
    """

    def __init__(self, model: BilinearModel, scaler, cfg: MpcConfig):
        super().__init__(model, scaler, cfg)
        A = np.asarray(model.A)
        NL, Np = self.NL, self.Np
        powers = [np.eye(NL)]
        for _ in range(Np):
            powers.append(powers[-1] @ A)
        self.powers = jnp.asarray(np.stack(powers))              # (Np+1, NL, NL)
        self.Cproj = jnp.asarray(self.projmtx)
        # projected powers: PA[k] = Cproj A^k, EA[k] = (A^k)[:n] -- the only
        # views of A^k the condensed QP ever needs
        self.PA = jnp.asarray(np.stack([self.projmtx @ p for p in powers]))
        self.EA = jnp.asarray(np.stack([p[: self.n] for p in powers]))
        self.Fj = jnp.asarray(self.F)
        self.cFj = jnp.asarray(self.cF)
        self.Qd = jnp.asarray(self.q_diag)
        self.Rd = jnp.asarray(self.r_diag)
        # state bounds in scaled units (structured rows, built on the fly)
        if cfg.state_bounds is not None:
            sb = np.asarray(cfg.state_bounds, float)
            if sb.ndim == 1:
                sb = np.tile(sb, (self.n, 1))
            self._sb_lo = jnp.asarray(np.asarray(scaler.y_down(sb[:, 0])))
            self._sb_hi = jnp.asarray(np.asarray(scaler.y_down(sb[:, 1])))
        else:
            self._sb_lo = None
        # Toeplitz-pregathered powers: [i, j] = proj_powers[i-1-j] for i > j,
        # zero otherwise.  Host-side constants: no per-lane gather or
        # masking at solve time.
        def toep(pp):
            out = np.zeros((Np + 1, Np) + pp.shape[1:], pp.dtype)
            for i in range(Np + 1):
                for j in range(min(i, Np)):
                    out[i, j] = pp[i - 1 - j]
            return jnp.asarray(out)

        self.PAt = toep(np.asarray(self.PA))
        self.EAt = toep(np.asarray(self.EA))
        # fused shared-Beta assembly constant: for the iters=1 path (Beta(z)
        # held constant over the horizon, Ksim.m:210) the two per-lane
        # contractions  Beta = Bm . z  then  CB = PAt . Beta  compose into
        # one lane-shared tensor  PG[(i,r,j,m), q] = sum_b PAt[ijrb] Bm[bmq],
        # so vmapped assembly is a single (B, NL) x (NL, rows) GEMM instead
        # of two batched-small einsums.  f64 precompute, cast to the model
        # dtype.
        Bm64 = np.asarray(model.B, np.float64)
        dt = np.asarray(model.A).dtype

        def fuse(toep_t):
            g = np.einsum("ijrb,bmq->irjmq", np.asarray(toep_t, np.float64),
                          Bm64)
            return jnp.asarray(g.reshape(-1, NL).astype(dt))

        self.PG = fuse(self.PAt)
        self.EG = fuse(self.EAt) if self._sb_lo is not None else None
        # LIFT-FUSED generators: for single-poly + PCA bases the lifted
        # state z = [zeta; pcs^T g(zeta); 1] is linear in
        # [zeta; poly feats; 1], so the PCA projection and constant column
        # fold into the assembly generators host-side (f64) and the solve
        # consumes the RAW zeta (``ops.qp.solve_qp_bilinear_lifted``, and
        # the step kernel's assembly GEMM).  The controller then advertises
        # ``wants_zeta`` and Ksim skips its own lift.
        self._lift_gens = None
        self._lift_tables = None
        # assembly generators: sqrt(Q)-scaled views of the same f64
        # contraction, W rows (p*n) then the CB0 u_prev coupling as p-row
        # blocks, so (W, v, b) are linear in (z, u_prev).
        p_rows = (Np + 1) * self.nproj
        ncols = Np * self.m
        G64 = np.einsum("ijrb,bmq->irjmq",
                        np.asarray(self.PAt, np.float64),
                        Bm64).reshape(p_rows, ncols, NL)
        sq64 = np.sqrt(np.asarray(self.q_diag, np.float64))
        Gs = sq64[:, None, None] * G64
        if self._Tb is not None:
            # move-blocked fused-assembly generator: the reduced
            # W_b = (sq CB[:, m:]) Tb is still linear in z, so Tb folds
            # into the lane-shared constant host-side (f64):
            # PGWb[(r, c), :] = sum_j Gs[r, m+j, :] Tb[j, c]
            self.PGWb = jnp.asarray(
                np.einsum("rjN,jc->rcN", Gs[:, self.m:, :],
                          np.asarray(self._Tb, np.float64))
                .reshape(-1, NL).astype(dt))
        self.PG0 = jnp.asarray(np.concatenate(
            [Gs[:, j, :] for j in range(self.m)], axis=0).astype(dt))
        self.PAsq = jnp.asarray(
            (sq64[:, None]
             * np.asarray(self.PA, np.float64).reshape(p_rows, NL))
            .astype(dt))
        self.sqq = jnp.asarray(sq64.astype(dt))
        basis = model.basis
        if (self._Tb is not None and self._sb_lo is None
                and self.meta.nw == 0 and cfg.bilinear_iters == 1
                and basis is not None and basis.pcs is not None
                and len(basis.families) == 1
                and basis.families[0][0] == "poly"):
            from koopman_realizations.ops.observables import (
                poly_parent_tables,
            )
            nzq = basis.nzeta_aug
            P_T = np.asarray(basis.pcs, np.float64).T   # (npcs, N_full)
            npcs = P_T.shape[0]

            def fold(X):
                Xp = X[:, nzq:nzq + npcs]
                return (X[:, :nzq] + Xp @ P_T[:, :nzq],
                        Xp @ P_T[:, nzq:-1],
                        X[:, -1] + Xp @ P_T[:, -1])

            nred = self._Tb.shape[1]
            Gs_b = np.einsum("rjN,jc->rcN", Gs[:, self.m:, :],
                             np.asarray(self._Tb, np.float64)) \
                .reshape(p_rows * nred, NL)
            H_full = np.concatenate([Gs[:, j, :] for j in range(self.m)],
                                    axis=0)             # (m*p, NL)
            P_full = sq64[:, None] * np.asarray(self.PA, np.float64) \
                .reshape(p_rows, NL)
            gens = {}
            for name, X in (("G", Gs_b), ("H", H_full), ("P", P_full)):
                Xz, Xm, Xb = fold(X)
                gens[name + "z"] = jnp.asarray(Xz.astype(dt))
                gens[name + "m"] = jnp.asarray(Xm.astype(dt))
                gens[name + "b"] = jnp.asarray(Xb.astype(dt))
            self._lift_gens = gens
            _, tables = poly_parent_tables(nzq, basis.families[0][1])
            self._lift_tables = tuple(
                (tuple(int(x) for x in pi), tuple(int(x) for x in di))
                for pi, di in tables)
            self.wants_zeta = True
        self._extend_dual_shift(self.n_con)

    def consts(self) -> dict:
        return bilinear_consts(self)

    @property
    def n_con(self) -> int:
        """Constraint-row count of the reduced QP (for dual-warm carries)."""
        if self._Tb is not None:
            return self.cF_red.size
        mc = self.F.shape[0]
        if self._sb_lo is not None:
            mc += 2 * self.n * (self.Np - 1)
        return mc

    def solve(self, z, u_prev, refhor, U_init=None, iters: int = None,
              lam_init=None):
        """iter-relinearized solve (``get_mpcInput_bilinear_iter:817-904``).

        Ksim uses iters=1 (one QP about Beta(z) held constant over the
        horizon, the reference's choice at ``Ksim.m:210``); for iters>1 the
        lifted trajectory is re-rolled between QPs.  Default comes from
        ``MpcConfig.bilinear_iters``.  Thin wrapper over
        ``bilinear_solve_pure`` (shared with ``workflows.lasso_sweep``).

        Returns (U, ok); with ``lam_init`` (dual warm start from the
        previous receding-horizon step) returns (U, ok, lam).
        """
        iters = self.cfg.bilinear_iters if iters is None else iters
        U, ok, lam = bilinear_solve_pure(
            self.consts(), z, u_prev, refhor, U_init,
            Np=self.Np, m=self.m, n=self.n, nproj=self.nproj,
            qp_iters=self.cfg.qp_iters, iters=iters,
            lam_init=self._shift_lam(lam_init),
            lift_tables=self._lift_tables)
        if lam_init is None:
            return U, ok
        return U, ok, lam


def _composed_maps(model: NonlinearModel):
    """Host-side (A1, A2, a0) of the composed F(x) = A1 x + A2 feats(x) + a0.

    ``NonlinearModel.F`` evaluates W^T [x ; pcs^T g_full(x) ; 1] -- a
    (N_full -> npcs) projection followed by a (N -> nzeta) output map on
    EVERY vector-field/Jacobian evaluation.  Both maps are linear in the
    raw feature vector g_full = [x ; feats(x) ; 1], so they compose
    host-side (float64) into one matrix per term.  Exactness: pure
    reassociation of the same linear algebra (~1e-7 in f32).
    """
    basis = model.basis
    W_T = np.asarray(model.W, np.float64).T             # (nzeta, N)
    nza = basis.nzeta_aug
    if basis.pcs is not None:
        P_T = np.asarray(basis.pcs, np.float64).T       # (npcs, N_full)
        Wp = W_T[:, nza:-1]
        A1 = W_T[:, :nza] + Wp @ P_T[:, :nza]
        A2 = Wp @ P_T[:, nza:-1]
        a0 = W_T[:, -1] + Wp @ P_T[:, -1]
    else:
        A1, A2, a0 = W_T[:, :nza], W_T[:, nza:-1], W_T[:, -1]
    return A1, A2, a0


def _compose_nonlinear_F(model: NonlinearModel):
    """Jittable composed F (see ``_composed_maps``) -- for the bench NMPC
    model (N=175, N_full=220, nzeta=6) a ~30x matmul-FLOP reduction per
    evaluation vs ``model.F``; validated in tests/test_closed_loop.py.
    """
    basis = model.basis
    A1, A2, a0 = _composed_maps(model)
    dt = np.asarray(model.W).dtype
    A1j = jnp.asarray(A1.astype(dt))
    A2j = jnp.asarray(A2.astype(dt))
    a0j = jnp.asarray(a0.astype(dt))
    families = basis.families

    def F_fn(zeta, u):
        x = jnp.concatenate([zeta, u])
        parts = [basis._family_feats(kind, deg, x) for kind, deg in families]
        feats = jnp.concatenate(parts) if parts else jnp.zeros((0,), x.dtype)
        return A1j @ x + A2j @ feats + a0j

    return F_fn


def _poly_jacobian_static(model: NonlinearModel):
    """Static pieces of the analytic poly Jacobian (see
    ``_compose_poly_jacobian``): (A1, G, blocks, tables, pos_x) with
    J(x).flatten() = A1.flatten() + G @ g_low(x), g_low = [x; low-degree
    monomial blocks], rows indexed (o, i) = o*nza + i.  ``pos_x[j]`` is
    the g_low column of coordinate x_j (blocks[0]'s order need not be the
    identity).  None when the dictionary is not a single poly family.
    """
    basis = model.basis
    if basis is None or len(basis.families) != 1 \
            or basis.families[0][0] != "poly":
        return None
    from koopman_realizations.ops.observables import poly_parent_tables
    degree = basis.families[0][1]
    nza = basis.nzeta_aug
    A1, A2, _ = _composed_maps(model)
    if degree == 1:
        return None
    nzo = A1.shape[0]
    blocks, tables = poly_parent_tables(nza, degree)
    pos, off = {}, 0
    for d in range(1, degree):
        for r, e in enumerate(blocks[d - 1]):
            pos[tuple(int(v) for v in e)] = off + r
        off += len(blocks[d - 1])
    G = np.zeros((nzo * nza, off), np.float64)
    fr = 0
    for d in range(2, degree + 1):
        for e in blocks[d - 1]:
            et = tuple(int(v) for v in e)
            for i in range(nza):
                if et[i] == 0:
                    continue
                parent = et[:i] + (et[i] - 1,) + et[i + 1:]
                G[i::nza, pos[parent]] += A2[:, fr] * et[i]
            fr += 1
    pos_x = np.asarray(
        [pos[tuple(1 if k == j else 0 for k in range(nza))]
         for j in range(nza)], np.int64)
    return A1, G, blocks, tables, pos_x


def _compose_poly_jacobian(model: NonlinearModel):
    """Analytic Jacobian of the composed F for ALL-POLY dictionaries.

    The SQP's jacfwd sweeps push 9 tangents through the 219-monomial lift
    per (lane, stage) -- measured 0.95 ms of the 1.82 ms SQP pass at B=2048
    and 16 ms at B=8192 (17x for 4x lanes: the tangent-feature
    intermediates are pure HBM traffic).  But for monomials
    d(x^e)/dx_i = e_i x^(e - delta_i), a monomial of one degree lower, so
    the composed Jacobian is LINEAR in the degree <= (d-1) monomials:

        J(x) = A1 + unflatten(G @ g_low(x), (nzeta, nza))

    with g_low(x) = [x ; poly blocks 2..d-1] (a PREFIX of the lift the
    solve computes anyway) and G the static (nzeta*nza, n_low) generator
    G[(o, i), pos(e - delta_i)] += A2[o, e] * e_i, precomputed host-side in
    f64.  One (B Np, n_low) x (n_low, nzeta*nza) GEMM replaces both
    jacfwd sweeps.  Returns a jittable ``J_fn(zeta, u) -> (nzeta, nza)`` or
    None when the dictionary is not a single poly family (jacfwd fallback).
    """
    basis = model.basis
    if basis is None or len(basis.families) != 1 \
            or basis.families[0][0] != "poly":
        return None
    degree = basis.families[0][1]
    nza = basis.nzeta_aug
    dt = np.asarray(model.W).dtype
    if degree == 1:                          # feats empty: J is constant
        A1, _, _ = _composed_maps(model)
        A1j = jnp.asarray(A1.astype(dt))
        return lambda zeta, u: A1j

    A1, G, blocks, tables, _ = _poly_jacobian_static(model)
    nzo = A1.shape[0]
    A1j = jnp.asarray(A1.astype(dt))
    Gj = jnp.asarray(G.astype(dt))

    def J_fn(zeta, u):
        x = jnp.concatenate([zeta, u])
        low, prev = [x], x
        for parent_idx, dim_idx in tables[: degree - 2]:
            prev = prev[parent_idx] * x[dim_idx]
            low.append(prev)
        g_low = jnp.concatenate(low)
        return A1j + (Gj @ g_low).reshape(nzo, nza)

    return J_fn


class NonlinearKmpc(_KmpcBase):
    """SQP NMPC on the nonlinear realization (or bilinear-as-NMPC).

    The reference hands fmincon a decision [Z; U] with dynamics equalities
    and analytic Jacobians (``nonlcon_nmpc:1074-1111``).  Here each SQP pass
    linearizes F along the current trajectory, condenses Z out, and solves
    the same input-only QP shape as the linear controller -- a Gauss-Newton
    real-time iteration with exact autodiff Jacobians.
    """

    def __init__(self, model, scaler, cfg: MpcConfig, F_fn=None):
        super().__init__(model, scaler, cfg)
        # analytic Jacobian of the composed F (all-poly dictionaries);
        # None -> the jacfwd fallback in _condense_inner
        self.J_fn = None
        if F_fn is not None:
            self.F_fn = F_fn
        elif isinstance(model, NonlinearModel):
            if model.meta.nw > 0:
                # no reference counterpart (fmincon NMPC is unloaded,
                # Kmpc.m:1114-1181), and the fallback F(zeta, u, w=None)
                # would crash in lift_loaded -- reject loudly
                raise NotImplementedError(
                    "NMPC on loaded (nw > 0) models is not supported")
            if model.basis is not None:
                self.F_fn = _compose_nonlinear_F(model)
                self.J_fn = _compose_poly_jacobian(model)
            else:
                self.F_fn = lambda zeta, u: model.F(zeta, u)
        elif isinstance(model, BilinearModel):
            # bilinear-as-NMPC: F = C (A g(zeta) + Beta(g(zeta)) u)  (Kmpc.m:93)
            basis = model.basis

            def F_fn(zeta, u):
                g = basis.lift(zeta)
                return model.C @ model.step(g, u)

            self.F_fn = F_fn
        else:
            raise TypeError("NonlinearKmpc needs a NonlinearModel or BilinearModel")
        self.nz = self.meta.nzeta
        # stage-Jacobian generators: when the analytic poly Jacobian
        # exists, the SQP passes its linearization trajectory (Zl, Ul, Fv)
        # and the Jacobians/defects generate inside the solve
        # (ops.qp.solve_qp_nmpc_stages)
        self._stage_ops = None
        self._jlayout = None
        self._roll_ops = None
        self._flayout = None
        if self.J_fn is not None and isinstance(model, NonlinearModel) \
                and model.basis is not None:
            st = _poly_jacobian_static(model)
            if st is not None:
                from koopman_realizations.ops.qp import (
                    build_stage_jac_ops,
                    build_stage_roll_ops,
                )
                A1s, Gs, _blocks, tabs, pos_x = st
                degree = model.basis.families[0][1]
                self._stage_ops, self._jlayout = build_stage_jac_ops(
                    A1s, Gs, tabs, pos_x, self.nz,
                    model.basis.nzeta_aug, degree)
                # ROLLOUT generators (the composed dynamics as one-hot-lift
                # GEMMs): lets the stage solve also generate its
                # linearization trajectory from the plan
                A1f, A2f, a0f = _composed_maps(model)
                self._roll_ops, self._flayout = build_stage_roll_ops(
                    A1f, A2f, a0f, tabs, self.nz, model.basis.nzeta_aug)
        # whether downstream needs the FULL (nz-row) sensitivity stack (only
        # the infeasible-path 'linear' between-pass update does; see
        # _condense_inner's projected scan outputs)
        self._full_S = cfg.sqp_update == "linear"
        # static placement matrices for the condensation scan: Emb[k] puts an
        # (nz, m) block at columns [k m, (k+1) m).  B_k @ Emb[k] replaces a
        # dynamic_update_slice inside the vmapped scan.
        # decision columns of the condensation: [u_0 block | free moves].
        # Under move blocking (MpcConfig.input_blocks) the sensitivity
        # recursion itself runs against the REDUCED columns (stage k's
        # placement hits its group's move) -- the condense carry, the
        # stacked Sy, and the inner QP all shrink with nf.
        if self._Tb is not None:
            group_of = np.repeat(np.arange(len(cfg.input_blocks)),
                                 cfg.input_blocks)      # stage-1..Np-1 -> g
            self._nU = self.m + self._Tb.shape[1]
        else:
            group_of = None
            self._nU = self.Np * self.m
        Emb = np.zeros((self.Np, self.m, self._nU), np.float32)
        cols = []
        for k in range(self.Np):
            if k == 0 or group_of is None:
                c0 = k * self.m
            else:
                c0 = self.m + int(group_of[k - 1]) * self.m
            Emb[k, :, c0:c0 + self.m] = np.eye(self.m)
            cols.append(c0)
        self._Emb = jnp.asarray(Emb)
        # static per-stage decision-column table for the condensation in
        # ops.qp.solve_qp_nmpc
        self._cols = tuple(cols)
        # projection acts on the first n state dims (Kmpc.m:924)
        self.Cz = jnp.asarray(self.projmtx[:, : self.n])
        E, cE = state_constraint_rows(cfg, self.n, self.n, self.Np, scaler)
        self.E = jnp.asarray(E)       # rows over stacked zeta[:n]
        self.cE = jnp.asarray(cE)
        if self._Tb is not None:
            self.Fj = None            # blocked: pre-reduced stack below
            self._Azj = jnp.asarray(self.F_red, jnp.float32)
            self._F0j = jnp.asarray(self.F0_red, jnp.float32)
            self._cFzj = jnp.asarray(self.cF_red, jnp.float32)
            self._Tbj = jnp.asarray(self._Tb, jnp.float32)
            self._Selj = jnp.asarray(self._Sel, jnp.float32)
            self._RdTj = jnp.asarray(self._Tb.T @ self.r_diag[self.m:],
                                     jnp.float32)
            # Levenberg rho||U - Ul||^2 in the reduced var: Tb^T Tb is
            # diag(group sizes) (disjoint groups)
            self._bsizes = jnp.asarray((self._Tb * self._Tb).sum(axis=0),
                                       jnp.float32)
        else:
            self.Fj = jnp.asarray(self.F)
        self.cFj = jnp.asarray(self.cF)
        self.Qd = jnp.asarray(self.q_diag)
        self.Rd = jnp.asarray(self.r_diag)

    def _condense(self, Zl, Ul, zeta0, frozen=None, return_jacs=False,
                  Fv=None):
        """Linearize dynamics along (Zl, Ul) and condense to U-only form.

        Returns (Sz [stacked zeta wrt U], s0 [affine part]) with
        Z = s0 + Sz @ vec(U).  Runs at HIGH (3-pass bf16) matmul precision:
        it only builds the SQP linearization (~1e-6 of f32), and the
        closed-loop step otherwise pins HIGHEST, which doubles the cost of
        every small matmul in the Jacobian/propagation chain.

        With ``frozen = (jac_z, jac_u, Sz)`` from an earlier refresh pass,
        the Jacobians (and hence the sensitivity stack Sz) are reused and
        only the affine defect term is re-propagated along the NEW (Zl, Ul)
        -- the chord Gauss-Newton used for stale ``sqp_jac_period`` passes.
        With ``return_jacs`` the (jac_z, jac_u) pair is appended to the
        return for caching.

        ``Fv`` (optional, (Np, nz)) are precomputed dynamics values
        F(Zl_k, Ul_k): whenever Zl is the true rollout of Ul (the default
        between-pass update), the rollout's next-states ARE those values,
        so the per-stage F re-evaluation here is pure waste -- pass
        ``Fv=Z[1:]`` from ``_rollout_full`` to skip it.
        """
        with jax.default_matmul_precision("high"):
            if frozen is not None:
                return self._condense_stale(Zl, Ul, zeta0, frozen, Fv=Fv)
            Sz, sz, jacs = self._condense_inner(Zl, Ul, zeta0, Fv=Fv)
            if return_jacs:
                return Sz, sz, jacs
            return Sz, sz

    def _condense_inner(self, Zl, Ul, zeta0, Fv=None):
        Np, nz, m = self.Np, self.nz, self.m
        if self.J_fn is not None:
            # analytic GEMM Jacobian (see _compose_poly_jacobian) instead
            # of the jacfwd tangent sweeps below
            J = jax.vmap(self.J_fn)(Zl, Ul)                  # (Np, nz, nz+m)
            jac_z, jac_u = J[..., :nz], J[..., nz:]
        else:
            jac_z = jax.vmap(jax.jacfwd(self.F_fn, argnums=0))(Zl, Ul)
            jac_u = jax.vmap(jax.jacfwd(self.F_fn, argnums=1))(Zl, Ul)
        if Fv is None:
            Fv = jax.vmap(self.F_fn)(Zl, Ul)                          # (Np,nz)
        cv = Fv - jnp.einsum("kij,kj->ki", jac_z, Zl) \
                - jnp.einsum("kij,kj->ki", jac_u, Ul)

        # every downstream consumer (Sy projection, state-bound rows) reads
        # only the first n rows of each stage's sensitivity -- EXCEPT the
        # infeasible-path 'linear' between-pass update, which moves the full
        # lifted state along Sz.  Emitting only those rows shrinks the
        # stacked scan output (B, Np+1, nz, Np m) -> (B, Np+1, n, Np m)
        # (29x less HBM for the N=175 model); the (nz, Np m) carry itself
        # never round-trips under unroll=Np.
        keep = nz if self._full_S else self.n

        def fwd(carry, inp):
            Sk, sk = carry                     # zeta_k = sk + Sk @ vec(U)
            Ak, Bk, ck, Ek = inp
            S1 = Ak @ Sk + Bk @ Ek             # static one-hot placement
            s1 = Ak @ sk + ck
            return (S1, s1), (S1[:keep], s1)

        S0 = jnp.zeros((nz, self._nU), Zl.dtype)
        s0 = zeta0
        (_, _), (Ss, ss) = jax.lax.scan(
            fwd, (S0, s0), (jac_z, jac_u, cv, self._Emb), unroll=Np)
        Sz = jnp.concatenate([S0[None, :keep], Ss], axis=0)  # (Np+1,keep,Npm)
        sz = jnp.concatenate([s0[None], ss], axis=0)      # (Np+1, nz)
        return Sz, sz, (jac_z, jac_u)

    def _stage_lin(self, Zl, Ul, frozen=None, Fv=None):
        """Per-stage linearization WITHOUT the sensitivity scan: returns
        (jac_z, jac_u, cv) for ``ops.qp.solve_qp_nmpc``, which runs the
        S-recursion itself.  With
        ``frozen = (jac_z, jac_u)`` the Jacobians are reused (chord
        passes); cv is always fresh at the new linearization point."""
        with jax.default_matmul_precision("high"):
            nz = self.nz
            if frozen is None:
                if self.J_fn is not None:
                    J = jax.vmap(self.J_fn)(Zl, Ul)      # (Np, nz, nz+m)
                    jac_z, jac_u = J[..., :nz], J[..., nz:]
                else:
                    jac_z = jax.vmap(jax.jacfwd(self.F_fn, argnums=0))(Zl, Ul)
                    jac_u = jax.vmap(jax.jacfwd(self.F_fn, argnums=1))(Zl, Ul)
            else:
                jac_z, jac_u = frozen
            if Fv is None:
                Fv = jax.vmap(self.F_fn)(Zl, Ul)
            cv = Fv - jnp.einsum("kij,kj->ki", jac_z, Zl) \
                    - jnp.einsum("kij,kj->ki", jac_u, Ul)
            return jac_z, jac_u, cv

    def _condense_stale(self, Zl, Ul, zeta0, frozen, Fv=None):
        """Affine-only re-condensation about frozen Jacobians.

        The first-order model is F(z, u) ~= F(Zl_k, Ul_k)
        + A_k (z - Zl_k) + B_k (u - Ul_k) with A/B from the refresh pass:
        the defect Fv is exact at the new linearization point, only the
        sensitivities are stale.  Skips both jacfwd sweeps and the full
        (nz, Np m) S-scan -- just one F eval per stage plus an (nz,)-vector
        recursion (and with ``Fv`` from the rollout, no F eval at all).
        """
        jac_z, jac_u, Sz = frozen
        if Fv is None:
            Fv = jax.vmap(self.F_fn)(Zl, Ul)                          # (Np,nz)
        cv = Fv - jnp.einsum("kij,kj->ki", jac_z, Zl) \
                - jnp.einsum("kij,kj->ki", jac_u, Ul)

        def fwd(sk, inp):
            Ak, ck = inp
            s1 = Ak @ sk + ck
            return s1, s1

        _, ss = jax.lax.scan(fwd, zeta0, (jac_z, cv), unroll=self.Np)
        sz = jnp.concatenate([zeta0[None], ss], axis=0)   # (Np+1, nz)
        return Sz, sz

    def solve(self, zeta, u_prev, refhor, U_init=None):
        """SQP solve (semantics of ``get_mpcInput_nonlinear:1114-1181``).

        Default initialization is COLD (hold the current state/input,
        matching fmincon's X0 at ``Kmpc.m:1158``): warm-starting from the
        shifted previous plan re-anchors the nonconvex SQP in whatever local
        basin the last step found, measurably worsening blockM transients
        (0.033 vs 0.028 mean error with Levenberg damping).  With
        ``sqp_multistart`` both inits run and the better true-rollout merit
        wins -- the per-step hedge against bad basins.
        """
        ref = _pad_ref(refhor, self.Np, self.nproj)
        if self.cfg.sqp_multistart and U_init is not None:
            U1, ok1 = self._solve_from(
                zeta, u_prev, ref, jnp.tile(u_prev[None, :], (self.Np, 1)))
            shifted = jnp.concatenate([U_init[1:], U_init[-1:]], axis=0)
            # warm linearization trajectory: the rollout of the shifted plan
            Zw = self._rollout_full(zeta, shifted)
            U2, ok2 = self._solve_from(zeta, u_prev, ref, shifted,
                                       Zl=Zw[:-1], Fv=Zw[1:])
            c1 = jnp.where(ok1, self._roll_cost(zeta, U1, ref), jnp.inf)
            c2 = jnp.where(ok2, self._roll_cost(zeta, U2, ref), jnp.inf)
            take2 = c2 < c1
            return jnp.where(take2, U2, U1), ok1 | ok2
        return self._solve_from(zeta, u_prev, ref,
                                jnp.tile(u_prev[None, :], (self.Np, 1)))

    def _solve_from(self, zeta, u_prev, ref, Ul, Zl=None, Fv=None):
        Np, m, n = self.Np, self.m, self.n
        fused0 = self.E.shape[0] == 0 and self.cfg.sqp_update != "linear"
        # rolled stage solve (roll_mode 'roll'/'hold'): the solve generates
        # the linearization trajectory itself from the plan, so no rollout
        # runs between passes.  best-of-passes / line search still need the
        # rollout for the merit and keep the explicit path.
        roll_fused = (fused0 and self._stage_ops is not None
                      and self._roll_ops is not None
                      and max(1, int(self.cfg.sqp_jac_period)) == 1
                      and not self.cfg.sqp_best_of_passes
                      and self.cfg.sqp_linesearch == 0)
        # whole-SQP path: all passes in one jitted solve
        # (ops.qp.solve_qp_nmpc_multipass).  The inter-pass glue is a
        # function of the previous pass's solution (Sel @ Tb = I, diagonal
        # Levenberg, row-sliced rollout inputs), so it applies exactly in
        # the default regime: cold per-pass duals, constant damping.
        if (roll_fused and Zl is None and not self.cfg.sqp_dual_warm
                and self.cfg.sqp_damping_decay == 1.0):
            sq = jnp.sqrt(self.Qd)
            rho = self.cfg.sqp_damping
            if self._Tb is not None:
                rdiag = self._RdTj + rho * self._bsizes
                Az_, cF_, F0_ = self._Azj, self._cFzj, self._F0j
                q0c = -2.0 * rho * np.asarray(self._bsizes)
            else:
                nred = (Np - 1) * m
                rdiag = self.Rd[m:] + rho
                Az_, cF_, F0_ = self.Fj[:, m:], self.cFj, self.Fj[:, :m]
                q0c = np.full(nred, -2.0 * rho, np.float32)
            nred = q0c.shape[0]
            Gup = np.tile(np.eye(m, dtype=np.float32), (nred // m, 1))
            from koopman_realizations.ops.qp import (
                solve_qp_nmpc_multipass,
            )
            sol = solve_qp_nmpc_multipass(
                zeta, u_prev, sq, sq * ref.reshape(-1), self.Cz, rdiag,
                Az_, cF_, F0_, self._cols, self._stage_ops, self._jlayout,
                self._roll_ops, self._flayout, Gup, q0c,
                n_passes=self.cfg.sqp_iters,
                hold0=self.cfg.sqp_init != "rollout",
                iters=self.cfg.qp_iters)
            xfull = self._Tbj @ sol.x if self._Tb is not None else sol.x
            return self._assemble_U(u_prev, xfull), sol.ok
        mode0 = "ship"
        if Zl is None:
            if roll_fused:
                mode0 = "roll" if self.cfg.sqp_init == "rollout" else "hold"
            elif self.cfg.sqp_init == "rollout":
                # linearize the first pass along the natural prediction
                # (roll the held input through F) -- mid-transient the
                # constant-state guess is a poor linearization point
                Z = self._rollout_full(zeta, Ul)
                Zl, Fv = Z[:-1], Z[1:]
            else:
                Zl = jnp.tile(zeta[None, :], (Np, 1))
        U, ok = None, None
        best_U, best_cost, best_ok = None, None, None
        lam_carry = None          # dual warm start across SQP passes: the
        # relinearized QP's active set is near the previous pass's, so its
        # (sqrt-damped, see ops.qp) multipliers are a better start than the
        # cold lam = 1 -- same pattern as the bilinear iters>1 loop
        jac_period = max(1, int(self.cfg.sqp_jac_period))
        frozen = None
        # condensation inside the solve (ops.qp.solve_qp_nmpc): the
        # sensitivity recursion + W/v assembly run per lane from the
        # per-stage Jacobians/defects, without the stacked (Np+1, n, nU)
        # sensitivity output of _condense.  Needs the factored
        # (no state bounds) shape; the 'linear' between-pass update needs
        # the explicit Sz.
        fused = fused0
        # stage variant: Jacobians/defects generate from (Zl, Ul, Fv);
        # chord passes (jac_period > 1) need the frozen jz/ju and keep the
        # explicit path
        stages = fused and self._stage_ops is not None \
            and jac_period == 1
        roll_mode = "ship"
        for it in range(self.cfg.sqp_iters):
            if stages:
                if roll_fused:
                    roll_mode = mode0 if it == 0 else "roll"
                elif Fv is None:
                    # cold 'hold' init: Zl/Ul rows are all the current
                    # point, so every stage's dynamics value is the same
                    # single evaluation
                    Fv = jnp.tile(self.F_fn(Zl[0], Ul[0])[None, :],
                                  (Np, 1))
                jz = ju = cvv = None
                Sy = sy = None
            elif fused:
                if it % jac_period == 0:
                    jz, ju, cvv = self._stage_lin(Zl, Ul, Fv=Fv)
                    frozen = (jz, ju)
                else:
                    jz, ju, cvv = self._stage_lin(Zl, Ul, frozen=frozen,
                                                  Fv=Fv)
                Sy = sy = None
            else:
                if it % jac_period == 0:
                    Sz, sz, jacs = self._condense(Zl, Ul, zeta,
                                                  return_jacs=True, Fv=Fv)
                    frozen = (jacs[0], jacs[1], Sz)
                else:
                    Sz, sz = self._condense(Zl, Ul, zeta, frozen=frozen,
                                            Fv=Fv)
                # predicted tracked outputs: y_k = Cz zeta_k[:n]
                Sy = jnp.einsum("pi,kij->kpj", self.Cz, Sz[:, : n, :]) \
                    .reshape((Np + 1) * self.nproj, self._nU)
                sy = (sz[:, : n] @ self.Cz.T).reshape(-1)
            # Levenberg damping rho ||U - U_lin||^2: the undamped Gauss-Newton
            # step can converge to an input-saturated local optimum during
            # transients (fmincon's line search avoids it); rho trades the
            # transient peak against steady-state tracking
            rho = self.cfg.sqp_damping * (self.cfg.sqp_damping_decay ** it)
            if self.E.shape[0]:
                # state bounds act on stacked zeta[:n]
                H = (Sy.T @ (self.Qd[:, None] * Sy) + jnp.diag(self.Rd)
                     + rho * jnp.eye(Np * m, dtype=Sy.dtype))
                f = (2.0 * Sy.T @ (self.Qd * (sy - ref.reshape(-1)))
                     - 2.0 * rho * Ul.reshape(-1))
                Zn = Sz[:, : n, :].reshape((Np + 1) * n, Np * m)
                zn = sz[:, : n].reshape(-1)
                L = jnp.concatenate([self.Fj, self.E @ Zn], axis=0)
                b = jnp.concatenate(
                    [self.cFj, self.cE - self.E @ zn])
                Pz, fz, Az, bz = self._eliminate_u0(2.0 * H, f, L, b, u_prev)
                sol = solve_qp(Pz, fz, Az, bz, iters=self.cfg.qp_iters,
                               x0=Ul[1:].reshape(-1), shared_A=False, lam0=lam_carry)
            elif fused:
                sq = jnp.sqrt(self.Qd)
                sqRef = sq * ref.reshape(-1)
                if self._Tb is not None:
                    rdiag = self._RdTj + rho * self._bsizes
                    Az_, cF_, F0_ = self._Azj, self._cFzj, self._F0j
                    x0_ = self._Selj @ Ul[1:].reshape(-1)
                    q0_ = None if rho == 0.0 \
                        else -2.0 * rho * (self._Tbj.T
                                           @ Ul[1:].reshape(-1))
                else:
                    rdiag = self.Rd[m:] + rho
                    Az_, cF_, F0_ = self.Fj[:, m:], self.cFj, \
                        self.Fj[:, :m]
                    x0_ = Ul[1:].reshape(-1)
                    q0_ = None if rho == 0.0 \
                        else -2.0 * rho * Ul.reshape(-1)[m:]
                if stages:
                    sol = solve_qp_nmpc_stages(
                        Zl, Ul, Fv, zeta, u_prev, sq, sqRef, self.Cz,
                        rdiag, Az_, cF_, F0_, self._cols,
                        self._stage_ops, self._jlayout,
                        iters=self.cfg.qp_iters, x0=x0_, q0=q0_,
                        lam0=lam_carry, roll_mode=roll_mode,
                        roll_ops=self._roll_ops or (),
                        flayout=self._flayout or ())
                else:
                    sol = solve_qp_nmpc(
                        jz, ju, cvv, zeta, u_prev, sq, sqRef, self.Cz,
                        rdiag, Az_, cF_, F0_, self._cols,
                        iters=self.cfg.qp_iters, x0=x0_, q0=q0_,
                        lam0=lam_carry)
            else:
                # factored form: the reduced Hessian is
                # 2 (W^T W + diag(Rd[m:] + rho)) with W = sqrt(Q) Sy_z; the
                # Levenberg term rho||U - U_lin||^2 folds into the QP's
                # DIAGONAL + linear q0 = -2 rho U_lin instead of
                # materializing sqrt(rho) I least-squares rows (n fewer
                # Gram rank-1 ops), and the u0 elimination folds into v
                # (Rd/rho diagonal, so no cross-block survives).
                sq = jnp.sqrt(self.Qd)
                Wls = sq[:, None] * Sy[:, m:]
                vls = sq * (sy - ref.reshape(-1) + Sy[:, :m] @ u_prev)
                if self._Tb is not None:
                    # move-blocked reduced var V (U[1:] = Tb V): the
                    # condensation already produced Sy against V, so only
                    # the constraint stack, the R/Levenberg diagonal
                    # (Tb^T (.) Tb = group-summed diag), and the warm
                    # starts change basis
                    sol = solve_qp_factored(
                        Wls, vls, self._RdTj + rho * self._bsizes,
                        self._Azj, self._cFzj - self._F0j @ u_prev,
                        iters=self.cfg.qp_iters,
                        x0=self._Selj @ Ul[1:].reshape(-1),
                        lam0=lam_carry,
                        q0=None if rho == 0.0
                        else -2.0 * rho * (self._Tbj.T
                                           @ Ul[1:].reshape(-1)))
                else:
                    Az = self.Fj[:, m:]
                    bz = self.cFj - self.Fj[:, :m] @ u_prev
                    sol = solve_qp_factored(
                        Wls, vls, self.Rd[m:] + rho, Az, bz,
                        iters=self.cfg.qp_iters, x0=Ul[1:].reshape(-1),
                        lam0=lam_carry,
                        q0=None if rho == 0.0
                        else -2.0 * rho * Ul.reshape(-1)[m:])
            xfull = self._Tbj @ sol.x if self._Tb is not None else sol.x
            U_qp, ok = self._assemble_U(u_prev, xfull), sol.ok
            if self.cfg.sqp_dual_warm:
                lam_carry = sol.lam
            last = it == self.cfg.sqp_iters - 1
            Zroll, cost = None, None
            if self.cfg.sqp_linesearch > 0:
                U, Zroll, cost = self._line_search(zeta, Ul, U_qp, ref)
            else:
                U = U_qp
                # one exact rollout serves both the merit bookkeeping and
                # the next pass's linearization trajectory + defect values;
                # skipped entirely on the last pass when nothing consumes
                # it -- and ALWAYS under roll_fused (the solve rolls)
                if self.cfg.sqp_best_of_passes or (
                        not last and self.cfg.sqp_update != "linear"
                        and not roll_fused):
                    Zroll = self._rollout_full(zeta, U)
            if self.cfg.sqp_best_of_passes:
                # keep the best iterate by TRUE rollout merit across passes:
                # the fixed-iteration Gauss-Newton can oscillate around (or
                # through) a good plan mid-transient; returning its best
                # visited point is the adaptive form of early stopping
                if cost is None:
                    cost = self._cost_from_Z(Zroll, U, ref)
                cost = jnp.where(ok, cost, jnp.inf)
                if best_U is None:
                    best_U, best_cost, best_ok = U, cost, ok
                else:
                    take = cost < best_cost
                    best_U = jnp.where(take, U, best_U)
                    best_cost = jnp.minimum(cost, best_cost)
                    best_ok = jnp.where(take, ok, best_ok)
            if not last:
                if self.cfg.sqp_update == "linear":
                    # infeasible-path update: move Z along the LINEARIZED
                    # dynamics (defects stay open between passes, like
                    # fmincon's sqp iterates on [Z; U]) instead of re-rolling
                    # the nonlinear model through the new inputs.  Zl keeps
                    # the [z_0 .. z_{Np-1}] convention of every other path
                    # (Zl[0] = zeta exactly), so drop the TERMINAL stage of
                    # the (Np+1)-stacked prediction, not the initial one
                    if self._Tb is not None:
                        Uvec = jnp.concatenate(
                            [U[0], self._Selj @ U[1:].reshape(-1)])
                    else:
                        Uvec = U.reshape(-1)
                    Zl, Fv = (sz + Sz @ Uvec)[:-1], None
                elif roll_fused:
                    # the solve rolls the next pass's trajectory from
                    # (zeta, U) itself -- nothing to carry in XLA
                    Zl, Fv = None, None
                else:
                    # feasible-path update: the rollout above, which also
                    # carries F(Zl, Ul) = Zroll[1:] into the condensation
                    Zl, Fv = Zroll[:-1], Zroll[1:]
            Ul = U
        if self.cfg.sqp_best_of_passes:
            return best_U, best_ok
        return U, ok

    def _rollout_full(self, zeta, U):
        """Exact nonlinear rollout of an input plan: Z = [z_0 .. z_Np].

        Z[:-1] is the linearization trajectory for the next SQP pass and
        Z[1:] == F(Z[:-1], U) row-for-row -- the ``Fv`` defect values the
        condensation needs, for free.
        """
        def roll(zc, u):
            z1 = self.F_fn(zc, u)
            return z1, zc
        # unroll: Np sequential F evals per pass; the rolled scan's carry
        # round trips are pure overhead at these tiny shapes
        zf, Zpre = jax.lax.scan(roll, zeta, U,
                                unroll=self.Np)   # Zpre = [z_0 .. z_{Np-1}]
        return jnp.concatenate([Zpre, zf[None]], axis=0)      # (Np+1, nz)

    def _cost_from_Z(self, Z, U, ref):
        """Merit of a plan given its exact rollout (see ``_roll_cost``)."""
        yflat = (Z[:, : self.n] @ self.Cz.T).reshape(-1)
        track = self.Qd @ (yflat - ref.reshape(-1)) ** 2
        return track + self.Rd @ (U.reshape(-1) ** 2)

    def _roll_cost(self, zeta, U, ref):
        """True (non-linearized) merit: rollout cost of an input plan.

        Same objective the QP minimizes on the linearization -- Q-weighted
        tracking over the horizon + R-weighted input -- but evaluated on the
        exact nonlinear rollout (fmincon's sqp evaluates its merit function
        the same way, ``Kmpc.m:1167-1174``).
        """
        return self._cost_from_Z(self._rollout_full(zeta, U), U, ref)

    def _line_search(self, zeta, U_old, U_qp, ref):
        """Backtracking merit line search between the previous plan and the
        QP step (``sqp_linesearch`` halvings; 0 = always take the full step).

        Both endpoints satisfy the convex input constraints, so every convex
        combination does too.  All candidates evaluate in one vmap.  Returns
        (U, Z, cost) with Z/cost the winner's exact rollout and merit --
        shared with the between-pass update instead of re-rolling.
        """
        ls = self.cfg.sqp_linesearch
        alphas = jnp.asarray([1.0] + [0.5 ** i for i in range(1, ls + 1)],
                             U_qp.dtype)
        cands = U_old[None] + alphas[:, None, None] * (U_qp - U_old)[None]
        Zs = jax.vmap(lambda Uc: self._rollout_full(zeta, Uc))(cands)
        costs = jax.vmap(self._cost_from_Z, in_axes=(0, 0, None))(
            Zs, cands, ref)
        i = jnp.argmin(costs)
        return cands[i], Zs[i], costs[i]


def make_kmpc(model, scaler, cfg: MpcConfig):
    """Controller factory following the reference's dispatch (``Kmpc.m:85-103``)."""
    mt = model.meta.model_type
    mpc_type = cfg.mpc_type or ("nonlinear" if mt == "nonlinear" else "linear")
    if mt == "linear" and mpc_type == "linear":
        return LinearKmpc(model, scaler, cfg)
    if mt == "bilinear" and mpc_type == "linear":
        return BilinearKmpc(model, scaler, cfg)
    if mt == "bilinear" and mpc_type == "nonlinear":
        return NonlinearKmpc(model, scaler, cfg)
    if mt == "nonlinear":
        return NonlinearKmpc(model, scaler, cfg)
    raise ValueError(f"{mt} model is incompatible with mpc_type {mpc_type}")
