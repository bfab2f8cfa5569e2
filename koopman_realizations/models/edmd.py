"""EDMD / Koopman-realization training (reference class ``Ksysid``).

Pipeline mirrors the reference constructor (``Ksysid.m:37-144``):
infer dims -> build observable dictionary -> merge trials -> fit [-1,1]
scaling -> extract snapshot pairs -> (optional) PCA dimension reduction ->
regress the Koopman operator per lasso value -> extract A/B/C (or bilinear /
nonlinear) models -> validate with scan rollouts.

Differences by design (batched, accelerator-first):
- snapshot lifting is a single vmapped jit instead of a Python loop
  (hot loop at ``Ksysid.m:1030-1065``),
- least squares runs as QR / Gram-Cholesky (``ops.lstsq``), optionally
  psum-accumulated across a device mesh (see ``parallel.edmd_sharded``),
- the LASSO QP is solved as projected FISTA on the matrix variable
  (``ops.lasso``) instead of a 2(N+m)^2-variable quadprog,
- subsampling uses a seeded numpy Generator (the reference's
  ``RandStream('mlfg6331_64')`` stream cannot be bit-matched).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from koopman_realizations.config import SysidConfig
from koopman_realizations.models.koopman import (
    BilinearModel,
    LinearModel,
    ModelMeta,
    NonlinearModel,
    rollout,
)
from koopman_realizations.ops import lstsq as lstsq_ops
from koopman_realizations.ops.lasso import lasso_constrained_lstsq_f64
from koopman_realizations.ops.linalg import logm_host, pcs_for_explained
from koopman_realizations.ops.observables import KoopmanBasis, build_basis, delay_embed
from koopman_realizations.ops.scaling import Scaler, fit_scaler
from koopman_realizations.types import DataSet, SnapshotPairs, Trial, merge_trials
from koopman_realizations.utils.metrics import get_error


class Ksysid:
    """Koopman system identification from trial data.

    Host-orchestrated trainer: stage boundaries run Python, stage interiors
    are jitted/batched JAX.  All trained models are pytrees ready for the
    controller stack.
    """

    def __init__(self, data: DataSet, cfg: SysidConfig):
        self.cfg = cfg
        first = data.train[0]
        self.n = first.n
        self.m = first.m
        self.Ts = first.Ts
        self.nd = cfg.delays
        self.nzeta = self.n * (self.nd + 1) + self.m * self.nd
        self.isfake = data.isfake
        self.sys_params = data.params

        if cfg.loaded and first.w is None:
            raise ValueError("loaded=True but training data has no load field (w)")
        self.nw = first.w.shape[1] if (cfg.loaded and first.w is not None) else 0

        self.dtype = jnp.dtype(cfg.dtype)
        if self.dtype == jnp.float64 and not jax.config.jax_enable_x64:
            self.dtype = jnp.dtype(jnp.float32)

        # observable dictionary (pre-PCA)
        self.basis: KoopmanBasis = build_basis(cfg, self.n, self.m, nw=self.nw)

        # merge + scale (Ksysid.m:119-131)
        merged = merge_trials(data.train)
        self.scaler: Scaler = fit_scaler(merged)
        self.traindata = self.scaler.trial_down(merged)
        self.valdata = [self.scaler.trial_down(tr) for tr in data.val]

        # snapshot pairs (Ksysid.m:134); datafiles may carry pre-extracted
        # pairs (Ksysid.m:931-938)
        if data.snapshots is not None:
            sp = data.snapshots
            self.snapshot_pairs = SnapshotPairs(
                alpha=np.asarray(sp["alpha"]), beta=np.asarray(sp["beta"]),
                u=np.asarray(sp["u"]), w=np.asarray(sp["w"]) if "w" in sp else None)
        else:
            self.snapshot_pairs = self.get_snapshot_pairs(self.traindata,
                                                          cfg.snapshots)

        # PCA dimension reduction (Ksysid.m:137-142)
        if cfg.dim_red:
            Px_full = self._lift_rows(self.basis.lift_full, self._dimred_inputs())
            pcs = pcs_for_explained(np.asarray(Px_full), self.cfg.pca_explained)
            self.basis = self.basis.with_pcs(pcs)

        self.N = self.basis.N
        self.candidates: List = []
        self.model = None

    # ------------------------------------------------------------------ data

    def get_snapshot_pairs(self, data: Trial, num: float) -> SnapshotPairs:
        """Snapshot pairs from merged time series (``Ksysid.m:910-984``).

        Pairs straddling trial boundaries are dropped by requiring
        before.t < after.t; the reference then samples ``num_max =
        P-1`` pairs without replacement (so with snapshots=Inf the last pair
        is always excluded -- reproduced here for parity).
        """
        zeta, uzeta = delay_embed(data.y, data.u, self.nd)
        t = np.asarray(data.t)
        before_t = t[self.nd: -1]
        after_t = t[self.nd + 1:]
        good = before_t < after_t

        alpha = zeta[:-1][good]
        beta = zeta[1:][good]
        u = uzeta[:-1][good]
        w = None
        if self.nw > 0:
            wz = np.asarray(data.w)[self.nd:]
            w = wz[:-1][good]

        num_max = alpha.shape[0] - 1
        k = num_max if not math.isfinite(num) else min(int(num), num_max)
        if k < num_max:
            rng = np.random.default_rng(self.cfg.seed)
            idx = rng.choice(num_max, size=k, replace=False)
        else:
            idx = np.arange(num_max)
        return SnapshotPairs(
            alpha=alpha[idx], beta=beta[idx], u=u[idx],
            w=None if w is None else w[idx],
        )

    def _dimred_inputs(self) -> np.ndarray:
        """Rows fed to the full lift for PCA (``Ksysid.lift_snapshots``)."""
        sp = self.snapshot_pairs
        if self.cfg.model_type == "nonlinear":
            return np.concatenate([sp.alpha, sp.u], axis=1)
        return np.asarray(sp.alpha)

    def _lift_rows(self, fn, rows: np.ndarray) -> jnp.ndarray:
        """Batched lift of snapshot rows, pinned to the HOST CPU.

        Training must be platform-independent: accelerator-evaluated f32
        lifts differ from CPU f32 in the last bits, and the PCA's
        smallest retained components (pca_explained=99.99 keeps a long
        tail) amplify those bits into visibly different models -- the
        hypersensitive NMPC transient measured 0.0207 vs 0.0142 mean
        blockM error from an accelerator-trained vs CPU-trained model.  The lift
        is a one-time training cost; the closed loop never calls this.
        """
        rows = np.asarray(rows, self.dtype)
        with jax.default_device(jax.devices("cpu")[0]):
            return jax.jit(jax.vmap(fn))(jnp.asarray(rows))

    # ------------------------------------------------------ operator fitting

    def lift_snapshot_matrices(self):
        """Build (Px, Py) regression matrices (``Ksysid.m:1013-1065``).

        Row layouts by model type:
        - linear:    [psi(zeta), u]        (N*(nw+1)+m columns)
        - nonlinear: psi([zeta, u])        (N*(nw+1) columns)
        - bilinear:  psi_input(zeta, u)    (N*(nw+1)*(m+1) columns)

        Memoized: the pairs and basis are fixed after __init__, and the
        lift is the dominant training cost -- a lasso sweep would otherwise
        re-lift the whole corpus once per candidate.
        """
        if getattr(self, "_lift_cache", None) is not None:
            return self._lift_cache
        sp = self.snapshot_pairs
        b = self.basis
        mt = self.cfg.model_type
        # host-CPU lift: platform-independent training (see _lift_rows)
        with jax.default_device(jax.devices("cpu")[0]):
            alpha = jnp.asarray(np.asarray(sp.alpha, self.dtype))
            beta = jnp.asarray(np.asarray(sp.beta, self.dtype))
            u = jnp.asarray(np.asarray(sp.u, self.dtype))
            w = None if sp.w is None else \
                jnp.asarray(np.asarray(sp.w, self.dtype))
            self._lift_cache = self._lift_snapshot_matrices_inner(
                alpha, beta, u, w, b, mt)
            return self._lift_cache

    def _lift_snapshot_matrices_inner(self, alpha, beta, u, w, b, mt):

        if mt == "nonlinear":
            zau = jnp.concatenate([alpha, u], axis=1)
            zbu = jnp.concatenate([beta, u], axis=1)
            if self.nw > 0:
                lift = jax.vmap(b.lift_loaded)
                Px, Py = lift(zau, w), lift(zbu, w)
            else:
                lift = jax.vmap(b.lift)
                Px, Py = lift(zau), lift(zbu)
        elif mt == "bilinear":
            if self.nw > 0:
                lift = jax.vmap(b.lift_loaded_input)
                Px, Py = lift(alpha, w, u), lift(beta, w, u)
            else:
                lift = jax.vmap(b.lift_input)
                Px, Py = lift(alpha, u), lift(beta, u)
        else:
            if self.nw > 0:
                lift = jax.vmap(b.lift_loaded)
                gx, gy = lift(alpha, w), lift(beta, w)
            else:
                lift = jax.vmap(b.lift)
                gx, gy = lift(alpha), lift(beta)
            Px = jnp.concatenate([gx, u], axis=1)
            Py = jnp.concatenate([gy, u], axis=1)
        return Px, Py

    def _delay_pin_mask(self, Nm: int) -> Optional[np.ndarray]:
        """Entries of K pinned to 1 by the delay structure.

        Semantic port of ``Ksysid.solve_KoopmanQP:1139-1164``: K[:, j] predicts
        basis entry j at the next step; delayed entries are exact copies of
        current entries, so those columns are unit vectors.
        Only applies to linear models with delays.
        """
        if self.cfg.model_type != "linear" or self.nd < 1:
            return None
        n, m, nd, NL = self.n, self.m, self.nd, self.N * (self.nw + 1)
        mask = np.zeros((Nm, Nm), bool)
        for j in range(1, nd + 1):          # y-delay blocks
            dst = n * j + np.arange(n)
            src = n * (j - 1) + np.arange(n)
            mask[src, dst] = True
        for j in range(1, nd + 1):          # u-delay blocks
            dst = n * (nd + 1) + m * (j - 1) + np.arange(m)
            if j == 1:
                src = NL + np.arange(m)     # current input columns of Px
            else:
                src = n * (nd + 1) + m * (j - 2) + np.arange(m)
            mask[src, dst] = True
        return mask

    def _lstsq64(self, A, B):
        """Minimum-norm least squares, always in float64.

        The regression runs once per fit; in float32 sessions (the
        accelerator default, x64 off) doing it at f32 visibly degrades open-loop rollouts (arm
        linear validation 2.6 vs 0.73 mean Euclidean error), so the solve
        always routes through host float64 and casts back.

        f32 sessions additionally truncate at rcond = f32 eps: the lifted
        features were EVALUATED at f32, so singular directions below the
        f32 noise floor are pure noise -- the f64 default rcond keeps
        them, and the minimum-norm solution loads them with huge
        coefficients (|K| ~ 1e4 observed on a loaded corpus) whose
        stability-critical cancellations then die in the final f32 cast
        (rho(A) 1.0000 -> 1.74, open-loop NaN; round-5 root cause).  A
        no-op when cond(Px) < 1/eps_f32 (the unloaded arm corpora).
        """
        if self.dtype == jnp.float64:
            return lstsq_ops.lstsq(A, B, refine=0)
        X = np.linalg.lstsq(np.asarray(A, np.float64),
                            np.asarray(B, np.float64),
                            rcond=float(np.finfo(np.float32).eps))[0]
        return jnp.asarray(X, self.dtype)

    def get_koopman(self, lasso: float):
        """Fit K with Px K ~= Py (``Ksysid.get_Koopman:987-1092``)."""
        Px, Py = self.lift_snapshot_matrices()
        if lasso >= 1e6 or math.isinf(lasso):
            K = self._lstsq64(Px, Py)
        else:
            t = lasso * self.N              # budget scaling (Ksysid.m:994-999)
            pin = self._delay_pin_mask(Px.shape[1])
            # host float64 regardless of the x64 flag: f32 regression
            # visibly degrades models (same rule as _lstsq64)
            K = jnp.asarray(lasso_constrained_lstsq_f64(
                Px, Py, t, pin_mask=pin,
                iters=self.cfg.lasso_iters,
                tol=self.cfg.lasso_tol), self.dtype)
        NLdim = self.N * (self.nw + 1)
        return {"K": K, "Px": Px[:, :NLdim], "Py": Py[:, :NLdim],
                "u": jnp.asarray(self.snapshot_pairs.u, self.dtype),
                "w": None if self.snapshot_pairs.w is None
                     else jnp.asarray(self.snapshot_pairs.w, self.dtype)}

    # ------------------------------------------------------ model extraction

    def _meta(self) -> ModelMeta:
        return ModelMeta(
            model_type=self.cfg.model_type, time_type=self.cfg.time_type,
            n=self.n, m=self.m, nd=self.nd, nw=self.nw, N=self.N,
            nzeta=self.nzeta, Ts=self.Ts,
        )

    def get_model(self, koop) -> LinearModel:
        """Extract A, B, C (+ M projection) (``Ksysid.get_model:1179-1235``)."""
        K = koop["K"]
        NL = self.N * (self.nw + 1)
        if self.cfg.time_type == "continuous":
            UT = logm_host(np.asarray(K).T + 1e-12 * np.eye(K.shape[0])) / self.Ts
            UT = jnp.asarray(UT, self.dtype)
        else:
            UT = K.T
        A = UT[:NL, :NL]
        B = UT[:NL, NL:]
        C = jnp.concatenate(
            [jnp.eye(self.n, dtype=self.dtype),
             jnp.zeros((self.n, NL - self.n), self.dtype)], axis=1)

        # projection M = argmin ||L M^T - Py|| with L_i = (A Px_i + B u_i)^T
        L = koop["Px"] @ A.T + koop["u"] @ B.T
        Mt = self._lstsq64(L, koop["Py"])
        M = Mt.T
        if self.cfg.time_type == "discrete":
            A, B = M @ A, M @ B
        return LinearModel(A=A, B=B, C=C, M=M, K=K, meta=self._meta(),
                           basis=self.basis)

    def get_BLmodel(self, koop) -> BilinearModel:
        """Extract bilinear A, B, Beta (``Ksysid.get_BLmodel:1238-1282``)."""
        K = koop["K"]
        NL = self.N * (self.nw + 1)
        if self.cfg.time_type == "continuous":
            UT = logm_host(np.asarray(K).T + 1e-12 * np.eye(K.shape[0])) / self.Ts
            UT = jnp.asarray(UT, self.dtype)
        else:
            UT = K.T
        A = UT[:NL, :NL]
        B = UT[:NL, NL:]                      # (NL, m*NL), block k => input k
        Br = B.reshape(NL, self.m, NL)
        C = jnp.concatenate(
            [jnp.eye(self.n, dtype=self.dtype),
             jnp.zeros((self.n, NL - self.n), self.dtype)], axis=1)
        return BilinearModel(A=A, B=Br, C=C, K=K, meta=self._meta(),
                             basis=self.basis)

    def get_NLmodel(self, koop) -> NonlinearModel:
        """Extract the discrete vector field (``Ksysid.get_NLmodel:1298-1341``)."""
        K = koop["K"]
        if self.cfg.time_type == "continuous":
            Kc = logm_host(np.asarray(K) + 1e-12 * np.eye(K.shape[0])) / self.Ts
            K = jnp.asarray(Kc, self.dtype)
        W = K[:, : self.nzeta]
        C = jnp.eye(self.n, dtype=self.dtype)
        return NonlinearModel(W=W, C=C, K=K, meta=self._meta(), basis=self.basis)

    def train_models(self, lasso=None) -> "Ksysid":
        """Fit one candidate model per lasso value (``Ksysid.m:1344-1389``)."""
        lasso_vals = self.cfg.lasso if lasso is None else (
            (lasso,) if np.isscalar(lasso) else tuple(lasso))
        extract = {"linear": self.get_model, "bilinear": self.get_BLmodel,
                   "nonlinear": self.get_NLmodel}[self.cfg.model_type]
        self.candidates = []
        for lv in lasso_vals:
            koop = self.get_koopman(float(lv))
            mdl = extract(koop)
            mdl = dataclasses.replace(mdl, lasso=float(lv))
            self.candidates.append(mdl)
        self.model = self.candidates[0]
        return self

    # ----------------------------------------------------------- validation

    def _initial_lift(self, model, zeta0, w0=None):
        if isinstance(model, NonlinearModel):
            return jnp.asarray(zeta0, self.dtype)
        if self.nw > 0:
            return self.basis.lift_loaded(zeta0, w0)
        return self.basis.lift(zeta0)

    def val_model(self, model, valtrial: Trial) -> dict:
        """Open-loop rollout vs held-out data (``Ksysid.val_*model``).

        valtrial must already be scaled (entries of ``self.valdata``).
        Returns {t, sim: {y, z}, real: {y}, error}.
        """
        zeta, uz = delay_embed(valtrial.y, valtrial.u, self.nd)
        treal = np.asarray(valtrial.t)[self.nd:]
        yreal = np.asarray(valtrial.y)[self.nd:]
        U = jnp.asarray(uz, self.dtype)
        W = None
        if self.nw > 0:
            W = jnp.asarray(np.asarray(valtrial.w)[self.nd:], self.dtype)
        zeta0 = jnp.asarray(zeta[0], self.dtype)
        z0 = self._initial_lift(model, zeta0, None if W is None else W[0])
        Y, Z = rollout(model, z0, U, W)
        err = get_error(Y, yreal, scaler=self.scaler)
        return {"t": treal, "sim": {"y": np.asarray(Y), "z": np.asarray(Z)},
                "real": {"y": yreal}, "error": err}

    def validate(self, model=None) -> list:
        """val_model over every validation trial (``valNplot_model``)."""
        model = model or self.model
        return [self.val_model(model, tr) for tr in self.valdata]
