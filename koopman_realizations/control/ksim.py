"""Closed-loop plant-in-the-loop MPC simulation (reference class ``Ksim``).

``Ksim.run_trial_mpc:47-262`` is a MATLAB while-loop doing, per 50 ms step:
estimate load -> slice reference horizon -> solve MPC QP -> step the true
plant -> record.  Here the entire loop is ONE ``lax.scan`` body, so it jits
to a single XLA program; ``vmap`` over the scan runs thousands of scenarios
per chip and ``shard_map`` spreads lanes across the mesh (see
``parallel.scenarios``).

Reference bookkeeping quirks reproduced for golden-file parity:
- the plant consumes the input chosen at the *previous* step
  (``Ksim.m:239-246``: ``u_k = results.U(end,:)``),
- the applied input each step is the *second* row of the MPC plan
  (``Ksim.m:225``),
- the recorded reference row at 1-based step k is ``ref_sc(k,:)`` = the row
  the horizon starts at (``Ksim.m:199,254``), so the error trace compares
  the NEXT measurement ``Y[k+1]`` with the current reference row ``ref[k]``,
- infeasible solves: the reference breaks the loop (``:220-222``); here the
  lane freezes and reports ``alive=False`` from that step on.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from koopman_realizations.control.kmpc import NonlinearKmpc
from koopman_realizations.utils.metrics import tracking_error


class KoopmanPlant:
    """Model-in-the-loop 'plant': propagates the learned lifted model instead
    of a physical simulator (reference ``Kmpc.run_simulation:403-512``).

    State is the lifted vector z; inputs/outputs cross the scaling boundary
    exactly like a real plant so the same Ksim harness drives it.
    """

    def __init__(self, model, scaler):
        self.model = model
        self.scaler = scaler

        class _Cfg:
            nx = model.meta.NL

        self.cfg = _Cfg()

    def simulate_Ts(self, z, u, w=None):
        u_sc = self.scaler.u_down(jnp.asarray(u))
        return self.model.step(z, u_sc)

    def get_y(self, z):
        return self.scaler.y_up(self.model.output(z))


def run_model_simulation(mpc, ref, steps: Optional[int] = None,
                         zeta0=None) -> dict:
    """Closed loop against the model itself (``Kmpc.run_simulation``)."""
    plant = KoopmanPlant(mpc.model, mpc.scaler)
    sim = Ksim(plant, mpc)
    if zeta0 is None:
        zeta0 = jnp.zeros((mpc.meta.nzeta,))
    z0 = mpc.model.basis.lift(jnp.asarray(zeta0))
    return sim.run_trial_mpc(ref, x0=np.asarray(z0), steps=steps)


class Ksim:
    """Closed-loop harness binding a plant, a controller, and scaling."""

    def __init__(self, plant, mpc, observer=None):
        self.plant = plant
        self.mpc = mpc
        self.scaler = mpc.scaler
        self.observer = observer     # optional load observer (control.observer)
        self.meta = mpc.meta
        self.nd = self.meta.nd
        # trailing-window length: delays need nd+1 rows; the load observer
        # needs load_obs_horizon+1 rows of past measurements, plus nd more
        # to delay-embed each regression row (observer.embed_zetas)
        self.win = self.nd + 1
        if observer is not None:
            self.win = max(self.win,
                           mpc.cfg.load_obs_horizon + 1 + self.nd)
        self._runner_cache = {}      # (ref bytes, steps, ...) -> jitted runner
        # width of the plant's load vector (the arm's is [m_ee, r_offset]);
        # plants with a different disturbance shape expose cfg.nw_plant
        self.nw_plant = getattr(plant.cfg, "nw_plant", 2)
        # receding-horizon dual warm start: the previous step's QP
        # multipliers ride the scan carry (controllers that expose n_con)
        self._dual_warm = bool(getattr(mpc.cfg, "qp_dual_warm", False)) \
            and hasattr(type(mpc), "n_con")

    # ------------------------------------------------------------------
    def _lift_current(self, zeta, what):
        # keyed on the CONTROLLER, not the model: NonlinearKmpc's vector
        # field always consumes the raw zeta (it lifts internally), including
        # the bilinear-as-NMPC dispatch (mpc_type="nonlinear" on a
        # BilinearModel, Kmpc.m:93) -- the condensed controllers consume the
        # lifted state
        if isinstance(self.mpc, NonlinearKmpc):
            return zeta
        if getattr(self.mpc, "wants_zeta", False):
            # lift-fused bilinear controller: the poly lift is folded into
            # the QP assembly; the loop ships the raw zeta
            return zeta
        basis = self.mpc.model.basis
        if self.meta.nw > 0:
            return basis.lift_loaded(zeta, what)
        return basis.lift(zeta)

    RECORD_ALL = ("U", "Y", "X", "R", "Z", "what", "alive")

    def make_body(self, ref_padded, record=RECORD_ALL):
        """Jittable scan body closed over the (device-constant) reference.

        carry = (x, ywin, uwin, u_prev, what, alive, U_plan); xs = (k, w_k)
        with k the reference index and w_k the true load applied this step.

        ``record`` selects which per-step outputs the scan stacks.  The full
        set costs real HBM at large batch -- Z alone is (B, K, NL) -- and
        dropping unused fields lets XLA dead-code-eliminate their stores
        (the B>8192 throughput cliff was exactly this).
        """
        mpc = self.mpc
        plant = self.plant
        scaler = self.scaler
        nd = self.nd
        Np = mpc.Np
        nproj = mpc.nproj
        ref_padded = jnp.asarray(ref_padded)

        dual = self._dual_warm

        def body_inner(carry, xs):
            k, w_k = xs
            if dual:
                x, y, ywin, uwin, u_prev, what, alive, U_plan, lam_plan = carry
            else:
                x, y, ywin, uwin, u_prev, what, alive, U_plan = carry

            # zeta from the trailing windows (newest last)
            parts = [ywin[-1]]
            for j in range(1, nd + 1):
                parts.append(ywin[-1 - j])
            for j in range(1, nd + 1):
                parts.append(uwin[-1 - j])
            zeta = jnp.concatenate(parts)

            # load estimate (observer wired via self.observer)
            what_prev = what
            if self.observer is not None:
                what = self.observer(k, ywin, uwin, what)

            z = self._lift_current(zeta, what)
            # k is the reference's 1-based step counter; the horizon starts
            # at the CURRENT reference row ref_sc(k,:) = ref[k-1] 0-based
            # (Ksim.m:198-199)
            refhor = jax.lax.dynamic_slice(ref_padded, (k - 1, 0),
                                           (Np + 1, nproj))
            if dual:
                # receding-horizon dual warm start: last step's multipliers
                # seed the interior point (floored in ops.qp, so stale
                # rows cannot pull it off the central path)
                U, ok, lam = mpc.solve(z, uwin[-1], refhor, U_init=U_plan,
                                       lam_init=lam_plan)
            else:
                U, ok = mpc.solve(z, uwin[-1], refhor, U_init=U_plan)
            u_next_sc = U[1]
            u_next = scaler.u_up(u_next_sc)

            # plant step with the previously chosen input (Ksim.m:239-246)
            x_new = plant.simulate_Ts(x, u_prev, w_k)
            y_new = plant.get_y(x_new)

            # freeze dead lanes: solver failure (reference: break on NaN
            # solution) or a non-finite plant state (e.g. the integrator
            # diverging under extreme unmodeled scenarios) -- either way the
            # lane must stop before NaNs enter the frozen records
            alive = alive & ok & jnp.all(jnp.isfinite(x_new))
            keep = lambda new, old: jnp.where(alive, new, old)
            x1 = keep(x_new, x)
            # y rides the carry so the frozen-lane output needs no second
            # forward-kinematics evaluation (y == get_y(x) by induction)
            y1 = keep(y_new, y)
            ywin1 = keep(jnp.concatenate([ywin[1:], scaler.y_down(y_new)[None]]),
                         ywin)
            uwin1 = keep(jnp.concatenate([uwin[1:], u_next_sc[None]]), uwin)
            u_prev1 = keep(u_next, u_prev)
            U_plan1 = keep(U, U_plan)

            out_full = {
                "U": lambda: keep(u_next, jnp.nan * u_next),
                "Y": lambda: y1,
                # projected tracked outputs only (y[proj_idx]): the bench
                # reads nothing else of Y -- recording 2 of 12 dims saves
                # per-step HBM stores and the post-run fetch
                "Yp": lambda: y1[jnp.asarray(mpc.proj_idx)],
                "X": lambda: x1,
                "R": lambda: scaler.ref_up(refhor[0], mpc.proj_idx),
                "Z": lambda: z,
                "what": lambda: what1,
                "alive": lambda: alive,
                # extra keys for utils.timing.phase_breakdown (not in
                # RECORD_ALL): the exact inputs the solve phase consumed
                "zeta": lambda: zeta,
                "u_prev_sc": lambda: uwin[-1],
                "U_plan_in": lambda: U_plan,
            }
            # the load estimate freezes with the lane like every other
            # carry element (dead lanes must not keep drifting What records)
            what1 = keep(what, what_prev)
            out = {name: out_full[name]() for name in record}
            new_carry = (x1, y1, ywin1, uwin1, u_prev1, what1, alive, U_plan1)
            if dual:
                new_carry += (keep(lam, lam_plan),)
            return new_carry, out

        def body(carry, xs):
            # true f32 matmuls throughout the control loop (no TF32 on the
            # GPU): reduced-precision matmul inputs accumulate enough error
            # in the plant Jacobians / MPC assembly to destabilize long
            # rollouts.  All matrices here are tiny, so full f32 costs
            # little.
            with jax.default_matmul_precision("highest"):
                return body_inner(carry, xs)

        return body

    # ---------------------------------------------------------- host prep

    def prep_ref(self, ref) -> np.ndarray:
        """Scale the reference down and pad Np+1 repeats of the last row."""
        ref_sc = np.asarray(self.scaler.ref_down(ref, self.mpc.proj_idx), float)
        return np.concatenate(
            [ref_sc, np.tile(ref_sc[-1:], (self.mpc.Np + 1, 1))], axis=0)

    def init_carry(self, x0=None, u0=None, dtype=jnp.float64):
        plant, scaler, nd = self.plant, self.scaler, self.nd
        if not jax.config.jax_enable_x64:
            dtype = jnp.float32
        x0 = np.zeros(plant.cfg.nx) if x0 is None else np.asarray(x0, float)
        u0 = np.zeros(self.meta.m) if u0 is None else np.asarray(u0, float)
        y0 = np.asarray(plant.get_y(jnp.asarray(x0)))
        y0j = jnp.asarray(y0, dtype)
        ywin0 = jnp.tile(jnp.asarray(scaler.y_down(y0), dtype)[None], (self.win, 1))
        uwin0 = jnp.tile(jnp.asarray(scaler.u_down(u0), dtype)[None], (self.win, 1))
        what0 = jnp.zeros((self.meta.nw,), dtype)
        # U_plan is carried in SCALED units (mpc.solve returns scaled plans)
        u0_sc = jnp.asarray(scaler.u_down(u0), dtype)
        U_plan0 = jnp.tile(u0_sc[None], (self.mpc.Np, 1))
        carry = (jnp.asarray(x0, dtype), y0j, ywin0, uwin0,
                 jnp.asarray(u0, dtype), what0, jnp.asarray(True), U_plan0)
        if self._dual_warm:
            # approximately cold: lam0 is given in ORIGINAL units, so the
            # solver's row/objective rescaling makes the first solve start
            # at sqrt-damped sqrt(row/obj) rather than exactly the cold
            # equilibrated lam = 1 -- the damping clamp keeps it near the
            # central path, and bench quality (alive 1.0, golden-parity
            # error) is verified with exactly this start
            carry += (jnp.ones((self.mpc.n_con,), dtype),)
        return carry

    def _w_seq(self, load, K) -> np.ndarray:
        if load is None:
            return np.zeros((K, self.nw_plant))
        load = np.asarray(load, float)
        return np.tile(load, (K, 1)) if load.ndim == 1 else load[:K]

    # --------------------------------------------------------- single trial

    def run_trial_mpc(self, ref, x0=None, u0=None, load=None,
                      steps: Optional[int] = None) -> dict:
        """Run one closed-loop trial (``Ksim.run_trial_mpc``).

        ref: (K, nproj) UNscaled reference; x0 (nx,), u0 (m,) initial plant
        state/input (default zeros); load: None, (nw,), or (K, nw) true load.
        """
        K = ref.shape[0] if steps is None else steps
        body = self.make_body(self.prep_ref(ref))
        init = self.init_carry(x0, u0)
        ks = jnp.arange(1, K)                 # reference loop: k = 1 .. K-1
        # iteration k applies load row k-1 (Ksim.m:242: results.W(k,:) with
        # 1-based k), so rows 0..K-2 align with ks = 1..K-1
        w_seq = jnp.asarray(self._w_seq(load, K)[:-1], init[0].dtype)
        import time as _time

        t0 = _time.perf_counter()
        _, out = jax.lax.scan(body, init, (ks, w_seq))
        jax.block_until_ready(out["Y"])
        wall = _time.perf_counter() - t0
        return self._package(out, wall_s=wall)

    def run_trial_mpc_timed(self, ref, x0=None, u0=None, load=None,
                            steps: Optional[int] = None) -> dict:
        """Unfused timed closed loop: one jitted body call PER STEP with a
        tic/toc around it, reproducing the reference's per-step ``comp_time``
        measurement (``Ksim.m:205-217``; BASELINE rows are mean/median/max of
        that field).  ~10-100x slower than ``run_trial_mpc`` (dispatch per
        step + no fusion across steps) -- use for timing evidence only.
        """
        import time as _time

        K = ref.shape[0] if steps is None else steps
        if K < 2:
            raise ValueError(f"timed run needs >= 2 steps, got {K}")
        body = jax.jit(self.make_body(self.prep_ref(ref)))
        carry = self.init_carry(x0, u0)
        w_seq = np.asarray(self._w_seq(load, K)[:-1])
        dtype = carry[0].dtype
        # compile once on the first step's shapes (discarded)
        jax.block_until_ready(
            body(carry, (jnp.asarray(1), jnp.asarray(w_seq[0], dtype))))
        outs, comp = [], []
        for i, k in enumerate(range(1, K)):
            xs = (jnp.asarray(k), jnp.asarray(w_seq[i], dtype))
            t0 = _time.perf_counter()
            carry, out = jax.block_until_ready(body(carry, xs))
            comp.append(_time.perf_counter() - t0)
            outs.append(out)
        stacked = {key: jnp.stack([o[key] for o in outs])
                   for key in self.RECORD_ALL}
        res = self._package(stacked, wall_s=float(np.sum(comp)))
        res["comp_time"] = np.asarray(comp)
        return res

    def _package(self, out, wall_s: float = 0.0) -> dict:
        """Assemble the reference's results-struct schema (``Ksim.m:129-258``).

        ``comp_time`` attributes the compiled loop's wall time uniformly over
        steps (per-solve tic/toc does not exist inside one fused scan;
        includes compile time on first call -- use utils.timing.step_time for
        clean measurements).
        """
        from koopman_realizations.utils.timing import comp_time_like

        Y = np.asarray(out["Y"])
        R = np.asarray(out["R"])
        err = np.asarray(tracking_error(R, Y, self.mpc.proj_idx))
        Ts = self.meta.Ts
        K1 = Y.shape[0]
        return {
            "comp_time": comp_time_like(wall_s, K1),
            "T": np.arange(1, K1 + 1) * Ts,
            # step-counter column of the reference's results struct
            # (``Ksim.m:133,253``: K starts at 0 and appends k per step; the
            # initial k=0 row is dropped here like every other initial row)
            "K": np.arange(1, K1 + 1),
            "U": np.asarray(out["U"]),
            "Y": Y,
            "R": R,
            "X": np.asarray(out["X"]),
            "Z": np.asarray(out["Z"]),
            "What": np.asarray(out["what"]),
            "alive": np.asarray(out["alive"]),
            "err": err,
        }

    def lane_init(self, x0, init0=None):
        """Per-lane scan init: re-seed x, y, AND the measurement window from
        this lane's actual initial state, so batched lanes are identical to
        ``run_trial_mpc(x0=...)`` (which seeds ywin through init_carry).
        Regression: seeding only (x, y) left every lane's first solve --
        and the first nd delay coordinates -- on the zero state's output."""
        if init0 is None:
            init0 = self.init_carry()
        import jax.numpy as _jnp
        x0 = _jnp.asarray(x0, init0[0].dtype)
        y0 = self.plant.get_y(x0).astype(init0[1].dtype)
        ywin0 = _jnp.tile(
            self.scaler.y_down(y0)[None].astype(init0[2].dtype),
            (self.win, 1))
        return (x0, y0, ywin0) + init0[3:]

    # ------------------------------------------------------ batched variant

    def batched_runner(self, ref, steps: Optional[int] = None,
                       record=RECORD_ALL):
        """Return fn(x0_batch, w_batch) scanning the closed loop vmapped over
        scenario lanes.  fn is jit-compiled once and reusable; pair with
        ``parallel.scenarios.shard_scenarios`` to spread lanes over a device
        mesh.  ``record`` trims the stacked outputs (see ``make_body``).
        """
        K = ref.shape[0] if steps is None else steps
        body = self.make_body(self.prep_ref(ref), record=record)
        init0 = self.init_carry()
        ks = jnp.arange(1, K)

        def one(x0, w):
            w_seq = jnp.tile(w[None, :], (K - 1, 1))
            _, out = jax.lax.scan(body, self.lane_init(x0, init0),
                                  (ks, w_seq))
            return out

        return jax.jit(jax.vmap(one))

    def run_multi_ref(self, refs, X0, load=None,
                      steps: Optional[int] = None) -> dict:
        """Batch with a DIFFERENT reference trajectory per lane.

        refs: list of (K_i, nproj) unscaled trajectories (padded to the
        longest with their final point) or an array (B, K, nproj).  Together
        with per-lane loads and initial states this realizes the north-star
        scenario axis: trajectories x initial conditions x loads concurrent
        in one compiled batch.

        Note: with ``steps`` set, each lane's reference is truncated at
        ``steps`` rows before horizon padding, so the final Np steps see a
        held terminal point instead of the trajectory's continuation (a
        truncated run of ``run_trial_mpc`` keeps looking ahead into the full
        reference).
        """
        if isinstance(refs, (list, tuple)):
            K = max(r.shape[0] for r in refs) if steps is None else steps
            stacked = []
            for r in refs:
                r = np.asarray(r, float)
                if r.shape[0] < K:
                    r = np.concatenate(
                        [r, np.tile(r[-1:], (K - r.shape[0], 1))], axis=0)
                stacked.append(r[:K])
            refs = np.stack(stacked)
        refs = np.asarray(refs, float)
        B, K = refs.shape[0], refs.shape[1] if steps is None else steps
        refs_padded = np.stack([self.prep_ref(r[:K]) for r in refs])

        init0 = self.init_carry()
        ks = jnp.arange(1, K)

        def one(x0, w, refp):
            body = self.make_body(refp, record=("U", "Y", "R", "alive"))
            w_seq = jnp.tile(w[None, :], (K - 1, 1))
            _, out = jax.lax.scan(body, self.lane_init(x0, init0),
                                  (ks, w_seq))
            return out

        load_b = jnp.zeros((B, self.nw_plant)) if load is None \
            else jnp.asarray(load)
        out = jax.jit(jax.vmap(one))(jnp.asarray(X0), load_b,
                                     jnp.asarray(refs_padded, init0[0].dtype))
        Y = np.asarray(out["Y"])
        R = np.asarray(out["R"])
        err = np.sqrt(((R - Y[..., list(self.mpc.proj_idx)]) ** 2).sum(-1))
        return {"Y": Y, "R": R, "U": np.asarray(out["U"]),
                "alive": np.asarray(out["alive"]), "err": err}

    def run_batch(self, ref, X0, load=None, steps: Optional[int] = None) -> dict:
        """vmap the whole closed loop over scenario axis 0 of X0.

        All scenarios share the reference; load: optional (B, nw_plant).
        """
        # content-keyed cache: id() of a collected array can be reused by a
        # different ref of the same length, silently replaying a stale runner
        record = ("U", "Y", "X", "R", "alive")
        key = (np.asarray(ref, float).tobytes(),
               ref.shape[0] if steps is None else steps, record)
        fn = self._runner_cache.get(key)
        if fn is None:
            fn = self._runner_cache[key] = self.batched_runner(
                ref, steps, record=record)
        B = np.asarray(X0).shape[0]
        load_b = jnp.zeros((B, self.nw_plant)) if load is None \
            else jnp.asarray(load)
        out = fn(jnp.asarray(X0), load_b)
        Y = np.asarray(out["Y"])
        R = np.asarray(out["R"])
        err = np.sqrt(((R - Y[..., list(self.mpc.proj_idx)]) ** 2).sum(-1))
        return {"Y": Y, "R": R, "U": np.asarray(out["U"]),
                "X": np.asarray(out["X"]),
                "alive": np.asarray(out["alive"]), "err": err}
