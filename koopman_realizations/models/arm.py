"""Differentiable planar N-link arm plant (reference class ``Arm``).

The reference derives the equations of motion symbolically (MATLAB Symbolic
Toolbox, ``Arm.set_EOM:111-222``) and compiles them with ``matlabFunction``.
Here the same Lagrangian mechanics come out of closed-form kinematics plus
JAX autodiff -- no symbols, fully jittable, batched with vmap:

    Dq(a, w) addot = -( dDq/dt adot - dL/da + damp + input )

with
    Dq   = m Jxcm^T Jxcm + i Jth^T Jth + Jx_end^T diag(m_eff) Jx_end
    L    = KE - PE,  KE = 1/2 adot^T Dq adot
    PE   = -m g sum(h_links) - w1 g h_eff + 1/2 k a^T a
    damp = d adot
    input= -ku (kron(u, 1_nlinks) - a)       (u is a joint *reference angle*,
                                              Arm.m:211-213, "Known Issue #1")
    w    = [end-effector mass, gravity direction angle]

Sensing (``Arm.get_y:364-412``): 'angles' | 'markers' | 'endeff' | 'shape'.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from koopman_realizations.config import ArmConfig
from koopman_realizations.ops.integrators import rk4, rk45, sdirk2


class Arm:
    """Planar N-link arm with autodiff Lagrangian dynamics."""

    def __init__(self, cfg: ArmConfig):
        self.cfg = cfg
        self.nlinks = cfg.Nlinks
        self._shape_obs_matrix = self._build_shape_obs_matrix()
        # closed-form inertia coefficients of the uniform planar chain:
        # in theta coordinates KE = 1/2 sum_{p,q} l^2 (m G[p,q] + w1)
        # cos(th_p - th_q) thd_p thd_q + 1/2 i sum thd^2, where G counts how
        # links past max(p,q) couple p and q (a_kp = 1 for k>p, 1/2 for k=p):
        # G[p,q] = N - max(p,q) + 1/2 (p != q), G[p,p] = N - p + 1/4 (1-based)
        N = self.nlinks
        idx = np.arange(1, N + 1)
        mx = np.maximum(idx[:, None], idx[None, :])
        G = (N - mx + 0.5).astype(float)
        np.fill_diagonal(G, N - idx + 0.25)
        self._G = G
        # gravity lever coefficients: sum_k a_kj = N - j + 1/2
        self._b = (N - idx + 0.5).astype(float)
        self._cv_cache = {}          # Ts -> custom_vmap'd SDIRK2 step

    # ---------------------------------------------------------- kinematics

    def alpha2theta(self, alpha):
        """Relative joint angles -> absolute angles (``Arm.m:37-50``)."""
        return jnp.cumsum(alpha)

    def joint_positions(self, alpha):
        """xy of each joint 0..Nlinks (rows), link COMs (``Arm.m:53-76``)."""
        theta = self.alpha2theta(alpha)
        step = self.cfg.l * jnp.stack([-jnp.sin(theta), jnp.cos(theta)], axis=1)
        joints = jnp.concatenate(
            [jnp.zeros((1, 2), alpha.dtype), jnp.cumsum(step, axis=0)], axis=0)
        coms = joints[:-1] + 0.5 * step
        return joints, coms

    # ------------------------------------------------------------ dynamics

    def mass_matrix(self, alpha, w):
        """Configuration-dependent mass matrix Dq (``Arm.m:148-151``).

        Closed form: Dq = J^T M_theta J with J the lower-triangular ones
        (theta = J alpha) and M_theta[p,q] = l^2 (m G[p,q] + w1)
        cos(th_p - th_q) + i delta_pq.  Equivalent to the reference's
        Jacobian products (cross-validated against the autodiff construction
        in ``_mass_matrix_autodiff``) at a fraction of the cost -- this sits
        inside every integrator substep of every simulation lane.
        """
        cfg = self.cfg
        theta = self.alpha2theta(alpha)
        dth = theta[:, None] - theta[None, :]
        coef = cfg.l ** 2 * (cfg.m * jnp.asarray(self._G, alpha.dtype) + w[0])
        M_th = coef * jnp.cos(dth) + cfg.i * jnp.eye(self.nlinks, dtype=alpha.dtype)
        # Dq = J^T M J with J lower-triangular ones: cumulative sums
        tmp = jnp.cumsum(M_th[::-1, :], axis=0)[::-1]      # J^T M
        return jnp.cumsum(tmp[:, ::-1], axis=1)[:, ::-1]   # (J^T M) J

    def _mass_matrix_autodiff(self, alpha, w):
        """Reference-faithful Jacobian construction (kept for validation)."""
        cfg = self.cfg

        def xcm_flat(a):
            return self.joint_positions(a)[1].reshape(-1)

        def theta_fn(a):
            return self.alpha2theta(a)

        def xj_flat(a):
            return self.joint_positions(a)[0][1:].reshape(-1)  # joints 1..N

        J_xcm = jax.jacfwd(xcm_flat)(alpha)
        J_th = jax.jacfwd(theta_fn)(alpha)
        J_x = jax.jacfwd(xj_flat)(alpha)
        # end-effector point mass on the last joint's xy coordinates
        m_joints = jnp.zeros(2 * self.nlinks, alpha.dtype)
        m_joints = m_joints.at[-2:].set(w[0])
        Dq = (cfg.m * J_xcm.T @ J_xcm
              + cfg.i * J_th.T @ J_th
              + J_x.T @ (m_joints[:, None] * J_x))
        return Dq

    def potential_energy(self, alpha, w):
        """PE with tilted gravity + joint springs (``Arm.m:164-169``).

        Closed form: heights along the tilted gravity direction reduce to
        cos(theta_j - w2) with static lever coefficients (sum of COM/end-eff
        contributions per link).
        """
        cfg = self.cfg
        theta = self.alpha2theta(alpha)
        lever = cfg.m * jnp.asarray(self._b, alpha.dtype) + w[0]
        h = cfg.l * jnp.sum(lever * jnp.cos(theta - w[1]))
        return -cfg.g * h + 0.5 * cfg.k * jnp.sum(alpha ** 2)

    def input_torque(self, alpha, u):
        """tau = -ku (kron(u, 1_nlinks) - alpha) (``Arm.m:211-213``)."""
        u_rep = jnp.repeat(u, self.cfg.nlinks)
        return -self.cfg.ku * (u_rep - alpha)

    def accel(self, alpha, alphadot, u, w):
        """Joint accelerations from the Euler-Lagrange equations.

        Mirrors ``Arm.set_EOM:220-221``: nonInert = Dq_dt adot - dL/da +
        damp + input, then Dq addot = -nonInert.
        """
        cfg = self.cfg

        def lagrangian(a):
            Dq = self.mass_matrix(a, w)
            ke = 0.5 * alphadot @ (Dq @ alphadot)
            return ke - self.potential_energy(a, w)

        dLda = jax.grad(lagrangian)(alpha)
        dDq = jax.jacfwd(lambda a: self.mass_matrix(a, w))(alpha)  # (n,n,n)
        Dq_dt = jnp.einsum("ijk,k->ij", dDq, alphadot)
        non_inert = (Dq_dt @ alphadot - dLda
                     + cfg.d * alphadot + self.input_torque(alpha, u))
        Dq = self.mass_matrix(alpha, w)
        from koopman_realizations.ops.batch_linalg import solve_spd_unrolled

        return solve_spd_unrolled(Dq, -non_inert)

    def rhs(self, x, u, w):
        """State-space RHS for x = [alpha; alphadot] (``Arm.vf_RHS:258-279``)."""
        n = self.nlinks
        alpha, alphadot = x[:n], x[n:]
        return jnp.concatenate([alphadot, self.accel(alpha, alphadot, u, w)])

    # ---------------------------------------------------------- simulation

    def simulate_Ts(self, x, u, w=None, Ts: Optional[float] = None):
        """One control-period step (``Arm.simulate_Ts:932-956``), jittable.

        The modified-Newton SDIRK2 path is a ``custom_vmap``: a plain call
        integrates one lane (autodiff Lagrangian RHS); under ``vmap`` (the
        closed-loop scenario batch) the whole batch is dispatched to the
        struct-of-arrays closed-form path (``models.arm_lanes``), which
        avoids the (B, n, n) trailing-dim tile padding that made the plant
        the largest phase of the MPC step.  Parity between the two paths is
        pinned in ``tests/test_arm_lanes.py``.
        """
        cfg = self.cfg
        w = jnp.zeros(2, jnp.asarray(x).dtype) if w is None else jnp.asarray(w)
        Ts = cfg.Ts if Ts is None else Ts
        if cfg.integrator == "sdirk2" and cfg.jac_mode in ("step", "substep"):
            return self._sdirk2_cv(float(Ts))(x, jnp.asarray(u), w)
        return self._simulate_Ts_lane(x, u, w, Ts)

    def _simulate_Ts_lane(self, x, u, w, Ts):
        """Single-lane integrator dispatch (all integrator/jac_mode combos)."""
        cfg = self.cfg
        f = lambda s: self.rhs(s, u, w)
        if cfg.integrator == "rk45":
            return rk45(f, x, Ts)
        if cfg.integrator == "rk4":
            return rk4(f, x, Ts, cfg.substeps)
        return sdirk2(f, x, Ts, cfg.substeps,
                      newton_iters=cfg.newton_iters, jac_mode=cfg.jac_mode)

    def _sdirk2_cv(self, Ts: float):
        """Cached custom_vmap step for one control period (static Ts)."""
        fn = self._cv_cache.get(Ts)
        if fn is not None:
            return fn
        from jax.custom_batching import custom_vmap

        from koopman_realizations.models.arm_lanes import sdirk2_soa

        cfg, G, bvec = self.cfg, self._G, self._b

        @custom_vmap
        def step(x, u, w):
            return self._simulate_Ts_lane(x, u, w, Ts)

        @step.def_vmap
        def _rule(axis_size, in_batched, x, u, w):
            xb, ub, wb = in_batched
            bc = lambda v, vb: v if vb else jnp.broadcast_to(
                v[None], (axis_size,) + v.shape)
            out = sdirk2_soa(cfg, G, bvec, bc(x, xb), bc(u, ub), bc(w, wb),
                             Ts, cfg.substeps, cfg.newton_iters, cfg.jac_mode)
            return out, True

        self._cv_cache[Ts] = step
        return step

    def simulate(self, x0, U, w=None):
        """Roll the plant over a ZOH input table U [T, nu] (scan).

        Returns X [T+1, nx]; ``U[k]`` is held over step k (the reference's
        ``simulate``/``simulate_rampNhold`` hold the per-step table value).
        """
        w = jnp.zeros(2, jnp.asarray(x0).dtype) if w is None else jnp.asarray(w)

        def body(x, u):
            x1 = self.simulate_Ts(x, u, w)
            return x1, x1

        _, X = jax.lax.scan(body, jnp.asarray(x0), jnp.asarray(U))
        return jnp.concatenate([jnp.asarray(x0)[None], X], axis=0)

    def ramp_and_hold(self, rng: np.random.Generator, tf: float, Tramp: float):
        """Random ramp-and-hold input table (``Arm.get_rampNhold:1054-1070``).

        Host-side numpy (data generation); returns (tsteps [T], u [T, nu]).
        """
        cfg = self.cfg
        tsteps = np.arange(0.0, tf + 1e-12, cfg.Ts)
        tswitch = np.arange(0.0, tf + 1e-12, Tramp)
        num_periods = int(np.ceil(len(tswitch) / 2))
        vals = cfg.umax * (2 * rng.random((num_periods, cfg.Nmods)) - 1)
        hold = np.repeat(vals, 2, axis=0)[: len(tswitch)]
        u = np.stack([np.interp(tsteps, tswitch, hold[:, j], left=0, right=0)
                      for j in range(cfg.Nmods)], axis=1)
        return tsteps, u

    # -------------------------------------------------------------- sensing

    def get_markers(self, alpha):
        """Marker xy rows: every nlinks-th joint (``Arm.get_markers:307-311``)."""
        joints, _ = self.joint_positions(alpha)
        return joints[:: self.cfg.nlinks]

    def _build_shape_obs_matrix(self) -> np.ndarray:
        """pinv of the Vandermonde system in points2poly (``Arm.m:339-352``).

        Static: depends only on marker positions; degree 3.
        """
        positions = np.asarray(self.cfg.markerPos)[1:]
        positions_supp = np.concatenate([[0.0, 1e-2], positions, [1.0 + 1e-2]])
        A = np.stack([positions_supp ** i for i in range(1, 4)], axis=1)
        return np.linalg.pinv(A)

    def shape_coeffs(self, alpha):
        """Degree-3 shape polynomial coefficients (``Arm.points2poly:314-361``)."""
        markers = self.get_markers(alpha)
        theta = self.alpha2theta(alpha)
        # reference quirk reproduced: theta2complex returns [sin, cos]
        # (``Arm.m:87-94``) although the link tangent used by the forward
        # kinematics is [-sin, cos] -- the end-tangent support point is
        # mirrored about the vertical for a bent final link, exactly as in
        # the shipped shape-sensing data
        orient = jnp.stack([jnp.sin(theta[-1]), jnp.cos(theta[-1])])
        endpoint = orient * 1e-2 + markers[-1]
        startpoint = jnp.asarray([0.0, 1e-2], alpha.dtype)
        pts = jnp.concatenate([
            jnp.zeros((1, 2), alpha.dtype), startpoint[None],
            markers[1:], endpoint[None]], axis=0)
        P = jnp.asarray(self._shape_obs_matrix, alpha.dtype)
        coeffs = (P @ pts).T                      # rows: x-coeffs, y-coeffs
        return coeffs.reshape(-1)                 # [cx1 cx2 cx3 cy1 cy2 cy3]

    def shape_curve(self, alpha, n_pts: int = 101):
        """Evaluate the fitted shape polynomial along [0, 1]
        (``Arm.get_shape:415-432``); returns (n_pts, 2) xy samples."""
        coeffs = self.shape_coeffs(alpha).reshape(2, 3)
        s = jnp.linspace(0.0, 1.0, n_pts)
        powers = jnp.stack([s, s ** 2, s ** 3])        # polynomial has no constant
        return (coeffs @ powers).T

    def get_y(self, x):
        """Measured output from full state (``Arm.get_y:364-412``), single row."""
        n = self.nlinks
        alpha = x[:n]
        ot = self.cfg.output_type
        if ot == "angles":
            return alpha
        if ot == "markers":
            return self.get_markers(alpha)[1:].reshape(-1)  # drop origin marker
        if ot == "endeff":
            return self.get_markers(alpha)[-1]
        if ot == "shape":
            return self.shape_coeffs(alpha)
        raise ValueError(f"unknown output_type {ot!r}")

    def get_y_batch(self, X):
        return jax.vmap(self.get_y)(jnp.asarray(X))

    # ------------------------------------------------------ data generation

    def simulate_rampNhold_batch(self, rng: np.random.Generator, tf: float,
                                 Tramp: float, W: np.ndarray) -> list:
        """Batched excitation trials: one vmapped scan for all load cases.

        W: (B, 2) load per trial.  Replaces B sequential ode45 runs of the
        reference's data generation with a single compiled batch -- this is
        the on-device path used to regenerate training corpora at scale.
        Returns a list of B sim dicts (same schema as simulate_rampNhold).
        """
        import jax

        W = np.asarray(W, float)
        B = W.shape[0]
        tables = [self.ramp_and_hold(rng, tf, Tramp) for _ in range(B)]
        t = tables[0][0]
        U = np.stack([u for _, u in tables])              # (B, T, nu)
        x0 = jnp.zeros((B, self.cfg.nx))
        sim_b = jax.jit(jax.vmap(lambda x, u, w: self.simulate(x, u, w)))
        X = np.asarray(sim_b(x0, jnp.asarray(U[:, :-1]), jnp.asarray(W)))
        Y = np.asarray(jax.vmap(self.get_y_batch)(jnp.asarray(X)))
        out = []
        for b in range(B):
            out.append({
                "t": t, "x": X[b],
                "alpha": X[b][:, : self.nlinks],
                "alphadot": X[b][:, self.nlinks:],
                "y": Y[b], "u": U[b],
                "w": np.tile(W[b], (len(t), 1)),
            })
        return out

    def simulate_rampNhold(self, rng: np.random.Generator, tf: float,
                           Tramp: float, w=np.zeros(2)):
        """One excitation trial (``Arm.simulate_rampNhold:866-929``).

        Returns a dict with t, x, alpha, alphadot, y, u, w -- the reference's
        sim struct schema, ready for Data packing.
        """
        t, u = self.ramp_and_hold(rng, tf, Tramp)
        x0 = jnp.zeros(self.cfg.nx)
        X = self.simulate(x0, jnp.asarray(u[:-1]), jnp.asarray(w, jnp.asarray(x0).dtype))
        Y = self.get_y_batch(X)
        return {
            "t": t, "x": np.asarray(X),
            "alpha": np.asarray(X[:, : self.nlinks]),
            "alphadot": np.asarray(X[:, self.nlinks:]),
            "y": np.asarray(Y), "u": u,
            "w": np.tile(np.asarray(w), (len(t), 1)),
        }
