"""Closed-loop evaluation of a lasso sweep: all candidate models in ONE batch.

The reference trains multiple candidates per lasso value
(``Ksysid.train_models:1344-1389``) and would evaluate them one
``Ksim.run_trial_mpc`` at a time.  Here the bilinear MPC solve is expressed
as a pure function of a per-candidate constants pytree, so the entire closed
loop vmaps over the candidate axis: models x initial conditions run
concurrently on one chip (BASELINE config #3: "lasso sweep training multiple
models in one batch").
"""

from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from koopman_realizations.config import MpcConfig
from koopman_realizations.control.kmpc import (
    BilinearKmpc,
    bilinear_consts,
    bilinear_solve_pure,
)
from koopman_realizations.models.koopman import BilinearModel


def lasso_sweep_closed_loop(ksysid, plant, mpc_cfg: MpcConfig, ref,
                            steps: Optional[int] = None) -> dict:
    """Run the closed loop for EVERY candidate model simultaneously.

    ksysid: a trained Ksysid whose ``candidates`` are bilinear models of
    identical shape (one per lasso value).  Returns per-candidate err/alive.
    """
    cands: List[BilinearModel] = ksysid.candidates
    assert all(isinstance(cd, BilinearModel) for cd in cands), \
        "lasso_sweep_closed_loop currently supports bilinear candidates"
    mpcs = [BilinearKmpc(cd, ksysid.scaler, mpc_cfg) for cd in cands]
    # candidate-INVARIANT consts (constraint rows, cost diagonals, state
    # bounds -- functions of cfg/scaler/dims only) stay unstacked: batching
    # them would make A/r_diag batched under vmap and every sweep QP would
    # form its Newton matrix per lane
    all_consts = [bilinear_consts(m) for m in mpcs]
    SHARED = ("Fj", "cFj", "Qd", "Rd", "sb_lo", "sb_hi")
    shared_consts = {k: all_consts[0][k] for k in SHARED if k in all_consts[0]}
    per_cand = [{k: v for k, v in c.items() if k not in SHARED}
                for c in all_consts]
    consts = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *per_cand)

    mpc0 = mpcs[0]
    Np, m, nproj = mpc0.Np, mpc0.m, mpc0.nproj
    scaler = ksysid.scaler
    basis = ksysid.basis
    ref = np.asarray(ref, float)
    K = ref.shape[0] if steps is None else steps
    ref_padded = jnp.asarray(
        np.concatenate([np.asarray(scaler.ref_down(ref[:K], mpc0.proj_idx)),
                        np.tile(np.asarray(
                            scaler.ref_down(ref[:K], mpc0.proj_idx))[-1:],
                            (Np + 1, 1))], axis=0))

    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    x0 = jnp.zeros((plant.cfg.nx,), dtype)
    y0 = plant.get_y(x0)
    u0 = jnp.zeros((m,), dtype)

    def one(c_var):
        c = {**c_var, **shared_consts}

        def body(carry, k):
            x, y_sc, u_prev, U_plan, alive = carry
            with jax.default_matmul_precision("highest"):
                z = basis.lift(y_sc)
                # 1-based step k: horizon starts at ref[k-1] 0-based
                # (Ksim.m:198-199, same alignment as control.ksim)
                refhor = jax.lax.dynamic_slice(ref_padded, (k - 1, 0),
                                               (Np + 1, nproj))
                U, ok, _ = bilinear_solve_pure(
                    c, z, scaler.u_down(u_prev), refhor, U_plan,
                    Np=Np, m=m, n=mpc0.n, nproj=nproj,
                    qp_iters=mpc_cfg.qp_iters,
                    iters=mpc_cfg.bilinear_iters)
                u_next = scaler.u_up(U[1])
                x_new = plant.simulate_Ts(x, u_prev, jnp.zeros(2, dtype))
                # same freeze rule as Ksim: a diverging integrator must not
                # report as an alive candidate with NaN error
                alive = alive & ok & jnp.all(jnp.isfinite(x_new))
                keep = lambda a, b: jnp.where(alive, a, b)
                x1 = keep(x_new, x)
                y1 = plant.get_y(x1)
                carry = (x1, scaler.y_down(y1), keep(u_next, u_prev),
                         keep(U, U_plan), alive)
                err = jnp.sqrt(jnp.sum(
                    (scaler.ref_up(refhor[0], mpc0.proj_idx)
                     - y1[jnp.asarray(mpc0.proj_idx)]) ** 2))
                return carry, {"err": err, "alive": alive}

        init = (x0, scaler.y_down(y0).astype(dtype), u0,
                jnp.zeros((Np, m), dtype), jnp.asarray(True))
        _, out = jax.lax.scan(body, init, jnp.arange(1, K))
        return out

    out = jax.jit(jax.vmap(one))(consts)
    return {"err": np.asarray(out["err"]),
            "alive": np.asarray(out["alive"]),
            "lasso": [float(cd.lasso) for cd in cands]}
