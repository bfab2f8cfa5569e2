"""Load estimation from past measurements (reference ``Kmpc.estimate_load_*``).

The loaded Koopman realization's lifted state is [g; w1 g; ...; w_nw g], so
over a past horizon the dynamics are linear in [1; w]:

    zeta_{i+1} ~= A_z Omega(zeta_i) [1; w] + B_z u_i      (linear model)
    zeta_{i+1} ~= (A_z + sum_j u_ij B_zj) Omega(zeta_i) [1; w]   (bilinear)

with Omega(zeta) = kron(I_{nw+1}, g(zeta)) and A_z/B_z the first-nzeta rows
(``estimate_load_linear:1298-1357``, ``estimate_load_bilinear:1360-1445``).
The reference solves this with ``lsqlin`` under an equality w0 = 1, a box
[-1, 1], and -- in the linear variant only -- a debug equality pinning the
LAST load component to zero (``Kmpc.m:1349``); all reproduced here as a tiny
box QP (``ops.qp``), evaluated every ``load_obs_period`` steps inside the
closed-loop scan.

Delays: the reference builds the regression's zeta rows through
``get_zeta`` (``Kmpc.m:1315,1377``), which embeds ``nd`` delay taps
(``Kmpc.m:389-400``) -- the estimators are delay-generic even though a
stale comment at ``Kmpc.m:1305`` claims otherwise.  Here the embedded
rows build from the closed-loop trailing windows with static gathers;
``load_obs_horizon`` counts regression EQUATIONS (the window must hold
``hor + nd + 1`` measurement rows; the reference's ``hor_y`` rows give
``hor_y - nd - 1`` equations, so hor = hor_y - nd - 1 maps exactly).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from koopman_realizations.models.koopman import BilinearModel
from koopman_realizations.ops.qp import solve_qp


def make_load_observer(model, cfg):
    """Build observer(k, ywin, uwin, what_prev) -> what (scaled space).

    ywin/uwin are the closed-loop trailing windows (rows oldest..newest,
    scaled); the last ``load_obs_horizon + 1`` rows feed the regression.
    Between update steps (k % load_obs_period != 0) the previous estimate is
    returned unchanged (``Ksim.m:185-193``).
    """
    meta = model.meta
    nd = meta.nd
    nw = meta.nw
    if nw == 0:
        raise ValueError("model has no loads (nw == 0)")
    N = meta.N
    nzeta = meta.nzeta
    hor = cfg.load_obs_horizon
    period = max(int(cfg.load_obs_period), 1)
    basis = model.basis
    bilinear = isinstance(model, BilinearModel)
    pin_last = not bilinear            # the linear variant's debug equality

    A3 = jnp.asarray(np.asarray(model.A))[:nzeta].reshape(nzeta, nw + 1, N)
    if bilinear:
        B3 = jnp.asarray(np.asarray(model.B))[:nzeta]     # (nzeta, m, NL)
        B4 = B3.reshape(nzeta, meta.m, nw + 1, N)
    else:
        Bz = jnp.asarray(np.asarray(model.B))[:nzeta]     # (nzeta, m)

    nfree = nw - 1 if pin_last else nw
    box_A = jnp.concatenate([jnp.eye(nfree), -jnp.eye(nfree)], axis=0)
    box_b = jnp.ones(2 * nfree)
    slope = cfg.load_obs_slope          # |w_j - w_prev_j| <= slope (optional)

    def embed_zetas(ywin, uwin):
        """Delay-embedded zeta rows for the last hor+1 measurement times
        (``get_zeta`` semantics; same tap order as ``Ksim.make_body``:
        current y, then y delays newest-first, then u delays)."""
        if nd == 0:
            return ywin[-(hor + 1):]
        W = ywin.shape[0]
        rows = []
        for t in range(hor + 1):
            i = W - 1 - hor + t
            parts = [ywin[i]]
            for j in range(1, nd + 1):
                parts.append(ywin[i - j])
            for j in range(1, nd + 1):
                parts.append(uwin[i - j])
            rows.append(jnp.concatenate(parts))
        return jnp.stack(rows)

    def estimate(ywin, uwin, what_prev=None):
        zetas = embed_zetas(ywin, uwin)        # (hor+1, nzeta)
        us = uwin[-(hor + 1):]
        g = jax.vmap(basis.lift)(zetas[:-1])   # (hor, N)
        if bilinear:
            # M_i = A3 + sum_j u_ij B4[:, j]: (hor, nzeta, nw+1, N)
            M = A3[None] + jnp.einsum("hm,zmwN->hzwN", us[:-1], B4)
            C = jnp.einsum("hzwN,hN->hzw", M, g)
            d = zetas[1:]
        else:
            C = jnp.einsum("zwN,hN->hzw", A3, g)
            d = zetas[1:] - us[:-1] @ Bz.T
        C = C.reshape(hor * nzeta, nw + 1)
        d = d.reshape(hor * nzeta)
        # eliminate w0 = 1; optionally pin the last component to 0
        Cw = C[:, 1: 1 + nfree]
        resid = d - C[:, 0]
        P = 2.0 * Cw.T @ Cw + 1e-9 * jnp.eye(nfree, dtype=C.dtype)
        q = -2.0 * Cw.T @ resid
        Ac = box_A.astype(C.dtype)
        bc = box_b.astype(C.dtype)
        if slope is not None and what_prev is not None:
            # slope constraint vs the previous estimate (``Kmpc.m:1341-1344``:
            # with w0 = 1 the rows reduce to |w_j - w_prev_j| <= slope)
            wp = what_prev[:nfree]
            Ac = jnp.concatenate([Ac, jnp.eye(nfree, dtype=C.dtype),
                                  -jnp.eye(nfree, dtype=C.dtype)], axis=0)
            bc = jnp.concatenate([bc, slope + wp, slope - wp])
        sol = solve_qp(P, q, Ac, bc, iters=15)
        w_free = jnp.where(sol.ok, sol.x, jnp.zeros_like(sol.x))
        if pin_last:
            return jnp.concatenate([w_free, jnp.zeros((1,), C.dtype)])
        return w_free

    def observer(k, ywin, uwin, what_prev):
        # warmup: need a full horizon of real data before trusting estimates.
        # lax.cond (not where) so load_obs_period > 1 actually SKIPS the
        # estimate QP on off-cadence steps -- k is shared across vmapped
        # lanes (scan xs, unbatched), so the branch stays a real branch
        update = ((k % period) == 0) & (k > hor + nd)
        return jax.lax.cond(update,
                            lambda: estimate(ywin, uwin, what_prev),
                            lambda: what_prev)

    observer.estimate = estimate
    observer.horizon = hor
    return observer


def validate_observer(model, cfg, valtrial, sparse_period: int = 0) -> dict:
    """Run the observer over an open-loop validation trial.

    Mirrors ``Ksysid.val_observer_load:2033-2076`` (and the sparse variant
    ``:2079-2139`` when ``sparse_period > 0``, which updates every
    ``sparse_period`` steps and reports the running mean of all estimates).
    Returns {what [T, nw], wreal [T, nw], werr [T, nw]} in scaled space.
    """
    import numpy as np

    obs = make_load_observer(model, cfg)
    hor = cfg.load_obs_horizon
    nd = model.meta.nd
    back = hor + nd                  # window rows behind the current time
    y = np.asarray(valtrial.y)
    u = np.asarray(valtrial.u)
    wreal = np.asarray(valtrial.w)
    T = y.shape[0]
    nw = wreal.shape[1]
    what = np.zeros((T, nw))
    est_jit = jax.jit(obs.estimate)
    history = []
    for i in range(T - 1):
        if i < back:
            what[i + 1] = what[i]
            continue
        if sparse_period and (i % sparse_period) != 0:
            what[i + 1] = what[i]
            continue
        ywin = jnp.asarray(y[i - back: i + 1])
        uwin = jnp.asarray(u[i - back: i + 1])
        if cfg.load_obs_slope is not None:
            w_i = np.asarray(est_jit(ywin, uwin, jnp.asarray(what[i])))
        else:
            w_i = np.asarray(est_jit(ywin, uwin))
        if sparse_period:
            history.append(w_i)          # running mean (Ksysid.m:2127-2128)
            what[i + 1] = np.mean(history, axis=0)
        else:
            what[i + 1] = w_i
    return {"what": what, "wreal": wreal, "werr": np.abs(wreal - what)}
