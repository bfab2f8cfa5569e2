"""FISTA LASSO certification against an independent oracle at paper scale.

The reference solves the L1-budget Koopman regression as a +/- split
quadprog in 2(N+m)^2 = 15,138 variables (``Ksysid.m:1095-1176``: M-split at
:1112, L1 budget row at :1135-1137, delay pins at :1139-1164).  The
production replacement is projected FISTA (``ops/lasso.py``); these tests
certify it ON THE ACTUAL ARM-SCALE PROBLEM (poly-3, N=84, m=3) against a
method-independent oracle:

- the split QP's Hessian kron(I, Px^T Px) is block-diagonal over the columns
  of K; columns couple only through the shared budget row, so for a fixed
  multiplier each column is an independent lasso solved to machine precision
  by cyclic coordinate descent (``lasso_oracle_penalized``), with bisection
  on the multiplier (``lasso_oracle_constrained``);
- the oracle's own KKT conditions are asserted before it judges FISTA;
- optimality is certified through WEAK DUALITY: for the oracle's (K_o, mu),
  f(K_o) + mu (||K_o||_1 - t) lower-bounds the constrained optimum, so
  f(K_fista) - bound is a rigorous suboptimality certificate.

Calibration (scripts/lasso_cert_proto.py): converged FISTA certifies to
~1e-8 relative; the pre-round-3 default (2000 fixed iterations) left a
2.4e-4 relative gap on this problem, which these bounds reject by >100x.
"""

import numpy as np
import pytest

from koopman_realizations.config import SysidConfig
from koopman_realizations.models.edmd import Ksysid
from koopman_realizations.ops.lasso import (
    lasso_constrained_lstsq_f64,
    lasso_oracle_constrained,
)


def _certify(Px, Py, budget, K_f, pin_mask=None, bisect_steps=8,
             cd_tol=1e-11, bracket=2.0):
    """Oracle solve + KKT self-check; returns the relative duality gap."""
    G, H = Px.T @ Px, Px.T @ Py
    obj = lambda K: float(((Px @ K - Py) ** 2).sum())

    free = np.ones_like(K_f, bool) if pin_mask is None else ~pin_mask
    g = 2.0 * (G @ K_f - H)
    nz = free & (np.abs(K_f) > 1e-9)
    mu_hat = float(np.median(-g[nz] * np.sign(K_f[nz])))
    assert mu_hat > 0  # the budget binds by construction

    K_o, mu = lasso_oracle_constrained(
        G, H, budget, mu_hat / bracket, mu_hat * bracket, K_f,
        pin_mask=pin_mask, bisect_steps=bisect_steps, cd_tol=cd_tol)

    # oracle KKT sanity check for the penalized problem at mu: nonzero
    # entries have gradient -mu*sign (to the CD tolerance; the binding
    # certificate below is the duality gap, not this), zeros are within mu
    g_o = 2.0 * (G @ K_o - H)
    nzo = free & (np.abs(K_o) > 1e-12)
    zo = free & ~nzo
    assert np.abs(g_o[nzo] + mu * np.sign(K_o[nzo])).max() <= 2e-2 * mu
    if zo.any():
        assert np.abs(g_o[zo]).max() <= mu * (1 + 1e-9) + 1e-12

    l1_free_o = float(np.abs(np.where(free, K_o, 0.0)).sum())
    lower = obj(K_o) + mu * (l1_free_o - budget)
    return (obj(K_f) - lower) / obj(K_f)


@pytest.mark.slow
def test_fista_certified_at_paper_scale(arm_dataset):
    """Arm poly-3 config: Px in R^{~12000 x 87}, split-QP decision dim
    15,138 -- the exact problem ``solve_KoopmanQP`` solves for the paper."""
    ks = Ksysid(arm_dataset, SysidConfig(
        model_type="linear", obs_type=("poly",), obs_degree=(3,)))
    Px, Py = (np.asarray(a, np.float64) for a in ks.lift_snapshot_matrices())
    assert Px.shape[1] == 84 + 3                      # N=84, m=3

    K_ls = np.linalg.lstsq(Px, Py, rcond=None)[0]
    budget = 0.5 * np.abs(K_ls).sum()                 # constraint binds

    cfg = SysidConfig()                               # production defaults
    K_f = lasso_constrained_lstsq_f64(Px, Py, budget,
                                      iters=cfg.lasso_iters,
                                      tol=cfg.lasso_tol)
    # budget feasibility (projection is exact up to roundoff)
    assert np.abs(K_f).sum() <= budget * (1 + 1e-12) + 1e-9

    rel_gap = _certify(Px, Py, budget, K_f)
    assert rel_gap < 1e-6, f"FISTA suboptimal: rel duality gap {rel_gap:.3e}"


def test_fista_certified_with_delay_pins(arm_dataset):
    """Delay-constrained variant (``Ksysid.m:1139-1164``): linear model with
    delays pins the shift-structure entries of K to exactly 1; pins must
    hold exactly, consume budget, and the free entries must be optimal."""
    ks = Ksysid(arm_dataset, SysidConfig(
        model_type="linear", obs_type=("poly",), obs_degree=(1,), delays=1))
    Px, Py = (np.asarray(a, np.float64) for a in ks.lift_snapshot_matrices())
    pin = ks._delay_pin_mask(Px.shape[1])
    npins = int(pin.sum())
    assert npins == ks.n + ks.m                       # y- and u-delay blocks

    K_ls = np.linalg.lstsq(Px, Py, rcond=None)[0]
    free_ls = np.abs(np.where(pin, 0.0, K_ls)).sum()
    t = 0.4 * free_ls + npins                         # binds on free entries

    cfg = SysidConfig()
    K_f = lasso_constrained_lstsq_f64(Px, Py, t, pin_mask=pin,
                                      iters=cfg.lasso_iters,
                                      tol=cfg.lasso_tol)
    np.testing.assert_array_equal(np.asarray(K_f)[pin], 1.0)  # pins exact
    free_budget = t - npins
    l1_free = np.abs(np.where(pin, 0.0, K_f)).sum()
    assert l1_free <= free_budget * (1 + 1e-12) + 1e-9

    # the 19x19 pinned problem is cheap: run the oracle to machine precision
    rel_gap = _certify(Px, Py, free_budget, np.asarray(K_f), pin_mask=pin,
                       bisect_steps=50, cd_tol=1e-15, bracket=4.0)
    assert rel_gap < 1e-9, f"pinned FISTA suboptimal: rel gap {rel_gap:.3e}"
