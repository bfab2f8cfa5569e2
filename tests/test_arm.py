"""Tests for the JAX arm plant against the shipped reference trajectories."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from koopman_realizations.config import ArmConfig
from koopman_realizations.models.arm import Arm
from koopman_realizations.ops.integrators import rk4, rk45, sdirk2


def shipped_arm():
    # parameters stored inside the shipped datafile's trial params
    return Arm(ArmConfig(Nmods=3, nlinks=1, L=1.0, m=0.1, k=-1e-5, d=10.0,
                         ku=10.0, Ts=0.05, output_type="markers", substeps=5))


def test_sensing_parity_with_shipped_data(arm_dataset):
    arm = shipped_arm()
    tr = arm_dataset.train[0]
    Y = np.asarray(arm.get_y_batch(jnp.asarray(np.asarray(tr.x)[:200])))
    np.testing.assert_allclose(Y, np.asarray(tr.y)[:200], atol=1e-12)


def test_one_step_parity_with_shipped_data(arm_dataset):
    """simulate_Ts reproduces the ode45-generated transitions.

    Note the shipped datafile's input alignment: x[k+1] = step(x[k], u[k+1])
    (the stored u table is shifted one step versus the input applied during
    the step -- verified empirically; on steps where u is constant the match
    is ~1e-7).
    """
    arm = shipped_arm()
    tr = arm_dataset.train[0]
    X, U = np.asarray(tr.x), np.asarray(tr.u)
    sl = np.arange(0, 1000, 7)
    step = jax.jit(jax.vmap(lambda x, u: arm.simulate_Ts(x, u)))
    x1 = np.asarray(step(jnp.asarray(X[sl]), jnp.asarray(U[sl + 1])))
    err_alpha = np.abs(x1[:, :3] - X[sl + 1, :3]).max()
    assert err_alpha < 1e-4


def test_rk4_unstable_sdirk2_stable(arm_dataset):
    """The plant is stiff: explicit RK4 at 10 substeps diverges, SDIRK2 holds."""
    tr = arm_dataset.train[0]
    x = jnp.asarray(np.asarray(tr.x)[500])
    u = jnp.asarray(np.asarray(tr.u)[501])
    arm_rk4 = Arm(ArmConfig(Nmods=3, nlinks=1, L=1.0, m=0.1,
                            output_type="markers", integrator="rk4", substeps=10))
    arm_imp = shipped_arm()
    bad = np.asarray(arm_rk4.simulate_Ts(x, u))
    good = np.asarray(arm_imp.simulate_Ts(x, u))
    assert not np.all(np.isfinite(bad)) or np.abs(bad).max() > 1e3
    assert np.all(np.isfinite(good)) and np.abs(good).max() < 1e2


def test_closed_form_mass_matrix_matches_autodiff():
    """The trig closed form equals the reference-style Jacobian products."""
    rng = np.random.default_rng(3)
    for N, w in [(2, [0.0, 0.0]), (3, [0.9, -0.7]), (5, [1.0, 0.3])]:
        arm = Arm(ArmConfig(Nmods=N, nlinks=1, L=1.0, m=0.1,
                            output_type="angles"))
        for _ in range(5):
            a = jnp.asarray(rng.uniform(-2, 2, N))
            wv = jnp.asarray(np.asarray(w))
            np.testing.assert_allclose(
                np.asarray(arm.mass_matrix(a, wv)),
                np.asarray(arm._mass_matrix_autodiff(a, wv)), atol=1e-12)


def test_energy_conservation_unforced():
    """With no damping/servo/springs, total energy is conserved."""
    cfg = ArmConfig(Nmods=2, nlinks=1, L=1.0, m=0.1, k=0.0, d=0.0, ku=0.0,
                    output_type="angles", substeps=50, integrator="rk4")
    arm = Arm(cfg)
    x0 = jnp.asarray(np.concatenate([[0.4, -0.3], [0.0, 0.0]]))
    u = jnp.zeros(2)
    w = jnp.zeros(2)

    def energy(x):
        a, ad = x[:2], x[2:]
        ke = 0.5 * ad @ (arm.mass_matrix(a, w) @ ad)
        return float(ke + arm.potential_energy(a, w))

    e0 = energy(x0)
    x = x0
    for _ in range(20):
        x = arm.simulate_Ts(x, u, w)
    assert abs(energy(x) - e0) < 1e-6 * max(1.0, abs(e0))


def test_output_types_shapes():
    for ot, dim in [("angles", 3), ("markers", 6), ("endeff", 2), ("shape", 6)]:
        arm = Arm(ArmConfig(Nmods=3, nlinks=1, output_type=ot))
        y = arm.get_y(jnp.asarray(np.r_[0.1, -0.2, 0.3, 0.0, 0.0, 0.0]))
        assert y.shape == (dim,), ot


def test_endeff_is_last_marker():
    arm_m = Arm(ArmConfig(Nmods=3, nlinks=1, output_type="markers"))
    arm_e = Arm(ArmConfig(Nmods=3, nlinks=1, output_type="endeff"))
    x = jnp.asarray(np.r_[0.2, 0.1, -0.4, 0.0, 0.0, 0.0])
    np.testing.assert_allclose(np.asarray(arm_e.get_y(x)),
                               np.asarray(arm_m.get_y(x))[-2:])


def test_ramp_and_hold_bounds(rng):
    arm = Arm(ArmConfig(Nmods=3, nlinks=1, umax=1.0))
    t, u = arm.ramp_and_hold(rng, tf=10.0, Tramp=2.0)
    assert t.shape[0] == u.shape[0] == 201
    assert np.abs(u).max() <= 1.0 + 1e-12


def test_simulate_rampNhold_trial_schema(rng):
    arm = Arm(ArmConfig(Nmods=2, nlinks=1, L=0.75, m=0.3, output_type="markers",
                        substeps=5))
    sim = arm.simulate_rampNhold(rng, tf=1.0, Tramp=0.5)
    assert sim["y"].shape == (21, 4)
    assert sim["x"].shape == (21, 4)
    assert sim["u"].shape == (21, 2)
    assert np.all(np.isfinite(sim["x"]))


def test_integrators_agree_on_smooth_ode():
    f = lambda x: jnp.stack([x[1], -x[0]])   # harmonic oscillator
    x0 = jnp.asarray([1.0, 0.0])
    xa = np.asarray(rk4(f, x0, 1.0, 100))
    xb = np.asarray(rk45(f, x0, 1.0, rtol=1e-9, atol=1e-12))
    xc = np.asarray(sdirk2(f, x0, 1.0, 200, newton_iters=4))
    truth = np.array([np.cos(1.0), -np.sin(1.0)])
    np.testing.assert_allclose(xa, truth, atol=1e-8)
    np.testing.assert_allclose(xb, truth, atol=1e-7)
    np.testing.assert_allclose(xc, truth, atol=1e-4)
