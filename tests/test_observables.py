"""Tests for the observable-dictionary engine.

Parity targets are the structural invariants of ``Ksysid.def_observables``:
basis ordering, sizes, compositions, and the partitions.m monomial order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from koopman_realizations.config import SysidConfig
from koopman_realizations.ops.observables import (
    KoopmanBasis,
    build_basis,
    delay_embed,
    partitions_ones,
    poly_exponents,
    zeta_from_window,
)


def test_partitions_order_matches_matlab():
    # partitions(1, ones(1,3)) -> identity in order (partitions.m recursion)
    np.testing.assert_array_equal(
        partitions_ones(1, 3), np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]])
    )
    # partitions(2, ones(1,2)): loop i=0..2 over last element
    np.testing.assert_array_equal(
        partitions_ones(2, 2), np.array([[2, 0], [1, 1], [0, 2]])
    )


def test_poly_exponents_count_and_identity_prefix():
    E = poly_exponents(9, 3)
    # C(12,3) - 1 = 219 monomials of degree 1..3 over 9 vars
    assert E.shape == (219, 9)
    np.testing.assert_array_equal(E[:9], np.eye(9, dtype=np.int32))
    assert E.sum(axis=1).max() == 3


def test_poly_basis_dimensions_paper_config():
    # paper config: n=6, m=3, delays=0, poly deg 3 => N = C(9,3) = 84
    cfg = SysidConfig(model_type="linear", obs_type=("poly",), obs_degree=(3,))
    basis = build_basis(cfg, n=6, m=3)
    assert basis.nzeta == 6
    assert basis.N == 84
    z = np.linspace(-0.9, 0.9, 6)
    g = basis.lift(z)
    assert g.shape == (84,)
    # first nzeta entries are zeta itself; last is the constant 1
    np.testing.assert_allclose(np.asarray(g[:6]), z)
    assert float(g[-1]) == 1.0


def test_poly_lift_values():
    cfg = SysidConfig(obs_type=("poly",), obs_degree=(2,))
    basis = build_basis(cfg, n=2, m=1)
    z = np.array([0.5, -0.25])
    g = np.asarray(basis.lift(z))
    # order: z1, z2, then degree-2 monomials in partitions order
    # partitions(2, ones(1,2)) = [[2,0],[1,1],[0,2]] -> z1^2, z1 z2, z2^2
    expect = np.array([0.5, -0.25, 0.25, -0.125, 0.0625, 1.0])
    np.testing.assert_allclose(g, expect)


def test_bilinear_lift_composition():
    cfg = SysidConfig(model_type="bilinear", obs_type=("poly",), obs_degree=(2,))
    basis = build_basis(cfg, n=2, m=2)
    z = np.array([0.3, -0.4])
    u = np.array([0.7, -0.1])
    g = np.asarray(basis.lift(z))
    gi = np.asarray(basis.lift_input(z, u))
    assert gi.shape == (basis.N * 3,)
    np.testing.assert_allclose(gi[: basis.N], g)
    np.testing.assert_allclose(gi[basis.N: 2 * basis.N], u[0] * g)
    np.testing.assert_allclose(gi[2 * basis.N:], u[1] * g)


def test_loaded_lift_composition():
    cfg = SysidConfig(obs_type=("poly",), obs_degree=(1,), loaded=True)
    basis = build_basis(cfg, n=2, m=1, nw=2)
    z = np.array([0.2, 0.9])
    w = np.array([-0.5, 0.25])
    g = np.asarray(basis.lift(z))
    gl = np.asarray(basis.lift_loaded(z, w))
    assert gl.shape == (basis.N * 3,)
    np.testing.assert_allclose(gl[basis.N: 2 * basis.N], w[0] * g)
    np.testing.assert_allclose(gl[2 * basis.N:], w[1] * g)


def test_nonlinear_basis_includes_input():
    cfg = SysidConfig(model_type="nonlinear", obs_type=("poly",), obs_degree=(2,))
    basis = build_basis(cfg, n=2, m=1)
    assert basis.nzeta == 2
    assert basis.nzeta_aug == 3
    # N = C(3+2,2) = 10 over [zeta; u]
    assert basis.N == 10
    zu = np.array([0.1, 0.2, 0.3])
    g = basis.lift(zu)
    np.testing.assert_allclose(np.asarray(g[:3]), zu)


def test_fourier_dimensions_and_values():
    cfg = SysidConfig(obs_type=("fourier",), obs_degree=(1,))
    basis = build_basis(cfg, n=2, m=1)
    # (1+2d)^nzeta - 1 = 3^2 - 1 = 8 features + nzeta + const
    assert basis.N == 2 + 8 + 1
    z = np.array([0.2, -0.3])
    g = np.asarray(basis.lift(z))
    c1, s1 = np.cos(2 * np.pi * z[0]), np.sin(2 * np.pi * z[0])
    c2, s2 = np.cos(2 * np.pi * z[1]), np.sin(2 * np.pi * z[1])
    # kron([1,c1,s1],[1,c2,s2]) drop first: [c2,s2, c1,c1c2,c1s2, s1,s1c2,s1s2]
    expect = np.array([c2, s2, c1, c1 * c2, c1 * s2, s1, s1 * c2, s1 * s2])
    np.testing.assert_allclose(g[2:-1], expect, atol=1e-12)


def test_fourier_sparser_values():
    cfg = SysidConfig(obs_type=("fourier_sparser",), obs_degree=(1,))
    basis = build_basis(cfg, n=2, m=1)
    z = np.array([0.15, -0.4])
    g = np.asarray(basis.lift(z))
    # multipliers = partitions(1, ones(1,4)): sin(z1), sin(z2), cos(z1), cos(z2)
    expect = np.array([
        np.sin(2 * np.pi * z[0]), np.sin(2 * np.pi * z[1]),
        np.cos(2 * np.pi * z[0]), np.cos(2 * np.pi * z[1]),
    ])
    np.testing.assert_allclose(g[2:-1], expect, atol=1e-12)


def test_gaussian_lift():
    cfg = SysidConfig(obs_type=("gaussian",), obs_degree=(5,), seed=3)
    basis = build_basis(cfg, n=2, m=1)
    assert basis.N == 2 + 5 + 1
    assert basis.gaussian_centers.shape == (2, 5)
    z = np.array([0.0, 0.0])
    g = np.asarray(basis.lift(z))
    expect = np.exp(-np.sum(basis.gaussian_centers ** 2, axis=0))
    np.testing.assert_allclose(g[2:-1], expect)


def test_hermite_lift_values():
    cfg = SysidConfig(obs_type=("hermite",), obs_degree=(2,))
    basis = build_basis(cfg, n=1, m=1)
    z = np.array([0.5])
    g = np.asarray(basis.lift(z))
    # orders: [1], [2] -> H1(z)=2z, H2(z)=4z^2-2
    np.testing.assert_allclose(g[1:-1], [2 * 0.5, 4 * 0.25 - 2], atol=1e-12)


def test_econ_basis_with_pcs():
    cfg = SysidConfig(obs_type=("poly",), obs_degree=(3,))
    basis = build_basis(cfg, n=6, m=3)
    rng = np.random.default_rng(0)
    pcs = rng.standard_normal((basis.N_full, 10))
    econ = basis.with_pcs(pcs)
    assert econ.N == 6 + 10 + 1
    z = rng.uniform(-1, 1, 6)
    g = np.asarray(econ.lift(z))
    gf = np.asarray(basis.lift_full(z))
    np.testing.assert_allclose(g[:6], z)
    np.testing.assert_allclose(g[6:-1], pcs.T @ gf, rtol=1e-10)
    assert g[-1] == 1.0


def test_delay_embed_layout():
    T, n, m, nd = 6, 2, 1, 2
    y = np.arange(T * n, dtype=float).reshape(T, n)
    u = 100 + np.arange(T * m, dtype=float).reshape(T, m)
    zeta, uz = delay_embed(y, u, nd)
    assert zeta.shape == (T - nd, n * (nd + 1) + m * nd)
    # row 0 corresponds to time index nd: [y2, y1, y0, u1, u0]
    np.testing.assert_allclose(zeta[0], np.concatenate([y[2], y[1], y[0], u[1], u[0]]))
    np.testing.assert_allclose(uz[0], u[2])
    # jit-friendly rolling-window version agrees
    zw = zeta_from_window(y[: nd + 1], u[: nd + 1], nd)
    np.testing.assert_allclose(np.asarray(zw), zeta[0])


def test_lift_is_jittable_and_vmappable():
    cfg = SysidConfig(obs_type=("poly",), obs_degree=(3,))
    basis = build_basis(cfg, n=6, m=3)
    zs = np.random.default_rng(1).uniform(-1, 1, (32, 6))
    lift_b = jax.jit(jax.vmap(basis.lift))
    G = np.asarray(lift_b(zs))
    assert G.shape == (32, 84)
    np.testing.assert_allclose(G[7], np.asarray(basis.lift(zs[7])), rtol=1e-12)
