"""Multi-device (virtual 8-CPU mesh) tests: psum EDMD and sharded scenarios."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from koopman_realizations.config import ArmConfig, MpcConfig, SysidConfig
from koopman_realizations.control import Ksim, make_kmpc
from koopman_realizations.models.arm import Arm
from koopman_realizations.models.edmd import Ksysid
from koopman_realizations.ops.lstsq import lstsq
from koopman_realizations.parallel import (
    koopman_gram_sharded,
    make_mesh,
    run_batch_sharded,
)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must force 8 virtual devices"
    return make_mesh(n_data=8)


def test_mesh_shape(mesh):
    assert mesh.shape["data"] == 8


def test_sharded_gram_matches_single_device(arm_dataset, mesh):
    ks = Ksysid(arm_dataset, SysidConfig(model_type="linear",
                                         obs_type=("poly",), obs_degree=(1,)))
    sp = ks.snapshot_pairs
    basis = ks.basis

    def lift_pair(a, b, u):
        return (jnp.concatenate([basis.lift(a), u]),
                jnp.concatenate([basis.lift(b), u]))

    K_sharded = koopman_gram_sharded(lift_pair, sp.alpha, sp.beta, sp.u, mesh)
    Px, Py = ks.lift_snapshot_matrices()
    K_direct = lstsq(Px, Py, refine=0)
    # compare fitted predictions (operators agree only up to the Gram null
    # space when the dictionary is rank-deficient)
    np.testing.assert_allclose(np.asarray(Px @ K_sharded),
                               np.asarray(Px @ K_direct), atol=1e-7)


def test_sharded_gram_padding_has_no_bias(mesh):
    """Row count not divisible by 8: padded rows must not change the fit."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((1001, 5))   # 1001 % 8 != 0
    X_true = rng.standard_normal((5, 5))
    B = A @ X_true

    def lift_pair(a, b, u):
        return a, b

    K = koopman_gram_sharded(lift_pair, A, B, np.zeros((1001, 1)), mesh)
    np.testing.assert_allclose(np.asarray(K), X_true, atol=1e-8)


@pytest.mark.slow
def test_sharded_closed_loop_matches_vmap(arm_dataset, blockM_ref, mesh):
    ks = Ksysid(arm_dataset, SysidConfig(model_type="linear", obs_type=("poly",),
                                         obs_degree=(3,), dim_red=True)
                ).train_models()
    mpc = make_kmpc(ks.model, ks.scaler, MpcConfig(
        horizon=10, input_bounds=(-7 * np.pi / 8, 7 * np.pi / 8),
        input_slopeConst=1e-1, cost_running=10.0, cost_terminal=100.0,
        cost_input=(3e-3, 2e-3, 1e-3), proj_idx=(4, 5)))
    arm = Arm(ArmConfig(Nmods=3, nlinks=1, L=1.0, m=0.1,
                        output_type="markers", substeps=5))
    sim = Ksim(arm, mpc)
    X0 = np.zeros((16, 6))
    X0[:, 0] = np.linspace(-0.2, 0.2, 16)
    res_sharded = run_batch_sharded(sim, blockM_ref["y"], X0, mesh, steps=40)
    res_vmap = sim.run_batch(blockM_ref["y"], X0, steps=40)
    assert res_sharded["alive"].all()
    np.testing.assert_allclose(res_sharded["err"], res_vmap["err"],
                               rtol=1e-7, atol=1e-9)


@pytest.mark.slow
def test_sharding_overhead_bounded(arm_dataset, blockM_ref, mesh):
    """Spreading a small scenario batch over the 8-device mesh must not cost
    more than a generous multiple of the one-device vmap wall (round-2
    verdict: bound the sharding overhead at small B).  Measured on an idle
    virtual mesh the shard_map runner is ~4.6% slower at 1 device and
    FASTER at >=2; 3x absorbs CI noise while still catching a
    pathological re-layout or per-step collective."""
    import time

    import jax

    from koopman_realizations.parallel.scenarios import sharded_batch_runner

    ks = Ksysid(arm_dataset, SysidConfig(model_type="linear", obs_type=("poly",),
                                         obs_degree=(3,), dim_red=True)
                ).train_models()
    mpc = make_kmpc(ks.model, ks.scaler, MpcConfig(
        horizon=10, input_bounds=(-7 * np.pi / 8, 7 * np.pi / 8),
        input_slopeConst=1e-1, cost_running=10.0, cost_terminal=100.0,
        cost_input=(3e-3, 2e-3, 1e-3), proj_idx=(4, 5)))
    arm = Arm(ArmConfig(Nmods=3, nlinks=1, L=1.0, m=0.1,
                        output_type="markers", substeps=5))
    sim = Ksim(arm, mpc)
    B, steps, record = 64, 20, ("Y", "alive")
    X0 = np.zeros((B, 6))
    X0[:, 0] = np.linspace(-0.2, 0.2, B)
    W = np.zeros((B, 2))

    def best_wall(fn, reps=3):
        jax.block_until_ready(fn(X0, W))           # compile + warmup
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(X0, W))
            walls.append(time.perf_counter() - t0)
        return min(walls)

    wall_sh = best_wall(sharded_batch_runner(sim, blockM_ref["y"], mesh,
                                             steps=steps, record=record))
    wall_vm = best_wall(sim.batched_runner(blockM_ref["y"], steps=steps,
                                           record=record))
    assert wall_sh < 3.0 * wall_vm, (
        f"sharded wall {wall_sh * 1e3:.1f} ms > 3x vmap {wall_vm * 1e3:.1f} ms")


def test_feature_sharded_pca_matches_host(rng):
    """Model-axis sharding: top-k PCs of a feature matrix match host PCA."""
    from koopman_realizations.ops.linalg import pca_explained
    from koopman_realizations.parallel.pca_sharded import pca_feature_sharded
    from koopman_realizations.parallel import make_mesh

    mesh = make_mesh(n_data=1, n_model=4)
    # low-rank-ish data: 777 features (not divisible by 4), clear spectrum
    base = rng.standard_normal((300, 6)) @ rng.standard_normal((6, 777))
    X = base + 0.01 * rng.standard_normal((300, 777))
    V, expl = pca_feature_sharded(X, k=6, mesh=mesh, iters=100)
    coeffs, explained = pca_explained(X)
    # subspace agreement via projector difference (signs/rotations within the
    # subspace are arbitrary); the full 6-dim signal subspace is recovered,
    # with the boundary component converging to the spectral-gap floor
    Pv = V @ V.T
    Pr = coeffs[:, :6] @ coeffs[:, :6].T
    assert np.abs(Pv - Pr).max() < 1e-5
    # explained fractions match the top eigenvalue shares
    np.testing.assert_allclose(np.sort(expl)[::-1],
                               (explained[:6] / 100.0), rtol=1e-4)


def test_four_device_phase_on_virtual_mesh(arm_generated, blockM_generated):
    """``chip_smoke.py --four`` at a tiny size: the bench's closed loop
    sharded over a 4-device mesh equals the same lanes on one device (the
    parity bounds of the smoke), and the sharded Gram fit equals the
    one-device fit."""
    import jax

    import bench
    import chip_smoke

    devs = jax.devices()[:4]
    mesh4 = make_mesh(n_data=4, devices=devs)
    mesh1 = make_mesh(n_data=1, devices=devs[:1])
    ks = Ksysid(arm_generated, SysidConfig(
        model_type="bilinear", obs_type=("poly",), obs_degree=(3,),
        dim_red=True, dtype="float32")).train_models()
    mpc = make_kmpc(ks.model, ks.scaler, MpcConfig(
        horizon=10, qp_iters=4, qp_dual_warm=True, input_blocks=(1, 1, 2, 5),
        input_bounds=(-7 * np.pi / 8, 7 * np.pi / 8), input_slopeConst=1e-1,
        cost_running=10.0, cost_terminal=100.0,
        cost_input=(3e-3, 2e-3, 1e-3), proj_idx=(4, 5)))
    sim = Ksim(Arm(ArmConfig(Nmods=3, nlinks=1, L=1.0, m=0.1,
                             output_type="markers", substeps=3,
                             newton_iters=1, jac_mode="step")), mpc)
    ref = np.asarray(blockM_generated["y"])
    steps = 40
    X0, W = bench.lane_inputs(16)
    res = [run_batch_sharded(sim, ref, X0, m, load=W, steps=steps)
           for m in (mesh4, mesh1)]
    chip_smoke.check_parity("4 vs 1 device", *(
        {"Yp": r["Y"][..., [4, 5]], "alive": r["alive"]} for r in res),
        ref, steps)
    assert res[0]["alive"].all()

    ks1 = Ksysid(arm_generated, SysidConfig(model_type="linear",
                                            obs_type=("poly",),
                                            obs_degree=(2,)))
    sp, basis = ks1.snapshot_pairs, ks1.basis

    def lift_pair(a, b, u):
        return (jnp.concatenate([basis.lift(a), u]),
                jnp.concatenate([basis.lift(b), u]))

    K4, K1 = (np.asarray(koopman_gram_sharded(lift_pair, sp.alpha, sp.beta,
                                              sp.u, m))
              for m in (mesh4, mesh1))
    Px, _ = ks1.lift_snapshot_matrices()
    p4, p1 = np.asarray(Px) @ K4, np.asarray(Px) @ K1
    assert np.abs(p4 - p1).max() / np.abs(p1).max() < chip_smoke.GRAM_RTOL
