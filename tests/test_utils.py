"""Data wrangling, naming, and checkpoint round-trip tests."""

import os

import numpy as np
import pytest

from koopman_realizations.config import SysidConfig
from koopman_realizations.models.edmd import Ksysid
from koopman_realizations.types import DataSet, Trial
from koopman_realizations.utils.checkpoint import export_mat, load_model, save_model
from koopman_realizations.utils.data import chop, get_data4sysid, merge_files, resample
from koopman_realizations.utils.naming import auto_rename, model_classname


def _trial(T=100, n=2, m=1, Ts=0.1, seed=0):
    rng = np.random.default_rng(seed)
    return Trial(t=np.arange(T) * Ts, y=rng.standard_normal((T, n)),
                 u=rng.standard_normal((T, m)))


def test_resample():
    tr = _trial(T=101, Ts=0.1)
    r = resample(tr, 0.05)
    assert r.t.shape[0] == 201
    np.testing.assert_allclose(r.y[::2], tr.y, atol=1e-12)


def test_chop():
    tr = _trial(T=100, Ts=0.1)
    parts = chop(tr, num=4, length_s=2.0)
    assert len(parts) == 4
    assert all(p.y.shape[0] == parts[0].y.shape[0] for p in parts)
    np.testing.assert_allclose(parts[1].y[0], tr.y[int(100 / 4 * 1)])


def test_get_data4sysid_and_merge_files():
    ds1 = get_data4sysid([_trial(seed=1)], [_trial(seed=2)])
    ds2 = get_data4sysid([_trial(seed=3)], [_trial(seed=4)])
    merged = merge_files([ds1, ds2])
    assert len(merged.train) == 2 and len(merged.val) == 2


def test_auto_rename(tmp_path):
    p = tmp_path / "model.npz"
    p.write_text("x")
    p2 = auto_rename(str(p))
    assert p2.endswith("model (2).npz")
    open(p2, "w").write("y")
    assert auto_rename(str(p)).endswith("model (3).npz")


def test_model_classname():
    name = model_classname("bilinear", "poly", 3, 6, 3, 0, timestamp="T")
    assert name == "bilinear_poly-3_n-6_m-3_del-0_T"


@pytest.mark.parametrize("model_type", ["linear", "bilinear", "nonlinear"])
def test_checkpoint_roundtrip(tmp_path, arm_dataset, model_type):
    cfg = SysidConfig(model_type=model_type, obs_type=("poly",),
                      obs_degree=(2,), dim_red=True)
    ks = Ksysid(arm_dataset, cfg).train_models()
    path = save_model(str(tmp_path / "mdl"), ks.model, scaler=ks.scaler)
    model2, scaler2 = load_model(path)
    # rollout parity through the reloaded model
    r1 = ks.val_model(ks.model, ks.valdata[0])
    r2 = ks.val_model(model2, ks.valdata[0])
    np.testing.assert_allclose(r1["sim"]["y"], r2["sim"]["y"], rtol=1e-12)
    np.testing.assert_allclose(np.asarray(scaler2.y_factor),
                               np.asarray(ks.scaler.y_factor))


def test_export_mat_layout(tmp_path, arm_dataset):
    import scipy.io as sio

    cfg = SysidConfig(model_type="bilinear", obs_type=("poly",),
                      obs_degree=(2,), dim_red=True)
    ks = Ksysid(arm_dataset, cfg).train_models()
    path = export_mat(str(tmp_path / "mdl"), ks.model)
    d = sio.loadmat(path, squeeze_me=True, struct_as_record=False)["model"]
    NL = ks.model.meta.NL
    assert d.A.shape == (NL, NL)
    assert d.B.shape == (NL, ks.model.meta.m * NL)
    # column-block k of B equals the stored (NL, m, NL) slice [:, k, :]
    np.testing.assert_allclose(d.B[:, :NL], np.asarray(ks.model.B)[:, 0, :])


def test_save_results_mat_roundtrip(tmp_path):
    """Closed-loop results export in the reference's result-struct layout."""
    import scipy.io as sio

    from koopman_realizations.utils.matio import save_results_mat

    results = {"T": np.arange(5) * 0.05, "U": np.zeros((5, 3)),
               "Y": np.ones((5, 6)), "R": np.ones((5, 2)),
               "err": np.full(5, 0.1), "comp_time": np.full(5, 1e-3)}
    path = str(tmp_path / "res.mat")
    save_results_mat(path, results, varname="res_lin")
    d = sio.loadmat(path, squeeze_me=True, struct_as_record=False)
    r = d["res_lin"]
    assert set(r._fieldnames) >= {"T", "U", "Y", "R", "err", "comp_time"}
    np.testing.assert_allclose(np.asarray(r.err), 0.1)


def _mk_trial(T=50, n=1, m=1, rng=None, with_xw=False):
    rng = rng or np.random.default_rng(0)
    t = np.arange(T) * 0.05
    kw = {}
    if with_xw:
        kw = {"x": rng.normal(size=(T, 2)), "w": rng.normal(size=(T, 2))}
    return Trial(t=t, y=rng.normal(size=(T, n)), u=rng.normal(size=(T, m)),
                 **kw)


def test_save_data4sysid_roundtrip(tmp_path):
    """Write-side data4sysid parity (``Rsys.save_data`` layout,
    ``Rsys.m:194-207``): our writer round-trips through our reader."""
    from koopman_realizations.utils.matio import (
        load_data4sysid,
        save_data4sysid,
    )

    rng = np.random.default_rng(3)
    ds = DataSet(train=[_mk_trial(rng=rng, with_xw=True) for _ in range(3)],
                 val=[_mk_trial(rng=rng, with_xw=True)])
    path = str(tmp_path / "rsys-1_train-3_val-1.mat")
    save_data4sysid(path, ds)
    back = load_data4sysid(path)
    assert len(back.train) == 3 and len(back.val) == 1
    np.testing.assert_allclose(back.train[1].y, ds.train[1].y, rtol=1e-12)
    np.testing.assert_allclose(back.val[0].u, ds.val[0].u, rtol=1e-12)
    np.testing.assert_allclose(back.train[0].w, ds.train[0].w, rtol=1e-12)


def test_save_rsys_ensemble_roundtrip(tmp_path):
    """``rsys-i_...`` per-system files + the ``rsys-all`` aggregate
    (``Rsys.m:182-216``) read back with the shipped-schema loaders."""
    from koopman_realizations.utils.matio import (
        load_data4sysid,
        load_rsys_all,
        save_rsys_ensemble,
    )

    rng = np.random.default_rng(5)
    datasets = [DataSet(train=[_mk_trial(rng=rng) for _ in range(4)],
                        val=[_mk_trial(rng=rng)]) for _ in range(3)]
    all_path = save_rsys_ensemble(str(tmp_path / "rand-systems_test"),
                                  datasets)
    assert all_path.endswith("rsys-all_train-4_val-1.mat")
    back = load_rsys_all(all_path)
    assert len(back) == 3
    np.testing.assert_allclose(back[2].train[3].y, datasets[2].train[3].y,
                               rtol=1e-12)
    one = load_data4sysid(str(tmp_path / "rand-systems_test" /
                              "rsys-2_train-4_val-1.mat"))
    np.testing.assert_allclose(one.val[0].y, datasets[1].val[0].y, rtol=1e-12)


def test_save_ref_trajectory_roundtrip(tmp_path):
    """Trajectory writer (``def_trajectory.m:37-40``) matches the shipped
    ref-struct schema bit-for-bit through the loader."""
    from koopman_realizations.utils.matio import (
        load_ref_trajectory,
        save_ref_trajectory,
    )
    from koopman_realizations.utils.trajectories import (
        get_blockM,
        make_trajectory,
    )

    pts = get_blockM([0.45, -0.35], 0.5, 0.5)
    ref = make_trajectory(pts, T=15.0, Ts=0.05, flip_y=True,
                          preamble_from=(0.0, 1.0),
                          name="blockM_roundtrip")
    path = str(tmp_path / "blockM_roundtrip.mat")
    save_ref_trajectory(path, ref)
    back = load_ref_trajectory(path)
    assert back["name"] == "blockM_roundtrip"
    assert back["T"] == 15.0 and back["Ts"] == 0.05
    np.testing.assert_allclose(back["y"], ref["y"], rtol=1e-15)
    np.testing.assert_allclose(back["t"], ref["t"], rtol=1e-15)


def test_roofline_model(arm_generated):
    """The analytic roofline model (utils/roofline.py) must track config
    knobs: FLOPs grow with qp_iters, blocking shrinks both FLOPs and the
    QP IO bytes, and the GEMM subset is a strict subset of the total."""
    from koopman_realizations.config import ArmConfig, MpcConfig
    from koopman_realizations.control import make_kmpc
    from koopman_realizations.utils.roofline import (
        bilinear_step_cost,
        device_peaks,
        roofline_summary,
    )

    ks = Ksysid(arm_generated, SysidConfig(model_type="bilinear",
                                           obs_type=("poly",),
                                           obs_degree=(3,), dim_red=True,
                                           dtype="float32")).train_models()

    def mk(**kw):
        return make_kmpc(ks.model, ks.scaler, MpcConfig(
            horizon=10, input_bounds=(-7 * np.pi / 8, 7 * np.pi / 8),
            input_slopeConst=1e-1, cost_running=10.0, cost_terminal=100.0,
            cost_input=(3e-3, 2e-3, 1e-3), proj_idx=(4, 5), **kw))

    acfg = ArmConfig(Nmods=3, nlinks=1, L=1.0, m=0.1, substeps=3,
                     newton_iters=2, jac_mode="step")
    blocked = bilinear_step_cost(
        mk(qp_iters=3, qp_dual_warm=True, input_blocks=(1, 1, 2, 5)), acfg)
    unblocked = bilinear_step_cost(mk(qp_iters=3, qp_dual_warm=True), acfg)
    more_iters = bilinear_step_cost(
        mk(qp_iters=8, qp_dual_warm=True, input_blocks=(1, 1, 2, 5)), acfg)
    for c in (blocked, unblocked, more_iters):
        assert c["flops_total"] > 0
        assert 0 < c["gemm_flops"] < c["flops_total"]
        assert 0 < c["bytes_min"] < c["bytes_est"]
        assert c["flops_total"] == sum(c["flops"].values())
    assert blocked["flops_total"] < unblocked["flops_total"]
    assert blocked["bytes_min"] < unblocked["bytes_min"]
    assert more_iters["flops_total"] > blocked["flops_total"]

    kind = "NVIDIA H100 80GB HBM3"
    assert device_peaks(kind)["peak_f32"] == 67e12
    roof = roofline_summary(15.3e6, {
        "flops_per_lane_step": blocked["flops_total"],
        "hbm_bytes_per_lane_step_est": blocked["bytes_est"]}, kind)
    assert 0 < roof["f32_frac"] < 1
    assert 0 < roof["hbm_frac_est"] < 1


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB",
                                  "NVIDIA H100 PCIe"])
def test_roofline_unknown_device_is_an_error(kind):
    """A device without published peaks in the table is an error, never a
    silent NaN share."""
    from koopman_realizations.utils.roofline import (
        device_peaks,
        roofline_summary,
    )
    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks(kind)
    with pytest.raises(KeyError):
        roofline_summary(1e6, {"flops_per_lane_step": 1,
                               "hbm_bytes_per_lane_step_est": 1}, kind)


def test_generate_arm_data_is_seeded():
    """The in-repo corpus is a function of its seed: same seed, same
    trials; another seed, another excitation.  Shape class of the
    reference datafile (markers y in R^6, 3 inputs, 20 Hz)."""
    from koopman_realizations.utils.data import generate_arm_data

    a = generate_arm_data(trials=3, tf=4.0, n_val=1, seed=0)
    b = generate_arm_data(trials=3, tf=4.0, n_val=1, seed=0)
    c = generate_arm_data(trials=3, tf=4.0, n_val=1, seed=1)
    assert len(a.train) == 2 and len(a.val) == 1
    tr = a.train[0]
    assert tr.y.shape[1] == 6 and tr.u.shape[1] == 3
    np.testing.assert_allclose(np.diff(tr.t), 0.05, atol=1e-12)
    for x, y in zip(a.train + a.val, b.train + b.val):
        np.testing.assert_array_equal(x.y, y.y)
        np.testing.assert_array_equal(x.u, y.u)
    assert not np.array_equal(a.train[0].u, c.train[0].u)
    assert np.isfinite(tr.y).all()
