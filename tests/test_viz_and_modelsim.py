"""Visualization writers and the model-in-the-loop simulation."""

import os

import numpy as np
import pytest

from koopman_realizations.config import ArmConfig, MpcConfig, SysidConfig
from koopman_realizations.control import make_kmpc, run_model_simulation
from koopman_realizations.models.arm import Arm
from koopman_realizations.models.edmd import Ksysid
from koopman_realizations.utils import viz


def test_run_model_simulation(arm_dataset, blockM_ref):
    ks = Ksysid(arm_dataset, SysidConfig(model_type="linear",
                                         obs_type=("poly",), obs_degree=(3,),
                                         dim_red=True)).train_models()
    mpc = make_kmpc(ks.model, ks.scaler, MpcConfig(
        horizon=10, input_bounds=(-7 * np.pi / 8, 7 * np.pi / 8),
        input_slopeConst=1e-1, cost_running=10.0, cost_terminal=100.0,
        cost_input=(3e-3, 2e-3, 1e-3), proj_idx=(4, 5)))
    res = run_model_simulation(mpc, blockM_ref["y"], steps=80)
    assert res["alive"].all()
    # the error decays from the (scaled-origin) initial condition and settles
    # in the linear model's own accuracy class
    assert res["err"][-20:].mean() < res["err"][:20].mean() / 3
    assert res["err"][-20:].mean() < 0.25


def test_plot_comparison_and_tracking(tmp_path, arm_dataset):
    ks = Ksysid(arm_dataset, SysidConfig(model_type="linear",
                                         obs_type=("poly",), obs_degree=(1,))
                ).train_models()
    res = ks.val_model(ks.model, ks.valdata[0])
    p1 = viz.plot_comparison(res["sim"]["y"], res["real"]["y"], res["t"],
                             nrmse=res["error"]["nrmse"],
                             path=str(tmp_path / "cmp.png"))
    assert os.path.getsize(p1) > 5000
    p2 = viz.plot_tracking(res["real"]["y"][:, 4:6], res["sim"]["y"][:, 4:6],
                           path=str(tmp_path / "track.png"))
    assert os.path.getsize(p2) > 5000


def test_animate_arm(tmp_path):
    arm = Arm(ArmConfig(Nmods=3, nlinks=1, output_type="markers"))
    t = np.linspace(0, 1, 12)
    alpha = np.stack([0.4 * np.sin(2 * np.pi * t + ph)
                      for ph in (0.0, 0.5, 1.0)], axis=1)
    path = viz.animate_arm(arm, alpha, str(tmp_path / "arm.mp4"), fps=10)
    assert os.path.exists(path)
    assert os.path.getsize(path) > 2000


def test_plot_rand_models_summary(tmp_path):
    results = {fam: {"dims": np.array([2, 4, 8]),
                     "median": np.array([0.5, 0.2, 0.1])}
               for fam in ("linear", "bilinear", "nonlinear")}
    p = viz.plot_rand_models_summary(results, path=str(tmp_path / "sum.png"))
    assert os.path.getsize(p) > 5000


def test_animate_arm_refendeff_and_validation(tmp_path):
    """The ref-vs-end-effector and validation animation variants
    (``Arm.animate_arm_refendeff:656-768``, ``animate_arm_validation:
    771-861``)."""
    import numpy as np

    from koopman_realizations.config import ArmConfig
    from koopman_realizations.models.arm import Arm
    from koopman_realizations.utils import viz

    arm = Arm(ArmConfig(Nmods=2, nlinks=1))
    T = 6
    alpha = np.linspace(0, 0.4, T)[:, None] * np.ones((1, 2))
    ref = np.stack([np.linspace(0.1, 0.4, T), np.linspace(0.8, 0.9, T)], 1)
    p1 = viz.animate_arm_refendeff(arm, alpha, ref,
                                   str(tmp_path / "ee.mp4"), fps=5)
    assert p1.endswith((".mp4", ".gif"))
    markers = np.tile(np.array([[0.1, 0.4, 0.2, 0.8]]), (T, 1))
    p2 = viz.animate_arm_validation(arm, alpha, markers,
                                    str(tmp_path / "val.mp4"), fps=5)
    assert p2.endswith((".mp4", ".gif"))
    # named refvmpc counterpart (``Arm.animate_arm_refvmpc:573-653``)
    p3 = viz.animate_arm_refvmpc(arm, alpha, ref,
                                 str(tmp_path / "rv.mp4"), y_xy=ref, fps=5)
    assert p3.endswith((".mp4", ".gif"))


def test_animate_timeseries(tmp_path):
    """``Data.animate_timeseries`` (``Data.m:146-254``) moving window."""
    import numpy as np

    from koopman_realizations.utils import viz

    t = np.arange(0, 1.0, 0.05)
    data = np.stack([np.sin(6 * t), np.cos(6 * t)], axis=1)
    p = viz.animate_timeseries(t, data, time_window=0.3,
                               path=str(tmp_path / "ts.mp4"), fps=10)
    assert p.endswith((".mp4", ".gif"))
    p2 = viz.animate_timeseries(t, data[:, 0], time_window=0.3,
                                path=str(tmp_path / "ts2.mp4"), fps=10,
                                subplots=True)
    assert p2.endswith((".mp4", ".gif"))
