"""Benchmark: batched closed-loop Koopman-MPC throughput on one GPU.

Pipeline: generate the arm training corpus from a seed and train the
paper's bilinear realization (poly-3, PCA-reduced) on the host CPU, then
run a batch of closed-loop 20 Hz MPC scenarios on the accelerator -- lift,
condensed QP by a fixed-iteration interior point, SDIRK2 arm plant step,
one scan over the whole blockM reference -- and measure MPC steps/s.

Baseline: the reference's K-BMPC solves one 50 ms control step in 9.6 ms of
MATLAB quadprog time (BASELINE.md) => ~104 closed-loop MPC steps/s on a
desktop CPU.  vs_baseline = our steps/s / 104.

Run:  python bench.py [--batch B] [--steps K] [--qp-iters N]
Prints exactly one JSON line on stdout.  Exits non-zero, printing no
result, when JAX sees no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
BASELINE_STEPS_PER_S = 1.0 / 0.0096   # reference bilinear comp_time mean

# Shipping controller: horizon 10, input move blocking (1,1,2,5) -- a
# condensed QP of 12 variables and 48 rows -- with qp_iters=4 and the
# receding-horizon dual warm start; SDIRK2 plant at substeps=3 with one
# chord-Newton iteration per stage and one Jacobian per control period.
QP_ITERS = 4
STEPS = 301                  # the whole 15 s blockM reference at 20 Hz
BATCH = 262144

# Tracking-error gate of the shipping configuration on the generated
# corpus: a converged run (qp_iters=20) of the same model at full width,
# plus a margin for the 4-iteration RTI solve (see PERF.md).
ERR_GATE = 0.0324


def setup_compile_cache():
    """Persistent compile cache: ``$JAX_COMPILATION_CACHE_DIR`` when set,
    else ``<repo>/.jax_cache`` (a fixed path, so repeated runs hit)."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or \
        os.path.join(REPO, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)


def require_gpu():
    """Stop the process unless JAX sees a GPU: a measurement taken on the
    CPU is not a measurement of this program."""
    import jax

    if not any(d.platform == "gpu" for d in jax.devices()):
        sys.exit(f"no GPU among JAX devices {jax.devices()}; refusing to "
                 f"measure on the CPU")


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def build_sim(qp_iters: int = QP_ITERS, seed: int = 0):
    """Train the bench model on the generated corpus and build the closed
    loop.  Returns (Ksim, blockM reference (K, 2))."""
    import jax

    from koopman_realizations.config import (
        ArmConfig,
        MpcConfig,
        SysidConfig,
    )
    from koopman_realizations.control import Ksim, make_kmpc
    from koopman_realizations.models.arm import Arm
    from koopman_realizations.models.edmd import Ksysid
    from koopman_realizations.utils.data import generate_arm_data
    from koopman_realizations.utils.trajectories import (
        get_blockM,
        make_trajectory,
    )

    ds = generate_arm_data(seed=seed)
    ref = make_trajectory(get_blockM([0.45, -0.35], 0.5, 0.5), T=15.0,
                          Ts=0.05, flip_y=True)
    # train on the host CPU (one-time; f32 is fine for the rollout)
    with jax.default_device(jax.devices("cpu")[0]):
        ks = Ksysid(ds, SysidConfig(model_type="bilinear", obs_type=("poly",),
                                    obs_degree=(3,), dim_red=True,
                                    dtype="float32")).train_models()
    mpc = make_kmpc(ks.model, ks.scaler, MpcConfig(
        horizon=10, qp_iters=qp_iters, qp_dual_warm=True,
        qp_dual_shift=False, input_blocks=(1, 1, 2, 5),
        input_bounds=(-7 * np.pi / 8, 7 * np.pi / 8),
        input_slopeConst=1e-1,
        cost_running=10.0, cost_terminal=100.0,
        cost_input=(0.1 * 3e-2, 0.1 * 2e-2, 0.1 * 1e-2),
        proj_idx=(4, 5),
    ))
    arm = Arm(ArmConfig(Nmods=3, nlinks=1, L=1.0, m=0.1,
                        output_type="markers", substeps=3, newton_iters=1,
                        jac_mode="step"))
    return Ksim(arm, mpc), np.asarray(ref["y"])


def lane_inputs(batch: int):
    """Scenario lanes: initial first-joint angle spread over [-0.2, 0.2],
    no load."""
    X0 = np.zeros((batch, 6), np.float32)
    X0[:, 0] = np.linspace(-0.2, 0.2, batch)
    W = np.zeros((batch, 2), np.float32)
    return X0, W


def lane_errors(out, ref_y, steps: int) -> np.ndarray:
    """Per-lane mean tracking error over the run.  The error row at step k
    compares the measured y_{k+1} with reference row k (``Ksim.m:199,254``):
    R_k = the input reference row through the scale round trip."""
    Yl = np.asarray(out["Yp"])
    Rl = np.broadcast_to(np.asarray(ref_y, np.float32)[None, : steps - 1],
                         Yl.shape)
    return np.sqrt(((Yl - Rl) ** 2).sum(-1)).mean(axis=1)


def time_runner(fn, X0, W, reps: int = 7):
    """Compile (first call), then the median wall of ``reps`` calls, each
    ending in ``block_until_ready``.  Returns (compile_s, median_s, out)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(X0, W))
    compile_s = time.perf_counter() - t0
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(X0, W))
        walls.append(time.perf_counter() - t0)
    return compile_s, float(np.median(walls)), out


def run_closed_loop(sim, ref_y, batch: int, steps: int, reps: int = 7):
    """Build, compile and time the closed loop (``Ksim.batched_runner``,
    recording only what the metrics read).  Returns (out, info) with info
    = {"compile_s", "wall_s", "steps_per_s", "alive_fraction", "err_mean",
    "err_worst"}."""
    X0, W = lane_inputs(batch)
    fn = sim.batched_runner(ref_y, steps=steps, record=("Yp", "alive"))
    compile_s, dt, out = time_runner(fn, X0, W, reps)
    lane_err = lane_errors(out, ref_y, steps)
    return out, {
        "compile_s": compile_s, "wall_s": dt,
        "steps_per_s": batch * (steps - 1) / dt,
        "alive_fraction": float(np.asarray(out["alive"])[:, -1].mean()),
        "err_mean": float(lane_err.mean()),
        "err_worst": float(lane_err.max()),
    }


def check_gates(info: dict, qp_iters: int, steps: int):
    """Every lane alive; the shipping configuration over the whole
    reference inside ``ERR_GATE``.  Raises RuntimeError otherwise."""
    # a silent lane loss would inflate steps/s
    if info["alive_fraction"] != 1.0:
        raise RuntimeError(f"alive_fraction {info['alive_fraction']} != 1.0")
    if qp_iters == QP_ITERS and steps == STEPS \
            and info["err_mean"] > ERR_GATE:
        raise RuntimeError(f"err_mean {info['err_mean']} exceeds the gate "
                           f"{ERR_GATE} of the shipping configuration")


def measure(batch: int = BATCH, steps: int = STEPS, qp_iters: int = QP_ITERS,
            reps: int = 7, sim=None, ref_y=None) -> dict:
    """Run the benchmark and return its result dict (``check_gates``
    applied)."""
    import jax

    if sim is None:
        sim, ref_y = build_sim(qp_iters)
    _, info = run_closed_loop(sim, ref_y, batch, steps, reps)
    check_gates(info, qp_iters, steps)
    steps_per_s = info["steps_per_s"]

    from koopman_realizations.utils.roofline import bilinear_step_cost
    cost = bilinear_step_cost(sim.mpc, sim.plant.cfg)
    dev = jax.devices()[0]
    return {
        "metric": "kmpc_bilinear_closed_loop_steps_per_s_per_chip",
        "value": steps_per_s,
        "unit": "mpc_steps/s",
        "vs_baseline": steps_per_s / BASELINE_STEPS_PER_S,
        "detail": {
            "batch": batch, "steps": steps, "qp_iters": qp_iters,
            **{k: v for k, v in info.items() if k != "steps_per_s"},
            "platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "amortized_us_per_lane_step": 1e6 / steps_per_s,
            "flops_per_lane_step": cost["flops_total"],
            "hbm_bytes_per_lane_step_est": cost["bytes_est"],
        },
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--qp-iters", type=int, default=QP_ITERS)
    args = ap.parse_args(argv)
    require_gpu()
    setup_compile_cache()
    result = measure(args.batch, args.steps, args.qp_iters)
    from koopman_realizations.utils.roofline import roofline_summary
    roof = roofline_summary(result["value"], result["detail"],
                            result["detail"]["device_kind"])
    result["detail"]["hbm_frac_est"] = roof["hbm_frac_est"]
    result["detail"]["f32_frac"] = roof["f32_frac"]
    result["detail"]["card"] = card()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
