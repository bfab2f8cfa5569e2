"""Timing and profiling helpers (reference: tic/toc ``comp_time``).

The reference instruments its real-time budget with tic/toc around each MPC
solve (``Ksim.m:205-217``), recorded as ``results.comp_time``.  Under jit the
whole closed loop is one XLA program, so the equivalents are:

- ``step_time``: wall-clock per control step of a compiled runner, averaged
  over repetitions (fills the comp_time-compatible field),
- ``profile_trace``: a jax.profiler trace context for per-kernel timing in
  TensorBoard / xprof.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax
import numpy as np


def step_time(fn: Callable, args: tuple, n_steps: int, reps: int = 3) -> dict:
    """Measure mean wall time per control step of a compiled runner.

    Returns {mean, median, max, total_s} in seconds per step, matching the
    summary statistics the reference reports for ``comp_time`` (BASELINE.md
    rows are mean/median/max of that field).
    """
    out = jax.block_until_ready(fn(*args))        # compile + warmup
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) / n_steps)
    times = np.asarray(times)
    return {"mean": float(times.mean()), "median": float(np.median(times)),
            "max": float(times.max()), "total_s": float(times.sum() * n_steps)}


def phase_breakdown(sim, ref, B: int = 4096, steps: int = 12,
                    reps: int = 10, record_step: int = -1) -> dict:
    """Measure what fraction of a closed-loop step each phase costs.

    Runs a short batched closed loop to harvest the EXACT inputs each phase
    consumed at ``record_step``, then times the jitted phases standalone at
    batch B: lift, MPC solve (the QP), plant step, observer (if wired), and
    the full fused step for reference.  This replaces asserted cost fractions
    with measured ones (the reference's only instrument is tic/toc around the
    solve, ``Ksim.m:205-217``).

    Returns {phase: {"s_per_step": float, "fraction_of_sum": float}, ...,
    "full_step_s": float} -- fractions are of the sum of phase times (phases
    overlap differently once XLA fuses them, so they need not sum to the
    fused step time).
    """
    import jax.numpy as jnp
    import numpy as np

    mpc, plant, scaler = sim.mpc, sim.plant, sim.scaler
    X0 = np.zeros((B, plant.cfg.nx), np.float32)
    X0[:, 0] = np.linspace(-0.2, 0.2, B)
    W = np.zeros((B, 2), np.float32)
    rec = ("X", "U", "zeta", "u_prev_sc", "U_plan_in", "what")
    runner = sim.batched_runner(ref, steps=steps, record=rec)
    out = jax.block_until_ready(runner(jnp.asarray(X0), jnp.asarray(W)))
    pick = lambda k: jnp.asarray(np.asarray(out[k])[:, record_step])
    zeta = pick("zeta")
    u_prev_sc = pick("u_prev_sc")
    U_plan = pick("U_plan_in")
    what = pick("what")
    X = pick("X")
    U = pick("U")                      # unscaled applied input (next u_prev)
    # stacked outputs have steps-1 entries; entry i was produced at the
    # body's 1-based step k = i+1, whose horizon starts at ref row k-1 = i
    i_rec = record_step % (steps - 1)
    refhor = jnp.asarray(sim.prep_ref(ref)[i_rec: i_rec + mpc.Np + 1])

    lift_fn = sim._lift_current
    phases = {
        "lift": jax.vmap(lambda zt, wh: lift_fn(zt, wh)),
        "mpc_solve": jax.vmap(
            lambda z, u, Up: mpc.solve(z, u, refhor, U_init=Up)),
        "plant_step": jax.vmap(
            lambda x, u, w: plant.simulate_Ts(x, u, w)),
    }
    args = {
        "lift": (zeta, what),
        "mpc_solve": (jax.jit(jax.vmap(lift_fn))(zeta, what), u_prev_sc,
                      U_plan),
        "plant_step": (X, U, jnp.asarray(W)),
    }
    if sim.observer is not None:
        hor = sim.observer.horizon
        ywin = jnp.asarray(np.tile(np.asarray(scaler.y_down(
            plant.get_y(X[0])))[None, None], (B, hor + 1, 1)))
        uwin = jnp.tile(u_prev_sc[:, None], (1, hor + 1, 1))
        phases["observer"] = jax.vmap(sim.observer.estimate)
        args["observer"] = (ywin, uwin)

    def clock(fn, a, n_inner: int = 30):
        # chain n_inner applications inside ONE program: per-dispatch launch
        # latency would otherwise swamp the per-phase cost that the fused
        # closed-loop scan amortizes away
        def chained(*aa):
            def body(carry, i):
                a0 = aa[0] + jnp.asarray(i, aa[0].dtype).astype(aa[0].dtype) * 1e-30
                out = fn(a0, *aa[1:])              # perturb: defeats hoisting
                s = sum(jnp.sum(o.astype(jnp.float32))
                        for o in jax.tree_util.tree_leaves(out)
                        if hasattr(o, "astype"))
                return carry + s, None
            tot, _ = jax.lax.scan(body, jnp.float32(0.0),
                                  jnp.arange(n_inner))
            return tot

        prog = jax.jit(chained)
        float(prog(*a))                            # compile + warm
        t0 = time.perf_counter()
        for _ in range(reps):
            float(prog(*a))
        return (time.perf_counter() - t0) / reps / n_inner

    times = {name: clock(fn, args[name]) for name, fn in phases.items()}
    # full fused step: steady-state scan time / steps
    t0 = time.perf_counter()
    jax.block_until_ready(runner(jnp.asarray(X0), jnp.asarray(W)))
    full = (time.perf_counter() - t0) / (steps - 1)
    total = sum(times.values())
    return {
        **{name: {"s_per_step": t, "fraction_of_sum": t / total}
           for name, t in times.items()},
        "full_step_s": full,
        "batch": B,
    }


@contextlib.contextmanager
def profile_trace(logdir: str):
    """jax.profiler trace context (view with TensorBoard's profile plugin)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def comp_time_like(total_wall_s: float, n_steps: int) -> np.ndarray:
    """A per-step comp_time vector from a single compiled-loop wall time.

    Inside one fused scan individual solves are not separable; the uniform
    attribution keeps the reference's results-struct schema usable.
    """
    return np.full(n_steps, total_wall_s / max(n_steps, 1))
