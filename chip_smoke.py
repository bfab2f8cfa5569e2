"""End-to-end proof that the closed loop runs on the GPU, in one process.

Phases (any failure stops the script with a non-zero exit):
  1. the device, and the card's name and power limit from nvidia-smi;
  2. generate the arm corpus from a seed and train the bench model;
  3. the full-width closed loop (bench shape: B=262144 lanes, 301 steps of
     blockM), compiled for the card, with the bench's alive and
     tracking-error gates;
  4. parity: the closed loop on the card against the same program on the
     CPU, 64 lanes;
  5. the steps/s line, with the card beside it.
No hand-written kernel is on this path: the Pallas-Triton step kernel
lost to XLA's program and was removed (PERF.md).
The last line of stdout is one JSON object naming the device.

``python chip_smoke.py --four`` runs only the four-card phase: the
sharded closed loop (``parallel.run_batch_sharded``) on a 4-card mesh at
4 x 65536 lanes against the same lanes on one card, and the sharded Gram
fit (``parallel.koopman_gram_sharded``) against the unsharded one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

import bench

PARITY_LANES_CPU = 64
FOUR_LANES = 4 * 65536
# f32 Gram sums reduced in another order across shards
GRAM_RTOL = 5e-3


def _phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def check_parity(name, out_a, out_b, ref_y, steps):
    """Tracked outputs agree to 2e-5 over the first 5 steps and 2e-3 over
    30, the alive masks are identical, and the mean tracking errors over
    the run agree within 1%."""
    Ya, Yb = np.asarray(out_a["Yp"]), np.asarray(out_b["Yp"])
    d = np.abs(Ya - Yb)
    d5, d30 = float(d[:, :5].max()), float(d[:, :30].max())
    same_alive = bool((np.asarray(out_a["alive"])
                       == np.asarray(out_b["alive"])).all())
    ea = float(bench.lane_errors(out_a, ref_y, steps).mean())
    eb = float(bench.lane_errors(out_b, ref_y, steps).mean())
    rel = abs(ea - eb) / eb
    print(f"parity {name}: max|dYp| 5 steps {d5:.3e}, 30 steps {d30:.3e}, "
          f"alive identical {same_alive}, err_mean {ea:.6f} vs {eb:.6f} "
          f"(rel {rel:.2e})", flush=True)
    if not (d5 < 2e-5 and d30 < 2e-3 and same_alive and rel < 0.01):
        raise RuntimeError(f"parity {name} failed")


def one_card(card, lanes: int = bench.BATCH):
    import jax

    t0 = _phase("2 corpus + training")
    sim, ref_y = bench.build_sim()
    print(f"trained in {time.perf_counter() - t0:.1f} s", flush=True)
    B, K = lanes, bench.STEPS

    _phase("3 full-width closed loop")
    out, info = bench.run_closed_loop(sim, ref_y, B, K, reps=3)
    bench.check_gates(info, bench.QP_ITERS, K)
    print(f"B={B}, {K} steps: alive {info['alive_fraction']}, err_mean "
          f"{info['err_mean']:.6f} (gate {bench.ERR_GATE}), err_worst "
          f"{info['err_worst']:.6f}, compile {info['compile_s']:.1f} s",
          flush=True)

    _phase("4 parity")
    X0, W = bench.lane_inputs(PARITY_LANES_CPU)
    gpu_out = jax.block_until_ready(
        sim.batched_runner(ref_y, steps=K, record=("Yp", "alive"))(X0, W))
    with jax.default_device(jax.devices("cpu")[0]):
        sim_c, _ = bench.build_sim()
        cpu_out = jax.block_until_ready(
            sim_c.batched_runner(ref_y, steps=K,
                                 record=("Yp", "alive"))(X0, W))
    check_parity(f"gpu vs cpu, B={PARITY_LANES_CPU}", gpu_out, cpu_out,
                 ref_y, K)

    _phase("5 throughput")
    print(f"steps/s xla: {info['steps_per_s']:.1f} (B={B}, {K} steps, "
          f"median of 3, wall {info['wall_s']:.4f} s) on {card}",
          flush=True)


def four_cards(card, lanes: int = FOUR_LANES):
    import jax
    import jax.numpy as jnp

    from koopman_realizations.config import SysidConfig
    from koopman_realizations.models.edmd import Ksysid
    from koopman_realizations.parallel import (
        koopman_gram_sharded,
        make_mesh,
        run_batch_sharded,
    )
    from koopman_realizations.utils.data import generate_arm_data

    devs = jax.devices()
    if len(devs) != 4:
        raise RuntimeError(f"--four needs 4 devices, JAX sees {len(devs)}")
    mesh4 = make_mesh(n_data=4)
    mesh1 = make_mesh(n_data=1, devices=devs[:1])
    _phase("2 corpus + training")
    sim, ref_y = bench.build_sim()

    _phase("3 sharded closed loop vs one card")
    X0, W = bench.lane_inputs(lanes)
    res = {}
    for name, mesh in (("4 cards", mesh4), ("1 card", mesh1)):
        t0 = time.perf_counter()
        res[name] = run_batch_sharded(sim, ref_y, X0, mesh, load=W)
        print(f"{name}: {lanes} lanes x {ref_y.shape[0] - 1} steps, wall "
              f"incl. compile {time.perf_counter() - t0:.1f} s, alive "
              f"{float(res[name]['alive'][:, -1].mean())}", flush=True)
    proj = list(sim.mpc.proj_idx)
    check_parity("sharded vs one card, lane for lane",
                 *({"Yp": r["Y"][..., proj], "alive": r["alive"]}
                   for r in (res["4 cards"], res["1 card"])), ref_y,
                 ref_y.shape[0])

    _phase("4 sharded Gram fit vs unsharded")
    ks = Ksysid(generate_arm_data(), SysidConfig(
        model_type="linear", obs_type=("poly",), obs_degree=(3,)))
    sp, basis = ks.snapshot_pairs, ks.basis

    def lift_pair(a, b, u):
        return (jnp.concatenate([basis.lift(a), u]),
                jnp.concatenate([basis.lift(b), u]))

    K = {name: np.asarray(koopman_gram_sharded(lift_pair, sp.alpha, sp.beta,
                                               sp.u, mesh))
         for name, mesh in (("4 cards", mesh4), ("1 card", mesh1))}
    Px, _ = ks.lift_snapshot_matrices()
    Px = np.asarray(Px, np.float64)
    pred4, pred1 = Px @ K["4 cards"], Px @ K["1 card"]
    rel = float(np.abs(pred4 - pred1).max() / np.abs(pred1).max())
    print(f"sharded Gram fit vs one card ({Px.shape[0]} snapshots, "
          f"{Px.shape[1]} features): max relative difference of the "
          f"fitted one-step predictions {rel:.3e}", flush=True)
    if not rel < GRAM_RTOL:
        raise RuntimeError("sharded Gram fit differs from one card")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args()
    import jax

    _phase("1 device")
    bench.require_gpu()
    bench.setup_compile_cache()
    card = bench.card()
    dev = jax.devices()[0]
    print(f"{dev.platform} {dev.device_kind} x{len(jax.devices())}; {card}",
          flush=True)
    with jax.default_matmul_precision("highest"):
        if args.four:
            four_cards(card)
        else:
            one_card(card)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    sys.exit(main())
