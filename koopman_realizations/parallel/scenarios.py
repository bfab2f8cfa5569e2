"""Scenario-parallel closed-loop simulation over a device mesh.

The BASELINE north star (>=10k concurrent 20 Hz Koopman-MPC sims) is pure
data parallelism: every lane owns its plant state, controller solve, and
rollout; no cross-lane communication until metrics collection.  Lanes are
sharded over the ``data`` mesh axis with ``shard_map`` and vmapped within a
device; the per-device program is the same single-scan closed loop as
``control.Ksim``.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from jax import shard_map

from koopman_realizations.parallel.mesh import pad_to_multiple


def sharded_batch_runner(sim, ref, mesh, steps: Optional[int] = None,
                         record=("U", "Y", "R", "alive")):
    """Build fn(X0, W) running the closed loop with lanes sharded over
    ``data``.  X0: (B, nx), W: (B, nw_plant); B must divide evenly after
    padding (use ``run_batch_sharded`` for automatic padding).
    Returns per-lane outputs with leading axis B.  ``record`` trims the
    stacked per-step outputs (see ``Ksim.make_body``).
    """
    K = ref.shape[0] if steps is None else steps
    body = sim.make_body(sim.prep_ref(ref), record=record)
    init0 = sim.init_carry()
    ks = jnp.arange(1, K)

    def one(x0, w):
        w_seq = jnp.tile(w[None, :], (K - 1, 1))
        _, out = jax.lax.scan(body, sim.lane_init(x0, init0), (ks, w_seq))
        return out

    local = jax.vmap(one)
    fn = shard_map(local, mesh=mesh, in_specs=(P("data"), P("data")),
                   out_specs=P("data"), check_vma=False)
    return jax.jit(fn)


def run_batch_sharded(sim, ref, X0, mesh, load=None,
                      steps: Optional[int] = None) -> dict:
    """Shard a scenario batch over the mesh and run the closed loop."""
    ndev = int(np.prod(list(mesh.shape.values())))
    X0 = np.asarray(X0)
    B = X0.shape[0]
    X0p, _ = pad_to_multiple(X0, ndev)
    if load is None:
        Wp = np.zeros((X0p.shape[0], sim.nw_plant))
    else:
        Wp, _ = pad_to_multiple(np.asarray(load), ndev)
    fn = sharded_batch_runner(sim, ref, mesh, steps)
    out = fn(jnp.asarray(X0p), jnp.asarray(Wp))
    Y = np.asarray(out["Y"])[:B]
    R = np.asarray(out["R"])[:B]
    err = np.sqrt(((R - Y[..., list(sim.mpc.proj_idx)]) ** 2).sum(-1))
    return {"Y": Y, "R": R, "U": np.asarray(out["U"])[:B],
            "alive": np.asarray(out["alive"])[:B], "err": err}
