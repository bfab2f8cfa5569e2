"""Data-parallel EDMD: Gram-matrix accumulation with psum over the mesh.

The reference's regression hot loop (``Ksysid.m:1030-1069``) lifts every
snapshot then solves Px \\ Py.  Multi-chip version: each device lifts its
shard of snapshot pairs and forms local Gram matrices PxT Px (Nm x Nm) and
PxT Py; a single ``psum`` over the ``data`` axis reduces them, and every
device solves the same small normal-equation system.  The raw (K x Nm)
snapshot matrices never cross devices -- only the Nm^2 Gram blocks do.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from jax import shard_map

from koopman_realizations.ops.lstsq import gram_lstsq, ridge_for_dtype
from koopman_realizations.parallel.mesh import pad_to_multiple


def koopman_gram_sharded(lift_pair_fn, alpha, beta, u, mesh, w=None):
    """Compute K = (PxTPx)^-1 PxTPy with snapshots sharded over ``data``.

    lift_pair_fn(alpha_row, beta_row, u_row [, w_row]) -> (px_row, py_row):
    the model-type-specific row constructor (see ``models.edmd``).  Padding
    rows (repeats of the last snapshot) are weighted to zero so they do not
    bias the Gram sums.
    """
    ndev = mesh.shape["data"] * mesh.shape.get("model", 1)
    K0 = alpha.shape[0]
    alpha, _ = pad_to_multiple(np.asarray(alpha), ndev)
    beta, _ = pad_to_multiple(np.asarray(beta), ndev)
    u, _ = pad_to_multiple(np.asarray(u), ndev)
    weights = np.zeros(alpha.shape[0])
    weights[:K0] = 1.0
    if w is not None:
        w, _ = pad_to_multiple(np.asarray(w), ndev)

    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32

    def local(alpha_s, beta_s, u_s, wgt_s, *w_s):
        if w_s:
            px, py = jax.vmap(lift_pair_fn)(alpha_s, beta_s, u_s, w_s[0])
        else:
            px, py = jax.vmap(lift_pair_fn)(alpha_s, beta_s, u_s)
        px = px * wgt_s[:, None]
        py = py * wgt_s[:, None]
        AtA = px.T @ px
        AtB = px.T @ py
        return gram_lstsq(AtA, AtB, ridge=ridge_for_dtype(dtype),
                          psum_axis="data")

    in_specs = [P("data"), P("data"), P("data"), P("data")]
    args = [jnp.asarray(alpha, dtype), jnp.asarray(beta, dtype),
            jnp.asarray(u, dtype), jnp.asarray(weights, dtype)]
    if w is not None:
        in_specs.append(P("data"))
        args.append(jnp.asarray(w, dtype))

    fn = shard_map(local, mesh=mesh, in_specs=tuple(in_specs),
                   out_specs=P(), check_vma=False)
    return jax.jit(fn)(*args)
