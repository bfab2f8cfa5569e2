"""Device-mesh helpers.

The reference is single-process MATLAB with no parallelism (SURVEY section
2.6).  The mapping here:
- ``data`` axis: snapshot-parallel EDMD (Gram psum) and scenario-parallel
  closed-loop simulation -- the cards of one host are joined all to all,
  so the mesh follows the algorithm,
- ``model`` axis (optional): shards the lifted dimension for very large
  dictionaries (TP-like); unused by the shipped configs whose N <= ~350.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices=None) -> Mesh:
    """Build a (data, model) mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n_data = n_data or (len(devices) // n_model)
    devs = np.asarray(devices[: n_data * n_model]).reshape(n_data, n_model)
    return Mesh(devs, axis_names=("data", "model"))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch/snapshot/scenario) axis over ``data``."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(x: np.ndarray, k: int, axis: int = 0):
    """Pad axis 0 of x up to a multiple of k (repeat last row); returns
    (padded, original_length)."""
    n = x.shape[axis]
    rem = (-n) % k
    if rem == 0:
        return x, n
    pad = np.repeat(np.take(x, [-1], axis=axis), rem, axis=axis)
    return np.concatenate([x, pad], axis=axis), n
