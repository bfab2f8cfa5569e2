"""Affine [-1,1] data scaling (reference ``Ksysid.get_scale:180-285``).

The reference compiles symbolic scale functions; here scaling is a pytree of
factor/offset vectors and pure affine ops, usable inside jit.
Invariant: all training/validation data, bounds, and references live in
scaled space; results are scaled back up only at the edges.
"""

from __future__ import annotations

from typing import Any, Optional

import jax.numpy as jnp
import numpy as np

from koopman_realizations.types import Trial, pytree_dataclass


@pytree_dataclass
class Scaler:
    """Per-dimension affine maps fitted from training data min/max.

    scaledown: (v - offset) / factor ; scaleup: v * factor + offset.
    Zero-range dims fall back to factor 1 (``Ksysid.m:198-204``); constant
    load dims are only shifted (``Ksysid.m:251-260``).
    """

    y_factor: Any
    y_offset: Any
    u_factor: Any
    u_offset: Any
    x_factor: Optional[Any] = None
    x_offset: Optional[Any] = None
    w_factor: Optional[Any] = None
    w_offset: Optional[Any] = None

    # ---- elementary maps --------------------------------------------------

    def y_down(self, y):
        return (jnp.asarray(y) - self.y_offset) / self.y_factor

    def y_up(self, y):
        return jnp.asarray(y) * self.y_factor + self.y_offset

    def u_down(self, u):
        return (jnp.asarray(u) - self.u_offset) / self.u_factor

    def u_up(self, u):
        return jnp.asarray(u) * self.u_factor + self.u_offset

    def x_down(self, x):
        return (jnp.asarray(x) - self.x_offset) / self.x_factor

    def x_up(self, x):
        return jnp.asarray(x) * self.x_factor + self.x_offset

    def w_down(self, w):
        return (jnp.asarray(w) - self.w_offset) / self.w_factor

    def w_up(self, w):
        return jnp.asarray(w) * self.w_factor + self.w_offset

    # ---- zeta (delay-embedded state) maps  (Ksysid.m:266-284) -------------

    def zeta_factors(self, nd: int):
        yf, uf = np.asarray(self.y_factor), np.asarray(self.u_factor)
        yo, uo = np.asarray(self.y_offset), np.asarray(self.u_offset)
        factor = np.concatenate([np.tile(yf, nd + 1), np.tile(uf, nd)])
        offset = np.concatenate([np.tile(yo, nd + 1), np.tile(uo, nd)])
        return factor, offset

    def zeta_down(self, zeta, nd: int):
        f, o = self.zeta_factors(nd)
        return (jnp.asarray(zeta) - o) / f

    def zeta_up(self, zeta, nd: int):
        f, o = self.zeta_factors(nd)
        return jnp.asarray(zeta) * f + o

    # ---- ref maps (subset of y selected by proj_idx; Kmpc.m:135-152) ------

    def ref_down(self, ref, proj_idx):
        idx = np.asarray(proj_idx)
        return (jnp.asarray(ref) - self.y_offset[idx]) / self.y_factor[idx]

    def ref_up(self, ref, proj_idx):
        idx = np.asarray(proj_idx)
        return jnp.asarray(ref) * self.y_factor[idx] + self.y_offset[idx]

    # ---- whole-trial maps -------------------------------------------------

    def trial_down(self, tr: Trial) -> Trial:
        # Host-side data prep: stay in numpy float64 regardless of the JAX
        # default dtype (jnp would silently downcast to f32 without x64).
        f = lambda v, fac, off: (np.asarray(v) - np.asarray(off)) / np.asarray(fac)
        return Trial(
            t=tr.t,
            y=f(tr.y, self.y_factor, self.y_offset),
            u=f(tr.u, self.u_factor, self.u_offset),
            x=None if (tr.x is None or self.x_factor is None) else f(tr.x, self.x_factor, self.x_offset),
            w=None if (tr.w is None or self.w_factor is None) else f(tr.w, self.w_factor, self.w_offset),
        )


def _fit_range(v: np.ndarray):
    vmin, vmax = v.min(axis=0), v.max(axis=0)
    offset = (vmax + vmin) / 2.0
    factor = (vmax - vmin) / 2.0
    factor = np.where(factor == 0.0, 1.0, factor)
    return factor, offset


def fit_scaler(train: Trial) -> Scaler:
    """Fit the scaler from merged training data (``Ksysid.get_scale``)."""
    yf, yo = _fit_range(np.asarray(train.y))
    uf, uo = _fit_range(np.asarray(train.u))
    kw = dict(y_factor=yf, y_offset=yo, u_factor=uf, u_offset=uo)
    if train.x is not None:
        xf, xo = _fit_range(np.asarray(train.x))
        kw.update(x_factor=xf, x_offset=xo)
    if train.w is not None:
        w = np.asarray(train.w)
        wmin, wmax = w.min(axis=0), w.max(axis=0)
        wo = (wmax + wmin) / 2.0
        wf = np.where(wmin == wmax, 1.0, (wmax - wmin) / 2.0)  # shift-only for const dims
        kw.update(w_factor=wf, w_offset=wo)
    return Scaler(**kw)
