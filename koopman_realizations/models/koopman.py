"""Koopman realization models (linear / bilinear / nonlinear) and rollouts.

Re-design of the reference's model structs and validation simulators:
- linear    z+ = A z + B u,          y = C z    (``Ksysid.get_model:1179``)
- bilinear  z+ = A z + Beta(z) u,    y = C z    (``Ksysid.get_BLmodel:1238``)
- nonlinear zeta+ = F(zeta, u) = W^T g([zeta;u]) (``Ksysid.get_NLmodel:1298``)

Open-loop validation loops (``Ksysid.val_model:1623``, ``val_BLmodel:1717``,
``val_NLmodel:1815``) become single ``lax.scan`` bodies, batched over trials
with ``vmap``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from koopman_realizations.ops.observables import KoopmanBasis


@dataclasses.dataclass(frozen=True)
class ModelMeta:
    """Static metadata shared by all model types (reference ``params``)."""

    model_type: str
    time_type: str
    n: int
    m: int
    nd: int
    nw: int
    N: int           # working basis dimension (reference params.N)
    nzeta: int
    Ts: float

    @property
    def NL(self) -> int:
        """Lifted state dimension incl. loads: N*(nw+1)."""
        return self.N * (self.nw + 1)


def _model_pytree(cls):
    """Dataclass pytree whose ``meta``/``basis`` fields are static aux."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    static = [n for n in fields if n in ("meta", "basis")]
    dynamic = [n for n in fields if n not in static]

    def flatten(obj):
        return [getattr(obj, n) for n in dynamic], tuple(getattr(obj, n) for n in static)

    def unflatten(aux, children):
        return cls(**dict(zip(dynamic, children)), **dict(zip(static, aux)))

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


@_model_pytree
class LinearModel:
    """z+ = A z + B u, y = C z, with the M-projection already folded in."""

    A: Any            # (NL, NL)
    B: Any            # (NL, m)
    C: Any            # (n, NL)
    M: Any            # (NL, NL) projection matrix (Ksysid.m:1205-1217)
    K: Any            # raw Koopman operator (for parity inspection)
    meta: ModelMeta = None
    basis: KoopmanBasis = None
    lasso: float = float("inf")

    def step(self, z, u):
        return self.A @ z + self.B @ u

    def output(self, z):
        return self.C @ z


@_model_pytree
class BilinearModel:
    """z+ = A z + Beta(z) u with Beta(z) = B kron(I_m, z).

    ``B`` is stored reshaped as (NL, m, NL) so Beta(z) = einsum('kmj,j->km').
    Column block k of the reference's (NL, m*NL) matrix multiplies input k
    (``Ksysid.get_Beta_bilinear:1285-1295``).
    """

    A: Any            # (NL, NL)
    B: Any            # (NL, m, NL)
    C: Any            # (n, NL)
    K: Any
    meta: ModelMeta = None
    basis: KoopmanBasis = None
    lasso: float = float("inf")

    def Beta(self, z):
        return jnp.einsum("kmj,j->km", self.B, z)

    def step(self, z, u):
        return self.A @ z + jnp.einsum("kmj,j,m->k", self.B, z, u)

    def output(self, z):
        return self.C @ z


@_model_pytree
class NonlinearModel:
    """zeta+ = W^T g([zeta; u])  (discrete Koopman vector field)."""

    W: Any            # (N*(nw+1), nzeta): K[:, :nzeta]
    C: Any            # (n, n) identity (Ksysid.m:1337)
    K: Any
    meta: ModelMeta = None
    basis: KoopmanBasis = None
    lasso: float = float("inf")

    def F(self, zeta, u, w=None):
        g = (self.basis.lift_loaded(jnp.concatenate([zeta, u]), w)
             if self.meta.nw > 0 else self.basis.lift(jnp.concatenate([zeta, u])))
        return self.W.T @ g


# ---- continuous-time helpers ----------------------------------------------


def zoh_discretize(A, B, Ts: float):
    """Exact zero-order-hold discretization via the augmented exponential.

    expm([[A, B], [0, 0]] * Ts) = [[Ad, Bd], [0, I]].  Used to roll out
    continuous-time models (the reference integrates them with ode45,
    ``Ksysid.val_model:1679-1683``; for an LTI system ZOH is exact).
    """
    A = jnp.asarray(A)
    B = jnp.asarray(B)
    n, m = A.shape[0], B.shape[1]
    aug = jnp.zeros((n + m, n + m), A.dtype)
    aug = aug.at[:n, :n].set(A * Ts)
    aug = aug.at[:n, n:].set(B * Ts)
    E = jax.scipy.linalg.expm(aug)
    return E[:n, :n], E[:n, n:]


def as_discrete(model):
    """Return a discrete-stepping equivalent of a continuous-time model."""
    import dataclasses as _dc

    meta = model.meta
    if meta.time_type != "continuous":
        return model
    if isinstance(model, LinearModel):
        Ad, Bd = zoh_discretize(model.A, model.B, meta.Ts)
        return _dc.replace(model, A=Ad, B=Bd,
                           meta=_dc.replace(meta, time_type="discrete"))
    raise NotImplementedError(
        "a continuous bilinear model has no state-independent (Ad, Bd); "
        "use zoh_step_bilinear (exact under ZOH input) or rollout(..) "
        "(rk4 substeps); nonlinear models integrate with rk4 only")


def zoh_step_bilinear(model: "BilinearModel", substeps: int = 1):
    """EXACT per-Ts stepper for a continuous bilinear model under ZOH input.

    With u held constant over the sample interval (zero-order hold -- the
    closed-loop actuation model, ``Ksim.m:239-246``), the bilinear vector
    field z' = A z + B(z) u = (A + sum_m u_m B[:, m, :]) z is LINEAR
    time-invariant over the interval, so the exact transition is the
    matrix exponential of the u-dependent generator:

        z+ = expm(Ts (A + sum_m u_m B[:, m, :])) z

    (the reference integrates the same interval with ode45,
    ``Ksysid.val_BLmodel:1779-1783``; this replaces the adaptive stepper
    with the closed-form solution).  ``substeps`` is accepted for
    signature compatibility with the rk4 stepper and ignored (the
    exponential is exact at any step size).  Cost: one NL x NL ``expm``
    per (step, lane) -- prefer rk4 for large batches, this for accuracy
    anchors and validation.
    """
    meta = model.meta
    if meta.time_type != "continuous":
        raise ValueError("zoh_step_bilinear needs a continuous-time model")
    A = jnp.asarray(model.A)
    Bm = jnp.asarray(model.B)
    Ts = meta.Ts

    def step(z, u):
        gen = A + jnp.einsum("kmj,m->kj", Bm, u)
        return jax.scipy.linalg.expm(Ts * gen) @ z

    return step


# ---- open-loop validation rollouts ----------------------------------------


def _maybe_continuous_step(model, meta, substeps: int = 8):
    """Per-Ts stepper for continuous bilinear/nonlinear models (rk4)."""
    from koopman_realizations.ops.integrators import rk4

    def step(z, u):
        return rk4(lambda zz: model.step(zz, u), z, meta.Ts, substeps)

    return step


def rollout_linear(model: LinearModel, z0, U, W=None):
    """Scan z+ = A z + B u over an input sequence; returns Y [T, n], Z [T, NL].

    With loads, the lifted state is re-mixed with the true load each step:
    znow = kron(I_{nw+1}, z_N) [1; w]  (``Ksysid.val_model:1667-1671``).
    Continuous-time models are ZOH-discretized exactly first.
    """
    model = as_discrete(model)
    meta = model.meta

    def remix(z, w):
        zN = z[: meta.N]
        one_w = jnp.concatenate([jnp.ones((1,), z.dtype), w])
        return (one_w[:, None] * zN[None, :]).reshape(-1)

    def step(z, xs):
        if W is None:
            u = xs
            z1 = model.step(z, u)
        else:
            u, w = xs
            z1 = model.step(remix(z, w), u)
        return z1, z1

    xs = U[:-1] if W is None else (U[:-1], W[:-1])
    _, Z = jax.lax.scan(step, z0, xs)
    Z = jnp.concatenate([z0[None], Z], axis=0)
    Y = Z @ model.C.T
    return Y, Z


def rollout_bilinear(model: BilinearModel, z0, U, W=None,
                     continuous_stepper: str = "rk4"):
    """``continuous_stepper`` (continuous-time models only): 'rk4' (fast
    fixed-substep default) or 'zoh' (exact u-dependent matrix exponential,
    ``zoh_step_bilinear``)."""
    meta = model.meta
    if meta.time_type == "discrete":
        stepper = model.step
    elif continuous_stepper == "zoh":
        stepper = zoh_step_bilinear(model)
    else:
        stepper = _maybe_continuous_step(model, meta)

    def remix(z, w):
        zN = z[: meta.N]
        one_w = jnp.concatenate([jnp.ones((1,), z.dtype), w])
        return (one_w[:, None] * zN[None, :]).reshape(-1)

    def step(z, xs):
        if W is None:
            u = xs
            z1 = stepper(z, u)
        else:
            u, w = xs
            zn = remix(z, w)
            z1 = stepper(zn, u)
        return z1, z1

    xs = U[:-1] if W is None else (U[:-1], W[:-1])
    _, Z = jax.lax.scan(step, z0, xs)
    Z = jnp.concatenate([z0[None], Z], axis=0)
    Y = Z @ model.C.T
    return Y, Z


def rollout_nonlinear(model: NonlinearModel, zeta0, U, W=None):
    """Iterate zeta+ = F(zeta, u); y = zeta[:n] (``Ksysid.val_NLmodel``).

    For continuous models F is a vector field integrated with rk4 over Ts
    (``Ksysid.val_NLmodel:1849-1855``).
    """
    meta = model.meta
    if meta.time_type == "continuous":
        from koopman_realizations.ops.integrators import rk4

        def apply_F(zeta, u, w=None):
            f = (lambda z: model.F(z, u, w)) if w is not None else \
                (lambda z: model.F(z, u))
            return rk4(f, zeta, meta.Ts, 8)
    else:
        apply_F = model.F

    def step(zeta, xs):
        if W is None:
            u = xs
            z1 = apply_F(zeta, u)
        else:
            u, w = xs
            z1 = apply_F(zeta, u, w)
        return z1, z1

    xs = U[:-1] if W is None else (U[:-1], W[:-1])
    _, Zt = jax.lax.scan(step, zeta0, xs)
    Zt = jnp.concatenate([zeta0[None], Zt], axis=0)
    Y = Zt[:, : meta.n]
    return Y, Zt


def rollout(model, init, U, W=None):
    if isinstance(model, LinearModel):
        return rollout_linear(model, init, U, W)
    if isinstance(model, BilinearModel):
        return rollout_bilinear(model, init, U, W)
    if isinstance(model, NonlinearModel):
        return rollout_nonlinear(model, init, U, W)
    raise TypeError(f"unknown model type {type(model)}")
