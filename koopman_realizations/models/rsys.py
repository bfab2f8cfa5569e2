"""Random scalar nonlinear system ensemble (reference class ``Rsys``).

``Rsys.construct_systems:34-91`` draws systems

    xdot = exp(-x^4) * ( sum_j coeff_j * x^px_j u^pu_j  +  c * u ) - atan(x)

with random coefficients and binary exponent selectors over the monomial
dictionary [x]*degree_x + [u]*degree_u, then simulates trials under random
piecewise-constant step inputs (``simulate_systems:96-125``,
``generate_input_steps:136-150``).

Batched re-design: the whole ensemble is a parameter pytree (coeffs, exponents,
input gains) and one vmapped RK integrator simulates systems x trials in a
single compiled batch.
"""

from __future__ import annotations

import dataclasses
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from koopman_realizations.ops.integrators import rk4
from koopman_realizations.types import DataSet, Trial


@dataclasses.dataclass(frozen=True)
class RsysEnsemble:
    """Parameters of num_sys random systems (stacked leading axis)."""

    coeffs: np.ndarray      # (S, num_terms)
    px: np.ndarray          # (S, num_terms) powers of x per term
    pu: np.ndarray          # (S, num_terms) powers of u per term
    cu: np.ndarray          # (S,) isolated input gain (2*(2 rand - 1))

    @property
    def num_sys(self) -> int:
        return self.coeffs.shape[0]

    def vf(self, s_idx, x, u):
        """xdot for system s_idx (jit/vmap friendly)."""
        coeffs = jnp.asarray(self.coeffs)[s_idx]
        px = jnp.asarray(self.px)[s_idx]
        pu = jnp.asarray(self.pu)[s_idx]
        cu = jnp.asarray(self.cu)[s_idx]
        terms = coeffs * (x ** px) * (u ** pu)
        return jnp.exp(-(x ** 4)) * (jnp.sum(terms) + cu * u) - jnp.arctan(x)


def construct_systems(num_sys: int, num_terms: int, degree_x: int,
                      degree_u: int, rng: np.random.Generator) -> RsysEnsemble:
    """Draw the ensemble (semantics of ``Rsys.construct_systems``).

    Each term multiplies a random subset of the dictionary
    [x]*degree_x + [u]*degree_u, i.e. x^px u^pu with px ~ Binomial(degree_x),
    pu ~ Binomial(degree_u); selectors are iid fair coin flips.
    """
    coeffs = 2.0 * rng.random((num_sys, num_terms)) - 1.0
    sel_x = rng.integers(0, 2, (num_sys, num_terms, degree_x))
    sel_u = rng.integers(0, 2, (num_sys, num_terms, degree_u))
    px = sel_x.sum(axis=2)
    pu = sel_u.sum(axis=2)
    cu = 2.0 * (2.0 * rng.random(num_sys) - 1.0)
    return RsysEnsemble(coeffs=coeffs.astype(float), px=px.astype(float),
                        pu=pu.astype(float), cu=cu.astype(float))


def generate_input_steps(rng: np.random.Generator, T: int,
                         num_steps: int = 50) -> np.ndarray:
    """Piecewise-constant random inputs in [-1, 1] held for num_steps samples
    (``Rsys.generate_input_steps``; the trailing partial block stays 0)."""
    u = np.zeros(T)
    ind = np.arange(0, T, num_steps)
    vals = 2.0 * rng.random(len(ind)) - 1.0
    for i in range(len(ind) - 1):
        u[ind[i]: ind[i + 1]] = vals[i]
    return u


def simulate_systems(ens: RsysEnsemble, t_end: float, Ts: float,
                     num_trials: int, rng: np.random.Generator,
                     x0: float = 0.0, substeps: int = 8) -> List[DataSet]:
    """Simulate num_trials step-input trials per system, fully batched.

    One vmapped scan over (num_sys * num_trials) lanes replaces the
    reference's nested ode45 loops.  Returns one DataSet per system with the
    last trial held out for validation (``Rsys.save_data:198-203``).
    """
    t = np.arange(0.0, t_end + 1e-12, Ts)
    T = len(t)
    S = ens.num_sys
    U = np.stack([[generate_input_steps(rng, T) for _ in range(num_trials)]
                  for _ in range(S)])                      # (S, R, T)

    def run_lane(s_idx, u_seq):
        def body(x, u):
            x1 = rk4(lambda xx: ens.vf(s_idx, xx, u), x, Ts, substeps)
            return x1, x1

        _, xs = jax.lax.scan(body, jnp.asarray(x0), u_seq[:-1])
        return jnp.concatenate([jnp.asarray([x0]), xs])

    s_ids = jnp.repeat(jnp.arange(S), num_trials)
    u_flat = jnp.asarray(U.reshape(S * num_trials, T))
    X = np.asarray(jax.jit(jax.vmap(run_lane))(s_ids, u_flat))
    X = X.reshape(S, num_trials, T)

    datasets = []
    for s in range(S):
        trials = [Trial(t=t, y=X[s, r][:, None], u=U[s, r][:, None])
                  for r in range(num_trials)]
        datasets.append(DataSet(train=trials[:-1], val=trials[-1:]))
    return datasets
