"""koopman_realizations: a batched Koopman-MPC engine in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
roahmlab/koopman-realizations (pure-MATLAB reference):

- ``ops.observables``  -- lifted-state observable dictionaries
  (poly / fourier / fourier_sparser / gaussian / hermite, delay embedding,
  loaded & bilinear compositions, PCA-reduced "econ" bases).
- ``models.edmd``      -- EDMD / Koopman-realization training (least squares
  and L1-constrained LASSO), model extraction for linear / bilinear /
  nonlinear realizations, open-loop validation rollouts.
- ``models.arm``       -- differentiable planar N-link arm plant (autodiff
  Lagrangian dynamics, RK4/adaptive integrators, marker/endeff/shape sensing).
- ``models.rsys``      -- random scalar nonlinear system ensemble generator.
- ``control.kmpc``     -- horizon-condensed MPC (linear / bilinear / SQP
  nonlinear) on lifted models, batched primal-dual interior-point QP.
- ``control.ksim``     -- closed-loop plant-in-the-loop simulation harness,
  vmapped over thousands of scenarios and sharded over a device mesh.
- ``parallel``         -- mesh/sharding helpers, psum-accumulated EDMD,
  scenario- and ensemble-parallel execution.

Everything under a ``jax.jit`` uses static shapes, ``lax.scan`` control flow
and dense batched linear algebra, so one compiled program serves a whole
scenario batch on the accelerator.
"""

__version__ = "0.1.0"

from koopman_realizations import config, types  # noqa: F401
