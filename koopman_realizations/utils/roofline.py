"""Analytic FLOPs / HBM-bytes model of the closed-loop MPC step (roofline).

The driver metric is closed-loop MPC steps/s; this module answers the
follow-up the raw rate cannot: how far from the hardware ceiling is it?
It counts, per scenario lane per control step, (a) the floating-point work
of every phase of the scan body (lift -> QP assembly -> interior point ->
plant step) and (b) the HBM traffic, as two brackets:

- ``bytes_min``  : the perfect-fusion lower bound -- only the scan carry
  round-trip plus the QP's per-lane inputs and outputs (the assembly GEMM
  and the QP solve do not fuse),
- ``bytes_est``  : each named inter-phase intermediate (lifted state,
  assembly GEMM output, reduced W/v) additionally spills to HBM once
  (write + read) -- the realistic ceiling-ward estimate for this program
  shape.

FLOP conventions: one multiply-add = 2 FLOPs; (mc,)/(n,)-sized vector
bookkeeping below ~1% of a phase is folded into per-phase constants; the
plant count is a documented coarse model (+-50%, <10% of the total).

Everything is derived from the live controller/plant objects, so the model
tracks config changes (horizon, blocking, qp_iters, substeps) instead of
hard-coding the bench shape.  Used by ``bench.py`` (roofline shares in its
detail fields).

No reference counterpart (the reference publishes no performance
accounting at all); the methodology is the standard roofline recipe
(arithmetic intensity vs the device's published peaks).
"""

from __future__ import annotations

import numpy as np

# Published peaks per device, keyed by ``jax.devices()[0].device_kind``.
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, dense rates
# without sparsity, at the full 700 W power limit.  The closed loop runs
# its matmuls at Precision.HIGHEST (plain f32, no TF32), so its compute
# roof is the f32 rate outside the tensor cores.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"peak_f32": 67e12, "peak_tf32": 495e12,
                              "peak_bf16": 989e12, "hbm_bytes_s": 3.35e12},
}


def device_peaks(device_kind: str) -> dict:
    """Published peaks of ``device_kind``; an unknown device is an error."""
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device {device_kind!r}; "
                       f"add it to DEVICE_PEAKS with its source") from None


def _ipm_iter_flops(n: int, mc: int, pairs: int) -> int:
    """One Mehrotra iteration of the interior point, per lane: residuals,
    A^T D A formation over the ``pairs`` structurally nonzero (i <= j)
    row-product entries, one Cholesky, two direction solves (predictor +
    corrector, each one pair of triangular solves + A/At matvecs), and
    the steplength/centering vector bookkeeping.
    """
    f = 0
    f += 2 * mc * n                    # r_p = A x
    f += 2 * n * n + 2 * n * mc        # r_d = P x + At lam
    f += 2 * pairs                     # A^T D A
    f += n ** 3 // 3 + n * n           # Cholesky
    # two directions: rhs At matvec, fwd+bwd triangular solve, ds = A dx,
    # dlam vector ops
    f += 2 * (2 * n * mc + 2 * n * n + 2 * mc * n + 4 * mc)
    f += 12 * mc + 8 * n               # slack ratios, steplengths, updates
    return f


def bilinear_step_cost(mpc, plant_cfg, dual_warm: bool = True) -> dict:
    """Per-lane-per-step FLOPs and HBM bytes of the SHIPPING bilinear loop.

    ``mpc``: a constructed ``BilinearKmpc`` (blocked or not);
    ``plant_cfg``: the ``ArmConfig`` of the plant in the loop.
    Returns {"flops": {phase: FLOPs}, "flops_total", "gemm_flops"
    (the lane-shared GEMM subset), "bytes_min", "bytes_est"}.
    """
    meta = mpc.meta
    NL, m, Np, nproj = meta.NL, meta.m, mpc.Np, mpc.nproj
    p = (Np + 1) * nproj                       # stacked projected rows
    ncols = Np * m                             # full stacked input columns
    blocked = getattr(mpc, "_Tb", None) is not None
    nred = mpc._Tb.shape[1] if blocked else (Np - 1) * m
    mc = mpc.n_con
    iters = mpc.cfg.qp_iters
    A = np.asarray(mpc.F_red if blocked else mpc.F[:, m:])
    nnz = A != 0
    pairs = int(sum(np.count_nonzero(np.tril(np.outer(r, r))) for r in nnz))

    basis = mpc.model.basis
    N_full = basis.pcs.shape[0] if basis.pcs is not None else NL
    npcs = basis.pcs.shape[1] if basis.pcs is not None else 0
    nza = basis.nzeta_aug

    fl = {}
    # lift: degree-blocked poly products (one multiply per monomial of
    # degree >= 2) + the PCA projection GEMM
    fl["lift"] = (N_full - nza - 1) + 2 * N_full * npcs
    # assembly: lane-shared PG GEMM (CB stack), CA z, CB0 u_prev fold,
    # blocked Tb reduction of W
    fl["qp_assembly"] = (2 * (p * ncols) * NL            # PG @ z
                         + 2 * p * NL + 2 * p * m        # v terms
                         + (2 * p * (ncols - m) * nred if blocked else 0))
    # QP prologue: Gram (p rank-1 updates), gradient, scale
    fl["qp_gram"] = 2 * nred * nred * p + 2 * nred * p + nred * nred
    fl["qp_iters"] = iters * _ipm_iter_flops(nred, mc, pairs)
    # plant: coarse closed-form 3-link model -- one EOM residual ~600 FLOPs
    # (mass matrix + suffix-sum Coriolis + gravity), one 6x6 Jacobian +
    # LU per step (jac_mode='step'), newton_iters residual+solve per
    # SDIRK2 substep (2 implicit stages)
    nx = 6
    resid = 600
    substeps = getattr(plant_cfg, "substeps", 3)
    newton = getattr(plant_cfg, "newton_iters", 2)
    fl["plant"] = (nx * resid + 2 * nx ** 3 // 3           # Jacobian + LU
                   + substeps * 2 * newton * (resid + 2 * nx * nx))
    fl["harness"] = 40 * NL                    # windows, freezes, scaling

    total = int(sum(fl.values()))
    # the lane-shared GEMM subset; the Gram, Cholesky and solves are
    # per-lane serial chains
    gemm = fl["lift"] + fl["qp_assembly"]

    # ---- HBM bytes ------------------------------------------------------
    f32 = 4
    # scan carry (read + write once per step): x, y, ywin, uwin, u_prev,
    # U_plan, lam (dual warm), alive
    win = 1 + meta.nd
    carry = (nx + meta.n + win * meta.n + win * m + m + Np * m
             + (mc if dual_warm else 0)) * f32 + 1
    # the assembly GEMM writes its (W, CB0, v) rows once and the QP reads
    # them back; the lifted features and the plan are the other spills
    qp_in = p * nred + m * p + p + nred + (mc if dual_warm else 0)
    spill_terms = NL + p * nred + m * p + p + nred + Np * m
    qp_io = (qp_in + nred + 2 * mc + 1) * f32
    bytes_min = 2 * carry + qp_io
    # each named intermediate additionally spills once (write+read)
    bytes_est = bytes_min + spill_terms * 2 * f32
    return {"flops": fl, "flops_total": total, "gemm_flops": int(gemm),
            "bytes_min": int(bytes_min), "bytes_est": int(bytes_est)}


def roofline_summary(steps_per_s: float, cost: dict, device_kind: str) -> dict:
    """Achieved rates of a measured throughput against the device's
    published f32 and HBM peaks (``device_peaks``)."""
    peaks = device_peaks(device_kind)
    flops_s = steps_per_s * cost["flops_per_lane_step"]
    bytes_s = steps_per_s * cost["hbm_bytes_per_lane_step_est"]
    return {
        "achieved_flops_per_s": flops_s,
        "hbm_bytes_per_s_est": bytes_s,
        "f32_frac": flops_s / peaks["peak_f32"],
        "hbm_frac_est": bytes_s / peaks["hbm_bytes_s"],
    }
