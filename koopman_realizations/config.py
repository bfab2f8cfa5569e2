"""Configuration dataclasses mirroring the reference's Name/Value knobs.

Field names intentionally match the MATLAB properties so that reference
experiment configurations translate one-to-one:
- sysid knobs:  ``Ksysid_setup.m:16-25`` / ``Ksysid.m:72-104``
- MPC knobs:    ``Kmpc_setup.m:6-17``   / ``Kmpc.m:54-72``
- plant knobs:  ``Arm_setup.m:12-52``
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class SysidConfig:
    """Knobs for EDMD / Koopman-realization training (Ksysid)."""

    model_type: str = "linear"          # 'linear' | 'bilinear' | 'nonlinear'
    time_type: str = "discrete"         # 'discrete' | 'continuous'
    obs_type: Tuple[str, ...] = ("poly",)
    obs_degree: Tuple[int, ...] = (1,)
    snapshots: float = math.inf          # number of snapshot pairs (inf = all)
    lasso: Tuple[float, ...] = (math.inf,)  # inf => plain least squares
    delays: int = 0
    loaded: bool = False
    dim_red: bool = False               # PCA dimension reduction
    pca_explained: float = 99.0         # dim_red variance threshold in %
                                        # (Ksysid.m:1500-1504 uses 99)
    seed: int = 0                       # PRNG seed (gaussian centers, subsampling)
    dtype: str = "float64"              # regression dtype (f32 for rollouts)
    lasso_iters: int = 50000            # FISTA iteration CAP for the LASSO path
    lasso_tol: float = 1e-12            # FISTA convergence stop (rel objective
    # change per 100 iters); the paper-scale poly-3 Gram is ~1e17-conditioned
    # and needs ~30k iterations -- certified in tests/test_lasso_cert.py

    def __post_init__(self):
        object.__setattr__(self, "obs_type", tuple(self.obs_type))
        object.__setattr__(self, "obs_degree", tuple(self.obs_degree))
        if isinstance(self.lasso, (int, float)):
            object.__setattr__(self, "lasso", (float(self.lasso),))
        else:
            object.__setattr__(self, "lasso", tuple(float(v) for v in self.lasso))
        if self.model_type not in ("linear", "bilinear", "nonlinear"):
            raise ValueError(f"invalid model_type {self.model_type!r}")
        if self.time_type not in ("discrete", "continuous"):
            raise ValueError(f"invalid time_type {self.time_type!r}")
        if len(self.obs_type) != len(self.obs_degree):
            raise ValueError("obs_type and obs_degree must have the same length")

    @property
    def liftinput(self) -> int:
        # Ksysid.m:96-104
        return {"linear": 0, "nonlinear": 1, "bilinear": 2}[self.model_type]


@dataclasses.dataclass(frozen=True)
class MpcConfig:
    """Knobs for the model-predictive controller (Kmpc)."""

    horizon: Optional[int] = None        # default floor(1/Ts)  (Kmpc.m:55)
    input_bounds: Optional[Tuple[float, float]] = None   # scalar pair or (m,2)
    input_slopeConst: Optional[float] = None
    input_smoothConst: Optional[float] = None
    state_bounds: Optional[Tuple[float, float]] = None
    # input move-blocking (no reference counterpart; a standard real-time
    # MPC technique, here a throughput lever: the condensed QP's decision
    # dim and constraint count shrink with the number of free moves, and
    # the dense interior-point cost is ~quadratic in both).  Tuple of group
    # lengths over the FREE stages 1..Np-1 (u_0 is pinned), e.g. (1, 1, 1,
    # 1, 1, 4): the input is held constant within each group.  Must sum to
    # horizon-1.  Incompatible with input_smoothConst / state_bounds.
    input_blocks: Optional[Tuple[int, ...]] = None
    cost_running: float = 0.1
    cost_terminal: float = 100.0
    cost_input: Sequence[float] = (0.0,)  # scalar or per-input weights
    mpc_type: Optional[str] = None       # default: nonlinear iff model nonlinear
    load_obs_horizon: int = 10
    load_obs_period: int = 1
    # optional slope constraint |w_j - w_prev_j| <= load_obs_slope on the
    # load estimate vs the previous one (Kmpc.m:1336-1345 uses 0.01)
    load_obs_slope: Optional[float] = None
    # projection: indices of y-dims tracked by the reference (None = all).
    # The reference passes projmtx = model.C(end-1:end,:) to track only the
    # end effector; here we give the row indices into y instead.
    proj_idx: Optional[Tuple[int, ...]] = None
    # solver knobs (no reference counterpart: quadprog/fmincon internals)
    qp_iters: int = 12                   # interior-point iterations: 8
                                         # matches arm golden parity, and
                                         # the bilinear bench holds golden
                                         # quality at 3 (blocked + dual
                                         # warm).  The default is the
                                         # MEASURED snake-fourier floor
                                         # (64-lane 0.15-spread snake
                                         # grid): unblocked qp=10 loses
                                         # 16% of lanes, qp=12 is the
                                         # smallest all-alive count
                                         # (blocked holds at 10)
    qp_dual_warm: bool = False           # carry the previous step's QP
                                         # multipliers through the closed
                                         # loop as the interior-point dual
                                         # start (linear/bilinear MPC).
                                         # Opt-in: on the arm bench it holds
                                         # golden-parity error down to
                                         # qp_iters=4 (the bench uses it),
                                         # but harder problems (snake
                                         # fourier basis, loaded observer)
                                         # track better from the cold dual
                                         # start -- leave off unless
                                         # validated on your workload
    qp_dual_shift: bool = False          # with qp_dual_warm: permute the
                                         # carried multipliers one STAGE
                                         # forward before seeding (receding
                                         # horizon: the constraint active at
                                         # stage k+1 of the old problem is
                                         # the one near stage k of the new).
                                         # Input-row blocks only; any state-
                                         # bound rows keep their multiplier
    sqp_iters: int = 5                   # SQP relinearization passes (NMPC)
    sqp_dual_warm: bool = False          # carry each SQP pass's QP
                                         # multipliers into the next pass's
                                         # relinearized QP (damped, see
                                         # ops.qp lam0).  Off by default:
                                         # measured on the blockM batch it
                                         # speeds convergence on easy lanes
                                         # but can mislead hard transients
                                         # (validate on your workload)
    sqp_damping: float = 0.05            # Levenberg damping on the SQP step
                                         # (tames transient input saturation)
    sqp_linesearch: int = 0              # merit line-search halvings per SQP
                                         # pass (0 = full step; fmincon's sqp
                                         # line search, Kmpc.m:1167-1174)
    sqp_damping_decay: float = 1.0       # per-pass decay of sqp_damping
                                         # (trust-region-like schedule: heavy
                                         # damping early, Newton-like late)
    sqp_multistart: bool = False         # run cold-hold AND warm-shifted SQP
                                         # inits, keep the better rollout
                                         # merit (hedge against local optima)
    sqp_update: str = "rollout"          # between-pass Z update: 'rollout'
                                         # (feasible path, nonlinear re-roll)
                                         # or 'linear' (infeasible path along
                                         # the linearization, fmincon-like)
    sqp_init: str = "hold"               # first-pass linearization traj:
                                         # 'hold' (constant state, fmincon's
                                         # X0) or 'rollout' (held input
                                         # rolled through the model)
    sqp_best_of_passes: bool = False     # return the SQP iterate with the
                                         # lowest TRUE rollout merit across
                                         # passes (adaptive early stopping)
    sqp_jac_period: int = 1              # recompute the SQP Jacobians every
                                         # this many passes (1 = every pass,
                                         # exact Gauss-Newton).  Stale passes
                                         # reuse the frozen linearization's
                                         # sensitivity Sz and only refresh
                                         # the affine defect term -- a chord
                                         # Gauss-Newton that skips the
                                         # dominant jacfwd + S-scan cost
    bilinear_iters: int = 1              # QP<->rollout passes (Ksim.m:210 uses 1)
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class ArmConfig:
    """Planar N-link arm physical parameters (Arm_setup.m:12-52)."""

    Nmods: int = 3          # number of modules (actuated sections)
    nlinks: int = 1         # links per module
    L: float = 1.0          # total arm length (m)
    k: float = -1e-5        # joint stiffness
    d: float = 10.0         # joint viscous damping
    m: float = 0.1          # link mass (kg)
    g: float = 9.81
    ku: float = 10.0        # effective input stiffness
    Ts: float = 0.05        # sampling time (20 Hz)
    umax: float = math.pi / 2
    output_type: str = "markers"   # 'angles'|'markers'|'endeff'|'shape'
    # integrator knobs (reference uses adaptive ode45; the plant is stiff, so
    # the default is an L-stable implicit SDIRK2 with fixed substeps, which
    # maps onto lax.scan; 'rk4' needs substeps >= ~140 for stability)
    substeps: int = 10
    integrator: str = "sdirk2"      # 'sdirk2' | 'rk4' | 'rk45'
    newton_iters: int = 3           # SDIRK2 stage Newton iterations
    jac_mode: str = "substep"       # SDIRK2 Jacobian refresh: 'substep'
                                    # (default), 'step' (one per Ts), or
                                    # 'stage' (exact Newton)

    @property
    def Nlinks(self) -> int:
        return self.Nmods * self.nlinks

    @property
    def l(self) -> float:
        return self.L / self.Nlinks

    @property
    def i(self) -> float:
        # link inertia: (1/3) m l^2  (Arm_setup.m:35)
        return (1.0 / 3.0) * self.m * self.l ** 2

    @property
    def nx(self) -> int:
        return self.Nlinks * 2

    @property
    def nu(self) -> int:
        return self.Nmods

    @property
    def nw(self) -> int:
        return 2

    @property
    def markerPos(self) -> Tuple[float, ...]:
        # Arm_setup.m:39
        return tuple((i * self.l * self.nlinks) / self.L for i in range(self.Nmods + 1))

    @property
    def ny(self) -> int:
        return {
            "angles": self.Nlinks,
            "markers": 2 * self.Nmods,
            "endeff": 2,
            "shape": 6,
        }[self.output_type]


def to_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg), default=str, indent=2)


def from_json(cls, s: str):
    d = json.loads(s)
    return cls(**d)
