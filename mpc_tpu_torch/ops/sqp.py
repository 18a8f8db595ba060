"""Solver data layer of the augmented-Lagrangian SQP (``mpc_tpu.ops.sqp``).

The configuration, the warm-startable state, the per-solve parameters and
the solution, plus the helpers that build and widen them.  The solve itself
is ``ops.fused_gn``; the per-lane and lanes-trailing engines of the JAX
package (``sqp.solve``, ``sqp_vec``) are later items of ROADMAP queue A.

Every tensor carries an explicit leading lane axis where the JAX package
vmaps: ``OcpParams.x0`` is (B, NX), ``SqpState.U`` is (B, H, NU), and so on.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mpc_tpu_torch.models import constraints as C
from mpc_tpu_torch.models import costs as cost_mod
from mpc_tpu_torch.models import dynamics as dyn_mod

NX = dyn_mod.NX
NU = dyn_mod.NU
# 10 formulation rows (friction + 9 circle rows) + 4 box rows (u0,u1,delta,v)
NROWS = C.NUM_INEQ + 4


def nrows(cfg) -> int:
    """Stage row count: base rows + optional road-boundary rows."""
    return NROWS + (C.NUM_BOUNDARY if cfg.boundary_rows else 0)


def row_scales(cfg, dtype=torch.float32, device=None) -> torch.Tensor:
    """Per-row violation scales, (nrows,): the friction row is scaled by its
    bound (a_max^2 for forcespro, a_max for casadi) so that ``viol`` is
    bound-relative for it and in meters for every other row."""
    s = np.ones((nrows(cfg),), np.float64)
    s[0] = cfg.a_max ** 2 if cfg.formulation == "forcespro" else cfg.a_max
    return torch.as_tensor(s, dtype=dtype, device=device)


def _default_bounds():
    inf = float("inf")
    return C.BoxBounds(u_lo=(-0.4, -11.5), u_hi=(0.4, 11.5),
                       x_lo=(-inf, -inf, -1.066, 0.0, -inf),
                       x_hi=(inf, inf, 1.066, 50.8, inf))


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver configuration; the fields, defaults and checks of
    ``mpc_tpu.ops.sqp.SolverConfig``."""

    horizon: int
    dt: float = 0.1
    wheelbase: float = 2.578
    integrator: str = "rk4"          # 'rk4' (forcespro) | 'euler' (casadi)
    model: str = "ks"                # 'ks' (5-state) | 'st' (7-state)
    vehicle: object = None           # VehicleParams; required for 'st'
    formulation: str = "forcespro"   # constraint algebra variant
    ego_length: float = 4.508
    ego_width: float = 1.610
    a_max: float = 11.5
    bounds: C.BoxBounds = dataclasses.field(default_factory=_default_bounds)
    use_terminal_cost: bool = True   # False for CasADi parity
    sqp_iters: int = 4               # inner Gauss-Newton iterations per AL step
    al_iters: int = 3                # outer multiplier/penalty updates
    reg: float = 1e-6                # Quu regularization
    mu0: float = 10.0                # initial AL penalty
    mu_factor: float = 8.0           # penalty growth for stalled rows
    mu_max: float = 1e5              # per-row penalty ceiling
    viol_improve: float = 0.25       # a row improves if its violation fell
                                     # to this fraction
    lam_max: float = 1e6             # multiplier clamp
    alphas: Tuple[float, ...] = (1.0, 0.35, 0.12, 0.04, 0.012, 1e-3)
                                     # line-search ladder; () applies the
                                     # full step unguarded (maxqps=1)
    tol_stat: float = 0.5            # KKT stationarity tolerance (status)
    tol_stat_ip: float = 1.0         # Lagrangian stationarity (ip status)
    tol_feas: float = 1e-4           # constraint violation tolerance (status)
    tol_infeas: float = 0.05         # violation above which status is -7
    lqr_backend: str = "scan"        # 'scan' | 'pscan'
    stage_axis: Optional[str] = None  # mesh axis of the stage dimension
    boundary_rows: bool = False      # road-boundary rows
    method: str = "al"               # 'al' | 'ip'
    engine: str = "auto"             # 'auto' | 'xla' | 'fused'
    ip_sqp_iters: int = 5            # SQP linearizations per solve (ip)
    ip_iters: int = 10               # IP Newton steps per QP (ip)
    ip_warm_duals: bool = False      # warm-start the first QP's row duals
    ip_alphas: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1, 0.03)
    ip_ls_rho: float = 300.0         # exact-penalty weight (ip line search)

    def __post_init__(self):
        # YAML delivers ladders as lists; the config must stay hashable
        for f in ("alphas", "ip_alphas"):
            v = getattr(self, f)
            if not isinstance(v, tuple):
                object.__setattr__(self, f, tuple(v))
        if self.horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {self.horizon}")
        if self.integrator not in ("rk4", "euler"):
            raise ValueError(f"unknown integrator '{self.integrator}'")
        if self.model not in ("ks", "st"):
            raise ValueError(f"unknown model '{self.model}' (ks|st)")
        if self.model == "st" and self.vehicle is None:
            raise ValueError("model='st' requires vehicle=VehicleParams")
        if self.formulation not in ("forcespro", "casadi"):
            raise ValueError(f"unknown formulation '{self.formulation}'")
        if self.lqr_backend not in ("scan", "pscan"):
            raise ValueError(f"unknown lqr_backend '{self.lqr_backend}'")
        if self.method not in ("al", "ip"):
            raise ValueError(f"unknown method '{self.method}' (al|ip)")
        if self.engine not in ("auto", "xla", "fused"):
            raise ValueError(
                f"unknown engine '{self.engine}' (auto|xla|fused)")
        if self.sqp_iters < 1 or self.al_iters < 1:
            raise ValueError("sqp_iters and al_iters must be >= 1")


class SqpState(NamedTuple):
    """Warm-startable solver state, lanes leading."""

    U: torch.Tensor          # (B, H, NU) input trajectory
    lam_lo: torch.Tensor     # (B, H+1, NROWS) multipliers for lo - h <= 0
    lam_hi: torch.Tensor     # (B, H+1, NROWS) multipliers for h - hi <= 0
    mu: torch.Tensor         # (B, H+1, NROWS) per-row AL penalties
    prev_viol: torch.Tensor  # (B, H+1, NROWS) violation at the last update

    def map(self, fn) -> "SqpState":
        return SqpState(*(fn(t) for t in self))


class OcpParams(NamedTuple):
    """Per-solve runtime parameters, lanes leading.

    x0 (B, NX); x_ref (B, H+1, NX), row k targets X_k; obs_centers (B, 3, 2)
    static or (B, H+1, 3, 2) per-stage (moving obstacle); min_dist (B,)
    r_ego + r_obs; weights with (B, .) fields.
    """

    x0: torch.Tensor
    x_ref: torch.Tensor
    obs_centers: torch.Tensor
    min_dist: torch.Tensor
    weights: cost_mod.Weights
    boundaries: Optional[torch.Tensor] = None      # (B, 2, NB, 2)
    boundary_signs: Optional[torch.Tensor] = None  # (B, 2)


class Solution(NamedTuple):
    X: torch.Tensor          # (B, H+1, NX) optimal states
    U: torch.Tensor          # (B, H, NU) optimal inputs
    state: SqpState          # warm-start state for the next solve
    status: torch.Tensor     # (B,) int32: 1 converged, 0 max-iters, -7
    kkt_stat: torch.Tensor   # (B,) stationarity residual (inf-norm)
    viol: torch.Tensor       # (B,) max scaled constraint violation
    cost: torch.Tensor       # (B,) objective value at the solution
    merit: torch.Tensor      # (B,) final AL merit


def solver_nx(cfg: SolverConfig) -> int:
    """State dimension of the configured dynamics model."""
    return dyn_mod.nx_of(cfg.model)


def normalize_params(cfg: SolverConfig, params: OcpParams) -> OcpParams:
    """Widen 5-column KS-schema params to the configured model's NX.

    Extra state columns (psiDot, beta) get zero reference and zero weight,
    and a short x0 is completed kinematically.  Only trailing axes are
    touched, so it is batch-safe.
    """
    nxv = solver_nx(cfg)
    have = params.x_ref.shape[-1]
    if have == nxv:
        return params
    if have != dyn_mod.NX:
        raise ValueError(
            f"x_ref has {have} state columns; want {dyn_mod.NX} or {nxv}")
    pad = nxv - have
    x_ref = torch.cat([params.x_ref,
                       params.x_ref.new_zeros(params.x_ref.shape[:-1]
                                              + (pad,))], dim=-1)
    w = params.weights
    zeros = w.q.new_zeros(w.q.shape[:-1] + (pad,))
    weights = cost_mod.Weights(q=torch.cat([w.q, zeros], dim=-1), r=w.r,
                               qN=torch.cat([w.qN, zeros], dim=-1))
    x0 = params.x0
    if x0.shape[-1] == have:
        veh = cfg.vehicle
        lr = veh.b if veh is not None else 0.5 * cfg.wheelbase
        x0 = dyn_mod.ks_to_st_state(x0, cfg.wheelbase, lr)
    return params._replace(x0=x0, x_ref=x_ref, weights=weights)


def init_state(cfg: SolverConfig, U0: Optional[torch.Tensor] = None,
               dtype=torch.float32, device=None,
               batch: Optional[int] = None) -> SqpState:
    """Fresh solver state (cold start); ``batch`` adds a leading lane axis.

    prev_viol starts at zero, so any initially violated row counts as
    stalled on the first outer update and is stiffened at once.
    """
    H = cfg.horizon
    lead = () if batch is None else (batch,)
    if U0 is None:
        U = torch.zeros(lead + (H, NU), dtype=dtype, device=device)
    else:
        U = torch.broadcast_to(U0.to(dtype=dtype, device=device),
                               lead + (H, NU)).clone()
    nr = nrows(cfg)
    shape = lead + (H + 1, nr)
    return SqpState(
        U=U,
        lam_lo=torch.zeros(shape, dtype=dtype, device=device),
        lam_hi=torch.zeros(shape, dtype=dtype, device=device),
        mu=torch.full(shape, cfg.mu0, dtype=dtype, device=device),
        prev_viol=torch.zeros(shape, dtype=dtype, device=device))
