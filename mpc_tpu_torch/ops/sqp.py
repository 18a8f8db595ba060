"""The SQP solver's data layer, model assembly and per-lane solve
(``mpc_tpu.ops.sqp``).

The configuration, the warm-startable state, the per-solve parameters and
the solution, the helpers that build and widen them, and the model of one
Gauss-Newton step: the stage rows, the AL terms, the objective and merit,
the rollout, the row Jacobians (``torch.func.jacfwd`` of the rows under
``torch.func.vmap``), the stagewise quadratic, the linearized dynamics and
the KKT residuals (``torch.func.grad`` of the merit through the rollout).

:func:`solve_batch` is the per-lane path of the JAX package (its vmapped
``sqp.solve``), written once over a leading lane axis; :func:`solve` is it
at one lane.  ``method='al'`` runs the batched AL algorithm of
``ops.sqp_vec`` with the per-lane sweep ``riccati.backward_pass``, or
``ops.pscan``'s for ``lqr_backend='pscan'``;
``method='ip'`` runs the RTI-SQP over the interior-point stagewise QP
(``ops.ipqp``).  The fused engines are ``ops.fused_gn`` and
``ops.fused_ip``.

Every tensor carries an explicit leading lane axis where the JAX package
vmaps: ``OcpParams.x0`` is (B, NX), ``SqpState.U`` is (B, H, NU), and so on.
The model functions broadcast over any further leading axes, so the merits
of all line-search rungs are one call.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mpc_tpu_torch.device import resolve_device
from mpc_tpu_torch.models import constraints as C
from mpc_tpu_torch.models import costs as cost_mod
from mpc_tpu_torch.models import dynamics as dyn_mod
from mpc_tpu_torch.ops import ipqp
from mpc_tpu_torch.ops import riccati

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


# ---------------------------------------------------------------------------
# Model assembly: the model of one Gauss-Newton step
# ---------------------------------------------------------------------------


def _step_fn(cfg: SolverConfig):
    return dyn_mod.make_step_fn(cfg.integrator, cfg.dt, cfg.wheelbase,
                                cfg.model, cfg.vehicle)


def _stage_rows(cfg: SolverConfig, x, u, obs: C.ObstacleParams, stage_idx,
                boundaries=None, boundary_signs=None):
    """All ``nrows(cfg)`` two-sided rows of stages: formulation rows, then
    the box rows [u0, u1, delta, v], then the optional boundary rows.

    x (..., NX), u (..., NU), obs and the boundaries broadcast against
    them; ``stage_idx`` is an integer tensor of the stage of each (stage H
    is terminal: its inputs are masked to 0 and its u rows are unbounded).
    Returns (h, lo, hi), each (..., nrows).
    """
    if not torch.is_tensor(stage_idx):
        stage_idx = torch.as_tensor(stage_idx, device=x.device)
    is_term = stage_idx >= cfg.horizon
    u_eff = torch.where(is_term[..., None], torch.zeros_like(u), u)
    if cfg.formulation == "forcespro":
        h, lo, hi = C.stage_ineq_forcespro(
            x, u_eff, obs, cfg.ego_length, cfg.ego_width, cfg.wheelbase,
            cfg.a_max)
    elif cfg.formulation == "casadi":
        h, lo, hi = C.stage_ineq_casadi(
            x, u_eff, obs, cfg.ego_length, cfg.ego_width, cfg.wheelbase,
            cfg.a_max, friction_active=(stage_idx == 0))
    else:
        raise ValueError(f"unknown formulation '{cfg.formulation}'")
    shape = h.shape[:-1]
    bnd = cfg.bounds
    inf = float("inf")

    def full(v):
        return torch.full(shape, v, dtype=x.dtype, device=x.device)

    def u_bound(v, unbounded):
        return torch.where(is_term, full(unbounded), full(v))

    box_h = torch.stack([torch.broadcast_to(t, shape) for t in (
        u_eff[..., 0], u_eff[..., 1], x[..., 2], x[..., 3])], -1)
    box_lo = torch.stack([u_bound(bnd.u_lo[0], -inf),
                          u_bound(bnd.u_lo[1], -inf),
                          full(bnd.x_lo[2]), full(bnd.x_lo[3])], -1)
    box_hi = torch.stack([u_bound(bnd.u_hi[0], inf),
                          u_bound(bnd.u_hi[1], inf),
                          full(bnd.x_hi[2]), full(bnd.x_hi[3])], -1)
    hs, los, his = [h, box_h], [lo, box_lo], [hi, box_hi]
    if cfg.boundary_rows:
        if boundaries is None or boundary_signs is None:
            raise ValueError(
                "boundary_rows=True needs params.boundaries + signs")
        r_ego, _ = C.approx_circle_radius(cfg.ego_length, cfg.ego_width)
        bh, blo, bhi = C.boundary_rows(x, cfg.ego_length, cfg.ego_width,
                                       boundaries, boundary_signs, r_ego)
        hs.append(torch.broadcast_to(bh, shape + bh.shape[-1:]))
        los.append(torch.broadcast_to(blo, shape + blo.shape[-1:]))
        his.append(torch.broadcast_to(bhi, shape + bhi.shape[-1:]))
    return torch.cat(hs, -1), torch.cat(los, -1), torch.cat(his, -1)


def _stage_obs(params: OcpParams, k) -> C.ObstacleParams:
    """Obstacle circles of stages ``k`` (an integer tensor (S,)): centers
    (B, S, 3, 2), min_dist (B, S); static obstacles repeat their centers,
    moving ones (B, H+1, 3, 2) are indexed."""
    k = torch.as_tensor(k, device=params.x0.device)
    c = params.obs_centers
    centers = (c[:, k] if c.dim() == 4
               else c[:, None].expand(c.shape[:1] + k.shape + c.shape[1:]))
    return C.ObstacleParams(
        centers=centers,
        min_dist=params.min_dist[:, None].expand(c.shape[:1] + k.shape))


def _stage_boundaries(params: OcpParams, n: int):
    """Boundaries (B, n, 2, NB, 2) and signs (B, n, 2) repeated over n
    stages (views), or (None, None)."""
    if params.boundaries is None or params.boundary_signs is None:
        return None, None
    b, s = params.boundaries, params.boundary_signs
    return (b[:, None].expand((b.shape[0], n) + b.shape[1:]),
            s[:, None].expand((s.shape[0], n) + s.shape[1:]))


def _all_rows(cfg: SolverConfig, X, U, params: OcpParams):
    """Rows of all H+1 stages, h, lo, hi each (..., B, H+1, nrows); X
    (..., B, H+1, NX) and U (..., B, H, NU) may carry leading axes."""
    U_ext = torch.cat([U, U[..., -1:, :]], dim=-2)  # stage H reuses U[H-1]
    idx = torch.arange(cfg.horizon + 1, device=X.device)
    bnd, sgn = _stage_boundaries(params, cfg.horizon + 1)
    return _stage_rows(cfg, X, U_ext, _stage_obs(params, idx), idx, bnd, sgn)


def _al_terms(h, lo, hi, lam_lo, lam_hi, mu):
    """AL penalty value, d(psi)/dh and active-set GN diagonal, elementwise.

    For one-sided c <= 0 with multiplier lam >= 0:
        psi = (1/2mu) * (max(0, lam + mu c)^2 - lam^2)
    Infinite bounds are handled by guarding every product with the active
    mask (no inf * 0 NaNs, also under ``torch.func.grad``).
    """
    t_hi = lam_hi + mu * (h - hi)
    t_lo = lam_lo + mu * (lo - h)
    act_hi = t_hi > 0
    act_lo = t_lo > 0
    zero = torch.zeros_like(t_hi)
    m_hi = torch.where(act_hi, t_hi, zero)
    m_lo = torch.where(act_lo, t_lo, zero)
    psi = (m_hi * m_hi - lam_hi * lam_hi
           + m_lo * m_lo - lam_lo * lam_lo) / (2.0 * mu)
    grad_h = m_hi - m_lo
    gn_diag = mu * (act_hi.to(h.dtype) + act_lo.to(h.dtype))
    return psi, grad_h, gn_diag


def _objective(cfg: SolverConfig, X, U, params: OcpParams):
    """Tracking objective per lane, (..., B): the stage costs of states
    0..H-1 and, with ``use_terminal_cost``, the terminal cost."""
    w = params.weights
    stage = cost_mod.stage_cost(X[..., :-1, :], U, params.x_ref[..., :-1, :],
                                w.map(lambda t: t[:, None]))
    obj = torch.sum(stage, -1)
    if cfg.use_terminal_cost:
        obj = obj + cost_mod.terminal_cost(X[..., -1, :],
                                           params.x_ref[..., -1, :], w)
    return obj


def _merit(cfg: SolverConfig, X, U, params: OcpParams, lam_lo, lam_hi, mu):
    """AL merit per lane, (..., B): objective + every row's psi."""
    h, lo, hi = _all_rows(cfg, X, U, params)
    psi, _, _ = _al_terms(h, lo, hi, lam_lo, lam_hi, mu)
    return _objective(cfg, X, U, params) + torch.sum(psi, (-2, -1))


def _rollout(cfg: SolverConfig, x0, U):
    """States (..., B, H+1, NX) of the inputs U (..., B, H, NU) from x0
    (B, NX); U may carry leading axes (line-search rungs)."""
    step = _step_fn(cfg)
    xs = [x0.expand(U.shape[:-2] + x0.shape[-1:])]
    for k in range(U.shape[-2]):
        xs.append(step(xs[-1], U[..., k, :]))
    return torch.stack(xs, -2)


def _row_jacobians(cfg: SolverConfig, X, U, params: OcpParams):
    """Jacobians of every stage's rows in (x, u), (B, H+1, nrows, NX+NU),
    by ``jacfwd`` of the rows of one stage under ``vmap`` over lanes and
    stages (the terminal stage's u columns are zero: its inputs are
    masked)."""
    H = cfg.horizon
    nxv = X.shape[-1]
    idx = torch.arange(H + 1, device=X.device)
    U_ext = torch.cat([U, U[:, -1:]], dim=1)
    Z = torch.cat([X, U_ext], dim=-1)                  # (B, H+1, NX+NU)
    obs = _stage_obs(params, idx)
    bnd, sgn = params.boundaries, params.boundary_signs

    def rows_z(z, k, centers, mind, b, s):
        hh, _, _ = _stage_rows(cfg, z[:nxv], z[nxv:],
                               C.ObstacleParams(centers, mind), k, b, s)
        return hh

    b_dims = None if bnd is None else 0
    per_stage = torch.func.vmap(torch.func.jacfwd(rows_z),
                                in_dims=(0, 0, 0, 0, None, None))
    per_lane = torch.func.vmap(per_stage,
                               in_dims=(0, None, 0, 0, b_dims, b_dims))
    # jacfwd may carry the tangents in float64 (Python scalars meeting
    # 0-dim tensors); the model is in X's dtype
    return per_lane(Z, idx, obs.centers, obs.min_dist, bnd, sgn).to(X.dtype)


def _cost_terminal(cfg: SolverConfig, w: cost_mod.Weights, dx_H):
    """The terminal cost's Hessian (B, NX, NX) and gradient (B, NX) at
    the terminal state's offset ``dx_H`` (zero without a terminal cost)."""
    if cfg.use_terminal_cost:
        return torch.diag_embed(2.0 * w.qN), 2.0 * w.qN * dx_H
    B, nxv = dx_H.shape
    return (dx_H.new_zeros((B, nxv, nxv)), dx_H.new_zeros((B, nxv)))


def _build_quadratic(cfg: SolverConfig, X, U, params: OcpParams,
                     lam_lo, lam_hi, mu):
    """Stagewise AL-Gauss-Newton quadratic model around (X, U): the row
    Jacobians (:func:`_row_jacobians`), then J' g_h and J' diag(gn) J plus
    the exact cost terms.  Returns (StageQuad (B, H, ...), QH (B, NX, NX),
    qH (B, NX))."""
    w = params.weights
    nxv = X.shape[-1]
    J = _row_jacobians(cfg, X, U, params)

    h, lo, hi = _all_rows(cfg, X, U, params)
    _, grad_h, gn_diag = _al_terms(h, lo, hi, lam_lo, lam_hi, mu)
    g_con = torch.sum(J * grad_h[..., None], -2)          # (B, H+1, NZ)
    H_con = torch.matmul((J * gn_diag[..., None]).transpose(-1, -2), J)

    dx = X - params.x_ref
    g_cost_x = 2.0 * w.q[:, None] * dx                    # (B, H+1, NX)
    g_cost_u = 2.0 * w.r[:, None] * U                     # (B, H, NU)
    Q_cost = torch.diag_embed(2.0 * w.q)                  # (B, NX, NX)
    R_cost = torch.diag_embed(2.0 * w.r)

    Qs = Q_cost[:, None] + H_con[:, :-1, :nxv, :nxv]
    Rs = R_cost[:, None] + H_con[:, :-1, nxv:, nxv:]
    Ms = H_con[:, :-1, :nxv, nxv:]
    qx = g_cost_x[:, :-1] + g_con[:, :-1, :nxv]
    qu = g_cost_u + g_con[:, :-1, nxv:]
    QH_cost, gH_cost = _cost_terminal(cfg, w, dx[:, -1])
    QH = QH_cost + H_con[:, -1, :nxv, :nxv]
    qH = gH_cost + g_con[:, -1, :nxv]
    quad = riccati.StageQuad(Q=Qs, R=Rs, M=Ms, qx=qx, qu=qu)
    return quad, QH, qH


def _linearize_dynamics(cfg: SolverConfig, X, U):
    """(A, B) of the discrete step at every (lane, stage) by ``jacfwd``
    under ``vmap``; the defect r is zero (the rollout keeps X consistent
    with U)."""
    step = _step_fn(cfg)
    jac = torch.func.vmap(torch.func.vmap(
        torch.func.jacfwd(step, argnums=(0, 1))))
    A, Bm = jac(X[:, :-1], U)
    return riccati.LinDyn(A=A.to(X.dtype), B=Bm.to(X.dtype),
                          r=torch.zeros_like(X[:, :-1]))


def _kkt_residuals(cfg: SolverConfig, params: OcpParams, X, U,
                   lam_lo, lam_hi, mu):
    """Stationarity of the AL (inf-norm of the merit's gradient in U,
    through the rollout) and the max scaled violation, each (B,)."""
    def merit_of_U(Uf):
        Xf = _rollout(cfg, params.x0, Uf)
        return torch.sum(_merit(cfg, Xf, Uf, params, lam_lo, lam_hi, mu))

    g = torch.func.grad(merit_of_U)(U)
    stat = torch.amax(torch.abs(g), (-2, -1))
    h, lo, hi = _all_rows(cfg, X, U, params)
    return stat, _max_scaled_viol(cfg, h, lo, hi)


def _max_scaled_viol(cfg: SolverConfig, h, lo, hi):
    """max over stages and rows of max(lo - h, h - hi, 0) / row_scales,
    non-finite violations counted as 0; (..., B)."""
    viol = torch.clamp(torch.maximum(lo - h, h - hi), min=0.0)
    viol = torch.where(torch.isfinite(viol), viol, torch.zeros_like(viol))
    return torch.amax(viol / row_scales(cfg, viol.dtype, viol.device),
                      (-2, -1))


# ---------------------------------------------------------------------------
# The per-lane solve
# ---------------------------------------------------------------------------


def map_tensors(tree, fn):
    """``fn`` applied to every tensor of a (nested) NamedTuple of tensors,
    ``Weights`` and ``None``s: lift, move or slice a whole problem."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, cost_mod.Weights):
        return tree.map(fn)
    return type(tree)(*(map_tensors(t, fn) for t in tree))


def _pick(merits, merit0):
    """The ladder's rung per lane, 0 for the iterate and r + 1 for rung r
    of ``merits`` (R, B): the first rung of least merit (``argmin`` with
    NaN first, as ``jnp.argmin``), taken only when it beats ``merit0``."""
    nan = torch.isnan(merits)
    best = torch.where(nan.any(0), nan.to(torch.int8).argmax(0),
                       merits.argmin(0))
    improved = merits.gather(0, best[None])[0] < merit0
    return torch.where(improved, best + 1, torch.zeros_like(best))


def _ip_penalty(cfg: SolverConfig, X, U, params: OcpParams, scales):
    """The exact-penalty merit of the IP line search, (..., B): objective
    + ip_ls_rho * the sum of the scaled violations (non-finite counted as
    0); NaN becomes inf, so a NaN trial never wins."""
    h, lo, hi = _all_rows(cfg, X, U, params)
    v = torch.clamp(torch.maximum(lo - h, h - hi), min=0.0)
    v = torch.where(torch.isfinite(v), v, torch.zeros_like(v)) / scales
    phi = _objective(cfg, X, U, params) + cfg.ip_ls_rho * torch.sum(
        v, (-2, -1))
    return torch.where(torch.isnan(phi), torch.full_like(phi, float("inf")),
                       phi)


def _ip_qp(cfg: SolverConfig, params: OcpParams, X, U) -> ipqp.QpData:
    """The IP stagewise QP at (X, U): the exact cost quadratic, the
    linearized dynamics with the multiple-shooting defect, and the rows
    with their Jacobians."""
    w = params.weights
    B, H, nxv = X.shape[0], cfg.horizon, X.shape[-1]
    dyn = _linearize_dynamics(cfg, X, U)
    defect = _step_fn(cfg)(X[:, :-1], U) - X[:, 1:]
    h0, lo, hi = _all_rows(cfg, X, U, params)
    dx = X - params.x_ref
    QH, qH = _cost_terminal(cfg, w, dx[:, -1])
    return ipqp.QpData(
        Q=torch.diag_embed(2.0 * w.q)[:, None].expand(B, H, nxv, nxv),
        R=torch.diag_embed(2.0 * w.r)[:, None].expand(B, H, NU, NU),
        M=X.new_zeros((B, H, nxv, NU)),
        qx=2.0 * w.q[:, None] * dx[:, :-1], qu=2.0 * w.r[:, None] * U,
        QH=QH, qH=qH, A=dyn.A, B=dyn.B, r=defect,
        J=_row_jacobians(cfg, X, U, params), h0=h0, lo=lo, hi=hi)


def _solve_ip(cfg: SolverConfig, params: OcpParams,
              state: SqpState) -> Solution:
    """RTI-SQP over the interior-point stagewise QP, every lane at once.

    Each of the ``ip_sqp_iters`` iterations linearizes cost, dynamics and
    rows at the trajectory, solves the QP (``ipqp.solve_qp``, its duals
    warm-started from the carried ones with ``ip_warm_duals``), scrubs a
    non-finite step to 0 and either applies the full step (``ip_alphas ==
    ()``) or takes the exact-penalty ladder's best rung where it beats the
    iterate.  The final duals go to lam_lo / lam_hi for the next solve; the
    status comes from the stationarity of the dual-weighted Lagrangian.
    """
    dtype, dev = params.x0.dtype, params.x0.device
    B, H = params.x0.shape[0], cfg.horizon
    u_lo, u_hi, _, _ = cfg.bounds.as_arrays(dtype, dev)
    scales = row_scales(cfg, dtype, dev)
    X = _rollout(cfg, params.x0, state.U)
    U = state.U
    if cfg.ip_warm_duals:
        z_lo, z_hi = state.lam_lo, state.lam_hi
    else:
        z_lo = torch.zeros((B, H + 1, nrows(cfg)), dtype=dtype, device=dev)
        z_hi = torch.zeros_like(z_lo)
    ladder = torch.tensor((0.0,) + cfg.ip_alphas, dtype=dtype, device=dev)
    lane = torch.arange(B, device=dev)
    for _ in range(cfg.ip_sqp_iters):
        qp = _ip_qp(cfg, params, X, U)
        warm = cfg.ip_warm_duals
        st = ipqp.solve_qp(qp, n_iters=cfg.ip_iters, reg=cfg.reg,
                           z_lo0=z_lo if warm else None,
                           z_hi0=z_hi if warm else None)
        dU = torch.nan_to_num(st.dU, nan=0.0, posinf=0.0, neginf=0.0)
        if len(cfg.ip_alphas) == 0:
            # the unguarded RTI step: applied with no merit test
            U = torch.clamp(U + dU, u_lo, u_hi)
            X = _rollout(cfg, params.x0, U)
        else:
            # rung 0 (alpha = 0) is the iterate's own merit
            Ua = torch.clamp(U + ladder[:, None, None, None] * dU, u_lo,
                             u_hi)
            Xa = _rollout(cfg, params.x0, Ua)
            phi = _ip_penalty(cfg, Xa, Ua, params, scales)
            rung = _pick(phi[1:], phi[0])
            take = (rung > 0)[:, None, None]
            X = torch.where(take, Xa[rung, lane], X)
            U = torch.where(take, Ua[rung, lane], U)
        z_lo, z_hi = st.z_lo, st.z_hi

    # the final consistency rollout of the clamped inputs
    U = torch.clamp(U, u_lo, u_hi)
    X = _rollout(cfg, params.x0, U)
    h, lo, hi = _all_rows(cfg, X, U, params)
    viol = torch.clamp(torch.maximum(lo - h, h - hi), min=0.0)
    viol = torch.where(torch.isfinite(viol), viol, torch.zeros_like(viol))
    viol_max = torch.amax(viol / scales, (-2, -1))

    # stationarity of the Lagrangian with the final QP's row duals
    lam_rows = z_hi - z_lo

    def lagrangian_of_U(Uf):
        Xf = _rollout(cfg, params.x0, Uf)
        hf, _, _ = _all_rows(cfg, Xf, Uf, params)
        hf = torch.where(torch.isfinite(hf), hf, torch.zeros_like(hf))
        return torch.sum(_objective(cfg, Xf, Uf, params)
                         + torch.sum(lam_rows * hf, (-2, -1)))

    stat = torch.amax(torch.abs(torch.func.grad(lagrangian_of_U)(U)),
                      (-2, -1))
    converged = (stat < cfg.tol_stat_ip) & (viol_max < cfg.tol_feas)
    feasible = viol_max < cfg.tol_infeas
    one = torch.ones_like(stat, dtype=torch.int32)
    status = torch.where(converged, one,
                         torch.where(feasible, 0 * one, -7 * one))
    new_state = state._replace(U=U, lam_lo=z_lo, lam_hi=z_hi,
                               prev_viol=viol)
    cost = _objective(cfg, X, U, params)
    return Solution(X=X, U=U, state=new_state, status=status, kkt_stat=stat,
                    viol=viol_max, cost=cost, merit=cost)


def lqr_sweep(cfg: SolverConfig, mesh=None):
    """The per-lane AL path's Riccati sweep for ``cfg.lqr_backend``:
    ``riccati.backward_pass`` ('scan') or ``pscan.backward_pass_pscan``
    ('pscan'), the latter with its stage axis sharded over the ranks of
    ``mesh`` along ``cfg.stage_axis`` when that is set.  A stage axis
    without a mesh raises ``ValueError`` (the JAX package needs an ambient
    mesh there)."""
    if cfg.lqr_backend != "pscan":
        return riccati.backward_pass
    from mpc_tpu_torch.ops import pscan
    if cfg.stage_axis is None:
        return pscan.backward_pass_pscan
    if mesh is None:
        raise ValueError(f"stage_axis={cfg.stage_axis!r} needs a mesh "
                         "(parallel.mesh.make_mesh) to shard the stages")
    return functools.partial(pscan.backward_pass_pscan, mesh=mesh,
                             axis=cfg.stage_axis)


def solve_batch(cfg: SolverConfig, params: OcpParams, state: SqpState,
                device=None, mesh=None) -> Solution:
    """The per-lane solve of every lane (``mpc_tpu``'s ``sqp.solve_batch``,
    the vmapped ``sqp.solve``), lanes leading.

    Runs on ``device`` (default: the GPU, see ``resolve_device``); the
    inputs are moved there, in their own dtype (float32 or float64).
    ``method='al'``: ``al_iters`` multiplier updates around ``sqp_iters``
    Gauss-Newton steps, the batched algorithm of ``ops.sqp_vec`` with the
    sweep :func:`lqr_sweep` picks (``mesh``: the ranks its stage axis is
    sharded over); ``method='ip'``: :func:`_solve_ip`, which has its own
    sweep and ignores ``lqr_backend``, as in the JAX package.
    """
    if cfg.method == "al":
        from mpc_tpu_torch.ops import sqp_vec
        return sqp_vec.solve_batch_vec(cfg, params, state, device=device,
                                       sweep=lqr_sweep(cfg, mesh))
    dev = resolve_device(device)
    params = map_tensors(normalize_params(cfg, params), lambda t: t.to(dev))
    state = state.map(lambda t: t.to(dev))
    return _solve_ip(cfg, params, state)


def solve(cfg: SolverConfig, params: OcpParams, state: SqpState,
          device=None) -> Solution:
    """One NMPC problem: params and state without a lane axis (x0 (NX,),
    U (H, NU), ...); :func:`solve_batch` at one lane."""
    sol = solve_batch(cfg, map_tensors(params, lambda t: t[None]),
                      state.map(lambda t: t[None]), device)
    return map_tensors(sol, lambda t: t[0])
