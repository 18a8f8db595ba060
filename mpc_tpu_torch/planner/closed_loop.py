"""Receding-horizon closed loops (``mpc_tpu.planner.closed_loop``).

Every lane runs T steps of

    reference window -> warm-started solve -> status gate -> plant step
    -> shift

after the configured cold-start solves.  :func:`make_loop_config` and
:func:`make_loop_params` turn a ``PlanningConfig`` into a loop.  The loop
is written once over a leading lane axis: :func:`closed_loop_batch_vec`
solves each step with one launch of a fused kernel (``ops.fused_gn``,
``ops.fused_ip``) or with the lanes-leading engine ``ops.sqp_vec``
(``engine='xla'``); :func:`closed_loop_batch` with the per-lane solve
``sqp.solve_batch``, which ``closed_loop_batch_vec`` also takes where the
JAX package falls back to its vmapped path (``engine='xla'`` with
``method='ip'``).  :func:`run_closed_loop` is one lane's loop, and
:func:`init_carry` / :func:`closed_loop_chunk` run it a few steps at a
time from an explicit carry.  :func:`init_batch_carry` /
:func:`closed_loop_batch_step` serve the batched loop a step at a time
from measured states, through the same step as
:func:`closed_loop_batch_vec`.  The JAX package traces the steps into one
``lax.scan`` and compiles it with ``closed_loop_jit``; here the steps are a
Python loop over eager PyTorch ops and kernel launches, so that wrapper has
no counterpart.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from mpc_tpu_torch.device import resolve_device
from mpc_tpu_torch.io.config import PlanningConfig
from mpc_tpu_torch.models import constraints as C
from mpc_tpu_torch.models import costs as cost_mod
from mpc_tpu_torch.models import dynamics as dyn_mod
from mpc_tpu_torch.ops import fused_gn
from mpc_tpu_torch.ops import fused_ip
from mpc_tpu_torch.ops import sqp
from mpc_tpu_torch.ops import sqp_vec
from mpc_tpu_torch.planner import reference as ref_mod
from mpc_tpu_torch.utils.geometry import (compute_polyline_length,
                                          resample_polyline)


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Static closed-loop configuration (fields of ``mpc_tpu``'s)."""

    solver: sqp.SolverConfig
    mode: str                 # 'forcespro' | 'casadi'
    n_steps: int              # iter_length T
    noise_std: float = 0.0    # actuation noise; 0 => deterministic
    plant_integrator: str = "rk4"
    cold_start_solves: int = 0   # warm-up solves of the step-0 problem
    warmup_obstacle_free: bool = True  # first warm-up ignores the obstacle
    progress_window: bool = False  # window base = closest path index
    warmup_full_strength: bool = True  # warm-ups run at least al 3x4
    rti_margin: float = 0.0      # RTI clearance backoff: the solver sees
                                 # min_dist + rti_margin
    rti_amax_scale: float = 1.0  # RTI friction backoff: the solver sees
                                 # a_max * rti_amax_scale
    gate_stages: Optional[int] = None  # status gated on stages 0..g of the
                                       # plan against the true problem


class LoopParams(NamedTuple):
    """Runtime data of a closed-loop run: one lane's (as
    :func:`make_loop_params` builds it), or lanes leading (B, ...).

    noise_key (K,) or (B, K) integers seed the actuation noise (used when
    ``noise_std > 0``; the last word of lane 0 seeds a ``torch.Generator``,
    so the draws differ from ``jax.random``'s).
    """

    x_init: torch.Tensor             # (NX,): 5 (KS) or 7 (ST)
    track: ref_mod.ReferenceTrack
    obs_centers: torch.Tensor        # (3, 2)
    min_dist: torch.Tensor           # ()
    weights: cost_mod.Weights
    noise_key: torch.Tensor          # (K,) integers
    boundaries: Optional[torch.Tensor] = None      # (2, NB, 2)
    boundary_signs: Optional[torch.Tensor] = None  # (2,)
    obs_track: Optional[torch.Tensor] = None       # (T+H+2, 3, 2)

    def map(self, fn) -> "LoopParams":
        def m(v):
            if v is None:
                return None
            return v.map(fn) if hasattr(v, "map") else fn(v)
        return LoopParams(*(m(v) for v in self))


class LoopResult(NamedTuple):
    """Per-step outputs, (T, ...) for one lane and (B, T, ...) for lanes."""

    X: torch.Tensor        # (B, T, NX) closed-loop states x_0 .. x_{T-1}
    U: torch.Tensor        # (B, T, 2) applied inputs
    status: torch.Tensor   # (B, T) per-step solver status
    viol: torch.Tensor     # (B, T) per-step max scaled violation
    cost: torch.Tensor     # (B, T) per-step objective values
    stat: torch.Tensor     # (B, T) per-step KKT stationarity residual


def make_loop_config(cfg: PlanningConfig, horizon: Optional[int] = None,
                     noised: Optional[bool] = None,
                     **solver_overrides) -> LoopConfig:
    """A LoopConfig from a PlanningConfig, dispatched on the framework.

    'forcespro': RK4, H = N - 1 transitions, the terminal cost, and the IP
    solve at 2 relinearizations x 6 Newton steps with warm duals by
    default; 'casadi': Euler, H = N, no terminal cost, the AL solve.  The
    YAML ``solver_settings`` are defaults that explicit keywords override;
    ``gate_stages``, ``rti_margin``, ``rti_amax_scale``, ``horizon`` and
    ``cold_start_solves`` ride the same channel to the loop.  Noise: 0.1
    (lane following) or 0.05 (collision avoidance) when noised.
    """
    mode = cfg.framework
    for k, v in (cfg.solver_settings or {}).items():
        solver_overrides.setdefault(k, v)
    gate_stages = solver_overrides.pop("gate_stages", None)
    rti_margin = float(solver_overrides.pop("rti_margin", 0.0))
    rti_amax_scale = float(solver_overrides.pop("rti_amax_scale", 1.0))
    ovr_horizon = solver_overrides.pop("horizon", None)
    if horizon is None:
        horizon = ovr_horizon
    cold_override = solver_overrides.pop("cold_start_solves", None)
    N = int(horizon if horizon is not None else cfg.predict_horizon)
    if mode == "forcespro":
        H, integ, use_term = max(N - 1, 1), "rk4", True
        solver_overrides.setdefault("method", "ip")
        if solver_overrides["method"] == "ip":
            solver_overrides.setdefault("ip_sqp_iters", 2)
            solver_overrides.setdefault("ip_iters", 6)
            solver_overrides.setdefault("ip_warm_duals", True)
    else:
        H, integ, use_term = N, "euler", False
        solver_overrides.setdefault("method", "al")
    if cfg.boundary_constraints:
        solver_overrides.setdefault("boundary_rows", True)
    p = cfg.vehicle
    solver_overrides.setdefault("model", cfg.dynamics_model)
    if solver_overrides.get("model") == "st":
        solver_overrides.setdefault("vehicle", p)
    solver_cfg = sqp.SolverConfig(
        horizon=H, dt=cfg.delta_t, wheelbase=cfg.wheelbase,
        integrator=integ, formulation=mode, ego_length=p.l, ego_width=p.w,
        a_max=p.longitudinal.a_max, bounds=C.make_box_bounds(p, mode),
        use_terminal_cost=use_term, **solver_overrides)
    if mode == "casadi" and H >= cfg.iter_length:
        warnings.warn(
            f"casadi-parity mode with horizon {H} >= iter_length "
            f"{cfg.iter_length}: the frozen end-of-path window pins the "
            "reference at the path start, degenerating tracking. Use a "
            "shorter horizon or the forcespro mode for long-horizon runs.",
            stacklevel=2)
    want_noise = cfg.noised if noised is None else noised
    std = ((0.1 if cfg.use_case == "lane_following" else 0.05)
           if want_noise else 0.0)
    # deep horizons warm up on obstacle-free solves first (the whole
    # maneuver sits inside one horizon); H <= 10 keeps the reference's
    # behaviour exactly
    cold = ((0 if H <= 10 else 2) if cold_override is None
            else int(cold_override))
    return LoopConfig(solver=solver_cfg, mode=mode, n_steps=cfg.iter_length,
                      noise_std=std, plant_integrator=integ,
                      cold_start_solves=cold,
                      progress_window=bool(cfg.progress_window),
                      gate_stages=gate_stages, rti_margin=rti_margin,
                      rti_amax_scale=rti_amax_scale)


# One warm-started QP a step, the reference FORCESPRO deployment's
# ``maxqps = 1``: lane following as is; collision avoidance with a 13-
# transition horizon, 4 full-strength warm-ups and the status gated on the
# applied prefix (stages 0..1).
RTI1_SETTINGS = dict(ip_sqp_iters=1, ip_iters=10, ip_warm_duals=True)
RTI1_CA_SETTINGS = dict(horizon=14, cold_start_solves=4,
                        ip_sqp_iters=1, ip_iters=10, ip_warm_duals=True,
                        gate_stages=1)

_BOUNDARY_POINTS = 128  # the boundary polylines' fixed resampling


def dummy_boundaries(dtype=torch.float32, device=None):
    """A far-away boundary pair whose rows always hold: lines 1e6 m out on
    either side (real segments: a polyline of equal points has a signed
    distance of 0), directed so that the origin is inside, signs +1."""
    xs = np.linspace(1e6, -1e6, _BOUNDARY_POINTS)
    left = np.stack([xs, np.full(_BOUNDARY_POINTS, 1e6)], 1)
    right = np.stack([-xs, np.full(_BOUNDARY_POINTS, -1e6)], 1)
    return (torch.tensor(np.stack([left, right]), dtype=dtype,
                         device=device),
            torch.ones((2,), dtype=dtype, device=device))


def _prepare_boundaries(cfg: PlanningConfig, dtype, device):
    """Both road boundaries resampled to (2, 128, 2) (a missing one is the
    far-away dummy), and signs that make the reference path's midpoint
    inside (positive)."""
    dummy_b, _ = dummy_boundaries(torch.float64)
    out, forced_sign = [], []
    for i, b in enumerate((cfg.left_road_boundary, cfg.right_road_boundary)):
        if b is None or len(b) < 2:
            out.append(dummy_b[i].numpy())
            forced_sign.append(1.0)
            continue
        L = compute_polyline_length(np.asarray(b, float))
        step = max(L / (_BOUNDARY_POINTS - 1), 1e-3)
        rs = resample_polyline(np.asarray(b, float), step)[:_BOUNDARY_POINTS]
        if len(rs) < _BOUNDARY_POINTS:
            rs = np.concatenate(
                [rs, np.repeat(rs[-1:], _BOUNDARY_POINTS - len(rs), axis=0)])
        out.append(rs)
        forced_sign.append(None)
    arr = np.stack(out)
    inside = torch.tensor(cfg.reference_path[len(cfg.reference_path) // 2],
                          dtype=dtype)
    signs = [forced if forced is not None else
             (1.0 if float(C.signed_distance_to_polyline(
                 inside, torch.tensor(b, dtype=dtype))) >= 0 else -1.0)
             for b, forced in zip(arr, forced_sign)]
    return (torch.tensor(arr, dtype=dtype, device=device),
            torch.tensor(signs, dtype=dtype, device=device))


def make_loop_params(cfg: PlanningConfig, lcfg: LoopConfig, seed: int = 0,
                     dtype=torch.float32, device=None) -> LoopParams:
    """One lane's LoopParams on ``device`` (default: the GPU, see
    ``resolve_device``), in ``dtype``: the obstacle's circles, the padded
    reference track (the curvature speed profile where the config has
    one), the start (lifted to the ST state for model='st'), the boundary
    polylines with boundary rows, the moving obstacle's circles padded to
    T + H + 2 steps, and the noise seed."""
    dev = resolve_device(device)
    ob = cfg.static_obstacle

    def t(v):
        return torch.as_tensor(np.asarray(v), device=dev).to(dtype)

    def centers(x, y, psi):
        return C.circle_centers(t(x), t(y), ob["length"], ob["width"],
                                t(psi))

    r_obs, _ = C.approx_circle_radius(ob["length"], ob["width"])
    r_ego, _ = C.approx_circle_radius(cfg.vehicle.l, cfg.vehicle.w)
    v_des = (cfg.v_profile if cfg.v_profile is not None
             else cfg.desired_velocity)
    scfg = lcfg.solver
    track = ref_mod.build_track(cfg.reference_path, cfg.orientation, v_des,
                                scfg.horizon, lcfg.mode, dtype, dev)
    x_init = t([cfg.init_position[0], cfg.init_position[1], 0.0,
                cfg.init_velocity, cfg.init_orientation])
    if scfg.model == "st":
        x_init = dyn_mod.ks_to_st_state(x_init, scfg.wheelbase,
                                        scfg.vehicle.b)
    boundaries = boundary_signs = None
    if scfg.boundary_rows:
        boundaries, boundary_signs = _prepare_boundaries(cfg, dtype, dev)
    obs_track = None
    if cfg.obstacle_trajectory is not None:
        traj = np.asarray(cfg.obstacle_trajectory, dtype=float)
        need = lcfg.n_steps + scfg.horizon + 2
        if len(traj) < need:
            traj = np.concatenate(
                [traj, np.repeat(traj[-1:], need - len(traj), axis=0)])
        traj = traj[:need]
        obs_track = centers(traj[:, 0], traj[:, 1], traj[:, 2])
    return LoopParams(
        x_init=x_init, track=track,
        obs_centers=centers(ob["position_x"], ob["position_y"],
                            ob["orientation"]),
        min_dist=t(r_ego + r_obs),
        weights=cost_mod.Weights.from_dict(cfg.weights, dtype, dev),
        noise_key=torch.tensor([0, seed], dtype=torch.int64, device=dev),
        boundaries=boundaries, boundary_signs=boundary_signs,
        obs_track=obs_track)


def _warmup_cfg(lcfg: LoopConfig) -> sqp.SolverConfig:
    """Solver config of the cold-start solves: RTI budgets are warm-start
    budgets, so the warm-ups run at least the full-strength budget of the
    method (AL 3x4, IP 5x10), on the tightened problem."""
    scfg = _tightened_solver_cfg(lcfg)
    if not lcfg.warmup_full_strength:
        return scfg
    if scfg.method == "ip":
        return dataclasses.replace(
            scfg, ip_sqp_iters=max(scfg.ip_sqp_iters, 5),
            ip_iters=max(scfg.ip_iters, 10))
    return dataclasses.replace(scfg, al_iters=max(scfg.al_iters, 3),
                               sqp_iters=max(scfg.sqp_iters, 4))


def _plant_step(lcfg: LoopConfig, x, u):
    step = dyn_mod.make_step_fn(lcfg.plant_integrator, lcfg.solver.dt,
                                lcfg.solver.wheelbase, lcfg.solver.model,
                                lcfg.solver.vehicle)
    return step(x, u)


def _shift(a):
    return torch.cat([a[:, 1:], a[:, -1:]], dim=1)


def _shift_state(st: sqp.SqpState) -> sqp.SqpState:
    """Shift-and-hold warm start along the stage axis of every field."""
    return st.map(_shift)


def select_engine(scfg: sqp.SolverConfig, have_boundaries: bool = False):
    """The batched solve for ``scfg`` (``mpc_tpu``'s ``select_engine``).

    ``engine='xla'``: the lanes-leading AL engine ``sqp_vec.solve_batch_vec``
    (KS or ST, with or without boundary rows), and for ``method='ip'`` the
    per-lane path ``sqp.solve_batch``, where the JAX package falls back to
    its vmapped solve.  ``'auto'`` and ``'fused'``: the fused AL kernel
    engine, or the fused IP kernel engine for ``method='ip'``, KS or ST,
    boundary rows included when ``have_boundaries`` (each sends a problem
    outside its kernel's envelope on to its fallback).  Boundary rows
    without boundary data: ``'auto'`` AL goes to ``sqp_vec`` (whose rows
    then raise ``ValueError``), ``'fused'`` and IP raise ``ValueError`` as
    the JAX package does.  The lanes-leading engine and the fused kernels
    read neither ``lqr_backend`` nor ``stage_axis``, as in the JAX
    package: on ``engine='xla'`` a 'pscan' solve is the 'scan' one.
    """
    if scfg.engine == "xla":
        return (sqp.solve_batch if scfg.method == "ip"
                else sqp_vec.solve_batch_vec)
    if scfg.boundary_rows and not have_boundaries:
        if scfg.method == "al" and scfg.engine != "fused":
            return sqp_vec.solve_batch_vec
        raise ValueError(f"engine='{scfg.engine}', method '{scfg.method}' "
                         "with boundary rows needs boundary data "
                         "(params.boundaries + signs)")
    if scfg.method == "ip":
        return fused_ip.solve_batch_fused_ip
    return fused_gn.solve_batch_fused


def _tightened_solver_cfg(lcfg: LoopConfig) -> sqp.SolverConfig:
    """Solver-side config with the RTI friction backoff applied
    (``rti_amax_scale``); the status gate keeps ``lcfg.solver``."""
    if lcfg.rti_amax_scale == 1.0:
        return lcfg.solver
    return dataclasses.replace(
        lcfg.solver, a_max=lcfg.solver.a_max * lcfg.rti_amax_scale)


def _tighten_ocp(lcfg: LoopConfig, ocp: sqp.OcpParams) -> sqp.OcpParams:
    """The OCP the solver sees (``rti_margin`` clearance backoff applied)."""
    if lcfg.rti_margin == 0.0:
        return ocp
    return ocp._replace(min_dist=ocp.min_dist + lcfg.rti_margin)


def _gated_status(scfg: sqp.SolverConfig, ocp: sqp.OcpParams, sol,
                  g: int) -> torch.Tensor:
    """Status re-gated against the TRUE problem over stages 0..g, (B,).

    Re-evaluates the scaled rows of the plan's first g+1 stages against
    ``scfg``/``ocp`` (the un-tightened problem) and rewrites the
    feasibility half of the status: -7 becomes 0 where the window's true
    violation is under ``tol_infeas``, and any status becomes -7 where the
    window violates the true bounds.  Other codes pass through.
    ``Solution.viol`` stays the solver's own (tightened, full-plan) figure.
    """
    ocp = sqp.normalize_params(scfg, ocp)
    if g >= scfg.horizon:
        h, lo, hi = sqp._all_rows(scfg, sol.X, sol.U, ocp)
    else:
        idx = torch.arange(g + 1, device=sol.X.device)
        bnd, sgn = sqp._stage_boundaries(ocp, g + 1)
        h, lo, hi = sqp._stage_rows(scfg, sol.X[:, :g + 1],
                                    sol.U[:, :g + 1],
                                    sqp._stage_obs(ocp, idx), idx, bnd, sgn)
    ok = sqp._max_scaled_viol(scfg, h, lo, hi) < scfg.tol_infeas
    seven = torch.full_like(sol.status, -7)
    return torch.where(ok, torch.where(sol.status == seven,
                                       torch.zeros_like(sol.status),
                                       sol.status), seven)


def _step_status(lcfg: LoopConfig, scfg: sqp.SolverConfig,
                 ocp: sqp.OcpParams, sol) -> torch.Tensor:
    """Per-step status under the loop's gating policy: the solver's own
    status; with ``gate_stages=g`` the gate over stages 0..g; with a
    backoff and no gate, the gate over the full plan (the solver solved the
    tightened problem, so its own status would count the backoff band as
    infeasible)."""
    if lcfg.gate_stages is not None:
        return _gated_status(scfg, ocp, sol, lcfg.gate_stages)
    if lcfg.rti_margin != 0.0 or lcfg.rti_amax_scale != 1.0:
        return _gated_status(scfg, ocp, sol, scfg.horizon)
    return sol.status


def _batch_helpers(lcfg: LoopConfig, params: LoopParams):
    """Window, obstacle and OCP builders over the batched ``params``."""
    scfg = lcfg.solver
    ahead = max(scfg.horizon + 2, 16)

    def batched_window(step_idx: int, x, prev_bases):
        step = torch.full_like(prev_bases, step_idx)
        if lcfg.progress_window:
            base = ref_mod.progress_index_local(params.track, x, prev_bases,
                                                ahead)
        else:
            base = step
        ref = ref_mod.window(
            params.track, base, scfg.horizon, lcfg.mode,
            x0=None if lcfg.progress_window else x[..., :dyn_mod.NX])
        return ref, base

    def step_obs(step_idx: int):
        """Per-stage obstacle window (moving-obstacle tracks) or static."""
        if params.obs_track is None:
            return params.obs_centers
        n = params.obs_track.shape[0]
        start = torch.full((n,), step_idx, dtype=torch.int64,
                           device=params.obs_track.device)
        return ref_mod._gather_rows(params.obs_track, start,
                                    scfg.horizon + 1)

    def make_ocp(x, x_ref, obs_centers=None):
        return sqp.OcpParams(x0=x, x_ref=x_ref,
                             obs_centers=(params.obs_centers
                                          if obs_centers is None
                                          else obs_centers),
                             min_dist=params.min_dist,
                             weights=params.weights,
                             boundaries=params.boundaries,
                             boundary_signs=params.boundary_signs)

    return batched_window, step_obs, make_ocp


def _batch_cold_start(lcfg: LoopConfig, params: LoopParams, batched_solve):
    """Warm-start state of a batched loop: cold init + warm-up solves (the
    first one obstacle-free, centres at -1e4, when configured)."""
    scfg = lcfg.solver
    n = params.x_init.shape[0]
    dev, dtype = params.x_init.device, params.x_init.dtype
    batched_window, step_obs, make_ocp = _batch_helpers(lcfg, params)
    state = sqp.init_state(scfg, dtype=dtype, device=dev, batch=n)
    wcfg = _warmup_cfg(lcfg)
    zero_bases = torch.zeros((n,), dtype=torch.int64, device=dev)
    for i in range(lcfg.cold_start_solves):
        x_ref0, _ = batched_window(0, params.x_init, zero_bases)
        obs0 = step_obs(0)
        if i == 0 and lcfg.warmup_obstacle_free:
            obs0 = torch.full_like(obs0, -1e4)  # rows trivially satisfied
        state = batched_solve(
            wcfg, _tighten_ocp(lcfg, make_ocp(params.x_init, x_ref0, obs0)),
            state).state
    return state


def _batched_step(lcfg: LoopConfig, params: LoopParams, batched_solve,
                  carry):
    """One closed-loop step over all lanes.

    carry = (step_idx, x (B, NX), SqpState batch, noise generator or
    :class:`LaneNoise` or None (no noise), bases (B,)), :func:`init_carry`'s
    layout.  Returns
    (new_carry, (x, u_applied, status, viol, cost, stat)).
    """
    batched_window, step_obs, make_ocp = _batch_helpers(lcfg, params)
    step_idx, x, sqp_state, gen, prev_bases = carry
    x_ref, bases = batched_window(step_idx, x, prev_bases)
    ocp = make_ocp(x, x_ref, step_obs(step_idx))
    sol = batched_solve(_tightened_solver_cfg(lcfg), _tighten_ocp(lcfg, ocp),
                        sqp_state)
    status = _step_status(lcfg, lcfg.solver, ocp, sol)
    u_apply = sol.U[:, 0]
    if gen is not None:
        u_apply = u_apply + lcfg.noise_std * _noise(gen, u_apply)
    x_next = _plant_step(lcfg, x, u_apply)
    warm = _shift_state(sol.state)
    out = (x, u_apply, status, sol.viol, sol.cost, sol.kkt_stat)
    return (step_idx + 1, x_next, warm, gen, bases), out


class LaneNoise(NamedTuple):
    """The noise of lanes lo..lo+b of a batch of ``total``: each step
    draws the whole batch's noise from ``gen`` and keeps those rows, so a
    block of lanes run on its own (``parallel.batch``) draws what the
    whole batch draws for it."""

    gen: torch.Generator
    lo: int
    total: int


def _noise(gen, u):
    """One step's actuation noise of the lanes of ``u`` (B, NU) from a
    generator or a :class:`LaneNoise`."""
    if isinstance(gen, LaneNoise):
        full = torch.randn((gen.total,) + u.shape[1:], generator=gen.gen,
                           dtype=u.dtype, device=u.device)
        return full[gen.lo:gen.lo + u.shape[0]]
    return torch.randn(u.shape, generator=gen, dtype=u.dtype,
                       device=u.device)


def _generator(lcfg: LoopConfig, noise_key, dev):
    """The actuation noise's generator, seeded by the last word of lane
    0's key, or None without noise."""
    if lcfg.noise_std <= 0.0:
        return None
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(noise_key.reshape(-1, noise_key.shape[-1])[0, -1]))
    return gen


def _run_steps(lcfg: LoopConfig, params: LoopParams, batched_solve, carry,
               n_steps: int):
    """``n_steps`` steps of :func:`_batched_step` over lanes-leading
    ``params``; returns (carry, LoopResult (B, n_steps, ...))."""
    outs = []
    for _ in range(n_steps):
        carry, out = _batched_step(lcfg, params, batched_solve, carry)
        outs.append(out)
    return carry, LoopResult(*(torch.stack(f, dim=1) for f in zip(*outs)))


def _batch_carry(lcfg: LoopConfig, params: LoopParams, batched_solve, dev):
    """The carry of a batched loop at step 0 on ``dev``, warm-up solves
    included; ``params`` are on ``dev``."""
    n = params.x_init.shape[0]
    state = _batch_cold_start(lcfg, params, batched_solve)
    return (0, params.x_init, state, _generator(lcfg, params.noise_key, dev),
            torch.zeros((n,), dtype=torch.int64, device=dev))


def _loop(lcfg: LoopConfig, params: LoopParams, engine, dev) -> LoopResult:
    """The whole loop of lanes-leading ``params`` on ``dev`` with
    ``engine``, from its cold start."""
    batched_solve = functools.partial(engine, device=dev)
    params = params.map(lambda t: t.to(dev))
    carry = _batch_carry(lcfg, params, batched_solve, dev)
    return _run_steps(lcfg, params, batched_solve, carry, lcfg.n_steps)[1]


def closed_loop_batch(lcfg: LoopConfig, params: LoopParams,
                      device=None) -> LoopResult:
    """The closed loop of every lane of lanes-leading ``params`` on the
    per-lane solve ``sqp.solve_batch`` (``mpc_tpu``'s vmapped
    ``closed_loop_batch``), on ``device`` (default: the GPU); results are
    (B, T, ...)."""
    return _loop(lcfg, params, sqp.solve_batch, resolve_device(device))


def closed_loop_batch_vec(lcfg: LoopConfig, params: LoopParams,
                          device=None) -> LoopResult:
    """Batched closed loop on the throughput hot path.

    Runs on ``device`` (default: the GPU; ``device="cpu"`` runs the plain
    solve).  ``params`` are moved there.  Same contract as ``mpc_tpu``'s
    ``closed_loop_batch_vec``; results are (B, T, ...).  Where
    :func:`select_engine` picks the per-lane solve, this is
    :func:`closed_loop_batch`.
    """
    return _loop(lcfg, params,
                 select_engine(lcfg.solver, params.boundaries is not None),
                 resolve_device(device))


def _lane(params: LoopParams) -> LoopParams:
    """One lane's params with a lane axis of 1."""
    return params.map(lambda t: t[None])


def cold_start_state(lcfg: LoopConfig, params: LoopParams,
                     device=None) -> sqp.SqpState:
    """One lane's warm-start state at step 0: the cold init and the
    configured warm-up solves (``sqp.solve``), as every path of the loop
    starts."""
    dev = resolve_device(device)
    lanes = _lane(params).map(lambda t: t.to(dev))
    state = _batch_cold_start(
        lcfg, lanes, functools.partial(sqp.solve_batch, device=dev))
    return state.map(lambda t: t[0])


def init_carry(lcfg: LoopConfig, params: LoopParams, device=None):
    """The carry of one lane's loop at step 0, warm-up solves included:
    (step, x, SqpState, noise generator or None, progress base)."""
    dev = resolve_device(device)
    state = cold_start_state(lcfg, params, dev)
    return (0, params.x_init.to(dev), state,
            _generator(lcfg, params.noise_key, dev),
            torch.zeros((), dtype=torch.int64, device=dev))


def closed_loop_chunk(lcfg: LoopConfig, params: LoopParams, carry,
                      n_steps: int, device=None):
    """``n_steps`` steps of one lane's loop from ``carry`` (see
    :func:`init_carry`); returns (carry, LoopResult (n_steps, ...)).
    Chunks resume where the last one stopped: a run cut into chunks is the
    whole loop."""
    dev = resolve_device(device)
    lanes = _lane(params).map(lambda t: t.to(dev))
    step, x, state, gen, base = carry
    c = (step, x[None], state.map(lambda t: t[None]), gen, base[None])
    c, res = _run_steps(lcfg, lanes,
                        functools.partial(sqp.solve_batch, device=dev), c,
                        n_steps)
    step, x, state, gen, bases = c
    return ((step, x[0], state.map(lambda t: t[0]), gen, bases[0]),
            LoopResult(*(f[0] for f in res)))


def run_closed_loop(lcfg: LoopConfig, params: LoopParams,
                    device=None) -> LoopResult:
    """One lane's whole closed loop on the per-lane solve, on ``device``
    (default: the GPU); results are (T, ...).  The warm start shifts every
    stagewise field one stage, holding the last."""
    carry = init_carry(lcfg, params, device)
    return closed_loop_chunk(lcfg, params, carry, lcfg.n_steps, device)[1]


def _serving_engine(lcfg: LoopConfig, params: LoopParams, dev):
    """The batched solve of the serving step on ``dev``:
    :func:`select_engine`'s, which is the per-lane ``sqp.solve_batch``
    where the JAX package serves with its vmapped solve."""
    return functools.partial(
        select_engine(lcfg.solver, params.boundaries is not None),
        device=dev)


def init_batch_carry(lcfg: LoopConfig, params: LoopParams, device=None):
    """The serving carry of lanes-leading ``params`` at step 0, the
    configured warm-up solves included, on ``device`` (default: the GPU):
    (step, x (B, NX), SqpState batch, noise generator or None, bases (B,)),
    :func:`closed_loop_batch_vec`'s own starting carry."""
    dev = resolve_device(device)
    params = params.map(lambda t: t.to(dev))
    return _batch_carry(lcfg, params, _serving_engine(lcfg, params, dev),
                        dev)


def closed_loop_batch_step(lcfg: LoopConfig, params: LoopParams, carry,
                           x_measured=None, device=None):
    """ONE batched warm NMPC step over externally measured states.

    The serving counterpart of :func:`closed_loop_batch_vec`: the plant is
    outside the loop (a fleet of vehicles), so each call solves every
    lane's warm problem once from ``x_measured`` ((B, NX); ``None`` takes
    the carry's own predicted states, and then a chain of calls reproduces
    ``closed_loop_batch_vec`` exactly, noise included) and returns
    (new_carry, (x, u_applied, status, viol, cost, stat)).  The carry
    comes from :func:`init_batch_carry`; its generator advances in place.
    Runs on ``device`` (default: the GPU), where the fused kernels launch.
    """
    dev = resolve_device(device)
    params = params.map(lambda t: t.to(dev))
    if x_measured is not None:
        step, _, state, gen, bases = carry
        carry = (step, torch.as_tensor(x_measured).to(
            device=dev, dtype=params.x_init.dtype), state, gen, bases)
    return _batched_step(lcfg, params, _serving_engine(lcfg, params, dev),
                         carry)
