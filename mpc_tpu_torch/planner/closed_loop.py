"""Batched receding-horizon closed loop (``mpc_tpu.planner.closed_loop``).

The batched part of the JAX module: every lane runs T steps of

    reference window -> warm-started solve -> status gate -> plant step
    -> shift

after the configured cold-start solves.  The solve is one launch of a fused
kernel (``ops.fused_gn``, ``ops.fused_ip``) or the lanes-leading engine
``ops.sqp_vec`` (``engine='xla'``), whose Riccati sweep is one kernel
launch per Gauss-Newton step.  The JAX package traces the steps into one
``lax.scan``; here they are a Python loop over eager PyTorch ops and kernel
launches, and nothing leaves the device inside it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import torch

from mpc_tpu_torch.device import resolve_device
from mpc_tpu_torch.models import costs as cost_mod
from mpc_tpu_torch.models import dynamics as dyn_mod
from mpc_tpu_torch.ops import fused_gn
from mpc_tpu_torch.ops import fused_ip
from mpc_tpu_torch.ops import sqp
from mpc_tpu_torch.ops import sqp_vec
from mpc_tpu_torch.planner import reference as ref_mod


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
    """Per-lane runtime data of a closed-loop run, lanes leading.

    noise_key (B, K) integers seed the actuation noise (used when
    ``noise_std > 0``; the last word of lane 0 seeds a ``torch.Generator``,
    so the draws differ from ``jax.random``'s).
    """

    x_init: torch.Tensor             # (B, NX): 5 (KS) or 7 (ST)
    track: ref_mod.ReferenceTrack    # lanes-leading fields
    obs_centers: torch.Tensor        # (B, 3, 2)
    min_dist: torch.Tensor           # (B,)
    weights: cost_mod.Weights        # (B, .) fields
    noise_key: torch.Tensor          # (B, K) integers
    boundaries: Optional[torch.Tensor] = None
    boundary_signs: Optional[torch.Tensor] = None
    obs_track: Optional[torch.Tensor] = None  # (B, T+H+1, 3, 2)

    def map(self, fn) -> "LoopParams":
        def m(v):
            if v is None:
                return None
            return v.map(fn) if hasattr(v, "map") else fn(v)
        return LoopParams(*(m(v) for v in self))


class LoopResult(NamedTuple):
    X: torch.Tensor        # (B, T, NX) closed-loop states x_0 .. x_{T-1}
    U: torch.Tensor        # (B, T, 2) applied inputs
    status: torch.Tensor   # (B, T) per-step solver status
    viol: torch.Tensor     # (B, T) per-step max scaled violation
    cost: torch.Tensor     # (B, T) per-step objective values
    stat: torch.Tensor     # (B, T) per-step KKT stationarity residual


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
    (KS or ST, with or without boundary rows).  ``'auto'`` and ``'fused'``:
    the fused AL kernel engine, or the fused IP kernel engine for
    ``method='ip'``, KS or ST, boundary rows included when
    ``have_boundaries``.
    Boundary rows without boundary data: ``'auto'`` AL goes to ``sqp_vec``
    (whose rows then raise ``ValueError``), ``'fused'`` and IP raise
    ``ValueError`` as the JAX package does.  The cases the JAX package
    sends to its vmapped per-lane path raise ``NotImplementedError``
    naming the ROADMAP item that brings them.
    """
    if scfg.engine == "xla":
        if scfg.method != "al":
            raise NotImplementedError(
                f"engine='xla', method '{scfg.method}': the JAX package "
                "solves it on the vmapped per-lane path, ROADMAP queue A, "
                "item 9")
        if scfg.lqr_backend == "pscan":
            raise NotImplementedError(
                "lqr_backend='pscan': the parallel-scan sweep is ROADMAP "
                "queue A, item 12")
        return sqp_vec.solve_batch_vec
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
                  carry, gen):
    """One closed-loop step over all lanes.

    carry = (step_idx, x (B, NX), SqpState batch, bases (B,)); ``gen`` is
    the noise generator (None when noise_std == 0).  Returns (new_carry,
    (x, u_applied, status, viol, cost, stat)).
    """
    batched_window, step_obs, make_ocp = _batch_helpers(lcfg, params)
    step_idx, x, sqp_state, prev_bases = carry
    x_ref, bases = batched_window(step_idx, x, prev_bases)
    ocp = make_ocp(x, x_ref, step_obs(step_idx))
    sol = batched_solve(_tightened_solver_cfg(lcfg), _tighten_ocp(lcfg, ocp),
                        sqp_state)
    status = _step_status(lcfg, lcfg.solver, ocp, sol)
    u_apply = sol.U[:, 0]
    if gen is not None:
        u_apply = u_apply + lcfg.noise_std * torch.randn(
            u_apply.shape, generator=gen, dtype=u_apply.dtype,
            device=u_apply.device)
    x_next = _plant_step(lcfg, x, u_apply)
    warm = _shift_state(sol.state)
    out = (x, u_apply, status, sol.viol, sol.cost, sol.kkt_stat)
    return (step_idx + 1, x_next, warm, bases), out


def closed_loop_batch_vec(lcfg: LoopConfig, params: LoopParams,
                          device=None) -> LoopResult:
    """Batched closed loop on the throughput hot path.

    Runs on ``device`` (default: the GPU; ``device="cpu"`` runs the plain
    solve).  ``params`` are moved there.  Same contract as ``mpc_tpu``'s
    ``closed_loop_batch_vec``; results are (B, T, ...).
    """
    dev = resolve_device(device)
    engine = select_engine(lcfg.solver, params.boundaries is not None)
    batched_solve = functools.partial(engine, device=dev)
    params = params.map(lambda t: t.to(dev))
    n = params.x_init.shape[0]
    state = _batch_cold_start(lcfg, params, batched_solve)
    gen = None
    if lcfg.noise_std > 0.0:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(params.noise_key.reshape(n, -1)[0, -1]))
    carry = (0, params.x_init, state,
             torch.zeros((n,), dtype=torch.int64, device=dev))
    outs = []
    for _ in range(lcfg.n_steps):
        carry, out = _batched_step(lcfg, params, batched_solve, carry, gen)
        outs.append(out)
    X, U, status, viol, cost, stat = (torch.stack(f, dim=1)
                                      for f in zip(*outs))
    return LoopResult(X=X, U=U, status=status, viol=viol, cost=cost,
                      stat=stat)
