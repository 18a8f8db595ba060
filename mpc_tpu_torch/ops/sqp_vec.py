"""The batched AL-SQP solve on the lanes-leading engine (``mpc_tpu.ops.sqp_vec``).

The same algorithm as the per-lane ``sqp.solve`` of the JAX package, over
the whole batch at once: ``al_iters`` multiplier updates around
``sqp_iters`` Gauss-Newton steps, each of which builds the stagewise
quadratic and the linearized dynamics (``ops.sqp``), runs the batched
Riccati sweep (``ops.riccati_vec.backward_pass_vec``: the CUDA kernel on the
GPU, the plain version on the CPU) and then either

* ``alphas == ()``: the unguarded full RTI step, NaN/inf gains scrubbed to
  0 and no merit rollouts (a non-finite rollout is committed into the warm
  start, as in the JAX package), or
* the ladder: every alpha rolled out at once, a per-lane argmin of the
  merits, committed only where it improves on the iterate's merit.

This is the engine ``SolverConfig.engine='xla'`` selects, and, with the
per-lane sweep ``riccati.backward_pass``, the AL half of the per-lane path
``sqp.solve_batch``.  It is AL only: ``method='ip'`` is solved by
``sqp.solve_batch``.
"""
from __future__ import annotations

import functools

import torch

from mpc_tpu_torch.device import resolve_device
from mpc_tpu_torch.ops import riccati_vec
from mpc_tpu_torch.ops import sqp as S
from mpc_tpu_torch.ops.fused_gn import _to


_pick = S._pick  # the rung per lane: 0 keeps the iterate, r + 1 alphas[r]


def _gn_iteration_vec(cfg: S.SolverConfig, params: S.OcpParams, lam_lo,
                      lam_hi, mu, X, U, sweep=None, rungs=None, follow=None):
    """One batched Gauss-Newton step; every tensor has a leading lane axis.

    ``sweep`` replaces ``riccati_vec.backward_pass_vec`` on the device of
    ``X`` (a check runs the same step with the plain sweep on the GPU).
    With the ladder on, a list ``rungs`` receives (rung (B,), merits
    (A+1, B)) with the iterate's merit first, and ``follow`` (B,) commits
    those rungs instead of the picked ones.
    """
    quad, QH, qH = S._build_quadratic(cfg, X, U, params, lam_lo, lam_hi, mu)
    dyn = S._linearize_dynamics(cfg, X, U)
    if sweep is None:
        sweep = functools.partial(riccati_vec.backward_pass_vec,
                                  device=X.device)
    gains = sweep(quad, QH, qH, dyn, cfg.reg)
    u_lo, u_hi, _, _ = cfg.bounds.as_arrays(X.dtype, X.device)
    if len(cfg.alphas) == 0:
        K = torch.nan_to_num(gains.K, nan=0.0, posinf=0.0, neginf=0.0)
        d = torch.nan_to_num(gains.d, nan=0.0, posinf=0.0, neginf=0.0)
        Xa, Ua = riccati_vec.feedback_rollout_vec(
            cfg.dt, cfg.wheelbase, params.x0, X, U, K, d, (1.0,), u_lo,
            u_hi, cfg.integrator, cfg.model, cfg.vehicle)
        return Xa[0], Ua[0]
    Xa, Ua = riccati_vec.feedback_rollout_vec(
        cfg.dt, cfg.wheelbase, params.x0, X, U, gains.K, gains.d,
        cfg.alphas, u_lo, u_hi, cfg.integrator, cfg.model, cfg.vehicle)
    merits = S._merit(cfg, Xa, Ua, params, lam_lo, lam_hi, mu)    # (A, B)
    merit0 = S._merit(cfg, X, U, params, lam_lo, lam_hi, mu)      # (B,)
    rung = _pick(merits, merit0) if follow is None else follow.long()
    if rungs is not None:
        rungs.append((rung, torch.cat([merit0[None], merits])))
    lane = torch.arange(X.shape[0], device=X.device)
    take = torch.clamp(rung - 1, min=0)
    w = (rung > 0)[:, None, None]
    return (torch.where(w, Xa[take, lane], X),
            torch.where(w, Ua[take, lane], U))


def solve_batch_vec(cfg: S.SolverConfig, params: S.OcpParams,
                    state: S.SqpState, device=None, sweep=None, rungs=None,
                    follow=None) -> S.Solution:
    """Batched AL solve; the contract of ``mpc_tpu``'s
    ``sqp_vec.solve_batch_vec``.

    Runs on ``device`` (default: the GPU, see ``resolve_device``); the
    inputs are moved there.  ``sweep``, ``rungs`` and ``follow`` are the
    hooks of :func:`_gn_iteration_vec`; ``follow`` is
    (al_iters * sqp_iters, B).  Another method than AL goes to the
    per-lane path ``sqp.solve_batch``, as in the JAX package.  As there,
    ``lqr_backend`` and ``stage_axis`` are not read: the sweep is
    ``sweep`` or the lanes-leading one.
    """
    if cfg.method != "al":
        return S.solve_batch(cfg, params, state, device=device)
    dev = resolve_device(device)
    params = _to(S.normalize_params(cfg, params), dev)
    state = _to(state, dev)
    X = S._rollout(cfg, params.x0, state.U)
    U, lam_lo, lam_hi, mu, prev_viol = state
    for ai in range(cfg.al_iters):
        for si in range(cfg.sqp_iters):
            X, U = _gn_iteration_vec(
                cfg, params, lam_lo, lam_hi, mu, X, U, sweep, rungs,
                None if follow is None else follow[ai * cfg.sqp_iters + si])
        # first-order multiplier update + per-row penalty growth: stiffen
        # only rows whose violation did not improve enough
        h, lo, hi = S._all_rows(cfg, X, U, params)
        t_hi = lam_hi + mu * (h - hi)
        t_lo = lam_lo + mu * (lo - h)
        zero = torch.zeros_like(t_hi)
        lam_hi = torch.clamp(torch.where(t_hi > 0, t_hi, zero), 0.0,
                             cfg.lam_max)
        lam_lo = torch.clamp(torch.where(t_lo > 0, t_lo, zero), 0.0,
                             cfg.lam_max)
        viol_row = torch.clamp(torch.maximum(lo - h, h - hi), min=0.0)
        viol_row = torch.where(torch.isfinite(viol_row), viol_row, zero)
        stalled = viol_row > cfg.viol_improve * prev_viol
        active = viol_row > cfg.tol_feas
        mu = torch.where(stalled & active, mu * cfg.mu_factor, mu)
        mu = torch.clamp(mu, cfg.mu0, cfg.mu_max)
        prev_viol = viol_row

    stat, viol = S._kkt_residuals(cfg, params, X, U, lam_lo, lam_hi, mu)
    converged = (stat < cfg.tol_stat) & (viol < cfg.tol_feas)
    feasible = viol < cfg.tol_infeas
    one = torch.ones_like(stat, dtype=torch.int32)
    status = torch.where(converged, one,
                         torch.where(feasible, 0 * one, -7 * one))
    new_state = S.SqpState(U=U, lam_lo=lam_lo, lam_hi=lam_hi, mu=mu,
                           prev_viol=prev_viol)
    return S.Solution(
        X=X, U=U, state=new_state, status=status, kkt_stat=stat, viol=viol,
        cost=S._objective(cfg, X, U, params),
        merit=S._merit(cfg, X, U, params, lam_lo, lam_hi, mu))
