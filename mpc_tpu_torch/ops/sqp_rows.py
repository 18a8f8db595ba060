"""The rows-native batched AL solve (``tools/ablation/sqp_rows.py``).

The layout-ablation reference: everything (constraint rows, Jacobians,
cost quadratics, Riccati sweep, rollouts, merits, AL updates) lives in
(feature, stage, lane) tensors, where the engines of the port keep lanes
leading.  On the TPU the layout was chosen so that every array tiles the
8 x 128 vector registers with no transpose of a padded array; that reason
does not carry over to a GPU, whose fused kernels (``ops.fused_gn``) own
their layout, and no engine of the port reaches this module, as no engine
of the JAX package reaches its counterpart.  It is kept, in eager torch,
as the reference the JAX package keeps.

Scope: the AL method without road-boundary rows (anything else goes to
``sqp.solve_batch``), the KS model.  The Jacobians are forward-mode
products with the seven basis tangents (``torch.func.jvp``, the
counterpart of ``jax.linearize``); the status is feasibility-based,
``viol`` the largest raw row violation and ``kkt_stat`` the
merit-objective gap, as in the JAX module.

One departure: the JAX module's Gauss-Newton steps read the multipliers
and penalties that the solve started with (its ``gn_iter`` closes over
them, not over the AL loop's carry), so from the second AL iteration on
its steps and merits use stale ones.  Here every step reads the current
ones, as ``sqp.solve_batch`` does; the two modules agree at
``al_iters=1``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mpc_tpu_torch.models import constraints as CM
from mpc_tpu_torch.ops import sqp as S

NX = 5
NU = 2
NZ = NX + NU
NR = S.NROWS  # 14


# ---------------------------------------------------------------------------
# layout helpers: (B, S, ...) <-> (feat, S, B)
# ---------------------------------------------------------------------------


def to_rows(x: torch.Tensor) -> torch.Tensor:
    """(B, S, ...) -> (feat, S, B)."""
    B, Sdim = x.shape[0], x.shape[1]
    return x.reshape(B, Sdim, -1).permute(2, 1, 0)


def from_rows(x: torch.Tensor, shape) -> torch.Tensor:
    """(feat, S, B) -> (B, S, *shape)."""
    feat, Sdim, B = x.shape
    return x.permute(2, 1, 0).reshape(B, Sdim, *shape)


def _swap(x: torch.Tensor) -> torch.Tensor:
    """(B, S, F) <-> (F, S, B)."""
    return x.permute(2, 1, 0)


# ---------------------------------------------------------------------------
# rows-native model evaluation
# ---------------------------------------------------------------------------


class RowsParams(NamedTuple):
    """Per-lane data in rows layout: x0 (NX, B), x_ref (NX, S, B), obs
    (6, B) (the obstacle circles' centres, flattened), mind (B,), wq, wr,
    wqN (NX/NU/NX, B)."""

    x0: torch.Tensor
    x_ref: torch.Tensor
    obs: torch.Tensor
    mind: torch.Tensor
    wq: torch.Tensor
    wr: torch.Tensor
    wqN: torch.Tensor


def pack_params(params: S.OcpParams) -> RowsParams:
    return RowsParams(
        x0=params.x0.T,
        x_ref=to_rows(params.x_ref),
        obs=params.obs_centers.reshape(params.obs_centers.shape[0], 6).T,
        mind=params.min_dist,
        wq=params.weights.q.T,
        wr=params.weights.r.T,
        wqN=params.weights.qN.T)


def _ego_circles(cfg, x):
    """x: the NX rows -> the 3 circle centres of the ego vehicle."""
    _, disc = CM.approx_circle_radius(cfg.ego_length, cfg.ego_width)
    dd = disc / 2.0 / 2.0
    c, s = torch.cos(x[4]), torch.sin(x[4])
    return [(x[0], x[1]),
            (x[0] + dd * c, x[1] + dd * s),
            (x[0] - dd * c, x[1] - dd * s)]


def rows_h(cfg: S.SolverConfig, x, u, rp: RowsParams, is_term, fric_mask):
    """Constraint rows h, (NR, S, B).

    x: the NX rows (S, B); u: the NU rows; is_term, fric_mask: (S, 1).
    """
    zero = torch.zeros((), dtype=x[0].dtype, device=x[0].device)
    u0 = torch.where(is_term, zero, u[0])
    u1 = torch.where(is_term, zero, u[1])
    v, delta = x[3], x[2]
    if cfg.formulation == "forcespro":
        psi_dot = v * torch.tan(delta) / cfg.wheelbase
        fric = u1 * u1 + (v * psi_dot) ** 2
    else:
        fric = torch.abs(u1 * u1 + v * (torch.tan(delta) * v)
                         / cfg.wheelbase)
        fric = torch.where(fric_mask, fric, zero)

    ego = _ego_circles(cfg, x)
    obs = [(rp.obs[2 * j][None], rp.obs[2 * j + 1][None]) for j in range(3)]
    if cfg.formulation == "forcespro":
        pairs = [(i, j) for i in range(3) for j in range(3)]
    else:
        pairs = [(i, i) for i in range(3) for _ in range(3)]
    dists = []
    for i, j in pairs:
        dx = ego[i][0] - obs[j][0]
        dy = ego[i][1] - obs[j][1]
        dists.append(torch.sqrt(dx * dx + dy * dy + 1e-9))
    return torch.stack([fric] + dists + [u0, u1, delta, v])


def rows_bounds(cfg: S.SolverConfig, rp: RowsParams, Sdim, B, is_term,
                dtype):
    """lo and hi bounds, (NR, S, B)."""
    dev = rp.x0.device
    u_lo, u_hi, x_lo, x_hi = cfg.bounds.as_arrays(dtype, dev)
    one = torch.ones((Sdim, B), dtype=dtype, device=dev)
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    f_hi = (cfg.a_max ** 2 if cfg.formulation == "forcespro"
            else cfg.a_max) * one
    d_lo = rp.mind[None].expand(Sdim, B)
    lo = [0 * one] + [d_lo] * 9 + [
        torch.where(is_term, -inf, u_lo[0]) * one,
        torch.where(is_term, -inf, u_lo[1]) * one,
        x_lo[2] * one, x_lo[3] * one]
    hi = [f_hi] + [inf * one] * 9 + [
        torch.where(is_term, inf, u_hi[0]) * one,
        torch.where(is_term, inf, u_hi[1]) * one,
        x_hi[2] * one, x_hi[3] * one]
    return torch.stack(lo), torch.stack(hi)


def _al_terms(h, lo, hi, lam_lo, lam_hi, mu):
    t_hi = lam_hi + mu * (h - hi)
    t_lo = lam_lo + mu * (lo - h)
    act_hi, act_lo = t_hi > 0, t_lo > 0
    m_hi = torch.where(act_hi, t_hi, torch.zeros_like(t_hi))
    m_lo = torch.where(act_lo, t_lo, torch.zeros_like(t_lo))
    psi = (m_hi * m_hi - lam_hi * lam_hi
           + m_lo * m_lo - lam_lo * lam_lo) / (2.0 * mu)
    grad_h = m_hi - m_lo
    gn = mu * (act_hi.to(h.dtype) + act_lo.to(h.dtype))
    return psi, grad_h, gn


def _objective_rows(cfg, x, u, rp: RowsParams):
    """The objective of every lane (B,); x: the NX rows (S, B), u: the NU
    rows (H, B)."""
    H = cfg.horizon
    dxs = [x[i][:H] - rp.x_ref[i, :H] for i in range(NX)]
    stage = sum(rp.wq[i][None] * dxs[i] * dxs[i] for i in range(NX))
    stage = stage + sum(rp.wr[i][None] * u[i] * u[i] for i in range(NU))
    total = stage.sum(0)
    if cfg.use_terminal_cost:
        dxt = [x[i][H] - rp.x_ref[i, H] for i in range(NX)]
        total = total + sum(rp.wqN[i] * dxt[i] * dxt[i] for i in range(NX))
    return total


def _dyn_step_rows(cfg, x, u):
    """One integrator step on rows; x: the NX rows, u: the NU rows."""
    wb, dt = cfg.wheelbase, cfg.dt

    def ode(xx, uu):
        v, delta, psi = xx[3], xx[2], xx[4]
        return [v * torch.cos(psi), v * torch.sin(psi), uu[0], uu[1],
                v / wb * torch.tan(delta)]

    def add(xx, s, k):
        return [xx[i] + s * k[i] for i in range(NX)]

    if cfg.integrator == "rk4":
        k1 = ode(x, u)
        k2 = ode(add(x, dt / 2, k1), u)
        k3 = ode(add(x, dt / 2, k2), u)
        k4 = ode(add(x, dt, k3), u)
        return [x[i] + dt / 6 * (k1[i] + 2 * k2[i] + 2 * k3[i] + k4[i])
                for i in range(NX)]
    return add(x, dt, ode(x, u))


def _rollout_rows(cfg, x0_rows, U_rows):
    """x0 (NX, B), U (NU, H, B) -> X (NX, H+1, B)."""
    xs = [x0_rows]
    for k in range(U_rows.shape[1]):
        xs.append(torch.stack(_dyn_step_rows(
            cfg, list(xs[-1]), list(U_rows[:, k]))))
    return torch.stack(xs, dim=1)


def _basis_jvps(f, Z):
    """f(Z) and its derivative along each of the NZ basis tangents of the
    feature axis (``jax.linearize`` and seven tangents)."""
    eye = torch.eye(NZ, dtype=Z.dtype, device=Z.device)
    out, cols = None, []
    for i in range(NZ):
        out, col = torch.func.jvp(f, (Z,), (eye[i][:, None, None]
                                             .expand(Z.shape),))
        cols.append(col)
    return out, cols


# ---------------------------------------------------------------------------
# quadratic model assembly
# ---------------------------------------------------------------------------


def _build_quad_rows(cfg, X_rows, U_rows, rp, lam_lo, lam_hi, mu,
                     is_term, fric_mask):
    """The AL Gauss-Newton stage quadratics in rows layout: Q (25, H, B),
    R (4, H, B), M (10, H, B), qx (5, H, B), qu (2, H, B), P_H (25, B),
    p_H (5, B)."""
    Sdim = cfg.horizon + 1
    B = X_rows.shape[-1]
    dtype = X_rows.dtype
    U_ext = torch.cat([U_rows, U_rows[:, -1:]], dim=1)     # (NU, S, B)

    def h_of_z(z):
        return rows_h(cfg, list(z[:NX]), list(z[NX:]), rp, is_term,
                      fric_mask)

    Z = torch.cat([X_rows, U_ext], dim=0)                  # (NZ, S, B)
    h, cols = _basis_jvps(h_of_z, Z)
    J = torch.stack(cols)                                  # (NZ, NR, S, B)

    lo, hi = rows_bounds(cfg, rp, Sdim, B, is_term, dtype)
    psi, grad_h, gn = _al_terms(h, lo, hi, lam_lo, lam_hi, mu)

    g_con = torch.einsum("zrsb,rsb->zsb", J, grad_h)       # (NZ, S, B)
    H_con = torch.einsum("zrsb,rsb,wrsb->zwsb", J, gn, J)  # (NZ, NZ, S, B)

    H = cfg.horizon
    dx = X_rows - rp.x_ref                                 # (NX, S, B)
    Q_rows = [(2.0 * rp.wq[i][None] if i == j else 0.0) + H_con[i, j, :H]
              for i in range(NX) for j in range(NX)]
    R_rows = [(2.0 * rp.wr[i][None] if i == j else 0.0)
              + H_con[NX + i, NX + j, :H]
              for i in range(NU) for j in range(NU)]
    M_rows = [H_con[i, NX + j, :H] for i in range(NX) for j in range(NU)]
    qx_rows = [2.0 * rp.wq[i][None] * dx[i, :H] + g_con[i, :H]
               for i in range(NX)]
    qu_rows = [2.0 * rp.wr[i][None] * U_rows[i] + g_con[NX + i, :H]
               for i in range(NU)]
    if cfg.use_terminal_cost:
        PH_rows = [(2.0 * rp.wqN[i] if i == j else 0.0) + H_con[i, j, H]
                   for i in range(NX) for j in range(NX)]
        pH_rows = [2.0 * rp.wqN[i] * dx[i, H] + g_con[i, H]
                   for i in range(NX)]
    else:
        PH_rows = [H_con[i, j, H] for i in range(NX) for j in range(NX)]
        pH_rows = [g_con[i, H] for i in range(NX)]
    return (torch.stack(Q_rows), torch.stack(R_rows), torch.stack(M_rows),
            torch.stack(qx_rows), torch.stack(qu_rows),
            torch.stack(PH_rows), torch.stack(pH_rows))


def _linearize_dyn_rows(cfg, X_rows, U_rows):
    """A (25, H, B) and B (10, H, B) of the integrator step."""
    H = cfg.horizon

    def f(z):
        return torch.stack(_dyn_step_rows(cfg, list(z[:NX]), list(z[NX:])))

    Z = torch.cat([X_rows[:, :H], U_rows], dim=0)          # (NZ, H, B)
    _, cols = _basis_jvps(f, Z)                            # each (NX, H, B)
    A_rows = torch.stack([cols[j][i] for i in range(NX) for j in range(NX)])
    B_rows = torch.stack([cols[NX + j][i]
                          for i in range(NX) for j in range(NU)])
    return A_rows, B_rows


# ---------------------------------------------------------------------------
# rows-native Riccati backward sweep and line-search rollout
# ---------------------------------------------------------------------------


def _mat(v, n, m):
    return [[v[i * m + j] for j in range(m)] for i in range(n)]


def _backward_rows(Q, R, M, qx, qu, PH, pH, A, Bm, reg):
    """Inputs (feat, H, B) and (feat, B); returns K (10, H, B), d (2, H, B).
    Written out entry by entry, single shooting (no defects)."""
    Pv, pv = PH, pH
    Ks, ds = [], []
    for k in range(Q.shape[1] - 1, -1, -1):
        P = _mat(Pv, NX, NX)
        p = [pv[i] for i in range(NX)]
        Qm = _mat(Q[:, k], NX, NX)
        Rm = _mat(R[:, k], NU, NU)
        Mm = _mat(M[:, k], NX, NU)
        Am = _mat(A[:, k], NX, NX)
        Bmat = _mat(Bm[:, k], NX, NU)
        PA = [[sum(P[i][q] * Am[q][j] for q in range(NX)) for j in range(NX)]
              for i in range(NX)]
        PB = [[sum(P[i][q] * Bmat[q][j] for q in range(NX))
               for j in range(NU)] for i in range(NX)]
        Qxx = [[Qm[i][j] + sum(Am[q][i] * PA[q][j] for q in range(NX))
                for j in range(NX)] for i in range(NX)]
        Quu = [[Rm[i][j] + sum(Bmat[q][i] * PB[q][j] for q in range(NX))
                for j in range(NU)] for i in range(NU)]
        Qux = [[Mm[j][i] + sum(Bmat[q][i] * PA[q][j] for q in range(NX))
                for j in range(NX)] for i in range(NU)]
        gx = [qx[i, k] + sum(Am[q][i] * p[q] for q in range(NX))
              for i in range(NX)]
        gu = [qu[i, k] + sum(Bmat[q][i] * p[q] for q in range(NX))
              for i in range(NU)]
        a, b = Quu[0][0] + reg, Quu[0][1]
        c, dd = Quu[1][0], Quu[1][1] + reg
        idet = 1.0 / (a * dd - b * c)
        Qi = [[dd * idet, -b * idet], [-c * idet, a * idet]]
        K = [[-(Qi[i][0] * Qux[0][j] + Qi[i][1] * Qux[1][j])
              for j in range(NX)] for i in range(NU)]
        d = [-(Qi[i][0] * gu[0] + Qi[i][1] * gu[1]) for i in range(NU)]
        P_new = [[Qxx[i][j] + Qux[0][i] * K[0][j] + Qux[1][i] * K[1][j]
                  for j in range(NX)] for i in range(NX)]
        Pv = torch.stack([0.5 * (P_new[i][j] + P_new[j][i])
                          for i in range(NX) for j in range(NX)])
        pv = torch.stack([gx[i] + Qux[0][i] * d[0] + Qux[1][i] * d[1]
                          for i in range(NX)])
        Ks.append(torch.stack([K[i][j] for i in range(NU)
                               for j in range(NX)]))
        ds.append(torch.stack(d))
    return torch.stack(Ks[::-1], dim=1), torch.stack(ds[::-1], dim=1)


def _ls_rollout_rows(cfg, x0_rows, X_rows, U_rows, K, d, alphas):
    """Every alpha's rollout: Xa (NX, S, A, B), Ua (NU, H, A, B)."""
    A_n, B = len(alphas), x0_rows.shape[-1]
    dtype, dev = x0_rows.dtype, x0_rows.device
    al = torch.tensor(alphas, dtype=dtype, device=dev)[:, None]   # (A, 1)
    u_lo, u_hi, _, _ = cfg.bounds.as_arrays(dtype, dev)
    xa = x0_rows[:, None, :].expand(NX, A_n, B)
    Xs, Us = [], []
    for k in range(cfg.horizon):
        x = list(xa)
        Km = _mat(K[:, k], NU, NX)
        dxb = [x[i] - X_rows[i, k][None] for i in range(NX)]
        u = []
        for i in range(NU):
            fb = sum(Km[i][j][None] * dxb[j] for j in range(NX))
            ui = U_rows[i, k][None] + al * d[i, k][None] + fb
            u.append(torch.clamp(ui, u_lo[i], u_hi[i]))
        Xs.append(xa)
        Us.append(torch.stack(u))
        xa = torch.stack(_dyn_step_rows(cfg, x, u))
    Xs.append(xa)
    return torch.stack(Xs, dim=1), torch.stack(Us, dim=1)


def _merit_rows(cfg, X_rows, U_rows, rp, lam_lo, lam_hi, mu,
                is_term, fric_mask):
    """The AL merit of every lane; X (NX, S, B), U (NU, H, B) -> (B,)."""
    U_ext = torch.cat([U_rows, U_rows[:, -1:]], dim=1)
    h = rows_h(cfg, list(X_rows), list(U_ext), rp, is_term, fric_mask)
    lo, hi = rows_bounds(cfg, rp, X_rows.shape[1], X_rows.shape[-1],
                         is_term, X_rows.dtype)
    psi, _, _ = _al_terms(h, lo, hi, lam_lo, lam_hi, mu)
    obj = _objective_rows(cfg, list(X_rows), list(U_rows), rp)
    return obj + psi.sum((0, 1))


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------


def solve_batch_rows(cfg: S.SolverConfig, params: S.OcpParams,
                     state: S.SqpState) -> S.Solution:
    """The rows-native batched AL solve, ``sqp.solve_batch``'s contract, on
    the device of ``params``; the IP method and boundary rows go to
    ``sqp.solve_batch`` there."""
    if cfg.method != "al" or cfg.boundary_rows:
        return S.solve_batch(cfg, params, state, device=params.x0.device)

    H = cfg.horizon
    Sdim = H + 1
    dtype, dev = params.x0.dtype, params.x0.device
    B = params.x0.shape[0]

    rp = pack_params(params)
    idx = np.arange(Sdim)
    is_term = torch.as_tensor((idx >= H)[:, None], device=dev)   # (S, 1)
    fric_mask = torch.as_tensor(
        ((idx == 0) if cfg.formulation == "casadi"
         else np.ones(Sdim, bool))[:, None], device=dev)

    lam_lo, lam_hi = _swap(state.lam_lo), _swap(state.lam_hi)
    mu, prev_viol = _swap(state.mu), _swap(state.prev_viol)
    U = _swap(state.U)                                           # (NU, H, B)
    X = _rollout_rows(cfg, rp.x0, U)
    A_n = len(cfg.alphas)

    def rep(a):
        """Every lane's rows once per alpha: (..., B) -> (..., A * B)."""
        return a[..., None, :].expand(*a.shape[:-1], A_n, a.shape[-1]
                                      ).reshape(*a.shape[:-1], -1)

    rp_f = RowsParams(x0=rp.x0, x_ref=rep(rp.x_ref), obs=rep(rp.obs),
                      mind=rp.mind.repeat(A_n), wq=rep(rp.wq),
                      wr=rep(rp.wr), wqN=rep(rp.wqN))
    for _ in range(cfg.al_iters):
        for _ in range(cfg.sqp_iters):
            Q, R, M, qx, qu, PH, pH = _build_quad_rows(
                cfg, X, U, rp, lam_lo, lam_hi, mu, is_term, fric_mask)
            A_rows, B_rows = _linearize_dyn_rows(cfg, X, U)
            K, d = _backward_rows(Q, R, M, qx, qu, PH, pH, A_rows, B_rows,
                                  cfg.reg)
            Xa, Ua = _ls_rollout_rows(cfg, rp.x0, X, U, K, d, cfg.alphas)
            # the merits of every alpha: alphas folded into the lanes
            merits = _merit_rows(
                cfg, Xa.reshape(NX, Sdim, A_n * B),
                Ua.reshape(NU, H, A_n * B), rp_f, rep(lam_lo), rep(lam_hi),
                rep(mu), is_term, fric_mask).reshape(A_n, B)
            merit0 = _merit_rows(cfg, X, U, rp, lam_lo, lam_hi, mu, is_term,
                                 fric_mask)
            best = torch.argmin(merits, dim=0)                   # (B,)
            improved = merits.min(0).values < merit0
            lane = torch.arange(B, device=dev)
            X = torch.where(improved, Xa[:, :, best, lane], X)
            U = torch.where(improved, Ua[:, :, best, lane], U)
        U_ext = torch.cat([U, U[:, -1:]], dim=1)
        h = rows_h(cfg, list(X), list(U_ext), rp, is_term, fric_mask)
        lo, hi = rows_bounds(cfg, rp, Sdim, B, is_term, dtype)
        zero = torch.zeros_like(h)
        t_hi = lam_hi + mu * (h - hi)
        t_lo = lam_lo + mu * (lo - h)
        lam_hi = torch.clamp(torch.where(t_hi > 0, t_hi, zero), 0.0,
                             cfg.lam_max)
        lam_lo = torch.clamp(torch.where(t_lo > 0, t_lo, zero), 0.0,
                             cfg.lam_max)
        viol = torch.clamp(torch.maximum(lo - h, h - hi), min=0.0)
        viol = torch.where(torch.isfinite(viol), viol, zero)
        stalled = viol > cfg.viol_improve * prev_viol
        active = viol > cfg.tol_feas
        mu = torch.clamp(torch.where(stalled & active, mu * cfg.mu_factor,
                                     mu), cfg.mu0, cfg.mu_max)
        prev_viol = viol

    # diagnostics: no autodiff KKT here, the merit-objective gap instead
    U_ext = torch.cat([U, U[:, -1:]], dim=1)
    h = rows_h(cfg, list(X), list(U_ext), rp, is_term, fric_mask)
    lo, hi = rows_bounds(cfg, rp, Sdim, B, is_term, dtype)
    viol_rows = torch.clamp(torch.maximum(lo - h, h - hi), min=0.0)
    viol_rows = torch.where(torch.isfinite(viol_rows), viol_rows,
                            torch.zeros_like(viol_rows))
    viol = viol_rows.amax((0, 1))                                # (B,)
    obj = _objective_rows(cfg, list(X), list(U), rp)
    merit = _merit_rows(cfg, X, U, rp, lam_lo, lam_hi, mu, is_term,
                        fric_mask)
    one = torch.ones_like(viol, dtype=torch.int32)
    status = torch.where(viol < cfg.tol_feas, one,
                         torch.where(viol < cfg.tol_infeas, 0 * one,
                                     -7 * one))
    new_state = S.SqpState(U=_swap(U), lam_lo=_swap(lam_lo),
                           lam_hi=_swap(lam_hi), mu=_swap(mu),
                           prev_viol=_swap(prev_viol))
    return S.Solution(X=from_rows(X, (NX,)), U=new_state.U, state=new_state,
                      status=status, kkt_stat=merit - obj, viol=viol,
                      cost=obj, merit=merit)
