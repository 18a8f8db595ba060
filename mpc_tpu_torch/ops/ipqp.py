"""Primal-dual interior-point stagewise QP (``mpc_tpu.ops.ipqp``).

Each IP-RTI iteration of the per-lane path (``ops.sqp``, ``method='ip'``)
solves the two-sided-row stagewise QP

    min  1/2 dz' H dz + g' dz
    s.t. dx_{k+1} = A_k dx_k + B_k du_k + r_k,   dx_0 = 0
         lo <= J_k dz_k + h_k <= hi

with a slack primal-dual interior-point method at a fixed iteration count:
each Newton step eliminates the slacks and row duals and solves the
row-weighted equality QP with the Riccati sweep (``riccati.solve_lqr``),
then takes a fraction-to-boundary step and updates the barrier from the
average complementarity gap.  Every tensor has a leading lane axis; each
lane takes its own step length and barrier.  The fused IP solve
(``ops.fused_ip``) runs the same iteration inside its kernel, with these
constants.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mpc_tpu_torch.ops import riccati

# float32 overflow guards of the iterate (HPIPM-style): slacks are floored
# at _S_FLOOR and duals capped at _Z_MAX, so sigma = z / s stays <= 1e16
_S_FLOOR = 1e-10
_Z_MAX = 1e6
# warm-started duals are clipped to [zc / _WARM_KAPPA, zc * _WARM_KAPPA]
# around the central-path value zc = mu0 / s
_WARM_KAPPA = 100.0

# init_ip / ip_iteration / solve_qp defaults, as the fused kernel uses them
_S_MIN = 1e-2       # smallest initial slack of a feasible row
_MU0 = 1.0          # initial barrier; dual of a violated row at the start
_SIGMA_B = 0.2      # barrier reduction: mu <- max(sigma gap / n, mu_min)
_TAU = 0.995        # fraction-to-boundary
_MU_MIN = 1e-8


class QpData(NamedTuple):
    """Stagewise QP data, lanes leading.

    Q (B, H, NX, NX), R (B, H, NU, NU), M (B, H, NX, NU), qx (B, H, NX), qu
    (B, H, NU), QH (B, NX, NX), qH (B, NX), A (B, H, NX, NX), B (B, H, NX,
    NU), r (B, H, NX); J (B, H+1, NROWS, NX+NU) row Jacobians (the terminal
    rows use only the dx columns); h0, lo, hi (B, H+1, NROWS).
    """

    Q: torch.Tensor
    R: torch.Tensor
    M: torch.Tensor
    qx: torch.Tensor
    qu: torch.Tensor
    QH: torch.Tensor
    qH: torch.Tensor
    A: torch.Tensor
    B: torch.Tensor
    r: torch.Tensor
    J: torch.Tensor
    h0: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor


class IpState(NamedTuple):
    dX: torch.Tensor     # (B, H+1, NX)
    dU: torch.Tensor     # (B, H, NU)
    s_lo: torch.Tensor   # (B, H+1, NROWS) slacks of c - lo
    s_hi: torch.Tensor   # (B, H+1, NROWS) slacks of hi - c
    z_lo: torch.Tensor   # (B, H+1, NROWS) duals
    z_hi: torch.Tensor   # (B, H+1, NROWS)
    mu: torch.Tensor     # (B,) barrier parameter


def _ext(dU):
    """dU with its last stage repeated: the terminal rows' dU column."""
    return torch.cat([dU, dU[..., -1:, :]], dim=-2)


def _rows_value(qp: QpData, dX, dU):
    """c_k = J_k dz_k + h0_k of all stages (the terminal stage uses
    dU[H-1], whose columns its J zeroes)."""
    dz = torch.cat([dX, _ext(dU)], dim=-1)
    return torch.einsum("...krz,...kz->...kr", qp.J, dz) + qp.h0


def _where(mask, a, b):
    """``torch.where`` with a Python number on either side."""
    if not torch.is_tensor(a):
        a = torch.full_like(b, a)
    if not torch.is_tensor(b):
        b = torch.full_like(a, b)
    return torch.where(mask, a, b)


def init_ip(qp: QpData, mu0: float = _MU0, s_min: float = _S_MIN,
            z_lo0: Optional[torch.Tensor] = None,
            z_hi0: Optional[torch.Tensor] = None) -> IpState:
    """Cold or dual-warm-started IP state.

    A row violated at the linearization point (margin <= 0) starts at slack
    1 and dual mu0; a feasible row at its margin, floored at ``s_min``,
    with dual mu0 / s.  Carried duals ``z_lo0``/``z_hi0`` (where positive)
    replace the cold duals, clipped to a band of ``_WARM_KAPPA`` around
    them; zero carried duals give the cold start.  Unbounded sides keep
    slack 1 and dual 0.
    """
    lead = qp.A.shape[:-3]
    H, nx, nu = qp.A.shape[-3], qp.Q.shape[-1], qp.R.shape[-1]
    dt, dev = qp.A.dtype, qp.A.device
    dX = torch.zeros(lead + (H + 1, nx), dtype=dt, device=dev)
    dU = torch.zeros(lead + (H, nu), dtype=dt, device=dev)
    c = qp.h0
    m_lo = torch.isfinite(qp.lo)
    m_hi = torch.isfinite(qp.hi)
    s_lo = _where(m_lo, _where(c - qp.lo <= 0, 1.0,
                               torch.clamp(c - qp.lo, min=s_min)), 1.0)
    s_hi = _where(m_hi, _where(qp.hi - c <= 0, 1.0,
                               torch.clamp(qp.hi - c, min=s_min)), 1.0)
    z_lo = mu0 / s_lo
    z_hi = mu0 / s_hi
    if z_lo0 is not None:
        z_lo = torch.clamp(torch.where(z_lo0 > 0, z_lo0, z_lo),
                           z_lo / _WARM_KAPPA, z_lo * _WARM_KAPPA)
    if z_hi0 is not None:
        z_hi = torch.clamp(torch.where(z_hi0 > 0, z_hi0, z_hi),
                           z_hi / _WARM_KAPPA, z_hi * _WARM_KAPPA)
    z_lo = _where(m_lo, z_lo, 0.0)
    z_hi = _where(m_hi, z_hi, 0.0)
    return IpState(dX=dX, dU=dU, s_lo=s_lo, s_hi=s_hi, z_lo=z_lo, z_hi=z_hi,
                   mu=torch.full(lead, mu0, dtype=dt, device=dev))


def _cost_grad(qp: QpData, dX, dU):
    """Gradient of the QP objective at the current primal, per stage."""
    gx = (torch.einsum("...kij,...kj->...ki", qp.Q, dX[..., :-1, :])
          + torch.einsum("...kij,...kj->...ki", qp.M, dU) + qp.qx)
    gu = (torch.einsum("...kji,...kj->...ki", qp.M, dX[..., :-1, :])
          + torch.einsum("...kij,...kj->...ki", qp.R, dU) + qp.qu)
    gH = riccati._mv(qp.QH, dX[..., -1, :]) + qp.qH
    return gx, gu, gH


def _max_step(v, dv, mask):
    """Largest step keeping ``v + t dv >= 0`` over a lane's masked rows
    with dv < 0, (B,); inf where none."""
    neg = mask & (dv < 0)
    ratio = _where(neg, -v / _where(dv < 0, dv, -1.0), float("inf"))
    return torch.amin(ratio, dim=(-2, -1))


def ip_iteration(qp: QpData, st: IpState, reg: float,
                 sigma: float = _SIGMA_B, tau: float = _TAU) -> IpState:
    """One primal-dual Newton step on the QP of every lane."""
    NX = qp.Q.shape[-1]
    m_lo = torch.isfinite(qp.lo)
    m_hi = torch.isfinite(qp.hi)
    c = _rows_value(qp, st.dX, st.dU)
    rs_lo = _where(m_lo, st.s_lo - (c - qp.lo), 0.0)
    rs_hi = _where(m_hi, st.s_hi - (qp.hi - c), 0.0)
    sig_lo = _where(m_lo, st.z_lo / st.s_lo, 0.0)
    sig_hi = _where(m_hi, st.z_hi / st.s_hi, 0.0)
    sigma_rows = sig_lo + sig_hi
    mu = st.mu[..., None, None]
    # the Newton right-hand side's row force once (ds, dz) are eliminated:
    # mu / s + sig * rs per side (the current duals cancel)
    w_rows = (_where(m_hi, mu / st.s_hi, 0.0)
              - _where(m_lo, mu / st.s_lo, 0.0)
              + sig_hi * rs_hi - sig_lo * rs_lo)
    JtSJ = torch.einsum("...krz,...kr,...krw->...kzw", qp.J, sigma_rows,
                        qp.J)
    Jtw = torch.einsum("...krz,...kr->...kz", qp.J, w_rows)
    gx, gu, gH = _cost_grad(qp, st.dX, st.dU)
    quad = riccati.StageQuad(
        Q=qp.Q + JtSJ[..., :-1, :NX, :NX], R=qp.R + JtSJ[..., :-1, NX:, NX:],
        M=qp.M + JtSJ[..., :-1, :NX, NX:], qx=gx + Jtw[..., :-1, :NX],
        qu=gu + Jtw[..., :-1, NX:])
    QHs = qp.QH + JtSJ[..., -1, :NX, :NX]
    qHs = gH + Jtw[..., -1, :NX]
    # defects of the current primal (zero while the steps keep the linear
    # dynamics, computed all the same)
    defect = (torch.einsum("...kij,...kj->...ki", qp.A, st.dX[..., :-1, :])
              + torch.einsum("...kij,...kj->...ki", qp.B, st.dU) + qp.r
              - st.dX[..., 1:, :])
    dyn = riccati.LinDyn(A=qp.A, B=qp.B, r=defect)
    ddX, ddU, _ = riccati.solve_lqr(quad, QHs, qHs, dyn,
                                    torch.zeros_like(st.dX[..., 0, :]), reg)
    ddz = torch.cat([ddX, _ext(ddU)], dim=-1)
    Jd = torch.einsum("...krz,...kz->...kr", qp.J, ddz)
    ds_lo = _where(m_lo, Jd - rs_lo, 0.0)
    ds_hi = _where(m_hi, -Jd - rs_hi, 0.0)
    dz_lo = _where(m_lo, mu / st.s_lo - st.z_lo - sig_lo * ds_lo, 0.0)
    dz_hi = _where(m_hi, mu / st.s_hi - st.z_hi - sig_hi * ds_hi, 0.0)
    alpha = torch.clamp(tau * torch.minimum(
        torch.minimum(_max_step(st.s_lo, ds_lo, m_lo),
                      _max_step(st.s_hi, ds_hi, m_hi)),
        torch.minimum(_max_step(st.z_lo, dz_lo, m_lo),
                      _max_step(st.z_hi, dz_hi, m_hi))), max=1.0)
    a = alpha[..., None, None]
    s_lo = _where(m_lo, torch.clamp(st.s_lo + a * ds_lo, min=_S_FLOOR), 1.0)
    s_hi = _where(m_hi, torch.clamp(st.s_hi + a * ds_hi, min=_S_FLOOR), 1.0)
    z_lo = _where(m_lo, torch.clamp(st.z_lo + a * dz_lo, max=_Z_MAX), 0.0)
    z_hi = _where(m_hi, torch.clamp(st.z_hi + a * dz_hi, max=_Z_MAX), 0.0)
    n_act = (m_lo.sum(dim=(-2, -1)) + m_hi.sum(dim=(-2, -1))).to(s_lo.dtype)
    gap = (_where(m_lo, s_lo * z_lo, 0.0).sum(dim=(-2, -1))
           + _where(m_hi, s_hi * z_hi, 0.0).sum(dim=(-2, -1))) / n_act
    return IpState(dX=st.dX + a * ddX, dU=st.dU + a * ddU, s_lo=s_lo,
                   s_hi=s_hi, z_lo=z_lo, z_hi=z_hi,
                   mu=torch.clamp(sigma * gap, min=_MU_MIN))


def solve_qp(qp: QpData, n_iters: int = 10, reg: float = 1e-7,
             mu0: float = _MU0, z_lo0: Optional[torch.Tensor] = None,
             z_hi0: Optional[torch.Tensor] = None) -> IpState:
    """``n_iters`` Newton steps from :func:`init_ip`."""
    st = init_ip(qp, mu0, z_lo0=z_lo0, z_hi0=z_hi0)
    for _ in range(n_iters):
        st = ip_iteration(qp, st, reg)
    return st
