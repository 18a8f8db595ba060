"""The stagewise QP's data of the Riccati sweep (``mpc_tpu.ops.riccati``).

The equality-constrained stagewise QP

    min  sum_k 1/2 [dx;du]_k' [[Q, M],[M', R]]_k [dx;du]_k + [qx;qu]_k'[dx;du]_k
         + 1/2 dx_H' Q_H dx_H + q_H' dx_H
    s.t. dx_{k+1} = A_k dx_k + B_k du_k + r_k

is solved by one backward Riccati recursion and one forward rollout.  These
are its inputs and gains, with the JAX package's fields, and the sweep of
the per-lane path (``ops.sqp``, ``ops.ipqp``): :func:`backward_pass` and
:func:`solve_lqr`, written once over a leading lane axis (the JAX package
vmaps its per-lane functions) in any dtype.  The engine ``engine='xla'``
sweeps with ``ops.riccati_vec`` instead (a CUDA kernel on the GPU).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class StageQuad(NamedTuple):
    """Stagewise quadratic model, stacked over the horizon.

    Q (B, H, nx, nx), R (B, H, nu, nu), M (B, H, nx, nu), qx (B, H, nx),
    qu (B, H, nu).
    """

    Q: torch.Tensor
    R: torch.Tensor
    M: torch.Tensor
    qx: torch.Tensor
    qu: torch.Tensor


class LinDyn(NamedTuple):
    """Linearized dynamics dx' = A dx + B du + r, stacked over the horizon."""

    A: torch.Tensor  # (B, H, nx, nx)
    B: torch.Tensor  # (B, H, nx, nu)
    r: torch.Tensor  # (B, H, nx) defect / affine term


class RiccatiGains(NamedTuple):
    K: torch.Tensor    # (B, H, nu, nx) feedback gains
    d: torch.Tensor    # (B, H, nu)     feedforward terms
    dV1: torch.Tensor  # (B,) predicted decrease, linear term sum d'gu
    dV2: torch.Tensor  # (B,) predicted decrease, quadratic term
                       # sum d'(Quu + reg) d


def _inv2x2(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 2, 2) matrices."""
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    inv_det = 1.0 / (a * d - b * c)
    row0 = torch.stack([d, -b], dim=-1)
    row1 = torch.stack([-c, a], dim=-1)
    return torch.stack([row0, row1], dim=-2) * inv_det[..., None, None]


def _inv_nu(m: torch.Tensor) -> torch.Tensor:
    if m.shape[-1] == 2:
        return _inv2x2(m)
    return torch.linalg.inv(m)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def backward_pass(quad: StageQuad, QH: torch.Tensor, qH: torch.Tensor,
                  dyn: LinDyn, reg) -> RiccatiGains:
    """Backward Riccati recursion with input-space regularization ``reg``
    (``mpc_tpu.ops.riccati.backward_pass``, lanes leading).

    quad.* and dyn.* are (B, H, ...), QH (B, NX, NX), qH (B, NX).  Returns
    the gains and the predicted decrease terms of the line search,
    dV(alpha) = alpha dV1 + alpha^2 / 2 dV2.
    """
    H = quad.Q.shape[-3]
    P, p = QH, qH
    eye = torch.eye(quad.R.shape[-1], dtype=quad.R.dtype,
                    device=quad.R.device)
    Ks, ds, dv1, dv2 = [None] * H, [None] * H, [], []
    for k in range(H - 1, -1, -1):
        A, Bm, r = dyn.A[..., k, :, :], dyn.B[..., k, :, :], dyn.r[..., k, :]
        At, Bt = A.transpose(-1, -2), Bm.transpose(-1, -2)
        Pr_p = p + _mv(P, r)
        PA = P @ A
        PB = P @ Bm
        Qxx = quad.Q[..., k, :, :] + At @ PA
        Quu = quad.R[..., k, :, :] + Bt @ PB
        Qux = quad.M[..., k, :, :].transpose(-1, -2) + Bt @ PA
        gx = quad.qx[..., k, :] + _mv(At, Pr_p)
        gu = quad.qu[..., k, :] + _mv(Bt, Pr_p)
        Quu_reg = Quu + reg * eye
        Quu_inv = _inv_nu(Quu_reg)
        K = -(Quu_inv @ Qux)
        d = -_mv(Quu_inv, gu)
        QuxT = Qux.transpose(-1, -2)
        P_new = Qxx + QuxT @ K
        # symmetrize against float32 drift over long horizons
        P = 0.5 * (P_new + P_new.transpose(-1, -2))
        p = gx + _mv(QuxT, d)
        Ks[k], ds[k] = K, d
        dv1.append(torch.sum(d * gu, dim=-1))
        dv2.append(torch.sum(d * _mv(Quu_reg, d), dim=-1))
    return RiccatiGains(K=torch.stack(Ks, dim=-3), d=torch.stack(ds, dim=-2),
                        dV1=torch.stack(dv1).sum(0),
                        dV2=torch.stack(dv2).sum(0))


def solve_lqr(quad: StageQuad, QH: torch.Tensor, qH: torch.Tensor,
              dyn: LinDyn, dx0: torch.Tensor, reg):
    """The stagewise QP's exact minimizer: :func:`backward_pass`, then the
    linear forward rollout from ``dx0`` (B, NX).  Returns (dX (B, H+1, NX),
    dU (B, H, NU), gains)."""
    gains = backward_pass(quad, QH, qH, dyn, reg)
    H = quad.Q.shape[-3]
    dx, dXs, dUs = dx0, [], []
    for k in range(H):
        du = _mv(gains.K[..., k, :, :], dx) + gains.d[..., k, :]
        dXs.append(dx)
        dUs.append(du)
        dx = (_mv(dyn.A[..., k, :, :], dx) + _mv(dyn.B[..., k, :, :], du)
              + dyn.r[..., k, :])
    dXs.append(dx)
    return torch.stack(dXs, dim=-2), torch.stack(dUs, dim=-2), gains
