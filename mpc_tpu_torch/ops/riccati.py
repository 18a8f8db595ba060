"""The stagewise QP's data of the Riccati sweep (``mpc_tpu.ops.riccati``).

The equality-constrained stagewise QP

    min  sum_k 1/2 [dx;du]_k' [[Q, M],[M', R]]_k [dx;du]_k + [qx;qu]_k'[dx;du]_k
         + 1/2 dx_H' Q_H dx_H + q_H' dx_H
    s.t. dx_{k+1} = A_k dx_k + B_k du_k + r_k

is solved by one backward Riccati recursion and one forward rollout.  These
are its inputs and gains, with the JAX package's fields; every tensor has a
leading lane axis.  The batched sweep is ``ops.riccati_vec``; the per-lane
``backward_pass``/``solve_lqr`` of the vmapped path are a later item of
ROADMAP queue A (item 9).
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
