"""The batched Riccati sweep and feedback rollout (``mpc_tpu.ops.riccati_vec``).

Drop-in batched counterparts, lanes leading, of the per-lane LQR pieces of
the Gauss-Newton step that ``ops.sqp_vec`` runs over the whole batch:

* :func:`backward_pass_vec`: the backward Riccati recursion with the affine
  defect ``r``, the closed-form 2x2 inverse of ``Quu + reg I`` and the
  predicted-decrease terms ``dV1 = sum d'gu`` and ``dV2 = sum d'(Quu+reg)d``.
  On the GPU it is the hand-written kernel (``ops.riccati_kernel``), on the
  CPU :func:`backward_pass_vec_plain`, its plain PyTorch version; nothing
  falls back from one to the other.
* :func:`feedback_rollout_vec`: the box-clamped iLQR forward pass for every
  line-search step size at once.
"""
from __future__ import annotations

from typing import Sequence

import torch

from mpc_tpu_torch.device import resolve_device
from mpc_tpu_torch.models import dynamics
from mpc_tpu_torch.ops.fused_gn import _mm, _mv, _to
from mpc_tpu_torch.ops.riccati import LinDyn, RiccatiGains, StageQuad

NU = 2


def backward_pass_vec_plain(quad: StageQuad, QH: torch.Tensor,
                            qH: torch.Tensor, dyn: LinDyn,
                            reg) -> RiccatiGains:
    """The sweep in plain PyTorch; the contract of ``mpc_tpu``'s
    ``riccati_vec.backward_pass_vec``.

    quad.*, dyn.* are (B, H, ...), QH (B, NX, NX), qH (B, NX).  Returns K
    (B, H, NU, NX), d (B, H, NU) and dV1, dV2 (B,).  NX comes from the
    inputs; NU must be 2 (closed-form Quu inverse).
    """
    if quad.R.shape[-1] != NU:
        raise ValueError(f"the sweep takes NU = {NU}, got "
                         f"{quad.R.shape[-1]}")
    reg = float(reg)
    H = quad.Q.shape[1]
    P, p = QH, qH
    Ks, ds, dv1, dv2 = [None] * H, [None] * H, [], []
    for k in range(H - 1, -1, -1):
        A, Bm, r = dyn.A[:, k], dyn.B[:, k], dyn.r[:, k]
        At, Bt = A.transpose(-1, -2), Bm.transpose(-1, -2)
        PA, PB = _mm(P, A), _mm(P, Bm)
        Prp = p + _mv(P, r)
        Qxx = quad.Q[:, k] + _mm(At, PA)
        Quu = quad.R[:, k] + _mm(Bt, PB)
        Qux = quad.M[:, k].transpose(-1, -2) + _mm(Bt, PA)
        gx = quad.qx[:, k] + _mv(At, Prp)
        gu = quad.qu[:, k] + _mv(Bt, Prp)
        a = Quu[:, 0, 0] + reg
        b = Quu[:, 0, 1]
        c = Quu[:, 1, 0]
        dd = Quu[:, 1, 1] + reg
        inv_det = 1.0 / (a * dd - b * c)
        Qi = torch.stack([torch.stack([dd * inv_det, -b * inv_det], -1),
                          torch.stack([-c * inv_det, a * inv_det], -1)], -2)
        K = -_mm(Qi, Qux)
        d = -_mv(Qi, gu)
        QuxT = Qux.transpose(-1, -2)
        P_new = Qxx + _mm(QuxT, K)
        P = 0.5 * (P_new + P_new.transpose(-1, -2))
        p = gx + _mv(QuxT, d)
        Ks[k], ds[k] = K, d
        dv1.append(d[:, 0] * gu[:, 0] + d[:, 1] * gu[:, 1])
        qd0 = a * d[:, 0] + b * d[:, 1]
        qd1 = c * d[:, 0] + dd * d[:, 1]
        dv2.append(d[:, 0] * qd0 + d[:, 1] * qd1)
    return RiccatiGains(K=torch.stack(Ks, 1), d=torch.stack(ds, 1),
                        dV1=torch.stack(dv1).sum(0),
                        dV2=torch.stack(dv2).sum(0))


def backward_pass_vec(quad: StageQuad, QH: torch.Tensor, qH: torch.Tensor,
                      dyn: LinDyn, reg, device=None) -> RiccatiGains:
    """Batched backward sweep on ``device`` (default: the GPU, see
    ``resolve_device``; the inputs are moved there): one launch of the CUDA
    kernel on the GPU, :func:`backward_pass_vec_plain` on the CPU.  Same
    contract as the plain version."""
    dev = resolve_device(device)
    quad, QH, qH, dyn = (_to(t, dev) for t in (quad, QH, qH, dyn))
    if dev.type == "cuda":
        from mpc_tpu_torch.ops import riccati_kernel
        return riccati_kernel.sweep(quad, QH, qH, dyn, reg)
    if dev.type == "cpu":
        return backward_pass_vec_plain(quad, QH, qH, dyn, reg)
    raise ValueError(f"unsupported device {dev}")


def _ode_rows(model: str, wheelbase: float, vehicle=None):
    """Rows-form ODE (``mpc_tpu.ops.riccati_vec._ode_rows``): x is an
    NX-list of same-shape tensors, u an NU-list; entrywise the formulas of
    ``models.dynamics.ks_ode`` / ``st_ode``, so the rollout never stacks
    (..., NX) state vectors."""
    if model == "ks":
        def ode(x, u):
            v, delta, psi = x[3], x[2], x[4]
            return [v * torch.cos(psi), v * torch.sin(psi), u[0], u[1],
                    v / wheelbase * torch.tan(delta)]
        return ode
    if model != "st":
        raise ValueError(f"unknown model '{model}'")
    if vehicle is None:
        raise ValueError("model='st' requires vehicle")
    g, mu, C_Sf, C_Sr, lf, lr, l, h, m, I = dynamics.st_params(vehicle)

    def ode(x, u):
        delta, v, psi, psi_dot, beta = x[2], x[3], x[4], x[5], x[6]
        u0, u1 = u[0], u[1]
        beta_kin = torch.arctan(torch.tan(delta) * lr / l)
        v_safe = torch.where(torch.abs(v) < 1e-3, 1e-3, v)
        f_low_psi = v * torch.cos(beta_kin) * torch.tan(delta) / l
        d_beta = (lr * u0) / (l * torch.cos(delta) ** 2
                              * (1.0 + (torch.tan(delta) ** 2 * lr / l) ** 2))
        dd_psi = (1.0 / l) * (
            u1 * torch.cos(beta) * torch.tan(delta)
            - v * torch.sin(beta) * d_beta * torch.tan(delta)
            + v * torch.cos(beta) * u0 / torch.cos(delta) ** 2)
        f_low = [v * torch.cos(beta_kin + psi), v * torch.sin(beta_kin + psi),
                 u0, u1, f_low_psi, dd_psi, d_beta]
        f_high = [
            v * torch.cos(beta + psi),
            v * torch.sin(beta + psi),
            u0, u1,
            psi_dot,
            -mu * m / (v_safe * I * (lr + lf))
            * (lf ** 2 * C_Sf * (g * lr - u1 * h)
               + lr ** 2 * C_Sr * (g * lf + u1 * h)) * psi_dot
            + mu * m / (I * (lr + lf))
            * (lr * C_Sr * (g * lf + u1 * h)
               - lf * C_Sf * (g * lr - u1 * h)) * beta
            + mu * m / (I * (lr + lf)) * lf * C_Sf
            * (g * lr - u1 * h) * delta,
            (mu / (v_safe ** 2 * (lr + lf))
             * (C_Sr * (g * lf + u1 * h) * lr
                - C_Sf * (g * lr - u1 * h) * lf) - 1.0) * psi_dot
            - mu / (v_safe * (lr + lf))
            * (C_Sr * (g * lf + u1 * h) + C_Sf * (g * lr - u1 * h)) * beta
            + mu / (v_safe * (lr + lf))
            * (C_Sf * (g * lr - u1 * h)) * delta,
        ]
        low = torch.abs(v) < 0.1
        return [torch.where(low, flo, fhi) for flo, fhi in zip(f_low, f_high)]
    return ode


def feedback_rollout_vec(dt: float, wheelbase: float, x0: torch.Tensor,
                         X_bar: torch.Tensor, U_bar: torch.Tensor,
                         K: torch.Tensor, d: torch.Tensor,
                         alphas: Sequence[float], u_lo, u_hi,
                         integrator: str, model: str = "ks", vehicle=None):
    """Box-clamped iLQR forward pass for ALL ``alphas`` in one pass:
    u = clip(U_bar + alpha d + K (x - X_bar)) along the nonlinear dynamics
    (the rows of :func:`_ode_rows`, RK4 or Euler).

    x0 (B, NX), X_bar (B, H+1, NX), U_bar (B, H, NU), K (B, H, NU, NX),
    d (B, H, NU); u_lo, u_hi are the NU input bounds; NX comes from x0 (5
    for KS, 7 for ST).  Returns Xa (A, B, H+1, NX) and Ua (A, B, H, NU).
    """
    ode = _ode_rows(model, wheelbase, vehicle)
    A, (B, H), nx = len(alphas), U_bar.shape[:2], x0.shape[-1]
    al = torch.tensor(alphas, dtype=x0.dtype, device=x0.device)[:, None]

    def add(x, s, k):
        return [x[i] + s * k[i] for i in range(nx)]

    x = x0.expand((A,) + x0.shape)
    xs, us = [x], []
    for k in range(H):
        fb = (K[:, k] * (x - X_bar[:, k])[..., None, :]).sum(-1)  # (A,B,NU)
        u = U_bar[:, k] + al[..., None] * d[:, k] + fb
        u = [torch.clamp(u[..., i], u_lo[i], u_hi[i]) for i in range(NU)]
        xr = [x[..., i] for i in range(nx)]
        k1 = ode(xr, u)
        if integrator == "rk4":
            k2 = ode(add(xr, dt / 2, k1), u)
            k3 = ode(add(xr, dt / 2, k2), u)
            k4 = ode(add(xr, dt, k3), u)
            xr = [xr[i] + dt / 6 * (k1[i] + 2 * k2[i] + 2 * k3[i] + k4[i])
                  for i in range(nx)]
        else:
            xr = add(xr, dt, k1)
        us.append(torch.stack(u, -1))
        x = torch.stack(xr, -1)
        xs.append(x)
    return torch.stack(xs, 2), torch.stack(us, 2)
