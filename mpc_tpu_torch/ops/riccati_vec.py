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
from mpc_tpu_torch.models import dynamics as dyn_mod
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


def feedback_rollout_vec(dt: float, wheelbase: float, x0: torch.Tensor,
                         X_bar: torch.Tensor, U_bar: torch.Tensor,
                         K: torch.Tensor, d: torch.Tensor,
                         alphas: Sequence[float], u_lo, u_hi,
                         integrator: str, model: str = "ks", vehicle=None):
    """Box-clamped iLQR forward pass for ALL ``alphas`` in one pass:
    u = clip(U_bar + alpha d + K (x - X_bar)) along the nonlinear dynamics.

    x0 (B, NX), X_bar (B, H+1, NX), U_bar (B, H, NU), K (B, H, NU, NX),
    d (B, H, NU); u_lo, u_hi are the NU input bounds.  Returns Xa
    (A, B, H+1, NX) and Ua (A, B, H, NU).
    """
    if model != "ks":
        raise NotImplementedError(
            f"model '{model}': the ST rows of the rollout are ROADMAP queue "
            "A, item 1 (ST)")
    step = dyn_mod.make_step_fn(integrator, dt, wheelbase)
    A, (B, H) = len(alphas), U_bar.shape[:2]
    al = torch.tensor(alphas, dtype=x0.dtype, device=x0.device)[:, None]
    x = x0.expand((A,) + x0.shape)
    xs, us = [x], []
    for k in range(H):
        fb = (K[:, k] * (x - X_bar[:, k])[..., None, :]).sum(-1)  # (A,B,NU)
        u = U_bar[:, k] + al[..., None] * d[:, k] + fb
        u = torch.stack([torch.clamp(u[..., i], u_lo[i], u_hi[i])
                         for i in range(NU)], -1)
        us.append(u)
        x = step(x, u)
        xs.append(x)
    return torch.stack(xs, 2), torch.stack(us, 2)
