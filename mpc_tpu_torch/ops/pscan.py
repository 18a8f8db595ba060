"""Parallel-scan (associative) Riccati sweep (``mpc_tpu.ops.pscan``).

The log-depth alternative to the sequential sweep of ``ops.riccati``: the
LQR value-function recursion is an associative composition of
conditional-value-function elements (the 5-tuples of Sarkka and
Garcia-Fernandez's temporal parallelization of LQ problems), and the
suffix compositions are a scan over the stage axis.  Cross terms M are
eliminated by completing the square in the controls before the elements
are built; linear costs ride the eta channel, the dynamics' affine terms
the b channel.

Lanes lead, as in ``ops.riccati``: quad.Q is (B, H, nx, nx), an element
stack (B, n, ...).  The scan is written out as a Hillis-Steele scan in
eager ops: ceil(log2 n) rounds, each one batched ``_combine`` over every
stage whose partner lies in range.  ``torch.linalg.solve`` and matmuls do
the work, as ``jnp.linalg.solve`` does in the JAX package, outside any
hand-written kernel.

The stage-sharded form (``backward_pass_pscan(..., mesh=, axis='sp')``):
each rank along ``axis`` holds a contiguous block of the H+1 elements,
scans it, all-gathers the block totals, composes the totals of the later
blocks into its own suffixes, computes the gains of its stages, then
all-gathers K and d and all-reduces dV1 and dV2, so every rank goes on
with the whole gains: the computation that the JAX package's sharding
constraints on the stage axis give under GSPMD.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mpc_tpu_torch.ops.riccati import (LinDyn, RiccatiGains, StageQuad,
                                       _inv_nu, _mv)


class _Elem(NamedTuple):
    """Conditional value-function elements, (B, n, ...) over n stages."""

    A: torch.Tensor    # (B, n, nx, nx)
    b: torch.Tensor    # (B, n, nx)
    C: torch.Tensor    # (B, n, nx, nx)
    eta: torch.Tensor  # (B, n, nx)
    J: torch.Tensor    # (B, n, nx, nx)


class _Affine(NamedTuple):
    """Affine maps x -> M x + v, (B, n, ...) over n stages."""

    M: torch.Tensor    # (B, n, nx, nx)
    v: torch.Tensor    # (B, n, nx)


def _t(m):
    return m.transpose(-1, -2)


def _combine(ei: _Elem, ej: _Elem) -> _Elem:
    """Element i (the earlier stages) composed with element j (the later
    ones), batched over any leading axes."""
    nx = ei.A.shape[-1]
    eye = torch.eye(nx, dtype=ei.A.dtype, device=ei.A.device)
    # (I + C_i J_j)^{-1} and (I + J_j C_i)^{-1} applied by solves
    M1 = eye + ei.C @ ej.J
    M2 = eye + ej.J @ ei.C
    S1 = torch.linalg.solve(M1, torch.cat(
        [ei.A, (ei.b + _mv(ei.C, ej.eta))[..., None], ei.C], dim=-1))
    A1, bc, C1 = S1[..., :nx], S1[..., nx], S1[..., nx + 1:]
    A = ej.A @ A1
    b = _mv(ej.A, bc) + ej.b
    C = ej.A @ C1 @ _t(ej.A) + ej.C
    S2 = torch.linalg.solve(M2, torch.cat(
        [(ej.eta - _mv(ej.J, ei.b))[..., None], ej.J @ ei.A], dim=-1))
    eta = _mv(_t(ei.A), S2[..., 0]) + ei.eta
    J = _t(ei.A) @ S2[..., 1:] + ei.J
    # J and C are symmetric by construction
    return _Elem(A=A, b=b, C=0.5 * (C + _t(C)), eta=eta,
                 J=0.5 * (J + _t(J)))


def _take(e, lo: int, hi: int):
    return type(e)(*(f[:, lo:hi] for f in e))


def _cat(a, b):
    return type(a)(*(torch.cat([x, y], dim=1) for x, y in zip(a, b)))


def _suffix_scan(e: _Elem) -> _Elem:
    """S_k = e_k o e_{k+1} o ... o e_{n-1} for every k (stage axis 1):
    each round composes S_k with S_{k+d}, the suffix that starts where
    S_k's span ends, for d = 1, 2, 4, ..."""
    n, d = e.A.shape[1], 1
    while d < n:
        e = _cat(_combine(_take(e, 0, n - d), _take(e, d, n)),
                 _take(e, n - d, n))
        d *= 2
    return e


def _prefix_scan(comb, e):
    """P_k = e_0 . ... . e_k (``comb(earlier, later)``) for every k."""
    n, d = e[0].shape[1], 1
    while d < n:
        e = _cat(_take(e, 0, d), comb(_take(e, 0, n - d), _take(e, d, n)))
        d *= 2
    return e


def _eliminate_cross_terms(quad: StageQuad, dyn: LinDyn, reg):
    """Complete the square in u: v = u + R^{-1} (M' dx + qu).

    Returns (Qt, qt, At, rt, R_reg, Rinv_Mt, Rinv_qu): the transformed
    problem has no cross terms and v-controls.
    """
    eye = torch.eye(quad.R.shape[-1], dtype=quad.R.dtype,
                    device=quad.R.device)
    R_reg = quad.R + reg * eye
    Rinv = _inv_nu(R_reg)
    Rinv_Mt = Rinv @ _t(quad.M)                 # (B, H, nu, nx)
    Rinv_qu = _mv(Rinv, quad.qu)                # (B, H, nu)
    Qt = quad.Q - quad.M @ Rinv_Mt
    qt = quad.qx - _mv(quad.M, Rinv_qu)
    At = dyn.A - dyn.B @ Rinv_Mt
    rt = dyn.r - _mv(dyn.B, Rinv_qu)
    return Qt, qt, At, rt, R_reg, Rinv_Mt, Rinv_qu


def _elements(quad: StageQuad, QH, qH, dyn: LinDyn, reg, lo: int = 0,
              hi: Optional[int] = None) -> _Elem:
    """Elements lo..hi-1 (default all) of the H+1: stage k's at k and the
    terminal cost's at H.  Only the stages of the block are built."""
    H = quad.Q.shape[1]
    hi = H + 1 if hi is None else hi
    parts = []
    if lo < H:
        stage = (lambda t: t[:, lo:min(hi, H)])
        quad, dyn = StageQuad(*map(stage, quad)), LinDyn(*map(stage, dyn))
        Qt, qt, At, rt, R_reg, _, _ = _eliminate_cross_terms(quad, dyn, reg)
        C_k = dyn.B @ _inv_nu(R_reg) @ _t(dyn.B)
        parts.append(_Elem(A=At, b=rt, C=C_k, eta=-qt, J=Qt))
    if hi > H:
        zeros_m = torch.zeros_like(QH[:, None])
        zeros_v = torch.zeros_like(qH[:, None])
        parts.append(_Elem(A=zeros_m, b=zeros_v, C=zeros_m,
                           eta=-qH[:, None], J=QH[:, None]))
    return parts[0] if len(parts) == 1 else _cat(*parts)


def value_functions(quad: StageQuad, QH: torch.Tensor, qH: torch.Tensor,
                    dyn: LinDyn, reg):
    """Every value function (P_k (B, H+1, nx, nx), p_k (B, H+1, nx)),
    k = 0..H, by the suffix scan."""
    suffix = _suffix_scan(_elements(quad, QH, qH, dyn, reg))
    return suffix.J, -suffix.eta


def _block(n: int, parts: int, i: int):
    """(lo, hi) of block i when n items split into ``parts`` contiguous
    blocks, the first n % parts of them one longer."""
    base, extra = divmod(n, parts)
    lo = i * base + min(i, extra)
    return lo, lo + base + (i < extra)


def _sharded_value_functions(quad, QH, qH, dyn, reg, mesh, axis):
    """(P, p, lo): the value functions of this rank's block [lo, hi) of
    the H+1 elements, with the later blocks composed in."""
    from mpc_tpu_torch.parallel import mesh as pm
    n = quad.Q.shape[1] + 1
    parts, me = mesh.size(axis), mesh.index(axis)
    if n < parts:
        raise ValueError(f"{n} stages cannot split over {axis}={parts}")
    lo, hi = _block(n, parts, me)
    local = _suffix_scan(_elements(quad, QH, qH, dyn, reg, lo, hi))
    # the block totals, one element a rank, packed into one gather
    widths = [f.shape[2:].numel() for f in local]
    total = torch.cat([f[:, 0].reshape(f.shape[0], -1) for f in local], -1)
    totals = pm.all_gather(total, mesh, axis)

    def unpack(flat):
        parts_ = torch.split(flat, widths, dim=-1)
        return _Elem(*(p.reshape((flat.shape[0], 1) + f.shape[2:])
                       for p, f in zip(parts_, local)))

    if me + 1 < parts:
        later = unpack(totals[me + 1])
        for j in range(me + 2, parts):
            later = _combine(later, unpack(totals[j]))
        later = _Elem(*(f.expand_as(g) for f, g in zip(later, local)))
        local = _combine(local, later)
    return local.J, -local.eta, lo


def _gains(quad: StageQuad, dyn: LinDyn, reg, P1, p1):
    """K, d and the per-stage decrease terms of the stages whose
    next-stage value functions are (P1, p1)."""
    Bt = _t(dyn.B)
    Quu = quad.R + Bt @ P1 @ dyn.B
    Qux = _t(quad.M) + Bt @ P1 @ dyn.A
    gu = quad.qu + _mv(Bt, p1 + _mv(P1, dyn.r))
    eye = torch.eye(Quu.shape[-1], dtype=Quu.dtype, device=Quu.device)
    Quu_reg = Quu + reg * eye
    Quu_inv = _inv_nu(Quu_reg)
    K = -(Quu_inv @ Qux)
    d = -_mv(Quu_inv, gu)
    return K, d, (d * gu).sum(-1), (d * _mv(Quu_reg, d)).sum(-1)


def backward_pass_pscan(quad: StageQuad, QH: torch.Tensor, qH: torch.Tensor,
                        dyn: LinDyn, reg, mesh=None,
                        axis: Optional[str] = None) -> RiccatiGains:
    """Drop-in for ``riccati.backward_pass`` (log-depth).  With ``mesh``
    and ``axis`` the stages split over the ranks along ``axis``; every
    rank returns the whole gains."""
    if mesh is None or axis is None or mesh.size(axis) == 1:
        P, p = value_functions(quad, QH, qH, dyn, reg)
        K, d, dv1, dv2 = _gains(quad, dyn, reg, P[:, 1:], p[:, 1:])
        return RiccatiGains(K=K, d=d, dV1=dv1.sum(-1), dV2=dv2.sum(-1))
    from mpc_tpu_torch.parallel import mesh as pm
    H = quad.Q.shape[1]
    P, p, lo = _sharded_value_functions(quad, QH, qH, dyn, reg, mesh, axis)
    # stage k reads element k + 1: this rank's stages are [s0, s1)
    s0, s1 = max(lo - 1, 0), lo + P.shape[1] - 1
    skip = s0 - (lo - 1)            # element 0 belongs to no stage
    stage = (lambda t: t[:, s0:s1])
    K, d, dv1, dv2 = _gains(StageQuad(*map(stage, quad)),
                            LinDyn(*map(stage, dyn)), reg, P[:, skip:],
                            p[:, skip:])
    # K and d of every stage, gathered in one padded block a rank
    nu, nx = K.shape[-2:]
    most = max(b - a for a, b in (_block(H + 1, mesh.size(axis), i)
                                  for i in range(mesh.size(axis))))
    mine = torch.cat([K.flatten(-2), d], dim=-1)
    mine = torch.cat([mine, mine.new_zeros(
        (mine.shape[0], most - mine.shape[1], mine.shape[2]))], dim=1)
    blocks = pm.all_gather(mine, mesh, axis)
    rows = []
    for i, blk in enumerate(blocks):
        a, b = _block(H + 1, mesh.size(axis), i)
        rows.append(blk[:, :b - 1 - max(a - 1, 0)])
    KD = torch.cat(rows, dim=1)
    dV = pm.all_reduce(torch.stack([dv1.sum(-1), dv2.sum(-1)]), mesh, axis)
    return RiccatiGains(K=KD[..., :nu * nx].reshape(KD.shape[:2] + (nu, nx)),
                        d=KD[..., nu * nx:], dV1=dV[0], dV2=dV[1])


def forward_rollout_pscan(gains: RiccatiGains, dyn: LinDyn,
                          dx0: torch.Tensor):
    """The linear forward rollout as a prefix scan of affine maps; returns
    (dX (B, H+1, nx), dU (B, H, nu))."""
    M = dyn.A + dyn.B @ gains.K                  # (B, H, nx, nx)
    v = _mv(dyn.B, gains.d) + dyn.r              # (B, H, nx)

    def comb(a, b):
        # a earlier, b later: x -> Mb (Ma x + va) + vb
        return _Affine(b.M @ a.M, _mv(b.M, a.v) + b.v)

    Mc, vc = _prefix_scan(comb, _Affine(M, v))
    dX = torch.cat([dx0[:, None], _mv(Mc, dx0[:, None]) + vc], dim=1)
    dU = _mv(gains.K, dX[:, :-1]) + gains.d
    return dX, dU


def solve_lqr_pscan(quad: StageQuad, QH: torch.Tensor, qH: torch.Tensor,
                    dyn: LinDyn, dx0: torch.Tensor, reg):
    """The whole log-depth LQR solve (drop-in for ``riccati.solve_lqr``):
    (dX, dU, gains)."""
    gains = backward_pass_pscan(quad, QH, qH, dyn, reg)
    dX, dU = forward_rollout_pscan(gains, dyn, dx0)
    return dX, dU, gains
