"""The whole batched hard-constrained RTI-SQP solve in one kernel launch
(``mpc_tpu.ops.fused_ip``).

One launch runs, for every lane::

    initial rollout                      (rows cached en route)
    for ip_sqp_iters:                    # RTI relinearizations
        slacks and duals from the row margins (or the warm duals)
        for ip_iters:                    # primal-dual Newton steps
            stage quadratics with sigma = z / s row weights
            Riccati backward sweep       (the first one fills the (A, B)
                                          cache, the others read it)
            linear forward pass          (ddX, ddU)
            slack and dual steps, fraction-to-boundary step
            apply, barrier from the complementarity gap
        dU scrubbed of NaN/inf
        ip_alphas == ():  the unguarded full dU step (one rollout)
        else:             exact-penalty ladder (objective + rho * viol)
    diagnostics                          (Lagrangian stationarity with the
                                          final duals lam = z_hi - z_lo,
                                          per-row violation, scaled
                                          violation, cost)

Two implementations of the same function:

* the CUDA C++ kernels, launched by :func:`launch_ip` on CUDA tensors: for
  the KS model without road-boundary rows ``csrc/fused_ip.cu`` (one warp
  per lane, a thread per stage, the Newton state in registers and shared
  memory, every buffer lanes leading); for the KS model with them and for
  the ST model ``csrc/fused_ip_ring.cu`` (32 lanes and 4 warps a block on
  fused_gn's ring of stage operands, the Newton state in device memory,
  every buffer lanes fastest), built as the libraries
  ``fused_ip_ks_ring`` and ``fused_ip_st`` (:func:`ip_library`);
* :func:`solve_batch_fused_ip_plain`, the plain PyTorch version over a
  leading lane axis, with the stage-independent work evaluated for all
  stages at once.  The CPU runs it, and the kernel is checked against it on
  the GPU.

:func:`solve_batch_fused_ip` takes a CPU tensor to the plain version and a
CUDA tensor to the kernel; nothing falls back from one to the other.

Envelope (:func:`eligible_ip`): the KS or the ST model, method 'ip',
forcespro or casadi rows, RK4 or Euler, static (B, 3, 2) or moving (B, H+1,
3, 2) obstacles, with or without the 6 road-boundary rows (given the
boundaries; their per-stage models are ``fused_gn.boundary_models``), cold
or warm duals, any ``ip_sqp_iters x ip_iters`` budget, ``ip_alphas=()`` or
a ladder of at most ``MAX_ALPHAS`` rungs, and a horizon within the
library's kernel: ``fused_ip.cu`` at most ``MAX_HORIZON`` stages whose lane
a block holds, the ring source a block of 32 lanes within a block's shared
memory (``MAX_HORIZON_ST``, ``MAX_HORIZON_KS_RING``).
"""
from __future__ import annotations

import ctypes

import torch

from mpc_tpu_torch.device import resolve_device
from mpc_tpu_torch.ops import fused_gn as F
from mpc_tpu_torch.ops import sqp as S
from mpc_tpu_torch.ops.fused_gn import (
    MAX_ALPHAS, NBND, NU, NX, NX_ST, StConsts, _assemble_quad, _cols, _mat,
    _mv, _row_bounds, _row_lin, _row_values, _vec, make_consts)
from mpc_tpu_torch.ops.ipqp import (
    _MU0, _MU_MIN, _S_FLOOR, _S_MIN, _SIGMA_B, _TAU, _WARM_KAPPA, _Z_MAX)

_BIG = 1e30    # "no bound" of the fraction-to-boundary ratio; merit of a
               # non-finite rollout in the ladder
TPL = 32       # threads per lane: one warp, a thread per stage
MAX_SPT = 2    # stages a thread holds, at most (csrc/fused_ip.cu MAX_SPT)
MAX_HORIZON = TPL * MAX_SPT - 1
SMEM_PER_BLOCK = 232448   # bytes of shared memory an H100 block may use
RING_LANES = 32           # csrc/fused_ip_ring.cu: lanes a block
RING_THREADS_PER_LANE = 4     # its T_IP


def quad_floats(nx: int = NX) -> int:
    """Floats a stage of the stored quadratics (``QUAD_LD``): Q's upper
    triangle, R, M, qx, qu, padded odd; 37 for KS, 55 for ST."""
    return (nx * (nx + 1) // 2 + NU * NU + nx * NU + nx + NU) | 1


def ab_floats(nx: int = NX) -> int:
    """Floats of a stage's (A, B) in the ring kernel (``Ring::NAB``): the
    rows of A and B other than those of delta and v, and B20, B31."""
    return (nx - 2) * (nx + NU) + 2


def ring_part_floats(boundary: bool, nx: int = NX) -> int:
    """Floats a lane of the ring kernel's ring part (``ring_part_floats``):
    the ring of stage operands, or each thread's slacks and duals of a
    stage (4 a row) where those are more (KS with the boundary rows)."""
    T = RING_THREADS_PER_LANE
    rows = F.NR + F.NB_ROWS if boundary else F.NR
    return max(F.ring_slots(T) * F.ring_operand_floats(nx), T * 4 * rows)


def lane_smem_bytes(H: int, boundary: bool = False, nx: int = NX) -> int:
    """Shared memory of one lane at horizon H in the library of the model
    of state count nx, with or without the boundary rows.  The ring source
    (ST, or KS with the boundary rows): ``ring_lane_floats`` in
    csrc/fused_ip_ring.cu (the threads' partials, the ladder's slot, a
    value a stage, the ring part, the sweep's P and p).  KS without them:
    ``Layout`` in csrc/fused_ip.cu (rows cache, 45 floats a stage,
    quadratics (whose space a rollout's scratch shares), (A, B), K, d,
    ddX, ddU, X, U, xref, obstacles, the terminal P and p, the
    stationarity, the lane's constants: weights, x0 and the clearance)."""
    if nx == NX_ST or boundary:
        T = RING_THREADS_PER_LANE
        return 4 * (T + 1 + (H + 1) + ring_part_floats(boundary, nx)
                    + F.sweep_floats(nx))
    S = H + 1
    floats = (45 * S + quad_floats(nx) * S + (nx * nx + nx * NU) * H
              + NU * nx * H + NU * H + nx * S + NU * S + nx * S + NU * S
              + nx * S + 7 * S + nx * nx + nx + 1 + (3 * nx + 3))
    return 4 * floats


def _ring_max_horizon(nx: int = NX_ST, boundary: bool = True) -> int:
    """The longest horizon whose block of ``RING_LANES`` lanes fits a
    block's shared memory in the ring kernel (a lane's footprint grows by
    4 bytes a stage)."""
    spare = (SMEM_PER_BLOCK // RING_LANES
             - lane_smem_bytes(0, boundary, nx=nx))
    return spare // 4


MAX_HORIZON_ST = _ring_max_horizon()
MAX_HORIZON_KS_RING = _ring_max_horizon(NX)


def ineligible_reason_ip(cfg: S.SolverConfig, params: S.OcpParams):
    """Why the problem is outside the IP kernel's envelope, or None."""
    if cfg.method != "ip":
        return (f"method '{cfg.method}': this is the IP kernel; the AL "
                "solve is ops.fused_gn")
    if cfg.boundary_rows and (params.boundaries is None
                              or params.boundary_signs is None):
        return ("boundary_rows without boundary data (params.boundaries "
                "and boundary_signs)")
    if params.obs_centers.dim() not in (3, 4):
        return (f"obs_centers of shape {tuple(params.obs_centers.shape)}: "
                "want (B, 3, 2) or (B, H+1, 3, 2)")
    nx = S.solver_nx(cfg)
    if params.x_ref.shape[-1] not in (NX, nx):
        return (f"x_ref has {params.x_ref.shape[-1]} state columns, want "
                f"{NX} or {nx}")
    if len(cfg.ip_alphas) > MAX_ALPHAS:
        return (f"{len(cfg.ip_alphas)} ladder rungs, the kernel takes "
                f"{MAX_ALPHAS}")
    H = cfg.horizon
    if ring_kernel(cfg):   # a thread loops over its stages
        lane = lane_smem_bytes(H, cfg.boundary_rows, nx)
        if RING_LANES * lane > SMEM_PER_BLOCK:
            return (f"horizon {H}: a block of {RING_LANES} lanes of the "
                    f"{cfg.model.upper()} model needs {RING_LANES * lane} "
                    f"bytes of shared memory ({lane} a lane), a block holds "
                    f"{SMEM_PER_BLOCK}: H <= "
                    f"{_ring_max_horizon(nx, cfg.boundary_rows)}")
        return None
    if H > MAX_HORIZON:
        return (f"horizon {H}: the kernel's warp holds at most "
                f"{TPL * MAX_SPT} stages a lane ({MAX_SPT} a thread), "
                f"H <= {MAX_HORIZON}")
    lane = lane_smem_bytes(H, cfg.boundary_rows, nx)
    if lane > SMEM_PER_BLOCK:
        return (f"horizon {H}: a lane of the {cfg.model.upper()} model "
                f"needs {lane} bytes of shared memory, a block holds "
                f"{SMEM_PER_BLOCK}")
    return None


def eligible_ip(cfg: S.SolverConfig, params: S.OcpParams) -> bool:
    return ineligible_reason_ip(cfg, params) is None


def _n_finite(bounds) -> int:
    """Bounded sides of a stage's rows (the barrier's complementarity
    count)."""
    return sum((lo is not None) + (hi is not None) for lo, hi in bounds)


def n_active(cfg: S.SolverConfig) -> float:
    """Bounded sides over the horizon: H stages and the terminal one."""
    c = make_consts(cfg)
    return float(cfg.horizon * _n_finite(_row_bounds(c, 0.0, False))
                 + _n_finite(_row_bounds(c, 0.0, True)))


def _fr_scale(consts) -> float:
    return (consts["a_max"] ** 2 if consts["formulation"] == "forcespro"
            else consts["a_max"])


# ---------------------------------------------------------------------------
# the plain version: one group of stages at a time (stages 0..H-1 as (B, H)
# registers, the terminal stage as (B,) registers)
# ---------------------------------------------------------------------------


def _split(t, H, n):
    """(B, H+1, n) -> (n registers (B, H), n registers (B,))."""
    return _cols(t[:, :H], n), _cols(t[:, H], n)


def _join(stage, term):
    """Inverse of :func:`_split`."""
    return torch.cat([torch.stack(stage, -1),
                      torch.stack(term, -1).unsqueeze(1)], 1)


def _side_init(margin, z0, warm):
    """Slack and dual of one bounded side (``ipqp.init_ip``): a violated
    row (margin <= 0) starts at slack 1, a feasible one at max(margin,
    S_MIN); the dual at mu0 / s, or at the warm dual clipped to a band
    around it."""
    s = torch.where(margin <= 0, 1.0, torch.clamp(margin, min=_S_MIN))
    zc = _MU0 / s
    if not warm:
        return s, zc
    z = torch.where(z0 > 0, z0, zc)
    return s, torch.minimum(torch.maximum(z, zc / _WARM_KAPPA),
                            zc * _WARM_KAPPA)


def _init_group(r, bounds, z_lo, z_hi, warm):
    """(s_lo, s_hi, z_lo, z_hi) of one group at the rows ``r``; a missing
    side has s = 1, z = 0."""
    hs = _row_values(r)
    one, zero = torch.ones_like(hs[0]), torch.zeros_like(hs[0])
    out = ([], [], [], [])
    for i, (lo, hi) in enumerate(bounds):
        sl, zl = (_side_init(hs[i] - lo, z_lo[i], warm) if lo is not None
                  else (one, zero))
        sh, zh = (_side_init(hi - hs[i], z_hi[i], warm) if hi is not None
                  else (one, zero))
        for lst, v in zip(out, (sl, sh, zl, zh)):
            lst.append(v)
    return out


def _ip_terms(bounds, cs, sz, mu_b):
    """Per row (psi unused, w, sigma) for ``_assemble_quad``: the barrier
    weight w = mu / s + sigma * rs per side and sigma = z / s, the current
    z cancelling against the dz elimination's -z (``ipqp.ip_iteration``)."""
    s_lo, s_hi, z_lo, z_hi = sz
    zero = torch.zeros_like(cs[0])
    terms = []
    for i, (lo, hi) in enumerate(bounds):
        w, sig = zero, zero
        if hi is not None:
            rs = s_hi[i] - (hi - cs[i])
            sg = z_hi[i] / s_hi[i]
            w = w + mu_b / s_hi[i] + sg * rs
            sig = sig + sg
        if lo is not None:
            rs = s_lo[i] - (cs[i] - lo)
            sg = z_lo[i] / s_lo[i]
            w = w - mu_b / s_lo[i] - sg * rs
            sig = sig + sg
        terms.append((None, w, sig))
    return terms


def _ftb(v, dv, amin):
    """Fraction-to-boundary: min(amin, -v / dv) where dv < 0."""
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0), _BIG)
    return torch.minimum(amin, ratio)


def _dual_steps(bounds, cs, Jd, sz, mu_b, amin):
    """Slack and dual steps (ds_lo, ds_hi, dz_lo, dz_hi) of one group and
    its fraction-to-boundary ratios folded into ``amin``."""
    s_lo, s_hi, z_lo, z_hi = sz
    zero = torch.zeros_like(cs[0])
    out = ([], [], [], [])
    for i, (lo, hi) in enumerate(bounds):
        dsl = dzl = dsh = dzh = zero
        if lo is not None:
            rs = s_lo[i] - (cs[i] - lo)
            sg = z_lo[i] / s_lo[i]
            dsl = Jd[i] - rs
            dzl = mu_b / s_lo[i] - z_lo[i] - sg * dsl
            amin = _ftb(s_lo[i], dsl, amin)
            amin = _ftb(z_lo[i], dzl, amin)
        if hi is not None:
            rs = s_hi[i] - (hi - cs[i])
            sg = z_hi[i] / s_hi[i]
            dsh = -Jd[i] - rs
            dzh = mu_b / s_hi[i] - z_hi[i] - sg * dsh
            amin = _ftb(s_hi[i], dsh, amin)
            amin = _ftb(z_hi[i], dzh, amin)
        for lst, v in zip(out, (dsl, dsh, dzl, dzh)):
            lst.append(v)
    return out, amin


def _apply_group(bounds, sz, steps, alpha, gap):
    """The step on slacks (floored at S_FLOOR) and duals (capped at Z_MAX),
    with the complementarity gap of the bounded sides added to ``gap``."""
    s_lo, s_hi, z_lo, z_hi = sz
    ds_lo, ds_hi, dz_lo, dz_hi = steps
    one, zero = torch.ones_like(s_lo[0]), torch.zeros_like(s_lo[0])
    out = ([], [], [], [])
    for i, (lo, hi) in enumerate(bounds):
        sl, zl, sh, zh = one, zero, one, zero
        if lo is not None:
            sl = torch.clamp(s_lo[i] + alpha * ds_lo[i], min=_S_FLOOR)
            zl = torch.clamp(z_lo[i] + alpha * dz_lo[i], max=_Z_MAX)
            gap = gap + sl * zl
        if hi is not None:
            sh = torch.clamp(s_hi[i] + alpha * ds_hi[i], min=_S_FLOOR)
            zh = torch.clamp(z_hi[i] + alpha * dz_hi[i], max=_Z_MAX)
            gap = gap + sh * zh
        for lst, v in zip(out, (sl, sh, zl, zh)):
            lst.append(v)
    return out, gap


class _IpProblem(F._Problem):
    """Per-lane data of one IP solve, with the row bounds of both stage
    groups and the (A, B) of the current linearization."""

    def __init__(self, cfg, params, bnd=None):
        super().__init__(cfg, params, bnd)
        c = self.consts
        self.bounds = (_row_bounds(c, self.mind, False),
                       _row_bounds(c, self.mind[:, 0], True))
        self.n_act = n_active(cfg)
        self.inv_fr = 1.0 / _fr_scale(c)

    def rows(self, X, U):
        return F._stage_rows(self, X, U), F._term_rows(self, X)


def _newton(cfg, pb, X, U, AB, rows, sz, dX, dU, mu_b):
    """One primal-dual Newton step of the stagewise QP at the linearization
    (X, U); returns the new (sz, dX, dU, mu_b)."""
    H = pb.H
    zero = torch.zeros_like(mu_b)
    mus = (mu_b[:, None], mu_b)
    nx = pb.nx
    dXg = _split(dX, H, nx)
    dUg = (_cols(dU, NU), [zero, zero])
    cs = [_row_lin(rows[g], dXg[g], dUg[g]) for g in (0, 1)]
    terms = [_ip_terms(pb.bounds[g], cs[g], sz[g], mus[g]) for g in (0, 1)]
    xc, uc = X + dX, U + dU
    like = xc[:, :H, 0]
    Q, R, M, qx, qu = _assemble_quad(
        rows[0], terms[0], _cols(xc[:, :H], nx), _cols(uc, NU),
        _cols(pb.xref[:, :H], nx), pb.wq, pb.wr, False)
    QH, qH = _assemble_quad(
        rows[1], terms[1], _cols(xc[:, H], nx), [zero, zero],
        _cols(pb.xref[:, H], nx), pb.wq, pb.wr, True, pb.wqN,
        cfg.use_terminal_cost)
    A, Bm = AB
    K, d = F._backward_sweep(cfg, pb, dict(
        Q=_mat(Q, like), R=_mat(R, like), M=_mat(M, like),
        qx=_vec(qx, like), qu=_vec(qu, like), A=A, Bm=Bm,
        QH=_mat(QH, zero), qH=_vec(qH, zero)))

    # linear forward pass from ddx_0 = 0 (x0 pinned)
    ddx = torch.zeros_like(X[:, 0])
    ddxs, ddus = [], []
    for k in range(H):
        ddxs.append(ddx)
        ddu = d[:, k] + _mv(K[:, k], ddx)
        ddus.append(ddu)
        ddx = _mv(A[:, k], ddx) + _mv(Bm[:, k], ddu)
    ddxs.append(ddx)
    ddX, ddU = torch.stack(ddxs, 1), torch.stack(ddus, 1)

    # slack / dual steps and the fraction-to-boundary step length
    ddXg = _split(ddX, H, nx)
    ddUg = (_cols(ddU, NU), [zero, zero])
    steps, amin = [], torch.full_like(mu_b, _BIG)
    for g in (0, 1):
        Jd = [a - b for a, b in zip(_row_lin(rows[g], ddXg[g], ddUg[g]),
                                    _row_values(rows[g]))]
        st, am = _dual_steps(pb.bounds[g], cs[g], Jd, sz[g], mus[g],
                             torch.full_like(cs[g][0], _BIG))
        steps.append(st)
        amin = torch.minimum(amin, am.amin(1) if g == 0 else am)
    alpha = torch.clamp(_TAU * amin, max=1.0)

    # apply; barrier from the complementarity gap
    dX = dX + alpha[:, None, None] * ddX
    dU = dU + alpha[:, None, None] * ddU
    sz0, gap0 = _apply_group(pb.bounds[0], sz[0], steps[0], alpha[:, None],
                             torch.zeros_like(like))
    szT, gap = _apply_group(pb.bounds[1], sz[1], steps[1], alpha,
                            gap0.sum(1))
    mu_b = torch.clamp(_SIGMA_B * gap / pb.n_act, min=_MU_MIN)
    return (sz0, szT), dX, dU, mu_b


def _row_viols(hs, bounds):
    """max(lo - h, h - hi, 0) of each row (raw)."""
    out = []
    for h, (lo, hi) in zip(hs, bounds):
        vi = torch.zeros_like(h)
        if hi is not None:
            vi = torch.maximum(vi, h - hi)
        if lo is not None:
            vi = torch.maximum(vi, lo - h)
        out.append(torch.clamp(vi, min=0.0))
    return out


def _scaled(pv, inv_fr):
    """Row violations with the friction row scaled by its bound."""
    return [pv[0] * inv_fr] + pv[1:]


def _dU_rollout(cfg, pb, U, dU, alpha, merit):
    """The RTI step: U <- clip(U + alpha dU) and its rollout (no feedback);
    with ``merit``, also objective + rho * viol of the result (1e30 when
    not finite)."""
    c = pb.consts
    Ua = U + alpha[:, None, None] * dU
    Ua = torch.stack([F._clip(Ua[..., 0], c["u_lo0"], c["u_hi0"]),
                      F._clip(Ua[..., 1], c["u_lo1"], c["u_hi1"])], -1)
    Xa = F._rollout(cfg, pb, Ua)
    if not merit:
        return Xa, Ua, None
    H, rho = pb.H, float(cfg.ip_ls_rho)
    rs, rT = pb.rows(Xa, Ua)
    v_k = sum(_scaled(_row_viols(_row_values(rs), pb.bounds[0]), pb.inv_fr))
    nx = pb.nx
    cost_k = F._stage_cost(_cols(Xa[:, :H], nx), _cols(Ua, NU),
                           _cols(pb.xref[:, :H], nx), pb.wq, pb.wr)
    acc = torch.zeros_like(alpha)
    for k in range(H):
        acc = acc + cost_k[:, k] + rho * v_k[:, k]
    if cfg.use_terminal_cost:
        acc = acc + F._term_cost(_cols(Xa[:, H], nx),
                                 _cols(pb.xref[:, H], nx), pb.wqN)
    acc = acc + rho * sum(_scaled(_row_viols(_row_values(rT), pb.bounds[1]),
                                  pb.inv_fr))
    return Xa, Ua, torch.where(torch.isfinite(acc), acc, _BIG)


def _diagnostics_ip(cfg, pb, X, U, z_lo, z_hi):
    """(per-row viol (B, H+1, NR), diag (B, 4) = stat, viol, cost, cost):
    Lagrangian stationarity by the adjoint recursion with lam = z_hi - z_lo
    and the Jacobians at the final iterate."""
    H = pb.H
    rs, rT = pb.rows(X, U)
    lam_k, lam_T = _split(z_hi - z_lo, H, pb.nr)
    nx = pb.nx
    xk, uk = _cols(X[:, :H], nx), _cols(U, NU)
    like = xk[0]
    zk = torch.zeros_like(like)
    _, _, _, qx, qu = _assemble_quad(
        rs, [(None, lm, zk) for lm in lam_k], xk, uk,
        _cols(pb.xref[:, :H], nx), pb.wq, pb.wr, False)
    zero = torch.zeros_like(X[:, 0, 0])
    _, qH = _assemble_quad(
        rT, [(None, lm, zero) for lm in lam_T], _cols(X[:, H], nx),
        [zero, zero], _cols(pb.xref[:, H], nx), pb.wq, pb.wr, True, pb.wqN,
        cfg.use_terminal_cost)
    A, Bm = pb.lin(xk, uk)
    A, Bm, qx, qu = _mat(A, like), _mat(Bm, like), _vec(qx, like), \
        _vec(qu, like)
    pv_T = _row_viols(_row_values(rT), pb.bounds[1])
    pv_k = _row_viols(_row_values(rs), pb.bounds[0])
    viol = torch.stack(_scaled(pv_T, pb.inv_fr)).amax(0)
    viol_k = torch.stack(_scaled(pv_k, pb.inv_fr)).amax(0)
    cost_k = F._stage_cost(xk, uk, _cols(pb.xref[:, :H], nx), pb.wq, pb.wr)
    cost = (F._term_cost(_cols(X[:, H], nx), _cols(pb.xref[:, H], nx),
                         pb.wqN) if cfg.use_terminal_cost else zero)
    lam, stat = _vec(qH, zero), zero
    for k in range(H - 1, -1, -1):
        g_u = qu[:, k] + _mv(Bm[:, k].transpose(-1, -2), lam)
        lam = qx[:, k] + _mv(A[:, k].transpose(-1, -2), lam)
        stat = torch.maximum(stat, torch.maximum(g_u[:, 0].abs(),
                                                 g_u[:, 1].abs()))
        viol = torch.maximum(viol, viol_k[:, k])
        cost = cost + cost_k[:, k]
    return _join(pv_k, pv_T), torch.stack([stat, viol, cost, cost], -1)


def solve_batch_fused_ip_plain(cfg: S.SolverConfig, params: S.OcpParams,
                               state: S.SqpState, rungs: list | None = None,
                               follow: torch.Tensor | None = None):
    """The kernel's function in plain PyTorch; returns (X, U, z_lo, z_hi,
    per-row viol, diag (B, 4)) like the kernel's outputs.

    With the ladder on, a list ``rungs`` receives for each SQP iteration
    (rung (B,), merits (R, B)): the rung it committed (0 for alpha = 0,
    r + 1 for ``ip_alphas[r]``, as in the kernel's rung buffer) and the
    merit of every rung.  ``follow`` (ip_sqp_iters, B) makes iteration i
    commit the rungs ``follow[i]`` instead of the best ones, which replays
    the kernel's choices.  KS-schema params of an ST problem are widened
    (``sqp.normalize_params``).
    """
    params = S.normalize_params(cfg, params)
    pb = _IpProblem(cfg, params, F.boundary_models(cfg, params, state))
    H = pb.H
    U, z_lo, z_hi = state.U, state.lam_lo, state.lam_hi
    X = F._rollout(cfg, pb, U)
    ones = torch.ones_like(X[:, 0, 0])
    for si in range(cfg.ip_sqp_iters):
        rows = pb.rows(X, U)
        zl, zh = _split(z_lo, H, pb.nr), _split(z_hi, H, pb.nr)
        sz = [_init_group(rows[g], pb.bounds[g], zl[g], zh[g],
                          cfg.ip_warm_duals) for g in (0, 1)]
        dX, dU = torch.zeros_like(X), torch.zeros_like(U)
        if cfg.ip_iters > 0:
            A, Bm = pb.lin(_cols(X[:, :H], pb.nx), _cols(U, NU))
            like = X[:, :H, 0]
            AB = (_mat(A, like), _mat(Bm, like))
        mu_b = torch.full_like(ones, _MU0)
        for _ in range(cfg.ip_iters):
            sz, dX, dU, mu_b = _newton(cfg, pb, X, U, AB, rows, sz, dX, dU,
                                       mu_b)
        z_lo = _join(sz[0][2], sz[1][2])
        z_hi = _join(sz[0][3], sz[1][3])
        dU = F._finite(dU)
        if not cfg.ip_alphas:
            # unguarded RTI (maxqps=1): the full step, no merit test
            X, U, _ = _dU_rollout(cfg, pb, U, dU, ones, False)
            continue
        best_a = torch.zeros_like(ones)
        _, _, best_m = _dU_rollout(cfg, pb, U, dU, best_a, True)
        best_r = torch.zeros_like(ones, dtype=torch.int32)
        merits = [best_m]
        for r, a_val in enumerate(cfg.ip_alphas):
            _, _, m = _dU_rollout(cfg, pb, U, dU, a_val * ones, True)
            merits.append(m)
            take = m < best_m if follow is None else follow[si] == r + 1
            best_r = torch.where(take, r + 1, best_r)
            best_m = torch.where(take, m, best_m)
            best_a = torch.where(take, a_val, best_a)
        X, U, _ = _dU_rollout(cfg, pb, U, dU, best_a, False)
        if rungs is not None:
            rungs.append((best_r, torch.stack(merits)))
    pviol, diag = _diagnostics_ip(cfg, pb, X, U, z_lo, z_hi)
    return X, U, z_lo, z_hi, pviol, diag


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


class IpArgs(ctypes.Structure):
    """Mirror of ``struct IpArgs`` in csrc/fused_ip.cu (all 4-byte)."""

    _fields_ = [(n, ctypes.c_int32) for n in (
        "B", "H", "ip_sqp_iters", "ip_iters", "n_alphas", "forcespro", "rk4",
        "moving", "use_term", "warm", "lanes_per_block")] + [
        (n, ctypes.c_float) for n in (
            "dt", "half_dt", "dt6", "inv_l", "reg", "d_ego", "a_cap",
            "inv_fr_scale", "u_lo0", "u_hi0", "u_lo1", "u_hi1", "d_lo",
            "d_hi", "v_lo", "v_hi", "rho", "n_act")] + [
        ("alphas", ctypes.c_float * MAX_ALPHAS),
        ("boundary", ctypes.c_int32), ("r_ego", ctypes.c_float),
        ("st", StConsts)]


def kernel_args_ip(cfg: S.SolverConfig, B: int, moving: bool,
                   lanes_per_block: int = 0) -> IpArgs:
    """The argument block; ``lanes_per_block`` 0 lets the kernel choose
    (the most lanes resident on an SM)."""
    c = make_consts(cfg)
    dt = float(cfg.dt)
    fr = _fr_scale(c)
    a = IpArgs(
        B=B, H=cfg.horizon, ip_sqp_iters=cfg.ip_sqp_iters,
        ip_iters=cfg.ip_iters, n_alphas=len(cfg.ip_alphas),
        forcespro=int(cfg.formulation == "forcespro"),
        rk4=int(cfg.integrator == "rk4"), moving=int(moving),
        use_term=int(cfg.use_terminal_cost), warm=int(cfg.ip_warm_duals),
        lanes_per_block=lanes_per_block, dt=dt, half_dt=0.5 * dt,
        dt6=dt / 6.0, inv_l=c["inv_l"], reg=float(cfg.reg),
        d_ego=c["d_ego"], a_cap=fr, inv_fr_scale=1.0 / fr, u_lo0=c["u_lo0"],
        u_hi0=c["u_hi0"], u_lo1=c["u_lo1"], u_hi1=c["u_hi1"],
        d_lo=c["d_lo"], d_hi=c["d_hi"], v_lo=c["v_lo"], v_hi=c["v_hi"],
        rho=float(cfg.ip_ls_rho), n_act=n_active(cfg),
        boundary=int(cfg.boundary_rows), r_ego=c["r_ego"])
    for i, v in enumerate(cfg.ip_alphas):
        a.alphas[i] = v
    if c["st"] is not None:
        a.st = StConsts(**c["st"])
    return a


# the kernel's buffers in the order of fused_ip_solve's pointer arguments.
# fused_ip.cu (KS, no boundary rows): all lanes leading (the package's
# public layout), the Newton state in the kernel's registers and shared
# memory, no scratch.  fused_ip_ring.cu (ST; KS with the boundary rows):
# all lanes fastest, then the Newton state's scratch.
KERNEL_INPUTS = F.KERNEL_INPUTS                 # x0, xref, obs, mind, w
KERNEL_STATE = ("U", "lam_lo", "lam_hi")        # updated in place
KERNEL_OUTPUTS = ("X", "pviol", "diag")
KERNEL_TRACE = ("rung",)     # optional: the rung each ladder step committed
KERNEL_BOUNDARY = F.KERNEL_BOUNDARY   # with boundary rows: (B, H+1, 18)
KERNEL_ORDER = (KERNEL_INPUTS + KERNEL_STATE + KERNEL_OUTPUTS + KERNEL_TRACE
                + KERNEL_BOUNDARY)
# the ring kernel's Newton state: slacks, the primal step, the Newton
# direction, K, d, (A, B); the ladder's trial chains (a slot a rung) only
# with the ladder on
KERNEL_SCRATCH_RING = ("s_lo", "s_hi", "dX", "dU", "ddX", "ddU", "K", "d",
                       "AB", "Xc", "Uc")
KERNEL_ORDER_RING = KERNEL_ORDER + KERNEL_SCRATCH_RING
_OUT_ORDER = ("X", "U", "lam_lo", "lam_hi", "pviol", "diag")


def ring_kernel(cfg: S.SolverConfig) -> bool:
    """Whether ``cfg`` runs on the ring kernel: the ST model, or the KS
    model with the road-boundary rows."""
    return ip_library(cfg) != "fused_ip"


def ip_library(cfg: S.SolverConfig) -> str:
    """The library that solves ``cfg``: ``fused_ip_st`` (the ST model),
    ``fused_ip_ks_ring`` (KS with the boundary rows; both build
    csrc/fused_ip_ring.cu) or ``fused_ip`` (csrc/fused_ip.cu)."""
    if cfg.model == "st":
        return "fused_ip_st"
    return "fused_ip_ks_ring" if cfg.boundary_rows else "fused_ip"


def _copied(t, shape):
    """A contiguous float32 copy of ``t``, checked against ``shape``."""
    if t.dtype != torch.float32:
        raise TypeError(f"the fused kernels take float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"shape {tuple(t.shape)}, want {shape}")
    return t.clone(memory_format=torch.contiguous_format)


def pack_ip(cfg: S.SolverConfig, params: S.OcpParams, state: S.SqpState,
            trace_rungs: bool = False) -> dict:
    """The kernel's buffers: every input copied (never a view of the
    caller's tensors, since the kernel writes U, lam_lo and lam_hi in
    place), every output allocated; the rung trace (ip_sqp_iters, B) only
    when the ladder is on and ``trace_rungs`` asks for it; with boundary
    rows their models at the rollout of the warm start
    (``fused_gn.boundary_models``); KS-schema params of an ST problem
    widened first (``sqp.normalize_params``).  fused_ip.cu: lanes leading
    and contiguous (one lane's data in consecutive addresses, which the
    lane's warp loads together); the ring kernel (:func:`ring_kernel`): its
    own layout (:func:`_pack_ring`).
    """
    reason = ineligible_reason_ip(cfg, params)
    if reason is not None:
        raise NotImplementedError(reason)
    params = S.normalize_params(cfg, params)
    if ring_kernel(cfg):
        return _pack_ring(cfg, params, state, trace_rungs)
    B, H, nr = params.x0.shape[0], cfg.horizon, S.nrows(cfg)
    nx = S.solver_nx(cfg)
    dev, f32 = params.x0.device, torch.float32
    moving = params.obs_centers.dim() == 4
    w = params.weights

    def empty(*shape):
        return torch.empty((B,) + shape, dtype=f32, device=dev)

    bufs = dict(
        x0=_copied(params.x0, (B, nx)),
        xref=_copied(params.x_ref, (B, H + 1, nx)),
        obs=_copied(params.obs_centers.reshape(B, -1, 6) if moving
                    else params.obs_centers.reshape(B, 6),
                    (B, H + 1, 6) if moving else (B, 6)),
        mind=_copied(params.min_dist.reshape(B), (B,)),
        w=_copied(torch.cat([w.q, w.r, w.qN], -1), (B, 2 * nx + NU)),
        U=_copied(state.U, (B, H, NU)),
        lam_lo=_copied(state.lam_lo, (B, H + 1, nr)),
        lam_hi=_copied(state.lam_hi, (B, H + 1, nr)),
        X=empty(H + 1, nx), pviol=empty(H + 1, nr), diag=empty(4))
    if cfg.ip_alphas and trace_rungs:
        bufs["rung"] = torch.empty((cfg.ip_sqp_iters, B), dtype=torch.int32,
                                   device=dev)
    return bufs


def _pack_ring(cfg, params, state, trace_rungs):
    """:func:`pack_ip` for the ring kernel: every buffer lanes fastest, the
    inputs and the duals copied by one ``torch.cat`` (U apart, as in
    ``fused_gn.pack``), the outputs and the Newton state's scratch
    allocated, the trial chains (a slot a rung) only with the ladder on."""
    B, H, nr = params.x0.shape[0], cfg.horizon, S.nrows(cfg)
    nx = S.solver_nx(cfg)
    dev, f32 = params.x0.device, torch.float32
    moving = params.obs_centers.dim() == 4
    w = params.weights
    parts = [
        ("x0", params.x0, (B, nx)),
        ("xref", params.x_ref, (B, H + 1, nx)),
        ("obs", params.obs_centers.reshape(B, -1, 6) if moving
         else params.obs_centers.reshape(B, 6),
         (B, H + 1, 6) if moving else (B, 6)),
        ("mind", params.min_dist.reshape(B), (B,)),
        ("w", [w.q, w.r, w.qN], (B, 2 * nx + NU)),
        ("lam_lo", state.lam_lo, (B, H + 1, nr)),
        ("lam_hi", state.lam_hi, (B, H + 1, nr))]
    if cfg.boundary_rows:
        parts.append(("bnd", F.boundary_models(cfg, params, state),
                      (B, H + 1, NBND)))
    bufs = F._lanes_fastest(parts)

    def empty(*shape):
        return torch.empty(shape + (B,), dtype=f32, device=dev)

    bufs.update(
        U=F._packed(state.U, (B, H, NU)), X=empty(H + 1, nx),
        pviol=empty(H + 1, nr), diag=empty(4), s_lo=empty(H + 1, nr),
        s_hi=empty(H + 1, nr), dX=empty(H + 1, nx), dU=empty(H, NU),
        ddX=empty(H + 1, nx), ddU=empty(H, NU), K=empty(H, NU * nx),
        d=empty(H, NU), AB=empty(H, ab_floats(nx)))
    if cfg.ip_alphas:
        rungs = 1 + len(cfg.ip_alphas)
        bufs.update(Xc=empty(rungs, H + 1, nx), Uc=empty(rungs, H, NU))
        if trace_rungs:
            bufs["rung"] = torch.empty((cfg.ip_sqp_iters, B),
                                       dtype=torch.int32, device=dev)
    return bufs


def _ring_bufs(bufs: dict) -> bool:
    """Whether ``bufs`` are the ring kernel's (lanes fastest)."""
    return "AB" in bufs


def _moving(bufs: dict) -> bool:
    """Moving obstacles: (B, H+1, 6) lanes leading, (H+1, 6, B) lanes
    fastest."""
    return bufs["obs"].dim() == 3


def _launch_ip(name: str, cfg: S.SolverConfig, bufs: dict,
               lanes_per_block: int) -> None:
    ring = _ring_bufs(bufs)
    B = bufs["x0"].shape[-1 if ring else 0]
    args = kernel_args_ip(cfg, B, _moving(bufs), lanes_per_block)
    err = F.call_kernel(name, args, bufs,
                        KERNEL_ORDER_RING if ring else KERNEL_ORDER)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def launch_ip(cfg: S.SolverConfig, bufs: dict, lanes_per_block: int = 0):
    """Launch the kernel of ``cfg`` (:func:`ip_library`) once on the current
    stream over packed ``bufs`` (the ST model: :func:`launch_ip_st`; KS
    with the boundary rows: :func:`launch_ip_ks_ring`).

    The kernel updates U, lam_lo and lam_hi in place, where the TPU kernel
    aliased inputs to outputs, and writes X, pviol and diag.
    ``lanes_per_block`` 0 lets the kernel choose.  ``launch_ip.launches``
    counts the launches of csrc/fused_ip.cu's kernel.
    """
    if cfg.model == "st":
        return launch_ip_st(cfg, bufs, lanes_per_block)
    if cfg.boundary_rows:
        return launch_ip_ks_ring(cfg, bufs, lanes_per_block)
    launch_ip.launches += 1
    return _launch_ip("fused_ip", cfg, bufs, lanes_per_block)


def launch_ip_st(cfg: S.SolverConfig, bufs: dict, lanes_per_block: int = 0):
    """:func:`launch_ip` of the ST model's kernel (csrc/fused_ip_st.cu);
    ``launch_ip_st.launches`` counts its launches."""
    if cfg.model != "st":
        raise ValueError(f"model '{cfg.model}': fused_ip_st solves 'st'")
    launch_ip_st.launches += 1
    return _launch_ip("fused_ip_st", cfg, bufs, lanes_per_block)


def launch_ip_ks_ring(cfg: S.SolverConfig, bufs: dict,
                      lanes_per_block: int = 0):
    """:func:`launch_ip` of the KS model with the boundary rows on the ring
    kernel (csrc/fused_ip_ks_ring.cu); ``launch_ip_ks_ring.launches``
    counts its launches."""
    if ip_library(cfg) != "fused_ip_ks_ring":
        raise ValueError("fused_ip_ks_ring solves the KS model with "
                         "boundary rows")
    launch_ip_ks_ring.launches += 1
    return _launch_ip("fused_ip_ks_ring", cfg, bufs, lanes_per_block)


launch_ip.launches = 0
launch_ip_st.launches = 0
launch_ip_ks_ring.launches = 0


def geometry(cfg: S.SolverConfig, B: int, moving: bool = False,
             lanes_per_block: int = 0) -> dict:
    """The launch geometry the kernel takes on the current GPU for B lanes:
    lanes per block (given, or chosen from registers and shared memory;
    the ring kernel's are 32, and it takes 0 or 32), shared bytes a lane
    and a block, blocks resident an SM, registers a thread, the most lanes
    a block's shared memory holds; the ring kernel's also its threads a
    lane."""
    from mpc_tpu_torch.ops import _build
    args = kernel_args_ip(cfg, B, moving, lanes_per_block)
    out = (ctypes.c_int32 * 6)()
    fn = _build.load(ip_library(cfg)).fused_ip_geometry
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(ctypes.byref(args), out)
    if err != 0:
        raise RuntimeError(f"fused_ip geometry failed: CUDA error {err}")
    keys = ("lanes_per_block", "smem_bytes_per_lane", "smem_bytes_per_block",
            "blocks_per_sm", "registers", "max_lanes_per_block")
    geo = dict(zip(keys, list(out)))
    if ring_kernel(cfg):
        geo["threads_per_lane"] = RING_THREADS_PER_LANE
    return geo


def unpack_ip(bufs: dict):
    """(X, U, z_lo, z_hi, per-row viol, diag) in the package's public
    lanes-leading layout: the KS kernel's buffers themselves, views of the
    ring kernel's."""
    if _ring_bufs(bufs):
        return tuple(F._aos(bufs[n]) for n in _OUT_ORDER)
    return tuple(bufs[n] for n in _OUT_ORDER)


def launch_kernel_ip(cfg: S.SolverConfig, params: S.OcpParams,
                     state: S.SqpState, lanes_per_block: int = 0):
    """Run the CUDA kernel; same outputs as
    :func:`solve_batch_fused_ip_plain`."""
    bufs = pack_ip(cfg, params, state)
    launch_ip(cfg, bufs, lanes_per_block)
    return unpack_ip(bufs)


def solve_batch_fused_ip(cfg: S.SolverConfig, params: S.OcpParams,
                         state: S.SqpState, device=None) -> S.Solution:
    """Fused batched hard-constrained solve; the contract of ``mpc_tpu``'s
    ``fused_ip.solve_batch_fused_ip``.

    Runs on ``device`` (default: the GPU, see ``resolve_device``): CUDA
    tensors go to the kernel, CPU tensors to the plain version.  A problem
    outside the kernel's envelope (:func:`ineligible_reason_ip`: the AL
    method, H > 63 on csrc/fused_ip.cu, a lane or a ring kernel's block of
    32 that does not fit a block's shared memory, more than ``MAX_ALPHAS``
    rungs) goes to the per-lane path ``sqp.solve_batch``,
    as the JAX package falls back to its vmapped solve; boundary rows
    without boundary data raise ``ValueError``, as that path's rows do.
    """
    dev = resolve_device(device)
    if ineligible_reason_ip(cfg, params) is not None:
        if cfg.boundary_rows and (params.boundaries is None
                                  or params.boundary_signs is None):
            raise ValueError(
                "boundary_rows=True needs params.boundaries + signs")
        return S.solve_batch(cfg, params, state, device=dev)
    params = F._to(S.normalize_params(cfg, params), dev)
    state = F._to(state, dev)
    if dev.type == "cuda":
        out = launch_kernel_ip(cfg, params, state)
    elif dev.type == "cpu":
        out = solve_batch_fused_ip_plain(cfg, params, state)
    else:
        raise ValueError(f"unsupported device {dev}")
    return to_solution_ip(cfg, out, state.mu)


def to_solution_ip(cfg: S.SolverConfig, out, mu) -> S.Solution:
    """The kernel's (or the plain version's) outputs as a Solution, with
    the status mapping of the JAX package (1 converged: stationarity under
    ``tol_stat_ip`` and violation under ``tol_feas``; 0 feasible; -7
    infeasible).  The duals carry over in lam_lo / lam_hi, ``mu`` passes
    through, prev_viol holds the raw per-row violation."""
    X, U, z_lo, z_hi, pviol, diag = out
    stat, viol, cost, _ = diag.unbind(-1)
    converged = (stat < cfg.tol_stat_ip) & (viol < cfg.tol_feas)
    feasible = viol < cfg.tol_infeas
    one = torch.ones_like(stat, dtype=torch.int32)
    status = torch.where(converged, one,
                         torch.where(feasible, 0 * one, -7 * one))
    new_state = S.SqpState(U=U, lam_lo=z_lo, lam_hi=z_hi, mu=mu,
                           prev_viol=pviol)
    return S.Solution(X=X, U=U, state=new_state, status=status,
                      kkt_stat=stat, viol=viol, cost=cost, merit=cost)
