"""The whole batched AL-SQP solve in one kernel launch (``mpc_tpu.ops.fused_gn``).

One launch runs, for every lane::

    initial rollout                    (rows cached en route)
    for al_iters:                      # outer multiplier updates
        for sqp_iters:                 # Gauss-Newton iterations
            analytic stage quadratics  (closed-form row gradients)
            RK4/Euler chain-rule Jacobians
            Riccati backward sweep     (closed-form 2x2 Quu inverse)
            alphas == ():  unguarded full step, NaN/inf gains scrubbed
            else:          merit ladder, best trial chain committed
        multiplier / penalty update    (rows cached for the diagnostics)
    diagnostics                        (KKT stationarity via the adjoint
                                        recursion, scaled violation, cost,
                                        merit)

Two implementations of the same function:

* the CUDA C++ kernel ``csrc/fused_gn.cu`` (32 lanes and T warps a block:
  warps 1..T-1 produce each stage's operands into a ring in shared memory,
  warp 0 runs the stage-to-stage chains for 32 lanes at once), launched by
  :func:`launch_kernel` on CUDA tensors;
* :func:`solve_batch_fused_plain`, the plain PyTorch version: the same
  analytic rows, quadratics, sweep, step branches, multiplier update and
  adjoint diagnostics over a leading lane axis, with the stage-independent
  work evaluated for all stages at once.  The CPU runs it, and the kernel is
  checked against it on the GPU.

:func:`solve_batch_fused` takes a CPU tensor to the plain version and a CUDA
tensor to the kernel; nothing falls back from one to the other.

Envelope (:func:`eligible`): the KS or the ST model, method 'al',
forcespro or casadi rows, RK4 or Euler, static (B, 3, 2) or moving (B, H+1,
3, 2) obstacles, with or without the 6 road-boundary rows (given the
boundaries), any iteration budget, ``alphas=()`` or a ladder of at most
``MAX_ALPHAS`` rungs, a horizon whose block of 32 lanes fits a block's
shared memory (``MAX_HORIZON``, ``MAX_HORIZON_ST``).  Other AL problems go
to ``sqp_vec.solve_batch_vec``, as in the JAX package.

The ST model (7 states, tire dynamics) has a library of its own,
``csrc/fused_gn_st.cu``: the same source with the model's policy type, whose
(A, B) come from forward-mode dual numbers through the RK4 / Euler step
(``csrc/st_model.cuh``; here :class:`_Dual`, :func:`_st_lin_step`).

Road-boundary rows: as in the JAX package, each signed-distance row of an
ego circle to a boundary polyline is replaced by its first-order model at
the nearest segment of the warm start's rollout
(:func:`linearize_boundaries`, on the host side of the launch, before
every solve); the kernel reads the (H+1, 18) models of a lane and builds
the 6 rows a stage from them.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from mpc_tpu_torch.device import resolve_device
from mpc_tpu_torch.models import constraints as C
from mpc_tpu_torch.models import dynamics
from mpc_tpu_torch.ops import sqp as S

NX = 5             # KS state count
NX_ST = 7          # ST state count (adds psiDot, beta)
NU = 2
NR = 14            # 1 friction + 9 circles + 4 box rows
NB_ROWS = 6        # road-boundary rows: 3 ego circles x 2 boundaries
NBND = 18          # floats of their linear models a stage: [nx, ny, c0] x 6
MAX_ALPHAS = 16    # ladder rungs the kernel's argument block holds
LANES_PER_BLOCK = 32          # csrc/fused_gn.cu LPB: a warp's width
THREADS_PER_LANE = (2, 4, 8)  # the kernel's instances (0: it chooses)
THREADS_PER_LANE_ST = (4, 8)  # the ST library's instances
SMEM_PER_BLOCK = 232448       # bytes of shared memory an H100 block may use


NSTG = 3                      # a rollout's staging ring: stages


def ring_operand_floats(nx: int = NX) -> int:
    """Floats of one stage's operands in the kernel's ring (``NOP`` of the
    model's policy in csrc): Q's entries off the structural zeros (9 of
    the rows and weights, and Q55, Q66 of the ST weights), R00, R11, M21,
    M31, qx, qu, the rows of A and B other than those of delta and v (3 for
    KS, 5 for ST), and B20, B31: 43 for KS, 71 for ST."""
    dense = nx - 2                 # rows of A and B off the integrators
    return (nx + 4) + 2 + 2 + nx + NU + dense * nx + dense * NU + 2


def roll_floats(nx: int = NX) -> int:
    """Floats a stage of a rollout's staging ring: X, U, K, d."""
    return nx + NU + NU * nx + NU


def sweep_floats(nx: int = NX) -> int:
    """The sweep's P and p a lane, padded odd (``PSTR``): 31 or 57."""
    return (nx * nx + nx) | 1


def ring_slots(threads_per_lane: int) -> int:
    """Stages of the kernel's ring of stage operands (``ring_slots``)."""
    producers = threads_per_lane - 1
    return producers * ((6 + producers - 1) // producers)


def lane_smem_bytes(H: int, threads_per_lane: int, nx: int = NX) -> int:
    """Shared memory of one lane at horizon H for the model of state count
    nx: ``lane_floats`` in csrc/fused_gn.cu (the owners' violation
    partials, the ladder's slot, a merit and an AL term a stage, a
    rollout's staging ring, the ring of stage operands, the sweep's P and
    p)."""
    return 4 * (threads_per_lane + 1 + 2 * (H + 1) + NSTG * roll_floats(nx)
                + ring_slots(threads_per_lane) * ring_operand_floats(nx)
                + sweep_floats(nx))


def threads_per_lane_of(nx: int = NX) -> tuple:
    """The threads a lane of the model's instances (by its state count)."""
    return THREADS_PER_LANE_ST if nx == NX_ST else THREADS_PER_LANE


def _max_horizon(nx: int = NX) -> int:
    """The longest horizon whose block (32 lanes, at any threads a lane)
    fits a block's shared memory; a thread loops over its stages, so the
    stages a thread are no bound of their own."""
    H = 0
    while all(LANES_PER_BLOCK * lane_smem_bytes(H + 1, t, nx)
              <= SMEM_PER_BLOCK for t in threads_per_lane_of(nx)):
        H += 1
    return H


MAX_HORIZON = _max_horizon(NX)
MAX_HORIZON_ST = _max_horizon(NX_ST)

# the ST model's constants (struct StConsts of csrc/st_model.cuh)
ST_CONSTS = ("lr_l", "inv_l", "lr", "l", "h", "g_lr", "g_lf", "c5_lf",
             "c5_lr", "c5_r", "c5_f", "mu_l", "sr_lr", "sf_lf", "c_sr", "c_sf")


def st_consts(veh) -> dict:
    """The ST model's constants, in the order of ``struct StConsts`` of
    csrc/st_model.cuh: each product of vehicle parameters that
    ``_st_ode_d`` forms in double precision before it meets a tensor."""
    g, mu, C_Sf, C_Sr, lf, lr, l, h, m, I = dynamics.st_params(veh)
    return {
        "lr_l": lr / l, "inv_l": 1.0 / l, "lr": lr, "l": l, "h": h,
        "g_lr": g * lr, "g_lf": g * lf,
        "c5_lf": (-(mu * m) / (I * l)) * (lf * lf * C_Sf),
        "c5_lr": (-(mu * m) / (I * l)) * (lr * lr * C_Sr),
        "c5_r": ((mu * m) / (I * l)) * (lr * C_Sr),
        "c5_f": ((mu * m) / (I * l)) * (lf * C_Sf),
        "mu_l": mu / l, "sr_lr": C_Sr * lr, "sf_lf": C_Sf * lf,
        "c_sr": C_Sr, "c_sf": C_Sf}


def make_consts(cfg: S.SolverConfig) -> dict:
    """Static per-config scalars of the fused kernels."""
    r_ego, spacing = C.approx_circle_radius(cfg.ego_length, cfg.ego_width)
    return {
        "model": cfg.model,
        "nx": S.solver_nx(cfg),
        "st": st_consts(cfg.vehicle) if cfg.model == "st" else None,
        "boundary": bool(cfg.boundary_rows),
        "r_ego": r_ego,
        "formulation": cfg.formulation,
        "inv_l": 1.0 / cfg.wheelbase,
        "a_max": float(cfg.a_max),
        "d_ego": spacing / 4.0,
        "u_lo0": float(cfg.bounds.u_lo[0]), "u_hi0": float(cfg.bounds.u_hi[0]),
        "u_lo1": float(cfg.bounds.u_lo[1]), "u_hi1": float(cfg.bounds.u_hi[1]),
        "d_lo": float(cfg.bounds.x_lo[2]), "d_hi": float(cfg.bounds.x_hi[2]),
        "v_lo": float(cfg.bounds.x_lo[3]), "v_hi": float(cfg.bounds.x_hi[3]),
    }


def ineligible_reason(cfg: S.SolverConfig, params: S.OcpParams):
    """Why the problem is outside the kernel's envelope, or None."""
    if cfg.method != "al":
        return (f"method '{cfg.method}': this is the AL kernel; the IP "
                "solve is ops.fused_ip")
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
    if len(cfg.alphas) > MAX_ALPHAS:
        return f"{len(cfg.alphas)} ladder rungs, the kernel takes {MAX_ALPHAS}"
    H = cfg.horizon
    T = max(threads_per_lane_of(nx), key=lambda t: lane_smem_bytes(H, t, nx))
    lane = lane_smem_bytes(H, T, nx)
    if LANES_PER_BLOCK * lane > SMEM_PER_BLOCK:
        return (f"horizon {H}: a block of {LANES_PER_BLOCK} lanes of the "
                f"{cfg.model.upper()} model needs {LANES_PER_BLOCK * lane} "
                f"bytes of shared memory ({lane} a lane at {T} threads a "
                f"lane), a block holds {SMEM_PER_BLOCK}: H <= "
                f"{_max_horizon(nx)}")
    return None


def eligible(cfg: S.SolverConfig, params: S.OcpParams) -> bool:
    return ineligible_reason(cfg, params) is None


# ---------------------------------------------------------------------------
# road-boundary rows: per-stage linear models at the warm start
# ---------------------------------------------------------------------------

# bytes the temporaries of one call of _linearize_lanes may take: the lanes
# go through it in chunks of at most this much
LINEARIZE_BYTES = 2 ** 31
_LINEARIZE_TEMPS = 6   # (lanes, H+1, 3, NB-1, 2) temporaries alive at once


def _nearest_segment_model(p, poly, sgn):
    """(nx, ny, c0), each (B, S, 3): the model n . c + c0 of the signed
    distance sgn * d(c, poly) at the nearest segment, for the circle
    centres p (B, S, 3, 2) of each lane's polyline poly (B, NB, 2)."""
    a = poly[:, None, None, :-1]                          # (B, 1, 1, NS, 2)
    ab = poly[:, None, None, 1:] - a
    ab2 = torch.clamp((ab * ab).sum(-1), min=1e-12)
    pa = p[..., None, :] - a                              # (B, S, 3, NS, 2)
    t = torch.clamp((pa * ab).sum(-1) / ab2, 0.0, 1.0)
    proj = a + t[..., None] * ab
    diff = p[..., None, :] - proj
    d2 = (diff * diff).sum(-1)                            # (B, S, 3, NS)
    i = d2.argmin(-1, keepdim=True)         # the first least, as jnp.argmin
    proj_i = torch.gather(proj, 3, i[..., None].expand(
        i.shape + (2,)))[..., 0, :]                       # (B, S, 3, 2)
    ab_i = torch.gather(ab.expand(proj.shape), 3, i[..., None].expand(
        i.shape + (2,)))[..., 0, :]
    d_i = torch.sqrt(torch.gather(d2, 3, i)[..., 0] + 1e-12)
    off = p - proj_i
    cross = ab_i[..., 0] * off[..., 1] - ab_i[..., 1] * off[..., 0]
    s = sgn[:, None, None] * torch.sign(cross)
    n = s[..., None] * off / d_i[..., None]
    c0 = s * d_i - (n * p).sum(-1)
    return n[..., 0], n[..., 1], c0


def _linearize_lanes(cfg, X0, boundaries, boundary_signs):
    _, spacing = C.approx_circle_radius(cfg.ego_length, cfg.ego_width)
    d_ego = spacing / 4.0
    ks = torch.tensor([0.0, d_ego, -d_ego], dtype=X0.dtype, device=X0.device)
    psi = X0[..., 4:5]
    cxy = torch.stack([X0[..., 0:1] + ks * torch.cos(psi),
                       X0[..., 1:2] + ks * torch.sin(psi)], -1)
    per_edge = [torch.stack(_nearest_segment_model(
        cxy, boundaries[:, j], boundary_signs[:, j]), -1) for j in (0, 1)]
    # (B, S, 3 circles, 2 boundaries, [nx, ny, c0]) -> (B, S, 18)
    return torch.stack(per_edge, -2).reshape(X0.shape[0], X0.shape[1], NBND)


def linearize_boundaries(cfg: S.SolverConfig, X0: torch.Tensor,
                         boundaries: torch.Tensor,
                         boundary_signs: torch.Tensor) -> torch.Tensor:
    """Per-(lane, stage) linear models of the 6 boundary rows, (B, H+1, 18)
    (``mpc_tpu.ops.fused_gn.linearize_boundaries``).

    Each signed-distance row h_ij = sign_j * d(circle_i(x), poly_j) is
    replaced by its first-order model n . c + c0 at the nearest segment,
    where c is the ego circle centre on the warm-start trajectory X0 (B,
    H+1, NX): exact while the nearest segment is a straight line.  Layout a
    stage: [nx, ny, c0] x 6 rows, circle-major (row idx = 2 i + j).
    boundaries (B, 2, NB, 2), boundary_signs (B, 2).

    The nearest-segment search holds (lanes, H+1, 3, NB-1, 2) temporaries;
    the lanes go through it in chunks whose temporaries stay within
    ``LINEARIZE_BYTES``, which changes no result.
    """
    B, S = X0.shape[:2]
    per_lane = (_LINEARIZE_TEMPS * S * 3 * (boundaries.shape[2] - 1) * 2
                * X0.element_size())
    chunk = max(1, LINEARIZE_BYTES // per_lane)
    if B <= chunk:
        return _linearize_lanes(cfg, X0, boundaries, boundary_signs)
    return torch.cat([_linearize_lanes(cfg, X0[i:i + chunk],
                                       boundaries[i:i + chunk],
                                       boundary_signs[i:i + chunk])
                      for i in range(0, B, chunk)])


def boundary_models(cfg: S.SolverConfig, params: S.OcpParams,
                    state: S.SqpState):
    """The boundary rows' models of a solve, (B, H+1, 18), at the rollout of
    its warm-start inputs (None without boundary rows)."""
    if not cfg.boundary_rows:
        return None
    X0 = S._rollout(cfg, params.x0, state.U)
    return linearize_boundaries(cfg, X0, params.boundaries,
                                params.boundary_signs)


# ---------------------------------------------------------------------------
# math on per-lane "registers": tensors (B,) or (B, S) over S stages at once
# ---------------------------------------------------------------------------


def _ks_ode(x, u, inv_l):
    px, py, delta, v, psi = x
    return [v * torch.cos(psi), v * torch.sin(psi), u[0], u[1],
            v * torch.tan(delta) * inv_l]


def _add(a, s, k):
    return [a[i] + s * k[i] for i in range(NX)]


def _step_rows(x, u, dt, inv_l, integrator):
    """Discrete KS step on row-lists (RK4 / Euler)."""
    if integrator == "euler":
        return _add(x, dt, _ks_ode(x, u, inv_l))
    k1 = _ks_ode(x, u, inv_l)
    k2 = _ks_ode(_add(x, 0.5 * dt, k1), u, inv_l)
    k3 = _ks_ode(_add(x, 0.5 * dt, k2), u, inv_l)
    k4 = _ks_ode(_add(x, dt, k3), u, inv_l)
    return [x[i] + (dt / 6.0) * (k1[i] + 2.0 * k2[i] + 2.0 * k3[i] + k4[i])
            for i in range(NX)]


def _jmul(x, M, inv_l, ncol):
    """J(x) @ M with the KS Jacobian's 6-nonzero sparsity.

    f0 <- (cos psi) d v - (v sin psi) d psi
    f1 <- (sin psi) d v + (v cos psi) d psi
    f4 <- (v (1 + tan^2 delta) / l) d delta + (tan delta / l) d v
    """
    delta, v, psi = x[2], x[3], x[4]
    t = torch.tan(delta)
    cp, sp = torch.cos(psi), torch.sin(psi)
    dvd = v * (1.0 + t * t) * inv_l
    tl = t * inv_l
    row0 = [cp * M[3][j] - (v * sp) * M[4][j] for j in range(ncol)]
    row1 = [sp * M[3][j] + (v * cp) * M[4][j] for j in range(ncol)]
    zrow = [0.0 for _ in range(ncol)]
    row4 = [dvd * M[2][j] + tl * M[3][j] for j in range(ncol)]
    return [row0, row1, zrow, zrow, row4]


def _macc(base, s, k, n, m):
    return [[base[i][j] + s * k[i][j] for j in range(m)] for i in range(n)]


def _lin_step(x, u, dt, inv_l, integrator):
    """Analytic (A, B) of the discrete step (chain rule through RK4/Euler).
    Row-lists A (5x5), Bm (5x2); structural entries are Python floats."""
    eye = [[1.0 if i == j else 0.0 for j in range(NX)] for i in range(NX)]
    fu = [[0.0] * NU for _ in range(NX)]
    fu[2][0] = 1.0
    fu[3][1] = 1.0
    if integrator == "euler":
        A = _macc(eye, dt, _jmul(x, eye, inv_l, NX), NX, NX)
        Bm = [[dt * fu[i][j] for j in range(NU)] for i in range(NX)]
        return A, Bm
    k1 = _ks_ode(x, u, inv_l)
    x2 = _add(x, 0.5 * dt, k1)
    k2 = _ks_ode(x2, u, inv_l)
    x3 = _add(x, 0.5 * dt, k2)
    k3 = _ks_ode(x3, u, inv_l)
    x4 = _add(x, dt, k3)

    dk1x = _jmul(x, eye, inv_l, NX)
    dk2x = _jmul(x2, _macc(eye, 0.5 * dt, dk1x, NX, NX), inv_l, NX)
    dk3x = _jmul(x3, _macc(eye, 0.5 * dt, dk2x, NX, NX), inv_l, NX)
    dk4x = _jmul(x4, _macc(eye, dt, dk3x, NX, NX), inv_l, NX)
    A = [[eye[i][j] + (dt / 6.0) * (dk1x[i][j] + 2.0 * dk2x[i][j]
                                    + 2.0 * dk3x[i][j] + dk4x[i][j])
          for j in range(NX)] for i in range(NX)]

    zero_u = [[0.0] * NU for _ in range(NX)]
    dk1u = fu
    dk2u = _macc(_jmul(x2, _macc(zero_u, 0.5 * dt, dk1u, NX, NU), inv_l, NU),
                 1.0, fu, NX, NU)
    dk3u = _macc(_jmul(x3, _macc(zero_u, 0.5 * dt, dk2u, NX, NU), inv_l, NU),
                 1.0, fu, NX, NU)
    dk4u = _macc(_jmul(x4, _macc(zero_u, dt, dk3u, NX, NU), inv_l, NU),
                 1.0, fu, NX, NU)
    Bm = [[(dt / 6.0) * (dk1u[i][j] + 2.0 * dk2u[i][j] + 2.0 * dk3u[i][j]
                         + dk4u[i][j]) for j in range(NU)]
          for i in range(NX)]
    return A, Bm


# ---------------------------------------------------------------------------
# the ST model: forward-mode dual numbers (``mpc_tpu.ops.fused_gn``'s _Dual)
# ---------------------------------------------------------------------------
#
# Each scalar is a value and its tangents along the nx + nu seed directions;
# the ODE is written once, so that values alone give the rollouts and duals
# give the exact (A, B) of the RK4 / Euler step.  The formulas, the order
# of their operations and the constants (products of vehicle parameters
# formed in double precision) are those of the kernels' helpers,
# csrc/st_model.cuh.  The low-speed slip rate is that of the JAX kernels:
# 1 + (tan(delta) lr / l)^2, where ``models.dynamics.st_ode`` has
# 1 + (tan(delta)^2 lr / l)^2.


class _Dual:
    """A value (a tensor or a float) and its tangents: a tensor (..., ns)
    of the seed directions, or None for values only.  A float operand is a
    constant (no tangent); a quotient's value is a * (1 / b), as in the
    kernels."""

    __slots__ = ("v", "t")

    def __init__(self, v, t=None):
        self.v = v
        self.t = t

    @staticmethod
    def _of(o):
        return o if isinstance(o, _Dual) else _Dual(o)

    @staticmethod
    def _scaled(t, scale):
        """Tangents scaled by a value (a tensor or a float)."""
        return t * (scale[..., None] if torch.is_tensor(scale) else scale)

    def __add__(self, o):
        o = _Dual._of(o)
        t = (self.t if o.t is None else o.t if self.t is None
             else self.t + o.t)
        return _Dual(self.v + o.v, t)

    __radd__ = __add__

    def __sub__(self, o):
        return self + (-_Dual._of(o))

    def __rsub__(self, o):
        return _Dual._of(o) + (-self)

    def __neg__(self):
        return _Dual(-self.v, None if self.t is None else -self.t)

    def __mul__(self, o):
        o = _Dual._of(o)
        if self.t is None and o.t is None:
            t = None
        elif o.t is None:
            t = _Dual._scaled(self.t, o.v)
        elif self.t is None:
            t = _Dual._scaled(o.t, self.v)
        else:
            t = _Dual._scaled(self.t, o.v) + _Dual._scaled(o.t, self.v)
        return _Dual(self.v * o.v, t)

    __rmul__ = __mul__

    def __truediv__(self, o):
        o = _Dual._of(o)
        inv = 1.0 / o.v
        q = self.v * inv
        if self.t is None and o.t is None:
            return _Dual(q)
        a = self.t if self.t is not None else 0.0
        b = _Dual._scaled(o.t, q) if o.t is not None else 0.0
        return _Dual(q, _Dual._scaled(a - b, inv))

    def __rtruediv__(self, o):
        return _Dual._of(o) / self


def _dchain(val, dval, x: _Dual) -> _Dual:
    return _Dual(val, None if x.t is None else _Dual._scaled(x.t, dval))


def _dcos(x):
    return _dchain(torch.cos(x.v), -torch.sin(x.v), x)


def _dsin(x):
    return _dchain(torch.sin(x.v), torch.cos(x.v), x)


def _dtan(x):
    t = torch.tan(x.v)
    return _dchain(t, 1.0 + t * t, x)


def _dsqrt(x):
    r = torch.sqrt(x.v)
    return _dchain(r, 0.5 / r, x)


def _dwhere(cond, a: _Dual, b: _Dual) -> _Dual:
    """Value and tangents of a where ``cond``, else of b (both branches
    are evaluated)."""
    t = None
    if a.t is not None or b.t is not None:
        ta = a.t if a.t is not None else torch.zeros_like(b.t)
        tb = b.t if b.t is not None else torch.zeros_like(a.t)
        t = torch.where(cond[..., None], ta, tb)
    return _Dual(torch.where(cond, a.v, b.v), t)


def _dguard(x: _Dual, lo: float) -> _Dual:
    """|v| floored at lo (``st_ode``'s v_safe): a value-only clamp, the
    tangents kept."""
    return _Dual(torch.where(torch.abs(x.v) < lo, lo, x.v), x.t)


def _st_ode_d(x, u, c):
    """The 7-state ST ODE on duals; x 7 duals [px, py, delta, v, psi,
    psiDot, beta], u 2 duals, c the model's constants (:func:`st_consts`).
    Both branches are evaluated and blended on |v| < 0.1."""
    delta, v, psi, psi_dot, beta = x[2], x[3], x[4], x[5], x[6]
    u0, u1 = u[0], u[1]

    td = _dtan(delta)
    # low-speed kinematic branch: beta_kin = arctan(tan(delta) lr / l) only
    # through cos(arctan t) = 1 / sqrt(1 + t^2), sin(arctan t) = t cos
    tb0 = td * c["lr_l"]
    inv_hyp = 1.0 / _dsqrt(tb0 * tb0 + 1.0)
    cbk = inv_hyp
    sbk = tb0 * inv_hyp
    cpsi = _dcos(psi)
    spsi = _dsin(psi)
    f0_lo = v * (cbk * cpsi - sbk * spsi)
    f1_lo = v * (sbk * cpsi + cbk * spsi)
    f4_lo = v * cbk * td * c["inv_l"]
    cd = _dcos(delta)
    cd2 = cd * cd
    tb = td * c["lr_l"]
    d_beta = (u0 * c["lr"]) / ((cd2 * (1.0 + tb * tb)) * c["l"])
    cb = _dcos(beta)
    sb = _dsin(beta)
    dd_psi = (u1 * cb * td - v * sb * d_beta * td
              + v * cb * u0 / cd2) * c["inv_l"]

    # high-speed tire branch
    v_safe = _dguard(v, 1e-3)
    f0_hi = v * _dcos(beta + psi)
    f1_hi = v * _dsin(beta + psi)
    glr_uh = c["g_lr"] - u1 * c["h"]
    glf_uh = c["g_lf"] + u1 * c["h"]
    f5_hi = (c["c5_lf"] * glr_uh / v_safe * psi_dot
             + c["c5_lr"] * glf_uh / v_safe * psi_dot
             + c["c5_r"] * glf_uh * beta
             - c["c5_f"] * glr_uh * beta
             + c["c5_f"] * glr_uh * delta)
    f6_hi = ((c["mu_l"] * (c["sr_lr"] * glf_uh - c["sf_lf"] * glr_uh)
              / (v_safe * v_safe) - 1.0) * psi_dot
             - c["mu_l"] * (c["c_sr"] * glf_uh + c["c_sf"] * glr_uh)
             / v_safe * beta
             + c["mu_l"] * (c["c_sf"] * glr_uh) / v_safe * delta)

    low = torch.abs(v.v) < 0.1
    return [_dwhere(low, f0_lo, f0_hi), _dwhere(low, f1_lo, f1_hi), u0, u1,
            _dwhere(low, f4_lo, psi_dot), _dwhere(low, dd_psi, f5_hi),
            _dwhere(low, d_beta, f6_hi)]


def _st_step_d(x, u, dt, c, integrator):
    """The discrete ST step (RK4 / Euler) on duals."""
    nx = len(x)

    def add(a, s, k):
        return [a[i] + s * k[i] for i in range(nx)]

    k1 = _st_ode_d(x, u, c)
    if integrator == "euler":
        return add(x, dt, k1)
    k2 = _st_ode_d(add(x, 0.5 * dt, k1), u, c)
    k3 = _st_ode_d(add(x, 0.5 * dt, k2), u, c)
    k4 = _st_ode_d(add(x, dt, k3), u, c)
    return [x[i] + (dt / 6.0) * (k1[i] + 2.0 * k2[i] + 2.0 * k3[i] + k4[i])
            for i in range(nx)]


def _st_step_rows(x, u, dt, c, integrator):
    """The discrete ST step on row-lists, values only."""
    out = _st_step_d([_Dual(xi) for xi in x], [_Dual(ui) for ui in u], dt,
                     c, integrator)
    return [o.v for o in out]


def _st_lin_step(x, u, dt, c, integrator):
    """Exact (A, B) of the discrete ST step by the dual-number RK4 / Euler
    (``jacfwd`` of ``models.dynamics.make_step_fn(..., 'st')`` up to the
    slip-rate formula above); row-lists A (7x7), Bm (7x2)."""
    nx = len(x)
    eye = torch.eye(nx + NU, dtype=x[0].dtype, device=x[0].device)

    def seeded(v, i):
        return _Dual(v, eye[i].expand(v.shape + (nx + NU,)))

    out = _st_step_d([seeded(x[i], i) for i in range(nx)],
                     [seeded(u[i], nx + i) for i in range(NU)], dt, c,
                     integrator)
    A = [[out[i].t[..., j] for j in range(nx)] for i in range(nx)]
    Bm = [[out[i].t[..., nx + j] for j in range(NU)] for i in range(nx)]
    return A, Bm


class _Rows:
    """Per-stage rows with their sparse gradients.

    friction: h_f, gf = (g_delta, g_v, g_a)
    circles:  9 x (d, ux, uy, g_psi)   [grad wrt px, py, psi]
    boxes:    [u0, u1, delta, v] identity rows
    boundary: 6 x (hb, nx, ny, g_psi) or none
    """

    __slots__ = ("h_f", "gf", "circ", "box", "bnd")


def _compute_rows(x, u_eff, obs, consts, is_term, k_is0, bnd=None):
    """Rows at (x, u_eff); obs is 6 registers [o_xy x 3]; k_is0 is a bool
    tensor (the casadi friction row binds stage 0 only); bnd is 18
    registers [nx, ny, c0] x 6 of the boundary rows' models when
    ``consts['boundary']``: the value nx cx + ny cy + c0 on the ego circle
    centre (cx, cy), with the circle rows' (px, py, psi) gradient."""
    px, py, delta, v, psi = x[:5]
    a = u_eff[1]
    inv_l = consts["inv_l"]
    r = _Rows()
    t = torch.tan(delta)
    if consts["formulation"] == "forcespro":
        w = v * v * t * inv_l            # v * psidot
        r.h_f = a * a + w * w
        g_delta = 2.0 * w * v * v * (1.0 + t * t) * inv_l
        g_v = 4.0 * w * v * t * inv_l
        g_a = 2.0 * a
    else:  # casadi: |a^2 + v^2 tan(delta)/l|, stage 0 only
        s_val = a * a + v * v * t * inv_l
        sgn = torch.sign(s_val)
        zero = torch.zeros((), dtype=s_val.dtype, device=s_val.device)
        r.h_f = torch.where(k_is0, torch.abs(s_val), zero)
        g_delta = torch.where(k_is0, sgn * v * v * (1.0 + t * t) * inv_l, zero)
        g_v = torch.where(k_is0, sgn * 2.0 * v * t * inv_l, zero)
        g_a = torch.where(k_is0, sgn * 2.0 * a, zero)
    if is_term:
        g_a = torch.zeros_like(g_a)  # terminal u columns are dropped
    r.gf = (g_delta, g_v, g_a)

    cp, sp = torch.cos(psi), torch.sin(psi)
    d_ego = consts["d_ego"]
    ks = (0.0, d_ego, -d_ego)
    if consts["formulation"] == "forcespro":
        pairs = [(i, j) for i in range(3) for j in range(3)]  # all 9
    else:
        pairs = [(i, i) for i in range(3) for _ in range(3)]  # matched x3
    circ = []
    for (i, j) in pairs:
        dx = px + ks[i] * cp - obs[2 * j]
        dy = py + ks[i] * sp - obs[2 * j + 1]
        dist = torch.sqrt(dx * dx + dy * dy + 1e-9)
        inv_d = 1.0 / dist
        ux = dx * inv_d
        uy = dy * inv_d
        g_psi = (ks[i] * (-ux * sp + uy * cp) if ks[i] != 0.0
                 else torch.zeros_like(ux))
        circ.append((dist, ux, uy, g_psi))
    r.circ = circ
    r.box = (u_eff[0], u_eff[1], delta, v)
    r.bnd = []
    if consts["boundary"]:
        for idx, ki in enumerate(k for k in ks for _ in range(2)):
            nx_, ny_, c0 = bnd[3 * idx], bnd[3 * idx + 1], bnd[3 * idx + 2]
            cx = px + ki * cp
            cy = py + ki * sp
            hb = nx_ * cx + ny_ * cy + c0
            gpsi = (ki * (-nx_ * sp + ny_ * cp) if ki != 0.0
                    else torch.zeros_like(hb))
            r.bnd.append((hb, nx_, ny_, gpsi))
    return r


def _row_values(r):
    return ([r.h_f] + [c[0] for c in r.circ] + list(r.box)
            + [b[0] for b in r.bnd])


def _row_lin(r, dX, dU):
    """Linearized row values h_i + J_i . (dX, dU) from the sparse gradients
    (dU is zero at the terminal stage, whose g_a is already zero)."""
    gd, gv, ga = r.gf
    cs = [r.h_f + gd * dX[2] + gv * dX[3] + ga * dU[1]]
    for (dist, ux, uy, gp) in r.circ:
        cs.append(dist + ux * dX[0] + uy * dX[1] + gp * dX[4])
    cs.append(r.box[0] + dU[0])
    cs.append(r.box[1] + dU[1])
    cs.append(r.box[2] + dX[2])
    cs.append(r.box[3] + dX[3])
    for (hb, nx_, ny_, gp) in r.bnd:
        cs.append(hb + nx_ * dX[0] + ny_ * dX[1] + gp * dX[4])
    return cs


def _row_bounds(consts, mind, is_term):
    """(lo, hi) per row; None = unbounded.  mind is per lane."""
    a_cap = (consts["a_max"] ** 2 if consts["formulation"] == "forcespro"
             else consts["a_max"])
    bounds = [(0.0, a_cap)] + [(mind, None)] * 9
    if is_term:
        bounds += [(None, None), (None, None)]
    else:
        bounds += [(consts["u_lo0"], consts["u_hi0"]),
                   (consts["u_lo1"], consts["u_hi1"])]
    bounds += [(consts["d_lo"], consts["d_hi"]),
               (consts["v_lo"], consts["v_hi"])]
    if consts["boundary"]:
        bounds += [(consts["r_ego"], None)] * NB_ROWS
    return bounds


def _al_one_sided(h, bound, lam, mu, is_hi):
    """AL terms of one side: (psi, d psi / d h, GN diagonal)."""
    c = (h - bound) if is_hi else (bound - h)
    t = lam + mu * c
    act = t > 0
    m = torch.where(act, t, 0.0)
    psi = (m * m - lam * lam) / (2.0 * mu)
    return psi, (m if is_hi else -m), torch.where(act, mu, 0.0)


def _row_terms(r, bounds, lam_lo, lam_hi, mu):
    """Per row: (psi, gh, gn) summed over the row's bounded sides."""
    out = []
    for i, (h, (lo, hi)) in enumerate(zip(_row_values(r), bounds)):
        psi, gh, gn = 0.0, 0.0, 0.0
        for bound, is_hi, lam in ((hi, True, lam_hi), (lo, False, lam_lo)):
            if bound is not None:
                p, g, n = _al_one_sided(h, bound, lam[i], mu[i], is_hi)
                psi, gh, gn = psi + p, gh + g, gn + n
        out.append((psi, gh, gn))
    return out


def _stage_psi(terms):
    psi = terms[0][0]
    for t in terms[1:]:
        psi = psi + t[0]
    return psi


def _stage_cost(x, u, xref, wq, wr):
    c = wq[0] * (x[0] - xref[0]) * (x[0] - xref[0])
    for i in range(1, len(x)):
        c = c + wq[i] * (x[i] - xref[i]) * (x[i] - xref[i])
    for i in range(NU):
        c = c + wr[i] * u[i] * u[i]
    return c


def _term_cost(x, xref, wqN):
    c = wqN[0] * (x[0] - xref[0]) * (x[0] - xref[0])
    for i in range(1, len(x)):
        c = c + wqN[i] * (x[i] - xref[i]) * (x[i] - xref[i])
    return c


def _assemble_quad(r, terms, x, u_eff, xref, wq, wr, is_term, wqN=None,
                   use_terminal=True):
    """Quadratic of cost + rows at one stage (sparse analytic form).

    ``terms`` gives each row as (psi, gh, gn): its gradient weight gh and
    its curvature gn (the AL terms' d psi / d h and GN diagonal, or the IP's
    barrier weight and z / s; psi is not read).

    Returns row-lists (Q nx x nx, R 2x2, M nx x 2, qx nx, qu 2), or (QH,
    qH) when is_term; the rows touch the first five states only.
    """
    nx = len(x)
    z = torch.zeros_like(x[0])
    Q = [[z for _ in range(nx)] for _ in range(nx)]
    qx = [z for _ in range(nx)]
    R = [[z for _ in range(NU)] for _ in range(NU)]
    M = [[z for _ in range(NU)] for _ in range(nx)]
    qu = [z for _ in range(NU)]

    _, gh, gn = terms[0]                       # friction -> (delta, v, a)
    gd, gv, ga = r.gf
    Q[2][2] = Q[2][2] + gn * gd * gd
    Q[2][3] = Q[2][3] + gn * gd * gv
    Q[3][3] = Q[3][3] + gn * gv * gv
    qx[2] = qx[2] + gh * gd
    qx[3] = qx[3] + gh * gv
    if not is_term:
        R[1][1] = R[1][1] + gn * ga * ga
        M[2][1] = M[2][1] + gn * gd * ga
        M[3][1] = M[3][1] + gn * gv * ga
        qu[1] = qu[1] + gh * ga

    for idx, (_, ux, uy, gp) in enumerate(r.circ):  # -> (px, py, psi)
        _, gh, gn = terms[1 + idx]
        Q[0][0] = Q[0][0] + gn * ux * ux
        Q[0][1] = Q[0][1] + gn * ux * uy
        Q[1][1] = Q[1][1] + gn * uy * uy
        Q[0][4] = Q[0][4] + gn * ux * gp
        Q[1][4] = Q[1][4] + gn * uy * gp
        Q[4][4] = Q[4][4] + gn * gp * gp
        qx[0] = qx[0] + gh * ux
        qx[1] = qx[1] + gh * uy
        qx[4] = qx[4] + gh * gp

    if not is_term:                            # box rows u0, u1
        R[0][0] = R[0][0] + terms[10][2]
        qu[0] = qu[0] + terms[10][1]
        R[1][1] = R[1][1] + terms[11][2]
        qu[1] = qu[1] + terms[11][1]
    Q[2][2] = Q[2][2] + terms[12][2]           # box rows delta, v
    qx[2] = qx[2] + terms[12][1]
    Q[3][3] = Q[3][3] + terms[13][2]
    qx[3] = qx[3] + terms[13][1]

    for idx, (_, nx_, ny_, gp) in enumerate(r.bnd):  # -> (px, py, psi)
        _, gh, gn = terms[NR + idx]
        Q[0][0] = Q[0][0] + gn * nx_ * nx_
        Q[0][1] = Q[0][1] + gn * nx_ * ny_
        Q[1][1] = Q[1][1] + gn * ny_ * ny_
        Q[0][4] = Q[0][4] + gn * nx_ * gp
        Q[1][4] = Q[1][4] + gn * ny_ * gp
        Q[4][4] = Q[4][4] + gn * gp * gp
        qx[0] = qx[0] + gh * nx_
        qx[1] = qx[1] + gh * ny_
        qx[4] = qx[4] + gh * gp

    if is_term:
        if use_terminal:
            for i in range(nx):
                Q[i][i] = Q[i][i] + 2.0 * wqN[i]
                qx[i] = qx[i] + 2.0 * wqN[i] * (x[i] - xref[i])
    else:
        for i in range(nx):
            Q[i][i] = Q[i][i] + 2.0 * wq[i]
            qx[i] = qx[i] + 2.0 * wq[i] * (x[i] - xref[i])
        for i in range(NU):
            R[i][i] = R[i][i] + 2.0 * wr[i]
            qu[i] = qu[i] + 2.0 * wr[i] * u_eff[i]

    Q[1][0] = Q[0][1]
    Q[3][2] = Q[2][3]
    Q[4][0] = Q[0][4]
    Q[4][1] = Q[1][4]
    if is_term:
        return Q, qx
    return Q, R, M, qx, qu


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _cols(t, n):
    """Last axis of ``t`` as a row-list of n registers."""
    return [t[..., i] for i in range(n)]


def _mat(rows, like):
    """Row-list matrix (registers or Python floats) -> tensor (..., n, m)."""
    return torch.stack([torch.stack([e if torch.is_tensor(e)
                                     else torch.full_like(like, e)
                                     for e in row], -1) for row in rows], -2)


def _vec(entries, like):
    return torch.stack([e if torch.is_tensor(e) else torch.full_like(like, e)
                        for e in entries], -1)


def _mm(a, b):
    """Batched small matrix product as multiply + sum (full fp32)."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2)


def _mv(a, v):
    return (a * v.unsqueeze(-2)).sum(-1)


def _clip(x, lo, hi):
    return torch.clamp(x, lo, hi)  # propagates NaN like jnp.clip


class _Problem:
    """Per-lane data of one solve as registers (lanes leading); ``bnd`` the
    boundary rows' models (B, H+1, 18) or None; ``step`` and ``lin`` the
    discrete step and its (A, B) on row-lists, of the KS or ST model."""

    def __init__(self, cfg, params, bnd=None):
        self.H = cfg.horizon
        self.consts = make_consts(cfg)
        self.nx = nx = self.consts["nx"]
        self.nr = S.nrows(cfg)
        self.bnd = bnd
        dt = float(cfg.dt)
        if cfg.model == "st":
            st = self.consts["st"]
            self.step = lambda x, u: _st_step_rows(x, u, dt, st,
                                                   cfg.integrator)
            self.lin = lambda x, u: _st_lin_step(x, u, dt, st,
                                                 cfg.integrator)
        else:
            inv_l = self.consts["inv_l"]
            self.step = lambda x, u: _step_rows(x, u, dt, inv_l,
                                                cfg.integrator)
            self.lin = lambda x, u: _lin_step(x, u, dt, inv_l,
                                              cfg.integrator)
        B = params.x0.shape[0]
        w = params.weights
        self.wq = _cols(w.q.reshape(B, 1, nx), nx)       # (B, 1) registers
        self.wr = _cols(w.r.reshape(B, 1, NU), NU)
        self.wqN = _cols(w.qN.reshape(B, nx), nx)         # (B,) registers
        self.x0 = params.x0
        self.xref = params.x_ref                          # (B, H+1, nx)
        obs = params.obs_centers
        self.moving = obs.dim() == 4
        self.obs = (obs.reshape(B, self.H + 1, 6) if self.moving
                    else obs.reshape(B, 1, 6))
        self.mind = params.min_dist.reshape(B, 1)
        stage = torch.arange(self.H, device=params.x0.device)
        self.k_is0 = (stage == 0).unsqueeze(0)            # (1, H)

    def obs_stages(self):
        return _cols(self.obs[:, :self.H] if self.moving else self.obs, 6)

    def obs_term(self):
        return _cols(self.obs[:, self.H] if self.moving else self.obs[:, 0],
                     6)

    def bnd_at(self, k):
        """The boundary models of stages ``k`` (a slice or an index) as 18
        registers, or None."""
        return None if self.bnd is None else _cols(self.bnd[:, k], NBND)


def _stage_rows(pb, X, U):
    """Rows of stages 0..H-1, registers (B, H)."""
    return _compute_rows(_cols(X[:, :-1], pb.nx), _cols(U, NU),
                         pb.obs_stages(),
                         pb.consts, False, pb.k_is0,
                         pb.bnd_at(slice(0, pb.H)))


def _term_rows(pb, X):
    xT = _cols(X[:, -1], pb.nx)
    zero = torch.zeros_like(xT[0])
    return _compute_rows(xT, [zero, zero], pb.obs_term(), pb.consts, True,
                         torch.zeros_like(xT[0], dtype=torch.bool),
                         pb.bnd_at(pb.H))


def _stage_merits(cfg, pb, X, U, lam_lo, lam_hi, mu):
    """Per-stage cost + AL psi, (B, H), and the terminal term, (B,)."""
    H, nr = pb.H, pb.nr
    rs = _stage_rows(pb, X, U)
    terms = _row_terms(rs, _row_bounds(pb.consts, pb.mind, False),
                       _cols(lam_lo[:, :H], nr), _cols(lam_hi[:, :H], nr),
                       _cols(mu[:, :H], nr))
    nx = pb.nx
    m_k = (_stage_cost(_cols(X[:, :H], nx), _cols(U, NU),
                       _cols(pb.xref[:, :H], nx), pb.wq, pb.wr)
           + _stage_psi(terms))
    rT = _term_rows(pb, X)
    termsT = _row_terms(rT, _row_bounds(pb.consts, pb.mind[:, 0], True),
                        _cols(lam_lo[:, H], nr), _cols(lam_hi[:, H], nr),
                        _cols(mu[:, H], nr))
    psiT = _stage_psi(termsT)
    cT = (_term_cost(_cols(X[:, H], nx), _cols(pb.xref[:, H], nx), pb.wqN)
          if cfg.use_terminal_cost else torch.zeros_like(psiT))
    return m_k, cT + psiT


def _rollout(cfg, pb, U):
    x = _cols(pb.x0, pb.nx)
    xs = [torch.stack(x, -1)]
    for k in range(pb.H):
        x = pb.step(x, _cols(U[:, k], NU))
        xs.append(torch.stack(x, -1))
    return torch.stack(xs, 1)


def _feedback_rollout(cfg, pb, X, U, K, d, alpha):
    """u = clip(ub + alpha d + K (x - xb)) along the nonlinear dynamics;
    alpha None is the unguarded step (ub + d + K dx)."""
    c = pb.consts
    x = pb.x0
    xs, us = [x], []
    for k in range(pb.H):
        fb = _mv(K[:, k], x - X[:, k])
        step = d[:, k] if alpha is None else alpha * d[:, k]
        u = U[:, k] + step + fb
        u = torch.stack([_clip(u[:, 0], c["u_lo0"], c["u_hi0"]),
                         _clip(u[:, 1], c["u_lo1"], c["u_hi1"])], -1)
        us.append(u)
        x = torch.stack(pb.step(_cols(x, pb.nx), _cols(u, NU)), -1)
        xs.append(x)
    return torch.stack(xs, 1), torch.stack(us, 1)


def _quadratics(cfg, pb, X, U, lam_lo, lam_hi, mu):
    """Stage quadratics (B, H, ...), terminal (QH, qH) and the Jacobians."""
    H, nr, nx = pb.H, pb.nr, pb.nx
    xk, uk = _cols(X[:, :H], nx), _cols(U, NU)
    rs = _stage_rows(pb, X, U)
    terms = _row_terms(rs, _row_bounds(pb.consts, pb.mind, False),
                       _cols(lam_lo[:, :H], nr), _cols(lam_hi[:, :H], nr),
                       _cols(mu[:, :H], nr))
    Q, R, M, qx, qu = _assemble_quad(rs, terms, xk, uk,
                                     _cols(pb.xref[:, :H], nx), pb.wq, pb.wr,
                                     False)
    like = xk[0]
    A, Bm = pb.lin(xk, uk)
    xT = _cols(X[:, H], nx)
    zero = torch.zeros_like(xT[0])
    rT = _term_rows(pb, X)
    termsT = _row_terms(rT, _row_bounds(pb.consts, pb.mind[:, 0], True),
                        _cols(lam_lo[:, H], nr), _cols(lam_hi[:, H], nr),
                        _cols(mu[:, H], nr))
    QH, qH = _assemble_quad(rT, termsT, xT, [zero, zero],
                            _cols(pb.xref[:, H], nx), pb.wq, pb.wr, True,
                            pb.wqN, cfg.use_terminal_cost)
    return dict(Q=_mat(Q, like), R=_mat(R, like), M=_mat(M, like),
                qx=_vec(qx, like), qu=_vec(qu, like),
                A=_mat(A, like), Bm=_mat(Bm, like),
                QH=_mat(QH, zero), qH=_vec(qH, zero),
                rows=rs, terms=terms, rowsT=rT, termsT=termsT)


def _backward_sweep(cfg, pb, qd):
    """Riccati sweep with the closed-form 2x2 Quu inverse -> K, d."""
    reg = float(cfg.reg)
    P, p = qd["QH"], qd["qH"]
    Ks, ds = [None] * pb.H, [None] * pb.H
    for k in range(pb.H - 1, -1, -1):
        A, Bm = qd["A"][:, k], qd["Bm"][:, k]
        At, Bt = A.transpose(-1, -2), Bm.transpose(-1, -2)
        PA, PB = _mm(P, A), _mm(P, Bm)
        Qxx = qd["Q"][:, k] + _mm(At, PA)
        Quu = qd["R"][:, k] + _mm(Bt, PB)
        Qux = qd["M"][:, k].transpose(-1, -2) + _mm(Bt, PA)
        gx = qd["qx"][:, k] + _mv(At, p)
        gu = qd["qu"][:, k] + _mv(Bt, p)
        a = Quu[:, 0, 0] + reg
        b = Quu[:, 0, 1]
        c = Quu[:, 1, 0]
        dd2 = Quu[:, 1, 1] + reg
        inv_det = 1.0 / (a * dd2 - b * c)
        Qi = torch.stack([torch.stack([dd2 * inv_det, -b * inv_det], -1),
                          torch.stack([-c * inv_det, a * inv_det], -1)], -2)
        K = -_mm(Qi, Qux)
        d = -_mv(Qi, gu)
        QuxT = Qux.transpose(-1, -2)
        P_new = Qxx + _mm(QuxT, K)
        P = 0.5 * (P_new + P_new.transpose(-1, -2))
        p = gx + _mv(QuxT, d)
        Ks[k], ds[k] = K, d
    return torch.stack(Ks, 1), torch.stack(ds, 1)


def _finite(t):
    return torch.where(torch.isfinite(t), t, torch.zeros_like(t))


def _multiplier_update(cfg, pb, X, U, lam_lo, lam_hi, mu, prev_viol):
    """First-order multiplier update + per-row penalty growth at all H+1
    stages (stage H: inputs masked to 0, u-box rows left unchanged)."""
    H = pb.H
    U_eff = torch.cat([U, torch.zeros_like(U[:, :1])], 1)     # (B, H+1, 2)
    obs = _cols(pb.obs, 6)
    k_is0 = (torch.arange(H + 1, device=X.device) == 0).unsqueeze(0)
    r = _compute_rows(_cols(X, pb.nx), _cols(U_eff, NU), obs, pb.consts, False,
                      k_is0, pb.bnd_at(slice(None)))
    hs = _row_values(r)
    is_last = (torch.arange(H + 1, device=X.device) == H).unsqueeze(0)
    zero = torch.zeros((), dtype=X.dtype, device=X.device)
    new = []
    for i, (lo, hi) in enumerate(_row_bounds(pb.consts, pb.mind, False)):
        ll, lh, m, pv = (lam_lo[..., i], lam_hi[..., i], mu[..., i],
                         prev_viol[..., i])
        if hi is not None:
            t_hi = lh + m * (hs[i] - hi)
            lh_n = _clip(torch.where(t_hi > 0, t_hi, zero), 0.0, cfg.lam_max)
            v_hi = torch.maximum(hs[i] - hi, zero)
        else:
            lh_n, v_hi = lh, zero
        if lo is not None:
            t_lo = ll + m * (lo - hs[i])
            ll_n = _clip(torch.where(t_lo > 0, t_lo, zero), 0.0, cfg.lam_max)
            v_lo = torch.maximum(lo - hs[i], zero)
        else:
            ll_n, v_lo = ll, zero
        viol = torch.maximum(v_hi, v_lo)
        if i in (10, 11):
            lh_n = torch.where(is_last, lh, lh_n)
            ll_n = torch.where(is_last, ll, ll_n)
            viol = torch.where(is_last, zero, viol)
        stalled = viol > cfg.viol_improve * pv
        active = viol > cfg.tol_feas
        m_new = _clip(torch.where(stalled & active, m * cfg.mu_factor, m),
                      cfg.mu0, cfg.mu_max)
        new.append((ll_n, lh_n, m_new, viol))
    return tuple(torch.stack([n[j] for n in new], -1) for j in range(4))


def _scaled_viol(hs, bounds, inv_scale, init):
    v = init
    for i, (lo, hi) in enumerate(bounds):
        if hi is not None:
            v = torch.maximum(v, (hs[i] - hi) * inv_scale[i])
        if lo is not None:
            v = torch.maximum(v, (lo - hs[i]) * inv_scale[i])
    return v


def _diagnostics(cfg, pb, X, U, lam_lo, lam_hi, mu):
    """(stat, viol, cost, merit) per lane: KKT stationarity by the adjoint
    recursion lam_H = qH, g_u[k] = qu + B' lam_{k+1}, lam_k = qx + A' lam_{k+1}."""
    H = pb.H
    c = pb.consts
    fr_scale = c["a_max"] ** 2 if c["formulation"] == "forcespro" \
        else c["a_max"]
    inv_scale = [1.0 / fr_scale] + [1.0] * (pb.nr - 1)
    qd = _quadratics(cfg, pb, X, U, lam_lo, lam_hi, mu)
    psiT = _stage_psi(qd["termsT"])
    nx = pb.nx
    costT = (_term_cost(_cols(X[:, H], nx), _cols(pb.xref[:, H], nx), pb.wqN)
             if cfg.use_terminal_cost else torch.zeros_like(psiT))
    zero = torch.zeros_like(psiT)
    violT = _scaled_viol(_row_values(qd["rowsT"]),
                         _row_bounds(c, pb.mind[:, 0], True), inv_scale, zero)
    viol_k = _scaled_viol(_row_values(qd["rows"]),
                          _row_bounds(c, pb.mind, False), inv_scale,
                          torch.zeros_like(X[:, :H, 0]))
    cost_k = _stage_cost(_cols(X[:, :H], nx), _cols(U, NU),
                         _cols(pb.xref[:, :H], nx), pb.wq, pb.wr)
    psi_k = _stage_psi(qd["terms"])

    lam = qd["qH"]
    stat = zero
    viol = torch.maximum(violT, zero)
    cost = costT
    merit = costT + psiT
    for k in range(H - 1, -1, -1):
        g_u = qd["qu"][:, k] + _mv(qd["Bm"][:, k].transpose(-1, -2), lam)
        lam = qd["qx"][:, k] + _mv(qd["A"][:, k].transpose(-1, -2), lam)
        stat = torch.maximum(stat, torch.maximum(g_u[:, 0].abs(),
                                                 g_u[:, 1].abs()))
        viol = torch.maximum(viol, viol_k[:, k])
        cost = cost + cost_k[:, k]
        merit = merit + cost_k[:, k] + psi_k[:, k]
    return stat, viol, cost, merit


def solve_batch_fused_plain(cfg: S.SolverConfig, params: S.OcpParams,
                            state: S.SqpState, rungs: list | None = None,
                            follow: torch.Tensor | None = None):
    """The kernel's function in plain PyTorch; returns (X, U, lam_lo,
    lam_hi, mu, prev_viol, diag (B, 4)) like the kernel's outputs.

    With the ladder on, a list ``rungs`` receives for each GN iteration
    (rung (B,), merits (R, B)): the rung it committed (0 for alpha = 0,
    r + 1 for ``alphas[r]``, as in the kernel's rung buffer) and the merit
    of every rung.  ``follow`` (al_iters * sqp_iters, B) makes iteration i
    commit the rungs ``follow[i]`` instead of the best ones, which replays
    the kernel's choices.  KS-schema params of an ST problem are widened
    (``sqp.normalize_params``).
    """
    params = S.normalize_params(cfg, params)
    pb = _Problem(cfg, params, boundary_models(cfg, params, state))
    U = state.U
    lam_lo, lam_hi, prev_viol = state.lam_lo, state.lam_hi, state.prev_viol
    mu = _prepared_mu(cfg, state.mu)
    X = _rollout(cfg, pb, U)
    for ai in range(cfg.al_iters):
        for si in range(cfg.sqp_iters):
            qd = _quadratics(cfg, pb, X, U, lam_lo, lam_hi, mu)
            K, d = _backward_sweep(cfg, pb, qd)
            if len(cfg.alphas) == 0:
                # unguarded full RTI step: scrub NaN/inf gains, commit the
                # alpha=1 chain (non-finite rollouts included)
                X, U = _feedback_rollout(cfg, pb, X, U, _finite(K),
                                         _finite(d), None)
                continue
            # ladder: alpha=0 reproduces the iterate; strictly better
            # trials win in rung order
            best_X, best_U, best_m, merits = None, None, None, []
            best_r = torch.zeros_like(pb.x0[:, 0], dtype=torch.int32)
            for r, a_val in enumerate((0.0,) + tuple(cfg.alphas)):
                alpha = torch.full_like(pb.x0[:, :1], a_val)
                Xa, Ua = _feedback_rollout(cfg, pb, X, U, K, d, alpha)
                m_k, m_T = _stage_merits(cfg, pb, Xa, Ua, lam_lo, lam_hi, mu)
                m = torch.zeros_like(m_T)
                for k in range(pb.H):
                    m = m + m_k[:, k]
                m = m + m_T
                merits.append(m)
                if best_m is None:
                    best_X, best_U, best_m = Xa, Ua, m
                    continue
                take = (m < best_m if follow is None
                        else follow[ai * cfg.sqp_iters + si] == r)
                best_r = torch.where(take, r, best_r)
                best_m = torch.where(take, m, best_m)
                best_X = torch.where(take[:, None, None], Xa, best_X)
                best_U = torch.where(take[:, None, None], Ua, best_U)
            X, U = best_X, best_U
            if rungs is not None:
                rungs.append((best_r, torch.stack(merits)))
        lam_lo, lam_hi, mu, prev_viol = _multiplier_update(
            cfg, pb, X, U, lam_lo, lam_hi, mu, prev_viol)
    diag = torch.stack(_diagnostics(cfg, pb, X, U, lam_lo, lam_hi, mu), -1)
    return X, U, lam_lo, lam_hi, mu, prev_viol, diag


def _prepared_mu(cfg, mu):
    """Penalties the solve starts from: at least mu0, and mu0 where <= 0."""
    mu = torch.maximum(mu, torch.full_like(mu, cfg.mu0))
    return torch.where(mu <= 0.0, torch.full_like(mu, cfg.mu0), mu)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


class StConsts(ctypes.Structure):
    """Mirror of ``struct StConsts`` in csrc/st_model.cuh (:func:`st_consts`;
    zero for the KS model)."""

    _fields_ = [(n, ctypes.c_float) for n in ST_CONSTS]


class FgnArgs(ctypes.Structure):
    """Mirror of ``struct FgnArgs`` in csrc/fused_gn.cu (all 4-byte)."""

    _fields_ = [(n, ctypes.c_int32) for n in (
        "B", "H", "al_iters", "sqp_iters", "n_alphas", "forcespro", "rk4",
        "moving", "use_term", "threads_per_lane")] + [(n, ctypes.c_float) for n in (
            "dt", "half_dt", "dt6", "inv_l", "reg", "d_ego", "a_cap",
            "inv_fr_scale", "u_lo0", "u_hi0", "u_lo1", "u_hi1", "d_lo",
            "d_hi", "v_lo", "v_hi", "mu0", "mu_factor", "mu_max",
            "viol_improve", "lam_max", "tol_feas", "tol_stat",
            "tol_infeas")] + [
        ("alphas", ctypes.c_float * MAX_ALPHAS),
        ("boundary", ctypes.c_int32), ("r_ego", ctypes.c_float),
        ("st", StConsts)]


def kernel_name(cfg: S.SolverConfig, name: str = "fused_gn") -> str:
    """The library of ``cfg``'s model: ``name`` (KS) or ``name + '_st'``
    (csrc/<name>_st.cu, the ST instances)."""
    return name + "_st" if cfg.model == "st" else name


def kernel_args(cfg: S.SolverConfig, B: int, moving: bool,
                threads_per_lane: int = 0) -> FgnArgs:
    """The argument block; ``threads_per_lane`` 0 lets the kernel choose
    (the most threads a lane whose blocks are all resident at once, else
    the fewest the model's library has: 2 for KS, 4 for ST)."""
    tpl = threads_per_lane_of(S.solver_nx(cfg))
    if threads_per_lane and threads_per_lane not in tpl:
        raise ValueError(f"threads_per_lane {threads_per_lane}: the "
                         f"{cfg.model.upper()} kernel has {tpl} (0: it "
                         "chooses)")
    c = make_consts(cfg)
    dt = float(cfg.dt)
    fr = c["a_max"] ** 2 if c["formulation"] == "forcespro" else c["a_max"]
    a = FgnArgs(
        B=B, H=cfg.horizon, al_iters=cfg.al_iters, sqp_iters=cfg.sqp_iters,
        n_alphas=len(cfg.alphas), forcespro=int(cfg.formulation ==
                                                "forcespro"),
        rk4=int(cfg.integrator == "rk4"), moving=int(moving),
        use_term=int(cfg.use_terminal_cost),
        threads_per_lane=threads_per_lane,
        dt=dt, half_dt=0.5 * dt, dt6=dt / 6.0, inv_l=c["inv_l"],
        reg=float(cfg.reg), d_ego=c["d_ego"], a_cap=fr, inv_fr_scale=1.0 / fr,
        u_lo0=c["u_lo0"], u_hi0=c["u_hi0"], u_lo1=c["u_lo1"],
        u_hi1=c["u_hi1"], d_lo=c["d_lo"], d_hi=c["d_hi"], v_lo=c["v_lo"],
        v_hi=c["v_hi"], mu0=cfg.mu0, mu_factor=cfg.mu_factor,
        mu_max=cfg.mu_max, viol_improve=cfg.viol_improve,
        lam_max=cfg.lam_max, tol_feas=cfg.tol_feas, tol_stat=cfg.tol_stat,
        tol_infeas=cfg.tol_infeas, boundary=int(cfg.boundary_rows),
        r_ego=c["r_ego"])
    for i, v in enumerate(cfg.alphas):
        a.alphas[i] = v
    if c["st"] is not None:
        a.st = StConsts(**c["st"])
    return a


# the argument block of a launch, built once per configuration and shape
_launch_args = functools.lru_cache(maxsize=64)(kernel_args)


def _soa(t):
    """(B, *mid) -> (*mid, B), always a new contiguous tensor: lanes
    fastest, so a warp's 32 threads read neighbouring addresses.  A state
    unpacked from an earlier solve is already lanes-fastest underneath, and
    ``.contiguous()`` would hand back that very buffer for the kernel to
    overwrite."""
    return t.permute(*range(1, t.dim()), 0).clone(
        memory_format=torch.contiguous_format)


def _aos(t):
    """(*mid, B) -> (B, *mid) view (the package's public layout)."""
    return t.permute(t.dim() - 1, *range(t.dim() - 1))


# the kernel's buffers in the order of fused_gn_solve's pointer arguments
KERNEL_INPUTS = ("x0", "xref", "obs", "mind", "w")
KERNEL_STATE = ("U", "lam_lo", "lam_hi", "mu", "pviol")   # updated in place
KERNEL_OUTPUTS = ("X", "diag", "status")
KERNEL_SCRATCH = ("K", "d", "Xc", "Uc")
KERNEL_TRACE = ("rung",)     # optional: the rung each ladder step committed
KERNEL_BOUNDARY = ("bnd",)   # with boundary rows: their models (H+1, 18, B)
KERNEL_ORDER = (KERNEL_INPUTS + KERNEL_STATE + KERNEL_OUTPUTS + KERNEL_SCRATCH
                + KERNEL_TRACE + KERNEL_BOUNDARY)
_OUT_ORDER = ("X", "U", "lam_lo", "lam_hi", "mu", "pviol", "diag")


def _packed(t, shape):
    """``t`` checked against the kernels' type and ``shape``, copied lanes
    fastest."""
    if t.dtype != torch.float32:
        raise TypeError(f"the fused kernels take float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"shape {tuple(t.shape)}, want {shape}")
    return _soa(t)


def _lanes_fastest(parts) -> dict:
    """Every (name, tensor or list of tensors, shape (B, *mid)) checked
    against float32 and its shape and copied, lanes fastest, into one
    buffer by a single ``torch.cat`` of their transposed views (a list is
    joined along its last axis); returns name -> a contiguous (*mid, B)
    view of that buffer."""
    cols, sizes = [], []
    for name, ts, shape in parts:
        ts = ts if isinstance(ts, list) else [ts]
        if any(t.dtype != torch.float32 for t in ts):
            raise TypeError(f"the fused kernels take float32, got "
                            f"{[t.dtype for t in ts]}")
        flat = [t.reshape(t.shape[0], -1) if t.dim() else t for t in ts]
        n = math.prod(shape[1:])
        if ((len(ts) == 1 and tuple(ts[0].shape) != shape)
                or any(f.dim() != 2 or f.shape[0] != shape[0] for f in flat)
                or sum(f.shape[1] for f in flat) != n):
            raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in ts]}"
                             f", want {shape}")
        cols += [f.t() for f in flat]
        sizes.append(n)
    big = torch.cat(cols, 0)
    out, o = {}, 0
    for (name, _, shape), n in zip(parts, sizes):
        out[name] = big[o:o + n].view(*shape[1:], shape[0])
        o += n
    return out


def pack(cfg: S.SolverConfig, params: S.OcpParams, state: S.SqpState,
         trace_rungs: bool = False) -> dict:
    """The kernel's buffers, lanes fastest: every input copied into that
    layout (so the caller's tensors are never written), all but U by one
    ``torch.cat``, every output and scratch buffer allocated.  The line-search
    trial chains (a slot a rung) are allocated only when the ladder is on,
    and the rung trace (al_iters * sqp_iters, B) only when it is on and
    ``trace_rungs`` asks for it.  With boundary rows their models at the
    rollout of the warm start (:func:`boundary_models`) go into the same
    buffer.  KS-schema params of an ST problem are widened first
    (``sqp.normalize_params``)."""
    reason = ineligible_reason(cfg, params)
    if reason is not None:
        raise NotImplementedError(reason)
    params = S.normalize_params(cfg, params)
    B, H, nr = params.x0.shape[0], cfg.horizon, S.nrows(cfg)
    nx = S.solver_nx(cfg)
    dev, f32 = params.x0.device, torch.float32
    moving = params.obs_centers.dim() == 4
    w = params.weights
    # the penalties the solve starts from (_prepared_mu): for mu0 > 0 the
    # floor alone, which leaves no penalty <= 0
    mu = (state.mu.clamp_min(cfg.mu0) if cfg.mu0 > 0
          else _prepared_mu(cfg, state.mu))
    parts = [
        ("x0", params.x0, (B, nx)),
        ("xref", params.x_ref, (B, H + 1, nx)),
        ("obs", params.obs_centers.reshape(B, -1, 6) if moving
         else params.obs_centers.reshape(B, 6),
         (B, H + 1, 6) if moving else (B, 6)),
        ("mind", params.min_dist.reshape(B), (B,)),
        ("w", [w.q, w.r, w.qN], (B, 2 * nx + NU)),
        ("lam_lo", state.lam_lo, (B, H + 1, nr)),
        ("lam_hi", state.lam_hi, (B, H + 1, nr)),
        ("mu", mu, (B, H + 1, nr)),
        ("pviol", state.prev_viol, (B, H + 1, nr))]
    if cfg.boundary_rows:
        parts.append(("bnd", boundary_models(cfg, params, state),
                      (B, H + 1, NBND)))
    bufs = _lanes_fastest(parts)
    bufs.update(
        # a buffer of its own: a caller keeps views of the solution's U
        # (the applied input), which must not hold the whole copy alive
        U=_packed(state.U, (B, H, NU)),
        X=torch.empty((H + 1, nx, B), dtype=f32, device=dev),
        diag=torch.empty((4, B), dtype=f32, device=dev),
        status=torch.empty((B,), dtype=torch.int32, device=dev),
        K=torch.empty((H, NU * nx, B), dtype=f32, device=dev),
        d=torch.empty((H, NU, B), dtype=f32, device=dev))
    if cfg.alphas:
        # a trial chain a rung: alpha = 0 and each of the alphas
        rungs = 1 + len(cfg.alphas)
        bufs["Xc"] = torch.empty((rungs, H + 1, nx, B), dtype=f32,
                                 device=dev)
        bufs["Uc"] = torch.empty((rungs, H, NU, B), dtype=f32, device=dev)
        if trace_rungs:
            bufs["rung"] = torch.empty((cfg.al_iters * cfg.sqp_iters, B),
                                       dtype=torch.int32, device=dev)
    return bufs


def call_kernel(name: str, args: ctypes.Structure, bufs: dict, order):
    """Call ``csrc/<name>.cu``'s C entry point on the current stream with
    the argument block and the buffers named in ``order`` (a missing one is
    passed as a null pointer); returns its CUDA error code."""
    from mpc_tpu_torch.ops import _build

    dev = bufs[order[0]].device
    if dev.type != "cuda":
        raise ValueError(f"the {name} kernel needs CUDA tensors, got {dev}")
    ptrs = [ctypes.c_void_p(bufs[n].data_ptr() if n in bufs else 0)
            for n in order]
    lib = _build.load(name)
    fn = getattr(lib, _build.SIGNATURES[name][0])
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        return fn(ctypes.byref(args), *ptrs, stream)


def _launch(name: str, cfg: S.SolverConfig, bufs: dict,
            threads_per_lane: int) -> None:
    args = _launch_args(cfg, bufs["x0"].shape[-1], bufs["obs"].dim() == 3,
                        threads_per_lane)
    err = call_kernel(name, args, bufs, KERNEL_ORDER)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def launch(cfg: S.SolverConfig, bufs: dict, threads_per_lane: int = 0):
    """Launch the kernel of ``cfg``'s model once on the current stream over
    packed ``bufs`` (the ST model: :func:`launch_st`).

    The kernel updates the warm-start buffers (U, lam_lo, lam_hi, mu,
    pviol) in place, where the TPU kernel aliased inputs to outputs, and
    writes X and diag.  ``threads_per_lane`` 0 lets the kernel choose.
    ``launch.launches`` counts the launches of the KS kernel.
    """
    if cfg.model == "st":
        return launch_st(cfg, bufs, threads_per_lane)
    launch.launches += 1
    return _launch("fused_gn", cfg, bufs, threads_per_lane)


def launch_st(cfg: S.SolverConfig, bufs: dict, threads_per_lane: int = 0):
    """:func:`launch` of the ST model's kernel (csrc/fused_gn_st.cu);
    ``launch_st.launches`` counts its launches."""
    if cfg.model != "st":
        raise ValueError(f"model '{cfg.model}': fused_gn_st solves 'st'")
    launch_st.launches += 1
    return _launch("fused_gn_st", cfg, bufs, threads_per_lane)


launch.launches = 0
launch_st.launches = 0


def geometry(cfg: S.SolverConfig, B: int, moving: bool = False,
             threads_per_lane: int = 0) -> dict:
    """The launch geometry the kernel takes on the current GPU for B lanes:
    threads a lane (given, or chosen with the occupancy API), lanes a
    block, shared bytes a lane and a block, blocks resident an SM,
    registers a thread."""
    from mpc_tpu_torch.ops import _build
    args = kernel_args(cfg, B, moving, threads_per_lane)
    out = (ctypes.c_int32 * 6)()
    fn = _build.load(kernel_name(cfg)).fused_gn_geometry
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(ctypes.byref(args), out)
    if err != 0:
        raise RuntimeError(f"fused_gn geometry failed: CUDA error {err}")
    keys = ("threads_per_lane", "lanes_per_block", "smem_bytes_per_lane",
            "smem_bytes_per_block", "blocks_per_sm", "registers")
    return dict(zip(keys, list(out)))


def unpack(bufs: dict):
    """(X, U, lam_lo, lam_hi, mu, prev_viol, diag) in the package's public
    lanes-leading layout (views of the kernel's buffers)."""
    return tuple(_aos(bufs[n]) for n in _OUT_ORDER)


def launch_kernel(cfg: S.SolverConfig, params: S.OcpParams,
                  state: S.SqpState, threads_per_lane: int = 0):
    """Run the CUDA kernel; same outputs as :func:`solve_batch_fused_plain`."""
    bufs = pack(cfg, params, state)
    launch(cfg, bufs, threads_per_lane)
    return unpack(bufs)


def _to(tree, dev):
    return S.map_tensors(tree, lambda t: t.to(dev))


def solve_batch_fused(cfg: S.SolverConfig, params: S.OcpParams,
                      state: S.SqpState, device=None) -> S.Solution:
    """Fused batched solve; the contract of ``mpc_tpu``'s
    ``fused_gn.solve_batch_fused``.

    Runs on ``device`` (default: the GPU, see ``resolve_device``): CUDA
    tensors go to the kernel of the model (KS or ST), CPU tensors to the
    plain version.  A problem outside the kernel's envelope goes to
    ``sqp_vec.solve_batch_vec`` on every device, as the JAX package falls
    back, and from there the IP method to the per-lane path
    ``sqp.solve_batch``.
    """
    dev = resolve_device(device)
    if ineligible_reason(cfg, params) is not None:
        from mpc_tpu_torch.ops import sqp_vec
        return sqp_vec.solve_batch_vec(cfg, params, state, device=dev)
    params = _to(S.normalize_params(cfg, params), dev)
    state = _to(state, dev)
    if dev.type == "cuda":
        bufs = pack(cfg, params, state)
        launch(cfg, bufs)
        return kernel_solution(bufs)
    if dev.type == "cpu":
        return to_solution(cfg, solve_batch_fused_plain(cfg, params, state))
    raise ValueError(f"unsupported device {dev}")


def _solution(out, status, viol) -> S.Solution:
    X, U, lam_lo, lam_hi, mu, prev_viol, diag = out
    stat, _, cost, merit = diag.unbind(-1)
    new_state = S.SqpState(U=U, lam_lo=lam_lo, lam_hi=lam_hi, mu=mu,
                           prev_viol=prev_viol)
    return S.Solution(X=X, U=U, state=new_state, status=status,
                      kkt_stat=stat, viol=viol, cost=cost, merit=merit)


def to_solution(cfg: S.SolverConfig, out) -> S.Solution:
    """The kernel's (or the plain version's) outputs as a Solution, with
    the status mapping of the JAX package: 1 converged, 0 feasible, -7
    infeasible."""
    stat, viol = out[-1][..., 0], torch.clamp(out[-1][..., 1], min=0.0)
    converged = (stat < cfg.tol_stat) & (viol < cfg.tol_feas)
    feasible = viol < cfg.tol_infeas
    one = torch.ones_like(stat, dtype=torch.int32)
    status = torch.where(converged, one,
                         torch.where(feasible, 0 * one, -7 * one))
    return _solution(out, status, viol)


def kernel_solution(bufs: dict) -> S.Solution:
    """The kernel's buffers as a Solution, with the status the kernel
    wrote: :func:`to_solution`'s mapping of the same diagnostics, whose
    violation is >= 0 or NaN there, so that no device work is left."""
    out = unpack(bufs)
    return _solution(out, bufs["status"], out[-1][..., 1])
