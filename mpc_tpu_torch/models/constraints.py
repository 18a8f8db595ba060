"""Stagewise inequality rows, constraint geometry and box bounds
(``mpc_tpu.models.constraints``).

Every row is ``lo <= h(x, u) <= hi`` with a fixed count per stage: the
friction-circle row and 9 obstacle-circle distances of the FORCESPRO or
the CasADi form, plus the optional road-boundary rows.  The functions take
tensors with any leading axes (lanes, stages, line-search rungs) that
broadcast against each other, and keep the JAX package's algebra row for
row: the sqrt distance with its ``eps=1e-9`` guard, the signed polyline
distance and ``lo = r_ego`` for the boundary rows.  The fused kernels
(``ops.fused_gn``, ``ops.fused_ip``) evaluate the same rows in closed form.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

# Two-sided inequality rows per stage: 1 friction-circle row + 9 circle rows.
NUM_INEQ = 10
# Optional road-boundary rows: 3 ego circles x 2 boundaries.
NUM_BOUNDARY = 6
_INF = float("inf")


def approx_circle_radius(length: float, width: float) -> Tuple[float, float]:
    """3-circle approximation radius + center spacing of a rectangle.

    Host-side (NumPy), including the reference planner's quirk: the radius
    is rounded to 0.1 m and bumped up by 0.1 m when rounding went down.
    """
    if length < 0 or width < 0:
        raise ValueError(f"negative extent {length} x {width}")
    if np.isclose(length, 0.0) and np.isclose(width, 0.0):
        return 0.0, 0.0
    square_length = length / 3.0
    diagonal_square = float(np.sqrt((square_length / 2.0) ** 2
                                    + (width / 2.0) ** 2))
    if diagonal_square > round(diagonal_square, 1):
        approx_radius = round(diagonal_square, 1) + 0.1
    else:
        approx_radius = round(diagonal_square, 1)
    return approx_radius, round(square_length * 2.0, 1)


def circle_centers(x: torch.Tensor, y: torch.Tensor, length: float,
                   width: float, orientation: torch.Tensor) -> torch.Tensor:
    """Centers of the 3 approximating circles, shape (..., 3, 2), in the
    order [center, front, rear]."""
    _, disc_distance = approx_circle_radius(length, width)
    d = disc_distance / 2.0 / 2.0
    c, s = torch.cos(orientation), torch.sin(orientation)
    center = torch.stack([x, y], dim=-1)
    front = torch.stack([x + d * c, y + d * s], dim=-1)
    rear = torch.stack([x - d * c, y - d * s], dim=-1)
    return torch.stack([center, front, rear], dim=-2)


@dataclasses.dataclass
class ObstacleParams:
    """Runtime obstacle data of the circle-distance rows.

    centers (..., 3, 2) obstacle circle centers [center, front, rear];
    min_dist (...) r_ego + r_obs, the lower bound of every distance row.
    """

    centers: torch.Tensor
    min_dist: torch.Tensor


def _take(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """a (..., N, k) at index i (..., 1) of its N axis -> (..., k); a
    broadcasts against i."""
    a = a.expand(i.shape[:-1] + a.shape[-2:])
    idx = i[..., None].expand(i.shape[:-1] + (1, a.shape[-1]))
    return torch.gather(a, -2, idx)[..., 0, :]


def signed_distance_to_polyline(p: torch.Tensor, poly: torch.Tensor
                                ) -> torch.Tensor:
    """Signed distance of points ``p`` (..., 2) to polylines (..., NB, 2).

    Positive left of the directed polyline (the sign of the cross product of
    the nearest segment's direction with the offset); callers calibrate the
    sign per boundary so that positive means inside the road.
    """
    a = poly[..., :-1, :]
    ab = poly[..., 1:, :] - a
    ab2 = torch.sum(ab * ab, dim=-1)
    rel = p[..., None, :] - a
    t = torch.clamp(torch.sum(rel * ab, dim=-1)
                    / torch.where(ab2 < 1e-12, torch.full_like(ab2, 1e-12),
                                  ab2), 0.0, 1.0)
    proj = a + t[..., None] * ab
    d2 = torch.sum((proj - p[..., None, :]) ** 2, dim=-1)
    i = torch.argmin(d2, dim=-1, keepdim=True)
    ab_i, a_i = _take(ab, i), _take(a, i)
    d2_i = torch.gather(d2, -1, i)[..., 0]
    cross = (ab_i[..., 0] * (p[..., 1] - a_i[..., 1])
             - ab_i[..., 1] * (p[..., 0] - a_i[..., 0]))
    return torch.sign(cross) * torch.sqrt(d2_i + 1e-12)


def boundary_rows(x: torch.Tensor, ego_length: float, ego_width: float,
                  boundaries: torch.Tensor, boundary_signs: torch.Tensor,
                  r_ego: float):
    """Signed distance of each ego circle to each road boundary, (..., 6).

    boundaries (..., 2, NB, 2) padded polylines (left, right);
    boundary_signs (..., 2) +-1 so that h > 0 means inside the road.
    Returns (h, lo, hi) with lo = r_ego and hi = inf.
    """
    ego = circle_centers(x[..., 0], x[..., 1], ego_length, ego_width,
                         x[..., 4])
    h = torch.stack([boundary_signs[..., j] * signed_distance_to_polyline(
        ego[..., i, :], boundaries[..., j, :, :])
        for i in range(3) for j in range(2)], dim=-1)
    return h, torch.full_like(h, r_ego), torch.full_like(h, _INF)


def _circle_bounds(friction, d, min_dist, f_hi):
    friction = torch.broadcast_to(friction, d.shape[:-1])
    h = torch.cat([friction[..., None], d], dim=-1)
    lo = torch.cat([torch.zeros_like(friction)[..., None],
                    torch.broadcast_to(min_dist[..., None], d.shape)], dim=-1)
    hi = torch.cat([torch.full_like(friction, f_hi)[..., None],
                    torch.full_like(d, _INF)], dim=-1)
    return h, lo, hi


def stage_ineq_forcespro(x: torch.Tensor, u: torch.Tensor,
                         obs: ObstacleParams, ego_length: float,
                         ego_width: float, wheelbase: float, a_max: float):
    """FORCESPRO-form rows, (..., NUM_INEQ): h[0] = a^2 + (v psidot)^2 in
    [0, a_max^2]; h[1:10] the distances of all 9 ego-circle / obstacle-circle
    pairs in [min_dist, inf), in sqrt form (unit-norm gradients)."""
    v, delta, psi = x[..., 3], x[..., 2], x[..., 4]
    a = u[..., 1]
    psi_dot = v * torch.tan(delta) / wheelbase
    friction = a * a + (v * psi_dot) ** 2
    ego = circle_centers(x[..., 0], x[..., 1], ego_length, ego_width, psi)
    diff = ego[..., :, None, :] - obs.centers[..., None, :, :]
    eps = 1e-9  # sqrt grad guard at exactly-coincident centers
    sq = torch.sum(diff * diff, dim=-1)
    d = torch.sqrt(sq.reshape(sq.shape[:-2] + (9,)) + eps)
    return _circle_bounds(friction, d, obs.min_dist, a_max ** 2)


def stage_ineq_casadi(x: torch.Tensor, u: torch.Tensor, obs: ObstacleParams,
                      ego_length: float, ego_width: float, wheelbase: float,
                      a_max: float, friction_active: torch.Tensor):
    """CasADi-form rows, (..., NUM_INEQ): h[0] = |a^2 + v^2 tan(delta) / l|
    in [0, a_max] where ``friction_active`` (stage 0), else 0; h[1:10] the 3
    matched circle distances, each 3x, in [min_dist, inf)."""
    v, delta, psi = x[..., 3], x[..., 2], x[..., 4]
    a = u[..., 1]
    friction = torch.abs(a * a + v * (torch.tan(delta) * v) / wheelbase)
    friction = torch.where(friction_active, friction,
                           torch.zeros_like(friction))
    ego = circle_centers(x[..., 0], x[..., 1], ego_length, ego_width, psi)
    diff = ego - obs.centers
    eps = 1e-9
    d = torch.sqrt(torch.sum(diff * diff, dim=-1) + eps)
    d9 = torch.repeat_interleave(d, 3, dim=-1)
    return _circle_bounds(friction, d9, obs.min_dist, a_max)


@dataclasses.dataclass(frozen=True)
class BoxBounds:
    """Static box bounds on inputs and states."""

    u_lo: Tuple[float, float]
    u_hi: Tuple[float, float]
    x_lo: Tuple[float, float, float, float, float]
    x_hi: Tuple[float, float, float, float, float]

    def as_arrays(self, dtype=torch.float32, device=None):
        return tuple(torch.tensor(b, dtype=dtype, device=device)
                     for b in (self.u_lo, self.u_hi, self.x_lo, self.x_hi))


def make_box_bounds(p, formulation: str) -> BoxBounds:
    """Box bounds from vehicle params for 'forcespro' or 'casadi' (the
    latter leaves aLong unbounded below)."""
    inf = float("inf")
    a_lo = -p.longitudinal.a_max if formulation == "forcespro" else -inf
    return BoxBounds(
        u_lo=(p.steering.v_min, a_lo),
        u_hi=(p.steering.v_max, p.longitudinal.a_max),
        x_lo=(-inf, -inf, p.steering.min, 0.0, -inf),
        x_hi=(inf, inf, p.steering.max, p.longitudinal.v_max, inf),
    )
