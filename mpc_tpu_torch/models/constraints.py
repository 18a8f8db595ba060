"""Constraint geometry and box bounds (``mpc_tpu.models.constraints``).

The stage rows themselves (friction circle, 9 circle distances, 4 box rows)
are evaluated in closed form inside the fused solve, ``ops.fused_gn``.
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
