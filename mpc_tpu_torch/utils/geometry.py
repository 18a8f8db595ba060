"""Polyline geometry (``mpc_tpu.utils.geometry``).

The host-side helpers are NumPy, the same functions as the JAX package's:
closest points, arc lengths, orientation and curvature of a polyline,
Chaikin corner cutting, fixed-step resampling and the lateral detour
pre-pass of a reference path.  The two device-side functions
(:func:`closest_point_index_t`, :func:`arclength_projection_t`) are torch
functions on tensors, the counterparts of the JAX package's ``*_jnp`` ones.
"""
from __future__ import annotations

import numpy as np
import torch


def find_closest_point(path_points: np.ndarray, point: np.ndarray) -> int:
    """Index of the closest polyline point."""
    diff = path_points - np.asarray(point).reshape(1, 2)
    return int(np.argmin(np.sum(diff * diff, axis=1)))


def compute_polyline_length(polyline: np.ndarray) -> float:
    """Total arc length of a polyline."""
    seg = np.diff(polyline, axis=0)
    return float(np.sum(np.hypot(seg[:, 0], seg[:, 1])))


def compute_pathlength_from_polyline(polyline: np.ndarray) -> np.ndarray:
    """Cumulative arc length per vertex, shape (n,)."""
    seg = np.diff(polyline, axis=0)
    return np.concatenate([[0.0], np.cumsum(np.hypot(seg[:, 0], seg[:, 1]))])


def compute_orientation_from_polyline(polyline: np.ndarray) -> np.ndarray:
    """Heading per vertex by forward differences; the last vertex repeats
    the last segment's heading."""
    polyline = np.asarray(polyline)
    seg = np.diff(polyline, axis=0)
    theta = np.arctan2(seg[:, 1], seg[:, 0])
    return np.concatenate([theta, theta[-1:]])


def compute_curvature_from_polyline(polyline: np.ndarray) -> np.ndarray:
    """Signed curvature per vertex by central differences."""
    x, y = polyline[:, 0], polyline[:, 1]
    dx, dy = np.gradient(x), np.gradient(y)
    ddx, ddy = np.gradient(dx), np.gradient(dy)
    denom = (dx * dx + dy * dy) ** 1.5
    denom = np.where(denom < 1e-12, 1e-12, denom)
    return (dx * ddy - dy * ddx) / denom


def chaikins_corner_cutting(polyline: np.ndarray,
                            refinements: int = 1) -> np.ndarray:
    """Chaikin smoothing: each segment is replaced by its 1/4 and 3/4
    points; the endpoints are kept."""
    pts = np.asarray(polyline, dtype=float)
    for _ in range(refinements):
        left = pts[:-1]
        right = pts[1:]
        q = 0.75 * left + 0.25 * right
        p = 0.25 * left + 0.75 * right
        inner = np.empty((2 * len(left), 2))
        inner[0::2] = q
        inner[1::2] = p
        pts = np.vstack([pts[:1], inner, pts[-1:]])
    return pts


def resample_polyline(polyline: np.ndarray, step: float) -> np.ndarray:
    """Points every ``step`` meters of arc length from the first vertex;
    the last vertex is appended when the remainder exceeds 1e-6 m."""
    polyline = np.asarray(polyline, dtype=float)
    if len(polyline) < 2:
        return polyline.copy()
    s = compute_pathlength_from_polyline(polyline)
    total = s[-1]
    n = int(np.floor(total / step)) + 1
    targets = np.arange(n) * step
    xs = np.interp(targets, s, polyline[:, 0])
    ys = np.interp(targets, s, polyline[:, 1])
    out = np.stack([xs, ys], axis=1)
    if total - targets[-1] > 1e-6:
        out = np.vstack([out, polyline[-1:]])
    return out


def closest_point_index_t(path_points: torch.Tensor,
                          point: torch.Tensor) -> torch.Tensor:
    """Index of the closest polyline point, on the tensors' device:
    path_points (..., n, 2), point (..., 2) -> (...) int64."""
    diff = path_points - point[..., None, :]
    return torch.argmin(torch.sum(diff * diff, dim=-1), dim=-1)


def arclength_projection_t(path_points: torch.Tensor,
                           point: torch.Tensor) -> torch.Tensor:
    """Arc-length coordinate of the projection of ``point`` (..., 2) onto
    the polyline ``path_points`` (..., n, 2): each segment's projection is
    clamped to the segment, and s is read at the nearest one."""
    a = path_points[..., :-1, :]
    ab = path_points[..., 1:, :] - a
    ab2 = torch.sum(ab * ab, dim=-1)
    t = torch.clamp(torch.sum((point[..., None, :] - a) * ab, dim=-1)
                    / torch.where(ab2 < 1e-12, torch.full_like(ab2, 1e-12),
                                  ab2), 0.0, 1.0)
    proj = a + t[..., None] * ab
    d2 = torch.sum((proj - point[..., None, :]) ** 2, dim=-1)
    seg_len = torch.sqrt(ab2).expand(d2.shape)
    s = torch.cat([torch.zeros_like(seg_len[..., :1]),
                   torch.cumsum(seg_len, dim=-1)], dim=-1)
    idx = torch.argmin(d2, dim=-1, keepdim=True)
    return (torch.gather(s, -1, idx) + torch.gather(t, -1, idx)
            * torch.gather(seg_len, -1, idx))[..., 0]


def point_polyline_distance(point: np.ndarray, poly: np.ndarray) -> float:
    """Unsigned least distance from ``point`` (2,) to the segments."""
    a = poly[:-1]
    b = poly[1:]
    ab = b - a
    ab2 = np.maximum(np.sum(ab * ab, axis=1), 1e-12)
    t = np.clip(np.sum((point - a) * ab, axis=1) / ab2, 0.0, 1.0)
    proj = a + t[:, None] * ab
    return float(np.sqrt(np.min(np.sum((proj - point) ** 2, axis=1))))


def detour_side_from_road(path: np.ndarray, obstacle: np.ndarray,
                          left_boundary, right_boundary,
                          required_clearance: float,
                          half_width: float) -> float | None:
    """The detour side with enough road: +1 (left) or -1 (right).

    Measures the room from the path point nearest the obstacle to each road
    edge; a side that fits the whole swerve (clearance + half the vehicle's
    width + 0.2 m) wins, else the roomier one.  None when an edge is
    missing (the caller then decides by the obstacle's offset).
    """
    if left_boundary is None or right_boundary is None:
        return None
    lb = np.asarray(left_boundary, float)
    rb = np.asarray(right_boundary, float)
    if len(lb) < 2 or len(rb) < 2:
        return None
    p = path[find_closest_point(path, obstacle)]
    room_left = point_polyline_distance(p, lb)
    room_right = point_polyline_distance(p, rb)
    need = required_clearance + half_width + 0.2
    if room_left >= need and room_left >= room_right:
        return 1.0
    if room_right >= need:
        return -1.0
    return 1.0 if room_left >= room_right else -1.0


def lateral_detour(polyline: np.ndarray, obstacle: np.ndarray,
                   required_clearance: float, side: float | None = None,
                   entry: float = 25.0, exit_dist: float = 15.0
                   ) -> np.ndarray:
    """Bend a reference path sideways around a near-head-on obstacle.

    An obstacle on the reference line is a symmetric saddle for a local
    solver; a smooth lateral bump (rising over ``entry`` m before the
    obstacle, falling over ``exit_dist`` m after it) starts the solver in
    the avoidance basin, while the rows still enforce the true clearance.
    No-op when the obstacle already clears the path laterally.  ``side``
    +1 bends left of travel, -1 right; by default the side away from the
    obstacle's offset, left on a tie.
    """
    path = np.asarray(polyline, dtype=float)
    obstacle = np.asarray(obstacle, dtype=float)
    s = compute_pathlength_from_polyline(path)
    i0 = find_closest_point(path, obstacle)
    lo, hi = max(i0 - 1, 0), min(i0 + 1, len(path) - 1)
    tang = path[hi] - path[lo]
    norm = np.hypot(*tang)
    if norm < 1e-9:
        return path
    tang = tang / norm
    normal = np.array([-tang[1], tang[0]])  # left of travel
    clearance = float((obstacle - path[i0]) @ normal)
    if abs(clearance) >= required_clearance:
        return path
    if side is None:
        side = -np.sign(clearance) if abs(clearance) > 1e-6 else 1.0
    target = clearance + side * required_clearance
    s0 = s[i0]
    rise = _smoothstep01((s - (s0 - entry)) / max(entry * 0.7, 1e-6))
    fall = 1.0 - _smoothstep01((s - (s0 + exit_dist * 0.3))
                               / max(exit_dist * 0.7, 1e-6))
    bump = target * rise * fall
    ori = compute_orientation_from_polyline(path)
    normals = np.stack([-np.sin(ori), np.cos(ori)], axis=1)
    return path + bump[:, None] * normals


def _smoothstep01(t: np.ndarray) -> np.ndarray:
    t = np.clip(t, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)
