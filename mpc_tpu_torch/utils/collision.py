"""Collision oracle (``mpc_tpu.utils.collision``, host side).

The planned trajectory's vehicle rectangle, swept along its states, is
checked against an obstacle rectangle (separating axes) and against
road-boundary polylines, in NumPy.  These are the Python versions of the
native library's checks (``utils.native``), used where it cannot be built.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _rect_corners(center: np.ndarray, length: float, width: float,
                  orientation: float) -> np.ndarray:
    """Corners (4, 2) of an oriented rectangle."""
    c, s = np.cos(orientation), np.sin(orientation)
    R = np.array([[c, -s], [s, c]])
    half = np.array([[length / 2, width / 2], [length / 2, -width / 2],
                     [-length / 2, -width / 2], [-length / 2, width / 2]])
    return center.reshape(1, 2) + half @ R.T


def _sat_overlap(a: np.ndarray, b: np.ndarray) -> bool:
    """Separating-axis test for two convex polygons (corner arrays)."""
    for poly in (a, b):
        n = len(poly)
        for i in range(n):
            edge = poly[(i + 1) % n] - poly[i]
            axis = np.array([-edge[1], edge[0]])
            pa = a @ axis
            pb = b @ axis
            if pa.max() < pb.min() or pb.max() < pa.min():
                return False
    return True


def rectangles_collide(c1, l1, w1, o1, c2, l2, w2, o2) -> bool:
    return _sat_overlap(_rect_corners(np.asarray(c1, float), l1, w1, o1),
                        _rect_corners(np.asarray(c2, float), l2, w2, o2))


def trajectory_collides_obstacle(
        states: np.ndarray, ego_length: float, ego_width: float,
        obs_center: np.ndarray, obs_length: float, obs_width: float,
        obs_orientation: float) -> Tuple[bool, int]:
    """Sweep the ego rectangle along the trajectory vs one static obstacle.

    states: (T, 5) rows [x, y, delta, v, psi].
    Returns (collides, first_colliding_step or -1).
    """
    if obs_length <= 0 or obs_width <= 0:
        return False, -1
    for i in range(states.shape[0]):
        if rectangles_collide(states[i, :2], ego_length, ego_width,
                              states[i, 4], obs_center, obs_length,
                              obs_width, obs_orientation):
            return True, i
    return False, -1


def _segments_of_polyline(poly: np.ndarray) -> np.ndarray:
    return np.stack([poly[:-1], poly[1:]], axis=1)  # (n-1, 2, 2)


def _segment_intersects_rect(seg: np.ndarray, corners: np.ndarray) -> bool:
    """Does segment (2,2) intersect the rectangle given by its corners?"""
    # endpoint inside?
    for p in seg:
        if _point_in_convex(p, corners):
            return True
    # edge crossing?
    for i in range(4):
        if _segments_cross(seg[0], seg[1], corners[i], corners[(i + 1) % 4]):
            return True
    return False


def _point_in_convex(p: np.ndarray, poly: np.ndarray) -> bool:
    signs = []
    n = len(poly)
    for i in range(n):
        e = poly[(i + 1) % n] - poly[i]
        v = p - poly[i]
        signs.append(np.sign(e[0] * v[1] - e[1] * v[0]))
    signs = [s for s in signs if s != 0]
    return len(set(signs)) <= 1


def _segments_cross(p1, p2, q1, q2) -> bool:
    def orient(a, b, c):
        return np.sign((b[0] - a[0]) * (c[1] - a[1])
                       - (b[1] - a[1]) * (c[0] - a[0]))
    return (orient(p1, p2, q1) != orient(p1, p2, q2)
            and orient(q1, q2, p1) != orient(q1, q2, p2))


def trajectory_crosses_boundary(states: np.ndarray, ego_length: float,
                                ego_width: float,
                                boundary: Optional[np.ndarray]
                                ) -> Tuple[bool, int]:
    """Does the swept ego rectangle cross a road-boundary polyline?

    Role of ``create_road_boundary_obstacle`` + collision check
    (``test/test_mpc_planner.py:41-47``).
    """
    if boundary is None or len(boundary) < 2:
        return False, -1
    segs = _segments_of_polyline(np.asarray(boundary, float))
    for i in range(states.shape[0]):
        corners = _rect_corners(states[i, :2], ego_length, ego_width,
                                states[i, 4])
        lo = corners.min(axis=0) - 1e-9
        hi = corners.max(axis=0) + 1e-9
        # broad phase: segment bbox overlap
        smin = segs.min(axis=1)
        smax = segs.max(axis=1)
        cand = np.where((smax[:, 0] >= lo[0]) & (smin[:, 0] <= hi[0])
                        & (smax[:, 1] >= lo[1]) & (smin[:, 1] <= hi[1]))[0]
        for j in cand:
            if _segment_intersects_rect(segs[j], corners):
                return True, i
    return False, -1
