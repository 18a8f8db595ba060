"""Lanelet-graph route planner (``mpc_tpu.io.route``).

Builds a digraph over lanelets with successor edges and lane-change
(adjacency) edges, finds the shortest route by Dijkstra from the lanelet
under the initial position to the goal, and renders a reference-path
polyline from the route's centerlines, blending across lane changes.  It
takes the place of ``commonroad-route-planner`` (first route retrieved).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from mpc_tpu_torch.io.scenario import Scenario, Lanelet
from mpc_tpu_torch.utils.geometry import (
    compute_pathlength_from_polyline, resample_polyline)

# Lane changes are allowed but cost extra so successor chains win when both
# exist; opposite-direction adjacency (overtaking into oncoming lane, as in
# ZAM_Over) costs more still.
_LANE_CHANGE_PENALTY = 15.0
_OPPOSITE_PENALTY = 30.0


@dataclasses.dataclass
class Route:
    lanelet_ids: List[int]
    # edge kind connecting lanelet i -> i+1: 'succ' | 'adj'
    edge_kinds: List[str]
    reference_path: np.ndarray  # (n, 2)


def _lanelet_length(l: Lanelet) -> float:
    seg = np.diff(l.center_vertices, axis=0)
    return float(np.sum(np.hypot(seg[:, 0], seg[:, 1])))


def _oriented_center(l: Lanelet, reverse: bool) -> np.ndarray:
    return l.center_vertices[::-1] if reverse else l.center_vertices


def _edges(scn: Scenario, lid: int):
    """Yield (neighbor_id, cost, kind, reverse_geometry)."""
    l = scn.lanelets[lid]
    for s in l.successors:
        if s in scn.lanelets:
            yield s, _lanelet_length(scn.lanelets[s]), "succ", False
    for adj, same in ((l.adj_left, l.adj_left_same_direction),
                      (l.adj_right, l.adj_right_same_direction)):
        if adj is not None and adj in scn.lanelets:
            pen = _LANE_CHANGE_PENALTY if same else _OPPOSITE_PENALTY
            yield adj, pen, "adj", not same


def shortest_route(scn: Scenario, start_id: int,
                   goal_ids: List[int]) -> Tuple[List[int], List[str]]:
    """Dijkstra over the lanelet digraph to the nearest goal lanelet."""
    goal_set = set(goal_ids)
    dist = {start_id: 0.0}
    prev: Dict[int, Tuple[int, str]] = {}
    pq = [(0.0, start_id)]
    visited = set()
    while pq:
        d, lid = heapq.heappop(pq)
        if lid in visited:
            continue
        visited.add(lid)
        if lid in goal_set:
            ids, kinds = [lid], []
            while ids[-1] in prev:
                p, kind = prev[ids[-1]]
                ids.append(p)
                kinds.append(kind)
            return ids[::-1], kinds[::-1]
        for nbr, cost, kind, _rev in _edges(scn, lid):
            nd = d + cost
            if nd < dist.get(nbr, np.inf):
                dist[nbr] = nd
                prev[nbr] = (lid, kind)
                heapq.heappush(pq, (nd, nbr))
    raise ValueError(
        f"No route from lanelet {start_id} to any of {goal_ids}")


def _smoothstep(t: np.ndarray) -> np.ndarray:
    t = np.clip(t, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _project_arclength(path: np.ndarray, point: np.ndarray) -> float:
    """Arc-length coordinate of the nearest point of ``path`` to ``point``."""
    s = compute_pathlength_from_polyline(path)
    d2 = np.sum((path - point.reshape(1, 2)) ** 2, axis=1)
    return float(s[int(np.argmin(d2))])


def _blend_lane_change(path: np.ndarray,
                       target_center: np.ndarray) -> np.ndarray:
    """Blend an existing path onto an adjacent lanelet's centerline.

    The blend begins where the target lanelet starts (projection of its first
    vertex onto the path) — the earlier portion of the path (e.g. the
    predecessor lanelet's centerline) is left untouched — and reaches full
    weight at the path end, producing the diagonal lane-change sweep the
    reference's route planner emits for adjacent-lanelet routes.  Points are
    matched by normalized arc length over the blend window.
    """
    s_path = compute_pathlength_from_polyline(path)
    s_tgt = compute_pathlength_from_polyline(target_center)
    total = s_path[-1]
    if total <= 0:
        return target_center.copy()
    s_start = _project_arclength(path, target_center[0])
    span = max(total - s_start, 1e-9)
    w = _smoothstep((s_path - s_start) / span)
    # arc-length parameterized correspondence over the blend window
    t = np.clip((s_path - s_start) / span, 0.0, 1.0)
    tx = np.interp(t * s_tgt[-1], s_tgt, target_center[:, 0])
    ty = np.interp(t * s_tgt[-1], s_tgt, target_center[:, 1])
    out = path.copy()
    out[:, 0] = (1 - w) * path[:, 0] + w * tx
    out[:, 1] = (1 - w) * path[:, 1] + w * ty
    return out


def plan_route(scn: Scenario, init_position: np.ndarray,
               goal_position: Optional[np.ndarray],
               goal_lanelets: List[int]) -> Route:
    """Plan a route and render its reference path.

    Mirrors the consumed behavior of
    ``RoutePlanner(...).plan_routes().retrieve_first_route()``
    (``configuration.py:508-515``): returns one route and its reference-path
    polyline.  The polyline is resampled at ~1 m spacing before being handed
    to the config layer, which clips and resamples it again
    (``configuration.py:518, 547-549``).
    """
    containing = scn.find_lanelets_by_position(init_position)
    start_id = containing[0] if containing else scn.nearest_lanelet(
        init_position)

    if goal_lanelets:
        goal_ids = list(goal_lanelets)
    elif goal_position is not None:
        g = scn.find_lanelets_by_position(goal_position)
        goal_ids = g if g else [scn.nearest_lanelet(goal_position)]
    else:
        # no goal at all (the shipped ZAM_Tutorial-1_2_T-1 planning problem
        # has no goalState): lane-following fallback — walk the successor
        # chain from the start lanelet to the network edge and route there
        chain_end, seen = start_id, {start_id}
        while True:
            succs = [s for s in scn.lanelets[chain_end].successors
                     if s in scn.lanelets and s not in seen]
            if not succs:
                break
            chain_end = succs[0]
            seen.add(chain_end)
        goal_ids = [chain_end]

    ids, kinds = shortest_route(scn, start_id, goal_ids)

    # Render: walk the route, concatenating successor centerlines and
    # blending across lane-change edges.
    first = scn.lanelets[ids[0]]
    path = first.center_vertices.copy()
    cur_reversed = False
    for i, kind in enumerate(kinds):
        nxt_id = ids[i + 1]
        cur = scn.lanelets[ids[i]]
        nxt = scn.lanelets[nxt_id]
        if kind == "succ":
            nxt_pts = _oriented_center(nxt, cur_reversed)
            # drop duplicated joint vertex
            if np.allclose(path[-1], nxt_pts[0], atol=1e-6):
                nxt_pts = nxt_pts[1:]
            path = np.vstack([path, nxt_pts])
        else:  # lane change: blend the tail of the path onto the neighbor
            same = (cur.adj_left == nxt_id and cur.adj_left_same_direction) \
                or (cur.adj_right == nxt_id and cur.adj_right_same_direction)
            reverse = not same
            tgt = _oriented_center(nxt, reverse ^ cur_reversed)
            # orient target to run in the same direction as the path
            if np.linalg.norm(tgt[0] - path[0]) > np.linalg.norm(
                    tgt[-1] - path[0]):
                tgt = tgt[::-1]
            path = _blend_lane_change(path, tgt)
    path = resample_polyline(path, step=1.0)
    return Route(lanelet_ids=ids, edge_kinds=kinds, reference_path=path)
