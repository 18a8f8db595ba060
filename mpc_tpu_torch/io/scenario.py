"""Minimal CommonRoad scenario XML reader (``mpc_tpu.io.scenario``).

Reads what the planner consumes from a CommonRoad 2018b/2020a file with
``xml.etree`` and NumPy: the lanelet polylines and graph topology, the
obstacle rectangles and their recorded states, and the planning problem's
initial and goal states.  It takes the place of ``commonroad-io``'s
``CommonRoadFileReader``.
"""
from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Lanelet:
    id: int
    left_vertices: np.ndarray    # (n, 2)
    right_vertices: np.ndarray   # (n, 2)
    center_vertices: np.ndarray  # (n, 2)
    predecessors: List[int]
    successors: List[int]
    adj_left: Optional[int] = None
    adj_left_same_direction: bool = True
    adj_right: Optional[int] = None
    adj_right_same_direction: bool = True

    def contains_point(self, p: np.ndarray) -> bool:
        """Point-in-lanelet via the quad strip between left/right bounds."""
        lv, rv = self.left_vertices, self.right_vertices
        n = min(len(lv), len(rv))
        for i in range(n - 1):
            quad = np.array([lv[i], lv[i + 1], rv[i + 1], rv[i]])
            if _point_in_polygon(p, quad):
                return True
        return False


def _point_in_polygon(p: np.ndarray, poly: np.ndarray) -> bool:
    x, y = p
    inside = False
    n = len(poly)
    j = n - 1
    for i in range(n):
        xi, yi = poly[i]
        xj, yj = poly[j]
        if (yi > y) != (yj > y):
            x_cross = (xj - xi) * (y - yi) / (yj - yi) + xi
            if x < x_cross:
                inside = not inside
        j = i
    return inside


@dataclasses.dataclass
class RectangleShape:
    length: float
    width: float


@dataclasses.dataclass
class ObstacleState:
    position: np.ndarray  # (2,)
    orientation: float
    time_step: int
    velocity: float = 0.0


@dataclasses.dataclass
class Obstacle:
    id: int
    role: str              # 'static' | 'dynamic'
    type: str
    shape: RectangleShape
    initial_state: ObstacleState
    trajectory: List[ObstacleState] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class GoalState:
    """Goal description.

    position_center: rectangle-center goal, or None for lanelet goals (the
    reference then falls back to the route end,
    ``configuration.py:593-600``).
    """

    position_center: Optional[np.ndarray]
    position_lanelets: List[int]
    time_start: int
    time_end: Optional[int]
    orientation_interval: Optional[Tuple[float, float]] = None


@dataclasses.dataclass
class PlanningProblem:
    id: int
    initial_position: np.ndarray
    initial_velocity: float
    initial_orientation: float
    initial_acceleration: float
    initial_yaw_rate: float
    goal: GoalState


@dataclasses.dataclass
class Scenario:
    benchmark_id: str
    dt: float
    lanelets: Dict[int, Lanelet]
    obstacles: List[Obstacle]
    planning_problems: List[PlanningProblem]

    def find_lanelets_by_position(self, p: np.ndarray) -> List[int]:
        return [lid for lid, l in self.lanelets.items()
                if l.contains_point(np.asarray(p))]

    def nearest_lanelet(self, p: np.ndarray) -> int:
        """Fallback: lanelet with the closest centerline point."""
        p = np.asarray(p)
        best, best_d = None, np.inf
        for lid, l in self.lanelets.items():
            d = np.min(np.sum((l.center_vertices - p) ** 2, axis=1))
            if d < best_d:
                best, best_d = lid, d
        return best


def _points(elem) -> np.ndarray:
    pts = [(float(pt.find("x").text), float(pt.find("y").text))
           for pt in elem.findall("point")]
    return np.asarray(pts)


def _exact_or_mid(elem, default=0.0) -> float:
    if elem is None:
        return default
    e = elem.find("exact")
    if e is not None:
        return float(e.text)
    lo = elem.find("intervalStart")
    hi = elem.find("intervalEnd")
    if lo is not None and hi is not None:
        return 0.5 * (float(lo.text) + float(hi.text))
    return default


def _parse_lanelet(elem) -> Lanelet:
    left = _points(elem.find("leftBound"))
    right = _points(elem.find("rightBound"))
    n = min(len(left), len(right))
    center = 0.5 * (left[:n] + right[:n])
    adj_l = elem.find("adjacentLeft")
    adj_r = elem.find("adjacentRight")
    return Lanelet(
        id=int(elem.get("id")),
        left_vertices=left,
        right_vertices=right,
        center_vertices=center,
        predecessors=[int(e.get("ref")) for e in elem.findall("predecessor")],
        successors=[int(e.get("ref")) for e in elem.findall("successor")],
        adj_left=int(adj_l.get("ref")) if adj_l is not None else None,
        adj_left_same_direction=(
            adj_l is None or adj_l.get("drivingDir", "same") == "same"),
        adj_right=int(adj_r.get("ref")) if adj_r is not None else None,
        adj_right_same_direction=(
            adj_r is None or adj_r.get("drivingDir", "same") == "same"),
    )


def _parse_state(elem) -> ObstacleState:
    pos_elem = elem.find("position")
    point = pos_elem.find("point") if pos_elem is not None else None
    if point is not None:
        pos = np.array([float(point.find("x").text),
                        float(point.find("y").text)])
    else:
        pos = np.zeros(2)
    return ObstacleState(
        position=pos,
        orientation=_exact_or_mid(elem.find("orientation")),
        time_step=int(_exact_or_mid(elem.find("time"))),
        velocity=_exact_or_mid(elem.find("velocity")),
    )


def _parse_obstacle(elem) -> Obstacle:
    role = elem.findtext("role", "static").strip()
    otype = elem.findtext("type", "unknown").strip()
    rect = elem.find("shape/rectangle")
    if rect is not None:
        shape = RectangleShape(length=float(rect.findtext("length")),
                               width=float(rect.findtext("width")))
    else:
        # circles/polygons are approximated by their bounding box role; the
        # planner only consumes rectangles (configuration.py:472-476)
        shape = RectangleShape(length=0.0, width=0.0)
    init = _parse_state(elem.find("initialState"))
    traj = [_parse_state(s)
            for s in elem.findall("trajectory/state")]
    return Obstacle(id=int(elem.get("id")), role=role, type=otype,
                    shape=shape, initial_state=init, trajectory=traj)


def _parse_planning_problem(elem) -> PlanningProblem:
    init = elem.find("initialState")
    pos = init.find("position/point")
    initial_position = np.array([float(pos.find("x").text),
                                 float(pos.find("y").text)])
    # goalState may be absent entirely (e.g. the shipped-but-unconfigured
    # ZAM_Tutorial-1_2_T-1.xml has a planning problem with no goal); fall
    # back to an open-ended goal so the scenario still parses
    goal_elem = elem.find("goalState")
    center = None
    lanelet_refs: List[int] = []
    t_start, t_end, ori_iv = 0, None, None
    if goal_elem is not None:
        gpos = goal_elem.find("position")
        if gpos is not None:
            rect = gpos.find("rectangle")
            if rect is not None and rect.find("center") is not None:
                c = rect.find("center")
                center = np.array([float(c.findtext("x")),
                                   float(c.findtext("y"))])
            lanelet_refs = [int(e.get("ref"))
                            for e in gpos.findall("lanelet")]
        t = goal_elem.find("time")
        if t is not None:
            t_start = int(float(t.findtext("intervalStart",
                                           t.findtext("exact", "0"))))
            t_end_txt = t.findtext("intervalEnd")
            t_end = int(float(t_end_txt)) if t_end_txt is not None else None
        ori = goal_elem.find("orientation")
        if ori is not None and ori.find("intervalStart") is not None:
            ori_iv = (float(ori.findtext("intervalStart")),
                      float(ori.findtext("intervalEnd")))
    return PlanningProblem(
        id=int(elem.get("id")),
        initial_position=initial_position,
        initial_velocity=_exact_or_mid(init.find("velocity")),
        initial_orientation=_exact_or_mid(init.find("orientation")),
        initial_acceleration=_exact_or_mid(init.find("acceleration")),
        initial_yaw_rate=_exact_or_mid(init.find("yawRate")),
        goal=GoalState(position_center=center,
                       position_lanelets=lanelet_refs,
                       time_start=t_start, time_end=t_end,
                       orientation_interval=ori_iv),
    )


def load_scenario(path: str) -> Scenario:
    """Parse a CommonRoad 2018b/2020a XML file."""
    root = ET.parse(path).getroot()
    lanelets = {}
    for e in root.findall("lanelet"):
        l = _parse_lanelet(e)
        lanelets[l.id] = l
    obstacles = [_parse_obstacle(e) for e in root.findall("obstacle")]
    # 2020a uses separate staticObstacle/dynamicObstacle tags
    obstacles += [_parse_obstacle(e) for e in root.findall("staticObstacle")]
    obstacles += [_parse_obstacle(e) for e in root.findall("dynamicObstacle")]
    problems = [_parse_planning_problem(e)
                for e in root.findall("planningProblem")]
    return Scenario(
        benchmark_id=root.get("benchmarkID", ""),
        dt=float(root.get("timeStepSize", "0.1")),
        lanelets=lanelets,
        obstacles=obstacles,
        planning_problems=problems,
    )
