"""Synthetic benchmark scenarios (``mpc_tpu.utils.synthetic``).

ZAM-like overtaking tracks of any length and horizon, replicated over a
batch of lanes with jittered starts: the closed-loop benchmark workload.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mpc_tpu_torch.device import resolve_device
from mpc_tpu_torch.models.constraints import circle_centers
from mpc_tpu_torch.models import dynamics as dyn_mod
from mpc_tpu_torch.models.costs import Weights
from mpc_tpu_torch.ops import sqp
from mpc_tpu_torch.planner import closed_loop as cl
from mpc_tpu_torch.planner import reference as ref_mod

ZAM_LIKE_WEIGHTS = {
    "weight_x": 2.3, "weight_y": 2.3, "weight_steering_angle": 500.0,
    "weight_velocity": 0.1, "weight_heading_angle": 160.0,
    "weight_velocity_steering_angle": 0.8, "weight_long_acceleration": 0.8,
    "weight_x_terminate": 80.0, "weight_y_terminate": 80.0,
    "weight_steering_angle_terminate": 100.0,
    "weight_velocity_terminate": 0.01,
    "weight_heading_angle_terminate": 110.0}


def _smooth01(t: np.ndarray) -> np.ndarray:
    t = np.clip(t, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def overtake_track(n_steps: int, v: float = 15.0, dt: float = 0.1
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reference path with an overtake swerve around an in-lane obstacle.

    Returns (path (T, 2), orientation (T,), obstacle_center (2,)).  The
    obstacle sits at 40% of the track, clearly below the travel line; the
    path clears it laterally by ~3.5 m.
    """
    T = n_steps
    s = np.arange(T) * v * dt
    x = 30.0 + s
    L = s[-1] if T > 1 else 1.0
    obs_s = 0.4 * L
    y = (-1.15
         + 4.15 * _smooth01((s - (obs_s - 24.0)) / 16.0)
         - 2.0 * _smooth01((s - (obs_s + 10.0)) / 15.0))
    path = np.stack([x, y], axis=1)
    seg = np.diff(path, axis=0)
    psi = np.arctan2(seg[:, 1], seg[:, 0])
    psi = np.concatenate([psi, psi[-1:]])
    obstacle = np.array([30.0 + obs_s, -1.9])
    return path, psi, obstacle


def stress_track(n_steps: int, v: float = 15.0, dt: float = 0.1,
                 offset: float = 0.9, pre_avoid: float = 1.2
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Straight lane with an in-lane obstacle ``offset`` m below the line
    whose reference swerve (``pre_avoid`` m) under-avoids it, so the
    solver itself must push the trajectory out (the budget-binding
    workload).  Returns (path (T, 2), orientation (T,), obstacle (2,)).
    """
    T = n_steps
    s = np.arange(T) * v * dt
    x = 30.0 + s
    L = s[-1] if T > 1 else 1.0
    obs_s = 0.55 * L
    y = (-1.15
         + pre_avoid * _smooth01((s - (obs_s - 24.0)) / 16.0)
         - pre_avoid * _smooth01((s - (obs_s + 10.0)) / 15.0))
    path = np.stack([x, y], axis=1)
    seg = np.diff(path, axis=0)
    psi = np.arctan2(seg[:, 1], seg[:, 0])
    psi = np.concatenate([psi, psi[-1:]])
    obstacle = np.array([30.0 + obs_s, -1.15 - offset])
    return path, psi, obstacle


def make_bench_loop(n_steps: int, horizon: int, n_lanes: int,
                    mode: str = "forcespro", dtype=torch.float32,
                    workload: str = "overtake", device=None, seed: int = 1,
                    **solver_overrides):
    """(LoopConfig, batched LoopParams) of the closed-loop benchmark.

    workload: 'overtake' (pre-avoiding reference line) or 'ca_stress'
    (:func:`stress_track`).  Lane starts are jittered in position, speed
    and heading by a numpy generator seeded with ``seed``.  Tensors are
    made on ``device`` (default: the GPU).
    """
    dev = resolve_device(device)
    v, dt = 15.0, 0.1
    track_fn = {"overtake": overtake_track,
                "ca_stress": stress_track}[workload]
    path, psi, obstacle = track_fn(n_steps + horizon + 2, v, dt)
    integ, use_term = (("rk4", True) if mode == "forcespro"
                       else ("euler", False))
    loop_kw = {k: solver_overrides.pop(k)
               for k in ("gate_stages", "rti_margin", "rti_amax_scale",
                         "cold_start_solves")
               if k in solver_overrides}
    scfg = sqp.SolverConfig(
        horizon=horizon, dt=dt, integrator=integ, formulation=mode,
        use_terminal_cost=use_term, **solver_overrides)
    loop_kw.setdefault("cold_start_solves", 4)
    lcfg = cl.LoopConfig(solver=scfg, mode=mode, n_steps=n_steps,
                         noise_std=0.0, plant_integrator=integ, **loop_kw)

    def lanes(t):
        return t.expand((n_lanes,) + t.shape)

    track = ref_mod.build_track(path, psi, v, horizon, mode, dtype,
                                dev).map(lanes)
    zero = torch.zeros((), dtype=dtype, device=dev)
    centers = circle_centers(zero + float(obstacle[0]),
                             zero + float(obstacle[1]), 6.0, 3.5, zero)
    nx = sqp.solver_nx(scfg)
    x_init = torch.tensor([path[0, 0], path[0, 1], 0.0, v, psi[0]],
                          dtype=dtype, device=dev)
    if scfg.model == "st":
        x_init = dyn_mod.ks_to_st_state(x_init, scfg.wheelbase,
                                        scfg.vehicle.b)
    scale = np.zeros(nx)
    scale[:5] = [0.5, 0.15, 0.0, 0.5, 0.01]
    rng = np.random.default_rng(seed)
    pert = torch.as_tensor(
        (rng.standard_normal((n_lanes, nx)) * scale).astype(np.float32),
        device=dev).to(dtype)
    params = cl.LoopParams(
        x_init=lanes(x_init) + pert,
        track=track,
        obs_centers=lanes(centers),
        min_dist=torch.full((n_lanes,), 3.3, dtype=dtype, device=dev),
        weights=Weights.from_dict(ZAM_LIKE_WEIGHTS, dtype, dev).map(lanes),
        noise_key=seed + torch.arange(n_lanes, device=dev)[:, None])
    return lcfg, params
