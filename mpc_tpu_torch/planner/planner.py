"""Scenario-level planner facade (``mpc_tpu.planner.planner``).

``MPCPlanner`` turns a ``PlanningConfig`` into one lane's closed loop on
the per-lane solve, runs it, computes the metrics, validates the
trajectory against the obstacle and the road boundaries (the native
library where it builds, ``utils.native``) and writes the reference
planner's text artifacts (``planned states.txt``, ``control inputs.txt``,
``solve time.txt``, ``deviation.txt``, ``RMSD.txt``).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from mpc_tpu_torch.device import resolve_device
from mpc_tpu_torch.io.config import PlanningConfig
from mpc_tpu_torch.planner import closed_loop as cl
from mpc_tpu_torch.utils import metrics as met
from mpc_tpu_torch.utils import native


@dataclasses.dataclass
class PlanResult:
    states: np.ndarray        # (T, NX)
    inputs: np.ndarray        # (T, 2)
    solve_time: np.ndarray    # (T,) seconds: each step's time with the
                              # device synchronized around it, or the
                              # loop's wall time / T (per_step_timing=False)
    status: np.ndarray        # (T,)
    rmsd: Optional[Dict[str, float]]
    deviation: np.ndarray     # (T,)
    collided_obstacle: bool
    collided_boundary: bool
    wall_time_s: float


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class MPCPlanner:
    """Scenario-level planner: config in, trajectory and artifacts out.

    Runs on ``device`` (default: the GPU, see ``resolve_device``), in
    float32.
    """

    def __init__(self, config: PlanningConfig,
                 horizon: Optional[int] = None,
                 noised: Optional[bool] = None,
                 seed: int = 0, device=None, **solver_overrides):
        self.config = config
        self.device = resolve_device(device)
        self.loop_config = cl.make_loop_config(
            config, horizon=horizon, noised=noised, **solver_overrides)
        self.loop_params = cl.make_loop_params(
            config, self.loop_config, seed=seed, device=self.device)

    def plan(self, per_step_timing: bool = True) -> PlanResult:
        """Run the closed loop once and assemble the metrics.

        With ``per_step_timing`` one step runs first off the clock (the
        CUDA context and the allocator), then the loop runs from its cold
        start a step at a time, each step timed on the host with the device
        synchronized around it: the reference's timed warm solve.
        Without it the whole loop runs once and ``solve_time`` is its wall
        time / T.
        """
        cfg = self.config
        lcfg, params, dev = self.loop_config, self.loop_params, self.device
        T = lcfg.n_steps
        if per_step_timing:
            carry = cl.init_carry(lcfg, params, dev)
            cl.closed_loop_chunk(lcfg, params, carry, 1, dev)
            _sync(dev)
            carry = cl.init_carry(lcfg, params, dev)
            step_times, outs = [], []
            t_all = time.perf_counter()
            for _ in range(T):
                _sync(dev)
                t0 = time.perf_counter()
                carry, out = cl.closed_loop_chunk(lcfg, params, carry, 1,
                                                  dev)
                _sync(dev)
                step_times.append(time.perf_counter() - t0)
                outs.append(out)
            wall = time.perf_counter() - t_all
            res = cl.LoopResult(*(torch.cat(f) for f in zip(*outs)))
            solve_time = np.asarray(step_times)
        else:
            _sync(dev)
            t0 = time.perf_counter()
            res = cl.run_closed_loop(lcfg, params, dev)
            _sync(dev)
            wall = time.perf_counter() - t0
            solve_time = np.full(T, wall / T)

        X = res.X.double().cpu().numpy()
        U = res.U.double().cpu().numpy()
        rmsd = None
        if cfg.use_case == "lane_following":
            rx, ry = met.rmsd_xy(X, cfg.reference_path)
            rmsd = {"x": rx, "y": ry}
        deviation = native.deviation_to_path(X, cfg.origin_reference_path)

        ob = cfg.static_obstacle
        veh = cfg.vehicle
        if cfg.obstacle_trajectory is not None:
            # a moving obstacle: each step against its pose at that step
            traj = np.asarray(cfg.obstacle_trajectory, dtype=float)
            poses = traj[np.minimum(np.arange(T), len(traj) - 1)]
            hit_obs = any(
                native.traj_obstacle_collision(
                    X[t:t + 1], veh.l, veh.w, pose[:2], ob["length"],
                    ob["width"], pose[2]) >= 0
                for t, pose in enumerate(poses))
        else:
            hit_obs = native.traj_obstacle_collision(
                X, veh.l, veh.w, (ob["position_x"], ob["position_y"]),
                ob["length"], ob["width"], ob["orientation"]) >= 0
        hit_bnd = any(
            native.traj_boundary_collision(X, veh.l, veh.w, b) >= 0
            for b in (cfg.left_road_boundary, cfg.right_road_boundary))
        return PlanResult(
            states=X, inputs=U, solve_time=solve_time,
            status=res.status.cpu().numpy(), rmsd=rmsd, deviation=deviation,
            collided_obstacle=bool(hit_obs), collided_boundary=bool(hit_bnd),
            wall_time_s=wall)

    def save_artifacts(self, result: PlanResult, out_dir: str) -> str:
        """Write the reference's text artifacts into
        ``out_dir/2D_plots_{framework}_{scenario}_{use_case}/``."""
        cfg = self.config
        d = os.path.join(out_dir, "2D_plots_{}_{}_{}".format(
            cfg.framework, cfg.scenario_name, cfg.use_case))
        os.makedirs(d, exist_ok=True)
        np.savetxt(os.path.join(d, "planned states.txt"), result.states)
        np.savetxt(os.path.join(d, "control inputs.txt"), result.inputs)
        np.savetxt(os.path.join(d, "solve time.txt"), result.solve_time)
        np.savetxt(os.path.join(d, "deviation.txt"), result.deviation)
        if result.rmsd is not None:
            np.savetxt(os.path.join(d, "RMSD.txt"),
                       np.array([result.rmsd["x"], result.rmsd["y"]]))
        return d
