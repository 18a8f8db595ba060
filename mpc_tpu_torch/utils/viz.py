"""Analysis plots and the scenario GIF (``mpc_tpu.utils.viz``).

The reference's rendering pass without commonroad's renderer: lanelets,
obstacle, ego rectangle, reference path and driven trajectory drawn
directly, the plot limits from the scenario's geometry.  matplotlib (and
Pillow, which it brings, for the GIF) is imported when something is drawn,
never with the module: the planner runs where matplotlib is missing, and
drawing there raises an ``ImportError`` that names it.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from mpc_tpu_torch.io.config import PlanningConfig
from mpc_tpu_torch.io.scenario import Scenario


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend, or an ImportError naming
    matplotlib."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("drawing needs matplotlib, which is not "
                          "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _rect_patch(center, length, width, orientation, **kw):
    from matplotlib.patches import Polygon
    c, s = np.cos(orientation), np.sin(orientation)
    R = np.array([[c, -s], [s, c]])
    half = np.array([[length / 2, width / 2], [length / 2, -width / 2],
                     [-length / 2, -width / 2], [-length / 2, width / 2]])
    return Polygon(np.asarray(center).reshape(1, 2) + half @ R.T, **kw)


def plot_analysis(config: PlanningConfig, states: np.ndarray,
                  inputs: np.ndarray, solve_time: np.ndarray,
                  deviation: np.ndarray, out_dir: str) -> None:
    """The reference's four 2D analysis figures in ``out_dir``:
    ``2D_plot_{framework}_{scenario}_{use_case}_{deviation,
    control_inputs,solve_time,performance}.png``."""
    plt = pyplot()
    os.makedirs(out_dir, exist_ok=True)
    T = states.shape[0]
    t = np.arange(T) * config.delta_t
    tag = f"{config.framework}_{config.scenario_name}_{config.use_case}"

    fig = plt.figure()
    plt.plot(t, deviation)
    plt.title("deviation with reference path")
    plt.xlabel("time [s]")
    plt.ylabel("deviation in euclidean distance [m]")
    fig.savefig(os.path.join(out_dir, f"2D_plot_{tag}_deviation.png"))
    plt.close(fig)

    fig = plt.figure()
    plt.subplot(2, 1, 1)
    plt.plot(t, np.rad2deg(inputs[:, 0]), color="b")
    plt.title("steering velocity")
    plt.xlabel("time [s]")
    plt.ylabel("delta_v [deg/s]")
    plt.subplots_adjust(hspace=0.8)
    plt.subplot(2, 1, 2)
    plt.plot(t, inputs[:, 1], color="b")
    plt.title("longitudinal acceleration")
    plt.xlabel("time [s]")
    plt.ylabel("long. acc. [m/s2]")
    fig.savefig(os.path.join(out_dir, f"2D_plot_{tag}_control_inputs.png"))
    plt.close(fig)

    fig = plt.figure()
    plt.plot(np.arange(T), solve_time * 1e3, color="b")
    plt.title("Computation time over iteration")
    plt.xlabel("iteration")
    plt.ylabel("Computation time [ms]")
    fig.savefig(os.path.join(out_dir, f"2D_plot_{tag}_solve_time.png"))
    plt.close(fig)

    fig = plt.figure()
    for i, axis in enumerate("xy"):
        plt.subplot(2, 1, i + 1)
        plt.title(f"Performance in {axis}-direction")
        plt.plot(t, config.reference_path[:T, i], "r--",
                 label="reference path")
        plt.plot(t, states[:, i], "g", label="MPC planned path")
        plt.legend()
        plt.xlabel("time [s]")
        plt.ylabel(f"{axis}-position [m]")
        plt.subplots_adjust(hspace=0.8)
    fig.savefig(os.path.join(out_dir, f"2D_plot_{tag}_performance.png"))
    plt.close(fig)


def draw_scenario_frame(ax, scenario: Scenario, config: PlanningConfig,
                        states: np.ndarray, step: int,
                        horizon_preview: Optional[np.ndarray] = None):
    """Draw one closed-loop frame on ``ax``: lanelets, obstacle, reference,
    the path driven up to ``step`` and the ego there."""
    for lane in scenario.lanelets.values():
        lv, rv = lane.left_vertices, lane.right_vertices
        ax.plot(lv[:, 0], lv[:, 1], color="0.6", lw=0.8)
        ax.plot(rv[:, 0], rv[:, 1], color="0.6", lw=0.8)
        ax.fill(np.concatenate([lv[:, 0], rv[::-1, 0]]),
                np.concatenate([lv[:, 1], rv[::-1, 1]]),
                color="0.92", zorder=0)
    ob = config.static_obstacle
    if ob["length"] > 0:
        ax.add_patch(_rect_patch(
            [ob["position_x"], ob["position_y"]], ob["length"], ob["width"],
            ob["orientation"], facecolor="#1d7eb4", edgecolor="k", zorder=20))
    ax.plot(config.reference_path[:, 0], config.reference_path[:, 1],
            color="r", marker=".", markersize=1, lw=1.0, zorder=19,
            label="reference path")
    ax.plot(states[:step + 1, 0], states[:step + 1, 1], color="g", lw=1.5,
            zorder=21, label="driven")
    ax.add_patch(_rect_patch(states[step, :2], 4.3, 1.8, states[step, 4],
                             facecolor="r", edgecolor="r", zorder=22))
    if horizon_preview is not None:
        ax.plot(horizon_preview[:, 0], horizon_preview[:, 1], "m.",
                markersize=2, zorder=23)
    ax.set_aspect("equal")


def render_gif(config: PlanningConfig, states: np.ndarray, out_dir: str,
               scenario: Scenario, fps: int = 10) -> str:
    """The closed loop's animation, a frame a step, as
    ``out_dir/gif_{framework}_{scenario}_{use_case}.gif``."""
    plt = pyplot()
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    pad = 10.0
    xs = np.concatenate([config.reference_path[:, 0], states[:, 0]])
    ys = np.concatenate([config.reference_path[:, 1], states[:, 1]])
    frames = []
    for i in range(states.shape[0]):
        fig, ax = plt.subplots(figsize=(10, 4))
        draw_scenario_frame(ax, scenario, config, states, i)
        ax.set_xlim(xs.min() - pad, xs.max() + pad)
        ax.set_ylim(ys.min() - pad, ys.max() + pad)
        ax.set_title(f"{config.scenario_name} step {i}")
        fig.canvas.draw()
        frames.append(Image.fromarray(
            np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy()))
        plt.close(fig)
    gif_path = os.path.join(out_dir, "gif_{}_{}_{}.gif".format(
        config.framework, config.scenario_name, config.use_case))
    frames[0].save(gif_path, save_all=True, append_images=frames[1:],
                   duration=1000 / fps, loop=0)
    return gif_path
