"""The port's scenario-to-trajectory path on the CPU: the ``MPCPlanner``
facade and its artifacts, the CLI, and the metrics, collision checks and
native library against the JAX package's.  The float64 loop against the
committed regression goldens is ``tests/test_torch_planner_goldens.py``."""
import json
import os
import subprocess
import sys

import numpy as np

from mpc_tpu.utils import collision as jcol
from mpc_tpu.utils import metrics as jmet
from mpc_tpu.utils import native as jnative
from mpc_tpu_torch.io.config import load_config
from mpc_tpu_torch.planner.planner import MPCPlanner
from mpc_tpu_torch.utils import collision as tcol
from mpc_tpu_torch.utils import metrics as tmet
from mpc_tpu_torch.utils import native as tnative

from asset_paths import CFG, SCN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_planner_facade_and_artifacts(tmp_path):
    """As tests/test_planner.py:61-78, and the loop cut into one-step
    chunks (the per-step timing) equal to the loop run whole."""
    c = load_config(os.path.join(CFG, "config_LF_ZAM_Over-1_1.yaml"), SCN)
    planner = MPCPlanner(c, noised=False, device="cpu")
    result = planner.plan()
    assert result.states.shape == (30, 5)
    assert not result.collided_obstacle
    assert not result.collided_boundary
    assert result.rmsd is not None and result.rmsd["x"] < 0.4
    assert result.solve_time.shape == (30,) and (result.solve_time > 0).all()
    whole = planner.plan(per_step_timing=False)
    np.testing.assert_array_equal(whole.states, result.states)
    np.testing.assert_array_equal(whole.status, result.status)
    d = planner.save_artifacts(result, str(tmp_path))
    for f in ["planned states.txt", "control inputs.txt", "solve time.txt",
              "deviation.txt", "RMSD.txt"]:
        assert os.path.exists(os.path.join(d, f)), f
    g = np.loadtxt(os.path.join(d, "planned states.txt"))
    np.testing.assert_allclose(g, result.states)


def _cli(*args, timeout=600):
    """The CLI in a subprocess, on one torch thread: the suite's workers
    share the host's cores, and a plan on the CPU gains nothing from
    torch's default of a thread a core."""
    return subprocess.run(
        [sys.executable, "-m", "mpc_tpu_torch.planner.cli", "--device",
         "cpu", "--scenario-dir", SCN, *args],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="1"))


def test_cli_smoke(tmp_path):
    proc = _cli("--config", os.path.join(CFG, "config_LF_ZAM_Over-1_1.yaml"),
                "--deterministic", "--out", str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout)
    assert summary["steps"] == 30 and summary["device"] == "cpu"
    assert summary["collided_obstacle"] is False
    assert summary["native"] is True
    assert all(int(k) >= 0 for k in summary["solver_status_counts"])
    out = os.path.join(str(tmp_path), "2D_plots_casadi_{}_lane_following"
                       .format(summary["scenario"]), "planned states.txt")
    assert np.loadtxt(out).shape == (30, 5)


def test_cli_rti1_smoke():
    """--rti1 on the deployment config: collision-free and every step
    feasible under its applied-prefix gate; a casadi config is refused."""
    proc = _cli("--config", os.path.join(
        CFG, "config_CA_ZAM_Over-1_1_forcespro.yaml"), "--deterministic",
        "--rti1")
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout)
    assert summary["collided_obstacle"] is False
    assert summary["collided_boundary"] is False
    bad = _cli("--config", os.path.join(CFG, "config_LF_ZAM_Over-1_1.yaml"),
               "--rti1", timeout=120)
    assert bad.returncode == 1
    assert "requires a forcespro-framework config" in bad.stderr
    missing = _cli("--config", os.path.join(CFG, "no_such.yaml"),
                   timeout=120)
    assert missing.returncode == 1 and "no such file" in missing.stderr


def _traj(n=20, y=0.0, v=10.0, dt=0.1, nx=5):
    states = np.zeros((n, nx))
    states[:, 0] = 5.0 + v * dt * np.arange(n)
    states[:, 1] = y
    states[:, 3] = v
    return states


def test_metrics_equal_jax():
    rng = np.random.default_rng(0)
    states = _traj()
    states[:, :2] += rng.normal(scale=0.3, size=(20, 2))
    ref = np.stack([5.0 + np.arange(25.0), 0.1 * np.arange(25.0)], 1)
    assert tmet.rmsd_xy(states, ref) == jmet.rmsd_xy(states, ref)
    np.testing.assert_array_equal(tmet.deviation_euclidean(states, ref),
                                  jmet.deviation_euclidean(states, ref))
    st = rng.uniform(1e-3, 3e-3, size=30)
    assert tmet.solve_time_stats(st) == jmet.solve_time_stats(st)


def test_collision_equal_jax():
    rng = np.random.default_rng(1)
    states = _traj()
    states[:, 4] = rng.normal(scale=0.1, size=20)
    for center, theta in [((12.0, 0.0), 0.0), ((12.0, 2.2), 0.4),
                          ((12.0, 8.0), 0.0)]:
        assert tcol.trajectory_collides_obstacle(
            states, 4.3, 1.8, np.asarray(center), 6.0, 3.5, theta) == \
            jcol.trajectory_collides_obstacle(
                states, 4.3, 1.8, np.asarray(center), 6.0, 3.5, theta)
    for y in (0.7, 1.2, 5.0):
        boundary = np.array([[0.0, y], [15.0, y + 0.3], [30.0, y]])
        assert tcol.trajectory_crosses_boundary(states, 4.3, 1.8, boundary) \
            == jcol.trajectory_crosses_boundary(states, 4.3, 1.8, boundary)
    assert tcol.rectangles_collide([0, 0], 4, 2, np.pi / 4, [2.0, 2.0], 2, 2,
                                   0.0)


def test_native_equals_python_and_jax():
    """The library built into build/native/ answers every entry point as
    its Python version and as the JAX package's bindings do; 7-column ST
    states are read by their KS columns."""
    assert tnative.available()
    assert str(tnative.lib_path()).startswith(os.path.join(ROOT, "build"))
    rng = np.random.default_rng(2)
    states = _traj()
    states[:, 4] = rng.normal(scale=0.05, size=20)
    path = np.stack([np.linspace(0.0, 40.0, 30),
                     np.sin(np.linspace(0.0, 3.0, 30))], 1)
    for center, want in [((12.0, 0.0), True), ((12.0, 8.0), False)]:
        step = tnative.traj_obstacle_collision(states, 4.3, 1.8, center, 6.0,
                                               3.5, 0.0)
        hit, py_step = tcol.trajectory_collides_obstacle(
            states, 4.3, 1.8, np.asarray(center), 6.0, 3.5, 0.0)
        assert (step >= 0) == want == hit
        assert step == (py_step if hit else -1)
        assert step == jnative.traj_obstacle_collision(
            states, 4.3, 1.8, center, 6.0, 3.5, 0.0)
    for boundary in (np.array([[0.0, 0.7], [30.0, 0.7]]),
                     np.array([[0.0, 5.0], [30.0, 5.0]])):
        step = tnative.traj_boundary_collision(states, 4.3, 1.8, boundary)
        hit, py_step = tcol.trajectory_crosses_boundary(states, 4.3, 1.8,
                                                        boundary)
        assert step == (py_step if hit else -1)
        assert step == jnative.traj_boundary_collision(states, 4.3, 1.8,
                                                       boundary)
    assert tnative.traj_boundary_collision(states, 4.3, 1.8, None) == -1
    np.testing.assert_allclose(tnative.deviation_to_path(states, path),
                               tmet.deviation_euclidean(states, path),
                               atol=1e-12)
    # the JAX package's library is built with -O3 -march=native: the last
    # bit may differ
    s, d = tnative.curvilinear_project(path, states[:, :2])
    js, jd = jnative.curvilinear_project(path, states[:, :2])
    np.testing.assert_allclose(s, js, rtol=0, atol=1e-12)
    np.testing.assert_allclose(d, jd, rtol=0, atol=1e-12)
    st7 = np.concatenate([states, rng.normal(size=(20, 2))], 1)
    assert tnative.traj_obstacle_collision(st7, 4.3, 1.8, (12.0, 0.0), 6.0,
                                           3.5, 0.0) == \
        tnative.traj_obstacle_collision(states, 4.3, 1.8, (12.0, 0.0), 6.0,
                                        3.5, 0.0)
    np.testing.assert_array_equal(tnative.deviation_to_path(st7, path),
                                  tnative.deviation_to_path(states, path))
