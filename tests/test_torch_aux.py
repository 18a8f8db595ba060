"""The port's support modules on the CPU: checkpoint and resume of a loop's
carry, the solve-time comparison, profiling, the plots and the GIF, and
the CLI's ``--out`` plots, ``--profile-dir`` and ``--debug-nans``
(tests/test_aux.py)."""
import dataclasses
import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from mpc_tpu.utils import compare as jcompare
from mpc_tpu_torch.io.config import load_config
from mpc_tpu_torch.planner import cli
from mpc_tpu_torch.planner import closed_loop as cl
from mpc_tpu_torch.planner.planner import MPCPlanner, PlanResult
from mpc_tpu_torch.utils import checkpoint as ck
from mpc_tpu_torch.utils import compare
from mpc_tpu_torch.utils import profiling
from mpc_tpu_torch.utils import synthetic

from asset_paths import CFG, GOLD, SCN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LF_ZAM = os.path.join(CFG, "config_LF_ZAM_Over-1_1.yaml")


def bench(lanes, noise):
    lcfg, lp = synthetic.make_bench_loop(n_steps=6, horizon=6,
                                         n_lanes=lanes, device="cpu",
                                         al_iters=1, sqp_iters=2)
    return dataclasses.replace(lcfg, cold_start_solves=1,
                               noise_std=noise), lp


def per_lane(lcfg, lp):
    """One lane's carry and chunk runner (closed_loop_chunk)."""
    one = lp.map(lambda t: t[0])
    return (cl.init_carry(lcfg, one, "cpu"),
            lambda c, n: cl.closed_loop_chunk(lcfg, one, c, n, "cpu"))


def serving(lcfg, lp):
    """The batched serving carry and a chain of closed_loop_batch_step."""
    def run(c, n):
        outs = []
        for _ in range(n):
            c, out = cl.closed_loop_batch_step(lcfg, lp, c, device="cpu")
            outs.append(out)
        return c, cl.LoopResult(*(torch.stack(f, 1) for f in zip(*outs)))
    return cl.init_batch_carry(lcfg, lp, "cpu"), run


@pytest.mark.parametrize("make,lanes,noise", [
    (per_lane, 1, 0.0), (per_lane, 1, 0.1), (serving, 3, 0.1),
], ids=["per-lane", "per-lane-noised", "serving-noised"])
def test_checkpoint_resume_is_the_uninterrupted_run(tmp_path, make, lanes,
                                                    noise):
    """A run cut at step 3, saved, restored and resumed equals the run
    made in one go at atol 0; with noise the generator's state is carried
    across."""
    lcfg, lp = bench(lanes, noise)
    carry, run = make(lcfg, lp)
    carry, r1 = run(carry, 3)
    ck.save_checkpoint(str(tmp_path), carry, 3)
    assert ck.latest_step(str(tmp_path)) == 3
    assert os.path.exists(tmp_path / "step_00000003.pt")
    restored = ck.restore_checkpoint(str(tmp_path), carry)
    assert restored[0] == 3
    for a, b in zip(carry[1:3], restored[1:3]):
        for x, y in zip(torch.utils._pytree.tree_leaves(a),
                        torch.utils._pytree.tree_leaves(b)):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert (restored[3] is None) == (noise == 0.0)
    _, r2 = run(restored, 3)
    _, full = run(make(lcfg, lp)[0], 6)
    dim = 0 if make is per_lane else 1
    for f in ("X", "U", "status"):
        assert torch.equal(torch.cat([getattr(r1, f), getattr(r2, f)], dim),
                           getattr(full, f)), f


def test_restore_without_checkpoints_raises(tmp_path):
    assert ck.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ck.restore_checkpoint(str(tmp_path), (torch.zeros(1),))


def test_compare_equals_jax_on_the_reference_artifacts(tmp_path):
    dirs = {d: os.path.join(GOLD, d) for d in sorted(os.listdir(GOLD))}
    assert len(dirs) == 6
    assert compare.compare_solve_times(dirs) == \
        jcompare.compare_solve_times(dirs)
    stats = compare.compare_solve_times(dirs)
    assert 30 < stats["2D_plots_casadi_ZAM_Over-1_1_lane_following"][
        "p50_ms"] < 50
    pytest.importorskip("matplotlib")
    png = compare.plot_solve_time_comparison(dirs, str(tmp_path / "c.png"))
    assert os.path.getsize(png) > 0


def test_profiling_timers():
    def f(x):
        return {"a": x * 2.0, "b": (x.sum(), None)}

    x = torch.ones((64, 64))
    assert profiling.time_jitted(f, x, reps=3) > 0.0
    assert profiling._scalarize(f)(x).item() == 2 * 4096 + 4096
    assert profiling.breakdown([("double", f, (x,))], reps=2)["double"] > 0
    np.testing.assert_allclose(profiling.solve_time_series(0.3, 30),
                               np.full(30, 0.01))


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones((8, 8)) @ torch.ones((8, 8))
    (path,) = glob.glob(str(tmp_path / "trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())


def _fake_result(T=5):
    gold = np.loadtxt(os.path.join(ROOT, "tests", "goldens",
                                   "zam_lf_casadi_states.txt"))[:T]
    return PlanResult(states=gold, inputs=np.zeros((T, 2)),
                      solve_time=np.full(T, 1e-3), status=np.ones(T, int),
                      rmsd={"x": 0.1, "y": 0.1}, deviation=np.zeros(T),
                      collided_obstacle=False, collided_boundary=False,
                      wall_time_s=5e-3)


def test_viz_writes_the_plots_and_the_gif(tmp_path):
    """The port's plots carry the JAX package's four file names; the GIF
    has a frame a step."""
    pytest.importorskip("matplotlib")
    from PIL import Image

    from mpc_tpu.io.config import load_config as jload
    from mpc_tpu.utils import viz as jviz
    from mpc_tpu_torch.io.scenario import load_scenario
    from mpc_tpu_torch.utils import viz

    c = load_config(LF_ZAM, SCN)
    r = _fake_result()
    viz.plot_analysis(c, r.states, r.inputs, r.solve_time, r.deviation,
                      str(tmp_path / "port"))
    jviz.plot_analysis(jload(LF_ZAM, SCN), r.states, r.inputs, r.solve_time,
                       r.deviation, str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "port"))
    assert len(names) == 4 and names == sorted(os.listdir(tmp_path / "jax"))
    gif = viz.render_gif(c, r.states, str(tmp_path), load_scenario(
        os.path.join(SCN, c.scenario_name + ".xml")))
    with Image.open(gif) as im:
        assert im.n_frames == len(r.states)


def test_drawing_without_matplotlib_names_it(monkeypatch):
    from mpc_tpu_torch.utils import viz
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        viz.pyplot()


@pytest.fixture
def stub_plan(monkeypatch):
    """MPCPlanner.plan replaced by a few tensor ops and a fixed result:
    the CLI's wiring without a whole plan; with ``stub["nan"]`` one op
    divides 0 by 0."""
    stub = {"nan": False}

    def plan(self):
        torch.ones(4) @ torch.ones(4)
        if stub["nan"]:
            torch.zeros(3) / torch.zeros(3)
        return _fake_result()
    monkeypatch.setattr(MPCPlanner, "plan", plan)
    return stub


def _cli(*extra):
    return cli.main(["--device", "cpu", "--deterministic", "--config",
                     LF_ZAM, "--scenario-dir", SCN, *extra])


def test_cli_debug_nans_raises_on_an_injected_nan(stub_plan):
    assert _cli("--debug-nans") == 0
    stub_plan["nan"] = True
    with pytest.raises(FloatingPointError, match="aten.div"):
        _cli("--debug-nans")
    assert _cli() == 0               # off by default


def test_cli_profile_dir_writes_a_trace(stub_plan, tmp_path, capsys):
    assert _cli("--profile-dir", str(tmp_path / "prof")) == 0
    assert glob.glob(str(tmp_path / "prof" / "trace_*.json"))
    assert "profiler trace written" in capsys.readouterr().err


def test_cli_out_draws_the_plots_or_names_matplotlib(stub_plan, tmp_path,
                                                     capsys, monkeypatch):
    """--out writes the text artifacts, then the four plots (and with
    --gif the GIF); without matplotlib the text artifacts, matplotlib named
    on stderr and exit 1, as the JAX package's CLI fails there."""
    pytest.importorskip("matplotlib")
    out = tmp_path / "out"
    d = out / "2D_plots_casadi_ZAM_Over-1_1_LF_lane_following"
    assert _cli("--out", str(out), "--gif") == 0
    assert len(glob.glob(str(d / "2D_plot_*.png"))) == 4
    assert len(glob.glob(str(out / "gif_*.gif"))) == 1
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out2 = tmp_path / "out2"
    assert _cli("--out", str(out2)) == 1
    assert "matplotlib" in capsys.readouterr().err
    assert len(os.listdir(out2 / d.name)) == 5   # the text artifacts
