"""The port's serving API on the CPU: the batched serving step against the
batched loop at atol 0, and the online planners
(tests/test_online.py); both planners against the JAX package's on the
same measured states are ``tests/test_torch_online_jax.py``."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from mpc_tpu_torch.io.config import load_config
from mpc_tpu_torch.models import dynamics as dyn
from mpc_tpu_torch.parallel import multi
from mpc_tpu_torch.planner import closed_loop as cl
from mpc_tpu_torch.planner.online import BatchedOnlinePlanner, OnlinePlanner
from mpc_tpu_torch.utils import synthetic

from asset_paths import CFG, SCN
from test_torch_multi import FORCESPRO_FLEET, configs


def al_bench():
    """tests/test_online.py:65-92's batch (B=4, T=6, H=9, al 2x2), with
    the actuation noise on."""
    lcfg, lp = synthetic.make_bench_loop(n_steps=6, horizon=9, n_lanes=4,
                                         method="al", al_iters=2,
                                         sqp_iters=2, device="cpu")
    return dataclasses.replace(lcfg, noise_std=0.1), lp


def forcespro_fleet():
    """The four forcespro configs in one batch (ip 2x6, the ladder, boundary
    rows, moving obstacles, H=12), cut to 6 steps."""
    lcfg, lp, _ = multi.make_multi_scenario_batch(
        configs(FORCESPRO_FLEET), noised=False, device="cpu")
    return dataclasses.replace(lcfg, n_steps=6), lp


@pytest.mark.parametrize("make", [al_bench, forcespro_fleet],
                         ids=["al-noised", "forcespro-fleet"])
def test_serving_chain_reproduces_batch_vec(make):
    """closed_loop_batch_step fed no measurement reproduces
    closed_loop_batch_vec exactly: X, U and status at atol 0, the noise
    stream included."""
    lcfg, lp = make()
    ref = cl.closed_loop_batch_vec(lcfg, lp, device="cpu")
    carry = cl.init_batch_carry(lcfg, lp, device="cpu")
    outs = []
    for _ in range(lcfg.n_steps):
        carry, out = cl.closed_loop_batch_step(lcfg, lp, carry, device="cpu")
        outs.append(out)
    x, u, status = (torch.stack(f, 1) for f in list(zip(*outs))[:3])
    assert carry[0] == lcfg.n_steps
    assert torch.equal(x, ref.X) and torch.equal(u, ref.U)
    assert torch.equal(status, ref.status)


def test_online_matches_offline_closed_loop():
    """Driving OnlinePlanner with the loop's own plant reproduces the
    offline loop (tests/test_online.py:14-38): X rtol/atol 1e-4, U 1e-3."""
    c = load_config(os.path.join(CFG, "config_LF_ZAM_Over-1_1.yaml"), SCN)
    lcfg = cl.make_loop_config(c, noised=False)
    params = cl.make_loop_params(c, lcfg, device="cpu")
    _, offline = cl.closed_loop_chunk(
        lcfg, params, cl.init_carry(lcfg, params, "cpu"), 10, "cpu")
    planner = OnlinePlanner(c, device="cpu")
    plant = dyn.make_step_fn(lcfg.plant_integrator, lcfg.solver.dt,
                             lcfg.solver.wheelbase)
    x = params.x_init.numpy()
    X, U = [], []
    for _ in range(10):
        u, info = planner.step(x)
        assert info.status >= 0
        np.testing.assert_array_equal(info.planned_x, x)
        X.append(x.copy())
        U.append(u)
        x = plant(torch.as_tensor(x), torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(np.asarray(X), offline.X.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(U), offline.U.numpy(), rtol=1e-3,
                               atol=1e-3)


def test_online_handles_disturbed_measurements():
    """15 steps on the CA ZAM config with 0.05 m of position noise a step
    stay feasible, and reset() restarts cleanly (tests/test_online.py:
    41-62)."""
    c = load_config(os.path.join(CFG, "config_CA_ZAM_Over-1_1.yaml"), SCN)
    planner = OnlinePlanner(c, device="cpu")
    lcfg = planner.lcfg
    plant = dyn.make_step_fn(lcfg.plant_integrator, lcfg.solver.dt,
                             lcfg.solver.wheelbase)
    rng = np.random.default_rng(0)
    x = planner.params.x_init.numpy()
    for t in range(15):
        u, info = planner.step(x)
        assert info.status >= 0, t
        x = plant(torch.as_tensor(x), torch.as_tensor(u)).numpy()
        x[:2] += rng.normal(0, 0.05, 2)
    planner.reset()
    u, info = planner.step(planner.params.x_init)
    assert info.status >= 0 and u.shape == (2,)


def _drive(fleet, steps, rng=None):
    """``steps`` fleet steps through the RK4 plant, with 0.02 m of position
    noise a lane and step from ``rng`` when given; the final states."""
    step = dyn.make_step_fn("rk4", fleet.lcfg.solver.dt,
                            fleet.lcfg.solver.wheelbase)
    x = fleet.params.x_init.numpy()
    for k in range(steps):
        u, info = fleet.step(x)
        assert u.shape == (fleet.n_lanes, 2)
        assert (info.status >= 0).all(), (k, info.status)
        x = step(torch.as_tensor(x), torch.as_tensor(u)).numpy()
        if rng is not None:
            x[:, :2] += rng.normal(0, 0.02, (fleet.n_lanes, 2))
    return x


def _forcespro(name):
    c = load_config(os.path.join(CFG, name), SCN)
    return dataclasses.replace(c, framework="forcespro")


IP_2X6 = dict(ip_sqp_iters=2, ip_iters=6, ip_warm_duals=True)


def test_batched_online_planner_fleet():
    """A replicated fleet (B=3) on the ZAM LF scenario with per-lane
    measurement noise stays feasible and within 1.0 m of the reference
    (tests/test_online.py:95-126)."""
    c = _forcespro("config_LF_ZAM_Over-1_1.yaml")
    fleet = BatchedOnlinePlanner(c, n_lanes=3, device="cpu", **IP_2X6)
    assert fleet.n_lanes == 3 and fleet.lane_lengths is None
    x = _drive(fleet, 8, np.random.default_rng(3))
    for i in range(3):
        d = np.min(np.linalg.norm(c.reference_path - x[i, :2], axis=1))
        assert d < 1.0, (i, d)


def test_batched_online_heterogeneous_fleet():
    """from_scenarios: a ZAM lane and a USA lane served in one batch, each
    along its own reference, far apart (tests/test_online.py:129-157)."""
    cfgs = [_forcespro("config_LF_ZAM_Over-1_1.yaml"),
            _forcespro("config_LF_USA_Lanker-2_18_T-1.yaml")]
    fleet = BatchedOnlinePlanner.from_scenarios(cfgs, device="cpu", **IP_2X6)
    assert fleet.n_lanes == 2 and fleet.lane_lengths == [30, 70]
    x = _drive(fleet, 6)
    for i, c in enumerate(cfgs):
        d = np.min(np.linalg.norm(c.reference_path - x[i, :2], axis=1))
        assert d < 1.0, (i, d)
    assert np.linalg.norm(x[0, :2] - x[1, :2]) > 10.0


LF_PAIR = ("config_LF_ZAM_Over-1_1.yaml", "config_LF_USA_Lanker-2_18_T-1.yaml")


def _measured(x0, dt, k, rng):
    """Measured states for step ``k``: each lane's start coasted ``k``
    steps along its heading at its speed, with 0.02 m of position noise
    from ``rng`` (the same sequence for both planners)."""
    x = np.array(x0, np.float32)
    run = k * dt * x[..., 3]
    x[..., 0] += run * np.cos(x[..., 4])
    x[..., 1] += run * np.sin(x[..., 4])
    x[..., :2] += rng.normal(0, 0.02, x[..., :2].shape)
    return x


def test_st_planner_lifts_a_ks_measurement():
    """For model='st' a 5-column KS measurement is lifted to the 7-state
    ST state before the solve."""
    from mpc_tpu_torch.models.vehicle import VEHICLE_2
    c = load_config(os.path.join(CFG, "config_LF_ZAM_Over-1_1.yaml"), SCN)
    c = dataclasses.replace(c, dynamics_model="st", vehicle=VEHICLE_2)
    planner = OnlinePlanner(c, device="cpu")
    x = planner.params.x_init[:5].numpy()
    u, info = planner.step(x)
    want = dyn.ks_to_st_state(torch.as_tensor(x), planner.lcfg.solver.wheelbase,
                              VEHICLE_2.b)
    np.testing.assert_allclose(info.planned_x, want.numpy(), rtol=1e-6)
    assert u.shape == (2,) and info.status >= 0


def test_serving_needs_a_gpu_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CPU-only contract does not apply")
    c = load_config(os.path.join(CFG, "config_LF_ZAM_Over-1_1.yaml"), SCN)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedOnlinePlanner(c, n_lanes=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        OnlinePlanner(c)


def test_st_casadi_first_step_spread_is_the_references():
    """OnlinePlanner on model='st' with the casadi AL budget (the ZAM LF
    config): the cold first step's steering rate is ill-conditioned in
    the JAX package itself, whose float32 planner swings between the rate
    bounds (-0.4, 0.0, +0.4 rad/s) under a 1e-6 move of the measured
    state; the port's first steering rate is one of those three outcomes
    (within 1e-5), its acceleration and the step after it agree with
    JAX's within 5e-3."""
    from mpc_tpu.models.vehicle import VEHICLE_2 as JV2
    from mpc_tpu.planner import online as jon
    from mpc_tpu_torch.models.vehicle import VEHICLE_2
    name = LF_PAIR[0]
    from mpc_tpu.io.config import load_config as jax_load_config
    jc = dataclasses.replace(jax_load_config(os.path.join(CFG, name), SCN),
                             dynamics_model="st", vehicle=JV2)
    c = dataclasses.replace(load_config(os.path.join(CFG, name), SCN),
                            dynamics_model="st", vehicle=VEHICLE_2)
    planner = OnlinePlanner(c, device="cpu")
    assert c.framework == "casadi" and planner.lcfg.solver.method == "al"
    x0, rng = planner.params.x_init[:5].numpy(), np.random.default_rng(1)
    xs = [_measured(x0, planner.lcfg.solver.dt, k, rng) for k in range(2)]
    move = np.float32(1e-6) * np.array([1, 1, 0, 1, 0.1], np.float32)
    firsts, seconds = [], []
    for sign in (0.0, 1.0, -1.0):
        ref = jon.OnlinePlanner(jc)
        firsts.append(np.asarray(ref.step(xs[0] + sign * move)[0]))
        seconds.append(np.asarray(ref.step(xs[1] + sign * move)[0]))
    steer = sorted(float(u[0]) for u in firsts)
    assert steer[-1] - steer[0] >= 0.4 - 1e-6, steer   # JAX's own spread
    u, _ = planner.step(xs[0])
    assert min(abs(float(u[0]) - s) for s in steer) <= 1e-5, (u, steer)
    np.testing.assert_allclose(u[1], firsts[0][1], rtol=0, atol=5e-3)
    u, _ = planner.step(xs[1])
    np.testing.assert_allclose(u, seconds[0], rtol=0, atol=5e-3)
