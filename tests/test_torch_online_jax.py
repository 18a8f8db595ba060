"""The port's online planners against the JAX package's on the same
measured states: a B=2 fleet for 3 steps, two ST steps from 5-column
states (the serving step and the rest: ``tests/test_torch_online.py``)."""
import dataclasses
import os

import numpy as np

from mpc_tpu_torch.planner.online import BatchedOnlinePlanner, OnlinePlanner

from asset_paths import CFG, SCN
from test_torch_online import IP_2X6, LF_PAIR, _forcespro, _measured


def _jax_forcespro(name):
    from mpc_tpu.io.config import load_config as jax_load_config
    c = jax_load_config(os.path.join(CFG, name), SCN)
    return dataclasses.replace(c, framework="forcespro")


def test_batched_online_planner_equals_jax():
    """from_scenarios on the ZAM and USA lanes (B=2, ip 2x6) and the JAX
    package's BatchedOnlinePlanner fed the same measured states for 3
    steps: U within the closed-loop band (5e-3) and equal status codes at
    every step."""
    from mpc_tpu.planner import online as jon
    ref = jon.BatchedOnlinePlanner.from_scenarios(
        [_jax_forcespro(n) for n in LF_PAIR], **IP_2X6)
    fleet = BatchedOnlinePlanner.from_scenarios(
        [_forcespro(n) for n in LF_PAIR], device="cpu", **IP_2X6)
    assert fleet.lcfg.solver.horizon <= 12
    x0, rng = fleet.params.x_init.numpy(), np.random.default_rng(0)
    for k in range(3):
        x = _measured(x0, fleet.lcfg.solver.dt, k, rng)
        u, info = fleet.step(x)
        ju, jinfo = ref.step(x)
        np.testing.assert_allclose(u, ju, rtol=0, atol=5e-3, err_msg=k)
        np.testing.assert_array_equal(info.status, jinfo.status)


def test_st_online_step_equals_jax():
    """OnlinePlanner on model='st' (the ZAM LF config, forcespro: the IP
    solve) and the JAX package's, two steps from 5-column KS measurements:
    the same lifted 7-state, U within 5e-3, equal status codes."""
    from mpc_tpu.models.vehicle import VEHICLE_2 as JV2
    from mpc_tpu.planner import online as jon
    from mpc_tpu_torch.models.vehicle import VEHICLE_2
    name = LF_PAIR[0]
    ref = jon.OnlinePlanner(dataclasses.replace(
        _jax_forcespro(name), dynamics_model="st", vehicle=JV2))
    planner = OnlinePlanner(dataclasses.replace(
        _forcespro(name), dynamics_model="st", vehicle=VEHICLE_2),
        device="cpu")
    assert planner.lcfg.solver.horizon <= 12
    x0, rng = planner.params.x_init[:5].numpy(), np.random.default_rng(1)
    for k in range(2):
        x = _measured(x0, planner.lcfg.solver.dt, k, rng)
        u, info = planner.step(x)
        ju, jinfo = ref.step(x)
        assert info.planned_x.shape == (7,)
        np.testing.assert_allclose(info.planned_x, jinfo.planned_x,
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(u, ju, rtol=0, atol=5e-3, err_msg=k)
        assert info.status == jinfo.status
