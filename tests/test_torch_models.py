"""The port's model and solver data layer against the JAX package.

Inputs are made from a seed with numpy and handed to both packages; the
port runs on the CPU.  Also checks that the port never imports JAX or the
JAX package (and runs without them:
``tests/test_torch_port_jax_blocked.py``).
"""
import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.models import constraints as JC
from mpc_tpu.models import costs as JCO
from mpc_tpu.models import dynamics as JD
from mpc_tpu.models import vehicle as JV
from mpc_tpu.ops import sqp as JS
from mpc_tpu_torch import convert
from mpc_tpu_torch.models import constraints as TC
from mpc_tpu_torch.models import costs as TCO
from mpc_tpu_torch.models import dynamics as TD
from mpc_tpu_torch.ops import sqp as TS

ROOT = Path(__file__).resolve().parents[1]
WB = 2.578
ATOL = 1e-5  # float32 on both sides; same formulas, possibly other order


def _xu(seed, n=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    x[:, 3] = rng.uniform(0.0, 25.0, n)          # speed
    x[:, 2] = rng.uniform(-0.5, 0.5, n)          # steering angle
    u = rng.normal(size=(n, 2)).astype(np.float32)
    return x, u


def _close(jax_out, torch_out, atol=ATOL):
    np.testing.assert_allclose(torch_out.numpy(), np.asarray(jax_out),
                               rtol=1e-5, atol=atol)


def test_ks_ode_matches_jax():
    x, u = _xu(0)
    _close(JD.ks_ode(jnp.asarray(x), jnp.asarray(u), WB),
           TD.ks_ode(torch.from_numpy(x), torch.from_numpy(u), WB))


@pytest.mark.parametrize("integrator", ["rk4", "euler"])
def test_discrete_steps_match_jax(integrator):
    x, u = _xu(1)
    j = {"rk4": JD.rk4_step, "euler": JD.euler_step}[integrator]
    step = TD.make_step_fn(integrator, 0.1, WB)
    _close(j(jnp.asarray(x), jnp.asarray(u), 0.1, WB),
           step(torch.from_numpy(x), torch.from_numpy(u)))
    _close(JD.make_step_fn(integrator, 0.1, WB)(jnp.asarray(x),
                                                jnp.asarray(u)),
           step(torch.from_numpy(x), torch.from_numpy(u)))


def test_st_step_is_not_ported_yet():
    """The ST model's step (ported since this test's name was given): RK4
    and Euler match JAX's ``make_step_fn(..., 'st')`` on lifted states,
    and the step still needs its vehicle."""
    x, u = _xu(3)
    x7 = JD.ks_to_st_state(jnp.asarray(x), WB, JV.VEHICLE_2.b)
    veh = convert.vehicle(JV.VEHICLE_2)
    for integrator in ("rk4", "euler"):
        ref = JD.make_step_fn(integrator, 0.1, WB, "st", JV.VEHICLE_2)(
            x7, jnp.asarray(u))
        got = TD.make_step_fn(integrator, 0.1, WB, model="st", vehicle=veh)(
            torch.from_numpy(np.asarray(x7)), torch.from_numpy(u))
        assert got.shape == (16, 7)
        _close(ref, got, atol=2e-5)
    with pytest.raises(ValueError, match="vehicle"):
        TD.make_step_fn("rk4", 0.1, WB, model="st")


def test_ks_to_st_state_matches_jax():
    x, _ = _xu(2)
    _close(JD.ks_to_st_state(jnp.asarray(x), WB, 1.42),
           TD.ks_to_st_state(torch.from_numpy(x), WB, 1.42))


@pytest.mark.parametrize("length,width", [
    (4.508, 1.610), (6.0, 3.5), (4.8, 2.0), (0.0, 0.0), (3.0, 1.0)])
def test_approx_circle_radius_matches_jax(length, width):
    assert (TC.approx_circle_radius(length, width)
            == JC.approx_circle_radius(length, width))


def test_circle_centers_match_jax():
    rng = np.random.default_rng(3)
    x, y, psi = (rng.normal(size=8).astype(np.float32) for _ in range(3))
    _close(JC.circle_centers(jnp.asarray(x), jnp.asarray(y), 6.0, 3.5,
                             jnp.asarray(psi)),
           TC.circle_centers(torch.from_numpy(x), torch.from_numpy(y), 6.0,
                             3.5, torch.from_numpy(psi)))


def test_box_bounds_match_jax():
    for form in ("forcespro", "casadi"):
        tb = TC.make_box_bounds(convert.vehicle(JV.VEHICLE_2), form)
        jb = JC.make_box_bounds(JV.VEHICLE_2, form)
        assert dataclasses.asdict(tb) == dataclasses.asdict(jb)
        for t, j in zip(tb.as_arrays(), jb.as_arrays()):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_weights_from_dict_match_jax():
    from mpc_tpu.utils.synthetic import ZAM_LIKE_WEIGHTS
    tw = TCO.Weights.from_dict(ZAM_LIKE_WEIGHTS)
    jw = JCO.Weights.from_dict(ZAM_LIKE_WEIGHTS)
    for f in ("q", "r", "qN"):
        np.testing.assert_array_equal(getattr(tw, f).numpy(),
                                      np.asarray(getattr(jw, f)))
    with pytest.raises(KeyError):
        TCO.Weights.from_dict({"weight_x": 1.0})


@pytest.mark.parametrize("kw", [
    dict(), dict(formulation="casadi", integrator="euler"),
    dict(boundary_rows=True), dict(horizon=3, alphas=[1.0, 0.5])])
def test_row_scales_nrows_init_state_match_jax(kw):
    kw = {"horizon": 7, **kw}
    jcfg = JS.SolverConfig(**kw)
    tcfg = TS.SolverConfig(**kw)
    assert TS.nrows(tcfg) == JS.nrows(jcfg)
    np.testing.assert_array_equal(TS.row_scales(tcfg).numpy(),
                                  np.asarray(JS.row_scales(jcfg)))
    js, ts = JS.init_state(jcfg), TS.init_state(tcfg)
    for f in JS.SqpState._fields:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    tb = TS.init_state(tcfg, batch=3)
    assert tb.mu.shape == (3,) + tuple(js.mu.shape)


def test_solver_config_fields_defaults_and_checks_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(JS.SolverConfig)
          if f.default is not dataclasses.MISSING}
    tf = {f.name: f.default for f in dataclasses.fields(TS.SolverConfig)
          if f.default is not dataclasses.MISSING}
    assert jf == tf
    assert ([f.name for f in dataclasses.fields(JS.SolverConfig)]
            == [f.name for f in dataclasses.fields(TS.SolverConfig)])
    # list -> tuple coercion keeps the config hashable
    cfg = TS.SolverConfig(horizon=5, alphas=[1.0, 0.1], ip_alphas=[1.0])
    assert cfg.alphas == (1.0, 0.1) and cfg.ip_alphas == (1.0,)
    hash(cfg)
    for bad in (dict(horizon=0), dict(horizon=3, integrator="rk2"),
                dict(horizon=3, model="dyn"), dict(horizon=3, model="st"),
                dict(horizon=3, formulation="x"),
                dict(horizon=3, lqr_backend="x"),
                dict(horizon=3, method="x"), dict(horizon=3, engine="x"),
                dict(horizon=3, sqp_iters=0)):
        with pytest.raises(ValueError):
            JS.SolverConfig(**bad)
        with pytest.raises(ValueError):
            TS.SolverConfig(**bad)


def test_convert_solver_config_round_trips():
    jcfg = JS.SolverConfig(horizon=9, model="st", vehicle=JV.VEHICLE_2,
                           alphas=(1.0, 0.3), formulation="casadi")
    tcfg = convert.solver_config(jcfg)
    assert tcfg.vehicle.b == JV.VEHICLE_2.b
    assert tcfg.vehicle.tire.p_ky1 == JV.VEHICLE_2.tire.p_ky1
    assert dataclasses.asdict(tcfg.bounds) == dataclasses.asdict(jcfg.bounds)
    assert tcfg == dataclasses.replace(
        tcfg, **{k: v for k, v in dataclasses.asdict(jcfg).items()
                 if k not in ("bounds", "vehicle")})


def _ocp_np(H, B, seed):
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(B, 5)).astype(np.float32)
    x0[:, 3] += 12.0
    return dict(
        x0=x0, x_ref=rng.normal(size=(B, H + 1, 5)).astype(np.float32),
        obs_centers=rng.normal(size=(B, 3, 2)).astype(np.float32),
        min_dist=np.full((B,), 3.3, np.float32),
        weights=dict(q=rng.uniform(size=(B, 5)).astype(np.float32),
                     r=rng.uniform(size=(B, 2)).astype(np.float32),
                     qN=rng.uniform(size=(B, 5)).astype(np.float32)))


@pytest.mark.parametrize("model", ["ks", "st"])
def test_normalize_params_matches_jax(model):
    H, B = 4, 3
    d = _ocp_np(H, B, 5)
    kw = dict(horizon=H, model=model)
    if model == "st":
        kw["vehicle"] = JV.VEHICLE_2
    jcfg = JS.SolverConfig(**kw)
    jp = JS.OcpParams(
        x0=jnp.asarray(d["x0"]), x_ref=jnp.asarray(d["x_ref"]),
        obs_centers=jnp.asarray(d["obs_centers"]),
        min_dist=jnp.asarray(d["min_dist"]),
        weights=JCO.Weights(**{k: jnp.asarray(v)
                               for k, v in d["weights"].items()}))
    jn = JS.normalize_params(jcfg, jp)
    tn = TS.normalize_params(convert.solver_config(jcfg),
                             convert.ocp_params(d))
    for f in ("x0", "x_ref", "obs_centers", "min_dist"):
        _close(getattr(jn, f), getattr(tn, f))
    for f in ("q", "r", "qN"):
        _close(getattr(jn.weights, f), getattr(tn.weights, f))


def _port_sources():
    return sorted((ROOT / "mpc_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "chip_ab.py"]


def test_port_imports_neither_jax_nor_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|mpc_tpu)(\s|\.|$)",
                     re.MULTILINE)
    for path in _port_sources():
        assert path.exists(), path
        hits = pat.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"
