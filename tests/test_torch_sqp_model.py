"""The model functions of the port's ``ops.sqp`` (CPU) against the JAX
package's at one lane: the stage rows (boundary rows
included), the stagewise quadratic, the linearized dynamics and the KKT
residuals; and the engine they feed, with boundary rows.
``tests/test_torch_sqp_vec.py`` holds the engine's other cases."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.ops import sqp as JS
from mpc_tpu_torch import convert
from mpc_tpu_torch.ops import sqp as TS
from tests.test_torch_fused_gn import ocp_numpy
from tests.test_torch_sqp_vec import (check_solve_case, jax_ocp,
                                      with_boundaries)


def lane(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


def state_numpy(H, nr, B, seed):
    """A warm-ish state: inputs near the box and active multipliers."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(U=(0.2 * rng.standard_normal((B, H, 2))).astype(f32),
                lam_lo=np.abs(rng.standard_normal((B, H + 1, nr))).astype(f32),
                lam_hi=np.abs(rng.standard_normal((B, H + 1, nr))).astype(f32),
                mu=np.full((B, H + 1, nr), 10.0, f32),
                prev_viol=np.zeros((B, H + 1, nr), f32))


@pytest.mark.parametrize("formulation,boundary", [
    ("forcespro", True), ("casadi", False)], ids=["forcespro-boundaries",
                                                  "casadi"])
def test_model_functions_match_jax_at_one_lane(formulation, boundary):
    """_all_rows, _build_quadratic, _linearize_dynamics and _kkt_residuals
    at a lane whose rows are active: the rows exactly, the quadratics and
    the stationarity in float32 rounding."""
    H, B = 6, 2
    jcfg = JS.SolverConfig(horizon=H, formulation=formulation,
                           integrator="rk4" if formulation == "forcespro"
                           else "euler", boundary_rows=boundary)
    d = ocp_numpy(H, B, seed=2)
    if boundary:
        d = with_boundaries(d)
    s = state_numpy(H, JS.nrows(jcfg), B, seed=3)
    tcfg = convert.solver_config(jcfg)
    tp = convert.ocp_params(d)
    ts = {k: torch.from_numpy(v) for k, v in s.items()}
    jp = lane(jax_ocp(d))
    js = {k: jnp.asarray(v[0]) for k, v in s.items()}
    jit = jax.jit  # op-by-op dispatch of these functions takes far longer
    jX = jit(JS._rollout, static_argnums=0)(jcfg, jp.x0, js["U"])
    tX = TS._rollout(tcfg, tp.x0, ts["U"])
    np.testing.assert_allclose(tX[0].numpy(), np.asarray(jX), rtol=1e-5,
                               atol=1e-4)
    X = torch.from_numpy(np.broadcast_to(np.asarray(jX), tX.shape).copy())

    jh, jlo, jhi = jit(JS._all_rows, static_argnums=0)(jcfg, jX, js["U"],
                                                        jp)
    th, tlo, thi = TS._all_rows(tcfg, X, ts["U"], tp)
    assert th.shape == (B, H + 1, JS.nrows(jcfg))
    np.testing.assert_allclose(th[0].numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tlo[0].numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi[0].numpy(), np.asarray(jhi))

    args = (js["lam_lo"], js["lam_hi"], js["mu"])
    targs = (ts["lam_lo"], ts["lam_hi"], ts["mu"])
    jq, jQH, jqH = jit(JS._build_quadratic, static_argnums=0)(
        jcfg, jX, js["U"], jp, *args)
    tq, tQH, tqH = TS._build_quadratic(tcfg, X, ts["U"], tp, *targs)
    for f in ("Q", "R", "M", "qx", "qu"):
        a, b = getattr(tq, f)[0].numpy(), np.asarray(getattr(jq, f))
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max(), err_msg=f)
    np.testing.assert_allclose(tQH[0].numpy(), np.asarray(jQH), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(tqH[0].numpy(), np.asarray(jqH), rtol=1e-4,
                               atol=1e-3)

    jd = jit(JS._linearize_dynamics, static_argnums=0)(jcfg, jX, js["U"])
    td = TS._linearize_dynamics(tcfg, X, ts["U"])
    for f in ("A", "B", "r"):
        np.testing.assert_allclose(getattr(td, f)[0].numpy(),
                                   np.asarray(getattr(jd, f)), rtol=1e-5,
                                   atol=1e-5)

    jstat, jviol = jit(JS._kkt_residuals, static_argnums=0)(
        jcfg, jp, jX, js["U"], *args)
    tstat, tviol = TS._kkt_residuals(tcfg, tp, X, ts["U"], *targs)
    assert bool(torch.isfinite(tstat).all())
    np.testing.assert_allclose(float(tstat[0]), float(jstat), rtol=1e-4)
    np.testing.assert_allclose(float(tviol[0]), float(jviol), rtol=1e-5,
                               atol=1e-6)


def test_solve_batch_vec_with_boundary_rows_matches_jax():
    check_solve_case("boundary-rows")
