"""The rows-native AL solve (``ops.sqp_rows``) against the JAX package's
``tools/ablation/sqp_rows.py`` and against the port's per-lane solve.

The JAX module's Gauss-Newton steps read the multipliers and penalties
the solve started with (its ``gn_iter`` closes over them, not over the
outer carry), so from the second AL iteration on it parts from its own
contract; the port reads the current ones.  The two are held together at
``al_iters=1``, and the port to ``sqp.solve_batch`` at more.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from mpc_tpu.ops import sqp as JS
from mpc_tpu_torch import convert
from mpc_tpu_torch.ops import sqp as TS
from mpc_tpu_torch.ops import sqp_rows as TR
from tests.test_torch_fused_gn import (assert_solutions_close, jax_ocp,
                                       jax_state, ocp_numpy)

ROOT = Path(__file__).resolve().parents[1]
CASADI = dict(formulation="casadi", integrator="euler",
              use_terminal_cost=False)


@pytest.fixture(scope="module")
def jax_rows():
    spec = importlib.util.spec_from_file_location(
        "sqp_rows", ROOT / "tools" / "ablation" / "sqp_rows.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_layout_round_trip():
    x = torch.arange(2 * 3 * 5.0).reshape(2, 3, 5)
    rows = TR.to_rows(x)
    assert rows.shape == (5, 3, 2) and float(rows[4, 2, 1]) == float(
        x[1, 2, 4])
    assert torch.equal(TR.from_rows(rows, (5,)), x)


@pytest.mark.parametrize("kw", [dict(), CASADI], ids=["forcespro-rk4",
                                                      "casadi-euler"])
def test_rows_solve_matches_jax(jax_rows, kw):
    """One AL iteration of 2 Gauss-Newton steps with the default ladder
    (H=6, 3 lanes): the bands of tests/test_fused_gn.py, equal status,
    the merit within 1e-3 relative."""
    H, B = 6, 3
    jcfg = JS.SolverConfig(horizon=H, al_iters=1, sqp_iters=2, **kw)
    d = ocp_numpy(H, B, seed=4)
    ref = jax_rows.solve_batch_rows(jcfg, jax_ocp(d), jax_state(jcfg, B))
    tcfg = convert.solver_config(jcfg)
    got = TR.solve_batch_rows(tcfg, convert.ocp_params(d),
                              TS.init_state(tcfg, batch=B))
    assert_solutions_close(got, ref)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    np.testing.assert_allclose(got.merit.numpy(), np.asarray(ref.merit),
                               rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("kw", [dict(al_iters=2, sqp_iters=2),
                                dict(al_iters=2, sqp_iters=1, **CASADI)],
                         ids=["forcespro-2x2", "casadi-2x1"])
def test_rows_solve_matches_per_lane_solve(kw):
    """More AL iterations: the per-lane ``sqp.solve_batch`` on the same
    lanes, at the same bands and the warm state's.  ``viol`` is not
    compared: here, as in the JAX module, it is the largest raw row
    violation, where ``sqp.solve_batch`` scales the friction row by its
    bound (``sqp.row_scales``)."""
    H, B = 6, 3
    cfg = TS.SolverConfig(horizon=H, **kw)
    ocp = convert.ocp_params(ocp_numpy(H, B, seed=4))
    got = TR.solve_batch_rows(cfg, ocp, TS.init_state(cfg, batch=B))
    ref = TS.solve_batch(cfg, ocp, TS.init_state(cfg, batch=B),
                         device="cpu")
    assert_solutions_close(got, ref._replace(viol=got.viol))
    np.testing.assert_allclose(got.merit.numpy(), ref.merit.numpy(),
                               rtol=1e-3, atol=1e-2)


def test_rows_solve_hands_ip_to_the_per_lane_path():
    cfg = TS.SolverConfig(horizon=4, method="ip", ip_sqp_iters=1,
                          ip_iters=2)
    ocp = convert.ocp_params(ocp_numpy(4, 2))
    got = TR.solve_batch_rows(cfg, ocp, TS.init_state(cfg, batch=2))
    ref = TS.solve_batch(cfg, ocp, TS.init_state(cfg, batch=2), device="cpu")
    assert torch.equal(got.U, ref.U)
