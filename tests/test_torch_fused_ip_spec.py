"""The port's fused IP-RTI solve (plain version, CPU) against the JAX
package's executable spec, the vmapped ``sqp.solve_batch`` with
``method='ip'``, at each budget (the wrapper's guards and the build:
``tests/test_torch_fused_ip.py``)."""
import numpy as np
import pytest

from mpc_tpu.ops import sqp as JS
from mpc_tpu_torch import convert
from mpc_tpu_torch.ops import fused_ip as TFI
from tests.test_torch_fused_ip import (assert_ip_solutions_close, ip_ocp_numpy,
                                       jax_ocp, jax_state)


# (H, B, solver fields, moving obstacles, solves chained on the duals)
SPEC_CASES = {
    "cold-2x6": (9, 4, dict(ip_sqp_iters=2, ip_iters=6), False, 1),
    "warm-duals-chained": (9, 2, dict(ip_sqp_iters=1, ip_iters=6,
                                      ip_warm_duals=True), False, 2),
    "ladder-1.0": (9, 2, dict(ip_sqp_iters=1, ip_iters=4, ip_warm_duals=True,
                              ip_alphas=(1.0,)), False, 1),
    "unguarded": (9, 2, dict(ip_sqp_iters=1, ip_iters=4, ip_warm_duals=True,
                             ip_alphas=()), False, 1),
    "moving-obstacle": (8, 2, dict(ip_sqp_iters=1, ip_iters=6), True, 1),
    "casadi-euler": (8, 2, dict(ip_sqp_iters=2, ip_iters=4,
                                formulation="casadi", integrator="euler",
                                use_terminal_cost=False), False, 1),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_plain_matches_jax_spec(case):
    H, B, fields, moving, solves = SPEC_CASES[case]
    jcfg = JS.SolverConfig(horizon=H, method="ip", **fields)
    d = ip_ocp_numpy(H, B, seed=0, moving=moving)
    tcfg, tocp = convert.solver_config(jcfg), convert.ocp_params(d)
    ref_state, got_state = jax_state(jcfg, B), None
    for _ in range(solves):
        # the duals (and U) of one solve warm-start the next
        got_state = (convert.sqp_state(ref_state) if got_state is None
                     else got_state)
        ref = JS.solve_batch(jcfg, jax_ocp(d), ref_state)
        got = TFI.solve_batch_fused_ip(tcfg, tocp, got_state, device="cpu")
        ref_state, got_state = ref.state, got.state
    assert_ip_solutions_close(got, ref)
    assert np.all(np.isfinite(got.X.numpy()))
