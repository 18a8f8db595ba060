"""The port's fused solve (plain version, CPU) against the JAX package's
lanes-trailing reference engine ``sqp_vec.solve_batch_vec``, across the
kernel's envelope: forcespro/RK4, casadi/Euler and moving obstacles."""
import numpy as np
import pytest

from mpc_tpu.ops import sqp as JS
from mpc_tpu.ops import sqp_vec
from mpc_tpu_torch import convert
from mpc_tpu_torch.ops import fused_gn as TF
from tests.test_torch_fused_gn import (assert_solutions_close, jax_ocp,
                                       jax_state, ocp_numpy)


@pytest.mark.parametrize("formulation,integrator,moving", [
    ("forcespro", "rk4", False),
    ("casadi", "euler", False),
    ("forcespro", "rk4", True),
], ids=["forcespro-rk4", "casadi-euler", "moving-obstacle"])
def test_plain_matches_sqp_vec(formulation, integrator, moving):
    H, B = 8, 3
    jcfg = JS.SolverConfig(horizon=H, formulation=formulation,
                           integrator=integrator,
                           use_terminal_cost=formulation == "forcespro",
                           al_iters=2, sqp_iters=2)
    # seed 0: at other seeds a lane's casadi friction row lands on the kink
    # of |s| at stage 0, where the JAX kernel itself parts from sqp_vec
    d = ocp_numpy(H, B, seed=0, moving=moving)
    jst = jax_state(jcfg, B)
    ref = sqp_vec.solve_batch_vec(jcfg, jax_ocp(d), jst)
    got = TF.solve_batch_fused(convert.solver_config(jcfg),
                               convert.ocp_params(d), convert.sqp_state(jst),
                               device="cpu")
    assert_solutions_close(got, ref)
    assert np.all(np.isfinite(got.X.numpy()))
