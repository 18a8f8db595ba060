"""The port's fused AL-SQP solve (plain version, CPU) against the JAX
package's Pallas kernel run in interpret mode, at the bench point and
with the merit ladder (the wrapper's guards:
``tests/test_torch_fused_gn.py``)."""
import numpy as np
import pytest

from mpc_tpu.ops import fused_gn as JF
from mpc_tpu.ops import sqp as JS
from mpc_tpu_torch import convert
from mpc_tpu_torch.ops import fused_gn as TF
from tests.test_torch_fused_gn import (assert_solutions_close, jax_ocp,
                                       jax_state, ocp_numpy)


@pytest.mark.parametrize("budget", [
    dict(al_iters=1, sqp_iters=1, alphas=()),          # the bench point
    # merit ladder over two AL iterations: the second one's sweep reads the
    # rows cached by the first multiplier update
    dict(al_iters=2, sqp_iters=1, alphas=(1.0, 0.25)),
], ids=["1x1-unguarded", "2x1-ladder"])
def test_plain_matches_jax_kernel_interpret(budget):
    H, B = (6, 2) if not budget["alphas"] else (4, 2)
    jcfg = JS.SolverConfig(horizon=H, **budget)
    d = ocp_numpy(H, B, seed=1)
    jst = jax_state(jcfg, B)
    ref = JF.solve_batch_fused(jcfg, jax_ocp(d), jst, interpret=True)
    got = TF.solve_batch_fused(convert.solver_config(jcfg),
                               convert.ocp_params(d), convert.sqp_state(jst),
                               device="cpu")
    assert_solutions_close(got, ref)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    np.testing.assert_allclose(got.kkt_stat.numpy(), np.asarray(ref.kkt_stat),
                               rtol=5e-2, atol=1e-3)
