"""The port's fused IP-RTI solve (plain version, CPU) against the JAX
package's Pallas IP kernel itself, run in interpret mode as
``tests/test_fused_ip.py`` runs it on the CPU.  One small case: the
interpreter takes tens of seconds even at H=6."""
from mpc_tpu.ops import fused_ip as JFI
from mpc_tpu.ops import sqp as JS
from mpc_tpu_torch import convert
from mpc_tpu_torch.ops import fused_ip as TFI
from tests.test_torch_fused_ip import (assert_ip_solutions_close, ip_ocp_numpy,
                                       jax_ocp, jax_state)


def test_plain_matches_jax_kernel_interpret():
    H, B = 6, 2
    jcfg = JS.SolverConfig(horizon=H, method="ip", ip_sqp_iters=1,
                           ip_iters=2)
    d = ip_ocp_numpy(H, B, seed=3)
    jst = jax_state(jcfg, B)
    ref = JFI.solve_batch_fused_ip(jcfg, jax_ocp(d), jst, interpret=True)
    got = TFI.solve_batch_fused_ip(convert.solver_config(jcfg),
                                   convert.ocp_params(d),
                                   convert.sqp_state(jst), device="cpu")
    assert_ip_solutions_close(got, ref)
