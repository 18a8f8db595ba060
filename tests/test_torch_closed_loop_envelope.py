"""The port's closed loop at the edges of its envelope, and its status gate
against the JAX package's (the rest of the closed loop:
``tests/test_torch_closed_loop.py``, ``tests/test_torch_closed_loop_jax.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.planner import closed_loop as jcl
from mpc_tpu_torch import convert
from mpc_tpu_torch.ops import sqp as TS
from mpc_tpu_torch.planner import closed_loop as tcl
from mpc_tpu_torch.utils import synthetic as tsyn


# boundary rows without boundary data raise the JAX package's ValueError
NO_DATA = (ValueError, "boundaries")


# engine='xla' reads no lqr_backend (mpc_tpu/ops/sqp_vec.py): 'pscan' is
# the 'scan' loop at atol 0
SCAN = "same loop as lqr_backend='scan'"


@pytest.mark.parametrize("solver_kw,loop_kw,raises", [
    (dict(method="ip", boundary_rows=True), {}, NO_DATA),
    (dict(boundary_rows=True), {}, NO_DATA),
    (dict(engine="xla", lqr_backend="pscan"), {}, SCAN),
    (dict(engine="xla", method="ip", ip_sqp_iters=1, ip_iters=2), {}, None),
    (dict(engine="fused", boundary_rows=True), {}, NO_DATA),
], ids=["ip", "boundary_rows", "xla-pscan", "xla-ip", "fused-boundary_rows"])
def test_out_of_envelope_raises(solver_kw, loop_kw, raises):
    """The envelope's edges: ``engine='xla'`` with ``method='ip'`` runs the
    loop on the per-lane solve (``closed_loop_batch``, as the JAX package
    falls back there); ``lqr_backend='pscan'`` on ``engine='xla'`` is the
    'scan' loop at atol 0, since that engine reads no ``lqr_backend`` (as
    in the JAX package); boundary rows without boundary data (the bench
    loop has none) raise the ``ValueError`` that the JAX package raises
    there."""
    lcfg, p = tsyn.make_bench_loop(3, 4, 2, device="cpu")
    lcfg = dataclasses.replace(
        lcfg, solver=dataclasses.replace(lcfg.solver, **solver_kw),
        **loop_kw)
    if raises == SCAN:
        scan = dataclasses.replace(lcfg, solver=dataclasses.replace(
            lcfg.solver, lqr_backend="scan"))
        got = tcl.closed_loop_batch_vec(lcfg, p, device="cpu")
        ref = tcl.closed_loop_batch_vec(scan, p, device="cpu")
        for f in tcl.LoopResult._fields:
            assert torch.equal(getattr(got, f), getattr(ref, f)), f
        return
    if raises is None:
        assert tcl.select_engine(lcfg.solver) is TS.solve_batch
        got = tcl.closed_loop_batch_vec(lcfg, p, device="cpu")
        ref = tcl.closed_loop_batch(lcfg, p, device="cpu")
        assert got.X.shape == (2, 3, 5)
        for f in tcl.LoopResult._fields:
            assert torch.equal(getattr(got, f), getattr(ref, f)), f
        return
    error, match = raises
    with pytest.raises(error, match=match):
        tcl.closed_loop_batch_vec(lcfg, p, device="cpu")


def _gate_fixture():
    """A bench OCP at H=6 over 4 lanes with the obstacle off the path, a
    feasible plan rolled out from U = 0, and the same plan with the ego put
    on the obstacle at stage 1 (lanes 1, 3) or at stage 4 (lane 2):
    (jcfg, numpy OCP, X, U)."""
    from tests.test_torch_fused_gn import ocp_numpy
    from mpc_tpu.ops import sqp as JS
    H, B = 6, 4
    jcfg = JS.SolverConfig(horizon=H)
    d = ocp_numpy(H, B, seed=0)
    d["obs_centers"] = d["obs_centers"] + np.float32(60.0)  # off the path
    U = np.zeros((B, H, 2), np.float32)
    X = np.asarray(jax.vmap(lambda x0, u: JS._rollout(jcfg, x0, u))(
        jnp.asarray(d["x0"]), jnp.asarray(U))).copy()
    X[[1, 3], 1, :2] = d["obs_centers"][[1, 3], 0]
    X[2, 4, :2] = d["obs_centers"][2, 0]
    return jcfg, d, X, U


@pytest.mark.parametrize("g", [1, 6], ids=["stages-0-1", "full-plan"])
def test_gated_status_matches_jax(g):
    """Hand-built plans: -7 becomes 0 where the gated stages are feasible
    (lane 0; lane 2 only under the stage-1 gate, its violation sits at
    stage 4), and 0 or 1 become -7 where they violate (lanes 1, 3), against
    JAX's per-lane ``_gated_status`` under vmap."""
    from mpc_tpu.ops import sqp as JS
    from tests.test_torch_fused_gn import jax_ocp
    jcfg, d, X, U = _gate_fixture()
    status = np.array([-7, 0, -7, 1], np.int32)
    B = len(status)
    z = np.zeros((B,), np.float32)
    jsol = JS.Solution(X=jnp.asarray(X), U=jnp.asarray(U), state=None,
                       status=jnp.asarray(status), kkt_stat=z, viol=z,
                       cost=z, merit=z)
    ref = jax.vmap(lambda o, s: jcl._gated_status(jcfg, o, s, g),
                   in_axes=(0, JS.Solution(0, 0, None, 0, 0, 0, 0, 0)))(
        jax_ocp(d), jsol)
    tsol = TS.Solution(X=torch.from_numpy(X), U=torch.from_numpy(U),
                       state=None, status=torch.from_numpy(status),
                       kkt_stat=None, viol=None, cost=None, merit=None)
    got = tcl._gated_status(convert.solver_config(jcfg),
                            convert.ocp_params(d), tsol, g)
    assert got.tolist() == np.asarray(ref).tolist()
    want = [0, -7, 0, -7] if g == 1 else [0, -7, -7, -7]
    assert got.tolist() == want
