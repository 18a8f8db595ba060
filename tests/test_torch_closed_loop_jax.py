"""The port's batched closed loop (CPU) against the JAX package's loops:
the soft bench row on the fused and xla engines, the status gate and the
RTI backoffs, the hard bench row, and C2's second half, the xla loop with
method='ip' (the reference windows, the benchmark workload and the
envelope guards: ``tests/test_torch_closed_loop.py``)."""
import dataclasses

import numpy as np
import pytest
import torch

from mpc_tpu.planner import closed_loop as jcl
from mpc_tpu.utils import synthetic as jsyn
from mpc_tpu_torch import convert
from mpc_tpu_torch.planner import closed_loop as tcl


H_LOOP, B_LOOP, T_LOOP = 10, 4, 20


def jax_loop(**kw):
    """JAX's make_bench_loop at the bench budget (al 1x1, the unguarded
    step) on the non-chaotic overtake workload, and its closed loop (on the
    CPU its lanes-trailing XLA engine, sqp_vec)."""
    lcfg, lp = jsyn.make_bench_loop(n_steps=T_LOOP, horizon=H_LOOP,
                                    n_lanes=B_LOOP, method="al", al_iters=1,
                                    sqp_iters=1, alphas=(), **kw)
    return lcfg, lp, jcl.closed_loop_batch_vec(lcfg, lp)


@pytest.fixture(scope="module")
def jax_soft_loop():
    return jax_loop()


def assert_loop_close(got, ref, status="feasibility"):
    """The closed-loop bands: X 5e-2, U 5e-3, and equal feasibility (or
    equal status codes)."""
    err_x = np.abs(np.asarray(ref.X) - got.X.numpy()).max()
    err_u = np.abs(np.asarray(ref.U) - got.U.numpy()).max()
    print(f"closed loop max abs err: X {err_x:.3g}  U {err_u:.3g}")
    assert got.X.shape == (B_LOOP, T_LOOP, 5)
    assert got.status.shape == (B_LOOP, T_LOOP)
    assert err_x < 5e-2 and err_u < 5e-3
    if status == "codes":
        np.testing.assert_array_equal(got.status.numpy(),
                                      np.asarray(ref.status))
    else:
        np.testing.assert_array_equal(got.status.numpy() >= 0,
                                      np.asarray(ref.status) >= 0)


def port_loop(lcfg, lp, **solver_kw):
    tl = convert.loop_config(lcfg)
    tl = dataclasses.replace(tl, solver=dataclasses.replace(tl.solver,
                                                            **solver_kw))
    return tcl.closed_loop_batch_vec(tl, convert.loop_params(lp),
                                     device="cpu")


def test_closed_loop_matches_jax_on_the_bench_workload(jax_soft_loop):
    """Non-chaotic overtake workload at the bench budget (al 1x1, the
    unguarded step), params carried over from JAX's make_bench_loop; the
    port's fused engine (its plain version on the CPU)."""
    lcfg, lp, ref = jax_soft_loop
    assert_loop_close(port_loop(lcfg, lp), ref)


def test_xla_closed_loop_matches_jax_on_the_bench_workload(jax_soft_loop):
    """The same loop on the port's ``engine='xla'`` (sqp_vec, the plain
    sweep on the CPU), against the JAX loop, which runs its own sqp_vec on
    the CPU: the same algorithm, so the status codes agree too."""
    lcfg, lp, ref = jax_soft_loop
    assert_loop_close(port_loop(lcfg, lp, engine="xla"), ref, "codes")


@pytest.mark.parametrize("kw", [dict(gate_stages=1),
                                dict(rti_margin=0.3, rti_amax_scale=0.9)],
                         ids=["gate_stages", "backoff"])
def test_gated_and_backoff_loops_match_jax(kw):
    """The status gate on stages 0..1, and the RTI backoffs (the solver
    sees min_dist + 0.3 and 0.9 a_max; the status is re-gated over the
    full plan against the true problem), on the xla engine against JAX's
    loops with the same knobs."""
    # one cold start: JAX traces every cold-start solve into the loop's
    # program, and compiling four of them is most of this test's time
    lcfg, lp, ref = jax_loop(cold_start_solves=1, **kw)
    got = port_loop(lcfg, lp, engine="xla")
    assert_loop_close(got, ref, "codes")


def test_hard_closed_loop_matches_jax_on_the_bench_workload():
    """The hard row of the bench (ip 1x4, warm duals, the unguarded step;
    5x10 warm-ups) on the non-chaotic overtake workload, against the JAX
    loop (on the CPU its vmapped ``sqp._solve_ip``), with the soft case's
    bands."""
    H, B, T = 10, 4, 20
    lcfg, lp = jsyn.make_bench_loop(n_steps=T, horizon=H, n_lanes=B,
                                    method="ip", ip_sqp_iters=1, ip_iters=4,
                                    ip_warm_duals=True, ip_alphas=())
    ref = jcl.closed_loop_batch_vec(lcfg, lp)
    got = tcl.closed_loop_batch_vec(convert.loop_config(lcfg),
                                    convert.loop_params(lp), device="cpu")
    err_x = np.abs(np.asarray(ref.X) - got.X.numpy()).max()
    err_u = np.abs(np.asarray(ref.U) - got.U.numpy()).max()
    print(f"hard closed loop max abs err: X {err_x:.3g}  U {err_u:.3g}")
    assert got.X.shape == (B, T, 5) and got.status.shape == (B, T)
    assert err_x < 5e-2 and err_u < 5e-3
    np.testing.assert_array_equal(got.status.numpy() >= 0,
                                  np.asarray(ref.status) >= 0)


def test_xla_ip_loop_equal_jax():
    """C2, second half: ``closed_loop_batch_vec`` with engine='xla',
    method='ip' against JAX's (which falls back to ``closed_loop_batch``)
    on the non-chaotic overtake workload: X 5e-2, U 5e-3, the same
    feasibility, and ``closed_loop_batch`` itself equal to it."""
    kw = dict(method="ip", ip_sqp_iters=1, ip_iters=4, ip_warm_duals=True,
              engine="xla")
    jl, jp = jsyn.make_bench_loop(n_steps=20, horizon=10, n_lanes=4, **kw)
    ref = jcl.closed_loop_batch_vec(jl, jp)
    tl, tp = convert.loop_config(jl), convert.loop_params(jp)
    got = tcl.closed_loop_batch_vec(tl, tp, device="cpu")
    err_x = np.abs(np.asarray(ref.X) - got.X.numpy()).max()
    err_u = np.abs(np.asarray(ref.U) - got.U.numpy()).max()
    print(f"xla ip loop max abs err: X {err_x:.3g}  U {err_u:.3g}")
    assert got.X.shape == (4, 20, 5)
    assert err_x < 5e-2 and err_u < 5e-3
    np.testing.assert_array_equal(got.status.numpy() >= 0,
                                  np.asarray(ref.status) >= 0)
    again = tcl.closed_loop_batch(tl, tp, device="cpu")
    assert torch.equal(again.U, got.U)
