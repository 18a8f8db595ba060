"""The ST model against the JAX package: its ODE, step and the step's
linearization, the nx=7 sweep, the xla engine, both fused solves' plain
versions against JAX's interpret-mode kernels and with road-boundary rows,
and the soft-st and hard-st closed loops (the kernels' helpers and the
rest: ``tests/test_torch_st.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from mpc_tpu.models import dynamics as JD
from mpc_tpu.models.vehicle import VEHICLE_2 as JV2
from mpc_tpu.ops import fused_gn as JF
from mpc_tpu.ops import fused_ip as JFI
from mpc_tpu.ops import riccati as JR
from mpc_tpu.ops import riccati_vec as JRV
from mpc_tpu.ops import sqp as JS
from mpc_tpu.ops import sqp_vec as JSV
from mpc_tpu.planner import closed_loop as jcl
from mpc_tpu.utils import synthetic as jsyn
from mpc_tpu_torch import convert
from mpc_tpu_torch.models import dynamics as TD
from mpc_tpu_torch.models.vehicle import VEHICLE_2 as TV2
from mpc_tpu_torch.ops import fused_gn as TF
from mpc_tpu_torch.ops import fused_ip as TFI
from mpc_tpu_torch.ops import riccati_vec as TRV
from mpc_tpu_torch.ops import sqp_vec as TSV
from mpc_tpu_torch.planner import closed_loop as tcl
from torch_corridors import corridor_ocp, straight_corridor
from torch_corridors import jax_ocp as jax_corridor_ocp
from tests.test_torch_fused_gn import (assert_solutions_close, jax_ocp,
                                       jax_state, ocp_numpy)
from tests.test_torch_fused_ip import (assert_ip_solutions_close,
                                       ip_ocp_numpy)
from torch_st_cases import ST, _close, states


def test_st_ode_and_steps_match_jax():
    x, u = states()
    jx, ju, tx, tu = (jnp.asarray(x), jnp.asarray(u), torch.from_numpy(x),
                      torch.from_numpy(u))
    _close(JD.st_ode(jx, ju, JV2), TD.st_ode(tx, tu, TV2), atol=2e-6)
    for integ in ("rk4", "euler"):
        jstep = JD.make_step_fn(integ, 0.1, JV2.wheelbase, "st", JV2)
        tstep = TD.make_step_fn(integ, 0.1, TV2.wheelbase, "st", TV2)
        _close(jstep(jx, ju), tstep(tx, tu))
        # JAX's linearization of every lane in one compiled program
        jlin = jax.jit(jax.vmap(lambda a, b: JD.linearize_step(jstep, a, b)))
        for b, ref in enumerate(zip(*jlin(jx, ju))):
            A, Bm, c = TD.linearize_step(tstep, tx[b], tu[b])
            assert A.shape == (7, 7) and Bm.shape == (7, 2)
            for r, got in zip(ref, (A, Bm, c)):
                _close(r, got, rtol=2e-4, atol=2e-5)


def test_plain_sweep_at_seven_states_matches_jax():
    quad, QH, qH, dyn = cs.random_lqr(np.random.default_rng(7), 4, 8, nx=7)
    jq = JR.StageQuad(*[jnp.asarray(t.numpy()) for t in quad])
    jd = JR.LinDyn(*[jnp.asarray(t.numpy()) for t in dyn])
    ref = JRV.backward_pass_vec(jq, jnp.asarray(QH.numpy()),
                                jnp.asarray(qH.numpy()), jd, 1e-6)
    got = TRV.backward_pass_vec(quad, QH, qH, dyn, 1e-6, device="cpu")
    assert got.K.shape == (4, 8, 2, 7)
    for f, (rtol, atol) in (("K", (2e-3, 2e-3)), ("d", (2e-3, 2e-3)),
                            ("dV1", (1e-2, 0.0)), ("dV2", (1e-2, 0.0))):
        _close(getattr(ref, f), getattr(got, f), rtol=rtol, atol=atol)


def test_xla_engine_matches_jax():
    """sqp_vec on the ST model (KS-schema params widened by
    normalize_params) against JAX's solve_batch_vec, as
    tests/test_st_model.py:88-105 holds JAX's own."""
    H, B = 8, 4
    jcfg = JS.SolverConfig(horizon=H, sqp_iters=2, al_iters=2, **ST)
    d = ocp_numpy(H, B, seed=3)
    jst = jax_state(jcfg, B)
    ref = JSV.solve_batch_vec_jit(jcfg, jax_ocp(d), jst)
    got = TSV.solve_batch_vec(convert.solver_config(jcfg),
                              convert.ocp_params(d), convert.sqp_state(jst),
                              device="cpu")
    assert got.X.shape == (B, H + 1, 7)
    assert_solutions_close(got, ref)


def test_fused_al_plain_matches_jax_kernel_interpret():
    """The AL plain version on ST against JAX's Pallas kernel in interpret
    mode (the bench point, 1x1 unguarded; the interpreter compiles the
    dual-number kernel for tens of seconds), in the bands of
    tests/test_fused_gn.py:42-55, all 7 columns of X."""
    H, B = 4, 2
    jcfg = JS.SolverConfig(horizon=H, al_iters=1, sqp_iters=1, alphas=(),
                           **ST)
    d = ocp_numpy(H, B, seed=1)
    jst = jax_state(jcfg, B)
    ref = JF.solve_batch_fused(jcfg, jax_ocp(d), jst, interpret=True)
    got = TF.solve_batch_fused(convert.solver_config(jcfg),
                               convert.ocp_params(d), convert.sqp_state(jst),
                               device="cpu")
    assert got.X.shape == (B, H + 1, 7)
    assert_solutions_close(got, ref)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))


def test_fused_ip_plain_matches_jax_kernel_interpret():
    """The IP plain version on ST against JAX's Pallas IP kernel in
    interpret mode, in the bands of tests/test_fused_ip.py:41-57."""
    H, B = 4, 2
    jcfg = JS.SolverConfig(horizon=H, method="ip", ip_sqp_iters=1,
                           ip_iters=1, **ST)
    d = ip_ocp_numpy(H, B, seed=3)
    jst = jax_state(jcfg, B)
    ref = JFI.solve_batch_fused_ip(jcfg, jax_ocp(d), jst, interpret=True)
    got = TFI.solve_batch_fused_ip(convert.solver_config(jcfg),
                                   convert.ocp_params(d),
                                   convert.sqp_state(jst), device="cpu")
    assert got.X.shape == (B, H + 1, 7)
    assert_ip_solutions_close(got, ref)


@pytest.mark.parametrize("method", ["al", "ip"])
def test_fused_plain_with_boundary_rows_matches_jax(method):
    """Both plain versions on ST with the road-boundary rows (the straight
    corridor of tests/test_torch_boundary_rows.py, whose left edge binds;
    the rows' models are exact on a straight edge) against the JAX
    package's own solves of the same problem: its xla engine (AL) and its
    vmapped per-lane IP (the spec tests/test_fused_ip.py holds the IP
    kernel to); at this speed the low-speed branch, where the two slip
    rates differ, is not reached."""
    H, B = 8, 3
    fields = (dict(al_iters=2, sqp_iters=2, alphas=()) if method == "al"
              else dict(method="ip", ip_sqp_iters=2, ip_iters=6))
    jcfg = JS.SolverConfig(horizon=H, boundary_rows=True, **fields, **ST)
    d = corridor_ocp(H, B, *straight_corridor(B, 2.5, -4.0, n=64))
    jp = jax_corridor_ocp(d)
    jst = jax_state(jcfg, B)
    tocp = convert.ocp_params(d)
    tcfg = convert.solver_config(jcfg)
    if method == "al":
        ref = JSV.solve_batch_vec_jit(jcfg, jp, jst)
        got = TF.solve_batch_fused(tcfg, tocp, convert.sqp_state(jst),
                                   device="cpu")
        assert_solutions_close(got, ref, state=False)
        lam = got.state.lam_lo
    else:
        ref = JS.solve_batch(jcfg, jp, jst)
        got = TFI.solve_batch_fused_ip(tcfg, tocp, convert.sqp_state(jst),
                                       device="cpu")
        assert_ip_solutions_close(got, ref)
        lam = got.state.lam_lo
    assert got.X.shape == (B, H + 1, 7)
    assert bool((lam[..., TF.NR:] > 0).any())      # a boundary row binds


def _loops(**kw):
    """JAX's and the port's loops of 12 steps on the bench's track (100
    steps long: on a track as short as the loop the obstacle lies within a
    horizon of the start, where the unguarded 1x1 loop turns chaotic), one
    cold start (JAX compiles each one into the loop's program)."""
    lcfg, lp = jsyn.make_bench_loop(n_steps=100, horizon=10, n_lanes=3,
                                    cold_start_solves=1, **kw, **ST)
    lcfg = dataclasses.replace(lcfg, n_steps=12)
    ref = jcl.closed_loop_batch_vec(lcfg, lp)
    got = tcl.closed_loop_batch_vec(convert.loop_config(lcfg),
                                    convert.loop_params(lp), device="cpu")
    return ref, got


@pytest.mark.parametrize("row", ["soft-st", "hard-st"])
def test_st_closed_loops_match_jax(row):
    """The soft-st (al 1x1, alphas=()) and hard-st (ip 1x4, warm duals,
    ip_alphas=()) rows on the overtake workload against JAX's loops (on
    the CPU its xla engine and its vmapped per-lane IP), as
    tests/test_st_model.py:107-129 runs JAX's: X 5e-2, U 5e-3, equal
    feasibility, every step feasible."""
    kw = (dict(method="al", al_iters=1, sqp_iters=1, alphas=())
          if row == "soft-st" else
          dict(method="ip", ip_sqp_iters=1, ip_iters=4, ip_warm_duals=True,
               ip_alphas=()))
    ref, got = _loops(**kw)
    assert got.X.shape == (3, 12, 7)
    err_x = np.abs(np.asarray(ref.X) - got.X.numpy()).max()
    err_u = np.abs(np.asarray(ref.U) - got.U.numpy()).max()
    print(f"{row} closed loop max abs err: X {err_x:.3g}  U {err_u:.3g}")
    assert err_x < 5e-2 and err_u < 5e-3
    np.testing.assert_array_equal(got.status.numpy() >= 0,
                                  np.asarray(ref.status) >= 0)
    assert bool((got.status >= 0).all())
