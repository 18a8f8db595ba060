"""The 7-state single-track model with tire dynamics (ST) in the port (CPU)
against the JAX package: the model and its step, the kernels' dual-number
helpers, the rows-form rollout, the nx=7 sweep, the xla engine, both fused
solves' plain versions (with and without road-boundary rows) and the soft
and hard closed loops.

The CUDA kernels' ST instances (``ops/csrc/fused_gn_st.cu``,
``fused_ip_st.cu``, ``riccati.cu`` at nx=7) are held against these plain
versions by ``tests/test_torch_kernel_host.py`` (their sources compiled for
the host) and on the GPU by ``chip_smoke.py``.
"""
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
from mpc_tpu_torch.ops import sqp as TS
from mpc_tpu_torch.ops import sqp_vec as TSV
from mpc_tpu_torch.planner import closed_loop as tcl
from mpc_tpu_torch.utils import synthetic as tsyn
from tests.test_torch_boundary_rows import corridor_ocp, straight_corridor
from tests.test_torch_boundary_rows import jax_ocp as jax_corridor_ocp
from tests.test_torch_fused_gn import (assert_solutions_close, jax_ocp,
                                       jax_state, ocp_numpy)
from tests.test_torch_fused_ip import (assert_ip_solutions_close,
                                       ip_ocp_numpy)

ST = dict(model="st", vehicle=JV2)
# the slip-rate pin: a state of the low-speed branch (v = 0.05 < 0.1)
PIN_X = [0.0, 0.0, 0.3, 0.05, 0.1, 0.2, 0.01]
PIN_U = [0.2, 1.0]


def states(seed=0):
    """(B=6, 7) states and (6, 2) inputs: the tire branch at speed, the
    low-speed branch (v = 0.05, -0.05), the v_safe guard (|v| < 1e-3)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(6, 7)).astype(np.float32) * [1, 1, .2, 1, .3, .3,
                                                       .05]
    x[:, 3] = [14.0, 0.05, -0.05, 5e-4, -2e-4, 8.0]
    u = (rng.normal(size=(6, 2)) * [0.2, 1.5]).astype(np.float32)
    return x.astype(np.float32), u


def _close(ref, got, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.detach().double().numpy(),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=atol)


def test_make_bench_loop_lifts_the_st_start():
    """make_bench_loop(model='st') lifts the start to the ST state before
    the jitter, as the JAX package does: lane 0 less its jitter is JAX's
    lift of the track's first state."""
    n, seed = 3, 0
    lcfg, lp = tsyn.make_bench_loop(4, 6, n, device="cpu", seed=seed, **ST)
    assert lp.x_init.shape == (n, 7)
    scale = np.zeros(7)
    scale[:5] = [0.5, 0.15, 0.0, 0.5, 0.01]
    pert = (np.random.default_rng(seed).standard_normal((n, 7))
            * scale).astype(np.float32)
    path, psi, _ = tsyn.overtake_track(4 + 6 + 2, 15.0, 0.1)
    x5 = jnp.asarray([path[0, 0], path[0, 1], 0.0, 15.0, psi[0]],
                     jnp.float32)
    ref = JD.ks_to_st_state(x5, lcfg.solver.wheelbase, JV2.b)
    _close(ref, lp.x_init[0] - torch.from_numpy(pert[0]), atol=2e-6)


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


@pytest.mark.parametrize("integrator", ["rk4", "euler"])
def test_dual_number_helpers_match_jax(integrator):
    """The plain version's _st_step_rows and _st_lin_step against the JAX
    kernel helpers on plain arrays, in tests/test_fused_st.py's bands
    (rtol 2e-4, atol 2e-5), the low-speed branch and the guard included."""
    x, u = states(1)
    c = TF.st_consts(TV2)
    jx, ju = [jnp.asarray(r) for r in x.T], [jnp.asarray(r) for r in u.T]
    tx, tu = ([torch.from_numpy(r.copy()) for r in x.T],
              [torch.from_numpy(r.copy()) for r in u.T])
    for ref, got in zip(JF._st_step_rows(jx, ju, 0.1, JV2, integrator),
                        TF._st_step_rows(tx, tu, 0.1, c, integrator)):
        _close(ref, got, rtol=2e-4, atol=2e-5)
    (jA, jB), (tA, tB) = (JF._st_lin_step(jx, ju, 0.1, JV2, integrator),
                          TF._st_lin_step(tx, tu, 0.1, c, integrator))
    for i in range(7):
        for j in range(7):
            _close(jA[i][j], tA[i][j], rtol=2e-4, atol=2e-5)
        for j in range(2):
            _close(jB[i][j], tB[i][j], rtol=2e-4, atol=2e-5)


def test_slip_rate_of_the_kernels_and_of_the_model():
    """The reference's two slip-rate formulas in the low-speed branch: the
    kernels' helpers (fused_gn.py:398-399, 1 + (tan delta lr / l)^2) give
    0.117471, the model and the xla rows (dynamics.py:93-94, 1 + (tan^2
    delta lr / l)^2) 0.120556; the port keeps both, in both places."""
    x, u = np.asarray(PIN_X, np.float32), np.asarray(PIN_U, np.float32)
    kernel = [JF._st_ode_d([JF._Dual(jnp.asarray(v), ()) for v in x],
                           [JF._Dual(jnp.asarray(v), ()) for v in u],
                           JV2)[6].v,
              TF._st_ode_d([TF._Dual(torch.tensor(v)) for v in x],
                           [TF._Dual(torch.tensor(v)) for v in u],
                           TF.st_consts(TV2))[6].v]
    model = [JD.st_ode(jnp.asarray(x), jnp.asarray(u), JV2)[6],
             TD.st_ode(torch.from_numpy(x), torch.from_numpy(u), TV2)[6]]
    rows = TRV._ode_rows("st", TV2.wheelbase, TV2)(
        [torch.tensor(v) for v in x], [torch.tensor(v) for v in u])[6]
    for v in kernel:
        assert abs(float(v) - 0.117471) < 1e-6
    for v in model + [rows]:
        assert abs(float(v) - 0.120556) < 1e-6


def test_feedback_rollout_rows_match_jax():
    """_ode_rows('st') through feedback_rollout_vec at three alphas."""
    rng = np.random.default_rng(2)
    B, H = 3, 6
    x0 = np.concatenate([rng.normal(size=(B, 2)), rng.normal(size=(B, 1))
                         * 0.1, 14.0 + rng.normal(size=(B, 1)),
                         rng.normal(size=(B, 3)) * 0.05], 1)
    x0[0, 3] = 0.05                    # a lane of the low-speed branch
    X = np.repeat(x0[:, None], H + 1, 1) + rng.normal(size=(B, H + 1, 7)) \
        * 0.05
    U = rng.normal(size=(B, H, 2)) * 0.2
    K = rng.normal(size=(B, H, 2, 7)) * 0.1
    d = rng.normal(size=(B, H, 2)) * 0.1
    arrs = [np.asarray(a, np.float32) for a in (x0, X, U, K, d)]
    alphas = (1.0, 0.5, 0.1)
    lo, hi = (-0.4, -11.5), (0.4, 11.5)
    Xa, Ua = JRV.feedback_rollout_vec(
        None, 0.1, JV2.wheelbase, *[jnp.asarray(a) for a in arrs], alphas,
        jnp.asarray(lo), jnp.asarray(hi), "rk4", "st", JV2)
    gX, gU = TRV.feedback_rollout_vec(
        0.1, TV2.wheelbase, *[torch.from_numpy(a) for a in arrs], alphas,
        lo, hi, "rk4", "st", TV2)
    assert gX.shape == (3, B, H + 1, 7)
    _close(Ua, gU, rtol=1e-4, atol=1e-4)
    _close(Xa, gX, rtol=1e-4, atol=1e-4)


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


def test_st_horizon_bound_names_it():
    """An ST horizon whose block does not fit a block's shared memory is
    outside the AL kernel's envelope, and the reason names the bound."""
    H = TF.MAX_HORIZON_ST + 1
    cfg = TS.SolverConfig(horizon=H, **dict(ST, vehicle=TV2))
    ocp = convert.ocp_params(ocp_numpy(H, 1))
    reason = TF.ineligible_reason(cfg, ocp)
    assert f"H <= {TF.MAX_HORIZON_ST}" in reason
    assert TF.eligible(dataclasses.replace(cfg, horizon=H - 1),
                       convert.ocp_params(ocp_numpy(H - 1, 1)))


def test_st_library_key_covers_the_source_it_includes(tmp_path):
    """fused_gn_st.cu is fused_gn.cu with the ST model: an edit of the
    included source builds both libraries anew, and of neither the IP
    ones."""
    import shutil
    from mpc_tpu_torch.ops import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    before = {n: _build.lib_path(n, csrc) for n in _build.SIGNATURES}
    src = csrc / "fused_gn.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = {n: _build.lib_path(n, csrc) for n in _build.SIGNATURES}
    assert {n for n in before if before[n] != after[n]} == {
        "fused_gn", "fused_gn_st"}


def test_st_constants_mirror_the_c_struct():
    """The ST model's constants: the keys of st_consts, the ctypes mirror
    and struct StConsts of csrc/st_model.cuh name the same fields in the
    same order; the argument blocks of both fused kernels end with it."""
    import re
    from mpc_tpu_torch.ops import _build
    src = (_build.CSRC / "st_model.cuh").read_text()
    body = re.search(r"struct StConsts \{(.*?)\};", src, re.S).group(1)
    c_fields = re.findall(r"(\w+)\s*[,;]", body.replace("float", ""))
    assert tuple(c_fields) == TF.ST_CONSTS == tuple(TF.st_consts(TV2))
    assert [f for f, _ in TF.StConsts._fields_] == list(TF.ST_CONSTS)
    for args in (TF.FgnArgs, TFI.IpArgs):
        assert args._fields_[-1] == ("st", TF.StConsts)
