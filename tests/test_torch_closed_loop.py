"""The port's batched closed loop (CPU) against the JAX package's, plus the
reference windows, the benchmark workload and the envelope guards."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.planner import closed_loop as jcl
from mpc_tpu.planner import reference as jref
from mpc_tpu.utils import synthetic as jsyn
from mpc_tpu_torch import convert
from mpc_tpu_torch.ops import sqp as TS
from mpc_tpu_torch.planner import closed_loop as tcl
from mpc_tpu_torch.planner import reference as tref
from mpc_tpu_torch.utils import synthetic as tsyn


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


@pytest.mark.parametrize("mode", ["forcespro", "casadi"])
def test_build_track_and_window_match_jax(mode):
    H, T = 6, 12
    path, psi, _ = tsyn.overtake_track(T)
    jt = jref.build_track(path, psi, 15.0, H, mode)
    tt = tref.build_track(path, psi, 15.0, H, mode)
    for f in ("path", "psi", "vdes", "T"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)))
    B = 3
    lanes = tt.map(lambda t: t.expand((B,) + t.shape))
    rng = np.random.default_rng(4)
    x0 = rng.normal(size=(B, 5)).astype(np.float32)
    # steps inside, at the end of and past the track (clamped windows)
    for step in (0, 3, T - H, T, T + H + 5):
        steps = torch.full((B,), step)
        got = tref.window(lanes, steps, H, mode, x0=torch.from_numpy(x0))
        for b in range(B):
            ref = jref.window(jt, jnp.asarray(step), H, mode,
                              x0=jnp.asarray(x0[b]))
            np.testing.assert_array_equal(got[b].numpy(), np.asarray(ref))


def test_progress_index_local_matches_jax():
    H, T = 6, 30
    path, psi, _ = tsyn.overtake_track(T)
    jt = jref.build_track(path, psi, 15.0, H, "forcespro")
    tt = tref.build_track(path, psi, 15.0, H, "forcespro")
    rng = np.random.default_rng(5)
    B = 6
    x = np.concatenate([path[rng.integers(0, T, B)]
                        + rng.normal(size=(B, 2)), np.zeros((B, 3))], 1)
    x = x.astype(np.float32)
    prev = rng.integers(0, T, B)
    got = tref.progress_index_local(
        tt.map(lambda t: t.expand((B,) + t.shape)), torch.from_numpy(x),
        torch.from_numpy(prev), 16)
    ref = [int(jref.progress_index_local(jt, jnp.asarray(x[b]),
                                         jnp.asarray(prev[b]), 16))
           for b in range(B)]
    assert got.tolist() == ref


def test_make_bench_loop_matches_jax_workload():
    """Same track, obstacle, weights and config as the JAX workload; lane
    jitter comes from a seeded numpy generator instead of jax.random."""
    H, B, T = 8, 5, 10
    jl, jp = jsyn.make_bench_loop(T, H, B, al_iters=1, sqp_iters=1,
                                  alphas=())
    tl, tp = tsyn.make_bench_loop(T, H, B, device="cpu", al_iters=1,
                                  sqp_iters=1, alphas=())
    assert tl == convert.loop_config(jl)
    for f in ("path", "psi", "vdes", "T"):
        np.testing.assert_array_equal(getattr(tp.track, f).numpy(),
                                      np.asarray(getattr(jp.track, f)))
    np.testing.assert_allclose(tp.obs_centers.numpy(),
                               np.asarray(jp.obs_centers), atol=1e-6)
    np.testing.assert_array_equal(tp.min_dist.numpy(),
                                  np.asarray(jp.min_dist))
    np.testing.assert_array_equal(tp.weights.q.numpy(),
                                  np.asarray(jp.weights.q))
    # jittered starts: deterministic per seed, spread like the JAX lanes
    _, tp2 = tsyn.make_bench_loop(T, H, B, device="cpu")
    assert torch.equal(tp.x_init, tp2.x_init)
    spread = (tp.x_init - tp.x_init.mean(0)).abs().max(0).values
    assert spread[2] == 0 and 0 < spread[0] < 2.5


def test_make_bench_loop_builds_the_hard_bench_row():
    """bench.py's hard row (ip 1x4, warm duals, ip_alphas=()): the same
    loop configuration as the JAX workload, and the converters carry the
    ip_* fields and the duals across."""
    from mpc_tpu.ops import sqp as JS
    H, B, T = 8, 3, 10
    kw = dict(method="ip", ip_sqp_iters=1, ip_iters=4, ip_warm_duals=True,
              ip_alphas=())
    jl, _ = jsyn.make_bench_loop(T, H, B, **kw)
    tl, _ = tsyn.make_bench_loop(T, H, B, device="cpu", **kw)
    assert tl == convert.loop_config(jl)
    s = tl.solver
    assert (s.method, s.ip_sqp_iters, s.ip_iters, s.ip_warm_duals,
            s.ip_alphas, tl.cold_start_solves) == ("ip", 1, 4, True, (), 4)
    jst = jax.vmap(lambda _: JS.init_state(jl.solver))(jnp.arange(B))
    jst = jst._replace(lam_lo=jst.lam_lo + 0.25, lam_hi=jst.lam_hi + 0.5)
    tst = convert.sqp_state(jst)
    for f in ("lam_lo", "lam_hi", "U"):
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)))


def test_shift_state_holds_the_last_stage():
    cfg = TS.SolverConfig(horizon=3)
    st = TS.init_state(cfg, batch=2)
    st = st._replace(U=torch.arange(12.0).reshape(2, 3, 2))
    sh = tcl._shift_state(st)
    assert sh.U[0].tolist() == [[2.0, 3.0], [4.0, 5.0], [4.0, 5.0]]
    assert sh.mu.shape == st.mu.shape


def test_warmup_budget_is_full_strength():
    lcfg, _ = tsyn.make_bench_loop(3, 4, 1, device="cpu", al_iters=1,
                                   sqp_iters=1, alphas=())
    w = tcl._warmup_cfg(lcfg)
    assert (w.al_iters, w.sqp_iters, w.alphas) == (3, 4, ())
    lcfg2 = dataclasses.replace(lcfg, warmup_full_strength=False)
    assert tcl._warmup_cfg(lcfg2).al_iters == 1


def test_ip_warmup_budget_is_5x10_and_selects_the_ip_kernel():
    from mpc_tpu_torch.ops import fused_ip as TFI
    lcfg, _ = tsyn.make_bench_loop(3, 4, 1, device="cpu", method="ip",
                                   ip_sqp_iters=1, ip_iters=4,
                                   ip_warm_duals=True, ip_alphas=())
    w = tcl._warmup_cfg(lcfg)
    assert (w.ip_sqp_iters, w.ip_iters, w.ip_warm_duals, w.ip_alphas) == (
        5, 10, True, ())
    assert tcl.select_engine(lcfg.solver) is TFI.solve_batch_fused_ip
    big = dataclasses.replace(lcfg, solver=dataclasses.replace(
        lcfg.solver, ip_sqp_iters=6, ip_iters=12))
    assert (tcl._warmup_cfg(big).ip_sqp_iters,
            tcl._warmup_cfg(big).ip_iters) == (6, 12)
    lcfg2 = dataclasses.replace(lcfg, warmup_full_strength=False)
    assert tcl._warmup_cfg(lcfg2).ip_iters == 4


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


@pytest.mark.parametrize("solver_kw,engine", [
    (dict(engine="xla"), "solve_batch_vec"),
    ({}, "solve_batch_fused"),
    (dict(method="ip", ip_sqp_iters=1, ip_iters=2), "solve_batch_fused_ip"),
], ids=["xla-st", "st", "ip-st"])
def test_st_model_runs_on_every_engine(solver_kw, engine):
    """The ST model goes where KS goes (the cases that raised before ST was
    ported): engine='xla' to sqp_vec, 'auto' to the fused AL or IP solve;
    a short loop of lifted 7-state starts runs on the CPU."""
    from mpc_tpu_torch.models.vehicle import VEHICLE_2
    lcfg, p = tsyn.make_bench_loop(3, 4, 2, device="cpu", model="st",
                                   vehicle=VEHICLE_2, al_iters=1,
                                   sqp_iters=1, alphas=(), **solver_kw)
    lcfg = dataclasses.replace(lcfg, cold_start_solves=1)
    assert tcl.select_engine(lcfg.solver).__name__ == engine
    res = tcl.closed_loop_batch_vec(lcfg, p, device="cpu")
    assert res.X.shape == (2, 3, 7) and bool(torch.isfinite(res.X).all())
    assert bool((res.status >= 0).all())


def test_entry_points_need_a_gpu_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CPU-only contract does not apply")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsyn.make_bench_loop(3, 4, 2)
    lcfg, p = tsyn.make_bench_loop(3, 4, 2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcl.closed_loop_batch_vec(lcfg, p)


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
