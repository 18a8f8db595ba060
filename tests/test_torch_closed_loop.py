"""The port's batched closed loop (CPU) against the JAX package's: the
reference windows, the benchmark workload and the engines it selects.
The loops themselves against JAX's are
``tests/test_torch_closed_loop_jax.py``; the envelope guards and the
status gate ``tests/test_torch_closed_loop_envelope.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.planner import reference as jref
from mpc_tpu.utils import synthetic as jsyn
from mpc_tpu_torch import convert
from mpc_tpu_torch.ops import sqp as TS
from mpc_tpu_torch.planner import closed_loop as tcl
from mpc_tpu_torch.planner import reference as tref
from mpc_tpu_torch.utils import synthetic as tsyn


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
