"""The port's lanes-leading AL engine ``sqp_vec.solve_batch_vec`` (CPU)
against the JAX package's ``sqp_vec.solve_batch_vec``; its model functions
are held against JAX's in ``tests/test_torch_sqp_model.py``.

On the CPU the engine's Riccati sweep is the plain version; the CUDA
kernel takes its place on the GPU (``chip_smoke.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from mpc_tpu.models import costs as JCO
from mpc_tpu.ops import sqp as JS
from mpc_tpu.ops import sqp_vec as JV
from mpc_tpu_torch import convert
from mpc_tpu_torch.ops import sqp as TS
from mpc_tpu_torch.ops import sqp_vec as TV
from tests.test_torch_fused_gn import (assert_same_solution,
                                       assert_solutions_close, jax_state,
                                       ocp_numpy)


def with_boundaries(d):
    """``d`` (numpy OCP arrays) with a road 4 m either side of the
    reference window (chip_smoke.with_road_boundaries)."""
    t = cs.with_road_boundaries(convert.ocp_params(d))
    return dict(d, boundaries=t.boundaries.numpy(),
                boundary_signs=t.boundary_signs.numpy())


def jax_ocp(d):
    opt = {k: jnp.asarray(d[k]) for k in ("boundaries", "boundary_signs")
           if k in d}
    return JS.OcpParams(
        x0=jnp.asarray(d["x0"]), x_ref=jnp.asarray(d["x_ref"]),
        obs_centers=jnp.asarray(d["obs_centers"]),
        min_dist=jnp.asarray(d["min_dist"]),
        weights=JCO.Weights(**{k: jnp.asarray(v)
                               for k, v in d["weights"].items()}), **opt)


CASES = {
    "forcespro-rk4-ladder-2x2": (dict(al_iters=2, sqp_iters=2), {}),
    "casadi-euler": (dict(formulation="casadi", integrator="euler",
                          use_terminal_cost=False, al_iters=2,
                          sqp_iters=2), {}),
    "moving-obstacle": (dict(al_iters=2, sqp_iters=1), dict(moving=True)),
    "unguarded": (dict(al_iters=2, sqp_iters=2, alphas=()), {}),
    # tests/test_torch_sqp_model.py runs this one (each JAX engine
    # compiles anew; the two files split the time)
    "boundary-rows": (dict(al_iters=1, sqp_iters=2, boundary_rows=True), {}),
}


def check_solve_case(case):
    """The bands of tests/test_fused_gn.py:42-55 on X, U, viol, cost and
    the warm state; equal status; the stationarity within 5e-2 relative.
    Seed 0: at other seeds a lane's casadi friction row sits on the kink of
    |s| at stage 0, where the JAX engines part from each other."""
    kw, okw = CASES[case]
    H, B = 8, 3
    jcfg = JS.SolverConfig(horizon=H, **kw)
    d = ocp_numpy(H, B, seed=0, **okw)
    if jcfg.boundary_rows:
        d = with_boundaries(d)
    jst = jax_state(jcfg, B)
    ref = JV.solve_batch_vec_jit(jcfg, jax_ocp(d), jst)
    got = TV.solve_batch_vec(convert.solver_config(jcfg),
                             convert.ocp_params(d), convert.sqp_state(jst),
                             device="cpu")
    assert_solutions_close(got, ref)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    np.testing.assert_allclose(got.kkt_stat.numpy(), np.asarray(ref.kkt_stat),
                               rtol=5e-2, atol=1e-3)
    np.testing.assert_allclose(got.merit.numpy(), np.asarray(ref.merit),
                               rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("case", [c for c in CASES if c != "boundary-rows"])
def test_solve_batch_vec_matches_jax(case):
    check_solve_case(case)


def test_ladder_replays_its_rungs_and_records_them():
    """``rungs`` records the committed rung and every merit (the iterate's
    first); ``follow`` replays those rungs to the same solve, and a ladder
    held at the iterate leaves U unchanged."""
    H, B = 6, 3
    cfg = TS.SolverConfig(horizon=H, al_iters=1, sqp_iters=2)
    p = convert.ocp_params(ocp_numpy(H, B, seed=0))
    st = TS.init_state(cfg, batch=B)
    rungs = []
    free = TV.solve_batch_vec(cfg, p, st, device="cpu", rungs=rungs)
    assert len(rungs) == 2
    chosen = torch.stack([r for r, _ in rungs])
    assert rungs[0][1].shape == (len(cfg.alphas) + 1, B)
    assert bool((chosen > 0).any())
    again = TV.solve_batch_vec(cfg, p, st, device="cpu", follow=chosen)
    assert torch.equal(again.U, free.U)
    held = TV.solve_batch_vec(cfg, p, st, device="cpu",
                              follow=torch.zeros_like(chosen))
    assert torch.equal(held.U, st.U)


def test_pick_takes_nan_first_like_jnp_argmin():
    nan = float("nan")
    merits = torch.tensor([[1.0, 2.0, 0.5], [0.5, nan, 0.1]])
    assert TV._pick(merits, torch.tensor([2.0, 1.0, 0.2])).tolist() == [
        2, 0, 2]
    assert TV._pick(merits, torch.tensor([0.1, nan, 0.2])).tolist() == [
        0, 0, 2]


# the ids are the cases' names from before the parallel-scan sweep was
# ported (the second names the ROADMAP item that ported it)
@pytest.mark.parametrize("kw,match", [
    (dict(method="ip"), "sqp.solve_batch"),
    (dict(lqr_backend="pscan"), None),
], ids=["kw0-sqp.solve_batch", "kw1-ROADMAP queue A, item 6"])
def test_out_of_envelope_raises(kw, match):
    """The AL engine hands the IP method to the per-lane path that solves
    it (``match`` names it), as the JAX package does, and reads no
    ``lqr_backend``, as ``mpc_tpu/ops/sqp_vec.py`` reads none: a 'pscan'
    solve is the 'scan' solve at atol 0."""
    cfg = TS.SolverConfig(horizon=4, **kw)
    p, st = convert.ocp_params(ocp_numpy(4, 2)), TS.init_state(cfg, batch=2)
    if cfg.method == "ip":
        assert_same_solution(TV.solve_batch_vec(cfg, p, st, device="cpu"),
                             TS.solve_batch(cfg, p, st, device="cpu"))
        return
    scan = dataclasses.replace(cfg, lqr_backend="scan")
    assert_same_solution(TV.solve_batch_vec(cfg, p, st, device="cpu"),
                         TV.solve_batch_vec(scan, p, st, device="cpu"))


def test_entry_point_needs_a_gpu_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CPU-only contract does not apply")
    cfg = TS.SolverConfig(horizon=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        TV.solve_batch_vec(cfg, convert.ocp_params(ocp_numpy(4, 2)),
                           TS.init_state(cfg, batch=2))
