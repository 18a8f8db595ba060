"""Road-boundary rows in the port (CPU) against the JAX package:
``linearize_boundaries`` against JAX's, the AL plain version with boundary
rows against JAX's Pallas kernel in interpret mode and the IP plain
version against JAX's vmapped ``sqp.solve_batch(method='ip')``, and the
slice as a whole, the port's closed loop in a straight corridor against
JAX's, hard and soft (the corridors and the rest:
``tests/test_torch_boundary_rows.py``)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.ops import fused_gn as JF
from mpc_tpu.ops import sqp as JS
from mpc_tpu.planner import closed_loop as jcl
from mpc_tpu.utils import synthetic as jsyn
from mpc_tpu_torch import convert
from mpc_tpu_torch.ops import fused_gn as TF
from mpc_tpu_torch.ops import fused_ip as TFI
from mpc_tpu_torch.ops import sqp as TS
from mpc_tpu_torch.planner import closed_loop as tcl
from torch_corridors import (_states, corridor_ocp,
                                            curved_corridor, jax_ocp,
                                            straight_corridor)
from tests.test_torch_fused_gn import assert_solutions_close, jax_state
from tests.test_torch_fused_ip import assert_ip_solutions_close


def _on_vertex_and_line(B, S):
    """States whose middle circle centre (k = 0) lies exactly on a vertex
    of the left edge (stages 0 and 2), exactly on the line between two
    vertices (stage 1, a zero cross product), and outside a convex vertex
    where both segments are nearest (stage 3)."""
    bnd, sgn = straight_corridor(B, 2.0, -2.0, x_lo=-10.0, x_hi=10.0, n=21)
    bnd = bnd.copy()
    bnd[:, 0, 10, 1] = 3.0           # a vertex at (0, 3) bends the left edge
    X = _states(B, S, 3)
    X[:, 0, :2] = bnd[:, 0, 10]       # on that vertex
    X[:, 1, :2] = [4.5, 2.0]          # on the line between (5, 2), (4, 2)
    X[:, 2, :2] = bnd[:, 0, 12]       # on the vertex (-2, 2)
    X[:, 3, :2] = [0.0, 3.5]          # above the vertex (0, 3): a tie
    return X, bnd, sgn


@pytest.mark.parametrize("case", ["straight", "curved-0", "curved-1",
                                  "vertex-and-line"])
def test_linearize_boundaries_matches_jax(case):
    B, H = 3, 6
    cfg = TS.SolverConfig(horizon=H, boundary_rows=True)
    jcfg = JS.SolverConfig(horizon=H, boundary_rows=True)
    if case == "straight":
        X = _states(B, H + 1, 0)
        bnd, sgn = straight_corridor(B, 2.5, -4.0)
    elif case == "vertex-and-line":
        X, bnd, sgn = _on_vertex_and_line(B, H + 1)
    else:
        seed = int(case[-1])
        X = _states(B, H + 1, 10 + seed)
        bnd, sgn = curved_corridor(B, 2.5, -2.5, seed=seed + 1)
        sgn[1] = [-1.0, 1.0]          # a lane with a flipped left sign
    ref = np.asarray(JF.linearize_boundaries(
        jcfg, jnp.asarray(X), jnp.asarray(bnd), jnp.asarray(sgn)))
    got = TF.linearize_boundaries(cfg, torch.from_numpy(X),
                                  torch.from_numpy(bnd),
                                  torch.from_numpy(sgn))
    assert got.shape == (B, H + 1, TF.NBND) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0.0, atol=1e-5)
    if case == "vertex-and-line":
        # k = 0, left edge: rows 0..2 of the stage are (nx, ny, c0) = 0
        # where the centre lies on the edge (sign of a zero cross product)
        assert not np.any(got.numpy()[:, :3, :3])
        assert np.any(got.numpy()[:, 3, :3])


def boundary_rows_bind(cfg, ocp, sol):
    """Lane-stages where a boundary row of the solution is within 0.05 m of
    its bound r_ego or beyond it (the exact rows of ``sqp``)."""
    h, lo, _ = TS._all_rows(cfg, sol.X, sol.U, TS.normalize_params(cfg, ocp))
    return int((h[..., TF.NR:] - lo[..., TF.NR:] < 0.05).any(-1).sum())


def test_al_plain_with_boundary_rows_matches_jax_interpret():
    """AL 1x1, unguarded, H=6, B=2, starting on a reference that hugs the
    left edge of a bending corridor: the rows bind (their multipliers turn
    on)."""
    H, B = 6, 2
    jcfg = JS.SolverConfig(horizon=H, al_iters=1, sqp_iters=1, alphas=(),
                           boundary_rows=True)
    d = corridor_ocp(H, B, *curved_corridor(B, 2.6, -4.0), on_ref=True)
    jst = jax_state(jcfg, B)
    ref = JF.solve_batch_fused(jcfg, jax_ocp(d), jst, interpret=True)
    cfg, ocp = convert.solver_config(jcfg), convert.ocp_params(d)
    got = TF.solve_batch_fused(cfg, ocp, convert.sqp_state(jst),
                               device="cpu")
    assert_solutions_close(got, ref)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    assert bool((got.state.lam_lo[..., TF.NR:] > 0).any())
    assert boundary_rows_bind(cfg, ocp, got) > 0


def test_ip_plain_with_boundary_rows_matches_jax_spec():
    """IP 1x6 on the straight corridor of tests/test_fused_ip.py, H=8,
    B=2, against the vmapped per-lane spec with the exact rows."""
    H, B = 8, 2
    jcfg = JS.SolverConfig(horizon=H, method="ip", ip_sqp_iters=1,
                           ip_iters=6, boundary_rows=True)
    d = corridor_ocp(H, B, *straight_corridor(B, 2.5, -4.0, n=64))
    ref = JS.solve_batch(jcfg, jax_ocp(d), jax_state(jcfg, B))
    cfg, ocp = convert.solver_config(jcfg), convert.ocp_params(d)
    got = TFI.solve_batch_fused_ip(cfg, ocp, TS.init_state(cfg, batch=B),
                                   device="cpu")
    assert_ip_solutions_close(got, ref)
    assert float(got.X[..., 1].max()) < 1.6
    assert boundary_rows_bind(cfg, ocp, got) > 0


# the track of a 20-step loop, whose swerve peaks within the first 10 steps
H_LOOP, B_LOOP, T_TRACK, T_LOOP = 10, 3, 20, 10
LOOPS = {
    "hard-2x6": dict(method="ip", ip_sqp_iters=2, ip_iters=6,
                     ip_warm_duals=True),
    "soft-3x4": dict(method="al", al_iters=3, sqp_iters=4),
}


@pytest.mark.parametrize("row", list(LOOPS))
def test_corridor_closed_loop_matches_jax(row):
    """The overtake workload inside a straight corridor (edges at y = 4.0
    and -4.0, 128 points): the port's loop on the CPU against JAX's, every
    step feasible in both, X within the closed-loop band of
    tests/test_torch_closed_loop.py (5e-2) and U within its band (5e-3) or
    within the reference's own rounding spread, whichever is larger: in a
    binding corridor the IP duals of the rows of the three ego circles
    against one edge are nearly degenerate, and JAX's loop itself moves U
    by more than 5e-3 when its starts move by 1e-6 (the hard row by ~1.7e-2,
    the soft one by ~6.7e-3).  The corridor binds: the port's loop stays
    >= 0.1 m below the same loop without it."""
    lcfg, lp = jsyn.make_bench_loop(n_steps=T_TRACK, horizon=H_LOOP,
                                    n_lanes=B_LOOP, boundary_rows=True,
                                    **LOOPS[row])
    lcfg = dataclasses.replace(lcfg, n_steps=T_LOOP)
    bnd, sgn = straight_corridor(B_LOOP, 4.0, -4.0, x_lo=0.0, x_hi=150.0)
    lp = lp._replace(boundaries=jnp.asarray(bnd),
                     boundary_signs=jnp.asarray(sgn))
    ref = jcl.closed_loop_batch_vec(lcfg, lp)
    tl, tp = convert.loop_config(lcfg), convert.loop_params(lp)
    got = tcl.closed_loop_batch_vec(tl, tp, device="cpu")
    err_x = np.abs(np.asarray(ref.X) - got.X.numpy()).max()
    err_u = np.abs(np.asarray(ref.U) - got.U.numpy()).max()
    spread_u = 0.0
    if err_u >= 5e-3:      # the reference's own spread, run only if needed
        nudged = jcl.closed_loop_batch_vec(lcfg, lp._replace(
            x_init=lp.x_init + 1e-6))
        spread_u = np.abs(np.asarray(ref.U) - np.asarray(nudged.U)).max()
    print(f"{row}: max abs err X {err_x:.3g} U {err_u:.3g}; JAX's own U "
          f"spread {spread_u:.3g}")
    assert err_x < 5e-2 and err_u <= max(5e-3, spread_u)
    assert bool((got.status >= 0).all()) and bool(
        (np.asarray(ref.status) >= 0).all())
    free = tcl.closed_loop_batch_vec(
        dataclasses.replace(tl, solver=dataclasses.replace(
            tl.solver, boundary_rows=False)),
        tp._replace(boundaries=None, boundary_signs=None), device="cpu")
    y, y_free = float(got.X[..., 1].max()), float(free.X[..., 1].max())
    print(f"{row}: max y {y:.3f} in the corridor, {y_free:.3f} without")
    assert y <= y_free - 0.1
