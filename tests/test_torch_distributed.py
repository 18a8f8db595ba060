"""The port's multi-rank path on the CPU: ranks spawned with gloo on
localhost (``tests/torch_ranks.py``), against the same work in one process
and against the JAX package.

Two spawns (``tests/torch_rank_fixtures.py``): two ranks run every
two-rank check at once (the mesh and its errors, the lane split, the
sharded solve, the noised sharded loop, the per-rank checkpoint, the
collective census, the stage-sharded sweep on a (1, 2) mesh and
``dryrun_multichip(2)``); four ranks the mesh shapes of four, an uneven
stage split over sp=4 and ``dryrun_multichip(4)``, held in
``tests/test_torch_distributed_four.py``.
"""
import numpy as np
import pytest
import torch

from tests.test_torch_fused_gn import jax_ocp, jax_state, ocp_numpy
from torch_rank_fixtures import B, H, two  # noqa: F401 (a fixture)


def test_mesh_of_two_ranks(two):
    for r, res in enumerate(two):
        shape, coords, dp, sp = res["mesh"]
        assert shape == {"dp": 2, "sp": 1}
        assert coords == {"dp": r, "sp": 0}
        assert (dp, sp) == ((0, 1), (r,))
        assert len(res["mesh_errors"]) == 3
        assert all("!= world size 2" in e for e in res["mesh_errors"])


def test_lanes_split_and_gather(two):
    x = torch.arange(8.0)[:, None] * 10 + torch.arange(3.0)
    for r, res in enumerate(two):
        assert torch.equal(res["shard"], x[4 * r:4 * r + 4])
        assert torch.equal(res["round_trip"].x, x)
        assert float(res["round_trip"].scalar) == 2.0
        assert res["round_trip"].none is None
        assert "3 lanes do not split evenly over dp=2" in res["uneven"]


def test_sharded_solve_equals_unsharded(two):
    """``solve_batch_sharded`` over two ranks (4 lanes each, the fused AL
    engine's plain version on the CPU) gathered against the same engine's
    solve of all 8 lanes in one call: equal at atol 0 (the plain version
    computes each lane on its own); and against the JAX package's
    unsharded solve of the same inputs, U within 1e-4
    (tests/test_distributed.py:154-156)."""
    from mpc_tpu.ops import sqp as JS
    from mpc_tpu.planner import closed_loop as jcl
    for res in two:
        assert torch.equal(res["solve_U"], res["solve_U_ref"])
        assert torch.equal(*res["solve_status"])
    cfg = JS.SolverConfig(horizon=H, sqp_iters=2, al_iters=2)
    d = ocp_numpy(H, B, seed=7)
    ref = jcl.select_engine(cfg, False)(cfg, jax_ocp(d), jax_state(cfg, B))
    np.testing.assert_allclose(two[0]["solve_U"].numpy(), np.asarray(ref.U),
                               rtol=1e-4, atol=1e-4)


def test_summaries_equal_host_reductions(two):
    """``summarize`` and ``summarize_loop`` over two ranks: the psums and
    the pmax of every lane equal the reduction of the gathered arrays."""
    for res in two:
        for got, want in ((res["summary"], res["summary_host"]),
                          (res["loop_summary"], res["loop_summary_host"])):
            assert got[:3] == pytest.approx(want[:3], abs=0)
            assert got[3] == pytest.approx(want[3], rel=1e-6)


def test_noised_sharded_loop_equals_unsharded(two):
    """Each rank draws the whole batch's noise and keeps its lanes
    (``closed_loop.LaneNoise``): the noised loop over two ranks equals the
    unsharded loop at atol 0."""
    for res in two:
        for got, want in zip(res["loop"], res["loop_ref"]):
            assert torch.equal(got, want)


def test_per_rank_checkpoint_resumes_exactly(two):
    """Cut at step 2, saved one file a rank and resumed: the uninterrupted
    sharded run at atol 0; another mesh shape is refused."""
    for r, res in enumerate(two):
        assert res["ckpt_file"] == f"ckpt/step_00000002/rank_{r:05d}.pt"
        for got, want in zip(res["resumed"], res["uninterrupted"]):
            assert torch.equal(got, want)
        assert "(2, 1) mesh, not (1, 2)" in res["ckpt_shape_error"]


def test_collective_census(two):
    """The engine-sharded loop issues no collective in its steps (nothing
    crosses ranks on the hot path); ``summarize_loop`` issues exactly the
    reductions of the JAX package's ``reduce_fn``: four psums and one pmax
    over dp, a scalar each."""
    for res in two:
        assert res["census_loop"] == []
        ops = [(c["op"], c["axis"], c["ranks"]) for c in
               res["census_summary"]]
        assert ops == [("all_reduce_sum", "dp", (0, 1))] * 2 + [
            ("all_reduce_max", "dp", (0, 1))] + [
            ("all_reduce_sum", "dp", (0, 1))] * 2
        assert {c["backend"] for c in res["census_summary"]} == {"gloo"}
        assert all(c["bytes"] in (4, 8) for c in res["census_summary"])


@pytest.mark.parametrize("key,tol", [
    ("sweep64_f64", 1e-9), ("sweep3", 1e-9), ("sweep64_f32", 2e-3)])
def test_stage_sharded_sweep_matches_sequential(two, key, tol):
    """The parallel-scan sweep with its H+1 elements split over sp=2 (65 =
    33 + 32 at H=64; 4 = 2 + 2 at H=3): K, d, dV1, dV2 against the
    sequential sweep, float64 within 1e-9 and float32 within 2e-3
    (tests/test_pscan.py's band) of the gains."""
    for res in two:
        errs = res[key]
        assert max(errs[:2]) < tol, errs
        assert max(errs[2:]) < (tol if tol < 1e-3 else 5e-2), errs
