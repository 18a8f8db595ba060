"""The port's mesh, lane split, summaries and entry points in one process
(``parallel.mesh``, ``parallel.batch``, ``entry``), against the JAX
package where it has the same function; the multi-rank cases run in
``tests/test_torch_distributed.py``.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu_torch import convert
from mpc_tpu_torch import entry as tentry
from mpc_tpu_torch.ops import sqp as TS
from mpc_tpu_torch.parallel import batch as TB
from mpc_tpu_torch.parallel import mesh as TM
from mpc_tpu_torch.planner import closed_loop as tcl
from mpc_tpu_torch.utils import checkpoint as tck
from mpc_tpu_torch.utils import synthetic as tsyn


def test_single_rank_mesh():
    """One process with no process group is a (1, 1) mesh, as the JAX
    package's ``make_mesh`` on one device; a shape that is not the world
    size raises ``ValueError``; collectives are identities."""
    assert not torch.distributed.is_initialized()
    for shape in (None, (1, 1)):
        m = TM.make_mesh(shape)
        assert m.shape == {"dp": 1, "sp": 1} and m.device_mesh is None
        assert m.coords == {"dp": 0, "sp": 0}
        assert m.ranks("dp") == (0,) and m.group("dp") is None
    for shape in ((2, 1), (1, 2), (2, 2)):
        with pytest.raises(ValueError, match="!= world size 1"):
            TM.make_mesh(shape)
    m = TM.make_mesh()
    t = torch.arange(3.0)
    assert TM.all_reduce(t, m, "dp") is t
    assert TM.all_gather(t, m, "sp") == [t]


def test_init_distributed_needs_a_named_backend(monkeypatch):
    """A no-op at world size 1; above it the backend must be named, so no
    GPU rank drifts onto gloo."""
    monkeypatch.setenv("WORLD_SIZE", "1")
    TM.init_distributed()
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="'nccl' or 'gloo'"):
        TM.init_distributed(world_size=2, rank=0)
    assert not torch.distributed.is_initialized()


def test_shard_and_gather_on_one_rank():
    """Every lane is this rank's; dataclass leaves (``Weights``) and None
    pass through; leaves that disagree on the lane count raise."""
    _, lp = tsyn.make_bench_loop(3, 4, 4, device="cpu")
    m = TM.make_mesh()
    sh = TM.shard_lanes(lp, m)
    assert torch.equal(sh.weights.q, lp.weights.q)
    assert sh.obs_track is None
    back = TM.gather_lanes(sh, m)
    assert torch.equal(back.track.path, lp.track.path)
    assert TM.lane_block(8, m) == (0, 8)
    with pytest.raises(ValueError, match="disagree on the lane count"):
        TM.shard_lanes(lp._replace(x_init=lp.x_init[:3]), m)


def _jax_summaries(status, viol, cost, loop):
    """JAX's summarize / summarize_loop on the 8-device virtual mesh of
    tests/conftest.py, lanes over dp."""
    from mpc_tpu.parallel import batch as jb
    from mpc_tpu.parallel import mesh as jm
    mesh = jm.make_mesh((8, 1))
    arrs = jm.shard_lanes(types.SimpleNamespace(
        status=jnp.asarray(status), viol=jnp.asarray(viol),
        cost=jnp.asarray(cost)).__dict__, mesh)
    fn = jb.summarize_loop if loop else jb.summarize
    return fn(types.SimpleNamespace(**arrs), mesh)


@pytest.mark.parametrize("loop", [False, True], ids=["solve", "loop"])
def test_summaries_equal_jax(loop):
    """``summarize`` / ``summarize_loop`` against the JAX package's on the
    same status, viol and cost arrays (16 lanes, 5 steps for the loop):
    counts and max equal, the mean cost within float32 rounding."""
    rng = np.random.default_rng(0)
    shape = (16, 5) if loop else (16,)
    status = rng.choice([-7, 0, 1], size=shape).astype(np.int32)
    viol = rng.exponential(1e-3, size=shape).astype(np.float32)
    cost = rng.exponential(50.0, size=shape).astype(np.float32)
    ref = _jax_summaries(status, viol, cost, loop)
    t = [torch.as_tensor(a) for a in (status, viol, cost)]
    if loop:
        got = TB.summarize_loop(tcl.LoopResult(
            X=None, U=None, status=t[0], viol=t[1], cost=t[2], stat=None),
            TM.make_mesh())
    else:
        got = TB.summarize(TS.Solution(
            X=None, U=None, state=None, status=t[0], kkt_stat=None,
            viol=t[1], cost=t[2], merit=None), TM.make_mesh())
    assert int(got.n_converged) == int(ref.n_converged)
    assert int(got.n_infeasible) == int(ref.n_infeasible)
    assert float(got.max_viol) == float(ref.max_viol)
    assert float(got.mean_cost) == pytest.approx(float(ref.mean_cost),
                                                 rel=1e-6)


def test_lane_noise_keeps_its_rows_of_the_whole_draw():
    """A block of lanes draws the whole batch's noise and keeps its rows:
    lanes 2..3 of 4 see rows 2..3 of the unsharded draw."""
    u = torch.zeros(4, 2)
    whole = tcl._noise(torch.Generator().manual_seed(5), u)
    part = tcl._noise(tcl.LaneNoise(torch.Generator().manual_seed(5), 2, 4),
                      u[2:])
    assert torch.equal(part, whole[2:])


def test_single_rank_sharded_loop_and_checkpoint(tmp_path):
    """On a (1, 1) mesh the sharded loop is ``closed_loop_batch_vec`` at
    atol 0, noise included; a per-rank checkpoint resumes it exactly and
    is refused on another mesh shape."""
    lcfg, lp = tsyn.make_bench_loop(4, 5, 3, device="cpu",
                                    cold_start_solves=1, al_iters=1,
                                    sqp_iters=1, alphas=())
    lcfg = dataclasses.replace(lcfg, noise_std=0.05)
    m = TM.make_mesh()
    got = TB.closed_loop_batch_sharded(lcfg, lp, m, device="cpu")
    ref = tcl.closed_loop_batch_vec(lcfg, lp, device="cpu")
    for f in tcl.LoopResult._fields:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    carry = TB.init_carry_sharded(lcfg, lp, m, device="cpu")
    carry, first = TB.closed_loop_chunk_sharded(lcfg, lp, carry, 2, m,
                                                device="cpu")
    path = tmp_path / "ckpt"
    target = tck.save_checkpoint(str(path), carry, 2, mesh=m)
    assert target.endswith("step_00000002/rank_00000.pt")
    assert tck.latest_step(str(path)) == 2
    like = TB.init_carry_sharded(lcfg, lp, m, device="cpu")
    back = tck.restore_checkpoint(str(path), like, mesh=m)
    assert isinstance(back[3], tcl.LaneNoise) and back[3][1:] == (0, 3)
    _, rest = TB.closed_loop_chunk_sharded(lcfg, lp, back, 2, m,
                                           device="cpu")
    assert torch.equal(torch.cat([first.X, rest.X], 1), ref.X)
    assert torch.equal(torch.cat([first.U, rest.U], 1), ref.U)
    with pytest.raises(ValueError, match=r"\(1, 1\) mesh, not \(2, 1\)"):
        tck.restore_checkpoint(str(path), like, mesh=TM.Mesh(2, 1))


def test_replicate_and_perturb():
    p = convert.ocp_params({"x0": np.ones(5, np.float32),
                            "x_ref": np.zeros((4, 5), np.float32),
                            "obs_centers": np.zeros((3, 2), np.float32),
                            "min_dist": np.float32(3.3),
                            "weights": {"q": np.ones(5, np.float32),
                                        "r": np.ones(2, np.float32),
                                        "qN": np.ones(5, np.float32)}})
    b = TB.replicate_ocp(p, 6)
    assert b.x_ref.shape == (6, 4, 5) and b.weights.q.shape == (6, 5)
    assert b.min_dist.shape == (6,)
    scale = torch.tensor([0.5, 0.2, 0.0, 0.5, 0.02])
    one = TB.perturb_x0(b, torch.Generator().manual_seed(0), scale)
    two = TB.perturb_x0(b, torch.Generator().manual_seed(0), scale)
    assert torch.equal(one.x0, two.x0)
    assert bool((one.x0[:, 2] == 1.0).all())
    assert not torch.equal(one.x0[0], one.x0[1])


def test_entry_matches_jax_at_reduced_size():
    """``entry()``'s solve on the JAX package's flagship OCP (H=12, 4
    lanes, converted) against ``__graft_entry__.entry()``'s function on
    the same lanes: U within the reference bands (2e-3), equal status."""
    import __graft_entry__ as ge
    from mpc_tpu.ops import sqp as JS

    H, n = 12, 4
    jparams, jstates = ge._flagship_ocp(horizon=H, n_lanes=n)
    cfg = JS.SolverConfig(horizon=H)
    ref = jax.vmap(lambda p, s: JS.solve(cfg, p, s))(jparams, jstates)
    fn, (params, states) = tentry.entry(horizon=H, n_lanes=n, device="cpu")
    assert params.x0.shape == (n, 5) and states.U.shape == (n, H, 2)
    U, status = fn(convert.ocp_params(jparams),
                   TS.init_state(TS.SolverConfig(horizon=H), batch=n))
    np.testing.assert_allclose(U.numpy(), np.asarray(ref.U), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_array_equal(status.numpy(), np.asarray(ref.status))
    U2, _ = fn(params, states)
    assert U2.shape == (n, H, 2) and bool(torch.isfinite(U2).all())
