"""Lanes split over ranks (``mpc_tpu.parallel.batch``).

The multi-GPU entry points: lanes (independent NMPC instances) split over
the mesh's ``dp`` axis, one contiguous block a rank, and every rank runs
the single-GPU engine on its own block: the fused kernels on the card,
with no communication on the hot path.  The cross-lane reductions
(convergence counters, the largest violation, the mean cost) are the only
quantities that cross ranks: :func:`summarize` and :func:`summarize_loop`
all-reduce them over ``dp``.  With ``SolverConfig.stage_axis`` set, each
rank runs the per-lane path instead, whose parallel-scan sweep splits its
stages over the ranks of that axis (``ops.pscan``).

The JAX package lowers its sharded programs without running them
(``lower_closed_loop_sharded``, ``lower_summarize_loop``) so that
``tools/scaling_census.py`` can count the collectives in the HLO.  Eager
PyTorch has no lowered program; :func:`collective_census` runs a function
and returns the collectives it issued instead.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from mpc_tpu_torch.device import resolve_device
from mpc_tpu_torch.ops import sqp
from mpc_tpu_torch.parallel import mesh as mesh_mod
from mpc_tpu_torch.planner import closed_loop as cl


class BatchSummary(NamedTuple):
    """Diagnostics of every lane of every rank, reduced over ``dp``."""

    n_converged: torch.Tensor   # () int64
    n_infeasible: torch.Tensor  # () int64
    max_viol: torch.Tensor      # ()
    mean_cost: torch.Tensor     # ()


def _solver(cfg: sqp.SolverConfig, have_boundaries: bool, mesh, dev):
    """The batched solve of one rank: ``closed_loop.select_engine``'s (the
    fused kernels on the card) or, with a stage axis, the per-lane path
    whose sweep splits the stages over ``mesh``."""
    if cfg.stage_axis is not None:
        return functools.partial(sqp.solve_batch, device=dev, mesh=mesh)
    return functools.partial(cl.select_engine(cfg, have_boundaries),
                             device=dev)


def solve_batch_sharded(cfg: sqp.SolverConfig, params: sqp.OcpParams,
                        state: sqp.SqpState, mesh: mesh_mod.Mesh,
                        device=None) -> sqp.Solution:
    """This rank's lanes of the batched solve of ``params`` and ``state``
    (every lane, on every rank), on ``device`` (default: the GPU).

    The lane count must divide by dp.  Per-lane status survives: no lane's
    failure aborts the batch.  Without a stage axis the solve goes through
    the same engine as ``closed_loop_batch_vec``; with
    ``cfg.stage_axis`` the per-lane path splits its sweep over that axis.
    :func:`mesh.gather_lanes` puts the lanes together.
    """
    dev = resolve_device(device)
    params = mesh_mod.shard_lanes(params, mesh)
    state = mesh_mod.shard_lanes(state, mesh)
    solve = _solver(cfg, params.boundaries is not None, mesh, dev)
    return solve(cfg, params, state)


def init_carry_sharded(lcfg: cl.LoopConfig, params: cl.LoopParams,
                       mesh: mesh_mod.Mesh, device=None):
    """The carry of this rank's lanes of a batched loop at step 0, the
    warm-up solves included (``closed_loop.init_batch_carry``'s layout).
    The noise is the whole batch's, seeded by its lane 0, of which the
    rank keeps its lanes' rows (``closed_loop.LaneNoise``)."""
    dev = resolve_device(device)
    n = mesh_mod.lane_count(params)
    lo, _ = mesh_mod.lane_block(n, mesh)
    shard = mesh_mod.shard_lanes(params, mesh).map(lambda t: t.to(dev))
    solve = _solver(lcfg.solver, shard.boundaries is not None, mesh, dev)
    step, x, state, _, bases = cl._batch_carry(lcfg, shard, solve, dev)
    gen = cl._generator(lcfg, params.noise_key, dev)
    noise = None if gen is None else cl.LaneNoise(gen, lo, n)
    return step, x, state, noise, bases


def closed_loop_chunk_sharded(lcfg: cl.LoopConfig, params: cl.LoopParams,
                              carry, n_steps: int, mesh: mesh_mod.Mesh,
                              device=None):
    """``n_steps`` steps of this rank's lanes from ``carry``
    (:func:`init_carry_sharded`); returns (carry, LoopResult of the rank's
    lanes).  A run cut into chunks is the whole run."""
    dev = resolve_device(device)
    shard = mesh_mod.shard_lanes(params, mesh).map(lambda t: t.to(dev))
    solve = _solver(lcfg.solver, shard.boundaries is not None, mesh, dev)
    return cl._run_steps(lcfg, shard, solve, carry, n_steps)


def closed_loop_batch_sharded(lcfg: cl.LoopConfig, params: cl.LoopParams,
                              mesh: mesh_mod.Mesh,
                              device=None) -> cl.LoopResult:
    """This rank's lanes of the batched closed loop of ``params`` (every
    lane, on every rank), (B / dp, T, ...), on ``device`` (default: the
    GPU).

    Without a stage axis each rank runs ``closed_loop_batch_vec``'s loop on
    its lanes (the fused kernels on the card); with
    ``lcfg.solver.stage_axis`` the per-lane loop, whose sweep splits the
    stages over that axis.  Each lane draws the noise it draws in the
    unsharded loop.
    """
    carry = init_carry_sharded(lcfg, params, mesh, device)
    return closed_loop_chunk_sharded(lcfg, params, carry, lcfg.n_steps,
                                     mesh, device)[1]


def collective_census(fn, *args, **kw):
    """(``fn(*args, **kw)``, every collective it issued through
    ``parallel.mesh``: dicts of op, axis, ranks, bytes, dtype, device and
    backend, in issue order)."""
    records = []
    token = mesh_mod.census.set(records)
    try:
        return fn(*args, **kw), records
    finally:
        mesh_mod.census.reset(token)


def _reduce(status, viol, cost, mesh: mesh_mod.Mesh) -> BatchSummary:
    """The psums and the pmax of the JAX package's ``reduce_fn``."""
    def psum(t):
        return mesh_mod.all_reduce(t, mesh, "dp", "sum")

    n = torch.tensor(status.numel(), dtype=cost.dtype, device=cost.device)
    return BatchSummary(
        n_converged=psum((status == 1).sum()),
        n_infeasible=psum((status < 0).sum()),
        max_viol=mesh_mod.all_reduce(viol.max(), mesh, "dp", "max"),
        mean_cost=psum(cost.sum()) / psum(n))


def summarize(solution: sqp.Solution, mesh: mesh_mod.Mesh) -> BatchSummary:
    """Every rank's lanes' solver diagnostics, reduced over ``dp``."""
    return _reduce(solution.status, solution.viol, solution.cost, mesh)


def summarize_loop(result: cl.LoopResult,
                   mesh: mesh_mod.Mesh) -> BatchSummary:
    """The (lane, step) diagnostics of a sharded loop's (B / dp, T)
    fields, reduced over ``dp``."""
    return _reduce(result.status, result.viol, result.cost, mesh)


def replicate_ocp(params: sqp.OcpParams, n: int) -> sqp.OcpParams:
    """One lane's OcpParams tiled to ``n`` lanes."""
    return sqp.map_tensors(
        params, lambda t: t[None].expand((n,) + t.shape).clone())


def perturb_x0(params: sqp.OcpParams, generator: torch.Generator,
               scale) -> sqp.OcpParams:
    """Each lane's initial state moved by ``scale`` times a standard
    normal draw of ``generator``."""
    x0 = params.x0
    noise = torch.randn(x0.shape, generator=generator, dtype=x0.dtype,
                        device=generator.device).to(x0.device)
    return params._replace(x0=x0 + torch.as_tensor(
        scale, dtype=x0.dtype, device=x0.device) * noise)
