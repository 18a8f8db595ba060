"""Heterogeneous scenario fleets in one lockstep batch
(``mpc_tpu.parallel.multi``).

Scenarios of one framework, time step, vehicle and dynamics model run as
the lanes of ONE batched closed loop: per-lane reference tracks (padded to
a common length), obstacles, weights, starts, boundaries and noise seeds,
solved each step by one launch of the batched engine (the fused kernels on
the GPU).  A lane whose scenario ends earlier (a smaller ``iter_length``)
keeps its own ``T`` in its ``ReferenceTrack``: its window freezes at the
path end as in a single run and its tail holds near the goal, so lane i's
result is valid up to ``lane_lengths[i]``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from mpc_tpu_torch.device import resolve_device
from mpc_tpu_torch.io.config import PlanningConfig
from mpc_tpu_torch.models import costs as cost_mod
from mpc_tpu_torch.planner import closed_loop as cl
from mpc_tpu_torch.planner import reference as ref_mod


def _pad_track(track: ref_mod.ReferenceTrack, n: int) -> ref_mod.ReferenceTrack:
    """The track's arrays extended to length ``n`` by repeating their last
    row (``build_track``'s own padding)."""
    def pad(a):
        need = n - a.shape[0]
        if need <= 0:
            return a
        return torch.cat([a, a[-1:].expand((need,) + a.shape[1:])])
    return ref_mod.ReferenceTrack(path=pad(track.path), psi=pad(track.psi),
                                  vdes=pad(track.vdes), T=track.T)


def _stack(*leaves):
    if leaves[0] is None:
        if any(leaf is not None for leaf in leaves):
            raise ValueError("inconsistent optional fields across lanes")
        return None
    if isinstance(leaves[0], ref_mod.ReferenceTrack):
        return ref_mod.ReferenceTrack(*(_stack(*f) for f in zip(*leaves)))
    if isinstance(leaves[0], cost_mod.Weights):
        return cost_mod.Weights(**{
            f.name: torch.stack([getattr(w, f.name) for w in leaves])
            for f in dataclasses.fields(cost_mod.Weights)})
    if any(leaf is None for leaf in leaves):
        raise ValueError("inconsistent optional fields across lanes")
    return torch.stack(leaves)


def make_multi_scenario_batch(
        cfgs: Sequence[PlanningConfig],
        horizon: Optional[int] = None,
        noised: Optional[bool] = None,
        seeds: Optional[Sequence[int]] = None,
        dtype=torch.float32, device=None,
        **solver_overrides) -> Tuple[cl.LoopConfig, cl.LoopParams, List[int]]:
    """Stack N planning configs into one batched closed-loop problem on
    ``device`` (default: the GPU).

    The configs must share the framework, time step, wheelbase and dynamics
    model: one loop config serves the batch.  Returns ``(lcfg, params,
    lane_lengths)``, ``lcfg.n_steps`` the longest scenario's
    ``iter_length``, ``params`` lanes leading (the noise keys (B, K)) and
    ``lane_lengths[i]`` lane i's own length.  Any boundary-constrained lane
    turns on ``boundary_rows`` for the batch, the other lanes getting the
    far-away ``cl.dummy_boundaries``; any moving-obstacle lane puts the
    static lanes on a constant ``obs_track``.
    """
    if not cfgs:
        raise ValueError("need at least one PlanningConfig")
    dev = resolve_device(device)
    fw, dt, wb = cfgs[0].framework, cfgs[0].delta_t, cfgs[0].wheelbase
    model = cfgs[0].dynamics_model
    for c in cfgs[1:]:
        if c.framework != fw:
            raise ValueError(
                f"mixed frameworks in batch: {fw!r} vs {c.framework!r}")
        if c.delta_t != dt or c.wheelbase != wb:
            raise ValueError("mixed delta_t/wheelbase in batch")
        if c.dynamics_model != model:
            raise ValueError("mixed dynamics_model in batch")
    any_boundary = any(c.boundary_constraints for c in cfgs)
    if any_boundary:
        solver_overrides.setdefault("boundary_rows", True)

    longest = max(cfgs, key=lambda c: c.iter_length)
    lcfg = cl.make_loop_config(longest, horizon=horizon, noised=noised,
                               **solver_overrides)
    if seeds is None:
        seeds = range(len(cfgs))
    per_lane = [cl.make_loop_params(c, lcfg, seed=int(seed), dtype=dtype,
                                    device=dev)
                for c, seed in zip(cfgs, seeds)]
    if lcfg.noise_std > 0.0:
        stds = {("lane_following" if c.use_case == "lane_following"
                 else "collision_avoidance") for c in cfgs}
        if len(stds) > 1:
            raise ValueError(
                "noised multi-scenario batch mixes use cases with different "
                "noise sigmas; run them deterministically or split batches")

    n_track = max(p.track.path.shape[0] for p in per_lane)
    per_lane = [p._replace(track=_pad_track(p.track, n_track))
                for p in per_lane]
    if any_boundary:
        # the rows of an unconstrained lane sit inactive 1e6 m away
        dummy_b, dummy_s = cl.dummy_boundaries(dtype, dev)
        per_lane = [
            p if c.boundary_constraints
            else p._replace(boundaries=dummy_b, boundary_signs=dummy_s)
            for c, p in zip(cfgs, per_lane)]
    if any(p.obs_track is not None for p in per_lane):
        need = lcfg.n_steps + lcfg.solver.horizon + 2
        per_lane = [
            p if p.obs_track is not None
            else p._replace(obs_track=p.obs_centers[None].expand(
                (need,) + p.obs_centers.shape))
            for p in per_lane]

    params = cl.LoopParams(*(_stack(*f) for f in zip(*per_lane)))
    return lcfg, params, [int(c.iter_length) for c in cfgs]


def plan_multi(cfgs: Sequence[PlanningConfig], device=None, **kw):
    """Build the batch and run ``closed_loop_batch_vec`` on ``device``
    (default: the GPU).  Returns ``(result, lane_lengths)``: the result's
    fields are lanes leading, lane i valid up to ``lane_lengths[i]``."""
    dev = resolve_device(device)
    lcfg, params, lane_lengths = make_multi_scenario_batch(cfgs, device=dev,
                                                           **kw)
    return cl.closed_loop_batch_vec(lcfg, params, device=dev), lane_lengths
