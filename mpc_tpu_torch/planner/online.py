"""Online planners: the serving API, one warm NMPC step per measured state
(``mpc_tpu.planner.online``).

The plant is outside: each call takes the latest measured state(s) and
returns the input(s) to apply for the next ``delta_t``, while the warm
start, the multipliers, the progress index and the noise generator persist
across calls.

    planner = OnlinePlanner(config)
    u, info = planner.step(x_measured)      # one vehicle, the per-lane solve

    fleet = BatchedOnlinePlanner(config, n_lanes=1024)
    U, info = fleet.step(X_measured)        # (1024, 5) -> (1024, 2)

:class:`OnlinePlanner` runs ``closed_loop_chunk`` for one step on the
per-lane solve; :class:`BatchedOnlinePlanner` runs
``closed_loop_batch_step``, one launch of the batched engine a step (the
fused kernels on the GPU).  Both run on the GPU unless given
``device="cpu"`` and return numpy.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mpc_tpu_torch.device import resolve_device
from mpc_tpu_torch.io.config import PlanningConfig
from mpc_tpu_torch.models import dynamics as dyn_mod
from mpc_tpu_torch.planner import closed_loop as cl


class StepInfo(NamedTuple):
    status: int        # 1 converged / 0 max-iters-or-gated / -7 infeasible.
                       # Under a gate_stages=g preset (RTI1_CA_SETTINGS) 0
                       # certifies only the applied prefix (stages 0..g);
                       # `viol` stays the full-plan violation either way.
    viol: float        # max constraint violation of the planned horizon
    cost: float        # objective value
    planned_x: np.ndarray  # the state the solver planned from


class BatchStepInfo(NamedTuple):
    status: np.ndarray   # (B,) as StepInfo.status, a lane each
    viol: np.ndarray     # (B,) max planned-stage violation per lane
    cost: np.ndarray     # (B,) objective values


def _measured(lcfg: cl.LoopConfig, x_measured, like: torch.Tensor):
    """A measured state (..., NX) as a tensor like ``like``, a 5-column KS
    state lifted to the ST state for model='st'."""
    x = torch.as_tensor(x_measured).to(dtype=like.dtype, device=like.device)
    scfg = lcfg.solver
    if scfg.model == "st" and x.shape[-1] == dyn_mod.NX:
        x = dyn_mod.ks_to_st_state(x, scfg.wheelbase, scfg.vehicle.b)
    return x


class OnlinePlanner:
    """Warm-started receding-horizon planner of one vehicle over measured
    states, on the per-lane solve (FORCESPRO's deployment pattern: one warm
    real-time iteration a step)."""

    def __init__(self, config: PlanningConfig,
                 horizon: Optional[int] = None, seed: int = 0, device=None,
                 **solver_overrides):
        self.config = config
        self.device = resolve_device(device)
        self.lcfg = cl.make_loop_config(config, horizon=horizon,
                                        noised=False, **solver_overrides)
        self.params = cl.make_loop_params(config, self.lcfg, seed=seed,
                                          device=self.device)
        self.reset()

    def reset(self) -> None:
        self._carry = cl.init_carry(self.lcfg, self.params, self.device)

    def step(self, x_measured) -> Tuple[np.ndarray, StepInfo]:
        """One warm NMPC solve from the measured state (5,) KS ``[x, y,
        delta, v, psi]`` (lifted for the ST model) or (7,) ST.  Returns
        ``(u, info)``, ``u = [deltaDot, aLong]``."""
        x = _measured(self.lcfg, x_measured, self.params.x_init)
        step, _, state, gen, base = self._carry
        self._carry, res = cl.closed_loop_chunk(
            self.lcfg, self.params, (step, x, state, gen, base), 1,
            self.device)
        return (res.U[0].cpu().numpy(),
                StepInfo(status=int(res.status[0]), viol=float(res.viol[0]),
                         cost=float(res.cost[0]),
                         planned_x=res.X[0].cpu().numpy()))


class BatchedOnlinePlanner:
    """A fleet of vehicles served in lockstep: one warm NMPC solve per
    vehicle per call, one launch of the batched engine for the fleet.
    Every lane carries its own warm state and status.

    The constructor replicates one scenario on ``n_lanes`` lanes;
    :meth:`from_scenarios` builds one lane per config
    (``parallel.multi``).  Both serve through :meth:`_serve`.  The serving
    loop is never noised (the plant is outside), so no lane draws from
    ``noise_key``.
    """

    def __init__(self, config: PlanningConfig, n_lanes: int,
                 horizon: Optional[int] = None, seed: int = 0, device=None,
                 **solver_overrides):
        device = resolve_device(device)
        lcfg = cl.make_loop_config(config, horizon=horizon, noised=False,
                                   **solver_overrides)
        one = cl.make_loop_params(config, lcfg, seed=seed, device=device)
        self._serve(config, lcfg, one.map(
            lambda t: t[None].expand((n_lanes,) + t.shape).clone()), device)

    @classmethod
    def from_scenarios(cls, cfgs, horizon: Optional[int] = None, seeds=None,
                       device=None, **solver_overrides):
        """A heterogeneous fleet: one lane per PlanningConfig, through
        ``parallel.multi.make_multi_scenario_batch``."""
        from mpc_tpu_torch.parallel import multi

        device = resolve_device(device)
        lcfg, params, lane_lengths = multi.make_multi_scenario_batch(
            cfgs, horizon=horizon, noised=False, seeds=seeds, device=device,
            **solver_overrides)
        self = cls.__new__(cls)
        self._serve(list(cfgs), lcfg, params, device, lane_lengths)
        return self

    def _serve(self, config, lcfg: cl.LoopConfig, params: cl.LoopParams,
               device, lane_lengths=None) -> None:
        self.config, self.lcfg, self.params = config, lcfg, params
        self.device, self.lane_lengths = device, lane_lengths
        self.n_lanes = int(params.x_init.shape[0])
        self.reset()

    def reset(self) -> None:
        self._carry = cl.init_batch_carry(self.lcfg, self.params,
                                          self.device)

    def step(self, x_measured) -> Tuple[np.ndarray, BatchStepInfo]:
        """One warm batched solve from measured states (B, NX) -> the
        inputs to apply (B, 2) and each lane's diagnostics."""
        x = _measured(self.lcfg, x_measured, self.params.x_init)
        self._carry, out = cl.closed_loop_batch_step(
            self.lcfg, self.params, self._carry, x, self.device)
        _, u_apply, status, viol, cost, _ = out
        return (u_apply.cpu().numpy(),
                BatchStepInfo(status=status.cpu().numpy(),
                              viol=viol.cpu().numpy(),
                              cost=cost.cpu().numpy()))
