"""Quadratic tracking-cost weights (``mpc_tpu.models.costs``).

The 12-weight schema of the reference planner's YAML ``weights_setting``
and the weighted least-squares costs over it.  The fused kernels evaluate
the same costs inside their solves.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

WEIGHT_KEYS = (
    "weight_x",
    "weight_y",
    "weight_steering_angle",
    "weight_velocity",
    "weight_heading_angle",
    "weight_velocity_steering_angle",
    "weight_long_acceleration",
    "weight_x_terminate",
    "weight_y_terminate",
    "weight_steering_angle_terminate",
    "weight_velocity_terminate",
    "weight_heading_angle_terminate",
)


@dataclasses.dataclass
class Weights:
    """q (..., 5) stage state weights [x, y, delta, v, psi]; r (..., 2)
    stage input weights [deltaDot, aLong]; qN (..., 5) terminal weights."""

    q: torch.Tensor
    r: torch.Tensor
    qN: torch.Tensor

    @staticmethod
    def from_dict(d: Dict[str, float], dtype=torch.float32,
                  device=None) -> "Weights":
        missing = [k for k in WEIGHT_KEYS if k not in d]
        if missing:
            raise KeyError(f"weights_setting missing keys: {missing}")

        def vec(keys):
            return torch.tensor([d[k] for k in keys], dtype=dtype,
                                device=device)

        return Weights(q=vec(WEIGHT_KEYS[0:5]), r=vec(WEIGHT_KEYS[5:7]),
                       qN=vec(WEIGHT_KEYS[7:12]))

    def map(self, fn) -> "Weights":
        """Apply ``fn`` to every field (broadcast, move, slice)."""
        return Weights(q=fn(self.q), r=fn(self.r), qN=fn(self.qN))


def stage_cost(x: torch.Tensor, u: torch.Tensor, x_ref: torch.Tensor,
               w: Weights) -> torch.Tensor:
    """l(x, u) = (x - x_ref)' diag(q) (x - x_ref) + u' diag(r) u over the
    last axis; the weights broadcast against the states."""
    dx = x - x_ref
    return torch.sum(w.q * dx * dx, dim=-1) + torch.sum(w.r * u * u, dim=-1)


def terminal_cost(x: torch.Tensor, x_ref: torch.Tensor,
                  w: Weights) -> torch.Tensor:
    """lN(x) = (x - x_ref)' diag(qN) (x - x_ref) over the last axis."""
    dx = x - x_ref
    return torch.sum(w.qN * dx * dx, dim=-1)


def trajectory_cost(X: torch.Tensor, U: torch.Tensor, X_ref: torch.Tensor,
                    w: Weights, use_terminal: bool) -> torch.Tensor:
    """Cost of a horizon: X (..., N+1, NX), U (..., N, NU), X_ref (..., N+1,
    NX) with row k the target of state k; the stage costs of states
    0..N-1 plus, with ``use_terminal``, the terminal cost of state N."""
    stage = torch.sum(stage_cost(X[..., :-1, :], U, X_ref[..., :-1, :], w),
                      dim=-1)
    if not use_terminal:
        return stage
    return stage + terminal_cost(X[..., -1, :], X_ref[..., -1, :], w)
