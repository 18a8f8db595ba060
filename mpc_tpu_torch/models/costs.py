"""Quadratic tracking-cost weights (``mpc_tpu.models.costs``).

The 12-weight schema of the reference planner's YAML ``weights_setting``.
Stage and terminal costs are evaluated inside the fused solve.
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
