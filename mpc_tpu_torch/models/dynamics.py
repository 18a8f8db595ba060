"""Kinematic single-track (KS) vehicle dynamics on torch tensors.

Counterpart of ``mpc_tpu.models.dynamics``.  Every function takes tensors
with any leading (lane) axes and the state/input on the last axis.

State  x = [xPos, yPos, delta, v, psi]   (5,)
Input  u = [deltaDot, aLong]             (2,)

The 7-state ST model is not ported yet: ``make_step_fn`` accepts
``model='ks'`` only.
"""
from __future__ import annotations

import torch

NX = 5     # KS state count
NX_ST = 7  # ST state count (adds [psiDot, beta])
NU = 2     # number of inputs (shared by both models)


def nx_of(model: str) -> int:
    """State dimension of a dynamics model ('ks' -> 5, 'st' -> 7)."""
    if model == "ks":
        return NX
    if model == "st":
        return NX_ST
    raise ValueError(f"unknown dynamics model '{model}' (want 'ks'|'st')")


def ks_ode(x: torch.Tensor, u: torch.Tensor, wheelbase: float) -> torch.Tensor:
    """xdot = [v cos psi, v sin psi, u0, u1, v / l * tan(delta)]."""
    v = x[..., 3]
    delta = x[..., 2]
    psi = x[..., 4]
    return torch.stack(
        [
            v * torch.cos(psi),
            v * torch.sin(psi),
            u[..., 0] + torch.zeros_like(v),
            u[..., 1] + torch.zeros_like(v),
            v / wheelbase * torch.tan(delta),
        ],
        dim=-1,
    )


def ks_to_st_state(x: torch.Tensor, wheelbase: float, lr: float
                   ) -> torch.Tensor:
    """Lift a 5-state KS state to the 7-state ST state kinematically:
    psiDot = v tan(delta) / l and beta = arctan(tan(delta) l_r / l)."""
    delta, v = x[..., 2], x[..., 3]
    psi_dot = v * torch.tan(delta) / wheelbase
    beta = torch.arctan(torch.tan(delta) * lr / wheelbase)
    return torch.cat([x, torch.stack([psi_dot, beta], dim=-1)], dim=-1)


def euler_step(x: torch.Tensor, u: torch.Tensor, dt: float,
               wheelbase: float) -> torch.Tensor:
    """Forward-Euler discretization of the KS model."""
    return x + dt * ks_ode(x, u, wheelbase)


def rk4_step(x: torch.Tensor, u: torch.Tensor, dt: float,
             wheelbase: float) -> torch.Tensor:
    """Classic RK4 discretization of the KS model."""
    k1 = ks_ode(x, u, wheelbase)
    k2 = ks_ode(x + 0.5 * dt * k1, u, wheelbase)
    k3 = ks_ode(x + 0.5 * dt * k2, u, wheelbase)
    k4 = ks_ode(x + dt * k3, u, wheelbase)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def make_step_fn(integrator: str, dt: float, wheelbase: float,
                 model: str = "ks", vehicle=None):
    """Discrete-time step ``x_next = F(x, u)`` ('rk4' or 'euler', KS)."""
    if model != "ks":
        raise NotImplementedError(
            f"model '{model}': only the KS model is ported (the ST model "
            "is a later item of ROADMAP queue A)")
    if integrator == "rk4":
        return lambda x, u: rk4_step(x, u, dt, wheelbase)
    if integrator == "euler":
        return lambda x, u: euler_step(x, u, dt, wheelbase)
    raise ValueError(f"unknown integrator '{integrator}' (want 'rk4'|'euler')")
