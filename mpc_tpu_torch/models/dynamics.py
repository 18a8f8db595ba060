"""Vehicle dynamics on torch tensors (``mpc_tpu.models.dynamics``).

Every function takes tensors with any leading (lane) axes and the
state/input on the last axis.

KS     x = [xPos, yPos, delta, v, psi]                   (5,)
ST     x = [xPos, yPos, delta, v, psi, psiDot, beta]     (7,)
Input  u = [deltaDot, aLong]                             (2,)
"""
from __future__ import annotations

from typing import NamedTuple

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


class StParams(NamedTuple):
    """The ST model's parameters, from a ``VehicleParams``."""
    g: float      # gravity
    mu: float     # friction coefficient
    C_Sf: float   # cornering stiffness coefficients, front and rear
    C_Sr: float
    lf: float     # CoG to front and rear axle, wheelbase
    lr: float
    l: float
    h: float      # CoG height, mass, yaw inertia
    m: float
    I: float


def st_params(vehicle) -> StParams:
    """The ST model's parameters of ``vehicle`` (a ``VehicleParams``)."""
    C_Sf = -vehicle.tire.p_ky1 / vehicle.tire.p_dy1
    return StParams(g=9.81, mu=vehicle.tire.p_dy1, C_Sf=C_Sf, C_Sr=C_Sf,
                    lf=vehicle.a, lr=vehicle.b, l=vehicle.a + vehicle.b,
                    h=vehicle.h_s, m=vehicle.m, I=vehicle.I_z)


def st_ode(x: torch.Tensor, u: torch.Tensor, p) -> torch.Tensor:
    """Single-track model with tire dynamics; ``p`` a ``VehicleParams``.

    State x = [xPos, yPos, delta, v, psi, psiDot, beta] (7,).  The
    low-speed kinematic branch (|v| < 0.1) and the tire branch are both
    evaluated and blended with ``torch.where``; the tire branch divides by
    v_safe, v floored at 1e-3 in magnitude.
    """
    g, mu, C_Sf, C_Sr, lf, lr, l, h, m, I = st_params(p)

    delta, v, psi, psi_dot, beta = (
        x[..., 2], x[..., 3], x[..., 4], x[..., 5], x[..., 6])
    u0, u1 = u[..., 0], u[..., 1]

    # low-speed kinematic branch: KS-cog dynamics, beta held kinematically
    beta_kin = torch.arctan(torch.tan(delta) * lr / l)
    v_safe = torch.where(torch.abs(v) < 1e-3, 1e-3, v)
    f_ks = torch.stack(
        [
            v * torch.cos(beta_kin + psi),
            v * torch.sin(beta_kin + psi),
            u0 + torch.zeros_like(v),
            u1 + torch.zeros_like(v),
            v * torch.cos(beta_kin) * torch.tan(delta) / l,
        ],
        dim=-1,
    )
    d_beta = (lr * u0) / (l * torch.cos(delta) ** 2
                          * (1.0 + (torch.tan(delta) ** 2 * lr / l) ** 2))
    dd_psi = (1.0 / l) * (
        u1 * torch.cos(beta) * torch.tan(delta)
        - v * torch.sin(beta) * d_beta * torch.tan(delta)
        + v * torch.cos(beta) * u0 / torch.cos(delta) ** 2
    )
    f_low = torch.cat([f_ks, torch.stack([dd_psi, d_beta], dim=-1)], dim=-1)

    # high-speed tire branch
    f_high = torch.stack(
        [
            v * torch.cos(beta + psi),
            v * torch.sin(beta + psi),
            u0 + torch.zeros_like(v),
            u1 + torch.zeros_like(v),
            psi_dot,
            -mu * m / (v_safe * I * (lr + lf))
            * (lf ** 2 * C_Sf * (g * lr - u1 * h)
               + lr ** 2 * C_Sr * (g * lf + u1 * h)) * psi_dot
            + mu * m / (I * (lr + lf))
            * (lr * C_Sr * (g * lf + u1 * h)
               - lf * C_Sf * (g * lr - u1 * h)) * beta
            + mu * m / (I * (lr + lf)) * lf * C_Sf * (g * lr - u1 * h) * delta,
            (mu / (v_safe ** 2 * (lr + lf))
             * (C_Sr * (g * lf + u1 * h) * lr - C_Sf * (g * lr - u1 * h) * lf)
             - 1.0) * psi_dot
            - mu / (v_safe * (lr + lf))
            * (C_Sr * (g * lf + u1 * h) + C_Sf * (g * lr - u1 * h)) * beta
            + mu / (v_safe * (lr + lf)) * (C_Sf * (g * lr - u1 * h)) * delta,
        ],
        dim=-1,
    )
    low_speed = (torch.abs(v) < 0.1)[..., None]
    return torch.where(low_speed, f_low, f_high)


def ks_to_st_state(x: torch.Tensor, wheelbase: float, lr: float
                   ) -> torch.Tensor:
    """Lift a 5-state KS state to the 7-state ST state kinematically:
    psiDot = v tan(delta) / l and beta = arctan(tan(delta) l_r / l)."""
    delta, v = x[..., 2], x[..., 3]
    psi_dot = v * torch.tan(delta) / wheelbase
    beta = torch.arctan(torch.tan(delta) * lr / wheelbase)
    return torch.cat([x, torch.stack([psi_dot, beta], dim=-1)], dim=-1)


def make_step_fn(integrator: str, dt: float, wheelbase: float,
                 model: str = "ks", vehicle=None):
    """Discrete-time step ``x_next = F(x, u)``: 'rk4' or 'euler' of the KS
    model, or of the ST model ('st', which needs ``vehicle``, a
    ``VehicleParams``)."""
    if model == "ks":
        ode = lambda x, u: ks_ode(x, u, wheelbase)  # noqa: E731
    elif model == "st":
        if vehicle is None:
            raise ValueError("model='st' requires vehicle=VehicleParams")
        ode = lambda x, u: st_ode(x, u, vehicle)  # noqa: E731
    else:
        raise ValueError(f"unknown dynamics model '{model}' (want 'ks'|'st')")
    if integrator == "rk4":
        def step(x, u):
            k1 = ode(x, u)
            k2 = ode(x + 0.5 * dt * k1, u)
            k3 = ode(x + 0.5 * dt * k2, u)
            k4 = ode(x + dt * k3, u)
            return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        return step
    if integrator == "euler":
        return lambda x, u: x + dt * ode(x, u)
    raise ValueError(f"unknown integrator '{integrator}' (want 'rk4'|'euler')")


def linearize_step(step_fn, x: torch.Tensor, u: torch.Tensor):
    """Exact linearization (A, B, c) of the discrete dynamics around one
    (x, u), x_next ~= A dx + B du + c with c = F(x, u), by
    ``torch.func.jacfwd``."""
    A = torch.func.jacfwd(step_fn, argnums=0)(x, u)
    B = torch.func.jacfwd(step_fn, argnums=1)(x, u)
    return A, B, step_fn(x, u)
