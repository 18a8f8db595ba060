"""Per-step reference windows (``mpc_tpu.planner.reference``).

The padded track arrays and the curvature-aware speed profile are built
once on the host; the per-step window and the progress index are batched
gathers and reductions over a leading lane axis.  Window starts are clamped the
way ``jax.lax.dynamic_slice`` clamps them, so both packages read the same
rows past the end of the track.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mpc_tpu_torch.utils.geometry import (
    compute_curvature_from_polyline, compute_pathlength_from_polyline)


class ReferenceTrack(NamedTuple):
    """Padded reference arrays, optionally with a leading lane axis.

    path (.., T+H+1, 2) and psi, vdes (.., T+H+1) are padded with their
    final values; vdes ramps to 0 over the last H points (forcespro) or is
    constant (casadi); T (..,) int32 is the number of closed-loop steps.
    """

    path: torch.Tensor
    psi: torch.Tensor
    vdes: torch.Tensor
    T: torch.Tensor

    def map(self, fn) -> "ReferenceTrack":
        return ReferenceTrack(*(fn(t) for t in self))


def build_track(reference_path: np.ndarray, orientation: np.ndarray,
                desired_velocity, horizon: int, mode: str,
                dtype=torch.float32, device=None) -> ReferenceTrack:
    """Padded track arrays of one lane (host side)."""
    T = int(reference_path.shape[0])
    H = int(horizon)
    pad = H + 1
    path = np.concatenate(
        [reference_path, np.repeat(reference_path[-1:], pad, axis=0)], axis=0)
    psi = np.concatenate([orientation, np.repeat(orientation[-1:], pad)])
    if np.ndim(desired_velocity) == 0:
        if mode == "forcespro":
            n_const = max(T - H, 0)
            vdes = np.concatenate([
                np.full(n_const, desired_velocity),
                np.linspace(desired_velocity, 0.0, min(H, T))])
        elif mode == "casadi":
            vdes = np.full(T, desired_velocity)
        else:
            raise ValueError(f"unknown reference mode '{mode}'")
    else:
        base = np.asarray(desired_velocity, dtype=float)
        if base.shape[0] != T:
            raise ValueError(
                f"v_des profile has {base.shape[0]} rows, path has {T}")
        if mode == "forcespro":
            n_ramp = min(H, T)
            vdes = base.copy()
            vdes[T - n_ramp:] = np.minimum(
                vdes[T - n_ramp:],
                np.linspace(float(base[T - n_ramp]), 0.0, n_ramp))
        elif mode == "casadi":
            vdes = base
        else:
            raise ValueError(f"unknown reference mode '{mode}'")
    vdes = np.concatenate([vdes, np.repeat(vdes[-1:], pad)])

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    return ReferenceTrack(path=t(path), psi=t(psi), vdes=t(vdes),
                          T=torch.tensor(T, dtype=torch.int32, device=device))


def speed_profile(reference_path: np.ndarray, v_des: float,
                  a_lat_max: float, a_long_max: float,
                  wheelbase: float, steer_rate_max: float) -> np.ndarray:
    """Curvature-aware desired velocity per path point (host side, (T,)).

    The cruise v_des is capped by the lateral acceleration through the
    curvature (v <= sqrt(a_lat / |kappa|)) and by steering-rate
    feasibility (delta = atan(l kappa) must wind at delta_dot_max: v <=
    delta_dot_max / |d delta / ds|); a backward and a forward pass over
    arc length then enforce the longitudinal deceleration and acceleration
    limit.  YAML ``curvature_speed_limit: true`` turns it on.
    """
    path = np.asarray(reference_path, dtype=float)
    kappa = compute_curvature_from_polyline(path)
    s = compute_pathlength_from_polyline(path)
    v_curve = np.sqrt(a_lat_max / np.maximum(np.abs(kappa), 1e-6))
    delta = np.arctan(wheelbase * kappa)
    dds = np.abs(np.gradient(delta, np.maximum(s, 1e-9), edge_order=1)) \
        if len(s) > 2 else np.zeros_like(delta)
    v_steer = steer_rate_max / np.maximum(dds, 1e-6)
    v = np.minimum(np.full(len(path), float(v_des)),
                   np.minimum(v_curve, v_steer))
    ds = np.diff(s)
    for i in range(len(v) - 2, -1, -1):        # backward: decel feasible
        v[i] = min(v[i], np.sqrt(v[i + 1] ** 2 + 2 * a_long_max * ds[i]))
    for i in range(1, len(v)):                 # forward: accel feasible
        v[i] = min(v[i], np.sqrt(v[i - 1] ** 2 + 2 * a_long_max * ds[i - 1]))
    return v


def progress_index(track: ReferenceTrack, x: torch.Tensor) -> torch.Tensor:
    """Index of the ego's closest reference point over the whole path
    (path tracking instead of the loop step's schedule; YAML
    ``progress_window: true``).  track fields (..., L, 2), x (..., NX) ->
    (...) int64."""
    d2 = torch.sum((track.path - x[..., None, :2]) ** 2, dim=-1)
    return torch.argmin(d2, dim=-1)


def _gather_rows(a: torch.Tensor, start: torch.Tensor, n: int):
    """a (B, L, ...) rows start[b] .. start[b]+n-1, start clamped to
    [0, L - n] like ``dynamic_slice``."""
    L = a.shape[1]
    start = torch.clamp(start, 0, L - n)
    idx = start[:, None] + torch.arange(n, device=a.device)
    idx = idx.reshape(idx.shape + (1,) * (a.dim() - 2)).expand(
        (-1, -1) + a.shape[2:])
    return torch.gather(a, 1, idx)


def progress_index_local(track: ReferenceTrack, x: torch.Tensor,
                         prev: torch.Tensor, ahead: int) -> torch.Tensor:
    """Per lane, the closest path index within [prev, prev + ahead), never
    past the path end T.  track lanes-leading, x (B, NX), prev (B,)."""
    n = track.path.shape[1]
    start = torch.clamp(prev, 0, n - ahead)
    sl = _gather_rows(track.path, start, ahead)          # (B, ahead, 2)
    d2 = torch.sum((sl - x[:, None, :2]) ** 2, dim=-1)
    best = start + torch.argmin(d2, dim=1).to(start.dtype)
    return torch.minimum(best, track.T.to(start.dtype))


def window(track: ReferenceTrack, step: torch.Tensor, horizon: int,
           mode: str, x0: torch.Tensor | None = None) -> torch.Tensor:
    """Reference rows (B, H+1, 5) for closed-loop step ``step`` (B,).

    forcespro: row m <- path[step + 1 + m].
    casadi:    row m <- path[min(step, T - H) + m]; at step 0 the window is
               the tiled current state ``x0`` (B, 5) when given.
    """
    H = horizon
    T = track.T.to(step.dtype)
    if mode == "forcespro":
        base = step + 1
    elif mode == "casadi":
        base = torch.minimum(torch.clamp(step, min=0), T - H)
    else:
        raise ValueError(f"unknown reference mode '{mode}'")
    p = _gather_rows(track.path, base, H + 1)
    psi = _gather_rows(track.psi, base, H + 1)
    v = _gather_rows(track.vdes, base, H + 1)
    rows = torch.stack([p[..., 0], p[..., 1], torch.zeros_like(psi), v, psi],
                       dim=-1)
    if mode == "casadi" and x0 is not None:
        rows = torch.where((step == 0)[:, None, None], x0[:, None, :], rows)
    return rows
