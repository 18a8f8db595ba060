"""Carry state across from the JAX package into the port's types.

Every function reads its argument by field name (NamedTuple fields,
dataclass fields or a mapping) and turns arrays into tensors with
``numpy.asarray``, so it takes the JAX package's pytrees (or numpy copies
of them) without importing that package.  With it, a test feeds both
packages the same lanes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from mpc_tpu_torch.io import config as config_mod
from mpc_tpu_torch.models import constraints as C
from mpc_tpu_torch.models import costs as cost_mod
from mpc_tpu_torch.models import vehicle as veh_mod
from mpc_tpu_torch.ops import ipqp
from mpc_tpu_torch.ops import riccati
from mpc_tpu_torch.ops import sqp
from mpc_tpu_torch.planner import closed_loop as cl
from mpc_tpu_torch.planner import reference as ref_mod


def fields_of(obj: Any) -> dict:
    """Field dict of a mapping, a dataclass or a NamedTuple."""
    if isinstance(obj, Mapping):
        return dict(obj)
    if dataclasses.is_dataclass(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    if hasattr(obj, "_asdict"):
        return obj._asdict()
    raise TypeError(f"cannot read fields of {type(obj).__name__}")


def tensor(a, device=None) -> torch.Tensor | None:
    """An array (numpy, JAX, list) as a tensor with the same dtype."""
    if a is None:
        return None
    return torch.as_tensor(np.array(a), device=device)


def weights(w, device=None) -> cost_mod.Weights:
    f = fields_of(w)
    return cost_mod.Weights(q=tensor(f["q"], device), r=tensor(f["r"], device),
                            qN=tensor(f["qN"], device))


def ocp_params(p, device=None) -> sqp.OcpParams:
    f = fields_of(p)
    return sqp.OcpParams(
        x0=tensor(f["x0"], device), x_ref=tensor(f["x_ref"], device),
        obs_centers=tensor(f["obs_centers"], device),
        min_dist=tensor(f["min_dist"], device),
        weights=weights(f["weights"], device),
        boundaries=tensor(f.get("boundaries"), device),
        boundary_signs=tensor(f.get("boundary_signs"), device))


def sqp_state(s, device=None) -> sqp.SqpState:
    f = fields_of(s)
    return sqp.SqpState(**{k: tensor(f[k], device)
                           for k in sqp.SqpState._fields})


def stage_quad(q, device=None) -> riccati.StageQuad:
    f = fields_of(q)
    return riccati.StageQuad(**{k: tensor(f[k], device)
                                for k in riccati.StageQuad._fields})


def lin_dyn(d, device=None) -> riccati.LinDyn:
    f = fields_of(d)
    return riccati.LinDyn(**{k: tensor(f[k], device)
                             for k in riccati.LinDyn._fields})


def riccati_gains(g, device=None) -> riccati.RiccatiGains:
    f = fields_of(g)
    return riccati.RiccatiGains(**{k: tensor(f[k], device)
                                   for k in riccati.RiccatiGains._fields})


def reference_track(t, device=None) -> ref_mod.ReferenceTrack:
    f = fields_of(t)
    return ref_mod.ReferenceTrack(**{k: tensor(f[k], device)
                                     for k in ref_mod.ReferenceTrack._fields})


def loop_params(p, device=None) -> cl.LoopParams:
    f = fields_of(p)
    return cl.LoopParams(
        x_init=tensor(f["x_init"], device),
        track=reference_track(f["track"], device),
        obs_centers=tensor(f["obs_centers"], device),
        min_dist=tensor(f["min_dist"], device),
        weights=weights(f["weights"], device),
        noise_key=tensor(np.asarray(f["noise_key"]).astype(np.int64),
                         device),
        boundaries=tensor(f.get("boundaries"), device),
        boundary_signs=tensor(f.get("boundary_signs"), device),
        obs_track=tensor(f.get("obs_track"), device))


def box_bounds(b) -> C.BoxBounds:
    f = fields_of(b)
    return C.BoxBounds(**{k: tuple(float(v) for v in f[k])
                          for k in ("u_lo", "u_hi", "x_lo", "x_hi")})


def vehicle(v) -> veh_mod.VehicleParams:
    f = fields_of(v)
    return veh_mod.VehicleParams(
        **{k: f[k] for k in ("name", "l", "w", "m", "I_z", "a", "b", "h_s")},
        steering=veh_mod.SteeringParams(**fields_of(f["steering"])),
        longitudinal=veh_mod.LongitudinalParams(
            **fields_of(f["longitudinal"])),
        tire=veh_mod.TireParams(**fields_of(f["tire"])))


def solver_config(cfg) -> sqp.SolverConfig:
    """SolverConfig from a field dict (or the JAX dataclass itself)."""
    f = fields_of(cfg)
    f["bounds"] = box_bounds(f["bounds"])
    if f.get("vehicle") is not None:
        f["vehicle"] = vehicle(f["vehicle"])
    return sqp.SolverConfig(**f)


def loop_config(lcfg) -> cl.LoopConfig:
    """LoopConfig from a field dict (or the JAX dataclass itself)."""
    f = fields_of(lcfg)
    f["solver"] = solver_config(f["solver"])
    return cl.LoopConfig(**f)


def qp_data(q, device=None) -> ipqp.QpData:
    f = fields_of(q)
    return ipqp.QpData(**{k: tensor(f[k], device)
                          for k in ipqp.QpData._fields})


def ip_state(s, device=None) -> ipqp.IpState:
    f = fields_of(s)
    return ipqp.IpState(**{k: tensor(f[k], device)
                           for k in ipqp.IpState._fields})


def planning_config(c) -> config_mod.PlanningConfig:
    """PlanningConfig from the JAX package's (or a field dict): arrays as
    numpy float64 arrays, the vehicle as the port's."""
    f = fields_of(c)
    for k, v in f.items():
        if v is not None and hasattr(v, "shape") and not isinstance(
                v, np.ndarray):
            f[k] = np.asarray(v)
    f["vehicle"] = vehicle(f["vehicle"])
    return config_mod.PlanningConfig(**f)
