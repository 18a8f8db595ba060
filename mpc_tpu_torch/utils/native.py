"""ctypes bindings to the native C++ geometry library (``mpc_tpu.utils.native``).

``native/mpc_native.cpp`` (the collision checks of the swept ego rectangle,
the deviation from a path and the curvilinear projection) is compiled with
``g++ -O2 -shared -fPIC`` into the git-ignored ``build/native/`` at first
use, under a name that hashes the source, and bound through the same C ABI
as the JAX package (``mpc_native_abi_version`` 1).  Nothing is written into
``native/``.  Where the library cannot be built (no compiler), the Python
versions in ``utils.collision``, ``utils.metrics`` and ``utils.geometry``
answer instead; :func:`available` says which one runs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from mpc_tpu_torch.utils import collision
from mpc_tpu_torch.utils import geometry
from mpc_tpu_torch.utils import metrics

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "mpc_native.cpp"
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
ABI_VERSION = 1

_cache: dict = {}


def lib_path() -> Path:
    """Where the library goes: named by a hash of the source and flags."""
    key = hashlib.sha256(SOURCE.read_bytes())
    key.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libmpc_native-{key.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is there; returns its path.  Raises
    ``RuntimeError`` when there is no C++ compiler or it fails."""
    out = lib_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build native/")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    dp = ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.c_int64
    lib.mpc_native_abi_version.restype = i64
    lib.mpc_native_abi_version.argtypes = []
    if lib.mpc_native_abi_version() != ABI_VERSION:
        raise RuntimeError(f"{path.name}: ABI version "
                           f"{lib.mpc_native_abi_version()}, want "
                           f"{ABI_VERSION}")
    lib.mpc_traj_obstacle_collision.restype = i64
    lib.mpc_traj_obstacle_collision.argtypes = [dp, i64] + [
        ctypes.c_double] * 7
    lib.mpc_traj_boundary_collision.restype = i64
    lib.mpc_traj_boundary_collision.argtypes = [
        dp, i64, ctypes.c_double, ctypes.c_double, dp, i64]
    lib.mpc_deviation_to_path.restype = None
    lib.mpc_deviation_to_path.argtypes = [dp, i64, dp, i64, dp]
    lib.mpc_curvilinear_project.restype = None
    lib.mpc_curvilinear_project.argtypes = [dp, i64, dp, i64, dp, dp]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The bound library, built at first use, or None where it cannot be
    built (the Python versions then answer)."""
    if "lib" not in _cache:
        try:
            _cache["lib"] = _bind(build())
        except (RuntimeError, OSError):
            _cache["lib"] = None
    return _cache["lib"]


def available() -> bool:
    """Whether the native library runs the checks (else the Python
    versions do)."""
    return _load() is not None


def _as_c(a) -> Tuple[np.ndarray, ctypes.POINTER(ctypes.c_double)]:
    """``a`` as a C-contiguous float64 array (kept alive by the caller)
    and its data pointer."""
    a = np.ascontiguousarray(a, dtype=np.float64)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _states(states) -> np.ndarray:
    """The KS columns [x, y, delta, v, psi] of (T, NX) states, the rows
    the library reads (an ST state's psiDot and beta follow them)."""
    s = np.asarray(states, dtype=np.float64)
    if s.ndim != 2 or s.shape[1] < 5:
        raise ValueError(f"states of shape {s.shape}: want (T, >=5) rows "
                         "[x, y, delta, v, psi, ...]")
    return np.ascontiguousarray(s[:, :5])


def traj_obstacle_collision(states, ego_length: float, ego_width: float,
                            obs_center, obs_length: float, obs_width: float,
                            obs_theta: float) -> int:
    """First step whose ego rectangle overlaps the obstacle rectangle, or
    -1."""
    lib = _load()
    s = _states(states)
    if lib is None:
        hit, step = collision.trajectory_collides_obstacle(
            s, ego_length, ego_width, np.asarray(obs_center, float),
            obs_length, obs_width, obs_theta)
        return step if hit else -1
    s, sp = _as_c(s)
    return int(lib.mpc_traj_obstacle_collision(
        sp, s.shape[0], ego_length, ego_width, float(obs_center[0]),
        float(obs_center[1]), obs_length, obs_width, obs_theta))


def traj_boundary_collision(states, ego_length: float, ego_width: float,
                            boundary: Optional[np.ndarray]) -> int:
    """First step whose ego rectangle crosses the boundary polyline, or -1
    (also without a boundary)."""
    if boundary is None:
        return -1
    lib = _load()
    s = _states(states)
    if lib is None:
        hit, step = collision.trajectory_crosses_boundary(
            s, ego_length, ego_width, boundary)
        return step if hit else -1
    s, sp = _as_c(s)
    b, bp = _as_c(boundary)
    return int(lib.mpc_traj_boundary_collision(
        sp, s.shape[0], ego_length, ego_width, bp, b.shape[0]))


def deviation_to_path(states, path: np.ndarray) -> np.ndarray:
    """Per-step distance to the nearest path point, (T,)."""
    lib = _load()
    s = _states(states)
    if lib is None:
        return metrics.deviation_euclidean(s, np.asarray(path, float))
    s, sp = _as_c(s)
    p, pp = _as_c(path)
    out = np.zeros(s.shape[0], dtype=np.float64)
    lib.mpc_deviation_to_path(sp, s.shape[0], pp, p.shape[0],
                              out.ctypes.data_as(
                                  ctypes.POINTER(ctypes.c_double)))
    return out


def curvilinear_project(path: np.ndarray, points: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(s, signed d) of each point's projection onto the polyline.  The
    Python version (``geometry.arclength_projection_t``) gives s only, and
    d = 0, as the JAX package's does."""
    lib = _load()
    p, ppath = _as_c(path)
    q, pq = _as_c(points)
    m = q.shape[0]
    out_s = np.zeros(m, dtype=np.float64)
    out_d = np.zeros(m, dtype=np.float64)
    if lib is None:
        out_s[:] = geometry.arclength_projection_t(
            torch.from_numpy(p)[None], torch.from_numpy(q)).numpy()
        return out_s, out_d
    lib.mpc_curvilinear_project(
        ppath, p.shape[0], pq, m,
        out_s.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out_d.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out_s, out_d
