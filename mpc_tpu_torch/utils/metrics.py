"""Planning metrics (``mpc_tpu.utils.metrics``, host side).

The reference planner's metrics: RMSD of x and y against the resampled
reference, the per-step Euclidean deviation from the original route path,
and solve-time statistics.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from mpc_tpu_torch.utils.geometry import find_closest_point


def rmsd_xy(states: np.ndarray, reference_path: np.ndarray):
    """Root-mean-square deviation of x and y vs the resampled reference.

    Parity with ``mpc_planner.py:279-292`` (note the reference divides by
    ``iter_length - 1``).
    """
    T = states.shape[0]
    dx = reference_path[:T, 0] - states[:, 0]
    dy = reference_path[:T, 1] - states[:, 1]
    return (float(np.sqrt(np.sum(dx ** 2) / (T - 1))),
            float(np.sqrt(np.sum(dy ** 2) / (T - 1))))


def deviation_euclidean(states: np.ndarray,
                        origin_reference_path: np.ndarray) -> np.ndarray:
    """Per-step Euclidean distance to the nearest original-route point.

    Parity with ``mpc_planner.py:184-197``.
    """
    out = np.zeros(states.shape[0])
    for i in range(states.shape[0]):
        j = find_closest_point(origin_reference_path, states[i, :2])
        out[i] = np.linalg.norm(origin_reference_path[j] - states[i, :2])
    return out


def solve_time_stats(solve_time: np.ndarray) -> Dict[str, float]:
    st = np.asarray(solve_time, dtype=float)
    return {
        "mean_ms": float(st.mean() * 1e3),
        "p50_ms": float(np.percentile(st, 50) * 1e3),
        "p95_ms": float(np.percentile(st, 95) * 1e3),
        "min_ms": float(st.min() * 1e3),
        "max_ms": float(st.max() * 1e3),
    }
