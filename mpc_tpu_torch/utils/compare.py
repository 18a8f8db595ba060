"""Solve-time comparison of artifact directories
(``mpc_tpu.utils.compare``).

Reads the ``solve time.txt`` series that ``MPCPlanner.save_artifacts``
writes (and the reference planner's own committed artifacts) and compares
them: statistics per label, and an overlay plot.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def load_solve_times(artifact_dir: str) -> np.ndarray:
    """The ``solve time.txt`` series (seconds) of an artifact directory."""
    return np.loadtxt(os.path.join(artifact_dir, "solve time.txt"))


def compare_solve_times(dirs: Dict[str, str]) -> Dict[str, Dict[str, float]]:
    """{label: artifact_dir} -> per-label statistics (ms)."""
    out = {}
    for label, d in dirs.items():
        st = np.atleast_1d(load_solve_times(d)) * 1e3
        out[label] = {
            "mean_ms": float(st.mean()),
            "p50_ms": float(np.percentile(st, 50)),
            "max_ms": float(st.max()),
            "n": int(st.size),
        }
    return out


def plot_solve_time_comparison(dirs: Dict[str, str], out_png: str,
                               title: Optional[str] = None) -> str:
    """Overlay the solve-time series of ``dirs`` in ``out_png`` (needs
    matplotlib)."""
    from mpc_tpu_torch.utils.viz import pyplot
    plt = pyplot()

    fig = plt.figure()
    for label, d in dirs.items():
        st = np.atleast_1d(load_solve_times(d)) * 1e3
        plt.plot(np.arange(st.size), st, label=label)
    plt.xlabel("iteration")
    plt.ylabel("Computation time [ms]")
    plt.yscale("log")
    plt.title(title or "Solve-time comparison")
    plt.legend()
    fig.savefig(out_png)
    plt.close(fig)
    return out_png
