"""Profiling and timing (``mpc_tpu.utils.profiling``, the same names).

* :func:`trace`: a ``torch.profiler`` context that writes a Chrome trace
  (Perfetto, ``chrome://tracing``) into ``log_dir``; the GPU's kernels are
  in it when there is one;
* :func:`time_jitted`: steady-state seconds a call of a function, its
  output reduced to one scalar on its device (``_scalarize``), timed with
  CUDA events on the GPU and ``perf_counter`` on the CPU;
* :func:`solve_time_series`: the reference's per-step ``solve time.txt``
  from a whole run's wall time;
* :func:`breakdown`: :func:`time_jitted` over named functions, in ms.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body with ``torch.profiler`` (the CPU's ops, and the
    GPU's kernels when there is one) and write its Chrome trace to
    ``log_dir/trace_<time>_<pid>.json``::

        with profiling.trace("/tmp/trace"):
            res = cl.closed_loop_batch_vec(lcfg, params)
            torch.cuda.synchronize()

    Yields the profiler (``key_averages()`` for sums by op)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}"
                 ".json"))


def _scalarize(fn: Callable) -> Callable:
    """``fn`` with its output's tensors reduced to one scalar on their
    device."""
    def wrapped(*args):
        leaves = [leaf for leaf in pytree.tree_leaves(fn(*args))
                  if isinstance(leaf, torch.Tensor)]
        return sum(leaf.float().sum() for leaf in leaves)
    return wrapped


def time_jitted(fn: Callable, *args, reps: int = 10,
                warmup: int = 1) -> float:
    """Steady-state seconds a call of ``fn(*args)``: the output reduced to
    one scalar on its device, only that scalar read back; CUDA events when
    it lies on the GPU, the host clock on the CPU."""
    f = _scalarize(fn)
    v = None
    for _ in range(max(warmup, 1)):
        v = f(*args)
        float(v)
    if isinstance(v, torch.Tensor) and v.is_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            v = f(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        v = f(*args)
    float(v)
    return (time.perf_counter() - t0) / reps


def solve_time_series(total_wall_s: float, n_steps: int) -> np.ndarray:
    """The reference's ``solve time.txt`` series (seconds, one a step) of
    a run timed as a whole: its wall time spread evenly over the steps."""
    return np.full(int(n_steps), float(total_wall_s) / max(int(n_steps), 1))


def breakdown(named_fns: Sequence, reps: int = 10) -> dict:
    """Time ``(name, fn, args)`` triples; returns {name: ms}."""
    return {name: 1e3 * time_jitted(fn, *args, reps=reps)
            for name, fn, args in named_fns}
