"""Command-line planner (``mpc_tpu.planner.cli``).

    python -m mpc_tpu_torch.planner.cli \\
        --config configs/config_LF_ZAM_Over-1_1.yaml \\
        --scenario-dir scenarios [--out DIR] [--device cpu]

Loads the YAML config and its CommonRoad scenario, plans the closed loop on
the per-lane solve and prints a JSON summary: the metrics, the collision
checks, the solver status counts and whether the native library ran them
(``native``).  ``--out`` writes the reference's text artifacts and then
the four analysis plots (``--gif`` the scenario's animation too), which
need matplotlib; ``--profile-dir`` writes a ``torch.profiler`` trace of
the plan; ``--debug-nans`` stops at the first op that makes a NaN.  The
exit code is 0 without a collision, 2 with one, and 1 when the config
cannot be loaded, ``--rti1`` is given a casadi-framework config or the
plots cannot be drawn.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils import _pytree as pytree

from mpc_tpu_torch.io.config import load_config
from mpc_tpu_torch.planner import closed_loop as cl
from mpc_tpu_torch.planner.planner import MPCPlanner
from mpc_tpu_torch.utils import native
from mpc_tpu_torch.utils import profiling


class NanCheck(TorchDispatchMode):
    """Raise ``FloatingPointError`` naming the first dispatched op whose
    floating-point output holds a NaN (the counterpart of JAX's
    ``jax_debug_nans``).  A custom kernel's launch is no dispatched op:
    only the ops that read its outputs are checked."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            # jacfwd's zero tangents and shape-only (meta) tensors hold
            # no data to check
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and not (t.is_meta or t._is_zerotensor())
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="mpc_tpu_torch.planner.cli",
        description="NMPC motion planner for CommonRoad scenarios "
                    "(PyTorch, CUDA)")
    ap.add_argument("--config", required=True, help="planner YAML config")
    ap.add_argument("--scenario-dir", required=True,
                    help="directory containing CommonRoad scenario XMLs")
    ap.add_argument("--out", default=None,
                    help="write reference-format text artifacts to this "
                         "directory")
    ap.add_argument("--horizon", type=int, default=None,
                    help="override prediction horizon")
    ap.add_argument("--seed", type=int, default=0, help="noise seed")
    ap.add_argument("--deterministic", action="store_true",
                    help="disable actuation noise regardless of the config")
    ap.add_argument("--rti1", action="store_true",
                    help="1-warm-QP-per-step deployment preset (the "
                         "reference's maxqps=1): RTI1_SETTINGS for lane "
                         "following, RTI1_CA_SETTINGS (N=14 horizon, "
                         "applied-prefix status gate) for collision "
                         "avoidance")
    ap.add_argument("--gif", action="store_true",
                    help="with --out, also render the scenario's animated "
                         "GIF (slow)")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler Chrome trace of the plan "
                         "to this directory")
    ap.add_argument("--debug-nans", action="store_true",
                    help="raise FloatingPointError at the first op whose "
                         "floating output holds a NaN, naming it (slow: "
                         "checks every op; a custom kernel's launch is not "
                         "a dispatched op, so only its outputs are seen, "
                         "by the ops that read them)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to plan on (default: cuda; cpu runs "
                         "the plain PyTorch path)")
    args = ap.parse_args(argv)

    try:
        config = load_config(args.config, args.scenario_dir)
    except FileNotFoundError as e:
        print(f"error: {e.filename or e}: no such file", file=sys.stderr)
        return 1
    except (KeyError, ValueError) as e:
        print(f"error: invalid configuration: {e}", file=sys.stderr)
        return 1
    overrides = {}
    if args.rti1:
        if config.framework != "forcespro":
            # the presets are tuned for the hard-constrained forcespro
            # formulation; under the casadi one they leave infeasible steps
            print("error: --rti1 requires a forcespro-framework config "
                  f"(this one is '{config.framework}'); set "
                  "framework_name: forcespro in the YAML",
                  file=sys.stderr)
            return 1
        overrides = dict(cl.RTI1_CA_SETTINGS
                         if config.use_case == "collision_avoidance"
                         else cl.RTI1_SETTINGS)
    # an explicit --horizon wins over a preset horizon
    preset_h = overrides.pop("horizon", None)
    horizon = args.horizon if args.horizon is not None else preset_h
    planner = MPCPlanner(config, horizon=horizon,
                         noised=False if args.deterministic else None,
                         seed=args.seed, device=args.device, **overrides)
    with contextlib.ExitStack() as stack:
        if args.profile_dir:
            stack.enter_context(profiling.trace(args.profile_dir))
        if args.debug_nans:
            stack.enter_context(NanCheck())
        result = planner.plan()
    if args.profile_dir:
        print(f"profiler trace written to {args.profile_dir}",
              file=sys.stderr)

    summary = {
        "scenario": config.scenario_name,
        "use_case": config.use_case,
        "framework": config.framework,
        "device": str(planner.device),
        "steps": int(result.states.shape[0]),
        "wall_time_s": round(result.wall_time_s, 4),
        "ms_per_step": round(1e3 * result.wall_time_s
                             / result.states.shape[0], 3),
        "rmsd": result.rmsd,
        "final_position": [round(float(v), 3) for v in result.states[-1, :2]],
        "collided_obstacle": result.collided_obstacle,
        "collided_boundary": result.collided_boundary,
        "native": native.available(),
        "solver_status_counts": {
            int(k): int(v) for k, v in zip(
                *np.unique(result.status, return_counts=True))},
    }
    print(json.dumps(summary, indent=2))

    if args.out:
        d = planner.save_artifacts(result, args.out)
        print(f"artifacts written to {d}", file=sys.stderr)
        from mpc_tpu_torch.utils import viz
        try:
            viz.plot_analysis(config, result.states, result.inputs,
                              result.solve_time, result.deviation, d)
            if args.gif:
                from mpc_tpu_torch.io.scenario import load_scenario
                scenario = load_scenario(os.path.join(
                    args.scenario_dir, config.scenario_name + ".xml"))
                gif = viz.render_gif(config, result.states, args.out,
                                     scenario)
                print(f"gif written to {gif}", file=sys.stderr)
        except ImportError as e:
            print(f"error: the plots were not drawn: {e}", file=sys.stderr)
            return 1
    return 0 if not (result.collided_obstacle or result.collided_boundary) \
        else 2


if __name__ == "__main__":
    raise SystemExit(main())
