"""Command-line planner (``mpc_tpu.planner.cli``).

    python -m mpc_tpu_torch.planner.cli \\
        --config configs/config_LF_ZAM_Over-1_1.yaml \\
        --scenario-dir scenarios [--out DIR] [--device cpu]

Loads the YAML config and its CommonRoad scenario, plans the closed loop on
the per-lane solve and prints a JSON summary: the metrics, the collision
checks, the solver status counts and whether the native library ran them
(``native``).  ``--out`` writes the reference's text artifacts.  The exit
code is 0 without a collision, 2 with one, and 1 when the config cannot
be loaded or ``--rti1`` is given a casadi-framework config.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from mpc_tpu_torch.io.config import load_config
from mpc_tpu_torch.planner import closed_loop as cl
from mpc_tpu_torch.planner.planner import MPCPlanner
from mpc_tpu_torch.utils import native


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
    result = planner.plan()

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
    return 0 if not (result.collided_obstacle or result.collided_boundary) \
        else 2


if __name__ == "__main__":
    raise SystemExit(main())
