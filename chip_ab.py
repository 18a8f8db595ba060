"""Time one bench loop, one row's kernel, or one row's solve call, of two
checkouts of this repository in turns on one GPU: this checkout
(``change``) and another one (``parent``), in the order parent, change,
change, parent, each run in a process of its own through that checkout's
``chip_smoke.phase_loop`` (104 launches counted, solves/s with CUDA events,
best of 3); with ``--timing``, its ``chip_smoke.phase_timing`` of the row's
kernel at the row's ``chip_smoke.TIMING_ROWS`` arguments (the warm and cold
budgets per launch, each held against the plain version); with ``--glue``,
the solve the row's loop calls, on the inputs it makes at
``chip_smoke.LOOP_CHECK_STEP``, and that solve's ``pack`` alone: the
median of 20 calls of the host's time until the call returns and of its
wall time to a synchronized device.  Each checkout's kernels are built
first, in a process of its own, so that no timed process compiles.

    python3 chip_ab.py PARENT_CHECKOUT [--row ROW] [--timing | --glue]

ROW: soft, hard, hard-corridor or soft-st.  Prints one JSON line per run
(the tree, solves/s, the loop's wall seconds, launches, feasible steps),
per timed case (the tree, the kernel, ms and the plain version's ms) or
per timed call (the tree, the call, host and wall ms); exits non-zero if a
run fails.  Checkouts whose ``chip_smoke.phase_loop`` takes (dev, card)
only, from before the hard row existed, run the soft row's loop; those
without ``TIMING_ROWS`` cannot be timed with ``--timing``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

RUN = """
import functools, inspect, json, statistics, sys, time, torch
sys.path.insert(0, {root!r})
import chip_smoke as cs
dev = torch.device("cuda", 0)
card = cs.phase_device()
cs.phase_build()
if {build_only!r}:
    sys.exit(0)
row, mode = {row!r}, {mode!r}
budget, kw = {{"soft": ("al 1x1", dict(method="al", **cs.WARM)),
               "hard": ("ip 1x4", cs.IP_WARM),
               "hard-corridor": ("ip 2x6", cs.HARD_CORRIDOR),
               "soft-st": ("al 1x1", cs.SOFT_ST)}}[row]
if mode == "timing":
    cs.phase_timing(dev, **cs.TIMING_ROWS[row])
elif mode == "glue":
    from mpc_tpu_torch.planner import closed_loop as cl
    lcfg, lp = cs.bench_loop(n_lanes=cs.B_BENCH, device=dev, **kw)
    step = cs.LOOP_CHECK_STEP
    ocp, state = cs.loop_inputs(dev, lcfg, lp, (step,))[step]
    cfg = lcfg.solver
    solve = functools.partial(
        cl.select_engine(cfg, lp.boundaries is not None), device=dev)
    pack = cs.engine(cfg).pack
    for call, fn in (("pack", lambda: pack(cfg, ocp, state)),
                     ("solve", lambda: solve(cfg, ocp, state))):
        host, wall = [], []
        for _ in range(21):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            host.append(t1 - t0)
            wall.append(time.perf_counter() - t0)
        print(json.dumps({{"phase": "glue", "call": call, "step": step,
                          "host_ms": 1e3 * statistics.median(host[1:]),
                          "wall_ms": 1e3 * statistics.median(wall[1:])}}))
elif len(inspect.signature(cs.phase_loop).parameters) == 2:
    cs.phase_loop(dev, card)
else:
    cs.phase_loop(dev, card, row, budget, **kw)
"""


def _run(name, root, row, build_only, mode="loop"):
    """One process in checkout ``root``; its standard output, or None (and
    the error's tail printed) when it fails."""
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(root=str(root), row=row,
                                           build_only=build_only,
                                           mode=mode)],
        cwd=root, capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        print(f"chip_ab: the {name} run failed:\n{out.stderr[-3000:]}",
              file=sys.stderr)
        return None
    return out.stdout


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("--row", default="soft",
                    choices=("soft", "hard", "hard-corridor", "soft-st"))
    how = ap.add_mutually_exclusive_group()
    how.add_argument("--timing", action="store_const", dest="mode",
                     const="timing", help="time the row's kernel")
    how.add_argument("--glue", action="store_const", dest="mode",
                     const="glue", help="time the row's solve call")
    args = ap.parse_args()
    trees = {"parent": args.parent.resolve(),
             "change": Path(__file__).resolve().parent}
    for name, root in trees.items():
        if _run(name, root, args.row, build_only=True) is None:
            return 1
    for name in ("parent", "change", "change", "parent"):
        stdout = _run(name, trees[name], args.row, build_only=False,
                      mode=args.mode or "loop")
        if stdout is None:
            return 1
        for line in stdout.splitlines():
            if '"phase": "glue"' in line:
                print(json.dumps({"tree": name, "row": args.row,
                                  **json.loads(line)}), flush=True)
            elif '"phase": "timing"' in line:
                d = json.loads(line)
                print(json.dumps({
                    "tree": name, "row": args.row, "kernel": d["kernel"],
                    "case": d["case"], "ms": d["ms"],
                    "plain_ms": d.get("plain_ms"),
                    "bound_ms": d["bound_ms"]}), flush=True)
            elif '"phase": "loop"' in line:
                d = json.loads(line)
                print(json.dumps({
                    "tree": name, "row": args.row,
                    "solves_per_s": d["value"], "loop_s": d["loop_s"],
                    "launches": d["kernel_launches"],
                    "feasible_steps": d["feasible_steps"],
                    "gpu": d["gpu"], "power_limit": d["power_limit"]}),
                    flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
