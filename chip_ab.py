"""Time one bench loop of two checkouts of this repository in turns on one
GPU: this checkout (``change``) and another one (``parent``), in the order
parent, change, change, parent, each run in a process of its own through
that checkout's ``chip_smoke.phase_loop`` (104 launches counted, solves/s
with CUDA events, best of 3).  Each checkout's kernels are built first, in
a process of its own, so that no timed process compiles.

    python3 chip_ab.py PARENT_CHECKOUT [--row soft|hard]

Prints one JSON line per run (the tree, solves/s, the loop's wall seconds,
launches, feasible steps); exits non-zero if a run fails.  Checkouts whose
``chip_smoke.phase_loop`` takes (dev, card) only, from before the hard row
existed, run the soft row.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

RUN = """
import inspect, json, sys, torch
sys.path.insert(0, {root!r})
import chip_smoke as cs
dev = torch.device("cuda", 0)
card = cs.phase_device()
cs.phase_build()
if {build_only!r}:
    sys.exit(0)
if len(inspect.signature(cs.phase_loop).parameters) == 2:
    cs.phase_loop(dev, card)
elif {row!r} == "soft":
    cs.phase_loop(dev, card, "soft", "al 1x1", method="al", **cs.WARM)
else:
    cs.phase_loop(dev, card, "hard", "ip 1x4", **cs.IP_WARM)
"""


def _run(name, root, row, build_only):
    """One process in checkout ``root``; its standard output, or None (and
    the error's tail printed) when it fails."""
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(root=str(root), row=row,
                                           build_only=build_only)],
        cwd=root, capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        print(f"chip_ab: the {name} run failed:\n{out.stderr[-3000:]}",
              file=sys.stderr)
        return None
    return out.stdout


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("--row", choices=("soft", "hard"), default="soft")
    args = ap.parse_args()
    trees = {"parent": args.parent.resolve(),
             "change": Path(__file__).resolve().parent}
    for name, root in trees.items():
        if _run(name, root, args.row, build_only=True) is None:
            return 1
    for name in ("parent", "change", "change", "parent"):
        stdout = _run(name, trees[name], args.row, build_only=False)
        if stdout is None:
            return 1
        for line in stdout.splitlines():
            if '"phase": "loop"' in line:
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
