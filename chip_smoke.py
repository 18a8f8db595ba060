"""Run the PyTorch/CUDA port on one NVIDIA GPU: build its kernels, hold
each kernel against its plain PyTorch version, drive the closed loops of
the port at the bench point, and plan CommonRoad scenarios end to end.

    python3 chip_smoke.py        # from the repository root, one CUDA GPU

Phases, each printing one JSON line (``"phase": ...``):

1. device   the card's name and power limit (``nvidia-smi``);
2. build    ``nvcc`` builds every kernel from ``mpc_tpu_torch/ops/csrc``
            (one process per source, all at once: the KS libraries, the ST
            model's ``fused_gn_st.cu`` and ``fused_ip_st.cu`` and the KS
            boundary rows' ``fused_ip_ks_ring.cu`` (both the ring source
            ``fused_ip_ring.cu``), the sweep with its nx=5 and nx=7
            instances) into the git-ignored ``build/kernels``; registers,
            spills and static shared memory from ``-Xptxas -v`` per entry
            function, and the fused kernels' dynamic shared memory and
            launch geometry (fused_gn: threads a lane; fused_ip: lanes a
            block; the ring source: 32 lanes, its threads a lane and blocks
            an SM) at the bench shape, the ST libraries' at the ST rows'
            shape;
3. check    each kernel against its plain version on the card at the bench
            shape (KS, RK4, forcespro, H=30, B=2048 lanes of
            ``make_bench_loop``), then one small case each for
            casadi/Euler and for moving obstacles at a ragged batch (B=250,
            not a multiple of the block).
            - fused_gn (AL): the cold-start budget (3x4, unguarded), the
              warm bench point (1x1, unguarded, from the cold-start state)
              and the default ladder (3x4); the bands of
              tests/test_fused_gn.py on every lane, the warm state and the
              status on >= 99.9% of lanes.
            - fused_ip (IP): the cold-start budget (5x10, unguarded), the
              warm bench point (1x4, warm duals, unguarded, from the
              cold-start state) and the default ladder (2x6, warm duals);
              the bands of tests/test_fused_ip.py on every lane, the status
              on >= 99.9% of lanes.
            - riccati (the sweep of the xla engine): random well-conditioned
              problems with a nonzero defect (B=2048 and a ragged B=250,
              H=30), the quadratics the xla engine builds at the bench
              point's step 0 (B=16384) and the same with road-boundary rows
              (B=250); the bands of tests/test_sqp_vec.py:26-31 on every
              lane, non-finite gains on the same entries.
            - the xla engine (``sqp_vec.solve_batch_vec``) with the kernel
              sweep against the same solve with the plain sweep, at
              B=2048: al 1x1 unguarded and a 2x2 ladder.
            - the road-boundary rows' instances of both fused kernels, one
              corridor row each (hard-corridor: fused_ip_ks_ring at H=14;
              soft-corridor: fused_gn at H=30): the row's warm-up budget on
              its loop's cold start, its own budget on the solve its loop
              makes at step 50 (rows bind; the loop run on the card at
              B=2048), its own budget at a ragged B=250 on a bending road
              whose rows bind, and the plain version against itself in
              float64 at step 38, where the gates cannot hold; each check
              reports its active boundary rows; linearize_boundaries on the
              card against the CPU.
            - the ST libraries (model='st', VEHICLE_2): the same cases as
              fused_gn and fused_ip, and each boundary instance at a ragged
              B=250 on the bending road, where rows bind (AL 1x1
              unguarded, 1.7 m; IP at the hard-corridor budget, 1.9 m);
              the sweep's nx=7 instance on random 7-state problems
              (B=2048, 250) and on the ST xla engine's step-0 quadratics
              (B=16384); the ST xla engine with the kernel sweep against
              the plain sweep (B=2048).
            With the ladder on, the kernel records the rung each iteration
            committed and the plain version replays those choices: every
            choice must be the best rung, up to a relative merit regret of
            TIE_RTOL, under the plain version's merits (near-tied rungs go
            either way by rounding);
4. loop_vs_plain  the first steps of a closed loop on the card against the
            same loop on the CPU (plain version), the tests' closed-loop
            bands: the soft and hard rows, the soft xla row plain and with
            the RTI backoffs, the hard row with the status gate on stage
            0..1, both corridor rows (U within the plain loop's own spread
            when that is larger), and the soft-st and hard-st rows;
5. timing   each kernel per launch at the main path's shape (B=16384,
            H=30; AL warm 1x1 and cold 3x4, IP warm 1x4 and cold 5x10, the
            sweep on the bench point's step-0 quadratics; fused_gn at 2, 4
            and 8 threads a lane and at its own choice, the sweep at
            32/64/128 threads a block, fused_ip at 1, 2, 4, 8 and the most
            lanes a block and at its own choice (the ST ring source at its
            own); the corridor rows' own
            and warm-up budgets, with the time of linearize_boundaries
            before each launch; the ST libraries at the soft and hard
            budgets (fused_gn_st at 4 and 8 threads a lane), the sweep's
            nx=7 instance), the plain
            version's time, and the bound: the larger of
            the bytes the call must move over 3.35 TB/s and its fp32
            operations (counted on the plain version) over 67 TFLOP/s; the
            timed launches' outputs are held against the plain version's,
            as in ``check``; with them the splits, each with its bound:
            B1.b on the soft-corridor's step-50 solve at its own budget
            without its ladder and, with it, without its rows; fused_ip
            and fused_ip_st warm at 1x1 against 1x4; fused_gn_st warm at
            1x2 against 1x1 (a Gauss-Newton step);
6. loop     ``closed_loop_batch_vec`` at B=16384, H=30, T=100 with 4
            cold-start solves, for the soft row (al 1x1, ``alphas=()``), the
            hard row (ip 1x4, warm duals, ``ip_alphas=()``) and the xla row
            (the soft row on ``engine='xla'``, XLA_STEPS steps), then
            hard-corridor and
            soft-corridor inside a straight road with edges at y = +-4 m,
            then the ST rows: soft-st and hard-st (the soft and hard rows'
            budgets, model='st') and xla-st (one cold start and
            XLA_ST_STEPS steps on engine='xla', the nx=7 sweep's main
            path):
            launches of every kernel counted in that run, then solves/s
            with CUDA events, best of 3 after it (where a loop took more
            than 20 s, bound by its host, that run on the host clock), the
            peak device memory, in a corridor row
            the lane-steps where a boundary row is active, in an ST row
            the largest |beta|;
7. profile  one more loop of each row under ``torch.profiler`` (the xla
            row: steps 0..4, the corridor rows: steps 38..47, after an
            unprofiled cold start; soft-st and hard-st: steps 50..59): device time of the kernel and of the
            eager glue around it, by kernel name, and of
            linearize_boundaries in the corridor rows;

8. planner  the scenario-to-trajectory path on the per-lane solve, which
            launches none of these kernels: the float64 regression goldens
            of one AL and one IP config (``run_closed_loop`` on the card,
            tests/test_closed_loop.py's atol 1e-4); the deployment config
            (``configs/config_CA_ZAM_Over-1_1_forcespro.yaml``) through the
            CLI in a subprocess, plain (exit 0, the native library, no -7
            step) and with ``--rti1`` (exit 0), the two side by side
            and beside the goldens;
            C2's two routes, the IP wrapper past its envelope (H=64, B=64,
            float64 on both sides) and the xla IP loop (B=256, T=10), each
            with no kernel launched
            and within the bands of the CPU run; and ``torch.profiler``
            over warm steps of the deployment's loop;

9. fleet    scenario fleets (``parallel.multi``) through the fused kernels
            and the serving API: (a) the four forcespro configs of
            FLEET tiled to B=16384 lanes (ip 2x6, the ladder, boundary
            rows beside dummy ones, moving obstacles, H=12, T=100) through
            ``closed_loop_batch_vec`` on fused_ip_ks_ring alone, its
            two cold-start solves on 256 lanes held config by config
            (every config on which the plain version's float32 and
            float64 solves agree; the line names the others with that
            share; config 3's one dual that is not unique at cold start
            0 left out), its step-0 solve on 256 copies of three configs
            and its step-50 solve on 256 lanes against the plain version
            (step 0, where the plain version parts from itself on the
            deployment's copies, measured a config each), every
            lane-step feasible over its own length or held to the plain
            loop, the copies of a config within the IP bands, solves/s,
            ms a step, peak memory and a profiled window; (b) the same
            batch served by ``init_batch_carry`` and T calls of
            ``closed_loop_batch_step``, equal to (a) at atol 0; (c)
            ``BatchedOnlinePlanner.from_scenarios`` on the four configs
            for 8 disturbed steps, against the same on the CPU; (d) the
            casadi lane-following pair at B=1024 on fused_gn's ladder
            instance within 0.05 m of its goldens; (e) ``OnlinePlanner``
            on the deployment config, ms a step, no kernel;
10. sharded lanes over ranks (``parallel.mesh``, ``parallel.batch``) on
            the one card: (a) one rank, ``init_distributed('nccl')`` a
            no-op at world size 1, a (1, 1) mesh: the soft row (al 1x1,
            alphas=(), B=16384, T=20) through ``closed_loop_batch_sharded``
            equal to ``closed_loop_batch_vec`` at atol 0, on fused_gn, and
            ``summarize_loop`` equal to the host's reduction; (b) two
            ranks spawned with gloo, each on ``cuda:0`` (NCCL refuses two
            ranks on one device), a (2, 1) mesh: the same loop (8192 lanes
            a rank) and the hard row's cold 5x10 step-0 solve on fused_ip,
            each gathered and equal to the one-call result at atol 0
            where the half batch takes the same kernel instance (threads a
            lane, lanes a block), else within the loop or IP bands; (c)
            ``entry.dryrun_multichip(2)`` in the same ranks (the per-lane
            loop with the parallel-scan sweep's stages over sp=2, the
            engine-sharded loop on fused_gn, the open-loop IP solve), its
            line; (e) ``mpc_tpu_torch.entry``'s path on its defaults in
            one rank spawned as a launcher starts one (WORLD_SIZE=1): a
            group of one on NCCL, ``entry()`` and ``dryrun_multichip(1)``
            on ``cuda:0``, every collective through NCCL on the card,
            entry's results and the dry run's outcome equal at atol 0 to
            the same path in this process; that dry run passes, or fails
            exactly as ENTRY_C4 says (its open-loop IP step on the fused
            IP kernel, which leaves lane 0 unconverged in float32, as
            the JAX package's kernel does on the same step); (d) ms a
            solve of the per-lane AL path at B=16384, al 1x1,
            ``lqr_backend`` 'scan' against 'pscan', H=30 and 128;

The pieces no timed phase reads run first, in the untimed section
(``phase_untimed``): while nvcc builds, the plain loops of 4 and of C2 run
on the CPU in WORKERS worker processes, the goldens and C2 of 8 on the
card here, and each check of 3 whose library is built here; once every
library is built, the other checks, the fleet's checks of 9 (a) and the
entry point's NCCL rank of 10 (e) in the workers, the CLI's two runs of 8
in processes of their own, and the rows of 4 on the card here.  The timed
phases (5, 6, 7, the planner's profile, 9, 10) follow, with the card and
the host to themselves.

Then it prints the card's name and power limit, the kernels line (with
each kernel's launches in the fleet and the sharded phases), and as the
last line ``{"ok": true, "device": {...}}``, after an explicit teardown,
and leaves by ``os._exit``, before the C++ libraries' static destructors
(one of them aborts at times after the last line).  A phase that fails raises:
the script then exits non-zero and prints no last line.
"""
from __future__ import annotations

import dataclasses
import faulthandler
import gc
import io
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent
H = 30
B_CHECK = 2048            # lanes of the kernel-vs-plain checks
B_SMALL = 250             # lanes of the casadi and moving-obstacle checks:
                          # ragged, so the kernel's lane >= B mask is used
B_BENCH = 16384           # lanes of the bench point
T_BENCH = 100
COLD = dict(al_iters=3, sqp_iters=4, alphas=())
WARM = dict(al_iters=1, sqp_iters=1, alphas=())
IP_COLD = dict(method="ip", ip_sqp_iters=5, ip_iters=10, ip_alphas=())
IP_WARM = dict(method="ip", ip_sqp_iters=1, ip_iters=4, ip_warm_duals=True,
               ip_alphas=())
XLA_WARM = dict(engine="xla", **WARM)
# the xla row's steps after its 4 cold starts: its loop is bound by its
# host's eager launches (~0.13 s a Gauss-Newton step, PERF.md) and timed
# by its counted run, and this cut makes room in the script's time limit
# for the fleet phase
XLA_STEPS = 25
# The ST rows: the 7-state single-track model with tire dynamics
# (model='st', VEHICLE_2, which bench_loop adds) at the bench budgets of the
# soft and hard rows, on the same overtake workload (its starts lifted to
# the ST state); the xla-st row runs XLA_ST_STEPS steps after one cold
# start: its eager glue takes about a second a Gauss-Newton step on an
# H100 (PERF.md), so its counted run takes over ONE_TIMED_RUN_S and times
# it, and this is enough to count the nx=7 sweep's launches on its main
# path.
ST = dict(model="st")
SOFT_ST = dict(method="al", **WARM, **ST)
HARD_ST = dict(**IP_WARM, **ST)
XLA_ST = dict(**XLA_WARM, **ST, cold_start_solves=1)
XLA_ST_STEPS = 10
# The corridor rows: the overtake workload inside a straight two-edge road,
# the left edge at y = +CORRIDOR_Y and the right at -CORRIDOR_Y, each a
# CORRIDOR_POINTS-point polyline spanning the whole track.  hard-corridor is
# the deployment of configs/config_CA_ZAM_Over-1_1_forcespro.yaml
# (boundary_constraints, predict_horizon 15: H = 14, ip 2x6, warm duals,
# the default ladder); soft-corridor the AL solve at its default 3x4
# budget and ladder at H = 30.  Both take their warm-up budget (IP 5x10,
# AL 3x4) in the cold starts.
CORRIDOR_Y = 4.0
CORRIDOR_POINTS = 128
HARD_CORRIDOR = dict(method="ip", ip_sqp_iters=2, ip_iters=6,
                     ip_warm_duals=True, boundary_rows=True, horizon=14,
                     corridor=True)
SOFT_CORRIDOR = dict(method="al", al_iters=3, sqp_iters=4,
                     boundary_rows=True, corridor=True)
# Where the corridor rows' checks and timing take their inputs: the solve
# each loop makes at LOOP_CHECK_STEP (the car still against the left edge,
# leaving it), and, for the warm-up budget, the loop's own cold start at
# step 0 (the edges 2.85 m off: no row binds there).  Where the car runs
# along the edge (steps ~35-47) the plain version's own float32 and float64
# solves part on the status of many lanes (the stationarity straddles its
# threshold; the IP duals of the three circles' rows against one edge are
# degenerate), so no two float32 implementations meet the gates there;
# GATE_STEP is where the check line measures that.
LOOP_CHECK_STEP = 50
GATE_STEP = 38
ROAD_STEP = 32       # a step whose window bends (the swerve's rise)
ACTIVE_BAND = 0.05   # a boundary row within this of r_ego is active
HBM_BYTES_PER_S = 3.35e12                    # H100 SXM, data sheet
FP32_OPS_PER_S = 67e12                       # H100 SXM, fp32 non-tensor
# (rtol, atol) of tests/test_fused_gn.py:42-55
BANDS = {"U": (2e-3, 2e-3), "X": (2e-3, 2e-2), "viol": (0.0, 1e-3),
         "cost": (1e-3, 1e-2)}
STATE_BANDS = {"mu": (1e-3, 1e-3), "lam_lo": (2e-2, 2e-2),
               "lam_hi": (2e-2, 2e-2)}
MIN_LANE_AGREEMENT = 0.999
# A lane outside a band is excused when the plain version's own float32 and
# float64 solves (committing the same rungs) part by more than that band on
# it: an ill-conditioned QP (duals ~1e3, stationarity ~1e4) where float32
# rounding alone decides the digits the band reads.  Such lanes are found
# from the plain version alone, and at most this share of a case's lanes
# may be excused (tests/test_torch_chip_smoke.py names two of 2048).
MAX_ROUNDING_SHARE = 0.01
# (rtol, atol) of tests/test_fused_ip.py:41-57, held on every lane; the
# carried duals z_hi there too, z_lo (not among those bands) on 99.9%.  The
# stationarity takes KKT_ATOL in place of those tests' 5e-3: at a converged
# iterate it is the float32 rounding of qu + B' lam, and the plain version
# alone parts from its float64 self by more than 5e-3 on some lanes
# (tests/test_torch_chip_smoke.py); KKT_ATOL is 1/20 of tol_stat_ip, the
# threshold the status reads it against.
KKT_ATOL = 5e-2
IP_BANDS = {"U": (2e-3, 2e-3), "X": (2e-3, 2e-2), "viol": (0.0, 1e-3),
            "cost": (1e-3, 1e-2), "kkt_stat": (5e-2, KKT_ATOL)}
IP_STATE_BANDS = {"lam_hi": (5e-2, 5e-2), "lam_lo": (5e-2, 5e-2)}
# (rtol, atol) of the Riccati sweep's gains, tests/test_sqp_vec.py:26-31;
# dV2 (a sum of d'(Quu + reg)d >= 0, as dV1 is of d'gu <= 0) in dV1's band
RIC_BANDS = {"K": (2e-3, 2e-3), "d": (2e-3, 2e-3), "dV1": (1e-2, 0.0),
             "dV2": (1e-2, 0.0)}
# A loop whose counted run takes longer than this is timed once, not best
# of 3 (as is a loop on engine='xla', host-bound however short)
ONE_TIMED_RUN_S = 20.0
# A ladder choice may lose to the best rung by rounding: at most this much
# of max(|best merit|, 1) under the plain version's merits.  The plain
# version's own float32 choices stay well inside it under its float64
# merits, and a ladder stuck at alpha = 0 is far outside it
# (tests/test_torch_chip_smoke.py).
TIE_RTOL = 1e-4
# The planner phase: the scenario-to-trajectory path on the per-lane solve.
# The float64 regression goldens of tests/test_closed_loop.py:179-208 (one
# AL and one IP config, each T=30) at that test's tolerance; the deployment
# config through the CLI; C2's two routes (the IP wrapper outside its
# kernel's envelope, the xla loop with method='ip') at the given shapes; and
# a profile of PROFILE_STEPS warm steps of the deployment's loop.
PLANNER_GOLDENS = (("config_LF_ZAM_Over-1_1.yaml", "zam_lf_casadi"),
                   ("config_CA_ZAM_Over-1_1_forcespro_ref.yaml",
                    "zam_ca_forcespro"))
GOLDEN_RTOL, GOLDEN_ATOL = 1e-7, 1e-4   # np.testing.assert_allclose there
DEPLOYMENT = "config_CA_ZAM_Over-1_1_forcespro.yaml"
# the JAX package's CLI on the CPU, deterministic, for comparison only: the
# CA loops are chaotic across backends in float32
JAX_CPU_STATUS_COUNTS = {"default": {"0": 18, "1": 12},
                         "rti1": {"-7": 2, "0": 24, "1": 4}}
C2_SOLVE = dict(horizon=64, lanes=64)   # H=64: past the IP kernel's 63
C2_LOOP = dict(lanes=256, steps=10)
LOOP_BANDS = {"X": 5e-2, "U": 5e-3}     # tests/test_torch_closed_loop.py
PROFILE_STEPS = 3
# loop_vs_plain: each row's budget, its lanes and steps
LOOP_VS_PLAIN_ROWS = {
    "soft": WARM, "hard": IP_WARM, "soft-xla": XLA_WARM,
    "soft-xla-backoff": dict(rti_margin=0.1, rti_amax_scale=0.9,
                             **XLA_WARM),
    "hard-gate1": dict(gate_stages=1, **IP_WARM),
    "hard-corridor": HARD_CORRIDOR, "soft-corridor": SOFT_CORRIDOR,
    "soft-st": SOFT_ST, "hard-st": HARD_ST}
LVP_LANES, LVP_STEPS = 64, 10


_captured = None   # the lines a worker's task emits, or None: print them


def emit(obj):
    if _captured is not None:
        _captured.append(obj)
    else:
        print(json.dumps(obj), flush=True)


class CheckFailed(RuntimeError):
    pass


def require(cond, what):
    if not cond:
        raise CheckFailed(what)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    emit({"phase": "device", "gpu": torch.cuda.get_device_name(0),
          "nvidia_smi": card, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return card


def ptxas_entries(text):
    """Per entry function in ``-Xptxas -v`` output: registers, spill stores
    and loads, stack frame and static shared memory (bytes)."""
    out = {}
    for block in text.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]

        def first(pattern, group=1):
            m = re.search(pattern, block)
            return int(m.group(group)) if m else None
        out[name] = {
            "registers": first(r"Used (\d+) registers"),
            "spill_stores": first(r"(\d+) bytes spill stores"),
            "spill_loads": first(r"(\d+) bytes spill loads"),
            "stack_frame": first(r"(\d+) bytes stack frame"),
            "static_smem_bytes": first(r"(\d+) bytes smem") or 0}
    return out


def main_entry(entries, instance=1, boundary=False, ladder=False):
    """The entry function the main path launches: the only one, or the
    template instance ``instance`` (fused_ip: one stage a thread, H + 1 <=
    32; the ring source and fused_gn: the threads a lane it takes at the
    bench shape; riccati: the state dimension, 5 or 7), with or without the
    road-boundary rows (the template's first ``bool``, ``Lb1E`` after the
    instance in the mangled name) and, in the KS fused_gn, the merit
    ladder (its ``int`` after the model's name, ``Li1E``; the ST library's
    one instance, ``Lin1E``, takes either)."""
    if len(entries) == 1:
        return next(iter(entries.values()))
    return next(v for k, v in entries.items()
                if f"ILi{instance}E" in k
                and (f"ILi{instance}ELb1E" in k) == boundary
                and ("ModelLin1E" in k or ("ModelLi1E" in k) == ladder))


def phase_build():
    """Build every kernel (waiting for the nvcc processes
    ``_build.start_all`` started); per kernel the registers, spills and shared
    memory a block of its main-path entry (static from ``-Xptxas -v``; the
    fused kernels' dynamic shared memory and geometry at the bench shape),
    and every entry function's figures."""
    from mpc_tpu_torch.ops import _build
    from mpc_tpu_torch.ops import fused_gn as F
    from mpc_tpu_torch.ops import fused_ip as FI
    logs = _build.build_all()
    seconds = _build.seconds()

    def geometry(kw):
        lcfg, _ = bench_loop(n_lanes=B_BENCH, device="cpu", **kw)
        geo = (FI.geometry if lcfg.solver.method == "ip" else F.geometry)
        # the AL kernel's ladder instance where the row runs its ladder
        ladder = lcfg.solver.method == "al" and bool(lcfg.solver.alphas)
        return dict(geo(lcfg.solver, B_BENCH), ladder=ladder)
    # each fused library at its row's shape (the KS IP library with the
    # boundary rows, whose only instance they are, at the hard-corridor
    # row's); the other boundary instances at the soft-corridor row's (KS)
    # and at H=30 with the ST rows' budgets (ST)
    geos = {"fused_gn": geometry(WARM), "fused_ip": geometry(IP_WARM),
            "fused_gn_st": geometry(SOFT_ST), "fused_ip_st": geometry(HARD_ST),
            "fused_ip_ks_ring": geometry(HARD_CORRIDOR)}
    bgeos = {"fused_gn": geometry(SOFT_CORRIDOR),
             "fused_gn_st": geometry(dict(SOFT_ST, boundary_rows=True)),
             "fused_ip_st": geometry(dict(HARD_ST, boundary_rows=True))}
    info = {}
    for name, text in logs.items():
        _build.load(name)
        entries = ptxas_entries(text)
        geo = geos.get(name)
        instance = (geo["threads_per_lane"] if "threads_per_lane" in
                    (geo or {}) else 5 if name == "riccati" else 1)
        info[name] = dict(main_entry(entries, instance,
                                     ladder=(geo or {}).get("ladder", False)),
                          entries=entries)
        info[name]["smem_bytes_per_block"] = (
            geo["smem_bytes_per_block"] if geo
            else info[name]["static_smem_bytes"])
        if geo:
            info[name]["geometry"] = geo
        if name == "riccati":   # the ST model's instance, nx=7
            info[name]["st_instance"] = main_entry(entries, 7)
        if name in bgeos:   # the boundary rows' instance at its row's shape
            bgeo = bgeos[name]
            instance = bgeo.get("threads_per_lane", 1)
            info[name]["boundary_instance"] = dict(
                main_entry(entries, instance, boundary=True,
                           ladder=bgeo["ladder"]),
                smem_bytes_per_block=bgeo["smem_bytes_per_block"],
                geometry=bgeo)
    emit({"phase": "build", "seconds": max(seconds.values(), default=0.0),
          "seconds_by_library": seconds, "kernels": info})
    return info


def bench_loop(horizon=H, corridor=False, **kw):
    """``make_bench_loop`` on the bench's track (T=100 steps long): a
    shorter track puts the obstacle within a horizon of the start, where
    the loop turns chaotic; with ``corridor`` inside the straight corridor
    (:func:`with_corridor`); the ST model with VEHICLE_2."""
    from mpc_tpu_torch.models.vehicle import VEHICLE_2
    from mpc_tpu_torch.utils import synthetic
    if kw.get("model") == "st":
        kw.setdefault("vehicle", VEHICLE_2)
    lcfg, lp = synthetic.make_bench_loop(T_BENCH, horizon, **kw)
    return lcfg, with_corridor(lp) if corridor else lp


def with_corridor(lp, y=CORRIDOR_Y, n=CORRIDOR_POINTS):
    """``lp`` inside a straight corridor spanning its whole track, given to
    every lane: the left edge at y directed -x, the right at -y directed
    +x, each an n-point polyline, signs +1 (inside positive)."""
    px = lp.track.path[..., 0]
    xs = torch.linspace(float(px.max()) + 50.0, float(px.min()) - 50.0, n,
                        dtype=px.dtype, device=px.device)
    left = torch.stack([xs, torch.full_like(xs, y)], -1)
    right = torch.stack([xs.flip(0), torch.full_like(xs, -y)], -1)
    B = lp.x_init.shape[0]
    return lp._replace(
        boundaries=torch.stack([left, right]).expand(B, 2, n, 2).contiguous(),
        boundary_signs=torch.ones((B, 2), dtype=px.dtype, device=px.device))


def ocp_at(lcfg, lp, step=0):
    """The OCP of closed-loop step ``step`` from the initial states (step 0
    is what the cold start solves)."""
    from mpc_tpu_torch.planner import closed_loop as cl
    window, step_obs, make_ocp = cl._batch_helpers(lcfg, lp)
    n = lp.x_init.shape[0]
    bases = torch.zeros((n,), dtype=torch.int64, device=lp.x_init.device)
    x_ref, _ = window(step, lp.x_init, bases)
    return make_ocp(lp.x_init, x_ref, step_obs(step))


def max_abs(a, b):
    return float((a.double() - b.double()).abs().nan_to_num(
        float("inf")).max())


def lanes_close(a, b, rtol, atol):
    """Per lane: every element within the band (NaN equal to NaN)."""
    ok = torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=True)
    return ok.reshape(ok.shape[0], -1).all(1)


def rung_regret(chosen, merits, best=None):
    """Per lane: how much the chosen rung's merit exceeds that of the rung
    the ladder's rule picks, relative to max(|that merit|, 1).  The fused
    kernels' rule (``best`` None): the first of least merit; a NaN trial
    never wins, and a NaN at alpha = 0 keeps the iterate.  The xla
    engine's picks come as ``best``."""
    m = merits.double()
    if best is None:
        best = torch.where(m[0].isnan(), 0,
                           m.nan_to_num(nan=float("inf")).argmin(0))
    best = best.long()
    mc = m.gather(0, chosen.long()[None])[0]
    mb = m.gather(0, best[None])[0]
    reg = ((mc - mb) / mb.abs().clamp(min=1.0)).nan_to_num(nan=float("inf"))
    return torch.where((chosen.long() == best) | (mc == mb),
                       torch.zeros_like(reg), reg)


class Engine(NamedTuple):
    """One fused kernel as ``chip_smoke`` drives it."""

    name: str
    replaces: str              # file:line of the TPU kernel
    pack: Callable             # (cfg, ocp, state, trace_rungs) -> bufs
    launch: Callable           # (cfg, bufs, geometry); counts its launches
    unpack: Callable           # bufs -> the plain version's output tuple
    plain: Callable            # (cfg, ocp, state, rungs, follow) -> outputs
    solution: Callable         # (cfg, outputs, state) -> Solution
    ladder: Callable           # cfg -> whether the ladder is on
    budget: Callable           # cfg -> "3x4"
    bands: dict                # Solution fields: (rtol, atol), every lane
    state_bands: dict          # state fields: (rtol, atol, lanes needed)
    kernel_io: tuple           # (inputs, in-place state, outputs) names
    geometry: str              # the launch knob: "threads_per_lane" or
                               # "lanes_per_block"
    sweep: Callable            # cfg -> the values of the knob to time
    default: int               # the knob's default (0: the kernel picks)


def engine(cfg) -> Engine:
    """The kernel that solves ``cfg``'s method and model."""
    from mpc_tpu_torch.ops import fused_gn as F
    from mpc_tpu_torch.ops import fused_ip as FI
    from mpc_tpu_torch.ops import sqp as S
    st = cfg.model == "st"
    if cfg.method == "ip":
        return Engine(
            FI.ip_library(cfg),
            "mpc_tpu/ops/fused_ip.py:93 (_make_ip_kernel"
            + (", model='st': :100-108)" if st else
               ", boundary rows: :765, :783)" if cfg.boundary_rows else ")"),
            FI.pack_ip, FI.launch_ip, FI.unpack_ip,
            FI.solve_batch_fused_ip_plain,
            lambda c, out, st: FI.to_solution_ip(c, out, st.mu),
            lambda c: bool(c.ip_alphas),
            lambda c: f"{c.ip_sqp_iters}x{c.ip_iters}", IP_BANDS,
            {"lam_hi": (*IP_STATE_BANDS["lam_hi"], 1.0),
             "lam_lo": (*IP_STATE_BANDS["lam_lo"], MIN_LANE_AGREEMENT)},
            (FI.KERNEL_INPUTS, FI.KERNEL_STATE, FI.KERNEL_OUTPUTS),
            "lanes_per_block",
            lambda c: (0,) if FI.ring_kernel(c) else ip_lane_sweep(
                FI.geometry(c, B_BENCH)["max_lanes_per_block"]), 0)
    return Engine(
        F.kernel_name(cfg), "mpc_tpu/ops/fused_gn.py:808 (_make_kernel"
        + (", model='st': :814-822)" if st else ")"),
        F.pack, F.launch, F.unpack, F.solve_batch_fused_plain,
        lambda c, out, st: F.to_solution(c, out), lambda c: bool(c.alphas),
        lambda c: f"{c.al_iters}x{c.sqp_iters}", BANDS,
        {f: (*b, MIN_LANE_AGREEMENT) for f, b in STATE_BANDS.items()},
        (F.KERNEL_INPUTS, F.KERNEL_STATE, F.KERNEL_OUTPUTS),
        "threads_per_lane",
        lambda c: (0,) + F.threads_per_lane_of(S.solver_nx(c)), 0)


def ip_lane_sweep(most):
    """Lanes a block to time the IP kernel at: 1, 2, 4, 8 and ``most``, the
    most whose block fits an SM (registers and shared memory), with 0 (the
    kernel's own choice)."""
    return (0,) + tuple(sorted({n for n in (1, 2, 4, 8) if n < most}
                               | {most}))


def compare(name, cfg, ocp, state, bufs=None, plain=None):
    """Kernel vs plain version on the card, on every lane.

    ``bufs``: the kernel's buffers after a launch on (cfg, ocp, state), or
    None to launch here; ``plain``: the plain version's outputs on the same
    inputs, or None to compute them (with the ladder on, the plain version
    always runs here, replaying the kernel's rungs).  The gates are
    :func:`hold`'s.  Returns (kernel Solution, max abs errors)."""
    eng = engine(cfg)
    ladder = eng.ladder(cfg)
    if bufs is None:
        bufs = eng.pack(cfg, ocp, state, trace_rungs=ladder)
        eng.launch(cfg, bufs)
    ker = eng.solution(cfg, eng.unpack(bufs), state)
    if "status" in bufs:   # fused_gn writes the status itself
        require(torch.equal(bufs["status"], ker.status),
                f"{name}: the kernel's status is not the mapping of its "
                "diagnostics")
    extra, rungs, trace = {}, None, None
    if ladder:
        rungs, trace, own = bufs["rung"], [], []
        plain = eng.plain(cfg, ocp, state, trace, follow=rungs)
        free = eng.solution(cfg, eng.plain(cfg, ocp, state, own), state)
        differs = rungs != torch.stack([r for r, _ in own])
        extra = {
            "rung_choices_unlike_free_plain": int(differs.sum()),
            "lanes_unlike_free_plain": int(differs.any(0).sum()),
            "status_agreement_free_plain":
                float((ker.status == free.status).double().mean())}
    elif plain is None:
        plain = eng.plain(cfg, ocp, state)
    pln = eng.solution(cfg, plain, state)
    torch.cuda.synchronize()
    return ker, hold(name, cfg, ocp, state, ker, pln, rungs, trace, extra)


def hold(name, cfg, ocp, state, ker, pln, rungs=None, trace=None,
         extra=None, p64=None, unheld=None):
    """The gates of a kernel's solution ``ker`` against the plain
    version's ``pln`` on the same inputs, on every lane: each band of the
    engine on every lane (a lane excused where the plain version's own
    float32 and float64 solves part by more than the band, at most
    MAX_ROUNDING_SHARE of the lanes), the duals and the status on their
    shares of lanes, and with the ladder (``rungs`` the kernel's choices,
    ``trace`` the plain version's merits replaying them) each choice within
    TIE_RTOL of the best rung.  ``p64``: the plain float64 solution
    replaying the same rungs, or None to compute it where needed.
    ``unheld`` {dual: bool mask of its entries}: entries left out of the
    dual's band, their departure reported.  Emits the check line; returns
    the max abs errors."""
    eng = engine(cfg)
    extra = dict(extra or {})
    if rungs is not None:
        regret = torch.stack([rung_regret(c, m)
                              for c, (_, m) in zip(rungs, trace)])
        extra.update(max_rung_regret=float(regret.max()),
                     rung_choices=int(rungs.numel()))
    errs, agree, need = {}, {}, {}
    inband = {f: lanes_close(getattr(ker, f), getattr(pln, f), *band)
              for f, band in eng.bands.items()}
    noisy = rounding_lanes(eng, cfg, ocp, state, pln, inband, rungs, p64)
    for f in eng.bands:
        errs[f] = max_abs(getattr(ker, f), getattr(pln, f))
        agree[f] = float((inband[f] | noisy[f]).double().mean())
        need[f] = 1.0
    n_noisy = int(torch.stack(list(noisy.values())).any(0).sum())
    extra["rounding_lanes"] = n_noisy
    for f, (rtol, atol, lanes) in eng.state_bands.items():
        a, b = getattr(ker.state, f), getattr(pln.state, f)
        if unheld and f in unheld:
            mask = unheld[f]
            per_lane = mask.reshape(len(mask), -1).sum(1)
            extra.setdefault("unheld", {})[f] = {
                "entries_a_lane": int(per_lane.max()),
                "lanes": int((per_lane > 0).sum()),
                "max_abs_err": max_abs(a[mask], b[mask])}
            a = torch.where(mask, b, a)
        errs[f] = max_abs(a, b)
        agree[f] = float(lanes_close(a, b, rtol, atol).double().mean())
        need[f] = lanes
    agree["status"] = float((ker.status == pln.status).double().mean())
    need["status"] = MIN_LANE_AGREEMENT
    if cfg.boundary_rows:   # a check where no boundary row binds proves little
        extra["active_boundary_rows"] = active_boundary_rows(
            cfg, ker.X, ocp.boundaries, ocp.boundary_signs)
    line = {"phase": "check", "kernel": eng.name, "case": name,
            "lanes": int(ocp.x0.shape[0]), "budget": eng.budget(cfg),
            "alphas": list(cfg.ip_alphas if cfg.method == "ip"
                           else cfg.alphas),
            "formulation": cfg.formulation, "integrator": cfg.integrator,
            "moving": ocp.obs_centers.dim() == 4, "max_abs_err": errs,
            "lane_agreement": agree, "lane_agreement_needed": need, **extra,
            "kernel_feasible_lanes": int((ker.status >= 0).sum()),
            "finite": bool(torch.isfinite(ker.X).all())}
    emit(line)
    short = [f for f in agree if agree[f] < need[f]]
    require(not short, f"{name}: kernel and plain version agree on too few "
                       f"lanes in {short}")
    require(n_noisy <= MAX_ROUNDING_SHARE * len(ker.status),
            f"{name}: {n_noisy} lanes where float32 rounding alone leaves "
            "the bands")
    require(rungs is None or extra["max_rung_regret"] <= TIE_RTOL,
            f"{name}: the kernel committed a rung worse than the best by "
            f"{extra.get('max_rung_regret')} of its merit")
    return errs


def as_float64(ocp, state):
    def f64(t):
        return t.double() if t.is_floating_point() else t
    return (ocp._replace(x0=f64(ocp.x0), x_ref=f64(ocp.x_ref),
                         obs_centers=f64(ocp.obs_centers),
                         min_dist=f64(ocp.min_dist),
                         weights=ocp.weights.map(f64)), state.map(f64))


def rounding_lanes(eng, cfg, ocp, state, pln, inband, follow, p64=None):
    """Per band field, the lanes whose band lies below float32 rounding:
    the plain version in float64 (committing the same rungs; ``p64`` when
    given) parts from the float32 one by more than the band.  They depend
    on the inputs and the plain version alone, never on the kernel, and
    are computed only when some lane of the kernel is outside a band."""
    if all(bool(v.all()) for v in inband.values()):
        return {f: torch.zeros_like(v) for f, v in inband.items()}
    if p64 is None:
        ocp64, st64 = as_float64(ocp, state)
        p64 = eng.solution(cfg, eng.plain(cfg, ocp64, st64, follow=follow),
                           st64)
    return {f: ~lanes_close(getattr(pln, f).double(), getattr(p64, f), *band)
            for f, band in eng.bands.items()}


def moving_obstacles(ocp, dev):
    """The static obstacle of ``ocp`` drifting along the horizon."""
    drift = torch.arange(H + 1, device=dev, dtype=torch.float32)[:, None,
                                                                   None]
    drift = drift * torch.tensor([0.3, 0.05], device=dev)
    return ocp._replace(obs_centers=ocp.obs_centers[:, None] + drift)


def _checks(dev, cases, model, prefix):
    """compare() on each (name, cold_kw, budget_kw, lanes, mode, step,
    moving, warm) of ``cases`` with the ``model`` kwargs: the solve of
    ``budget_kw`` on the bench loop's OCP at ``step``, from init_state, or
    from the state the cold budget leaves when ``warm``."""
    from mpc_tpu_torch.ops import sqp as S
    results, cold = {}, {}
    for name, cold_kw, kw, lanes, mode, step, moving, warm in cases:
        lcfg, lp = bench_loop(n_lanes=lanes, device=dev, mode=mode,
                              **cold_kw, **model)
        ocp = ocp_at(lcfg, lp, step)
        if moving:
            ocp = moving_obstacles(ocp, dev)
        cfg = dataclasses.replace(lcfg.solver, **kw)
        st = (cold[lanes] if warm else
              S.init_state(lcfg.solver, device=dev, batch=lanes))
        ker, results[prefix + name] = compare(prefix + name, cfg, ocp, st)
        if not kw:
            cold[lanes] = ker.state
    return results


def phase_check(dev, **model):
    """The AL kernel's checks (of ``model``'s library: KS, or ST with
    model='st'): the cold-start and warm bench budgets, the default ladder,
    casadi/Euler (step 1: casadi's step-0 window is the current state held
    in place) and moving obstacles."""
    from mpc_tpu_torch.ops import sqp as S
    small = dict(al_iters=2, sqp_iters=2)
    return _checks(dev, (
        ("cold_3x4", COLD, {}, B_CHECK, "forcespro", 0, False, False),
        ("warm_1x1", COLD, WARM, B_CHECK, "forcespro", 0, False, True),
        ("ladder_3x4", COLD, dict(alphas=S.SolverConfig(horizon=H).alphas),
         B_CHECK, "forcespro", 0, False, False),
        ("casadi_euler_2x2_ladder", small, {}, B_SMALL, "casadi", 1, False,
         False),
        ("moving_2x2", dict(small, alphas=()), {}, B_SMALL, "forcespro", 0,
         True, False)), model, "st_" if model else "")


def phase_check_ip(dev, **model):
    """The IP kernel's checks (of ``model``'s library): the cold-start and
    warm bench budgets, the default ladder, casadi/Euler and moving
    obstacles."""
    from mpc_tpu_torch.ops import sqp as S
    ladder = dict(ip_sqp_iters=2, ip_iters=6, ip_warm_duals=True)
    return _checks(dev, (
        ("ip_cold_5x10", IP_COLD, {}, B_CHECK, "forcespro", 0, False, False),
        ("ip_warm_1x4", IP_COLD, IP_WARM, B_CHECK, "forcespro", 0, False,
         True),
        ("ip_ladder_2x6", IP_COLD, dict(
            ladder, ip_alphas=S.SolverConfig(horizon=H).ip_alphas), B_CHECK,
         "forcespro", 0, False, False),
        ("ip_casadi_euler_2x6_ladder", dict(method="ip", **ladder), {},
         B_SMALL, "casadi", 1, False, False),
        ("ip_moving_2x6", dict(method="ip", ip_sqp_iters=2, ip_iters=6,
                               ip_alphas=()), {}, B_SMALL, "forcespro", 0,
         True, False)), model, "st_" if model else "")


def phase_check_st_roads(dev):
    """The ST libraries' boundary-row instances at a ragged B=250 on the
    bending road of :func:`on_curved_road`, where rows bind: the AL kernel
    at the soft-st row's budget (al 1x1, unguarded, H=30, 1.7 m either
    side; at 3x4, with the default ladder or without, the plain version's
    own float32 and float64 solves part on 9% and more of the lanes in U,
    and at 2x2 a friction row active at its bound flips the penalty growth
    of a lane by rounding, PERF.md), the IP kernel at the hard-corridor
    budget (ip 2x6, warm duals, the default ladder, H=14, 1.9 m).  Returns
    (max abs errors, launches) of each check: only the boundary instance
    launches here, so the ST library's count is its boundary instance's."""
    from mpc_tpu_torch.ops import sqp as S
    results, launches = {}, {}
    for kw, half_width in ((dict(WARM, boundary_rows=True), 1.7),
                           (HARD_CORRIDOR, 1.9)):
        kw = {k: v for k, v in kw.items() if k != "corridor"}
        lcfg, lp = bench_loop(n_lanes=B_SMALL, device=dev, **kw, **ST)
        cfg = lcfg.solver
        require(cfg.boundary_rows, "an ST road check without boundary rows")
        name = (f"st_road{half_width}_{cfg.method}_"
                f"{engine(cfg).budget(cfg)}")
        ocp = on_curved_road(lcfg, lp, half_width)
        reset_launch_counts()
        ker, results[name] = compare(
            name, cfg, ocp, S.init_state(cfg, device=dev, batch=B_SMALL))
        launches[name] = launch_counts()[engine(cfg).name]
        require(launches[name] > 0, f"{name}: the kernel never launched")
        require(active_boundary_rows(cfg, ker.X, ocp.boundaries,
                                     ocp.boundary_signs) > 0,
                f"{name}: no boundary row binds")
    return results, launches


def loop_inputs(dev, lcfg, lp, steps):
    """{step: (ocp, state)}: the inputs the closed loop of ``lcfg`` hands
    its solve at each of ``steps``, the loop run on the card."""
    from mpc_tpu_torch.planner import closed_loop as cl
    carry = cl.init_batch_carry(lcfg, lp, dev)
    window, step_obs, make_ocp = cl._batch_helpers(lcfg, lp)
    out = {}
    for k in range(max(steps) + 1):
        if k in steps:
            _, x, st, _, bases = carry
            out[k] = (make_ocp(x, window(k, x, bases)[0], step_obs(k)), st)
        carry, _ = cl.closed_loop_batch_step(lcfg, lp, carry, device=dev)
    return out


def kernel_solve(cfg, ocp, state):
    """One launch of ``cfg``'s kernel: (its Solution, the rungs it
    committed (iterations, B) with the ladder on, else None)."""
    eng = engine(cfg)
    bufs = eng.pack(cfg, ocp, state, trace_rungs=eng.ladder(cfg))
    eng.launch(cfg, bufs)
    return (eng.solution(cfg, eng.unpack(bufs), state),
            bufs["rung"] if eng.ladder(cfg) else None)


def gate_calibration(name, cfg, ocp, state, kernel=False, groups=1):
    """The plain version's own float32 and float64 solves at one input:
    the share of lanes on which they agree in status and within each band
    (no gate: it says where the gates can hold).  With ``kernel``, the
    kernel launches once, both solves replay its rungs, and the line adds
    the share of lanes on which the kernel agrees with the float32 one,
    the state bands (the duals) included.  With ``groups`` > 1 each share
    is a list, a group of lanes (lane % ``groups``: a config of a tiled
    fleet) each.  Returns the solutions: ``ker`` (None without
    ``kernel``), ``p32`` and ``p64``, and the kernel's ``rungs`` with the
    float32 solve's merits replaying them (``trace``), or None."""
    eng = engine(cfg)

    def share(ok):
        out = [float(ok[g::groups].double().mean()) for g in range(groups)]
        return out if groups > 1 else out[0]
    follow, trace, ker, line = None, None, None, {}
    if kernel:
        ker, follow = kernel_solve(cfg, ocp, state)
        trace = None if follow is None else []
    p32 = eng.solution(cfg, eng.plain(cfg, ocp, state, trace, follow=follow),
                       state)
    ocp64, st64 = as_float64(ocp, state)
    p64 = eng.solution(cfg, eng.plain(cfg, ocp64, st64, follow=follow), st64)
    torch.cuda.synchronize()
    agree = {f: share(lanes_close(getattr(p32, f).double(), getattr(p64, f),
                                  *band))
             for f, band in eng.bands.items()}
    agree["status"] = share(p32.status == p64.status)
    if kernel:
        line["kernel_vs_plain_float32_lane_agreement"] = {
            **{f: share(lanes_close(getattr(ker, f), getattr(p32, f), *band))
               for f, band in eng.bands.items()},
            **{f: share(lanes_close(getattr(ker.state, f),
                                    getattr(p32.state, f), rtol, atol))
               for f, (rtol, atol, _) in eng.state_bands.items()},
            "status": share(ker.status == p32.status)}
        line["kernel_vs_plain_float32_max_abs_err"] = {
            **{f: max_abs(getattr(ker, f), getattr(p32, f))
               for f in eng.bands},
            **{f: max_abs(getattr(ker.state, f), getattr(p32.state, f))
               for f in eng.state_bands}}
    emit({"phase": "check", "kernel": eng.name, "case": name,
          "lanes": int(ocp.x0.shape[0]), "budget": eng.budget(cfg),
          "plain_float32_vs_float64_lane_agreement": agree, **line,
          "active_boundary_rows": active_boundary_rows(
              cfg, p32.X, ocp.boundaries, ocp.boundary_signs)})
    return {"ker": ker, "p32": p32, "p64": p64, "rungs": follow,
            "trace": trace}


def hold_by_config(name, cfg, ocp, state, groups, unheld=None):
    """A tiled fleet's solve (lane i a copy of config i % ``groups``) held
    to the plain version config by config: one launch and the plain
    float32 and float64 solves replaying its rungs
    (:func:`gate_calibration`'s, whose line it emits), then :func:`hold`'s
    gates on the copies of every config on which the plain version agrees
    with itself: its float32 and float64 solves part, in status or a band,
    on at most MAX_ROUNDING_SHARE of the config's copies.  The check line
    names the configs held and, for each left out, that share.
    ``unheld`` {config: (dual, stage, row)}: an entry no solve can hold
    (a dual that is not unique there), left out of that config's band.
    Returns (max abs errors, the configs held)."""
    from mpc_tpu_torch.ops import sqp as S
    eng = engine(cfg)
    cal = gate_calibration(f"{name}_by_config", cfg, ocp, state,
                           kernel=True, groups=groups)
    p32, p64 = cal["p32"], cal["p64"]
    parted = p32.status != p64.status
    for f, band in eng.bands.items():
        parted |= ~lanes_close(getattr(p32, f).double(), getattr(p64, f),
                               *band)
    share = [float(parted[g::groups].double().mean()) for g in range(groups)]
    held = [g for g in range(groups) if share[g] <= MAX_ROUNDING_SHARE]
    require(held, f"{name}: the plain version parts from itself on every "
                  f"config: {share}")
    config = torch.arange(len(parted), device=parted.device) % groups
    idx = torch.isin(config, torch.tensor(held, device=config.device))
    idx = idx.nonzero()[:, 0]

    def take(tree):
        return S.map_tensors(tree, lambda t: t[idx] if t.dim() else t)
    masks = {}
    for g, (f, k, r) in (unheld or {}).items():
        m = masks.setdefault(f, torch.zeros_like(getattr(p32.state, f),
                                                 dtype=torch.bool))
        m[config == g, k, r] = True
    rungs, trace = cal["rungs"], cal["trace"]
    if rungs is not None:
        rungs = rungs[:, idx]
        trace = [(r[idx], m[:, idx]) for r, m in trace]
    extra = {"configs_held": held,
             "configs_left_out": {str(g): {
                 "plain_float32_vs_float64_lanes_parted": share[g]}
                 for g in range(groups) if g not in held}}
    errs = hold(name, cfg, take(ocp), take(state), take(cal["ker"]),
                take(p32), rungs, trace, extra, p64=take(p64),
                unheld={f: m[idx] for f, m in masks.items()})
    return errs, held


def phase_check_corridor(dev, row, kw, half_width):
    """A corridor row's boundary-row instance against its plain version:
    at B=2048 its warm-up budget on the loop's own cold start (step 0) and
    its own budget on the solve its loop makes at LOOP_CHECK_STEP; at a
    ragged B=250 its own budget on the bending road of
    :func:`on_curved_road`, ``half_width`` m either side.  The last two
    must bind.  Then the plain version against itself in float64 on the
    loop's solve at GATE_STEP, where the car runs along the edge."""
    from mpc_tpu_torch.ops import sqp as S
    from mpc_tpu_torch.planner import closed_loop as cl
    results = {}
    lcfg, lp = bench_loop(n_lanes=B_CHECK, device=dev, **kw)
    eng = engine(lcfg.solver)
    wcfg, cfg = cl._warmup_cfg(lcfg), lcfg.solver
    name = f"{row}_step0_warmup_{eng.budget(wcfg)}"
    _, results[name] = compare(name, wcfg, ocp_at(lcfg, lp),
                               S.init_state(cfg, device=dev, batch=B_CHECK))
    ins = loop_inputs(dev, lcfg, lp, (GATE_STEP, LOOP_CHECK_STEP))
    name = f"{row}_step{LOOP_CHECK_STEP}_{eng.budget(cfg)}"
    ker, results[name] = compare(name, cfg, *ins[LOOP_CHECK_STEP])
    binding = [active_boundary_rows(cfg, ker.X, ins[LOOP_CHECK_STEP][0]
                                    .boundaries, lp.boundary_signs)]
    lcfg, lp = bench_loop(n_lanes=B_SMALL, device=dev, **kw)
    name = f"{row}_road{half_width}_{eng.budget(cfg)}"
    ocp = on_curved_road(lcfg, lp, half_width)
    ker, results[name] = compare(name, cfg, ocp,
                                 S.init_state(cfg, device=dev, batch=B_SMALL))
    binding.append(active_boundary_rows(cfg, ker.X, ocp.boundaries,
                                        ocp.boundary_signs))
    require(min(binding) > 0, f"{row}: a check where no boundary row binds")
    gate_calibration(f"{row}_step{GATE_STEP}_plain_self", cfg,
                     *ins[GATE_STEP])
    return results


def phase_check_linearize(dev):
    """``linearize_boundaries`` on the card against the same call on the
    CPU, at the rollout of U = 0 (a cold start's warm start): the corridor
    at the bench shape (B=16384, H=30) and the bending road (B=250)."""
    from mpc_tpu_torch.ops import fused_gn as F
    from mpc_tpu_torch.ops import sqp as S
    results = {}
    for name, B, road in (("corridor", B_BENCH, False),
                          ("road", B_SMALL, True)):
        lcfg, lp = bench_loop(n_lanes=B, device=dev, **SOFT_CORRIDOR)
        cfg = lcfg.solver
        ocp = (on_curved_road(lcfg, lp, 1.7) if road
               else ocp_on_step(lcfg, lp, GATE_STEP))
        st = S.init_state(cfg, device=dev, batch=B)
        X0 = S._rollout(cfg, ocp.x0, st.U)
        card = F.linearize_boundaries(cfg, X0, ocp.boundaries,
                                      ocp.boundary_signs)
        cpu = F.linearize_boundaries(cfg, X0.cpu(), ocp.boundaries.cpu(),
                                     ocp.boundary_signs.cpu())
        err = max_abs(card.cpu(), cpu)
        results[name] = err
        emit({"phase": "check", "kernel": "linearize_boundaries",
              "case": name, "lanes": B, "horizon": H,
              "max_abs_err_vs_cpu": err,
              "active_boundary_rows": active_boundary_rows(
                  cfg, X0, ocp.boundaries, ocp.boundary_signs)})
        require(err < 1e-3, f"linearize_boundaries {name}: card and CPU "
                            f"differ by {err}")
    return results


def random_lqr(rng, B, Hs, device="cpu", nx=5):
    """B random well-conditioned LQR problems of Hs stages and nx states
    with a nonzero defect r: the distribution of tests/test_riccati.py's
    generator (SPD Q, R, QH; A = I + noise; r ~ 0.1 N(0, 1)), drawn for
    all lanes at once.  Returns (StageQuad, QH, qH, LinDyn), float32, lanes
    leading."""
    from mpc_tpu_torch.ops.riccati import LinDyn, StageQuad

    def spd(*lead, n):
        m = rng.standard_normal(lead + (n, n))
        return m @ m.swapaxes(-1, -2) + n * np.eye(n)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    quad = StageQuad(Q=t(spd(B, Hs, n=nx)), R=t(spd(B, Hs, n=2)),
                     M=t(0.1 * rng.standard_normal((B, Hs, nx, 2))),
                     qx=t(rng.standard_normal((B, Hs, nx))),
                     qu=t(rng.standard_normal((B, Hs, 2))))
    QH, qH = t(spd(B, n=nx)), t(rng.standard_normal((B, nx)))
    dyn = LinDyn(A=t(np.eye(nx) + 0.1 * rng.standard_normal((B, Hs, nx,
                                                              nx))),
                 B=t(rng.standard_normal((B, Hs, nx, 2))),
                 r=t(0.1 * rng.standard_normal((B, Hs, nx))))
    return quad, QH, qH, dyn


def with_road_boundaries(ocp, half_width=4.0):
    """``ocp`` with a road around each lane's reference window: left and
    right polylines ``half_width`` m either side of the reference points,
    extended 10 m back along the first heading, signs (-1, +1) so that h >
    0 inside."""
    xy, psi = ocp.x_ref[..., :2], ocp.x_ref[..., 4]
    back = xy[:, :1] - 10.0 * torch.stack(
        [torch.cos(psi[:, :1]), torch.sin(psi[:, :1])], -1)
    xy = torch.cat([back, xy], 1)
    psi = torch.cat([psi[:, :1], psi], 1)
    normal = torch.stack([-torch.sin(psi), torch.cos(psi)], -1)
    bnd = torch.stack([xy + half_width * normal, xy - half_width * normal],
                      1)
    signs = torch.tensor([-1.0, 1.0], dtype=xy.dtype, device=xy.device)
    return ocp._replace(boundaries=bnd.contiguous(),
                        boundary_signs=signs.expand(xy.shape[0], 2).clone())


def ocp_on_step(lcfg, lp, step, seed=0):
    """The OCP of bench-loop step ``step`` with each lane's start moved onto
    the window's first reference state plus the jitter of
    ``make_bench_loop``'s starts (a numpy generator seeded with
    ``seed``)."""
    ocp = ocp_at(lcfg, lp, step)
    B = ocp.x0.shape[0]
    jitter = np.random.default_rng(seed).standard_normal((B, 5)) * [
        0.5, 0.15, 0.0, 0.5, 0.01]
    return ocp._replace(x0=ocp.x_ref[:, 0] + torch.as_tensor(
        jitter, dtype=ocp.x0.dtype, device=ocp.x0.device))


def on_curved_road(lcfg, lp, half_width, step=ROAD_STEP):
    """:func:`ocp_on_step` at a step whose reference window lies in the
    overtake's swerve, inside a road ``half_width`` m either side of the
    window (:func:`with_road_boundaries`): the road bends, and a half-width
    a little above r_ego = 1.2 m makes its rows bind."""
    return with_road_boundaries(ocp_on_step(lcfg, lp, step), half_width)


def boundary_margins(cfg, X, boundaries, signs):
    """(..., S, 6): each road-boundary row's signed distance less its bound
    r_ego at the states X (B, S, 5): the rows' models taken at X itself
    (``linearize_boundaries``, in chunks of lanes), which are exact there."""
    from mpc_tpu_torch.models import constraints as C
    from mpc_tpu_torch.ops import fused_gn as F
    m = F.linearize_boundaries(cfg, X, boundaries, signs).unflatten(-1,
                                                                    (6, 3))
    r_ego, spacing = C.approx_circle_radius(cfg.ego_length, cfg.ego_width)
    ks = torch.tensor([0.0, spacing / 4.0, -spacing / 4.0], dtype=X.dtype,
                      device=X.device).repeat_interleave(2)   # idx = 2 i + j
    cx = X[..., 0:1] + ks * torch.cos(X[..., 4:5])
    cy = X[..., 1:2] + ks * torch.sin(X[..., 4:5])
    return m[..., 0] * cx + m[..., 1] * cy + m[..., 2] - r_ego


def active_boundary_rows(cfg, X, boundaries, signs, band=ACTIVE_BAND):
    """Lane-stages of X (B, S, 5) where a road-boundary row lies within
    ``band`` m of its bound r_ego or beyond it."""
    return int((boundary_margins(cfg, X, boundaries, signs) < band).any(
        -1).sum())


def gn_problem(cfg, ocp, state):
    """The quadratics and dynamics the xla engine's first Gauss-Newton step
    builds from ``state`` (its rollout, multipliers and penalties)."""
    from mpc_tpu_torch.ops import sqp as S
    ocp = S.normalize_params(cfg, ocp)
    X = S._rollout(cfg, ocp.x0, state.U)
    quad, QH, qH = S._build_quadratic(cfg, X, state.U, ocp, state.lam_lo,
                                      state.lam_hi, state.mu)
    return quad, QH, qH, S._linearize_dynamics(cfg, X, state.U)


def _double(tree):
    """A tensor, or a tuple (NamedTuples too) of them, in float64."""
    if torch.is_tensor(tree):
        return tree.double()
    return type(tree)(*(_double(t) for t in tree))


def riccati_lanes_close(a, b, bands=RIC_BANDS):
    """Per lane: every gain within its band, non-finite entries equal."""
    ok = None
    for f, (rtol, atol) in bands.items():
        x, y = getattr(a, f), getattr(b, f)
        if x.dim() == 1:
            x, y = x[:, None], y[:, None]
        lane = lanes_close(x, y, rtol, atol)
        ok = lane if ok is None else ok & lane
    return ok


def riccati_compare(name, problem, reg, gains=None, plain=None):
    """The sweep's kernel against its plain version on every lane of
    ``problem`` (quad, QH, qH, dyn); ``gains``/``plain`` reuse outputs
    already computed on it.  A lane outside a band is excused only where
    the plain version's float32 and float64 sweeps part by more than that
    band (at most MAX_ROUNDING_SHARE of the lanes)."""
    from mpc_tpu_torch.ops import riccati_kernel as RK
    from mpc_tpu_torch.ops import riccati_vec as RV
    if gains is None:
        gains = RK.sweep(*problem, reg)
    if plain is None:
        plain = RV.backward_pass_vec_plain(*problem, reg)
    torch.cuda.synchronize()
    ok = riccati_lanes_close(gains, plain)
    noisy = torch.zeros_like(ok)
    if not bool(ok.all()):
        p64 = RV.backward_pass_vec_plain(*_double(problem), reg)
        noisy = ~riccati_lanes_close(_double(plain), p64)
    errs = {f: max_abs(getattr(gains, f), getattr(plain, f))
            for f in RIC_BANDS}
    nonfinite_equal = all(
        bool(torch.equal(torch.isfinite(getattr(gains, f)),
                         torch.isfinite(getattr(plain, f))))
        for f in ("K", "d", "dV1", "dV2"))
    B = int(ok.shape[0])
    line = {"phase": "check", "kernel": "riccati", "case": name,
            "lanes": B, "horizon": int(problem[0].Q.shape[1]),
            "max_abs_err": errs,
            "lane_agreement": float((ok | noisy).double().mean()),
            "rounding_lanes": int(noisy.sum()),
            "nonfinite_lanes": int((~torch.isfinite(plain.K).reshape(
                B, -1).all(1)).sum()),
            "nonfinite_equal": nonfinite_equal}
    emit(line)
    require(bool((ok | noisy).all()),
            f"riccati {name}: kernel and plain version differ on "
            f"{int((~(ok | noisy)).sum())} lanes")
    require(int(noisy.sum()) <= MAX_ROUNDING_SHARE * B,
            f"riccati {name}: {int(noisy.sum())} lanes where float32 "
            "rounding alone leaves the bands")
    require(nonfinite_equal, f"riccati {name}: non-finite gains differ")
    return errs


def phase_check_riccati(dev, **model):
    """The sweep's checks: random problems with a defect, and the
    quadratics the xla engine builds at the bench point's step 0, plain
    and with road-boundary rows; with model='st' its nx=7 instance on
    random 7-state problems and on the ST xla engine's step-0
    quadratics."""
    from mpc_tpu_torch.ops import sqp as S
    st, results = bool(model), {}
    prefix = "st_" if st else ""
    for B in (B_CHECK, B_SMALL):
        prob = random_lqr(np.random.default_rng(B), B, H, dev,
                          nx=7 if st else 5)
        results[f"{prefix}random_{B}"] = riccati_compare(
            f"{prefix}random_{B}", prob, 1e-6)
    for B, boundary in ((B_BENCH, False),) + (() if st else
                                              ((B_SMALL, True),)):
        lcfg, lp = bench_loop(n_lanes=B, device=dev, boundary_rows=boundary,
                              **XLA_WARM, **model)
        ocp = ocp_at(lcfg, lp)
        if boundary:
            ocp = with_road_boundaries(ocp)
        state = S.init_state(lcfg.solver, device=dev, batch=B)
        name = (f"{prefix}bench_step0_{B}"
                + ("_boundaries" if boundary else ""))
        results[name] = riccati_compare(
            name, gn_problem(lcfg.solver, ocp, state), lcfg.solver.reg)
    return results


def phase_check_sqp_vec(dev, **model):
    """The xla engine with the kernel sweep against the same solve with the
    plain sweep, on the card, at B=2048 from the cold start: al 1x1
    unguarded, and a 2x2 ladder whose rung choices the plain-sweep solve
    replays (each within TIE_RTOL of the best under its merits); of the
    ST model with model='st'."""
    from mpc_tpu_torch.ops import riccati_vec as RV
    from mpc_tpu_torch.ops import sqp as S
    from mpc_tpu_torch.ops import sqp_vec as SV
    results = {}
    prefix = "st_" if model else ""
    for name, budget in ((f"{prefix}xla_1x1", WARM),
                         (f"{prefix}xla_ladder_2x2",
                          dict(al_iters=2, sqp_iters=2))):
        lcfg, lp = bench_loop(n_lanes=B_CHECK, device=dev, engine="xla",
                              **budget, **model)
        cfg, ocp = lcfg.solver, ocp_at(lcfg, lp)
        st = S.init_state(cfg, device=dev, batch=B_CHECK)
        ladder = bool(cfg.alphas)
        chosen, trace = [], []
        ker = SV.solve_batch_vec(cfg, ocp, st, device=dev,
                                 rungs=chosen if ladder else None)
        follow = torch.stack([r for r, _ in chosen]) if ladder else None
        pln = SV.solve_batch_vec(cfg, ocp, st, device=dev,
                                 sweep=RV.backward_pass_vec_plain,
                                 rungs=trace if ladder else None,
                                 follow=follow)
        extra = {}
        if ladder:
            regret = torch.stack([
                rung_regret(c, m, SV._pick(m[1:], m[0]))
                for c, (_, m) in zip(follow, trace)])
            extra = {"max_rung_regret": float(regret.max()),
                     "rung_choices": int(follow.numel())}
        torch.cuda.synchronize()
        inband = {f: lanes_close(getattr(ker, f), getattr(pln, f), *band)
                  for f, band in BANDS.items()}
        noisy = {f: torch.zeros_like(v) for f, v in inband.items()}
        if not all(bool(v.all()) for v in inband.values()):
            ocp64, st64 = as_float64(ocp, st)
            p64 = SV.solve_batch_vec(cfg, ocp64, st64, device=dev,
                                     sweep=RV.backward_pass_vec_plain,
                                     follow=follow)
            noisy = {f: ~lanes_close(getattr(pln, f).double(),
                                     getattr(p64, f), *band)
                     for f, band in BANDS.items()}
        errs = {f: max_abs(getattr(ker, f), getattr(pln, f)) for f in BANDS}
        agree = {f: float((inband[f] | noisy[f]).double().mean())
                 for f in BANDS}
        for f, (rtol, atol) in STATE_BANDS.items():
            a, b = getattr(ker.state, f), getattr(pln.state, f)
            errs[f] = max_abs(a, b)
            agree[f] = float(lanes_close(a, b, rtol, atol).double().mean())
        agree["status"] = float((ker.status == pln.status).double().mean())
        n_noisy = int(torch.stack(list(noisy.values())).any(0).sum())
        emit({"phase": "check", "kernel": "riccati", "case": name,
              "engine": "xla", "lanes": B_CHECK,
              "budget": f"{cfg.al_iters}x{cfg.sqp_iters}",
              "alphas": list(cfg.alphas), "max_abs_err": errs,
              "lane_agreement": agree, "rounding_lanes": n_noisy, **extra,
              "kernel_feasible_lanes": int((ker.status >= 0).sum())})
        short = [f for f, v in agree.items()
                 if v < (1.0 if f in BANDS else MIN_LANE_AGREEMENT)]
        require(not short, f"{name}: kernel-sweep and plain-sweep solves "
                           f"agree on too few lanes in {short}")
        require(n_noisy <= MAX_ROUNDING_SHARE * B_CHECK,
                f"{name}: {n_noisy} lanes where float32 rounding alone "
                "leaves the bands")
        require(not ladder or extra["max_rung_regret"] <= TIE_RTOL,
                f"{name}: a rung worse than the best by "
                f"{extra.get('max_rung_regret')} of its merit")
        results[name] = errs
    return results


def lvp_loop(row):
    """(lcfg, lanes on the CPU) of ``row``'s loop_vs_plain: LVP_LANES lanes
    of its bench loop, LVP_STEPS steps."""
    lcfg, lp = bench_loop(n_lanes=LVP_LANES, device="cpu",
                          **LOOP_VS_PLAIN_ROWS[row])
    return dataclasses.replace(lcfg, n_steps=LVP_STEPS), lp


def plain_loop_ref(row, f64=False):
    """``row``'s loop_vs_plain loop on the CPU (the plain version), in
    float64 with ``f64``."""
    from mpc_tpu_torch.planner import closed_loop as cl
    lcfg, lp = lvp_loop(row)
    if f64:
        lp = lp.map(lambda t: t.double() if t.is_floating_point() else t)
    return cl.closed_loop_batch_vec(lcfg, lp, device="cpu")


def phase_loop_vs_plain(dev, row, refs=None):
    """The first steps of ``row``'s bench loop on the card vs the plain
    loop on the CPU (bands of tests/test_torch_closed_loop.py); ``refs()``
    gives the plain loops (:func:`plain_loop_ref`, float32 and float64)
    where they ran elsewhere."""
    lcfg, lp = lvp_loop(row)
    loop_vs_plain(dev, row, lcfg, lp, LOOP_VS_PLAIN_ROWS[row], refs)


def loop_vs_plain(dev, row, lcfg, lp, config, refs=None):
    """The loop ``lcfg`` of the lanes ``lp`` (on the CPU) on the card and on
    the CPU (plain version), held to the bands of
    tests/test_torch_closed_loop.py: X 5e-2, U 5e-3, the same feasibility.
    With boundary rows U is held to 5e-3 or to the plain loop's own spread,
    whichever is larger: how far the same plain loop moves in float64,
    since the corridor rows' ladders and degenerate duals make their loops
    part by rounding alone (tests/test_torch_boundary_rows.py).
    ``refs()``: (the plain loop, its float64 run or None) computed
    elsewhere on the same lanes."""
    from mpc_tpu_torch.planner import closed_loop as cl
    ref, f64 = refs() if refs else (
        cl.closed_loop_batch_vec(lcfg, lp, device="cpu"), None)
    got = cl.closed_loop_batch_vec(lcfg, lp, device=dev)
    err_x = max_abs(got.X.cpu(), ref.X)
    err_u = max_abs(got.U.cpu(), ref.U)
    same_feas = bool(torch.equal(got.status.cpu() >= 0, ref.status >= 0))
    line = {"phase": "loop_vs_plain", "row": row,
            "lanes": int(lp.x_init.shape[0]), "steps": lcfg.n_steps,
            "config": {k: v for k, v in config.items() if k != "corridor"},
            "max_abs_err": {"X": err_x, "U": err_u},
            "feasible_steps": int((got.status >= 0).sum()),
            "feasibility_equal": same_feas}
    band_u = 5e-3
    if lcfg.solver.boundary_rows:
        line["active_boundary_lane_steps"] = active_boundary_rows(
            lcfg.solver, got.X.cpu(), lp.boundaries, lp.boundary_signs)
        if f64 is None:
            lp64 = lp.map(lambda t: t.double() if t.is_floating_point()
                          else t)
            f64 = cl.closed_loop_batch_vec(lcfg, lp64, device="cpu")
        line["plain_spread_U"] = max_abs(f64.U, ref.U)
        band_u = max(band_u, line["plain_spread_U"])
    emit(line)
    require(err_x < 5e-2 and err_u <= band_u and same_feas,
            f"{row} closed loop on the card differs from the plain loop")


class _OpCount(TorchDispatchMode):
    """Arithmetic operations of a PyTorch computation: each elementwise op
    counts its output's elements, a sum its inputs' less its outputs'."""

    ELEMENTWISE = {
        "add", "sub", "rsub", "mul", "div", "neg", "abs", "sqrt", "sin",
        "cos", "tan", "reciprocal", "maximum", "minimum", "clamp", "where",
        "gt", "lt", "ge", "le", "eq", "ne", "sign", "isfinite", "isnan",
        "logical_and", "logical_or", "logical_not", "bitwise_and", "pow"}

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._overloadpacket.__name__.rstrip("_")
        if name in self.ELEMENTWISE:
            self.n += out.numel()
        elif name in ("sum", "amin"):
            self.n += args[0].numel() - out.numel()
        return out


def ops_per_lane(cfg, ocp=None):
    """fp32 operations of one lane's solve under ``cfg``, counted on the
    plain version at one lane on the CPU: lane 0 of ``ocp``, or of the
    bench loop's step-0 OCP.  The plain version recomputes rows and
    Jacobians that the kernel reads from its caches, so the count is a
    little high.  The boundary rows' models (``boundary_models``, host-side
    glue before the launch) are taken outside the count."""
    from mpc_tpu_torch.ops import fused_gn as F
    from mpc_tpu_torch.ops import sqp as S
    if ocp is None:
        lcfg, lp = bench_loop(n_lanes=1, device="cpu", horizon=cfg.horizon)
        ocp = ocp_at(lcfg, lp)
    ocp = type(ocp)(*(None if t is None else t.map(lambda w: w[:1].cpu())
                      if hasattr(t, "map") else t[:1].cpu() for t in ocp))
    st = S.init_state(cfg, batch=1)
    bnd = F.boundary_models(cfg, ocp, st)
    real = F.boundary_models
    F.boundary_models = lambda *a: bnd
    try:
        with _OpCount() as c:
            engine(cfg).plain(cfg, ocp, st)
    finally:
        F.boundary_models = real
    return c.n


def kernel_bytes(cfg, bufs):
    """Bytes the solve must move: each input read once (the boundary rows'
    models among them), each output written once (the warm-start state is
    both)."""
    inputs, state, outputs = engine(cfg).kernel_io

    def nbytes(names):
        return sum(bufs[n].numel() * bufs[n].element_size() for n in names
                   if n in bufs)
    return nbytes(inputs) + 2 * nbytes(state) + nbytes(outputs)


def cuda_ms(fn):
    """(device milliseconds of ``fn()`` between two CUDA events, its
    result)."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1), out


def time_kernel_ms(cfg, ocp, state, reps, geometry):
    """Median per-launch time over fresh copies of the same inputs (the
    kernel updates the warm state in place), after one warm-up launch, at
    the launch ``geometry`` (the engine's knob); returns the last launch's
    buffers too."""
    eng = engine(cfg)
    times = []
    for i in range(reps + 1):
        # with the ladder on, the rungs are recorded for the check's replay
        bufs = eng.pack(cfg, ocp, state, trace_rungs=eng.ladder(cfg))
        ms, _ = cuda_ms(lambda: eng.launch(cfg, bufs, geometry))
        if i:
            times.append(ms)
    times.sort()
    return times[len(times) // 2], bufs


def time_plain_ms(cfg, ocp, state, reps):
    """Best time of ``reps`` plain solves, and the plain outputs."""
    plain = engine(cfg).plain
    runs = [cuda_ms(lambda: plain(cfg, ocp, state)) for _ in range(reps)]
    return min(ms for ms, _ in runs), runs[-1][1]


def phase_timing(dev, cold_kw, warm_kw, warm_reps=20, cold_reps=5,
                 row=None, split=None):
    """Per-launch times of one kernel at the bench shape: the warm budget
    from the cold-start state and the cold budget from ``init_state``, at
    the default launch geometry and at each value of the engine's sweep.
    For a corridor ``row`` (boundary rows): its own budget (warm) on the
    solve its loop makes at LOOP_CHECK_STEP, where rows bind, and its
    warm-up budget (cold) on the loop's cold start, at the default
    geometry only, with the time of the boundary rows' models
    (``boundary_models``, the glue before each launch).  ``split(cfg, ocp,
    state)`` of the warm inputs names more (cfg, ocp, state) to time at the
    default geometry, each with its bound, into ``out["split"]``."""
    from mpc_tpu_torch.ops import fused_gn as F
    from mpc_tpu_torch.ops import sqp as S
    lcfg, lp = bench_loop(n_lanes=B_BENCH, device=dev, **cold_kw)
    ocp = ocp_at(lcfg, lp)
    cold_cfg = lcfg.solver
    warm_cfg = dataclasses.replace(cold_cfg, **warm_kw)
    eng = engine(cold_cfg)
    st0 = S.init_state(cold_cfg, device=dev, batch=B_BENCH)
    if row:
        wocp, warm_state = loop_inputs(dev, dataclasses.replace(
            lcfg, solver=warm_cfg), lp, (LOOP_CHECK_STEP,))[LOOP_CHECK_STEP]
    else:
        bufs = eng.pack(cold_cfg, ocp, st0, trace_rungs=False)
        eng.launch(cold_cfg, bufs)
        wocp = ocp
        warm_state = eng.solution(cold_cfg, eng.unpack(bufs), st0).state
    out = {}
    for case, cfg, ocp, state, reps in (
            (f"warm_{eng.budget(warm_cfg)}", warm_cfg, wocp, warm_state,
             warm_reps),
            (f"cold_{eng.budget(cold_cfg)}", cold_cfg, ocp, st0, cold_reps)):
        ms, bufs = time_kernel_ms(cfg, ocp, state, reps, eng.default)
        by_geometry = {g: time_kernel_ms(cfg, ocp, state, reps, g)[0]
                       for g in (() if row else eng.sweep(cfg))}
        # the plain version once at the corridor rows' budgets (seconds a
        # solve at this batch), best of 3 at the bench budgets
        plain_ms, plain = time_plain_ms(
            cfg, ocp, state, 3 if case.startswith("warm") and not row else 1)
        _, errs = compare(f"timed_{row + '_' if row else ''}{case}", cfg, ocp,
                          state, bufs, plain)
        out[case] = {
            "ms": ms, eng.geometry: eng.default, "plain_ms": plain_ms,
            **kernel_bound(cfg, bufs, ocp if row else None),
            "max_abs_err": errs}
        if by_geometry:
            out[case][f"ms_by_{eng.geometry}"] = {
                str(g): v for g, v in by_geometry.items()}
        if row:   # the glue before each launch, and its peak memory
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            times = sorted(cuda_ms(lambda: F.boundary_models(
                cfg, ocp, state))[0] for _ in range(5))
            out[case]["boundary_models_ms"] = times[2]
            out[case]["boundary_models_peak_bytes"] = (
                torch.cuda.max_memory_allocated() - base)
        emit({"phase": "timing", "kernel": eng.name,
              **({"row": row} if row else {}), "case": case,
              "lanes": B_BENCH, "horizon": cfg.horizon, **out[case]})
    out["split"] = {}
    for name, (cfg, ocp, state) in (split(warm_cfg, wocp, warm_state)
                                    if split else {}).items():
        ms, bufs = time_kernel_ms(cfg, ocp, state, warm_reps, eng.default)
        out["split"][name] = {"ms": ms, **kernel_bound(cfg, bufs, ocp)}
        emit({"phase": "timing", "kernel": engine(cfg).name,
              **({"row": row} if row else {}), "case": f"split_{name}",
              "lanes": B_BENCH, "horizon": cfg.horizon,
              **out["split"][name]})
    return out


def kernel_bound(cfg, bufs, ocp=None):
    """A fused solve's bound at B_BENCH lanes: the bytes of ``bufs`` it
    must move over the card's memory rate, and its fp32 operations (counted
    on the plain version at one lane of ``ocp``, or of the bench loop's
    step-0 OCP) over its fp32 rate."""
    nbytes = kernel_bytes(cfg, bufs)
    ops = ops_per_lane(cfg, ocp) * B_BENCH
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "fp32_ops": ops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "ops_ms": ops_ms}


def split_b1b(cfg, ocp, state):
    """B1.b's split at its own budget on the corridor's solve (rows bind):
    (b) without the ladder, (c) the instance without the boundary rows, on
    the same problem without its boundary data, with the ladder; with (a),
    the row's own timing, (a) - (b) is the ladder and (a) - (c) the rows."""
    from mpc_tpu_torch.ops import sqp as S
    nb = dataclasses.replace(cfg, boundary_rows=False)
    rows = S.nrows(nb)
    st_nb = state._replace(**{f: getattr(state, f)[..., :rows].contiguous()
                              for f in ("lam_lo", "lam_hi", "mu",
                                        "prev_viol")})
    return {"b1b_b_rows": (dataclasses.replace(cfg, alphas=()), ocp, state),
            "b1b_c_ladder": (nb, ocp._replace(boundaries=None,
                                             boundary_signs=None), st_nb)}


def split_ip(cfg, ocp, state):
    """The IP kernel's split: its warm budget at one Newton step (1x1)
    against its 1x4, the Newton steps against the rollouts."""
    return {"warm_1x1": (dataclasses.replace(cfg, ip_iters=1), ocp, state)}


def split_gn_st(cfg, ocp, state):
    """The ST AL kernel's split: its warm budget at two Gauss-Newton steps
    (1x2) against its 1x1, so that the difference is one step (its ring,
    the dual-number (A, B) of its producers, the rollout) and the rest of
    1x1 the initial rollout and the diagnostics."""
    return {"gn_st_warm_1x2": (dataclasses.replace(cfg, sqp_iters=2), ocp,
                               state)}


# Each row's kernel timing: phase_timing's keyword arguments (chip_ab.py
# --timing looks its row up here).  The corridor rows time their own
# budget (warm) and their warm-up budget (cold), 10 and 3 launches.
TIMING_ROWS = {
    "soft": dict(cold_kw=COLD, warm_kw=WARM),
    "hard": dict(cold_kw=IP_COLD, warm_kw=IP_WARM, split=split_ip),
    "soft-corridor": dict(cold_kw=SOFT_CORRIDOR, warm_kw={}, warm_reps=10,
                          cold_reps=3, row="soft-corridor", split=split_b1b),
    "hard-corridor": dict(cold_kw=dict(HARD_CORRIDOR, ip_sqp_iters=5,
                                       ip_iters=10),
                          warm_kw=dict(ip_sqp_iters=2, ip_iters=6),
                          warm_reps=10, cold_reps=3, row="hard-corridor"),
    "soft-st": dict(cold_kw=dict(COLD, **ST), warm_kw=WARM,
                    split=split_gn_st),
    "hard-st": dict(cold_kw=dict(IP_COLD, **ST), warm_kw=IP_WARM,
                    split=split_ip),
}


def riccati_bound(bufs):
    """The sweep's bound at the shapes of ``bufs``: its bytes (every input
    read once, every output written once) over the card's memory rate, and
    its fp32 operations, counted on the plain version at one lane of the
    same horizon and state dimension, over its fp32 rate."""
    from mpc_tpu_torch.ops import riccati_kernel as RK
    from mpc_tpu_torch.ops import riccati_vec as RV
    Hs, _, B = bufs["Q"].shape
    nbytes = sum(bufs[n].numel() * bufs[n].element_size()
                 for n in RK.KERNEL_INPUTS + RK.KERNEL_OUTPUTS)
    problem = random_lqr(np.random.default_rng(0), 1, Hs,
                         nx=bufs["qH"].shape[0])
    with _OpCount() as c:
        RV.backward_pass_vec_plain(*problem, 1e-6)
    ops = c.n * B
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "fp32_ops": ops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_timing_riccati(dev, reps=20, **model):
    """The sweep per launch on the quadratics the xla engine builds at the
    bench point's step 0 (B=16384, H=30; of ``model``, the nx=7 instance
    for model='st'): the median of ``reps`` launches with CUDA events at
    32/64/128 threads, the layout copies of ``pack``, the plain version's
    time and the bound; the timed launch's gains held against the plain
    version's."""
    from mpc_tpu_torch.ops import riccati_kernel as RK
    from mpc_tpu_torch.ops import riccati_vec as RV
    from mpc_tpu_torch.ops import sqp as S
    lcfg, lp = bench_loop(n_lanes=B_BENCH, device=dev, **XLA_WARM, **model)
    cfg = lcfg.solver
    problem = gn_problem(cfg, ocp_at(lcfg, lp),
                         S.init_state(cfg, device=dev, batch=B_BENCH))
    bufs = RK.pack(*problem)

    def median_ms(fn):
        fn()
        times = sorted(cuda_ms(fn)[0] for _ in range(reps))
        return times[len(times) // 2]
    by_threads = {t: median_ms(lambda: RK.launch(bufs, cfg.reg, t))
                  for t in (32, 64, 128)}
    ms = by_threads[RK.THREADS]
    pack_ms = median_ms(lambda: RK.pack(*problem))
    plain_ms, plain = min(
        (cuda_ms(lambda: RV.backward_pass_vec_plain(*problem, cfg.reg))
         for _ in range(3)), key=lambda r: r[0])
    prefix = "st_" if model else ""
    errs = riccati_compare(f"{prefix}timed_bench_step0", problem, cfg.reg,
                           RK.unpack(bufs), plain)
    line = {"ms": ms, "threads": RK.THREADS,
            "ms_by_threads": {str(t): v for t, v in by_threads.items()},
            "pack_ms": pack_ms, "plain_ms": plain_ms, **riccati_bound(bufs),
            "max_abs_err": errs}
    emit({"phase": "timing", "kernel": "riccati",
          "case": f"{prefix}bench_step0", "lanes": B_BENCH, "horizon": H,
          "nx": S.solver_nx(cfg), **line})
    return line


def _launchers():
    """Each kernel's launching wrapper, which counts its launches."""
    from mpc_tpu_torch.ops import fused_gn as F
    from mpc_tpu_torch.ops import fused_ip as FI
    from mpc_tpu_torch.ops import riccati_kernel as RK
    return {"fused_gn": F.launch, "fused_ip": FI.launch_ip,
            "riccati": RK.launch, "fused_gn_st": F.launch_st,
            "fused_ip_st": FI.launch_ip_st,
            "fused_ip_ks_ring": FI.launch_ip_ks_ring}


def reset_launch_counts():
    for fn in _launchers().values():
        fn.launches = 0


def launch_counts():
    return {name: fn.launches for name, fn in _launchers().items()}


def row_kernel(lcfg):
    """(kernel, launches it makes in one loop of ``lcfg``): one fused solve
    per cold start and step (the ST model's library for model='st'), or
    one sweep per Gauss-Newton step of the xla engine (the cold starts at
    their full-strength budget)."""
    from mpc_tpu_torch.planner import closed_loop as cl
    scfg = lcfg.solver
    if scfg.engine != "xla":
        return engine(scfg).name, lcfg.cold_start_solves + lcfg.n_steps
    wcfg = cl._warmup_cfg(lcfg)
    return "riccati", (lcfg.cold_start_solves * wcfg.al_iters
                       * wcfg.sqp_iters
                       + lcfg.n_steps * scfg.al_iters * scfg.sqp_iters)


def counted(fn):
    """``fn()`` with every kernel's launches counted from 0 and the device
    synchronized around it: (its result, launches by kernel, wall s on
    the host clock, peak device bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, launch_counts(), time.perf_counter() - t0,
            torch.cuda.max_memory_allocated())


def require_row_kernel(name, lcfg, launches):
    """The row's kernel launched as often as the loop solves, no other."""
    kernel, want = row_kernel(lcfg)
    require(launches[kernel] == want,
            f"{name}: {kernel} launches {launches[kernel]}, want {want}")
    others = {k: n for k, n in launches.items() if k != kernel and n}
    require(not others, f"{name}: other kernels launched: {others}")
    return kernel


def infeasible_vs_plain(dev, row, lcfg, lp, status, most=64):
    """The first steps of (at most ``most``) lanes with an infeasible step
    in the card's loop, up to their last first infeasible step, on the card
    against the plain loop on the CPU: a corridor row's infeasible steps
    are a finding, held to the plain version."""
    bad = (status < 0).cpu()
    lanes = bad.any(1).nonzero()[:, 0][:most]
    steps = int(bad[lanes].int().argmax(1).max()) + 1
    sub = lp.map(lambda t: t.cpu()[lanes] if t.dim() else t.cpu())
    loop_vs_plain(dev, f"{row}-infeasible-lanes",
                  dataclasses.replace(lcfg, n_steps=steps), sub,
                  {"lanes": lanes.tolist()})


def phase_loop(dev, card, row, budget, steps=T_BENCH, **kw):
    """One bench row: ``closed_loop_batch_vec`` at B=16384, T=100 (or
    ``steps``; H=30, or the row's), the launches of every kernel counted in
    a first run (the row's kernel alone, as often as the row needs it) and
    its peak device memory, then solves/s with CUDA events, best of 3 (the
    counted run itself, on the host clock around it, when it took longer
    than ONE_TIMED_RUN_S or ran on engine='xla': such a loop is bound by
    its host).  Every step
    must be feasible, except in a corridor row, whose infeasible steps are
    counted and held against the plain version
    (:func:`infeasible_vs_plain`); a corridor row also counts the
    lane-steps where a boundary row is active, an ST row the largest slip
    angle |beta|."""
    from mpc_tpu_torch.ops import sqp as S
    from mpc_tpu_torch.planner import closed_loop as cl
    lcfg, lp = bench_loop(n_lanes=B_BENCH, device=dev, **kw)
    lcfg = dataclasses.replace(lcfg, n_steps=steps)
    corridor = kw.get("corridor", False)

    def run():
        res = cl.closed_loop_batch_vec(lcfg, lp, device=dev)
        feasible = (res.status >= 0).sum()
        checksum = (res.X.sum() + res.U.sum() + res.viol.sum()
                    + res.cost.sum())
        return feasible, checksum, res

    # the main path's run
    (feasible, checksum, res), launches, counted_s, peak = counted(run)
    total = B_BENCH * steps
    require(tuple(res.X.shape) == (B_BENCH, steps, S.solver_nx(lcfg.solver)),
            "loop X shape")
    require(bool(torch.isfinite(checksum)), "loop checksum is not finite")
    require(corridor or int(feasible) == total,
            f"{row}: feasible steps {int(feasible)} of {total}")
    kernel = require_row_kernel(row, lcfg, launches)
    extra = {}
    if corridor:
        extra["active_boundary_lane_steps"] = active_boundary_rows(
            lcfg.solver, res.X, lp.boundaries, lp.boundary_signs)
        extra["max_lateral_y"] = float(res.X[..., 1].max())
        require(extra["active_boundary_lane_steps"] > 0,
                f"{row}: no boundary row is active in the loop")
        if int(feasible) < total:
            infeasible_vs_plain(dev, row, lcfg, lp, res.status)
    if lcfg.solver.model == "st":
        extra["max_abs_beta"] = float(res.X[..., 6].abs().max())
    del res

    # a loop bound by its host (its counted run over ONE_TIMED_RUN_S, or on
    # engine='xla', whose eager glue sets its pace) is timed by that run;
    # the others by CUDA events, best of 3 after it
    host_bound = (counted_s > ONE_TIMED_RUN_S
                  or lcfg.solver.engine == "xla")
    best = counted_s if host_bound else float("inf")
    timed_runs = 0 if host_bound else 3
    for _ in range(timed_runs):
        ms, (feasible, checksum, _) = cuda_ms(run)
        require(int(feasible) == total, "feasible steps changed between runs")
        best = min(best, ms / 1e3)
    name, limit = [s.strip() for s in card.split(",", 1)]
    Hs = lcfg.solver.horizon
    line = {"phase": "loop", "row": row, "impl": "torch-cuda",
            "metric": f"nmpc_solves_per_s_per_chip_h{Hs}",
            "value": total / best, "unit": "solves/s/chip",
            "step_latency_ms": best / steps * 1e3, "loop_s": best,
            "timed_runs": timed_runs, "counted_run_s": counted_s,
            "feasible_steps": int(feasible), "total_solves": total,
            "batch": B_BENCH, "horizon": Hs, "steps": steps,
            "model": lcfg.solver.model, **extra,
            "budget": budget, "engine": lcfg.solver.engine,
            "cold_start_solves": lcfg.cold_start_solves,
            "kernel": kernel, "kernel_launches": launches[kernel],
            "launches_by_kernel": launches,
            "peak_device_memory_bytes": peak, "checksum": float(checksum),
            "gpu": name, "power_limit": limit}
    emit(line)
    return line, lcfg, lp


# each kernel's source where it is not csrc/<library>.cu: the ST IP
# library's (fused_ip_st.cu) and the KS IP library with the boundary rows
# (fused_ip_ks_ring.cu) are the ring source
SOURCES = {"fused_ip_st": "fused_ip_ring.cu",
           "fused_ip_ks_ring": "fused_ip_ring.cu"}


def kernel_symbol(kernel, name):
    """Whether the device kernel ``name`` the profiler saw is ``kernel``'s:
    "fused_ip_kernel<1>(IpArgs, IpBufs)" and the like; the ST libraries'
    kernels carry StModel, the ring source's libraries build
    "fused_ip_ring_kernel<4, ...>" (KsModel in fused_ip_ks_ring, StModel in
    fused_ip_st), the sweep's nx=7 instance a 7."""
    st = kernel.endswith("_st")
    symbol = ("fused_ip_ring_kernel"
              if SOURCES.get(kernel) == "fused_ip_ring.cu"
              else f"{kernel.removesuffix('_st')}_kernel")
    return symbol in name and ("StModel" in name) == st


def phase_profile(dev, row, lcfg, lp, window=None, start=0):
    """Device time of one bench loop by kernel, from torch.profiler (the
    profiler's own host overhead widens the gaps between kernels, so the
    idle share comes from the unprofiled loop time).  ``window`` steps
    profiles only that many steps from step ``start``, after an unprofiled
    cold start and steps: a steady window, for a row of too many eager
    launches to trace whole; only the device's activity, except with
    boundary rows, whose rows' models (``linearize_boundaries``) are a
    named range on the host."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from mpc_tpu_torch.ops import fused_gn as F
    from mpc_tpu_torch.planner import closed_loop as cl
    kernel, _ = row_kernel(lcfg)
    if window is None:
        def body():
            cl.closed_loop_batch_vec(lcfg, lp, device=dev)
    else:
        carry = cl.init_batch_carry(lcfg, lp, dev)
        for _ in range(start):
            carry, _ = cl.closed_loop_batch_step(lcfg, lp, carry, device=dev)

        def body():
            c = carry
            for _ in range(window):
                c, _ = cl.closed_loop_batch_step(lcfg, lp, c, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    activities = [ProfilerActivity.CUDA]
    if window is None or lcfg.solver.boundary_rows:
        activities.append(ProfilerActivity.CPU)
    # the boundary rows' models (glue before each launch) as a named range
    real = F.linearize_boundaries

    def named(*a):
        with record_function("linearize_boundaries"):
            return real(*a)
    F.linearize_boundaries = named
    try:
        with profile(activities=activities) as prof:
            body()
            torch.cuda.synchronize()
    finally:
        F.linearize_boundaries = real
    profiled_s = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    by_name, span_ms = {}, 0.0
    for e in prof.events():
        if e.device_type != cuda:
            continue
        if e.name == "linearize_boundaries":   # the range on the device
            span_ms += e.time_range.elapsed_us() / 1e3
            continue
        n, ms = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    require(by_name, "the profiler saw no device kernels")
    busy = sum(ms for _, ms in by_name.values())
    fused = [v for k, v in by_name.items() if kernel_symbol(kernel, k)]
    copies = [v for k, v in by_name.items() if "opy" in k]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    glue = {}
    if lcfg.solver.boundary_rows:
        # the kernels launched inside the range (its host-side entry), and
        # the range's span on the device timeline
        rng = [e for e in prof.key_averages() if e.key ==
               "linearize_boundaries"
               and e.device_type == torch.autograd.DeviceType.CPU]
        glue = {"linearize_boundaries_calls": sum(e.count for e in rng),
                "linearize_boundaries_kernels_ms": sum(
                    e.device_time_total for e in rng) / 1e3,
                "linearize_boundaries_span_ms": span_ms}
    line = {"phase": "profile", "row": row, **glue,
            "window_steps": (f"{start}..{start + window - 1}" if window
                             else "whole loop"),
            "profiled_wall_ms": profiled_s * 1e3, "device_busy_ms": busy,
            "kernel": kernel, "kernel_ms": sum(ms for _, ms in fused),
            "kernel_launches_seen": sum(n for n, _ in fused),
            "copy_kernels_ms": sum(ms for _, ms in copies),
            "copy_kernel_launches": sum(n for n, _ in copies),
            "device_launches": sum(n for n, _ in by_name.values()),
            "top": [{"kernel": k[:80], "launches": n, "ms": ms}
                    for k, (n, ms) in top]}
    emit(line)
    return line


def planner_golden(dev, config, tag):
    """One float64 regression golden on ``dev``: ``make_loop_config`` +
    ``make_loop_params`` + ``run_closed_loop`` (deterministic, the per-lane
    solve) against ``tests/goldens/<tag>_states.txt``; no kernel
    launches."""
    from mpc_tpu_torch.io.config import load_config
    from mpc_tpu_torch.planner import closed_loop as cl
    c = load_config(str(ROOT / "configs" / config), str(ROOT / "scenarios"))
    lcfg = cl.make_loop_config(c, noised=False)
    lp = cl.make_loop_params(c, lcfg, dtype=torch.float64, device=dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    res = cl.run_closed_loop(lcfg, lp, device=dev)
    X = res.X.cpu().numpy()
    seconds = time.perf_counter() - t0
    golden = np.loadtxt(ROOT / "tests" / "goldens" / f"{tag}_states.txt")
    err = float(np.abs(X - golden).max())
    ok = X.shape == golden.shape and bool(np.all(
        np.abs(X - golden) <= GOLDEN_ATOL + GOLDEN_RTOL * np.abs(golden)))
    launches = {k: n for k, n in launch_counts().items() if n}
    line = {"phase": "planner", "case": f"golden_{tag}", "config": config,
            "method": lcfg.solver.method, "steps": lcfg.n_steps,
            "dtype": "float64", "max_abs_dX": err, "atol": GOLDEN_ATOL,
            "loop_s": seconds, "ms_per_step": seconds / lcfg.n_steps * 1e3,
            "kernel_launches": launches}
    emit(line)
    require(ok, f"golden {tag} on the card: max |dX| {err:.3g}")
    require(not launches, f"golden {tag}: kernels launched: {launches}")
    return line


def planner_cli_start(dev, rti1=False):
    """Start the deployment config through the port's CLI in a subprocess
    on the card (:func:`planner_cli` waits for it)."""
    cmd = [sys.executable, "-m", "mpc_tpu_torch.planner.cli",
           "--config", str(ROOT / "configs" / DEPLOYMENT),
           "--scenario-dir", str(ROOT / "scenarios"), "--deterministic",
           "--device", str(dev)] + (["--rti1"] if rti1 else [])
    return (subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True),
            time.perf_counter(), rti1)


def planner_cli(dev, started):
    """The CLI run of :func:`planner_cli_start`: exit 0 (no obstacle or
    boundary collision); without --rti1 also the native library and no
    infeasible (-7) step."""
    popen, t0, rti1 = started
    case = "rti1" if rti1 else "default"
    stdout, stderr = popen.communicate(timeout=600)
    proc = subprocess.CompletedProcess(popen.args, popen.returncode, stdout,
                                       stderr)
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"planner CLI ({case}) exit {proc.returncode}: "
            f"{proc.stderr[-2000:]}")
    summary = json.loads(proc.stdout)
    counts = summary["solver_status_counts"]
    emit({"phase": "planner", "case": f"cli_{case}", "config": DEPLOYMENT,
          "exit_code": proc.returncode, "process_s": seconds,
          "summary": summary,
          "jax_cpu_status_counts": JAX_CPU_STATUS_COUNTS[case]})
    require(summary["device"] == str(dev),
            f"planner CLI ({case}) ran on {summary['device']}")
    if not rti1:
        require(summary["native"], "planner CLI: native library not built")
        require("-7" not in counts, f"planner CLI: infeasible steps {counts}")
    return summary


def c2_solve_inputs(horizon, lanes):
    """C2's solve on the CPU in float64: (cfg, ocp, state)."""
    from mpc_tpu_torch.ops import sqp as S
    lcfg, lp = bench_loop(horizon=horizon, n_lanes=lanes, device="cpu",
                          method="ip", ip_sqp_iters=2, ip_iters=6,
                          ip_warm_duals=True)
    cfg = lcfg.solver
    return (cfg, *as_float64(ocp_at(lcfg, lp),
                             S.init_state(cfg, batch=lanes)))


def c2_solve_ref(horizon, lanes):
    """C2's solve on the CPU (:func:`planner_c2_solve`'s reference)."""
    from mpc_tpu_torch.ops import fused_ip as FI
    return FI.solve_batch_fused_ip(*c2_solve_inputs(horizon, lanes),
                                   device="cpu")


def planner_c2_solve(dev, horizon, lanes, ref=None):
    """C2, first half: ``solve_batch_fused_ip`` outside the IP kernel's
    envelope (H = ``horizon`` > 63) on the overtake problem at the
    deployment budget (ip 2x6 warm duals, the default ladder) takes the
    per-lane path on the card: no kernel launches, and the solution within
    the bands of tests/test_fused_ip.py of the same call on the CPU, with
    the same status, on every lane.  Both run in float64: at this horizon
    the CPU's own float32 and float64 solves part on 6 to 16 of 64 lanes
    (U by up to 0.57, warm or cold), so float32 alone does not determine
    the digits the bands read.  ``ref()``: the CPU's solve
    (:func:`c2_solve_ref`) where it ran elsewhere."""
    from mpc_tpu_torch.ops import fused_ip as FI
    from mpc_tpu_torch.ops import sqp as S
    cfg, ocp, st = c2_solve_inputs(horizon, lanes)
    reason = FI.ineligible_reason_ip(cfg, ocp)
    require(reason is not None, f"H={horizon} is inside the IP envelope")
    ocp_d = S.map_tensors(ocp, lambda t: t.to(dev))
    st_d = st.map(lambda t: t.to(dev))
    reset_launch_counts()
    ms, got = cuda_ms(lambda: FI.solve_batch_fused_ip(cfg, ocp_d, st_d,
                                                      device=dev))
    launches = {k: n for k, n in launch_counts().items() if n}
    ref = ref() if ref else FI.solve_batch_fused_ip(cfg, ocp, st,
                                                    device="cpu")
    inband = {f: lanes_close(getattr(got, f).cpu(), getattr(ref, f), *band)
              for f, band in IP_BANDS.items()}
    inband["status"] = got.status.cpu() == ref.status
    bad = ~torch.stack(list(inband.values())).all(0)
    line = {"phase": "planner", "case": "c2_fused_ip_fallback",
            "horizon": horizon, "lanes": lanes, "dtype": "float64",
            "reason": reason,
            "budget": "ip 2x6, warm duals, default ip_alphas",
            "ms": ms, "kernel_launches": launches,
            "max_abs_err": {f: max_abs(getattr(got, f).cpu(),
                                       getattr(ref, f))
                            for f in ("X", "U", "kkt_stat")},
            "lanes_outside_bands": int(bad.sum())}
    emit(line)
    require(not launches, f"C2 fallback launched kernels: {launches}")
    require(not bool(bad.any()), "C2 fallback on the card differs from the "
            "CPU")
    return line


def c2_loop_inputs(lanes, steps):
    """C2's xla IP loop on the CPU: (lcfg, lanes)."""
    lcfg, lp = bench_loop(n_lanes=lanes, device="cpu", engine="xla",
                          **IP_WARM)
    return dataclasses.replace(lcfg, n_steps=steps), lp


def c2_loop_ref(lanes, steps):
    """C2's xla IP loop on the CPU (:func:`planner_c2_loop`'s
    reference)."""
    from mpc_tpu_torch.planner import closed_loop as cl
    return cl.closed_loop_batch_vec(*c2_loop_inputs(lanes, steps),
                                    device="cpu")


def planner_c2_loop(dev, card, lanes, steps, ref=None):
    """C2, second half: ``closed_loop_batch_vec`` with engine='xla',
    method='ip' (ip 1x4 warm, unguarded) runs ``closed_loop_batch`` on the
    per-lane solve: no kernel launches, X and U within the closed-loop
    bands of the CPU run and the same feasible lane-steps, a lane outside
    them excused only by rounding (the CPU's float32 and float64 loops part
    there), at most MAX_ROUNDING_SHARE of the lanes; solves/s as a
    record.  ``ref()``: the CPU's loop (:func:`c2_loop_ref`) where it ran
    elsewhere."""
    from mpc_tpu_torch.planner import closed_loop as cl
    lcfg, lp = c2_loop_inputs(lanes, steps)
    lp_d = lp.map(lambda t: t.to(dev))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    got = cl.closed_loop_batch_vec(lcfg, lp_d, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: n for k, n in launch_counts().items() if n}
    ref = ref() if ref else cl.closed_loop_batch_vec(lcfg, lp, device="cpu")

    def inband_of(a, b, bands):
        out = {f: ((getattr(a, f).cpu().double()
                    - getattr(b, f).cpu().double()).abs().nan_to_num(
                        float("inf")).flatten(1).amax(1) <= band)
               for f, band in bands.items()}
        out["feasible"] = ((a.status.cpu() >= 0)
                           == (b.status.cpu() >= 0)).all(1)
        return out

    bad = ~torch.stack(list(inband_of(got, ref, LOOP_BANDS).values())).all(0)
    excused = torch.zeros_like(bad)
    if bool(bad.any()):
        lanes_bad = bad.nonzero()[:, 0]
        sub = lp.map(lambda t: t[lanes_bad] if t.dim() else t)
        ref_sub = cl.closed_loop_batch_vec(lcfg, sub, device="cpu")
        sub64 = sub.map(lambda t: t.double() if t.is_floating_point() else t)
        ref64 = cl.closed_loop_batch_vec(lcfg, sub64, device="cpu")
        excused[lanes_bad] = ~torch.stack(list(inband_of(
            ref_sub, ref64, LOOP_BANDS).values())).all(0)
    name, limit = [s.strip() for s in card.split(",", 1)]
    line = {"phase": "planner", "case": "c2_xla_ip_loop", "lanes": lanes,
            "steps": steps, "horizon": lcfg.solver.horizon,
            "budget": "ip 1x4, warm duals, ip_alphas=()",
            "cold_start_solves": lcfg.cold_start_solves,
            "loop_s": seconds, "solves_per_s": lanes * steps / seconds,
            "kernel_launches": launches,
            "max_abs_err": {"X": max_abs(got.X.cpu(), ref.X),
                            "U": max_abs(got.U.cpu(), ref.U)},
            "feasible_steps": int((got.status >= 0).sum()),
            "feasible_steps_cpu": int((ref.status >= 0).sum()),
            "lanes_outside_bands": int(bad.sum()),
            "rounding_lanes": int((bad & excused).sum()),
            "gpu": name, "power_limit": limit}
    emit(line)
    require(not launches, f"C2 loop launched kernels: {launches}")
    require(not bool((bad & ~excused).any())
            and int(bad.sum()) <= MAX_ROUNDING_SHARE * lanes,
            "C2 loop on the card differs from the CPU")
    return line


def planner_profile(dev, steps=PROFILE_STEPS):
    """``steps`` warm steps of the deployment's loop (one lane, the
    per-lane solve, float32) under ``torch.profiler``, after its cold start
    and one unprofiled step, and the same steps unprofiled on the host
    clock: device kernels launched a step, device-busy ms against wall ms a
    step."""
    from torch.profiler import ProfilerActivity, profile

    from mpc_tpu_torch.io.config import load_config
    from mpc_tpu_torch.planner import closed_loop as cl
    c = load_config(str(ROOT / "configs" / DEPLOYMENT),
                    str(ROOT / "scenarios"))
    lcfg = cl.make_loop_config(c, noised=False)
    lp = cl.make_loop_params(c, lcfg, device=dev)
    carry = cl.init_carry(lcfg, lp, dev)
    carry, _ = cl.closed_loop_chunk(lcfg, lp, carry, 1, dev)
    torch.cuda.synchronize()
    start = carry
    t0 = time.perf_counter()
    cl.closed_loop_chunk(lcfg, lp, start, steps, dev)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cl.closed_loop_chunk(lcfg, lp, start, steps, dev)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    by_name = {}
    for e in prof.events():
        if e.device_type != cuda:
            continue
        n, ms = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    require(by_name, "the profiler saw no device kernels")
    busy = sum(ms for _, ms in by_name.values()) / steps
    launches = sum(n for n, _ in by_name.values()) / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    line = {"phase": "planner", "case": "profile", "config": DEPLOYMENT,
            "steps": steps, "wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy,
            "device_launches_per_step": launches,
            "idle_share": 1.0 - busy / wall_ms,
            "top": [{"kernel": k[:80], "launches": n, "ms": ms}
                    for k, (n, ms) in top]}
    emit(line)
    return line


# The untimed section: the work no timed phase reads, run before them in
# worker processes beside the build and beside each other, so that the
# timed phases after it have the card and the host to themselves.
WORKERS = 3   # processes beside this one; a task on the CPU takes 1 thread
# the kernels' checks: (phase_seconds key, the libraries each launches,
# the phase, its arguments after the device), the longest first
CHECKS = (
    ("check_fused_gn_st", ("fused_gn_st",), "phase_check", (), ST),
    ("check_soft_corridor", ("fused_gn",), "phase_check_corridor",
     ("soft-corridor", SOFT_CORRIDOR, 1.7), {}),
    ("check_fused_ip_st", ("fused_ip_st",), "phase_check_ip", (), ST),
    ("check_hard_corridor", ("fused_ip_ks_ring",), "phase_check_corridor",
     ("hard-corridor", HARD_CORRIDOR, 1.9), {}),
    ("check_xla_st", ("riccati",), "phase_check_sqp_vec", (), ST),
    ("check_fused_gn", ("fused_gn",), "phase_check", (), {}),
    ("check_riccati", ("riccati",), "phase_check_riccati", (), {}),
    ("check_linearize", (), "phase_check_linearize", (), {}),
    ("check_fused_ip", ("fused_ip",), "phase_check_ip", (), {}),
    ("check_st_roads", ("fused_gn_st", "fused_ip_st"),
     "phase_check_st_roads", (), {}),
    ("check_xla", ("riccati",), "phase_check_sqp_vec", (), {}),
    ("check_riccati_st", ("riccati",), "phase_check_riccati", (), ST))
# loop_vs_plain's plain loops on the CPU, (row, float64), the longest first
PLAIN_LOOPS = (("soft-corridor", False), ("soft-corridor", True),
               ("hard-st", False), ("hard-corridor", False),
               ("hard-corridor", True), ("soft-st", False),
               ("hard-gate1", False), ("soft-xla", False),
               ("soft-xla-backoff", False), ("hard", False),
               ("soft", False))


def _worker_init():
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _task(fn, args, kw):
    """A worker's task: this module's ``fn`` on (args, kw); returns (its
    result as ``torch.save`` writes it, the lines it emitted, its
    seconds).  A task that raises prints its lines first."""
    global _captured
    _captured, t0 = [], time.perf_counter()
    try:
        out = globals()[fn](*args, **kw)
    except BaseException:
        lines, _captured = _captured, None
        for line in lines:
            emit(line)
        raise
    lines, _captured = _captured, None
    buf = io.BytesIO()
    torch.save(out, buf)
    return buf.getvalue(), lines, time.perf_counter() - t0


class Workers:
    """WORKERS spawned processes running :func:`_task`; each task's result
    comes back through the getter :meth:`submit` returns, which emits its
    lines here and keeps its seconds in ``seconds[key]``."""

    def __init__(self, seconds, n=WORKERS):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        self.pool = ProcessPoolExecutor(
            n, mp_context=multiprocessing.get_context("spawn"),
            initializer=_worker_init)
        self.seconds = seconds

    def submit(self, key, fn, *args, **kw):
        future, box = self.pool.submit(_task, fn, args, kw), []

        def get():
            if not box:
                data, lines, self.seconds[key] = future.result()
                for line in lines:
                    emit(line)
                box.append(torch.load(io.BytesIO(data), map_location="cpu",
                                      weights_only=False))
            return box[0]
        return get

    def close(self, kill=False):
        """End the workers: after their tasks, or at once with ``kill``."""
        procs = list((self.pool._processes or {}).values())
        if kill:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
        self.pool.shutdown(wait=True, cancel_futures=True)
        for proc in procs:
            proc.join(10)


def phase_untimed(dev, card, seconds, workers=WORKERS):
    """Every piece no timed phase reads, first: the nvcc processes started
    (``_build.start_all``) and, in ``workers`` processes beside them, C2's
    and loop_vs_plain's plain loops on the CPU; here the planner's goldens
    and C2 on the card (:func:`planner_golden`, :func:`planner_c2_solve`,
    :func:`planner_c2_loop`), then each check of CHECKS whose libraries are
    built, until all are (:func:`phase_build`); then the deployment through
    the CLI twice (:func:`planner_cli_start`), the other checks, the
    fleet's (:func:`fleet_forcespro_checks`) and the entry point's NCCL
    rank (:func:`sharded_entry`) in the workers, and here loop_vs_plain's
    rows on the card.  Each piece's seconds go into ``seconds``; every
    worker and CLI process has ended on return.  Returns (the build line's
    kernels, {check key: its result}, the fleet's checks, the NCCL
    rank's)."""
    from mpc_tpu_torch.ops import _build
    pool = Workers(seconds, workers)
    started = []
    try:
        ref = {"c2_solve": pool.submit("c2_solve_ref", "c2_solve_ref",
                                       **C2_SOLVE),
               "c2_loop": pool.submit("c2_loop_ref", "c2_loop_ref",
                                      **C2_LOOP)}
        for row, f64 in PLAIN_LOOPS:
            ref[row, f64] = pool.submit(
                f"plain_loop_{row}{'_f64' if f64 else ''}", "plain_loop_ref",
                row, f64)
        _build.start_all()
        t0 = time.perf_counter()
        for config, tag in PLANNER_GOLDENS:
            planner_golden(dev, config, tag)
        planner_c2_solve(dev, **C2_SOLVE, ref=ref["c2_solve"])
        planner_c2_loop(dev, card, **C2_LOOP, ref=ref["c2_loop"])
        seconds["planner_goldens_c2"] = time.perf_counter() - t0
        checks, todo = {}, list(CHECKS)
        while todo and not all(map(_build.done, _build.SIGNATURES)):
            ready = [c for c in todo if all(map(_build.done, c[1]))]
            if not ready:
                time.sleep(0.5)
                continue
            todo.remove(ready[0])
            key, _, fn, args, kw = ready[0]
            t0 = time.perf_counter()
            checks[key] = globals()[fn](dev, *args, **kw)
            seconds[key] = time.perf_counter() - t0
        t0 = time.perf_counter()
        build = phase_build()
        seconds["build_wait"] = time.perf_counter() - t0
        started = [planner_cli_start(dev, rti1) for rti1 in (False, True)]
        later = {key: pool.submit(key, fn, dev, *args, **kw)
                 for key, _, fn, args, kw in todo}
        fleet = pool.submit("fleet_checks", "fleet_forcespro_checks", dev)
        entry = pool.submit("entry_one_rank", "sharded_entry", dev)
        for row in LOOP_VS_PLAIN_ROWS:
            t0 = time.perf_counter()
            phase_loop_vs_plain(dev, row, lambda r=row: (
                ref[r, False](), ref[r, True]() if (r, True) in ref
                else None))
            seconds[f"loop_vs_plain_{row}"] = time.perf_counter() - t0
        checks.update({key: get() for key, get in later.items()})
        fleet, entry = fleet(), entry()
        for run in started:
            planner_cli(dev, run)
    except BaseException:
        pool.close(kill=True)
        raise
    finally:
        for popen, _, _ in started:
            if popen.poll() is None:
                popen.kill()
                popen.wait()
    pool.close()
    return build, checks, fleet, entry


# The fleet phase: scenario fleets (parallel.multi) through the fused
# kernels, and the serving API on the same batch.
FLEET = ("config_CA_ZAM_Over-1_1_forcespro.yaml",    # boundary rows
         "config_CA_SYN_Moving-1.yaml",              # a moving obstacle
         "config_CA_ZAM_Over-1_1_forcespro_ref.yaml",
         "config_LF_ZAM_Tutorial-1_2_T-1.yaml")
FLEET_LF = (("config_LF_ZAM_Over-1_1.yaml", "zam_lf_casadi"),
            ("config_LF_USA_Lanker-2_18_T-1.yaml", "usa_lf_casadi"))
B_FLEET = 16384           # 4,096 lanes of each forcespro config
B_FLEET_LF = 1024         # 512 lanes of each casadi config
FLEET_CHECK_LANES = 256   # lanes of the solve held to the plain version
FLEET_PROFILE = dict(start=GATE_STEP, window=10)
ONLINE_STEPS = 8
ONLINE_NOISE = 0.02       # m of position noise a lane and step
LATENCY_STEPS = 5
GOLDEN_BAND = 0.05        # a batched lane against its single run,
                          # tests/test_multi_scenario.py:36
TRACK_BAND = 1.0          # tests/test_online.py:95-157
# The one entry no float32 solve holds (tests/test_torch_fleet_cold_start.py):
# at the first cold start, config 3's friction row, its lower side (h_f >= 0,
# h_f a sum of squares), at the terminal stage, where the car drives straight
# with a = 0, so h_f and its gradient vanish and the dual does not enter
# stationarity: not unique (a move of 1e-6 in the inputs moves it by 1e6 in
# the JAX package's own float64 solve).  {cold start: {config: entry}}
FLEET_UNHELD = {0: {3: ("lam_lo", -1, 0)}}


def fleet_configs(names):
    from mpc_tpu_torch.io.config import load_config
    return [load_config(str(ROOT / "configs" / n), str(ROOT / "scenarios"))
            for n in names]


def fleet_batch(dev, names, lanes, steps=None):
    """``make_multi_scenario_batch`` over the configs ``names``, tiled to
    ``lanes`` lanes (lane i a copy of config i % len(names)): (lcfg,
    params, each lane's own length (B,), the configs); ``steps`` cuts T
    (a rehearsal)."""
    from mpc_tpu_torch.parallel import multi
    cfgs = fleet_configs(names)
    lcfg, lp, lens = multi.make_multi_scenario_batch(cfgs, noised=False,
                                                     device=dev)
    if steps is not None:
        lcfg = dataclasses.replace(lcfg, n_steps=steps)
    idx = torch.arange(lanes, device=dev) % len(cfgs)
    return (lcfg, lp.map(lambda t: t[idx]),
            torch.tensor(lens, device=dev)[idx], cfgs)


def copies_agree(res, n_configs):
    """Per config, the share of its copies whose X and U lie within the IP
    bands of its first copy's and whose status equals it at every step."""
    out = []
    for s in range(n_configs):
        X, U, st = (getattr(res, f)[s::n_configs]
                    for f in ("X", "U", "status"))
        ok = (lanes_close(X, X[:1].expand_as(X), *IP_BANDS["X"])
              & lanes_close(U, U[:1].expand_as(U), *IP_BANDS["U"])
              & (st == st[:1]).all(1))
        out.append(float(ok.double().mean()))
    return out


def cold_start_inputs(lcfg, lp):
    """[(cfg, ocp, state)]: what each of the loop's cold-start solves is
    handed (the warm-up budget; each state the kernel's own from the solve
    before), recorded through ``_batch_cold_start`` itself."""
    from mpc_tpu_torch.planner import closed_loop as cl
    dev = lp.x_init.device
    solve, ins = cl._serving_engine(lcfg, lp, dev), []

    def record(cfg, ocp, state):
        ins.append((cfg, ocp, state.map(torch.clone)))
        return solve(cfg, ocp, state)
    cl._batch_cold_start(lcfg, lp, record)
    return ins


def fleet_checks(dev, lcfg, lp, check_lanes, check_step):
    """The fleet's solves against their plain version, on its first
    ``check_lanes`` lanes (copies of the four configs, lane i of config
    i % 4) unless said.  Each cold-start solve (the warm-up budget) by
    :func:`hold_by_config`: every config on which the plain version agrees
    with itself held, FLEET_UNHELD's entry left out; the loop's step-0
    solve by :func:`compare` on ``check_lanes`` copies of the three
    configs other than the deployment (lane i % 4 != 0); its solve at
    ``check_step`` by :func:`compare` (at step 50 the deployment's
    boundary rows bind).  Step 0, where the plain version's own float32
    and float64 solves part on the deployment's copies (its stationarity),
    is measured a config each by :func:`gate_calibration`.  Returns the
    max abs errors of the held solves and the configs each cold start
    held."""
    n = len(FLEET)
    lane = torch.arange(lp.x_init.shape[0], device=dev)
    held = lp.map(lambda t: t[lane[lane % n != 0][:check_lanes]])
    sub = lp.map(lambda t: t[:check_lanes])
    errs, cold_held = {}, {}
    for i, (cfg, ocp, state) in enumerate(cold_start_inputs(lcfg, sub)):
        errs[f"cold{i}"], cold_held[f"cold{i}"] = hold_by_config(
            f"fleet_cold{i}", cfg, ocp, state, n, FLEET_UNHELD.get(i))
    ins = loop_inputs(dev, lcfg, sub, (0, check_step))
    gate_calibration("fleet_step0_by_config", lcfg.solver, *ins[0],
                     kernel=True, groups=n)
    _, errs["step0"] = compare("fleet_step0", lcfg.solver,
                               *loop_inputs(dev, lcfg, held, (0,))[0])
    _, errs[f"step{check_step}"] = compare(f"fleet_step{check_step}",
                                           lcfg.solver, *ins[check_step])
    return errs, cold_held


def fleet_forcespro_checks(dev, lanes=B_FLEET,
                           check_lanes=FLEET_CHECK_LANES,
                           check_step=LOOP_CHECK_STEP):
    """:func:`fleet_checks` of :func:`fleet_forcespro`'s batch, on its
    own."""
    lcfg, lp, _, _ = fleet_batch(dev, FLEET, lanes)
    return fleet_checks(dev, lcfg, lp, check_lanes, check_step)


def fleet_forcespro(dev, lanes=B_FLEET, check_lanes=FLEET_CHECK_LANES,
                    profile=FLEET_PROFILE, steps=None,
                    check_step=LOOP_CHECK_STEP, checks=None):
    """(a) and (b): the four forcespro configs tiled to ``lanes`` lanes (ip
    2x6 warm duals, the 5-rung ladder, boundary rows with the dummy
    polylines 1e6 m out on three configs, moving obstacles, H=12, T=100,
    2 cold starts).  :func:`fleet_checks` holds its solves to the plain
    version; ``closed_loop_batch_vec`` (``plan_multi``'s loop) with its
    launches counted (fused_ip_ks_ring alone, a launch a solve), every
    lane-step feasible over the lane's own length (an infeasible one held
    to the plain loop on the CPU), the copies of a config within the IP
    bands of each other; the loop once more timed with CUDA events; a
    profiled window of steps; then ``init_batch_carry`` and T calls of
    ``closed_loop_batch_step`` fed no measurement, equal to the loop at
    atol 0.  ``steps`` cuts T (a rehearsal); ``checks()``: the checks'
    result (:func:`fleet_forcespro_checks`) where they ran elsewhere."""
    from mpc_tpu_torch.planner import closed_loop as cl
    lcfg, lp, lens, cfgs = fleet_batch(dev, FLEET, lanes, steps)
    n, T = len(cfgs), lcfg.n_steps
    check_err, cold_held = (checks() if checks else fleet_checks(
        dev, lcfg, lp, check_lanes, check_step))

    def loop():
        return cl.closed_loop_batch_vec(lcfg, lp, device=dev)
    res, launches, counted_s, peak = counted(loop)
    kernel = require_row_kernel("fleet", lcfg, launches)
    require(tuple(res.X.shape) == (lanes, T, 5), "fleet: X shape")
    require(bool(torch.isfinite(res.X).all()), "fleet: non-finite states")
    valid = torch.arange(T, device=dev)[None] < lens[:, None]
    status = torch.where(valid, res.status, torch.zeros_like(res.status))
    infeasible = status < 0
    agree = copies_agree(res, n)
    require(min(agree) >= MIN_LANE_AGREEMENT,
            f"fleet: the copies of a config disagree: {agree}")
    if bool(infeasible.any()):   # the copies agree: hold each first copy
        infeasible_vs_plain(dev, "fleet", lcfg, lp, status[:n])
    ms, again = cuda_ms(loop)
    require(torch.equal(again.status, res.status),
            "fleet: the statuses changed between runs")
    rerun_identical = bool(torch.equal(again.X, res.X))
    del again
    prof = phase_profile(dev, "fleet", lcfg, lp, **profile)
    step_ms = min(ms, counted_s * 1e3) / T

    carry, serve_launches, _, _ = counted(
        lambda: cl.init_batch_carry(lcfg, lp, dev))
    outs = []
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(T):
        carry, out = cl.closed_loop_batch_step(lcfg, lp, carry, device=dev)
        outs.append(out[:3])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = {k: v + serve_launches[k]
                      for k, v in launch_counts().items()}
    require_row_kernel("fleet serving", lcfg, serve_launches)
    X, U, S = (torch.stack(f, 1) for f in zip(*outs))
    require(torch.equal(X, res.X) and torch.equal(U, res.U)
            and torch.equal(S, res.status),
            "fleet: the serving chain differs from the loop")
    return {
        "configs": list(FLEET), "lanes": lanes,
        "lane_lengths": sorted(set(lens.tolist())),
        "horizon": lcfg.solver.horizon, "steps": T,
        "cold_start_solves": lcfg.cold_start_solves,
        "budget": f"{lcfg.solver.ip_sqp_iters}x{lcfg.solver.ip_iters}",
        "ip_alphas": list(lcfg.solver.ip_alphas),
        "kernel": kernel, "launches_by_kernel": launches,
        "check_step": check_step, "check_lanes": check_lanes,
        "check_max_abs_err": check_err, "cold_start_configs_held": cold_held,
        "infeasible_lane_steps": int(infeasible.sum()),
        "infeasible_lanes_by_config": [
            int(infeasible[s::n].any(1).sum()) for s in range(n)],
        "copies_agreement": agree,
        "solves_per_s": lanes * T / (step_ms * T / 1e3),
        "step_ms": step_ms, "counted_run_s": counted_s, "timed_run_ms": ms,
        "rerun_identical_X": rerun_identical,
        "peak_device_memory_bytes": peak,
        "profile": {k: prof[k] for k in (
            "window_steps", "device_busy_ms", "kernel_ms",
            "kernel_launches_seen", "linearize_boundaries_kernels_ms",
            "copy_kernels_ms", "device_launches")},
        "profile_idle_share": 1.0 - prof["device_busy_ms"]
                              / (profile["window"] * step_ms),
        "serving": {"launches_by_kernel": serve_launches,
                    "step_ms": serve_s * 1e3 / T,
                    "equal_to_loop_atol0": True}}


def fleet_online(dev, steps=ONLINE_STEPS):
    """(c) ``BatchedOnlinePlanner.from_scenarios`` on the four forcespro
    configs for ``steps`` steps, the plant the port's RK4 step with
    ONLINE_NOISE m of position noise a lane and step (a seeded
    generator), on the card and on the CPU (the plain version) from the
    same noise: the loops within the closed-loop bands with equal
    feasibility, and every lane within TRACK_BAND m of its own reference
    path unless the plain run ends as far out too (within the X band of
    it).  The JAX package's own fleet has the deployment config's lane
    infeasible at step 1 and 1.06 m out after 8 steps (its horizon is the
    batch's 12, not its own 14)."""
    from mpc_tpu_torch.models import dynamics as dyn
    from mpc_tpu_torch.planner.online import BatchedOnlinePlanner
    cfgs = fleet_configs(FLEET)
    gen = torch.Generator().manual_seed(0)
    noise = ONLINE_NOISE * torch.randn((steps, len(cfgs), 2), generator=gen)

    def drive(device):
        fleet = BatchedOnlinePlanner.from_scenarios(cfgs, device=device)
        s = fleet.lcfg.solver
        plant = dyn.make_step_fn("rk4", s.dt, s.wheelbase)
        x = fleet.params.x_init
        X, status, step_s = [], [], []
        for k in range(steps):
            t0 = time.perf_counter()
            u, info = fleet.step(x)        # numpy: the device is done
            step_s.append(time.perf_counter() - t0)
            X.append(x.cpu())
            status.append(torch.as_tensor(info.status))
            x = plant(x, torch.as_tensor(u, device=x.device))
            x[:, :2] += noise[k].to(x.device)
        return (fleet.lcfg, torch.stack(X, 1), torch.stack(status, 1),
                x.cpu(), step_s)

    (lcfg, X, status, x_end, step_s), launches, _, _ = counted(
        lambda: drive(dev))
    _, X_p, status_p, x_end_p, _ = drive("cpu")
    err_x = max_abs(X, X_p)

    def distance(x):
        return [float(np.min(np.linalg.norm(
            c.reference_path - x[i, :2].double().numpy(), axis=1)))
            for i, c in enumerate(cfgs)]
    d, d_p = distance(x_end), distance(x_end_p)
    kernel = engine(lcfg.solver).name
    want = lcfg.cold_start_solves + steps
    require(launches[kernel] == want and sum(launches.values()) == want,
            f"fleet online: launches {launches}, want {want} of {kernel}")
    require(err_x < LOOP_BANDS["X"] and torch.equal(status >= 0,
                                                    status_p >= 0),
            "fleet online: the card's fleet differs from the plain one")
    far = [i for i in range(len(cfgs)) if d[i] >= TRACK_BAND and not (
        d_p[i] >= TRACK_BAND and abs(d[i] - d_p[i]) < LOOP_BANDS["X"])]
    require(not far, f"fleet online: lanes {far} left their reference")
    return {"lanes": len(cfgs), "steps": steps, "noise_m": ONLINE_NOISE,
            "launches_by_kernel": launches,
            "step_ms": [t * 1e3 for t in step_s],
            "status": status.tolist(), "plain_status": status_p.tolist(),
            "max_abs_err_X_vs_plain": err_x,
            "distance_to_reference_m": d, "plain_distance_m": d_p}


def fleet_lf_pair(dev, lanes=B_FLEET_LF, steps=None):
    """(d) The casadi lane-following pair tiled to ``lanes`` lanes (al 3x4,
    the 6-rung ladder, H=10, no rows, T=70): fused_gn's ladder instance a
    launch a step, every lane within GOLDEN_BAND m of its single run's
    float64 golden over its own length, every step feasible there; ms a
    step the lower of the counted run (host clock) and a rerun timed with
    CUDA events, as (a); ``steps`` cuts T (a rehearsal)."""
    from mpc_tpu_torch.planner import closed_loop as cl
    lcfg, lp, lens, cfgs = fleet_batch(dev, [c for c, _ in FLEET_LF], lanes,
                                       steps)
    def loop():
        return cl.closed_loop_batch_vec(lcfg, lp, device=dev)
    res, launches, wall_s, peak = counted(loop)
    kernel = require_row_kernel("fleet-lf", lcfg, launches)
    ms, again = cuda_ms(loop)
    require(torch.equal(again.status, res.status),
            "fleet-lf: the statuses changed between runs")
    del again
    step_ms = min(ms, wall_s * 1e3) / lcfg.n_steps
    errs = {}
    for i, (_, tag) in enumerate(FLEET_LF):
        gold = torch.tensor(np.loadtxt(
            ROOT / "tests" / "goldens" / f"{tag}_states.txt"))
        require(bool((lens[i::2] == gold.shape[0]).all()),
                f"fleet-lf: {tag} length")
        L = min(gold.shape[0], lcfg.n_steps)
        errs[tag] = max_abs(res.X[i::2, :L, :2].cpu(),
                            gold[None, :L, :2].expand(lanes // 2, L, 2))
        require(errs[tag] < GOLDEN_BAND,
                f"fleet-lf: {tag} lanes {errs[tag]} m from the golden")
        require(bool((res.status[i::2, :L] >= 0).all()),
                f"fleet-lf: an infeasible step in a {tag} lane")
    from mpc_tpu_torch.ops import fused_gn as F
    return {"configs": [c for c, _ in FLEET_LF], "lanes": lanes,
            "horizon": lcfg.solver.horizon, "steps": lcfg.n_steps,
            "budget": f"{lcfg.solver.al_iters}x{lcfg.solver.sqp_iters}",
            "alphas": list(lcfg.solver.alphas), "kernel": kernel,
            "geometry": F.geometry(lcfg.solver, lanes),
            "launches_by_kernel": launches,
            "max_abs_err_xy_vs_golden": errs,
            "solves_per_s": lanes * 1e3 / step_ms, "step_ms": step_ms,
            "counted_run_s": wall_s, "timed_run_ms": ms,
            "peak_device_memory_bytes": peak}


def fleet_latency(dev, steps=LATENCY_STEPS):
    """(e) ``OnlinePlanner`` on the deployment config for ``steps`` steps
    fed the RK4 plant: ms a step (the host clock around ``step``, which
    returns numpy), no kernel launched (the per-lane path), every step
    feasible."""
    from mpc_tpu_torch.models import dynamics as dyn
    from mpc_tpu_torch.planner.online import OnlinePlanner
    planner = OnlinePlanner(fleet_configs([DEPLOYMENT])[0], device=dev)
    s = planner.lcfg.solver
    plant = dyn.make_step_fn("rk4", s.dt, s.wheelbase)

    def drive():
        x, out = planner.params.x_init, []
        for _ in range(steps):
            t0 = time.perf_counter()
            u, info = planner.step(x)
            out.append(((time.perf_counter() - t0) * 1e3, info.status))
            x = plant(x, torch.as_tensor(u, device=dev))
        return out
    out, launches, _, _ = counted(drive)
    require(not any(launches.values()),
            f"online planner: kernels launched {launches}")
    require(all(st >= 0 for _, st in out),
            f"online planner: infeasible steps {out}")
    ms = [m for m, _ in out]
    return {"config": DEPLOYMENT, "steps": steps, "step_ms": ms,
            "median_step_ms": float(np.median(ms)),
            "status": [st for _, st in out], "launches_by_kernel": launches}


def phase_fleet(dev, card, checks=None):
    """Scenario fleets through the fused kernels and the serving API: (a)
    and (b) :func:`fleet_forcespro` (``checks``: its checks' result where
    they ran elsewhere), (c) :func:`fleet_online`, (d)
    :func:`fleet_lf_pair`, (e) :func:`fleet_latency`; one line."""
    name, limit = [s.strip() for s in card.split(",", 1)]
    line, seconds = {"phase": "fleet"}, {}
    for piece, fn in (("forcespro", lambda d: fleet_forcespro(
                          d, checks=checks)),
                      ("online", fleet_online), ("lf_pair", fleet_lf_pair),
                      ("online_latency", fleet_latency)):
        t0 = time.perf_counter()
        line[piece] = fn(dev)
        seconds[piece] = time.perf_counter() - t0
    line.update(seconds=seconds, gpu=name, power_limit=limit)
    emit(line)
    return line


def fleet_launches(fleet, kernel):
    """A kernel's launches in each counted run of the fleet phase."""
    return {"plan_multi": fleet["forcespro"]["launches_by_kernel"][kernel],
            "serving": fleet["forcespro"]["serving"]["launches_by_kernel"][
                kernel],
            "online": fleet["online"]["launches_by_kernel"][kernel],
            "lf_pair": fleet["lf_pair"]["launches_by_kernel"][kernel],
            "online_latency":
                fleet["online_latency"]["launches_by_kernel"][kernel]}


# --------------------------------------------------------------------------
# sharded: lanes over ranks (parallel.mesh, parallel.batch) and pscan
# --------------------------------------------------------------------------

SHARDED_STEPS = 20        # steps of the soft row's sharded loop
SHARDED_RANKS = 2         # ranks that share the one card in (b) and (c)
SHARDED_TIMEOUT_S = 240.0  # the spawned ranks' limit, start-up included
PSCAN_HORIZONS = (30, 128)  # the per-lane solve's scan/pscan timing
PSCAN_BAND = 1e-3         # U of pscan against scan (tests/test_pscan.py)


def sharded_rows(dev, lanes=B_BENCH, steps=SHARDED_STEPS):
    """The sharded phase's two loads at B=16384 (``lanes``): the soft row
    (al 1x1, alphas=(), H=30) as a SHARDED_STEPS-step loop, and the hard
    row's cold 5x10 solve of its step 0 (cfg, ocp, state)."""
    from mpc_tpu_torch.ops import sqp as S
    lcfg, lp = bench_loop(n_lanes=lanes, device=dev, method="al", **WARM)
    lcfg = dataclasses.replace(lcfg, n_steps=steps)
    hcfg, hlp = bench_loop(n_lanes=lanes, device=dev, **IP_COLD)
    state = S.init_state(hcfg.solver, device=dev, batch=lanes)
    return lcfg, lp, (hcfg.solver, ocp_at(hcfg, hlp, 0), state)


def loop_summary_host(res):
    """``summarize_loop``'s four numbers, reduced on the host (float64)."""
    status = res.status.cpu().numpy()
    return (int((status == 1).sum()), int((status < 0).sum()),
            float(res.viol.double().max()),
            float(res.cost.double().sum()) / status.size)


def sharded_one_rank(dev, lcfg, lp):
    """(a): one rank, ``init_distributed(backend='nccl')`` a no-op at world
    size 1, a (1, 1) mesh; the sharded soft loop against
    ``closed_loop_batch_vec`` at atol 0 and ``summarize_loop`` against the
    host's reduction."""
    from mpc_tpu_torch.parallel import batch as pb
    from mpc_tpu_torch.parallel import mesh as pm
    from mpc_tpu_torch.planner import closed_loop as cl
    pm.init_distributed(backend="nccl")
    mesh = pm.make_mesh()
    require(mesh.shape == {"dp": 1, "sp": 1}, f"one-rank mesh {mesh.shape}")
    (res, census), launches, wall, peak = counted(
        lambda: pb.collective_census(pb.closed_loop_batch_sharded, lcfg, lp,
                                     mesh, device=dev))
    kernel = require_row_kernel("sharded-one-rank", lcfg, launches)
    ref = cl.closed_loop_batch_vec(lcfg, lp, device=dev)
    for f in ("X", "U", "status"):
        require(torch.equal(getattr(res, f), getattr(ref, f)),
                f"sharded (1, 1) loop {f} != closed_loop_batch_vec")
    summ = [float(v) for v in pb.summarize_loop(res, mesh)]
    host = loop_summary_host(res)
    require(summ[:3] == list(host[:3]) and abs(summ[3] - host[3])
            <= 1e-6 * abs(host[3]), f"summarize_loop {summ} != host {host}")
    require(int(summ[1]) == 0, f"{int(summ[1])} infeasible lane-steps")
    return {"mesh": mesh.shape, "kernel": kernel, "launches": launches,
            "collectives": census, "equal_atol0": ["X", "U", "status"],
            "summary": summ, "summary_host": host, "wall_s": wall,
            "peak_device_memory_bytes": peak}, ref


def _sharded_rank(rank, port, out_dir):
    """One rank of (b) and (c) on the card it shares: gloo, a (2, 1) mesh
    for the soft loop and the hard solve (each gathered and held to the
    one-call results that ``out_dir/ref.pt`` holds, with the sizes, the
    rank's device, or None for ``cuda:{LOCAL_RANK % device_count}``, and
    a hook the rank calls first), then ``entry.dryrun_multichip(2)``; its
    results go to ``rank_<r>.pt``."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(SHARDED_RANKS), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mpc_tpu_torch import entry
    from mpc_tpu_torch.parallel import batch as pb
    from mpc_tpu_torch.parallel import mesh as pm
    out = {"rank": rank}
    try:
        ref = torch.load(os.path.join(out_dir, "ref.pt"), weights_only=False)
        if ref["hook"] is not None:
            ref["hook"](rank)
        dev = pm.local_device(ref["device"])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        pm.init_distributed("gloo")
        mesh = pm.make_mesh((SHARDED_RANKS, 1))
        out.update(device=str(dev), backend=torch.distributed.get_backend(),
                   mesh=dict(mesh.shape), coords=dict(mesh.coords))
        ref = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
               for k, v in ref.items()}
        lanes = ref["lanes"]
        lcfg, lp, (hcfg, hocp, hstate) = sharded_rows(dev, lanes,
                                                      ref["steps"])

        def soft():
            return pm.gather_lanes(pb.closed_loop_batch_sharded(
                lcfg, lp, mesh, device=dev), mesh)

        (res, census), launches, wall, _ = counted(
            lambda: pb.collective_census(soft))
        out["soft"] = {"launches": launches, "wall_s": wall,
                       "collectives": census,
                       "lanes_per_rank": lanes // SHARDED_RANKS,
                       "max_abs_err": {f: max_abs(getattr(res, f), ref[f])
                                       for f in ("X", "U")},
                       "equal": {f: bool(torch.equal(getattr(res, f),
                                                     ref[f]))
                                 for f in ("X", "U", "status")},
                       "in_loop_bands": {
                           f: float(lanes_close(getattr(res, f), ref[f],
                                                0.0, LOOP_BANDS[f])
                                    .float().mean()) for f in ("X", "U")}}

        def hard():
            return pm.gather_lanes(pb.solve_batch_sharded(
                hcfg, hocp, hstate, mesh, device=dev), mesh)

        (sol, census), launches, wall, _ = counted(
            lambda: pb.collective_census(hard))
        out["hard"] = {"launches": launches, "wall_s": wall,
                       "collectives": census,
                       "max_abs_err": {f: max_abs(getattr(sol, f),
                                                  ref["hard_" + f])
                                       for f in ("X", "U")},
                       "equal": {f: bool(torch.equal(getattr(sol, f),
                                                     ref["hard_" + f]))
                                 for f in ("X", "U", "status")},
                       "in_ip_bands": {
                           f: float(lanes_close(getattr(sol, f),
                                                ref["hard_" + f],
                                                *IP_BANDS[f])
                                    .float().mean()) for f in ("X", "U")}}
        del res, sol, lp, hocp, hstate
        torch.cuda.empty_cache()
        (line, census), launches, wall, _ = counted(
            lambda: pb.collective_census(entry.dryrun_multichip,
                                         SHARDED_RANKS, device=dev))
        out["dryrun"] = {"line": line, "launches": launches, "wall_s": wall,
                         "collectives": len(census),
                         "collective_ops": sorted({c["op"] for c in census}),
                         "collective_devices": sorted(
                             {c["device"] for c in census}),
                         "collective_backends": sorted(
                             {c["backend"] for c in census})}
    except BaseException:
        import traceback
        out["error"] = traceback.format_exc()
        raise
    finally:
        torch.save(out, os.path.join(out_dir, f"rank_{rank}.pt"))
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def spawn_ranks(fn, out_dir, nprocs=SHARDED_RANKS):
    """``fn(rank, port, out_dir)`` in ``nprocs`` spawned processes; each
    rank's saved results (``out_dir/rank_<r>.pt``).  A rank that raises,
    dies or outlives SHARDED_TIMEOUT_S fails the phase (and every rank is
    stopped)."""
    import socket
    import torch.multiprocessing as mp
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    ctx = mp.start_processes(fn, args=(port, out_dir), nprocs=nprocs,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + SHARDED_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            require(time.monotonic() <= deadline, "sharded ranks still "
                    f"running after {SHARDED_TIMEOUT_S} s")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        raise CheckFailed(f"a sharded rank failed: {e}") from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [torch.load(os.path.join(out_dir, f"rank_{r}.pt"),
                       weights_only=False) for r in range(nprocs)]


def sharded_two_ranks(dev, lcfg, loop, hard, hard_ref, rank_device=None,
                      hook=None):
    """(b) and (c): two gloo ranks, each on ``cuda:0`` (``rank_device``),
    ``hook(rank)`` run first in each.  The soft loop's X and U equal (a)'s
    at atol 0 where both ranks' half batch takes the same fused_gn
    instance (threads a lane) as the whole batch, else lie in the loop
    bands; the same for the hard solve against the one-call fused_ip
    (lanes a block; else the IP bands).  The dry run's asserts hold in
    both ranks, its engine-sharded loop launches fused_gn, and rank 0
    prints its line."""
    import tempfile
    from mpc_tpu_torch.ops import fused_gn as F
    from mpc_tpu_torch.ops import fused_ip as FI
    lanes = loop.X.shape[0]
    half = lanes // SHARDED_RANKS
    geometry = {"fused_gn": [F.geometry(lcfg.solver, b)
                             for b in (lanes, half)],
                "fused_ip": [FI.geometry(hard[0], b) for b in (lanes, half)]}
    # the instance: threads a lane (fused_gn), lanes a block (fused_ip)
    same = {k: g[0][knob] == g[1][knob] for (k, g), knob in zip(
        geometry.items(), ("threads_per_lane", "lanes_per_block"))}
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    torch.save({"X": loop.X.cpu(), "U": loop.U.cpu(),
                "status": loop.status.cpu(), "hard_X": hard_ref.X.cpu(),
                "hard_U": hard_ref.U.cpu(),
                "hard_status": hard_ref.status.cpu(), "lanes": lanes,
                "steps": lcfg.n_steps, "device": rank_device, "hook": hook},
               f"{out_dir}/ref.pt")
    want = rank_device or "cuda:0"
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_ranks(_sharded_rank, out_dir)
    wall = time.perf_counter() - t0
    for r in ranks:
        require(r["backend"] == "gloo" and r["device"] == want,
                f"rank {r['rank']}: {r['backend']} on {r['device']}")
        for piece, kernel, key in (("soft", "fused_gn", "in_loop_bands"),
                                   ("hard", "fused_ip", "in_ip_bands")):
            p = r[piece]
            require(p["launches"][kernel] > 0,
                    f"rank {r['rank']} {piece}: {kernel} not launched")
            if same[kernel]:
                require(all(p["equal"].values()),
                        f"rank {r['rank']} {piece}: same {kernel} instance, "
                        f"not equal at atol 0: {p['max_abs_err']}")
            else:
                require(min(p[key].values()) >= MIN_LANE_AGREEMENT,
                        f"rank {r['rank']} {piece}: lanes in band {p[key]}")
        # the dry run's engine-sharded loop; its IP solve, with the loop's
        # stage axis, takes the per-lane path (entry.dryrun_multichip)
        require(r["dryrun"]["launches"]["fused_gn"] > 0,
                f"rank {r['rank']} dry run: {r['dryrun']['launches']}")
    return {"ranks": ranks, "wall_s": wall, "geometry": geometry,
            "same_instance_as_one_call": same,
            "applied": {k: "atol 0" if v else
                        ("loop bands" if k == "fused_gn" else "IP bands")
                        for k, v in same.items()}}


# The one failure of the entry point's dry run at world size 1 that (e)
# accepts, to the letter: its open-loop IP step (no stage axis) runs on the
# fused IP kernel, which leaves lane 0 at its steering-rate bound with its
# stationarity above the status's threshold in float32, as the JAX
# package's Pallas kernel does on the same step (ROADMAP queue C, C4;
# tests/test_torch_entry_world_one.py).
ENTRY_C4 = "1/2 converged open-loop solves; status by lane [0, 1]"


def entry_path(device=None):
    """``entry.main``'s path (``entry.run``: the default backend and
    device, ``entry()``, the dry run over the world).  Returns (entry's
    (U, status) on the host, the dry run's line, or ENTRY_C4's failure as
    text); any other failure of the dry run raises."""
    from mpc_tpu_torch import entry
    (U, status), dry = entry.run(device=device)
    if isinstance(dry, AssertionError):
        if str(dry) != ENTRY_C4:
            raise dry
        dry = f"AssertionError: {dry}"
    return (U.cpu(), status.cpu()), dry


def _entry_rank(rank, port, out_dir):
    """(e): the entry point's default path in a rank a launcher started
    alone (``WORLD_SIZE=1``, ``MASTER_PORT`` set, so ``init_distributed``
    joins a group of one): ``out_dir/ref.pt``'s hook run first (its return
    value saved), then :func:`entry_path` on its defaults under
    ``collective_census``, the launches counted; the results go to
    ``rank_0.pt``."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE="1", RANK=str(rank), LOCAL_RANK=str(rank))
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mpc_tpu_torch.parallel import batch as pb
    from mpc_tpu_torch.parallel import mesh as pm
    out = {"rank": rank}
    try:
        ref = torch.load(os.path.join(out_dir, "ref.pt"), weights_only=False)
        out["hook"] = ref["hook"](rank) if ref["hook"] is not None else None
        (((U, status), outcome), census), launches, wall, _ = counted(
            lambda: pb.collective_census(entry_path))
        out.update(backend=torch.distributed.get_backend(),
                   group_size=torch.distributed.get_world_size(),
                   mesh_device_type=pm.make_mesh().device_mesh.device_type,
                   U=U, status=status, dryrun=outcome, collectives=census,
                   launches=launches, wall_s=wall)
    except BaseException:
        import traceback
        out["error"] = traceback.format_exc()
        raise
    finally:
        torch.save(out, os.path.join(out_dir, f"rank_{rank}.pt"))
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def sharded_entry(dev, rank_device=None, hook=None):
    """(e) ``mpc_tpu_torch.entry``'s path on its defaults
    (:func:`entry_path`): in this process on ``dev`` (no process group:
    the one-process run), then in one rank spawned as a launcher starts
    one, which joins a group of one with the default backend (NCCL) on its
    default device (``cuda:0``; ``rank_device`` where the hook moves it,
    and then the backend it serves NCCL with, gloo on the CPU).
    entry()'s U and status equal the one-process run's at atol 0, and so
    does the dry run's outcome; its collectives all ran through
    ``backend`` on that device; the mesh it makes is on the backend's
    device type."""
    import tempfile
    ((ref_U, ref_status), ref_outcome), launches, wall, _ = counted(
        lambda: entry_path(rank_device or dev))
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_entry_")
    torch.save({"hook": hook}, f"{out_dir}/ref.pt")
    t0 = time.perf_counter()
    r, = spawn_ranks(_entry_rank, out_dir, nprocs=1)
    spawn_s = time.perf_counter() - t0
    want = str(torch.device(rank_device or "cuda:0"))
    backend = "nccl" if torch.device(want).type == "cuda" else "gloo"
    census = r["collectives"]
    where = {(c["backend"], c["device"]) for c in census}
    require(r["backend"] == backend and r["group_size"] == 1,
            f"entry rank: {r['backend']} group of {r['group_size']}")
    require(r["mesh_device_type"] == torch.device(want).type,
            f"entry rank: a mesh on {r['mesh_device_type']}")
    require(census and where == {(backend, want)},
            f"entry rank: collectives on {where}, want {(backend, want)}")
    equal = {"U": bool(torch.equal(r["U"], ref_U)),
             "status": bool(torch.equal(r["status"], ref_status)),
             "dryrun_outcome": r["dryrun"] == ref_outcome}
    require(all(equal.values()),
            f"entry rank: not equal to the one-process run: {equal}")
    require(launches["fused_gn"] > 0 and r["launches"]["fused_gn"] > 0,
            f"entry: fused_gn launches {launches}, {r['launches']}")
    ops = {}
    for c in census:
        op = ops.setdefault(c["op"], {"calls": 0, "bytes": 0})
        op["calls"] += 1
        op["bytes"] += c["bytes"]
    return {"backend": r["backend"], "device": want, "group_size": 1,
            "mesh_device_type": r["mesh_device_type"],
            "collectives_by_op": ops, "collectives": len(census),
            "equal_atol0": equal, "dryrun_outcome": r["dryrun"],
            "launches": r["launches"], "one_process_launches": launches,
            "rank_wall_s": r["wall_s"], "one_process_wall_s": wall,
            "spawn_s": spawn_s, "hook": r["hook"]}


def pscan_timing(dev, card, lanes=B_BENCH, horizons=PSCAN_HORIZONS):
    """(d): ms per solve of the per-lane AL path ``sqp.solve_batch`` at the
    bench point (al 1x1, alphas=()), B=16384, lqr_backend 'scan' against
    'pscan', unsharded, at each of PSCAN_HORIZONS (a horizon whose scan
    solve takes past ONE_TIMED_RUN_S is the last): a counted call, then
    the best of up to 3 on CUDA events; pscan's U held to scan's on
    MIN_LANE_AGREEMENT of the lanes at PSCAN_BAND."""
    from mpc_tpu_torch.ops import sqp as S
    name, limit = [s.strip() for s in card.split(",", 1)]
    rows = []
    for Hs in horizons:
        lcfg, lp = bench_loop(horizon=Hs, n_lanes=lanes, device=dev,
                              method="al", **WARM)
        ocp = ocp_at(lcfg, lp, 0)
        row, sols = {"horizon": Hs, "batch": lanes, "budget": "al 1x1"}, {}
        for backend in ("scan", "pscan"):
            cfg = dataclasses.replace(lcfg.solver, lqr_backend=backend)
            st = S.init_state(cfg, device=dev, batch=lanes)
            sols[backend], launches, first, peak = counted(
                lambda: S.solve_batch(cfg, ocp, st, device=dev))
            require(not any(launches.values()),
                    f"per-lane solve launched {launches}")
            times = [cuda_ms(lambda: S.solve_batch(cfg, ocp, st,
                                                   device=dev))[0]]
            reps = max(1, min(3, int(ONE_TIMED_RUN_S / 4e-3 / times[0])))
            times += [cuda_ms(lambda: S.solve_batch(cfg, ocp, st,
                                                    device=dev))[0]
                      for _ in range(reps - 1)]
            row[backend] = {"ms": min(times), "reps": reps,
                            "counted_call_s": first,
                            "peak_device_memory_bytes": peak}
        ok = lanes_close(sols["pscan"].U, sols["scan"].U, PSCAN_BAND,
                         PSCAN_BAND)
        row["pscan_vs_scan_max_abs_err_U"] = max_abs(sols["pscan"].U,
                                                     sols["scan"].U)
        row["lanes_within_band"] = float(ok.float().mean())
        require(row["lanes_within_band"] >= MIN_LANE_AGREEMENT,
                f"pscan H={Hs}: {row['lanes_within_band']} of lanes within "
                f"{PSCAN_BAND} of scan")
        row["pscan_over_scan"] = row["pscan"]["ms"] / row["scan"]["ms"]
        rows.append(row)
        del sols, lp, ocp
        if row["scan"]["ms"] > 1e3 * ONE_TIMED_RUN_S:
            break
    return {"rows": rows, "gpu": name, "power_limit": limit}


def phase_sharded(dev, card, lanes=B_BENCH, steps=SHARDED_STEPS,
                  horizons=PSCAN_HORIZONS, rank_device=None, hook=None,
                  entry=None):
    """Lanes over ranks on the one card: (a) one rank (:func:`sharded_one_
    rank`), (b) and (c) two gloo ranks (:func:`sharded_two_ranks`: the soft
    loop, the hard solve, the dry run), (e) the entry point's default path
    in one NCCL rank (:func:`sharded_entry`), (d)
    :func:`pscan_timing`; one line.  ``hook(rank)`` runs first in every
    rank the phase spawns; ``rank_device`` is their device; ``entry()``:
    (e)'s result where it ran elsewhere."""
    from mpc_tpu_torch.ops import fused_ip as FI
    name, limit = [s.strip() for s in card.split(",", 1)]
    seconds = {}
    t0 = time.perf_counter()
    lcfg, lp, hard = sharded_rows(dev, lanes, steps)
    one, loop = sharded_one_rank(dev, lcfg, lp)
    hard_ref, launches, _, _ = counted(
        lambda: FI.solve_batch_fused_ip(*hard, device=dev))
    require(launches["fused_ip"] == 1, f"one-call hard solve: {launches}")
    seconds["one_rank"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    two = sharded_two_ranks(dev, lcfg, loop, hard, hard_ref, rank_device,
                            hook)
    seconds["two_ranks"] = time.perf_counter() - t0
    del loop, lp, hard, hard_ref
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    if entry:
        entry_rank = entry()
    else:
        t0 = time.perf_counter()
        entry_rank = sharded_entry(dev, rank_device, hook)
        seconds["entry_one_rank"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    timing = pscan_timing(dev, card, lanes, horizons)
    seconds["pscan_timing"] = time.perf_counter() - t0
    line = {"phase": "sharded", "one_rank": one, "two_ranks": two,
            "dryrun_line": two["ranks"][0]["dryrun"]["line"],
            "entry_one_rank": entry_rank,
            "pscan_timing": timing, "seconds": seconds, "gpu": name,
            "power_limit": limit}
    emit(line)
    return line


def sharded_launches(sharded, kernel):
    """A kernel's launches in each counted run of the sharded phase: (a),
    per rank the soft loop, the hard solve and the dry run of (b) and (c),
    and the NCCL rank's entry path (e)."""
    ranks = sharded["two_ranks"]["ranks"]
    return {"one_rank": sharded["one_rank"]["launches"][kernel],
            **{piece: [r[piece]["launches"][kernel] for r in ranks]
               for piece in ("soft", "hard", "dryrun")},
            "entry": sharded["entry_one_rank"]["launches"][kernel]}


def boundary_instance_line(eng, loop, timing, warm, cold, checks, build,
                           split=None):
    """The boundary-row instance of one fused kernel in its corridor row:
    the launches of the row's loop, the largest errors of its checks, the
    times of its own budget (warm) and warm-up budget (cold) with their
    bounds and the glue of the rows' models, its registers, spills and
    shared memory; ``split``: its split timings."""
    errs = list(checks.values()) + [t["max_abs_err"]
                                    for k, t in timing.items()
                                    if k != "split"]
    info = build[eng.name]["boundary_instance"]
    return {
        "row": loop["row"], "launches": loop["kernel_launches"],
        "feasible_steps": loop["feasible_steps"],
        "total_solves": loop["total_solves"],
        "active_boundary_lane_steps": loop["active_boundary_lane_steps"],
        "max_abs_err": max(e["U"] for e in errs),
        "max_abs_err_X": max(e["X"] for e in errs),
        "ms": timing[warm]["ms"], "plain_ms": timing[warm]["plain_ms"],
        "bound_ms": timing[warm]["bound_ms"],
        "bound_by": timing[warm]["bound_by"], "library_ms": None,
        "boundary_models_ms": timing[warm]["boundary_models_ms"],
        cold: timing[cold],
        "registers": info["registers"],
        "spill_stores": info["spill_stores"],
        "spill_loads": info["spill_loads"],
        "smem_bytes_per_block": info["smem_bytes_per_block"],
        "geometry": info["geometry"], **({"split": split} if split else {})}


def kernel_line(eng, loop, timing, warm, cold, checks, build,
                boundary=None, split=None):
    """The kernels-line entry of one fused kernel: the warm bench budget's
    times, the main path's launches, the largest errors of every check;
    ``boundary``: its boundary-row instance's entry; ``split``: its split
    timings."""
    errs = list(checks.values()) + [t["max_abs_err"]
                                    for k, t in timing.items()
                                    if k != "split"]
    info = build[eng.name]
    return {
        "name": eng.name, "route": "cuda",
        "source": "mpc_tpu_torch/ops/csrc/"
                  + SOURCES.get(eng.name, f"{eng.name}.cu"),
        "replaces": eng.replaces,
        "launches": loop["kernel_launches"],
        "max_abs_err": max(e["U"] for e in errs),
        "max_abs_err_U": max(e["U"] for e in errs),
        "max_abs_err_X": max(e["X"] for e in errs),
        "ms": timing[warm]["ms"], "plain_ms": timing[warm]["plain_ms"],
        "bound_ms": timing[warm]["bound_ms"],
        "bound_by": timing[warm]["bound_by"],
        "library_ms": None,
        cold: timing[cold],
        "registers": info["registers"],
        "spill_stores": info["spill_stores"],
        "spill_loads": info["spill_loads"],
        "smem_bytes_per_block": info["smem_bytes_per_block"],
        **({"geometry": info["geometry"]} if "geometry" in info else {}),
        **({"boundary_instance": boundary} if boundary else {}),
        **({"split": split} if split else {}), "ok": True}


def st_boundary_line(eng, checks, check_launches, build):
    """The boundary-row instance of an ST library: no row of the main path
    drives it, so its checks' launches and largest errors (the bending
    road, where rows bind), registers, spills, shared memory and
    geometry."""
    info = build[eng.name]["boundary_instance"]
    return {"row": None, "check_launches": sum(check_launches.values()),
            "max_abs_err": max(e["U"] for e in checks.values()),
            "max_abs_err_X": max(e["X"] for e in checks.values()),
            "checks": sorted(checks), "registers": info["registers"],
            "spill_stores": info["spill_stores"],
            "spill_loads": info["spill_loads"],
            "smem_bytes_per_block": info["smem_bytes_per_block"],
            "geometry": info["geometry"]}


def riccati_kernel_line(loop, timing, checks, checks_vec, build, st=None):
    """The kernels-line entry of the sweep: its time on the bench point's
    step-0 quadratics, its launches in the xla row, the largest gain error
    of every sweep check (and the U error of the engine checks); ``st``:
    the same of its nx=7 instance, (loop, timing, checks, checks_vec) of
    the xla-st row."""
    info = build["riccati"]
    errs = list(checks.values()) + [timing["max_abs_err"]]
    extra = {}
    if st is not None:
        st_line = riccati_kernel_line(*st, {"riccati": dict(
            info["st_instance"],
            smem_bytes_per_block=info["smem_bytes_per_block"])})
        extra["st_instance"] = dict(
            st_line, name="riccati nx=7",
            replaces="the nx=7 sweep of mpc_tpu/ops/riccati_vec.py::"
                     "backward_pass_vec (engine='xla', model='st'; the "
                     "Pallas kernel is KS-only)")
    return {
        "name": "riccati", "route": "cuda",
        "source": "mpc_tpu_torch/ops/csrc/riccati.cu",
        "replaces": "tools/ablation/pallas_riccati.py:104 (_riccati_kernel)",
        "launches": loop["kernel_launches"],
        "max_abs_err": max(e["K"] for e in errs),
        "max_abs_err_d": max(e["d"] for e in errs),
        "max_abs_err_engine_U": max(e["U"] for e in checks_vec.values()),
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None, "pack_ms": timing["pack_ms"],
        "registers": info["registers"],
        "spill_stores": info["spill_stores"],
        "spill_loads": info["spill_loads"],
        "smem_bytes_per_block": info["smem_bytes_per_block"],
        **extra, "ok": True}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one "
              "GPU", file=sys.stderr)
        return 2
    if not (ROOT / "mpc_tpu_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (no "
              "mpc_tpu_torch package beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = time.perf_counter() - t0
        return out

    card = timed("device", phase_device)
    build, chk, fleet_checks, entry = timed("untimed", phase_untimed, dev,
                                            card, seconds)
    checks, checks_ip = chk["check_fused_gn"], chk["check_fused_ip"]
    checks_ric, checks_vec = chk["check_riccati"], chk["check_xla"]
    checks_st, checks_ip_st = chk["check_fused_gn_st"], \
        chk["check_fused_ip_st"]
    checks_roads_st, launches_roads_st = chk["check_st_roads"]
    checks_ric_st, checks_vec_st = chk["check_riccati_st"], \
        chk["check_xla_st"]
    checks_sc, checks_hc = chk["check_soft_corridor"], \
        chk["check_hard_corridor"]
    timing = timed("timing_fused_gn", phase_timing, dev,
                   **TIMING_ROWS["soft"])
    timing_ip = timed("timing_fused_ip", phase_timing, dev,
                      **TIMING_ROWS["hard"])
    timing_ric = timed("timing_riccati", phase_timing_riccati, dev)
    timing_sc = timed("timing_soft_corridor", phase_timing, dev,
                      **TIMING_ROWS["soft-corridor"])
    timing_hc = timed("timing_hard_corridor", phase_timing, dev,
                      **TIMING_ROWS["hard-corridor"])
    timing_st = timed("timing_fused_gn_st", phase_timing, dev,
                      **TIMING_ROWS["soft-st"])
    timing_ip_st = timed("timing_fused_ip_st", phase_timing, dev,
                         **TIMING_ROWS["hard-st"])
    timing_ric_st = timed("timing_riccati_st", phase_timing_riccati, dev,
                          **ST)
    loop, lcfg, lp = timed(
        "loop_soft", phase_loop, dev, card, "soft",
        "al 1x1, alphas=() (unguarded RTI step)", method="al", **WARM)
    timed("profile_soft", phase_profile, dev, "soft", lcfg, lp)
    soft = engine(lcfg.solver)
    loop_ip, lcfg, lp = timed(
        "loop_hard", phase_loop, dev, card, "hard",
        "ip 1x4, warm duals, ip_alphas=() (unguarded RTI step)", **IP_WARM)
    timed("profile_hard", phase_profile, dev, "hard", lcfg, lp)
    hard = engine(lcfg.solver)
    loop_xla, lcfg, lp = timed(
        "loop_xla", phase_loop, dev, card, "xla",
        f"al 1x1, alphas=() (unguarded RTI step), engine='xla', "
        f"{XLA_STEPS} steps", steps=XLA_STEPS, **XLA_WARM)
    timed("profile_xla", phase_profile, dev, "xla", lcfg, lp, window=5)
    loop_hc, lcfg, lp = timed(
        "loop_hard_corridor", phase_loop, dev, card, "hard-corridor",
        "ip 2x6, warm duals, default ip_alphas, boundary rows, H=14 "
        "(config_CA_ZAM_Over-1_1_forcespro.yaml)", **HARD_CORRIDOR)
    timed("profile_hard_corridor", phase_profile, dev, "hard-corridor",
          lcfg, lp, window=10, start=GATE_STEP)
    hard_corridor = engine(lcfg.solver)
    loop_sc, lcfg, lp = timed(
        "loop_soft_corridor", phase_loop, dev, card, "soft-corridor",
        "al 3x4, default alphas, boundary rows", **SOFT_CORRIDOR)
    timed("profile_soft_corridor", phase_profile, dev, "soft-corridor",
          lcfg, lp, window=10, start=GATE_STEP)
    loop_st, lcfg, lp = timed(
        "loop_soft_st", phase_loop, dev, card, "soft-st",
        "al 1x1, alphas=() (unguarded RTI step), model='st'", **SOFT_ST)
    timed("profile_soft_st", phase_profile, dev, "soft-st", lcfg, lp,
          window=10, start=LOOP_CHECK_STEP)
    soft_st = engine(lcfg.solver)
    loop_ip_st, lcfg, lp = timed(
        "loop_hard_st", phase_loop, dev, card, "hard-st",
        "ip 1x4, warm duals, ip_alphas=() (unguarded RTI step), model='st'",
        **HARD_ST)
    timed("profile_hard_st", phase_profile, dev, "hard-st", lcfg, lp,
          window=10, start=LOOP_CHECK_STEP)
    hard_st = engine(lcfg.solver)
    loop_xla_st, _, _ = timed(
        "loop_xla_st", phase_loop, dev, card, "xla-st",
        f"al 1x1, alphas=() (unguarded RTI step), engine='xla', "
        f"model='st', 1 cold start, {XLA_ST_STEPS} steps",
        steps=XLA_ST_STEPS, **XLA_ST)

    def roads_st(method):   # the ST road checks of one kernel
        return ({k: v for k, v in checks_roads_st.items() if method in k},
                {k: n for k, n in launches_roads_st.items() if method in k})


    kernels = [
        kernel_line(soft, loop, timing, "warm_1x1", "cold_3x4", checks,
                    build, boundary_instance_line(
                        soft, loop_sc, timing_sc, "warm_3x4", "cold_3x4",
                        checks_sc, build, timing_sc["split"])),
        kernel_line(hard, loop_ip, timing_ip, "warm_1x4", "cold_5x10",
                    checks_ip, build, split=timing_ip["split"]),
        kernel_line(hard_corridor, loop_hc, timing_hc, "warm_2x6",
                    "cold_5x10", checks_hc, build),
        riccati_kernel_line(loop_xla, timing_ric, checks_ric, checks_vec,
                            build, (loop_xla_st, timing_ric_st, checks_ric_st,
                                    checks_vec_st)),
        kernel_line(soft_st, loop_st, timing_st, "warm_1x1", "cold_3x4",
                    checks_st, build, st_boundary_line(
                        soft_st, *roads_st("_al_"), build),
                    timing_st["split"]),
        kernel_line(hard_st, loop_ip_st, timing_ip_st, "warm_1x4",
                    "cold_5x10", checks_ip_st, build, st_boundary_line(
                        hard_st, *roads_st("_ip_"), build),
                    timing_ip_st["split"])]
    timed("planner_profile", planner_profile, dev)
    fleet = timed("fleet", phase_fleet, dev, card, lambda: fleet_checks)
    sharded = timed("sharded", phase_sharded, dev, card,
                    entry=lambda: entry)
    for line in kernels:
        line["fleet_launches"] = fleet_launches(fleet, line["name"])
        line["sharded_launches"] = sharded_launches(sharded, line["name"])
    print(card, flush=True)
    emit({"kernels": kernels, "seconds": time.perf_counter() - t_start,
          "phase_seconds": seconds})
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    teardown()
    emit({"ok": True, "device": device})
    return 0


def teardown():
    """Release what the run made before the interpreter's own exit: the
    device's queued work, any process group of this process (the ranks
    destroy theirs, and ``spawn_ranks`` joins them), the profilers' and
    the phases' last references, the cached device memory."""
    torch.cuda.synchronize()
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


if __name__ == "__main__":
    faulthandler.enable()   # a fatal signal prints its stack
    code = main()
    # main has torn down what it made and printed its last line.  The
    # interpreter's own exit would now run the static destructors of the
    # process's C++ libraries (PyTorch's and CUDA's; this repository's C++
    # starts no thread), one of which aborts now and then with "terminate
    # called without an active exception" after the last line (PERF.md
    # section 7): leave without them.  Its library is unnamed: fifteen runs
    # to the normal exit on an H100 under a handler that prints the native
    # stack at std::terminate and SIGABRT (twelve of this process's profile
    # phase on the hard-corridor window, three of the whole script) did
    # not abort.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
