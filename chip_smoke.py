"""Run the PyTorch/CUDA port on one NVIDIA GPU: build its kernel, hold the
kernel against its plain PyTorch version, and drive the closed loop at the
bench point.

    python3 chip_smoke.py        # from the repository root, one CUDA GPU

Phases, each printing one JSON line (``"phase": ...``):

1. device   the card's name and power limit (``nvidia-smi``);
2. build    ``nvcc`` builds every kernel from ``mpc_tpu_torch/ops/csrc``
            into the git-ignored ``build/kernels``; registers and spills
            from ``-Xptxas -v``;
3. check    the fused AL-SQP kernel against ``solve_batch_fused_plain`` on
            the card at the bench shape (KS, RK4, forcespro, H=30,
            B=2048 lanes of ``make_bench_loop``): the cold-start budget
            (3x4, unguarded), the warm bench point (1x1, unguarded, from the
            cold-start state) and the default ladder (3x4); then one small
            case each for casadi/Euler and for moving obstacles, at a
            ragged batch (B=250, not a multiple of the block).  The bands
            of tests/test_fused_gn.py hold on every lane, the warm state
            and the status agree on >= 99.9% of lanes.  With the ladder on,
            the kernel records the rung each iteration committed and the
            plain version replays those choices: every choice must be the
            best rung, up to a relative merit regret of TIE_RTOL, under the
            plain version's merits (near-tied rungs go either way by
            rounding);
4. loop_vs_plain  a short closed loop on the card against the same loop
            on the CPU (plain version), the tests' closed-loop bands;
5. timing   the kernel per launch at the main path's shape (B=16384,
            H=30; warm 1x1 and cold 3x4; 32/64/128 threads a block), the
            plain version's time, and the bound: the larger of the bytes
            the solve must move over 3.35 TB/s and its fp32 operations
            (counted on the plain version) over 67 TFLOP/s; the timed
            launches' outputs are held against the plain version's, as in
            ``check``;
6. loop     ``closed_loop_batch_vec`` at B=16384, H=30, T=100, al 1x1,
            ``alphas=()``, 4 cold-start solves: launches counted in that
            run, then solves/s with CUDA events, best of 3 after it;
7. profile  one more such loop under ``torch.profiler``: device time of
            the kernel and of the eager glue around it, by kernel name;

then the card's name and power limit, the kernels line, and as the last
line ``{"ok": true, "device": {...}}``.  A phase that fails raises: the
script then exits non-zero and prints no last line.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

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
HBM_BYTES_PER_S = 3.35e12                    # H100 SXM, data sheet
FP32_OPS_PER_S = 67e12                       # H100 SXM, fp32 non-tensor
# (rtol, atol) of tests/test_fused_gn.py:42-55
BANDS = {"U": (2e-3, 2e-3), "X": (2e-3, 2e-2), "viol": (0.0, 1e-3),
         "cost": (1e-3, 1e-2)}
STATE_BANDS = {"mu": (1e-3, 1e-3), "lam_lo": (2e-2, 2e-2),
               "lam_hi": (2e-2, 2e-2)}
MIN_LANE_AGREEMENT = 0.999
# A ladder choice may lose to the best rung by rounding: at most this much
# of max(|best merit|, 1) under the plain version's merits.  The plain
# version's own float32 choices stay well inside it under its float64
# merits, and a ladder stuck at alpha = 0 is far outside it
# (tests/test_torch_chip_smoke.py).
TIE_RTOL = 1e-4


def emit(obj):
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


def phase_build():
    from mpc_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    seconds = time.perf_counter() - t0
    info = {}
    for name, text in logs.items():
        _build.load(name)
        regs = re.findall(r"Used (\d+) registers", text)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          text)
        stack = re.search(r"(\d+) bytes stack frame", text)
        info[name] = {
            "registers": int(regs[-1]) if regs else None,
            "spill_stores": int(spill.group(1)) if spill else None,
            "spill_loads": int(spill.group(2)) if spill else None,
            "stack_frame": int(stack.group(1)) if stack else None}
    emit({"phase": "build", "seconds": seconds, "kernels": info})
    return info


def bench_loop(**kw):
    """``make_bench_loop`` on the bench's track (T=100 steps long): a
    shorter track puts the obstacle within a horizon of the start, where
    the loop turns chaotic."""
    from mpc_tpu_torch.utils import synthetic
    return synthetic.make_bench_loop(T_BENCH, H, **kw)


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


def rung_regret(chosen, merits):
    """Per lane: how much the chosen rung's merit exceeds that of the rung
    the ladder's rule picks (the first of least merit; a NaN trial never
    wins, and a NaN at alpha = 0 keeps the iterate), relative to
    max(|that merit|, 1)."""
    m = merits.double()
    best = torch.where(m[0].isnan(), 0,
                       m.nan_to_num(nan=float("inf")).argmin(0))
    mc = m.gather(0, chosen.long()[None])[0]
    mb = m.gather(0, best[None])[0]
    reg = ((mc - mb) / mb.abs().clamp(min=1.0)).nan_to_num(nan=float("inf"))
    return torch.where((chosen.long() == best) | (mc == mb),
                       torch.zeros_like(reg), reg)


def compare(name, cfg, ocp, state, bufs=None, plain=None):
    """Kernel vs plain version on the card, on every lane.

    ``bufs``: the kernel's buffers after a launch on (cfg, ocp, state), or
    None to launch here; ``plain``: the plain version's outputs on the same
    inputs, or None to compute them (with the ladder on, the plain version
    always runs here, replaying the kernel's rungs).  Returns (kernel
    Solution, max abs errors)."""
    from mpc_tpu_torch.ops import fused_gn as F
    ladder = bool(cfg.alphas)
    if bufs is None:
        bufs = F.pack(cfg, ocp, state, trace_rungs=ladder)
        F.launch(cfg, bufs)
    ker = F.to_solution(cfg, F.unpack(bufs))
    extra = {}
    if ladder:
        chosen, trace, own = bufs["rung"], [], []
        plain = F.solve_batch_fused_plain(cfg, ocp, state, trace,
                                          follow=chosen)
        free = F.to_solution(cfg, F.solve_batch_fused_plain(cfg, ocp, state,
                                                            own))
        regret = torch.stack([rung_regret(c, m)
                              for c, (_, m) in zip(chosen, trace)])
        differs = chosen != torch.stack([r for r, _ in own])
        extra = {
            "max_rung_regret": float(regret.max()),
            "rung_choices": int(chosen.numel()),
            "rung_choices_unlike_free_plain": int(differs.sum()),
            "lanes_unlike_free_plain": int(differs.any(0).sum()),
            "status_agreement_free_plain":
                float((ker.status == free.status).double().mean())}
    elif plain is None:
        plain = F.solve_batch_fused_plain(cfg, ocp, state)
    pln = F.to_solution(cfg, plain)
    torch.cuda.synchronize()

    errs, agree, need = {}, {}, {}
    for f, (rtol, atol) in BANDS.items():
        a, b = getattr(ker, f), getattr(pln, f)
        errs[f] = max_abs(a, b)
        agree[f] = float(lanes_close(a, b, rtol, atol).double().mean())
        need[f] = 1.0
    for f, (rtol, atol) in STATE_BANDS.items():
        a, b = getattr(ker.state, f), getattr(pln.state, f)
        errs[f] = max_abs(a, b)
        agree[f] = float(lanes_close(a, b, rtol, atol).double().mean())
        need[f] = MIN_LANE_AGREEMENT
    agree["status"] = float((ker.status == pln.status).double().mean())
    need["status"] = MIN_LANE_AGREEMENT
    line = {"phase": "check", "case": name, "lanes": int(ocp.x0.shape[0]),
            "budget": f"{cfg.al_iters}x{cfg.sqp_iters}",
            "alphas": list(cfg.alphas), "formulation": cfg.formulation,
            "integrator": cfg.integrator,
            "moving": ocp.obs_centers.dim() == 4, "max_abs_err": errs,
            "lane_agreement": agree, "lane_agreement_needed": need, **extra,
            "kernel_feasible_lanes": int((ker.status >= 0).sum()),
            "finite": bool(torch.isfinite(ker.X).all())}
    emit(line)
    short = [f for f in agree if agree[f] < need[f]]
    require(not short, f"{name}: kernel and plain version agree on too few "
                       f"lanes in {short}")
    require(not ladder or extra["max_rung_regret"] <= TIE_RTOL,
            f"{name}: the kernel committed a rung worse than the best by "
            f"{extra.get('max_rung_regret')} of its merit")
    return ker, errs


def phase_check(dev):
    from mpc_tpu_torch.ops import sqp as S
    results = {}
    lcfg, lp = bench_loop(n_lanes=B_CHECK, device=dev, **COLD)
    ocp = ocp_at(lcfg, lp)
    cold_cfg = lcfg.solver
    st0 = S.init_state(cold_cfg, device=dev, batch=B_CHECK)
    cold, results["cold_3x4"] = compare("cold_3x4", cold_cfg, ocp, st0)
    warm_cfg = dataclasses.replace(cold_cfg, **WARM)
    _, results["warm_1x1"] = compare("warm_1x1", warm_cfg, ocp,
                                     cold.state)
    # the cold budget with the default line-search ladder
    ladder_cfg = dataclasses.replace(cold_cfg,
                                     alphas=S.SolverConfig(horizon=H).alphas)
    _, results["ladder_3x4"] = compare("ladder_3x4", ladder_cfg, ocp,
                                       st0)

    # step 1: casadi's step-0 window is the current state held in place
    lcfg, lp = bench_loop(n_lanes=B_SMALL, mode="casadi", device=dev,
                          al_iters=2, sqp_iters=2)
    ocp = ocp_at(lcfg, lp, step=1)
    st = S.init_state(lcfg.solver, device=dev, batch=B_SMALL)
    _, results["casadi_euler_2x2_ladder"] = compare(
        "casadi_euler_2x2_ladder", lcfg.solver, ocp, st)

    lcfg, lp = bench_loop(n_lanes=B_SMALL, device=dev, al_iters=2,
                          sqp_iters=2, alphas=())
    ocp = ocp_at(lcfg, lp)
    drift = torch.arange(H + 1, device=dev, dtype=torch.float32)[:, None,
                                                                   None]
    drift = drift * torch.tensor([0.3, 0.05], device=dev)
    ocp = ocp._replace(obs_centers=ocp.obs_centers[:, None] + drift)
    st = S.init_state(lcfg.solver, device=dev, batch=B_SMALL)
    _, results["moving_2x2"] = compare("moving_2x2", lcfg.solver, ocp,
                                       st)
    return results


def phase_loop_vs_plain(dev):
    """The first steps of the bench loop on the card vs the plain loop on
    the CPU (bands of tests/test_torch_closed_loop.py)."""
    from mpc_tpu_torch.planner import closed_loop as cl
    B, T = 64, 10
    lcfg, lp = bench_loop(n_lanes=B, device="cpu", **WARM)
    lcfg = dataclasses.replace(lcfg, n_steps=T)
    ref = cl.closed_loop_batch_vec(lcfg, lp, device="cpu")
    got = cl.closed_loop_batch_vec(lcfg, lp, device=dev)
    err_x = max_abs(got.X.cpu(), ref.X)
    err_u = max_abs(got.U.cpu(), ref.U)
    same_feas = bool(torch.equal(got.status.cpu() >= 0, ref.status >= 0))
    emit({"phase": "loop_vs_plain", "lanes": B, "steps": T,
          "max_abs_err": {"X": err_x, "U": err_u},
          "feasibility_equal": same_feas})
    require(err_x < 5e-2 and err_u < 5e-3 and same_feas,
            "closed loop on the card differs from the plain loop")


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
        elif name == "sum":
            self.n += args[0].numel() - out.numel()
        return out


def ops_per_lane(cfg):
    """fp32 operations of one lane's solve under ``cfg``, counted on the
    plain version at one lane on the CPU.  The plain version recomputes the
    rows that the kernel reads from its cache on the first sweep of each
    AL iteration, so the count is high by those rows."""
    from mpc_tpu_torch.ops import fused_gn as F
    from mpc_tpu_torch.ops import sqp as S
    lcfg, lp = bench_loop(n_lanes=1, device="cpu")
    ocp = ocp_at(lcfg, lp)
    with _OpCount() as c:
        F.solve_batch_fused_plain(cfg, ocp, S.init_state(cfg, batch=1))
    return c.n


def kernel_bytes(bufs):
    """Bytes the solve must move: each input read once, each output
    written once (the warm-start state is both)."""
    from mpc_tpu_torch.ops import fused_gn as F

    def nbytes(names):
        return sum(bufs[n].numel() * bufs[n].element_size() for n in names)
    return (nbytes(F.KERNEL_INPUTS) + 2 * nbytes(F.KERNEL_STATE)
            + nbytes(F.KERNEL_OUTPUTS))


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


def time_kernel_ms(cfg, ocp, state, reps, threads):
    """Median per-launch time over fresh copies of the same inputs (the
    kernel updates the warm state in place), after one warm-up launch;
    returns the last launch's buffers too."""
    from mpc_tpu_torch.ops import fused_gn as F
    times = []
    for i in range(reps + 1):
        bufs = F.pack(cfg, ocp, state)
        ms, _ = cuda_ms(lambda: F.launch(cfg, bufs, threads))
        if i:
            times.append(ms)
    times.sort()
    return times[len(times) // 2], bufs


def time_plain_ms(cfg, ocp, state, reps):
    """Best time of ``reps`` plain solves, and the plain outputs."""
    from mpc_tpu_torch.ops import fused_gn as F
    runs = [cuda_ms(lambda: F.solve_batch_fused_plain(cfg, ocp, state))
            for _ in range(reps)]
    return min(ms for ms, _ in runs), runs[-1][1]


def phase_timing(dev):
    from mpc_tpu_torch.ops import fused_gn as F
    from mpc_tpu_torch.ops import sqp as S
    lcfg, lp = bench_loop(n_lanes=B_BENCH, device=dev, **COLD)
    ocp = ocp_at(lcfg, lp)
    cold_cfg = lcfg.solver
    warm_cfg = dataclasses.replace(cold_cfg, **WARM)
    st0 = S.init_state(cold_cfg, device=dev, batch=B_BENCH)
    warm_state = F.solve_batch_fused(cold_cfg, ocp, st0, device=dev).state
    out = {}
    for name, cfg, state, reps in (("warm_1x1", warm_cfg, warm_state, 20),
                                   ("cold_3x4", cold_cfg, st0, 5)):
        ms, bufs = time_kernel_ms(cfg, ocp, state, reps, F.THREADS)
        by_threads = {t: time_kernel_ms(cfg, ocp, state, reps, t)[0]
                      for t in (32, 64, 128)}
        plain_ms, plain = time_plain_ms(cfg, ocp, state,
                                        3 if name == "warm_1x1" else 1)
        _, errs = compare(f"timed_{name}", cfg, ocp, state, bufs, plain)
        nbytes = kernel_bytes(bufs)
        ops = ops_per_lane(cfg) * B_BENCH
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        out[name] = {
            "ms": ms, "threads": F.THREADS,
            "ms_by_threads": {str(t): v for t, v in by_threads.items()},
            "plain_ms": plain_ms, "bytes": nbytes, "fp32_ops": ops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "max_abs_err": errs}
        emit({"phase": "timing", "case": name, "lanes": B_BENCH, "horizon": H,
              **out[name]})
    return out


def phase_loop(dev, card):
    from mpc_tpu_torch.ops import fused_gn as F
    from mpc_tpu_torch.planner import closed_loop as cl
    lcfg, lp = bench_loop(n_lanes=B_BENCH, device=dev, method="al", **WARM)

    def run():
        res = cl.closed_loop_batch_vec(lcfg, lp, device=dev)
        feasible = (res.status >= 0).sum()
        checksum = (res.X.sum() + res.U.sum() + res.viol.sum()
                    + res.cost.sum())
        return feasible, checksum, res

    F.launch.launches = 0                  # the main path's run
    feasible, checksum, res = run()
    torch.cuda.synchronize()
    launches = F.launch.launches
    total = B_BENCH * T_BENCH
    require(tuple(res.X.shape) == (B_BENCH, T_BENCH, 5), "loop X shape")
    require(bool(torch.isfinite(checksum)), "loop checksum is not finite")
    require(int(feasible) == total,
            f"feasible steps {int(feasible)} of {total}")
    want = lcfg.cold_start_solves + T_BENCH
    require(launches == want, f"kernel launches {launches}, want {want}")

    best = float("inf")
    for _ in range(3):
        ms, (feasible, checksum, _) = cuda_ms(run)
        require(int(feasible) == total, "feasible steps changed between runs")
        best = min(best, ms / 1e3)
    name, limit = [s.strip() for s in card.split(",", 1)]
    line = {"phase": "loop", "impl": "torch-cuda",
            "metric": "nmpc_solves_per_s_per_chip_h30",
            "value": total / best, "unit": "solves/s/chip",
            "step_latency_ms": best / T_BENCH * 1e3, "loop_s": best,
            "feasible_steps": int(feasible), "total_solves": total,
            "batch": B_BENCH, "horizon": H, "steps": T_BENCH,
            "budget": "al 1x1, alphas=() (unguarded RTI step)",
            "cold_start_solves": lcfg.cold_start_solves,
            "kernel_launches": launches, "checksum": float(checksum),
            "gpu": name, "power_limit": limit}
    emit(line)
    return line, lcfg, lp


def phase_profile(dev, lcfg, lp):
    """Device time of one bench loop by kernel, from torch.profiler (the
    profiler's own host overhead widens the gaps between kernels, so the
    idle share comes from the unprofiled loop time)."""
    from torch.profiler import ProfilerActivity, profile

    from mpc_tpu_torch.planner import closed_loop as cl
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cl.closed_loop_batch_vec(lcfg, lp, device=dev)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    by_name = {}
    for e in prof.events():
        if e.device_type == cuda:
            n, ms = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    require(by_name, "the profiler saw no device kernels")
    busy = sum(ms for _, ms in by_name.values())
    fused = [v for k, v in by_name.items() if k.startswith("fused_gn")]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    line = {"phase": "profile", "device_busy_ms": busy,
            "fused_gn_ms": sum(ms for _, ms in fused),
            "fused_gn_launches": sum(n for n, _ in fused),
            "kernel_launches": sum(n for n, _ in by_name.values()),
            "top": [{"kernel": k[:80], "launches": n, "ms": ms}
                    for k, (n, ms) in top]}
    emit(line)
    return line


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
    card = phase_device()
    build = phase_build()
    checks = phase_check(dev)
    phase_loop_vs_plain(dev)
    timing = phase_timing(dev)
    loop, lcfg, lp = phase_loop(dev, card)
    phase_profile(dev, lcfg, lp)

    warm = timing["warm_1x1"]
    errs = list(checks.values()) + [t["max_abs_err"] for t in timing.values()]
    kernel = {
        "name": "fused_gn", "route": "cuda",
        "source": "mpc_tpu_torch/ops/csrc/fused_gn.cu",
        "replaces": "mpc_tpu/ops/fused_gn.py:808 (_make_kernel)",
        "launches": loop["kernel_launches"],
        "max_abs_err": max(e["U"] for e in errs),
        "max_abs_err_U": max(e["U"] for e in errs),
        "max_abs_err_X": max(e["X"] for e in errs),
        "ms": warm["ms"], "plain_ms": warm["plain_ms"],
        "bound_ms": warm["bound_ms"], "bound_by": warm["bound_by"],
        "library_ms": None,
        "cold_3x4": timing["cold_3x4"],
        "registers": build["fused_gn"]["registers"],
        "spill_stores": build["fused_gn"]["spill_stores"],
        "ok": True}
    print(card, flush=True)
    emit({"kernels": [kernel], "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
