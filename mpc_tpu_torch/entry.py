"""The entry points of ``__graft_entry__.py``: a batched solve on the
flagship configuration and a dry run of the multi-rank path.

``entry()``             (fn, example_args): the per-lane AL solve of the
                        flagship OCP (H=30, 32 ZAM-like overtaking lanes);
                        it launches no kernel, as in the JAX package.
``dryrun_multichip(n)`` the production multi-rank path on an n-rank
                        ('dp', 'sp') mesh, one step each on small shapes,
                        run by the n ranks that the caller started.
``run()``               what ``main`` runs: join the ranks, ``entry()`` on
                        rank 0, the dry run over the world.

    torchrun --nproc-per-node N -m mpc_tpu_torch.entry [--backend gloo]
    python -m mpc_tpu_torch.entry --device cpu     # one process, the CPU

runs both (``entry`` on rank 0).
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from mpc_tpu_torch.device import resolve_device


def _flagship_ocp(horizon: int, n_lanes: int, dtype=torch.float32,
                  device=None):
    """ZAM-like overtaking instances, perturbed per lane: (OcpParams,
    SqpState), lanes leading."""
    from mpc_tpu_torch.models.costs import Weights
    from mpc_tpu_torch.ops import sqp
    from mpc_tpu_torch.parallel import batch as pb
    from mpc_tpu_torch.utils.synthetic import ZAM_LIKE_WEIGHTS

    dev = resolve_device(device)
    w = Weights.from_dict(ZAM_LIKE_WEIGHTS, dtype, dev)
    H = horizon
    v, dt = 15.0, 0.1
    ts = np.arange(H + 1) * dt
    xs = 30.0 + v * ts
    # overtake line: swings left early and passes clear of the obstacle at
    # (59.9, 0.08) by >= 3.3 m
    ys = np.interp(xs, [30.0, 45.0, 57.0, 75.0], [-1.15, 1.2, 3.6, 3.3])
    psi = np.gradient(ys, xs)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=dev)

    params = sqp.OcpParams(
        x0=t([30.0, -1.15, 0.0, v, 0.03]),
        x_ref=t(np.stack([xs, ys, 0 * ts, np.full_like(ts, v), psi], 1)),
        obs_centers=t([[59.9, 0.08], [61.9, 0.24], [57.9, -0.07]]),
        min_dist=t(3.3), weights=w)
    batch = pb.replicate_ocp(params, n_lanes)
    batch = pb.perturb_x0(batch, torch.Generator().manual_seed(0),
                          t([0.5, 0.2, 0.0, 0.5, 0.02]))
    states = sqp.init_state(sqp.SolverConfig(horizon=H), dtype=dtype,
                            device=dev, batch=n_lanes)
    return batch, states


def entry(horizon: int = 30, n_lanes: int = 32, device=None):
    """(fn, example_args): the batched per-lane solve, one GPU (or
    ``device``); fn returns (U, status)."""
    from mpc_tpu_torch.ops import sqp

    dev = resolve_device(device)
    cfg = sqp.SolverConfig(horizon=horizon)
    params, states = _flagship_ocp(horizon, n_lanes, device=dev)

    def fn(params, states):
        sol = sqp.solve_batch(cfg, params, states, device=dev)
        return sol.U, sol.status

    return fn, (params, states)


def dryrun_multichip(n_devices: int, device=None) -> str:
    """The production multi-rank path on an n-rank ('dp', 'sp') mesh (sp =
    2 when n is even), run by each of the n ranks; returns (and prints on
    rank 0) its line:

    * a multi-step closed loop through ``parallel.batch.closed_loop_
      batch_sharded``, lanes over 'dp', with the parallel-scan sweep's
      stages over 'sp';
    * the cross-lane reductions ``summarize_loop`` and ``summarize``;
    * the engine-sharded loop (the fused kernels on the card) against the
      unsharded ``closed_loop_batch_vec`` of the same lanes;
    * an open-loop ``solve_batch_sharded`` IP step at a convergence-grade
      budget, on which every lane converges: with the loop's stage axis
      (sp = 2) on the per-lane path, without one on the engine (the fused
      IP kernel on the card), as the JAX package dispatches it.
    """
    from mpc_tpu_torch.parallel import batch as pb
    from mpc_tpu_torch.parallel import mesh as pm
    from mpc_tpu_torch.planner import closed_loop as cl
    from mpc_tpu_torch.utils import synthetic

    dev = resolve_device(device)
    sp = 2 if n_devices % 2 == 0 else 1
    dp = n_devices // sp
    mesh = pm.make_mesh((dp, sp))

    # H+1 = 16 stages split evenly over sp=2; lanes (2 a dp shard) over dp
    H = 15
    n_lanes = 2 * dp
    # 6 steps: the tail steps run warm-started at steady state, where the
    # status gate must report converged solves
    lcfg, params = synthetic.make_bench_loop(
        n_steps=6, horizon=H, n_lanes=n_lanes, device=dev,
        lqr_backend="pscan", stage_axis=("sp" if sp > 1 else None),
        sqp_iters=2, al_iters=2)
    lcfg = dataclasses.replace(lcfg, cold_start_solves=1)

    res = pb.closed_loop_batch_sharded(lcfg, params, mesh, device=dev)
    assert res.X.shape == (n_lanes // dp, lcfg.n_steps, 5), res.X.shape
    summary = pb.summarize_loop(res, mesh)
    n_bad = int(summary.n_infeasible)
    assert n_bad == 0, f"{n_bad} infeasible (lane, step) solves"
    assert float(summary.max_viol) < lcfg.solver.tol_infeas
    assert int(summary.n_converged) > 0, "0 converged solves"

    # the engine-sharded path against the unsharded loop of the same
    # lanes: per-shard batch sizes may pick another instance of the fused
    # kernel, whose rounding the warm-started loop amplifies over 6 steps
    lcfg_flat = dataclasses.replace(
        lcfg, solver=dataclasses.replace(lcfg.solver, lqr_backend="scan",
                                         stage_axis=None))
    shard = pb.closed_loop_batch_sharded(lcfg_flat, params, mesh,
                                         device=dev)
    res_sh = pm.gather_lanes(shard, mesh)
    res_ref = cl.closed_loop_batch_vec(lcfg_flat, params, device=dev)
    dX = float((res_sh.X - res_ref.X).abs().max())
    assert dX < 5e-2, f"sharded != unsharded closed loop (max dX {dX})"
    assert bool((res_sh.status >= 0).all()) and bool(
        (res_ref.status >= 0).all())
    assert int(pb.summarize_loop(shard, mesh).n_infeasible) == 0

    # the open-loop sharded IP solve at a convergence-grade budget: every
    # lane converges (the reference asserts exitflag == 1 on every solve)
    ocp, states = _flagship_ocp(H, n_lanes, device=dev)
    scfg8 = dataclasses.replace(lcfg.solver, formulation="forcespro",
                                method="ip", ip_sqp_iters=8, ip_iters=12)
    sol = pb.solve_batch_sharded(scfg8, ocp, states, mesh, device=dev)
    ssum = pb.summarize(sol, mesh)
    assert int(ssum.n_infeasible) == 0
    if int(ssum.n_converged) != n_lanes:
        status = torch.cat(pm.all_gather(sol.status, mesh, "dp")).tolist()
        raise AssertionError(f"{int(ssum.n_converged)}/{n_lanes} converged "
                             f"open-loop solves; status by lane {status}")

    line = (f"dryrun_multichip({n_devices}): ok — closed loop "
            f"{n_lanes} lanes x {lcfg.n_steps} steps on mesh "
            f"{dict(mesh.shape)}, stage axis "
            f"{'sp (pscan sharded)' if sp > 1 else 'unsharded'}, "
            f"{int(summary.n_converged)} converged solves, "
            f"max viol {float(summary.max_viol):.2e}; open-loop batch "
            f"{int(ssum.n_converged)}/{n_lanes} converged")
    if mesh.index("dp") == 0 and mesh.index("sp") == 0:
        print(line, flush=True)
    return line


def join(backend=None, device=None) -> torch.device:
    """Join the program's ranks (``backend`` defaults to nccl, or gloo with
    ``device='cpu'``; at world size 1 a group of one only under a
    launcher) and take this rank's device; returns it."""
    from mpc_tpu_torch.parallel import mesh as pm

    cpu = device is not None and torch.device(device).type == "cpu"
    pm.init_distributed(backend or ("gloo" if cpu else "nccl"))
    dev = pm.local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def run(backend=None, device=None):
    """``main``'s path: :func:`join`, :func:`entry` on rank 0, then
    :func:`dryrun_multichip` over the world.  Returns (entry's (U, status)
    on rank 0, else None; the dry run's line, or the AssertionError it
    raised); the process group stays joined."""
    dev = join(backend, device)
    grouped = torch.distributed.is_initialized()
    out = None
    if not grouped or torch.distributed.get_rank() == 0:
        fn, fargs = entry(device=dev)
        out = fn(*fargs)
    world = torch.distributed.get_world_size() if grouped else 1
    try:
        dry = dryrun_multichip(world, device=dev)
    except AssertionError as e:
        dry = e
    return out, dry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="process group backend (default: nccl on GPUs, "
                         "gloo with --device cpu)")
    ap.add_argument("--device", default=None,
                    help="'cpu', or a CUDA device (default: the rank's)")
    args = ap.parse_args(argv)
    out, dry = run(args.backend, args.device)
    if out is not None:
        print("entry: ran, U shape", tuple(out[0].shape), flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    if isinstance(dry, AssertionError):
        raise dry
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
