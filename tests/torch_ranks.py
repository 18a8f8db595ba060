"""Multi-rank programs of the port's tests, spawned on the CPU with gloo.

Each program runs in every rank of a localhost process group and returns a
dict of plain results (tensors, numbers, strings), which its rank saves;
the test process reads them.  The ranks import torch and the port only;
``chip_smoke.spawn_ranks`` starts them, as it starts the sharded phase's.

    results = spawn(two_rank_checks, 2, tmp_path)   # [rank 0's, rank 1's]
"""
from __future__ import annotations

import dataclasses
import functools
import os
import tempfile
import time
import traceback
from typing import NamedTuple, Optional

import numpy as np
import torch


class Lanes(NamedTuple):
    """A tree to split: lanes, a 0-dim tensor and a None."""

    x: torch.Tensor
    scalar: Optional[torch.Tensor]
    none: Optional[torch.Tensor]


def _rank(rank, port, out_dir, world, program):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from mpc_tpu_torch.parallel import mesh as pm
    out = {}
    try:
        pm.init_distributed("gloo")
        t0 = time.perf_counter()
        out = program(out_dir)
        out["seconds"] = time.perf_counter() - t0
    except Exception:
        out = {"error": traceback.format_exc()}
        raise
    finally:
        torch.save(out, os.path.join(out_dir, f"rank_{rank}.pt"))
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def spawn(program, world: int, out_dir=None):
    """Run ``program(out_dir)`` in ``world`` gloo ranks; the list of their
    results, or ``chip_smoke.CheckFailed`` naming the rank that failed or
    hung."""
    import chip_smoke as cs
    out_dir = str(out_dir or tempfile.mkdtemp())
    return cs.spawn_ranks(functools.partial(_rank, world=world,
                                            program=program),
                          out_dir, nprocs=world)


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------


def random_lqr(H, B=2, seed=3, dtype=torch.float64):
    """Random well-conditioned stagewise QPs (tests/test_riccati.py's
    recipe, lanes leading)."""
    from mpc_tpu_torch.ops import riccati as R
    rng = np.random.default_rng(seed)
    nx, nu = 5, 2

    def spd(n, shape):
        a = rng.normal(size=shape + (n, n))
        return a @ np.swapaxes(a, -1, -2) + n * np.eye(n)

    Q, Rm = spd(nx, (B, H)), spd(nu, (B, H))
    M = 0.1 * rng.normal(size=(B, H, nx, nu))
    A = np.eye(nx) + 0.1 * rng.normal(size=(B, H, nx, nx))
    Bm = 0.1 * rng.normal(size=(B, H, nx, nu))
    t = (lambda a: torch.as_tensor(a, dtype=dtype))
    quad = R.StageQuad(t(Q), t(Rm), t(M), t(rng.normal(size=(B, H, nx))),
                       t(rng.normal(size=(B, H, nu))))
    dyn = R.LinDyn(t(A), t(Bm), t(0.1 * rng.normal(size=(B, H, nx))))
    return quad, t(spd(nx, (B,))), t(rng.normal(size=(B, nx))), dyn


def sweep_errors(mesh, H, dtype=torch.float64):
    """Largest |K|, |d|, |dV1|, |dV2| differences of the stage-sharded
    parallel-scan sweep from the sequential sweep."""
    from mpc_tpu_torch.ops import pscan
    from mpc_tpu_torch.ops import riccati as R
    quad, QH, qH, dyn = random_lqr(H, dtype=dtype)
    seq = R.backward_pass(quad, QH, qH, dyn, 1e-6)
    par = pscan.backward_pass_pscan(quad, QH, qH, dyn, 1e-6, mesh=mesh,
                                    axis="sp")
    return [float((a - b).abs().max()) for a, b in zip(seq, par)]


def bench(B, H, T, **kw):
    from mpc_tpu_torch.utils import synthetic
    lcfg, lp = synthetic.make_bench_loop(T, H, B, device="cpu",
                                         cold_start_solves=1, **kw)
    return lcfg, lp


def two_rank_checks(out_dir):
    """Everything the tests hold two ranks to; rank r's results."""
    from mpc_tpu_torch import entry
    from mpc_tpu_torch.ops import sqp
    from mpc_tpu_torch.parallel import batch as pb
    from mpc_tpu_torch.parallel import mesh as pm
    from mpc_tpu_torch.planner import closed_loop as cl
    from mpc_tpu_torch.utils import checkpoint as ck
    from mpc_tpu_torch import convert

    out = {"rank": torch.distributed.get_rank()}
    mesh = pm.make_mesh()
    out["mesh"] = (dict(mesh.shape), dict(mesh.coords),
                   mesh.ranks("dp"), mesh.ranks("sp"))
    out["mesh_errors"] = []
    for shape in ((4, 1), (1, 1), (3, 1)):
        try:
            pm.make_mesh(shape)
        except ValueError as e:
            out["mesh_errors"].append(str(e))
    x = torch.arange(8.0)[:, None] * 10 + torch.arange(3.0)
    shard = pm.shard_lanes(Lanes(x, torch.tensor(2.0), None), mesh)
    out["shard"] = shard.x
    out["round_trip"] = pm.gather_lanes(shard, mesh)
    try:
        pm.shard_lanes(Lanes(torch.zeros(3, 2), None, None), mesh)
    except ValueError as e:
        out["uneven"] = str(e)

    # the sharded solve against the unsharded one of the same inputs (the
    # test process writes them: OCP arrays of H=8, B=8)
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"),
                        weights_only=False)
    H, B = inputs["x_ref"].shape[1] - 1, inputs["x0"].shape[0]
    cfg = sqp.SolverConfig(horizon=H, sqp_iters=2, al_iters=2)
    ocp = convert.ocp_params(inputs)
    state = sqp.init_state(cfg, batch=B)
    sol = pb.solve_batch_sharded(cfg, ocp, state, mesh, device="cpu")
    whole = pm.gather_lanes(sol, mesh)
    from mpc_tpu_torch.planner.closed_loop import select_engine
    ref = select_engine(cfg)(cfg, ocp, state, device="cpu")
    out["solve_U"], out["solve_U_ref"] = whole.U, ref.U
    out["solve_status"] = (whole.status, ref.status)
    out["summary"] = tuple(float(v) for v in pb.summarize(sol, mesh))
    out["summary_host"] = (
        int((ref.status == 1).sum()), int((ref.status < 0).sum()),
        float(ref.viol.max()), float(ref.cost.sum() / ref.cost.numel()))

    # the noised loop, sharded and whole
    lcfg, lp = bench(4, 6, 4, al_iters=1, sqp_iters=1, alphas=())
    lcfg = dataclasses.replace(lcfg, noise_std=0.05)
    res, census_loop = pb.collective_census(
        pb.closed_loop_batch_sharded, lcfg, lp, mesh, device="cpu")
    whole = pm.gather_lanes(res, mesh)
    ref = cl.closed_loop_batch_vec(lcfg, lp, device="cpu")
    out["loop"] = (whole.X, whole.U, whole.status)
    out["loop_ref"] = (ref.X, ref.U, ref.status)
    out["census_loop"] = census_loop
    summ, census_summary = pb.collective_census(pb.summarize_loop, res,
                                                mesh)
    out["census_summary"] = census_summary
    out["loop_summary"] = tuple(float(v) for v in summ)
    out["loop_summary_host"] = (
        int((ref.status == 1).sum()), int((ref.status < 0).sum()),
        float(ref.viol.max()), float(ref.cost.sum() / ref.cost.numel()))

    # a per-rank checkpoint at step 2, resumed
    path = os.path.join(out_dir, "ckpt")
    carry = pb.init_carry_sharded(lcfg, lp, mesh, device="cpu")
    carry, first = pb.closed_loop_chunk_sharded(lcfg, lp, carry, 2, mesh,
                                                device="cpu")
    out["ckpt_file"] = os.path.relpath(
        ck.save_checkpoint(path, carry, 2, mesh=mesh), out_dir)
    torch.distributed.barrier()
    like = pb.init_carry_sharded(lcfg, lp, mesh, device="cpu")
    back = ck.restore_checkpoint(path, like, mesh=mesh)
    _, rest = pb.closed_loop_chunk_sharded(lcfg, lp, back, 2, mesh,
                                           device="cpu")
    out["resumed"] = tuple(torch.cat([a, b], 1) for a, b in
                           zip(first[:3], rest[:3]))
    out["uninterrupted"] = (res.X, res.U, res.status)
    try:
        ck.restore_checkpoint(path, like, mesh=pm.Mesh(1, 2))
    except ValueError as e:
        out["ckpt_shape_error"] = str(e)

    # the stage-sharded sweep on a (1, 2) mesh, and the dry run
    sp_mesh = pm.make_mesh((1, 2))
    out["sweep64_f64"] = sweep_errors(sp_mesh, 64)
    out["sweep64_f32"] = sweep_errors(sp_mesh, 64, torch.float32)
    out["sweep3"] = sweep_errors(sp_mesh, 3)
    out["dryrun"] = entry.dryrun_multichip(2, device="cpu")
    return out


def four_rank_checks(out_dir):
    """The mesh shapes of four ranks, an uneven stage split over sp=4 and
    the dry run on a (2, 2) mesh."""
    from mpc_tpu_torch import entry
    from mpc_tpu_torch.parallel import mesh as pm

    out = {"shapes": {}, "errors": []}
    for shape in ((4, 1), (2, 2), (1, 4), None):
        m = pm.make_mesh(shape)
        out["shapes"][str(shape)] = (dict(m.shape), dict(m.coords),
                                     m.ranks("dp"), m.ranks("sp"))
    for shape in ((3, 1), (2, 1), (4, 2)):
        try:
            pm.make_mesh(shape)
        except ValueError as e:
            out["errors"].append(str(e))
    m = pm.make_mesh((2, 2))
    v = pm.all_reduce(torch.tensor([float(torch.distributed.get_rank())]),
                      m, "dp")
    out["dp_sum"] = float(v)
    out["sp_gather"] = [float(t) for t in pm.all_gather(
        torch.tensor([float(torch.distributed.get_rank())]), m, "sp")]
    out["sweep12_sp4"] = sweep_errors(pm.make_mesh((1, 4)), 12)
    out["dryrun"] = entry.dryrun_multichip(4, device="cpu")
    return out


# ---------------------------------------------------------------------------
# hooks of chip_smoke's sharded phase, rehearsed on the CPU
# ---------------------------------------------------------------------------


def count_fused_calls(rank):
    """In a rank of ``chip_smoke._sharded_rank`` on the CPU: each fused
    wrapper's call counted as a launch of its kernel (on the CPU the
    wrappers run the plain version, which launches nothing) and the device
    clocks stubbed, as the test process's rehearsal fixtures do."""
    import chip_smoke as cs
    from mpc_tpu_torch.ops import fused_gn as F
    from mpc_tpu_torch.ops import fused_ip as FI
    for mod, fn in ((FI, "solve_batch_fused_ip"), (F, "solve_batch_fused")):
        def counting(cfg, params, state, device=None, _real=getattr(mod, fn)):
            cs._launchers()[cs.engine(cfg).name].launches += 1
            return _real(cfg, params, state, device=device)
        setattr(mod, fn, counting)
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.max_memory_allocated = lambda *a, **k: 0


def fail_on_rank_one(rank):
    """A rank that fails before it joins the process group."""
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")


def ranks_on_cpu(rank):
    """In every rank of ``chip_smoke.phase_sharded`` on the CPU: each
    fused wrapper's call counted as a launch (:func:`count_fused_calls`);
    a request for NCCL, which the entry point's default path makes on its
    rank's GPU, recorded and served by gloo, and the rank's default device
    the CPU; one torch thread, as in :func:`_rank`.  Returns the record
    (the entry piece's rank saves it)."""
    import torch.distributed as dist
    from mpc_tpu_torch.parallel import mesh as pm
    torch.set_num_threads(1)
    count_fused_calls(rank)
    seen = {"requested_backends": []}
    real_init, real_device = dist.init_process_group, pm.local_device

    def init(backend=None, **kw):
        seen["requested_backends"].append(backend)
        return real_init("gloo" if backend == "nccl" else backend, **kw)
    dist.init_process_group = init
    pm.local_device = lambda device=None: real_device(device or "cpu")
    return seen
