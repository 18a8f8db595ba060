"""The CUDA kernels' own arithmetic, compiled for the host and held
against their plain PyTorch versions on the CPU.

Each ``ops/csrc/<name>.cu`` is compiled with the host C++ compiler against
a small stand-in for ``cuda_runtime.h`` (the CUDA qualifiers defined away,
``blockIdx``/``threadIdx`` per thread) with its ``<<<...>>>`` launch line
replaced by ``host_launch``, which runs each block's threads as
``std::thread``s: ``__syncwarp``/``__syncthreads`` are C++20
``std::barrier``s, ``__shfl_*_sync`` an exchange array between two barrier
waits, and each block has its own buffer for ``extern __shared__``.  Its C
entry point is called through ctypes on the packed CPU buffers.  The card's build (``nvcc``) and timing
are ``chip_smoke.py``'s; this holds the source's arithmetic, the buffer
layout and the ctypes binding to the plain version wherever a host
compiler is present.  The stand-in, the build and the calls are
``tests/torch_host_kernels.py``; the fused sources' solves at their
budgets are ``tests/test_torch_kernel_host_{gn,ip,st,rings}.py``.
"""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
from mpc_tpu_torch.models.vehicle import VEHICLE_2
from mpc_tpu_torch.ops import _build
from mpc_tpu_torch.ops import fused_gn as TF
from mpc_tpu_torch.ops import fused_ip as TFI
from mpc_tpu_torch.ops import riccati_kernel as TRK
from mpc_tpu_torch.ops import riccati_vec as TRV
from mpc_tpu_torch.ops import sqp as TS
from mpc_tpu_torch.ops import sqp_vec as TSV
from torch_host_kernels import (B, H, ST, assert_close, bench_ocp,
                                build_host_libs, host_gn, host_ip, run_host)

@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    return build_host_libs(tmp_path_factory)


@pytest.mark.parametrize("horizon,threads_per_lane,boundary",
                         [(1, 2, False), (30, 4, False), (30, 8, False),
                          (40, 8, False), (TF.MAX_HORIZON, 8, False),
                          (14, 4, True), (30, 4, True),
                          (TF.MAX_HORIZON, 8, True)])
def test_fused_gn_shared_memory_footprint_matches_the_source(
        host_libs, horizon, threads_per_lane, boundary):
    """``lane_smem_bytes``, which the eligibility reads, is the source's
    own ``lane_floats`` of one lane's shared memory, and the geometry of
    the instance with or without the boundary rows takes that much: the
    boundary rows' models come from device memory, so both instances take
    the same."""
    fn = host_libs["fused_gn"].fused_gn_lane_floats
    fn.restype = ctypes.c_int
    want = TF.lane_smem_bytes(horizon, threads_per_lane)
    assert 4 * fn(horizon, threads_per_lane) == want
    cfg = TS.SolverConfig(horizon=horizon, boundary_rows=boundary)
    out = (ctypes.c_int32 * 6)()
    geo = host_libs["fused_gn"].fused_gn_geometry
    geo.restype = ctypes.c_int
    assert geo(ctypes.byref(TF.kernel_args(cfg, 64, False,
                                           threads_per_lane)), out) == 0
    assert (out[0], out[2], out[3]) == (threads_per_lane, want, 32 * want)


@pytest.mark.parametrize("horizon,boundary", [
    (1, False), (8, False), (30, False), (31, False), (63, False),
    (8, True), (14, True), (30, True), (63, True)])
def test_fused_ip_shared_memory_footprint_matches_the_source(host_libs,
                                                            horizon,
                                                            boundary):
    """``lane_smem_bytes``, which the eligibility reads, is the source's
    own footprint of one lane's shared memory, and the geometry of that
    instance takes it: without the boundary rows fused_ip.cu's ``Layout``
    (at most 12 lanes a block), with them the KS ring library's
    ``ring_lane_floats`` (a block of 32 lanes; each thread's slacks and
    duals of a stage, 4 x 20 floats, set its ring part)."""
    cfg = TS.SolverConfig(horizon=horizon, method="ip",
                          boundary_rows=boundary)
    lib = host_libs[TFI.ip_library(cfg)]
    fn = lib.fused_ip_lane_floats
    fn.restype = ctypes.c_int
    want = TFI.lane_smem_bytes(horizon, boundary)
    assert 4 * fn(horizon, int(boundary)) == want
    out = (ctypes.c_int32 * 6)()
    geo = lib.fused_ip_geometry
    geo.restype = ctypes.c_int
    assert geo(ctypes.byref(TFI.kernel_args_ip(cfg, 64, False)), out) == 0
    assert out[1] == want
    if boundary:
        lanes = TFI.RING_LANES
        assert (out[0], out[2], out[5]) == (lanes, lanes * want, lanes)
        assert TFI.ring_part_floats(True) == 4 * 4 * 20 > 6 * 43
    else:
        assert out[5] == min(12, TFI.SMEM_PER_BLOCK // want)


@pytest.mark.parametrize("case", ["ring-bound", "fused_ip-refuses-rows"])
def test_ks_boundary_rows_envelope_is_the_ring_sources(host_libs, case,
                                                       monkeypatch):
    """KS with the boundary rows runs on the ring library up to its own
    bound (a block of 32 lanes within a block's shared memory:
    MAX_HORIZON_KS_RING in, one stage more out, past fused_ip.cu's H <= 63)
    and past it goes to the per-lane path ``sqp.solve_batch``;
    fused_ip.cu refuses the boundary rows, and the ring library a KS
    problem without them."""
    if case == "fused_ip-refuses-rows":
        for boundary, name in ((1, "fused_ip"), (0, "fused_ip_ks_ring")):
            cfg = TS.SolverConfig(horizon=14, method="ip",
                                  boundary_rows=bool(boundary))
            args = TFI.kernel_args_ip(cfg, 64, False)
            args.boundary = boundary
            lib = host_libs[name]
            out = (ctypes.c_int32 * 6)()
            lib.fused_ip_geometry.restype = ctypes.c_int
            assert lib.fused_ip_geometry(ctypes.byref(args), out) != 0
            solve = lib.fused_ip_solve
            solve.restype = ctypes.c_int
            nptr = len(_build.SIGNATURES[name][1])
            assert solve(ctypes.byref(args),
                         *[ctypes.c_void_p(0)] * nptr) != 0
        lanes = host_libs["fused_ip"].fused_ip_lane_floats
        lanes.restype = ctypes.c_int
        assert lanes(14, 1) == -1
        return
    fn = host_libs["fused_ip_ks_ring"].fused_ip_lane_floats
    fn.restype = ctypes.c_int
    most = TFI.MAX_HORIZON_KS_RING
    block = 4 * TFI.RING_LANES
    assert block * fn(most, 1) <= TFI.SMEM_PER_BLOCK < block * fn(most + 1, 1)
    assert most > TFI.MAX_HORIZON == 63
    per_lane = []
    monkeypatch.setattr(TS, "solve_batch",
                        lambda *a, **k: per_lane.append(a) or "per-lane")
    # the envelope reads the problem's schema, not its stage count
    cfg, ocp = bench_ocp(method="ip", boundary_rows=True)
    ocp = cs.with_road_boundaries(ocp)
    for Hs, fits in ((most, True), (most + 1, False)):
        cfg = dataclasses.replace(cfg, horizon=Hs)
        reason = TFI.ineligible_reason_ip(cfg, ocp)
        assert (reason is None) == fits, reason
        if not fits:
            assert f"H <= {most}" in reason and "KS model" in reason
            assert TFI.solve_batch_fused_ip(
                cfg, ocp, TS.init_state(cfg, batch=B),
                device="cpu") == "per-lane"
    assert len(per_lane) == 1


def host_riccati(libs, quad, QH, qH, dyn, reg):
    bufs = TRK.pack(quad, QH, qH, dyn)
    Hs, _, Bs = bufs["Q"].shape
    run_host(libs, "riccati", TRK.RicArgs(B=Bs, H=Hs, threads=2, reg=reg,
                                          nx=quad.Q.shape[-1]),
             bufs, TRK.KERNEL_INPUTS + TRK.KERNEL_OUTPUTS)
    return TRK.unpack(bufs)


def bench_gn_problem(boundary_rows=False):
    """The quadratics the xla engine builds at the bench point's step 0
    (cold start), with a nonzero defect r."""
    cfg, ocp = bench_ocp(al_iters=1, sqp_iters=1, alphas=(),
                         boundary_rows=boundary_rows)
    if boundary_rows:
        ocp = cs.with_road_boundaries(ocp)
    quad, QH, qH, dyn = cs.gn_problem(cfg, ocp, TS.init_state(cfg, batch=B))
    r = 0.01 * torch.sin(torch.arange(dyn.r.numel(), dtype=torch.float32))
    return quad, QH, qH, dyn._replace(r=r.reshape(dyn.r.shape))


@pytest.mark.parametrize("case", ["random", "bench-step0",
                                  "bench-step0-boundaries", "singular-lane"])
def test_riccati_source_matches_the_plain_version(host_libs, case):
    """The sweep's source against ``backward_pass_vec_plain`` in the bands
    of tests/test_sqp_vec.py:26-31, with non-finite gains on the same
    entries (a lane whose Quu is singular at reg = 0)."""
    reg = 1e-6
    if case == "random":
        quad, QH, qH, dyn = cs.random_lqr(np.random.default_rng(0), B, H)
    else:
        quad, QH, qH, dyn = bench_gn_problem(case.endswith("boundaries"))
    if case == "singular-lane":
        reg = 0.0
        quad = quad._replace(R=quad.R.clone())
        quad.R[1] = 0.0
        dyn = dyn._replace(B=dyn.B.clone())
        dyn.B[1] = 0.0
    ker = host_riccati(host_libs, quad, QH, qH, dyn, reg)
    pln = TRV.backward_pass_vec_plain(quad, QH, qH, dyn, reg)
    ok = cs.riccati_lanes_close(ker, pln)
    assert bool(ok.all()), ok
    if case == "singular-lane":
        assert not bool(torch.isfinite(ker.K[1]).any())
        assert bool(torch.isfinite(ker.K[0]).all())


def test_xla_engine_with_the_riccati_source_matches_the_plain_sweep(
        host_libs):
    """The bench point's warm solve on the xla engine (al 1x1, unguarded)
    with the sweep's source in place of the plain sweep."""
    cfg, ocp = bench_ocp(al_iters=1, sqp_iters=1, alphas=(), engine="xla")
    st = TS.init_state(cfg, batch=B)

    def host_sweep(quad, QH, qH, dyn, reg):
        return host_riccati(host_libs, quad, QH, qH, dyn, reg)
    ker = TSV.solve_batch_vec(cfg, ocp, st, device="cpu", sweep=host_sweep)
    pln = TSV.solve_batch_vec(cfg, ocp, st, device="cpu")
    assert_close(ker, pln, cs.BANDS, cs.STATE_BANDS)


# --------------------------------------------------------------------------
# the ST model's libraries (fused_gn_st.cu, fused_ip_st.cu) and the sweep's
# nx=7 instance
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kernel,horizon,knob,boundary", [
    ("fused_gn", 1, 4, False), ("fused_gn", 30, 4, False),
    ("fused_gn", 30, 8, True), ("fused_gn", TF.MAX_HORIZON_ST, 8, False),
    ("fused_ip", 1, 0, False), ("fused_ip", 30, 0, False),
    ("fused_ip", 30, 0, True), ("fused_ip", TFI.MAX_HORIZON_ST, 0, True)])
def test_st_shared_memory_footprints_match_the_sources(host_libs, kernel,
                                                       horizon, knob,
                                                       boundary):
    """``lane_smem_bytes`` at nx=7, which the eligibility reads, is the ST
    library's own footprint of one lane (fused_gn: ``lane_floats`` at
    ``knob`` threads a lane; fused_ip: the ring source's
    ``ring_lane_floats``, the same with or without the boundary rows), and
    the geometry of that instance takes it: the ring source's block holds
    32 lanes."""
    lib = host_libs[f"{kernel}_st"]
    cfg = TS.SolverConfig(horizon=horizon, boundary_rows=boundary,
                          method="ip" if kernel == "fused_ip" else "al",
                          **dict(ST, vehicle=VEHICLE_2))
    out = (ctypes.c_int32 * 6)()
    if kernel == "fused_gn":
        want = TF.lane_smem_bytes(horizon, knob, 7)
        lib.fused_gn_lane_floats.restype = ctypes.c_int
        assert 4 * lib.fused_gn_lane_floats(horizon, knob) == want
        lib.fused_gn_geometry.restype = ctypes.c_int
        assert lib.fused_gn_geometry(ctypes.byref(
            TF.kernel_args(cfg, 64, False, knob)), out) == 0
        assert (out[0], out[2], out[3]) == (knob, want, 32 * want)
    else:
        want = TFI.lane_smem_bytes(horizon, boundary, 7)
        lib.fused_ip_lane_floats.restype = ctypes.c_int
        assert 4 * lib.fused_ip_lane_floats(horizon, int(boundary)) == want
        lib.fused_ip_geometry.restype = ctypes.c_int
        assert lib.fused_ip_geometry(ctypes.byref(
            TFI.kernel_args_ip(cfg, 64, False)), out) == 0
        lanes = TFI.RING_LANES
        assert (out[0], out[1], out[2], out[5]) == (lanes, want, lanes * want,
                                                    lanes)


@pytest.mark.parametrize("rungs", ["17-rungs", "horizon"])
def test_st_ip_envelope_is_the_ring_sources(host_libs, rungs):
    """The ST branch of ``ineligible_reason_ip`` states the ring source's
    own limits, each named in its reason: at most MAX_ALPHAS rungs, and a
    block of 32 lanes of the source's own footprint within a block's shared
    memory (MAX_HORIZON_ST in, one stage more out)."""
    cfg, ocp = bench_ocp(method="ip", **ST)
    if rungs == "17-rungs":
        ok = dataclasses.replace(cfg, ip_alphas=(0.5,) * TF.MAX_ALPHAS)
        out = dataclasses.replace(cfg, ip_alphas=(0.5,) * (TF.MAX_ALPHAS + 1))
        assert TFI.ineligible_reason_ip(ok, ocp) is None
        assert "17 ladder rungs" in TFI.ineligible_reason_ip(out, ocp)
        return
    fn = host_libs["fused_ip_st"].fused_ip_lane_floats
    fn.restype = ctypes.c_int
    most = TFI.MAX_HORIZON_ST
    block = 4 * TFI.RING_LANES
    assert block * fn(most, 1) <= TFI.SMEM_PER_BLOCK < block * fn(most + 1, 1)
    for boundary in (False, True):
        kw = dict(boundary_rows=boundary)
        ocp_b = cs.with_road_boundaries(ocp) if boundary else ocp
        assert TFI.ineligible_reason_ip(dataclasses.replace(
            cfg, horizon=most, **kw), ocp_b) is None
        reason = TFI.ineligible_reason_ip(dataclasses.replace(
            cfg, horizon=most + 1, **kw), ocp_b)
        assert f"H <= {most}" in reason and "shared memory" in reason
    # the KS kernel keeps its own bound
    assert TFI.MAX_HORIZON == 63 < most


# a ladder of 6 alphas, 7 rungs with alpha = 0, over fewer warps than
# rungs: alpha NaN (rung 2), whose merit is NaN (1e30 in the IP ladder),
# and two equal alphas (rungs 3 and 4), whose merits tie to the bit
ODD_LADDER = (1.0, float("nan"), 0.35, 0.35, 0.12, 0.04)
LADDER_CASES = {"al-2-threads": ("al", 2), "al-4-threads": ("al", 4),
                "ip-st-ring": ("ip", 4)}


@pytest.mark.parametrize("case", list(LADDER_CASES))
def test_parallel_ladder_keeps_the_sequential_rule(host_libs, case):
    """The ladder's rungs rolled out across the warps (AL: 2 and 4 threads
    a lane, 4 and 2 rounds; IP: the ST ring source) choose the rung that
    the sequential rule gives on the plain version's merits (alpha = 0
    first, a rung taken on a strict "<"): never the NaN rung, never the
    second of two tied rungs, up to TIE_RTOL where rungs nearly tie; and
    the solve replayed on those rungs holds its bands."""
    method, threads = LADDER_CASES[case]
    trace = []
    if method == "al":
        cfg, ocp = bench_ocp(al_iters=2, sqp_iters=2, alphas=ODD_LADDER)
        st = TS.init_state(cfg, batch=B)
        bufs, ker = host_gn(host_libs, cfg, ocp, st, threads)
        pln = TF.to_solution(cfg, TF.solve_batch_fused_plain(
            cfg, ocp, st, trace, follow=bufs["rung"]))
        assert_close(ker, pln, cs.BANDS, cs.STATE_BANDS)
    else:
        cfg, ocp = bench_ocp(method="ip", ip_sqp_iters=2, ip_iters=4,
                             ip_warm_duals=True, ip_alphas=ODD_LADDER, **ST)
        st = TS.init_state(cfg, batch=B)
        bufs, ker = host_ip(host_libs, cfg, ocp, st)
        pln = TFI.to_solution_ip(cfg, TFI.solve_batch_fused_ip_plain(
            cfg, ocp, st, trace, follow=bufs["rung"]), st.mu)
        assert_close(ker, pln, cs.IP_BANDS, cs.IP_STATE_BANDS)
    chosen = bufs["rung"]
    merits = torch.stack([m for _, m in trace])      # (iterations, 7, B)
    nan_rung = merits[:, 2]
    assert bool((nan_rung.isnan() if method == "al"
                 else nan_rung == 1e30).all())
    assert torch.equal(merits[:, 3], merits[:, 4])
    assert not bool(((chosen == 2) | (chosen == 4)).any())
    assert bool((chosen > 0).any())
    regret = torch.stack([cs.rung_regret(c, m)
                          for c, m in zip(chosen, merits)])
    assert float(regret.max()) <= cs.TIE_RTOL


@pytest.mark.parametrize("case", ["random", "st-bench-step0"])
def test_riccati_source_at_seven_states(host_libs, case):
    """The sweep's nx=7 instance against the plain sweep: random 7-state
    problems, and the ST xla engine's step-0 quadratics with a defect."""
    if case == "random":
        quad, QH, qH, dyn = cs.random_lqr(np.random.default_rng(1), B, H,
                                          nx=7)
    else:
        cfg, ocp = bench_ocp(al_iters=1, sqp_iters=1, alphas=(),
                             engine="xla", **ST)
        quad, QH, qH, dyn = cs.gn_problem(cfg, ocp,
                                          TS.init_state(cfg, batch=B))
        r = 0.01 * torch.sin(torch.arange(dyn.r.numel(),
                                          dtype=torch.float32))
        dyn = dyn._replace(r=r.reshape(dyn.r.shape))
    ker = host_riccati(host_libs, quad, QH, qH, dyn, 1e-6)
    pln = TRV.backward_pass_vec_plain(quad, QH, qH, dyn, 1e-6)
    assert ker.K.shape == (B, H, 2, 7)
    assert bool(cs.riccati_lanes_close(ker, pln).all())
