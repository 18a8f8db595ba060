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
compiler is present.
"""
import ctypes
import dataclasses
import re
import shutil
import subprocess

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
from mpc_tpu_torch.utils import synthetic as tsyn

SHIM = """#pragma once
#define HOST_KERNEL_SHIM
#include <barrier>
#include <cmath>
#include <condition_variable>
#include <mutex>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <math.h>
#include <memory>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__
#define __grid_constant__
#define __launch_bounds__(...)
typedef void* cudaStream_t;
struct HostDim { unsigned x; };
// A block's threads run as std::threads; a warp's threads meet at a
// std::barrier, which also carries __shfl_*_sync's exchange.
struct HostWarp {
  explicit HostWarp(int n) : bar(n) {}
  std::barrier<> bar;
  uint32_t x[32];
};
// bar.arrive / bar.sync with an id and a thread count: a generation
// counter per id and block.
struct HostNamed {
  std::mutex m;
  std::condition_variable cv;
  int count = 0;
  unsigned gen = 0;
};
static thread_local HostDim blockIdx, threadIdx, blockDim;
static thread_local HostNamed* host_named;
inline void host_named_barrier(int id, int n, bool wait) {
  HostNamed& b = host_named[id];
  std::unique_lock<std::mutex> lk(b.m);
  const unsigned g = b.gen;
  if (++b.count == n) {
    b.count = 0;
    ++b.gen;
    b.cv.notify_all();
  } else if (wait) {
    b.cv.wait(lk, [&] { return b.gen != g; });
  }
}
static thread_local HostWarp* host_warp;
static thread_local std::barrier<>* host_block;
static thread_local void* host_smem;
inline void __syncwarp(unsigned = 0xffffffffu) { host_warp->bar.arrive_and_wait(); }
inline void __syncthreads() { host_block->arrive_and_wait(); }
inline void __threadfence_block() {}
template <class T> T host_shfl(T v, int src) {
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  std::memcpy(&host_warp->x[threadIdx.x % 32], &v, 4);
  host_warp->bar.arrive_and_wait();
  T r;
  std::memcpy(&r, &host_warp->x[src], 4);
  host_warp->bar.arrive_and_wait();
  return r;
}
template <class T> T __shfl_sync(unsigned, T v, int src) { return host_shfl(v, src); }
template <class T> T __shfl_xor_sync(unsigned, T v, int m) {
  return host_shfl(v, (int)(threadIdx.x % 32) ^ m);
}
template <class F>
void host_launch(unsigned blocks, unsigned threads, size_t smem, F body) {
  for (unsigned bi = 0; bi < blocks; ++bi) {
    std::vector<double> buf(smem / sizeof(double) + 1);
    std::vector<std::unique_ptr<HostWarp>> warps;
    for (unsigned w = 0; w * 32 < threads; ++w)
      warps.emplace_back(new HostWarp(threads - w * 32 < 32 ? threads - w * 32 : 32));
    std::barrier<> block((std::ptrdiff_t)threads);
    std::unique_ptr<HostNamed[]> named(new HostNamed[16]);
    std::vector<std::thread> ts;
    for (unsigned ti = 0; ti < threads; ++ti)
      ts.emplace_back([&, ti] {
        blockIdx.x = bi; threadIdx.x = ti; blockDim.x = threads;
        host_warp = warps[ti / 32].get(); host_block = &block;
        host_smem = buf.data(); host_named = named.get();
        body();
        host_warp->bar.arrive_and_drop();
        block.arrive_and_drop();
      });
    for (auto& t : ts) t.join();
  }
}
enum { cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize,
       cudaFuncAttributePreferredSharedMemoryCarveout,
       cudaDevAttrMaxSharedMemoryPerBlockOptin,
       cudaDevAttrMaxSharedMemoryPerMultiprocessor,
       cudaDevAttrMultiProcessorCount };
struct cudaFuncAttributes { int numRegs; };
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int attr, int) {
  *v = attr == cudaDevAttrMultiProcessorCount ? 132 : 232448;
  return 0;
}
template <class K> int cudaFuncSetAttribute(K, int, int) { return 0; }
template <class K> int cudaFuncGetAttributes(cudaFuncAttributes* f, K) {
  f->numRegs = 0; return 0;
}
template <class K>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1; return 0;
}
"""
# every kernel launch line, run on the host by host_launch
LAUNCH = re.compile(r"([\w<>]+)<<<(\w+), (\w+), (\w+), \(cudaStream_t\)stream"
                    r">>>\(([^;]*)\);")
LOOP = r"host_launch(\2, \3, \4, [&] { \1(\5); });"
# dynamic shared memory: the block's host buffer
SMEM = re.compile(r"extern __shared__ (\w+) (\w+)\[\];")
SMEM_HOST = r"\1* \2 = (\1*)host_smem;"
H, B = 8, 5


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to build the kernels with")
    out = tmp_path_factory.mktemp("host_kernels")
    (out / "cuda_runtime.h").write_text(SHIM)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    # every source with its launch line run by host_launch, so that a
    # source that includes another (fused_gn_st.cu) includes the host copy
    launches = {}
    for src in _build.CSRC.glob("*.cu"):
        text, launches[src.name] = LAUNCH.subn(LOOP, src.read_text())
        (out / src.name).write_text(SMEM.sub(SMEM_HOST, text))
    jobs = {}
    for name in _build.SIGNATURES:
        text = (_build.CSRC / f"{name}.cu").read_text()
        n = launches[f"{name}.cu"] + sum(
            launches[i] for i in _build._INCLUDED_SOURCE.findall(text))
        assert n == 1, f"{name}.cu: expected one kernel launch line"
        lib = out / f"lib{name}.so"
        jobs[name] = (lib, subprocess.Popen(
            [cxx, "-O1", "-std=c++20", "-shared", "-fPIC", "-pthread",
             "-ffp-contract=off", "-I", str(out), "-x", "c++", "-o",
             str(lib), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log.decode()[-4000:]
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def run_host(libs, name, args, bufs, order):
    fn = getattr(libs[name], _build.SIGNATURES[name][0])
    fn.restype = ctypes.c_int
    ptrs = [ctypes.c_void_p(bufs[n].data_ptr() if n in bufs else 0)
            for n in order]
    assert fn(ctypes.byref(args), *ptrs, ctypes.c_void_p(0)) == 0


def host_gn(libs, cfg, ocp, st, threads_per_lane=2):
    """The AL source of ``cfg``'s model on the host: 32 lanes and
    ``threads_per_lane`` warps a block (B=5 lanes leave the block
    ragged)."""
    bufs = TF.pack(cfg, ocp, st, trace_rungs=True)
    run_host(libs, TF.kernel_name(cfg), TF.kernel_args(
        cfg, ocp.x0.shape[0], ocp.obs_centers.dim() == 4, threads_per_lane),
        bufs, TF.KERNEL_ORDER)
    sol = TF.to_solution(cfg, TF.unpack(bufs))
    # the status the kernel writes is to_solution's, from its diagnostics
    assert torch.equal(bufs["status"], sol.status)
    return bufs, sol


def host_ip(libs, cfg, ocp, st, lanes_per_block=2):
    """The IP library of ``cfg`` on the host (``ip_library``): fused_ip.cu
    a block of ``lanes_per_block`` warps (B=5 lanes leave the last block
    ragged), the ring source (ST; KS with the boundary rows) a block of 32
    lanes and 4 warps (B=5 lanes of 32)."""
    bufs = TFI.pack_ip(cfg, ocp, st, trace_rungs=True)
    ring = TFI.ring_kernel(cfg)
    run_host(libs, TFI.ip_library(cfg), TFI.kernel_args_ip(
        cfg, ocp.x0.shape[0], ocp.obs_centers.dim() == 4,
        0 if ring else lanes_per_block), bufs,
        TFI.KERNEL_ORDER_RING if ring else TFI.KERNEL_ORDER)
    return bufs, TFI.to_solution_ip(cfg, TFI.unpack_ip(bufs), st.mu)


def bench_ocp(mode="forcespro", moving=False, horizon=H, **kw):
    lcfg, lp = tsyn.make_bench_loop(cs.T_BENCH, horizon, B, mode=mode,
                                    device="cpu", **kw)
    ocp = cs.ocp_at(lcfg, lp, step=1 if mode == "casadi" else 0)
    if moving:
        drift = torch.arange(horizon + 1.0)[:, None, None] * torch.tensor(
            [0.3, 0.05])
        ocp = ocp._replace(obs_centers=ocp.obs_centers[:, None] + drift)
    return lcfg.solver, ocp


def assert_close(ker, pln, bands, state_bands):
    for f, band in bands.items():
        assert bool(cs.lanes_close(getattr(ker, f), getattr(pln, f),
                                   *band).all()), f
    for f, band in state_bands.items():
        assert bool(cs.lanes_close(getattr(ker.state, f),
                                   getattr(pln.state, f), *band).all()), f
    assert torch.equal(ker.status, pln.status)


AL_CASES = {
    "cold-3x4": dict(al_iters=3, sqp_iters=4, alphas=()),
    "ladder-2x2": dict(al_iters=2, sqp_iters=2),
    "casadi-euler-ladder": dict(mode="casadi", al_iters=2, sqp_iters=2),
    "moving-2x2": dict(moving=True, al_iters=2, sqp_iters=2, alphas=()),
}


@pytest.mark.parametrize("case", list(AL_CASES))
def test_fused_gn_source_matches_the_plain_version(host_libs, case):
    cfg, ocp = bench_ocp(**AL_CASES[case])
    st = TS.init_state(cfg, batch=B)
    bufs, ker = host_gn(host_libs, cfg, ocp, st)
    pln = TF.to_solution(cfg, TF.solve_batch_fused_plain(
        cfg, ocp, st, follow=bufs.get("rung")))
    assert_close(ker, pln, cs.BANDS, cs.STATE_BANDS)


def test_fused_gn_source_with_binding_rows(host_libs):
    """The obstacle 2.5 m beside the reference's last stage: its circle
    rows bind, so the multipliers, the penalties' growth on stalled rows
    and the violations that the updates between AL iterations compute
    shape the solve."""
    cfg, ocp = bench_ocp(al_iters=3, sqp_iters=2, alphas=())
    ahead = ocp.x_ref[:, H, None, :2] + torch.tensor(
        [[0.0, 2.5], [1.5, 2.5], [-1.5, 2.5]])
    ocp = ocp._replace(obs_centers=ahead.contiguous())
    st = TS.init_state(cfg, batch=B)
    _, ker = host_gn(host_libs, cfg, ocp, st, 4)
    pln = TF.to_solution(cfg, TF.solve_batch_fused_plain(cfg, ocp, st))
    assert bool((pln.state.mu > cfg.mu0).any())      # a penalty grew
    assert bool((pln.state.lam_lo > 0).any())        # a multiplier is on
    assert_close(ker, pln, cs.BANDS, cs.STATE_BANDS)
    torch.testing.assert_close(ker.state.prev_viol, pln.state.prev_viol,
                               rtol=0.0, atol=1e-3)


def test_fused_gn_source_ragged_lanes_and_strided_stages(host_libs):
    """B=5 lanes in a block of 32 (the other 27 threads of every warp past
    the last lane) at 4 and 8 threads a lane, H=40: 41 stages, so each
    thread owns 5 to 11 of them, with moving obstacles and the ladder on."""
    cfg, ocp = bench_ocp(horizon=40, moving=True, al_iters=2, sqp_iters=2)
    st = TS.init_state(cfg, batch=B)
    for threads_per_lane in (4, 8):
        bufs, ker = host_gn(host_libs, cfg, ocp, st, threads_per_lane)
        pln = TF.to_solution(cfg, TF.solve_batch_fused_plain(
            cfg, ocp, st, follow=bufs.get("rung")))
        assert_close(ker, pln, cs.BANDS, cs.STATE_BANDS)


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


IP_CASES = {
    "cold-5x10": dict(method="ip", ip_sqp_iters=5, ip_iters=10,
                      ip_alphas=()),
    "ladder-2x6-warm-duals": dict(method="ip", ip_sqp_iters=2, ip_iters=6,
                                  ip_warm_duals=True),
    "casadi-euler-ladder": dict(mode="casadi", method="ip", ip_sqp_iters=2,
                                ip_iters=4),
    "moving-2x6": dict(moving=True, method="ip", ip_sqp_iters=2, ip_iters=6,
                       ip_alphas=()),
}


@pytest.mark.parametrize("case", list(IP_CASES))
def test_fused_ip_source_matches_the_plain_version(host_libs, case):
    cfg, ocp = bench_ocp(**IP_CASES[case])
    st = TS.init_state(cfg, batch=B)
    bufs, ker = host_ip(host_libs, cfg, ocp, st)
    pln = TFI.to_solution_ip(cfg, TFI.solve_batch_fused_ip_plain(
        cfg, ocp, st, follow=bufs.get("rung")), st.mu)
    assert_close(ker, pln, cs.IP_BANDS, cs.IP_STATE_BANDS)
    torch.testing.assert_close(ker.state.prev_viol, pln.state.prev_viol,
                               rtol=0.0, atol=1e-3)


def test_fused_ip_source_warm_start_and_in_place_state(host_libs):
    """The bench point: warm ip 1x4 from the cold-start state; the kernel
    writes U and the duals in place and leaves the caller's state alone."""
    cfg, ocp = bench_ocp(method="ip", ip_sqp_iters=5, ip_iters=10,
                         ip_alphas=())
    _, cold = host_ip(host_libs, cfg, ocp, TS.init_state(cfg, batch=B))
    warm_cfg = dataclasses.replace(cfg, ip_sqp_iters=1, ip_iters=4,
                                   ip_warm_duals=True)
    before = cold.state.map(torch.clone)
    bufs, ker = host_ip(host_libs, warm_cfg, ocp, cold.state)
    for a, b in zip(cold.state, before):
        assert torch.equal(a, b)
    assert ker.U.data_ptr() == bufs["U"].data_ptr()
    pln = TFI.to_solution_ip(warm_cfg, TFI.solve_batch_fused_ip_plain(
        warm_cfg, ocp, cold.state), cold.state.mu)
    assert_close(ker, pln, cs.IP_BANDS, cs.IP_STATE_BANDS)
    assert bool((ker.status >= 0).all())


def test_fused_ip_source_ragged_lanes_and_strided_stages(host_libs):
    """B=5 lanes at 2 and 4 lanes a block (the last block ragged), H=40:
    41 stages over the warp's 32 threads, so threads 0..8 own two stages
    each (the strided path of the kernel), with moving obstacles and the
    ladder on."""
    cfg, ocp = bench_ocp(horizon=40, moving=True, method="ip",
                         ip_sqp_iters=2, ip_iters=3, ip_warm_duals=True)
    st = TS.init_state(cfg, batch=B)
    for lanes_per_block in (2, 4):
        bufs, ker = host_ip(host_libs, cfg, ocp, st, lanes_per_block)
        pln = TFI.to_solution_ip(cfg, TFI.solve_batch_fused_ip_plain(
            cfg, ocp, st, follow=bufs.get("rung")), st.mu)
        assert_close(ker, pln, cs.IP_BANDS, cs.IP_STATE_BANDS)
        torch.testing.assert_close(ker.state.prev_viol, pln.state.prev_viol,
                                   rtol=0.0, atol=1e-3)


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


def corridor_ocp(**kw):
    """B=5 lanes at H=12 on the bending road of ``chip_smoke`` (the bench
    loop's step 32, in the swerve), 1.3 m either side of the reference, so
    that the boundary rows bind."""
    lcfg, lp = tsyn.make_bench_loop(cs.T_BENCH, 12, B, device="cpu",
                                    boundary_rows=True, **kw)
    return lcfg.solver, cs.on_curved_road(lcfg, lp, 1.3)


def test_fused_gn_source_with_boundary_rows(host_libs):
    """The AL source's boundary instance (3x2 with the ladder, B=5 ragged,
    4 threads a lane) on a bending road whose rows bind: their multipliers
    and penalties move."""
    cfg, ocp = corridor_ocp(al_iters=3, sqp_iters=2)
    st = TS.init_state(cfg, batch=B)
    bufs, ker = host_gn(host_libs, cfg, ocp, st, 4)
    pln = TF.to_solution(cfg, TF.solve_batch_fused_plain(
        cfg, ocp, st, follow=bufs.get("rung")))
    assert cs.active_boundary_rows(cfg, pln.X, ocp.boundaries,
                                   ocp.boundary_signs) > 0
    assert bool((pln.state.lam_lo[..., TF.NR:] > 0).any())
    assert_close(ker, pln, cs.BANDS, cs.STATE_BANDS)
    torch.testing.assert_close(ker.state.prev_viol, pln.state.prev_viol,
                               rtol=0.0, atol=1e-3)


def test_fused_ip_source_with_boundary_rows(host_libs):
    """The KS IP library with the boundary rows, the ring source's instance
    (2x6, warm duals, the ladder, B=5 lanes of a block of 32), on a bending
    road whose rows bind."""
    cfg, ocp = corridor_ocp(method="ip", ip_sqp_iters=2, ip_iters=6,
                            ip_warm_duals=True)
    st = TS.init_state(cfg, batch=B)
    bufs, ker = host_ip(host_libs, cfg, ocp, st)
    pln = TFI.to_solution_ip(cfg, TFI.solve_batch_fused_ip_plain(
        cfg, ocp, st, follow=bufs.get("rung")), st.mu)
    assert cs.active_boundary_rows(cfg, pln.X, ocp.boundaries,
                                   ocp.boundary_signs) > 0
    assert bool((pln.state.lam_lo[..., TF.NR:] > 1.0).any())
    assert_close(ker, pln, cs.IP_BANDS, cs.IP_STATE_BANDS)
    torch.testing.assert_close(ker.state.prev_viol, pln.state.prev_viol,
                               rtol=0.0, atol=1e-3)


def test_fused_ip_ks_ring_ragged_lanes_at_the_corridor_horizon(host_libs):
    """The KS ring library at the hard-corridor row's horizon (H=14: 15
    stages over a block's 4 warps) and its warm-up budget (5x10, warm
    duals, the default ladder), B=5 lanes of a block of 32, moving
    obstacles, inside a road 4 m either side of the reference."""
    cfg, ocp = bench_ocp(horizon=14, moving=True, method="ip",
                         ip_sqp_iters=5, ip_iters=10, ip_warm_duals=True,
                         boundary_rows=True)
    ocp = cs.with_road_boundaries(ocp)
    assert TFI.ip_library(cfg) == "fused_ip_ks_ring" and cfg.ip_alphas
    st = TS.init_state(cfg, batch=B)
    bufs, ker = host_ip(host_libs, cfg, ocp, st)
    pln = TFI.to_solution_ip(cfg, TFI.solve_batch_fused_ip_plain(
        cfg, ocp, st, follow=bufs.get("rung")), st.mu)
    assert_close(ker, pln, cs.IP_BANDS, cs.IP_STATE_BANDS)
    torch.testing.assert_close(ker.state.prev_viol, pln.state.prev_viol,
                               rtol=0.0, atol=1e-3)
    assert ker.X.shape == (B, 15, 5) and ker.state.lam_lo.shape[-1] == 20


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

ST = dict(model="st", vehicle=VEHICLE_2)
ST_CASES = {f"al-{k}": v for k, v in AL_CASES.items()}
ST_CASES.update({f"ip-{k}": v for k, v in IP_CASES.items()})


@pytest.mark.parametrize("case", list(ST_CASES))
def test_st_sources_match_the_plain_version(host_libs, case):
    """Both fused sources' ST instances (4 threads a lane; 2 lanes a
    block) against the plain versions, at the KS cases' budgets, all 7
    states in the X band."""
    cfg, ocp = bench_ocp(**ST_CASES[case], **ST)
    st = TS.init_state(cfg, batch=B)
    if cfg.method == "ip":
        bufs, ker = host_ip(host_libs, cfg, ocp, st)
        pln = TFI.to_solution_ip(cfg, TFI.solve_batch_fused_ip_plain(
            cfg, ocp, st, follow=bufs.get("rung")), st.mu)
        assert_close(ker, pln, cs.IP_BANDS, cs.IP_STATE_BANDS)
    else:
        bufs, ker = host_gn(host_libs, cfg, ocp, st, 4)
        pln = TF.to_solution(cfg, TF.solve_batch_fused_plain(
            cfg, ocp, st, follow=bufs.get("rung")))
        assert_close(ker, pln, cs.BANDS, cs.STATE_BANDS)
    assert ker.X.shape == (B, H + 1, 7)


@pytest.mark.parametrize("method", ["al", "ip"])
def test_st_sources_with_boundary_rows(host_libs, method):
    """The ST libraries' boundary instances on the bending road whose rows
    bind (the KS cases' budgets: al 3x2 with the ladder, ip 2x6 with warm
    duals and the ladder)."""
    kw = (dict(al_iters=3, sqp_iters=2) if method == "al" else
          dict(method="ip", ip_sqp_iters=2, ip_iters=6, ip_warm_duals=True))
    cfg, ocp = corridor_ocp(**kw, **ST)
    st = TS.init_state(cfg, batch=B)
    if method == "ip":
        bufs, ker = host_ip(host_libs, cfg, ocp, st)
        pln = TFI.to_solution_ip(cfg, TFI.solve_batch_fused_ip_plain(
            cfg, ocp, st, follow=bufs.get("rung")), st.mu)
        assert_close(ker, pln, cs.IP_BANDS,
                     {"lam_hi": cs.IP_STATE_BANDS["lam_hi"]})
        # the boundary rows' duals of a lane running along the edge are
        # degenerate (ROADMAP, known behaviours): lam_lo is held on the
        # lanes where the plain version's own float32 and float64 solves
        # agree, as chip_smoke's rounding_lanes excuses the others, here
        # one lane of five
        o64, s64 = cs.as_float64(ocp._replace(
            boundaries=ocp.boundaries.double(),
            boundary_signs=ocp.boundary_signs.double()), st)
        p64 = TFI.solve_batch_fused_ip_plain(cfg, o64, s64,
                                             follow=bufs.get("rung"))
        band = cs.IP_STATE_BANDS["lam_lo"]
        noisy = ~cs.lanes_close(pln.state.lam_lo.double(), p64[2], *band)
        assert int(noisy.sum()) <= 1
        assert bool((cs.lanes_close(ker.state.lam_lo, pln.state.lam_lo,
                                    *band) | noisy).all())
    else:
        bufs, ker = host_gn(host_libs, cfg, ocp, st, 4)
        pln = TF.to_solution(cfg, TF.solve_batch_fused_plain(
            cfg, ocp, st, follow=bufs.get("rung")))
        assert_close(ker, pln, cs.BANDS, cs.STATE_BANDS)
    assert cs.active_boundary_rows(cfg, pln.X, ocp.boundaries,
                                   ocp.boundary_signs) > 0
    torch.testing.assert_close(ker.state.prev_viol, pln.state.prev_viol,
                               rtol=0.0, atol=1e-3)


def test_st_al_source_at_eight_threads_a_lane_and_h40(host_libs):
    """B=5 ragged lanes at 8 threads a lane, H=40, moving obstacles, the
    ladder on: the ST ring's operand (71 floats) through several slots a
    producer."""
    cfg, ocp = bench_ocp(horizon=40, moving=True, al_iters=2, sqp_iters=2,
                         **ST)
    st = TS.init_state(cfg, batch=B)
    bufs, ker = host_gn(host_libs, cfg, ocp, st, 8)
    pln = TF.to_solution(cfg, TF.solve_batch_fused_plain(
        cfg, ocp, st, follow=bufs.get("rung")))
    assert_close(ker, pln, cs.BANDS, cs.STATE_BANDS)


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


def test_st_ip_ring_source_ragged_lanes_and_strided_stages(host_libs):
    """The ST ring source at H=40 (41 stages over a block's 4 warps, a
    thread looping over 10 or 11 of them in every separable phase and a
    producer over 13 or 14 in every ring), B=5 lanes of a block of 32,
    moving obstacles, warm duals and the ladder on."""
    cfg, ocp = bench_ocp(horizon=40, moving=True, method="ip",
                         ip_sqp_iters=2, ip_iters=3, ip_warm_duals=True, **ST)
    st = TS.init_state(cfg, batch=B)
    bufs, ker = host_ip(host_libs, cfg, ocp, st)
    pln = TFI.to_solution_ip(cfg, TFI.solve_batch_fused_ip_plain(
        cfg, ocp, st, follow=bufs.get("rung")), st.mu)
    assert_close(ker, pln, cs.IP_BANDS, cs.IP_STATE_BANDS)
    torch.testing.assert_close(ker.state.prev_viol, pln.state.prev_viol,
                               rtol=0.0, atol=1e-3)
    assert ker.X.shape == (B, 41, 7)


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
