"""The CUDA sources compiled for the host, shared by the
``tests/test_torch_kernel_host*.py`` files (see
``tests/test_torch_kernel_host.py`` for how a source runs on the host):
the stand-in for ``cuda_runtime.h``, the build of the libraries, their
ctypes calls and the problems they are held to their plain versions on.
"""
import ctypes
import re
import shutil
import subprocess

import pytest
import torch

import chip_smoke as cs
from mpc_tpu_torch.models.vehicle import VEHICLE_2
from mpc_tpu_torch.ops import _build
from mpc_tpu_torch.ops import fused_gn as TF
from mpc_tpu_torch.ops import fused_ip as TFI
from mpc_tpu_torch.utils import synthetic as tsyn
from torch_once import once


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


def build_host_libs(tmp_path_factory, names=tuple(_build.SIGNATURES)):
    """The libraries of ``names`` compiled for the host.  Every library is
    compiled once a test session (``torch_once.once``), into one directory
    that each file's ``host_libs`` loads from."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to build the kernels with")
    paths = once(tmp_path_factory, "host_kernels",
                 lambda out: _compile_host_libs(cxx, out))
    return {name: ctypes.CDLL(paths[name]) for name in names}


def _compile_host_libs(cxx, out):
    """Every library of ``_build.SIGNATURES`` compiled in ``out``, in
    parallel: their paths by name."""
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
    paths = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log.decode()[-4000:]
        paths[name] = str(lib)
    return paths


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


def corridor_ocp(**kw):
    """B=5 lanes at H=12 on the bending road of ``chip_smoke`` (the bench
    loop's step 32, in the swerve), 1.3 m either side of the reference, so
    that the boundary rows bind."""
    lcfg, lp = tsyn.make_bench_loop(cs.T_BENCH, 12, B, device="cpu",
                                    boundary_rows=True, **kw)
    return lcfg.solver, cs.on_curved_road(lcfg, lp, 1.3)


ST = dict(model="st", vehicle=VEHICLE_2)
