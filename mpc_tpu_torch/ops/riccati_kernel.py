"""The batched Riccati sweep as one CUDA kernel launch.

The port of ``tools/ablation/pallas_riccati.py::_riccati_kernel``, the
Pallas TPU kernel of the sweep: ``csrc/riccati.cu``, one thread per lane,
an instance for each state dimension (5 for KS, 7 for ST; the Pallas
kernel was KS-only, the JAX engine's XLA sweep takes either), built by
``_build.load`` at first use and bound with ctypes.  It computes
the function of :func:`ops.riccati_vec.backward_pass_vec_plain` (K, d, dV1,
dV2, with the defect ``r``); :func:`ops.riccati_vec.backward_pass_vec`
sends CUDA tensors here.

:func:`pack` copies the lanes-leading inputs into the kernel's layout,
(stage, field, lane) with the lane fastest, and allocates the outputs;
:func:`launch` runs the kernel once over them and counts the launch;
:func:`unpack` views the outputs in the lanes-leading layout again.
"""
from __future__ import annotations

import ctypes

import torch

from mpc_tpu_torch.ops import fused_gn as F
from mpc_tpu_torch.ops.riccati import LinDyn, RiccatiGains, StageQuad

NU = 2
NXS = (5, 7)       # the kernel's instances: KS and ST state dimensions
THREADS = 64       # threads per block: one lane per thread

# the kernel's buffers in the order of riccati_sweep's pointer arguments
KERNEL_INPUTS = ("Q", "R", "M", "qx", "qu", "A", "B", "r", "QH", "qH")
KERNEL_OUTPUTS = ("K", "d", "dV")


class RicArgs(ctypes.Structure):
    """Mirror of ``struct RicArgs`` in csrc/riccati.cu."""

    _fields_ = [("B", ctypes.c_int32), ("H", ctypes.c_int32),
                ("threads", ctypes.c_int32), ("reg", ctypes.c_float),
                ("nx", ctypes.c_int32)]


def pack(quad: StageQuad, QH: torch.Tensor, qH: torch.Tensor,
         dyn: LinDyn) -> dict:
    """The kernel's buffers: every input checked (float32, the shapes of
    its state dimension NX, 5 or 7, taken from Q) and copied lanes
    fastest, the outputs K (H, NU*NX, B), d (H, NU, B) and dV (2, B)
    allocated."""
    B, H, nx = quad.Q.shape[:3]
    if nx not in NXS:
        raise ValueError(f"state dimension {nx}: the kernel has {NXS}")
    shapes = {"Q": (nx, nx), "R": (NU, NU), "M": (nx, NU), "qx": (nx,),
              "qu": (NU,), "A": (nx, nx), "B": (nx, NU), "r": (nx,)}
    src = dict(zip(StageQuad._fields, quad))
    src.update(A=dyn.A, B=dyn.B, r=dyn.r)
    bufs = {n: F._packed(src[n], (B, H) + s).reshape(H, -1, B)
            for n, s in shapes.items()}
    bufs["QH"] = F._packed(QH, (B, nx, nx)).reshape(nx * nx, B)
    bufs["qH"] = F._packed(qH, (B, nx))
    dev, f32 = quad.Q.device, torch.float32
    bufs.update(K=torch.empty((H, NU * nx, B), dtype=f32, device=dev),
                d=torch.empty((H, NU, B), dtype=f32, device=dev),
                dV=torch.empty((2, B), dtype=f32, device=dev))
    return bufs


def launch(bufs: dict, reg, threads: int = THREADS):
    """Launch the kernel once on the current stream over packed ``bufs``;
    ``launch.launches`` counts the launches."""
    H, nx2, B = bufs["Q"].shape
    args = RicArgs(B=B, H=H, threads=threads, reg=float(reg),
                   nx=round(nx2 ** 0.5))
    err = F.call_kernel("riccati", args, bufs, KERNEL_INPUTS + KERNEL_OUTPUTS)
    launch.launches += 1
    if err != 0:
        raise RuntimeError(f"riccati kernel launch failed: CUDA error {err}")


launch.launches = 0


def unpack(bufs: dict) -> RiccatiGains:
    """The gains in the lanes-leading layout (views of the outputs)."""
    H, unx, B = bufs["K"].shape
    return RiccatiGains(K=F._aos(bufs["K"]).reshape(B, H, NU, unx // NU),
                        d=F._aos(bufs["d"]), dV1=bufs["dV"][0],
                        dV2=bufs["dV"][1])


def sweep(quad: StageQuad, QH: torch.Tensor, qH: torch.Tensor, dyn: LinDyn,
          reg, threads: int = THREADS) -> RiccatiGains:
    """The sweep on CUDA tensors: pack, one launch, unpack."""
    bufs = pack(quad, QH, qH, dyn)
    launch(bufs, reg, threads)
    return unpack(bufs)
