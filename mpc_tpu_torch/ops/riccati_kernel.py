"""The batched Riccati sweep as one CUDA kernel launch.

The port of ``tools/ablation/pallas_riccati.py::_riccati_kernel``, the
Pallas TPU kernel of the sweep: ``csrc/riccati.cu``, one thread per lane,
built by ``_build.load`` at first use and bound with ctypes.  It computes
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

NX = 5
NU = 2
THREADS = 64       # threads per block: one lane per thread

# the kernel's buffers in the order of riccati_sweep's pointer arguments
KERNEL_INPUTS = ("Q", "R", "M", "qx", "qu", "A", "B", "r", "QH", "qH")
KERNEL_OUTPUTS = ("K", "d", "dV")


class RicArgs(ctypes.Structure):
    """Mirror of ``struct RicArgs`` in csrc/riccati.cu."""

    _fields_ = [("B", ctypes.c_int32), ("H", ctypes.c_int32),
                ("threads", ctypes.c_int32), ("reg", ctypes.c_float)]


def pack(quad: StageQuad, QH: torch.Tensor, qH: torch.Tensor,
         dyn: LinDyn) -> dict:
    """The kernel's buffers: every input checked (float32, KS shapes) and
    copied lanes fastest, the outputs K (H, NU*NX, B), d (H, NU, B) and
    dV (2, B) allocated."""
    B, H = quad.Q.shape[:2]
    shapes = {"Q": (NX, NX), "R": (NU, NU), "M": (NX, NU), "qx": (NX,),
              "qu": (NU,), "A": (NX, NX), "B": (NX, NU), "r": (NX,)}
    src = dict(zip(StageQuad._fields, quad))
    src.update(A=dyn.A, B=dyn.B, r=dyn.r)
    bufs = {n: F._packed(src[n], (B, H) + s).reshape(H, -1, B)
            for n, s in shapes.items()}
    bufs["QH"] = F._packed(QH, (B, NX, NX)).reshape(NX * NX, B)
    bufs["qH"] = F._packed(qH, (B, NX))
    dev, f32 = quad.Q.device, torch.float32
    bufs.update(K=torch.empty((H, NU * NX, B), dtype=f32, device=dev),
                d=torch.empty((H, NU, B), dtype=f32, device=dev),
                dV=torch.empty((2, B), dtype=f32, device=dev))
    return bufs


def launch(bufs: dict, reg, threads: int = THREADS):
    """Launch the kernel once on the current stream over packed ``bufs``;
    ``launch.launches`` counts the launches."""
    H, _, B = bufs["Q"].shape
    args = RicArgs(B=B, H=H, threads=threads, reg=float(reg))
    err = F.call_kernel("riccati", args, bufs, KERNEL_INPUTS + KERNEL_OUTPUTS)
    launch.launches += 1
    if err != 0:
        raise RuntimeError(f"riccati kernel launch failed: CUDA error {err}")


launch.launches = 0


def unpack(bufs: dict) -> RiccatiGains:
    """The gains in the lanes-leading layout (views of the outputs)."""
    H, _, B = bufs["K"].shape
    return RiccatiGains(K=F._aos(bufs["K"]).reshape(B, H, NU, NX),
                        d=F._aos(bufs["d"]), dV1=bufs["dV"][0],
                        dV2=bufs["dV"][1])


def sweep(quad: StageQuad, QH: torch.Tensor, qH: torch.Tensor, dyn: LinDyn,
          reg, threads: int = THREADS) -> RiccatiGains:
    """The sweep on CUDA tensors: pack, one launch, unpack."""
    bufs = pack(quad, QH, qH, dyn)
    launch(bufs, reg, threads)
    return unpack(bufs)
