"""Ranks, their ('dp', 'sp') mesh and the lane split
(``mpc_tpu.parallel.mesh``) on ``torch.distributed``.

Axis conventions, as in the JAX package:

* ``dp``: the lane axis.  Lanes (independent NMPC instances) split into
  contiguous blocks, one a rank; nothing crosses ranks on the hot path.
* ``sp``: the stage axis.  The ranks of one ``sp`` group hold the same
  lanes; the parallel-scan Riccati sweep (``ops.pscan``) splits its H+1
  elements among them when ``SolverConfig.stage_axis == 'sp'``.

A program of n ranks is n processes, each started by the caller (a
``torchrun``-style launcher, ``torch.multiprocessing``) with the
environment ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK``.  :func:`init_distributed` joins them, :func:`make_mesh`
lays them out as (dp, sp), :func:`shard_lanes` hands a rank its lanes and
:func:`gather_lanes` puts the lanes back together.  One process with no
process group is a mesh of shape (1, 1) whose collectives are identities.

Every collective of the parallel path goes through :func:`all_reduce` or
:func:`all_gather`, which record their op, axis, ranks, bytes and device
while a census runs (``parallel.batch.collective_census``).

Not carried: ``lane_sharding`` and ``replicated`` return the
``NamedSharding`` with which JAX places one global array over the mesh.
Eager PyTorch has no global array: a rank holds its block of lanes as an
ordinary tensor, and where the JAX package would state a placement the
port calls :func:`shard_lanes` (lanes over ``dp``) or leaves the tensor
whole on every rank (replicated).
"""
from __future__ import annotations

import contextvars
import datetime
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from mpc_tpu_torch.ops.sqp import map_tensors

AXES = ("dp", "sp")
TIMEOUT_S = 240.0   # a collective waits this long for a rank that failed

# the records of the running census (parallel.batch.collective_census)
census: contextvars.ContextVar = contextvars.ContextVar("census",
                                                        default=None)


def init_distributed(backend: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> None:
    """Join this process to the program's process group (a no-op when it
    has joined already, and at world size 1 unless a launcher started the
    process: ``torchrun --nproc-per-node 1`` sets ``MASTER_PORT``, and
    then the one rank joins a group of one, whose collectives run through
    ``backend``).

    ``world_size`` and ``rank`` default to ``WORLD_SIZE`` and ``RANK``; the
    rendezvous is ``tcp://MASTER_ADDR:MASTER_PORT``.  ``backend`` is the
    caller's: 'nccl' (one GPU a rank) or 'gloo' (the CPU, or ranks that
    share a GPU).  A collective that waits on a rank longer than
    ``TIMEOUT_S`` raises instead of hanging.
    """
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if dist.is_initialized() or (world_size <= 1
                                 and "MASTER_PORT" not in os.environ):
        return
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if rank is None:
        rank = int(os.environ["RANK"])
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ["MASTER_PORT"]
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}:{port}", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))


def local_device(device=None) -> torch.device:
    """This rank's device: ``device`` when given, else
    ``cuda:{LOCAL_RANK % device_count}`` (ranks beyond the cards share
    them)."""
    if device is not None:
        return torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


class Mesh:
    """A (dp, sp) grid of the program's ranks, row-major (global rank =
    i_dp * sp + i_sp); ``shape`` is {'dp': dp, 'sp': sp} as JAX's
    ``Mesh.shape``.  ``device_mesh`` is the ``DeviceMesh`` whose groups the
    collectives use, or None for a single rank."""

    def __init__(self, dp: int, sp: int, device_mesh=None):
        self.shape: Dict[str, int] = {"dp": dp, "sp": sp}
        self.device_mesh = device_mesh
        rank = dist.get_rank() if device_mesh is not None else 0
        self.coords = {"dp": rank // sp, "sp": rank % sp}

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's place along ``axis``."""
        return self.coords[axis]

    def group(self, axis: str):
        """The process group of the ranks along ``axis`` through this rank
        (None on a single-rank mesh)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def ranks(self, axis: str) -> Tuple[int, ...]:
        """Global ranks along ``axis`` through this rank, in axis order."""
        dp, sp = self.shape["dp"], self.shape["sp"]
        if axis == "dp":
            return tuple(i * sp + self.coords["sp"] for i in range(dp))
        return tuple(self.coords["dp"] * sp + j for j in range(sp))

    def __repr__(self):
        return f"Mesh({self.shape}, coords={self.coords})"


def make_mesh(shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """A ('dp', 'sp') mesh over the program's ranks; ``shape`` (dp, sp)
    defaults to every rank on ``dp``.  Raises ``ValueError`` when dp * sp
    is not the world size.  With a process group the axes' groups come
    from ``init_device_mesh`` ('cuda' under NCCL, else 'cpu'); without
    one the mesh is this one rank, (1, 1)."""
    grouped = dist.is_initialized()
    n = dist.get_world_size() if grouped else 1
    dp, sp = (n, 1) if shape is None else shape
    if dp * sp != n:
        raise ValueError(f"mesh shape {(dp, sp)} != world size {n}")
    if not grouped:
        return Mesh(dp, sp)
    from torch.distributed.device_mesh import init_device_mesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(dp, sp, init_device_mesh(device_type, (dp, sp),
                                         mesh_dim_names=AXES))


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _record(op, mesh: Mesh, axis: str, t: torch.Tensor):
    records = census.get()
    if records is not None:
        records.append({"op": op, "axis": axis, "ranks": mesh.ranks(axis),
                        "bytes": t.numel() * t.element_size(),
                        "dtype": str(t.dtype).replace("torch.", ""),
                        "device": str(t.device),
                        "backend": dist.get_backend(mesh.group(axis))})


def _alone(mesh: Mesh, axis: str) -> bool:
    """Whether a collective along ``axis`` is the identity: the axis holds
    this rank alone, and the program is more than one rank or has no
    process group (a launcher's world of one rank runs its collectives
    through its backend)."""
    return mesh.size(axis) == 1 and (
        mesh.group(axis) is None or mesh.size("dp") * mesh.size("sp") > 1)


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str, op: str = "sum"
               ) -> torch.Tensor:
    """``t`` reduced ('sum' or 'max') over the ranks along ``axis``, the
    ``psum``/``pmax`` of the JAX package; ``t`` itself on one rank
    (:func:`_alone`)."""
    if _alone(mesh, axis):
        return t
    out = t.clone()
    _record(f"all_reduce_{op}", mesh, axis, out)
    dist.all_reduce(out, op=_OPS[op], group=mesh.group(axis))
    return out


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str) -> list:
    """Every rank's ``t`` along ``axis``, in axis order (the tensors must
    have one shape); ``[t]`` on one rank (:func:`_alone`)."""
    if _alone(mesh, axis):
        return [t]
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size(axis))]
    _record("all_gather", mesh, axis, t)
    dist.all_gather(parts, t, group=mesh.group(axis))
    return parts


# ---------------------------------------------------------------------------
# the lane split
# ---------------------------------------------------------------------------


def lane_count(tree) -> int:
    """The lane count of ``tree`` (NamedTuples of tensors, ``Weights`` and
    Nones, as ``sqp.map_tensors`` walks them): the leading size its
    tensors share (a ValueError where they disagree)."""
    sizes = set()

    def size(x):
        if x.dim():
            sizes.add(x.shape[0])
        return x

    map_tensors(tree, size)
    if len(sizes) != 1:
        raise ValueError(f"leaves disagree on the lane count: {sorted(sizes)}")
    return sizes.pop()


def lane_block(n: int, mesh: Mesh) -> Tuple[int, int]:
    """(lo, hi): this rank's contiguous block of ``n`` lanes along dp.
    Raises ``ValueError`` when ``n`` does not divide by dp."""
    dp = mesh.size("dp")
    if n % dp:
        raise ValueError(f"{n} lanes do not split evenly over dp={dp}")
    lo = mesh.index("dp") * (n // dp)
    return lo, lo + n // dp


def shard_lanes(tree, mesh: Mesh):
    """This rank's block of lanes of every tensor of ``tree`` with a
    leading lane axis (0-dim tensors and Nones stay whole), as views."""
    lo, hi = lane_block(lane_count(tree), mesh)
    return map_tensors(tree, lambda x: x[lo:hi] if x.dim() else x)


def gather_lanes(tree, mesh: Mesh):
    """Every lane on every rank: each tensor of ``tree`` with a leading
    lane axis all-gathered over dp and concatenated in lane order
    (``multihost_utils.process_allgather(tiled=True)``)."""
    return map_tensors(
        tree,
        lambda x: torch.cat(all_gather(x, mesh, "dp")) if x.dim() else x)
