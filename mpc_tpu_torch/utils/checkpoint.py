"""Checkpoint and resume of a closed loop's carry
(``mpc_tpu.utils.checkpoint``, its numpy route).

The carry of a loop (``closed_loop.init_carry`` / ``init_batch_carry``: the
step, the plant states, the warm-start solver state, the noise generator
and the progress bases) is saved between chunks, so that a run cut at step
k and resumed is the uninterrupted run, noise included.  The leaves of the
carry go to ``step_{step:08d}.pt`` with ``torch.save``; a
``torch.Generator`` is saved as its ``get_state()``.

A loop whose lanes split over ranks (``parallel.batch``) saves one file a
rank, ``step_{step:08d}/rank_{rank:05d}.pt``, each with its rank's lanes
and the mesh's shape: each rank writes and reads only its own lanes (the
JAX package hands orbax its shards for the same reason), and a run
resumes on a mesh of the same shape.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import torch
from torch import distributed as dist
from torch.utils import _pytree as pytree


def _saved(leaf):
    if isinstance(leaf, torch.Generator):
        return leaf.get_state()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    return leaf


def _rank_file(path: str, step: int, mesh) -> str:
    rank = dist.get_rank() if mesh.device_mesh is not None else 0
    return os.path.join(os.path.abspath(path), f"step_{step:08d}",
                        f"rank_{rank:05d}.pt")


def save_checkpoint(path: str, state: Any, step: int, mesh=None) -> str:
    """Save the leaves of ``state`` (tensors, generators, numbers, None)
    at ``step``; returns the file written.  With ``mesh``
    (``parallel.mesh.Mesh``) ``state`` is this rank's and goes to a file
    of its own."""
    leaves = [_saved(leaf) for leaf in pytree.tree_leaves(state)]
    if mesh is not None:
        target = _rank_file(path, step, mesh)
        os.makedirs(os.path.dirname(target), exist_ok=True)
        torch.save({"mesh": [mesh.size("dp"), mesh.size("sp")],
                    "leaves": leaves}, target)
        return target
    os.makedirs(path, exist_ok=True)
    target = os.path.join(os.path.abspath(path), f"step_{step:08d}.pt")
    torch.save(leaves, target)
    return target


def latest_step(path: str) -> Optional[int]:
    """The last step saved under ``path``, or None."""
    if not os.path.isdir(path):
        return None
    steps = [int(name.split("_")[1].split(".")[0])
             for name in os.listdir(path) if name.startswith("step_")]
    return max(steps) if steps else None


def _restored(saved, like):
    if isinstance(like, torch.Generator):
        gen = torch.Generator(device=like.device)
        gen.set_state(saved)
        return gen
    if isinstance(like, torch.Tensor):
        return saved.to(dtype=like.dtype, device=like.device)
    return saved


def restore_checkpoint(path: str, like: Any, step: Optional[int] = None,
                       mesh=None) -> Any:
    """The state saved at ``step`` (default: the latest) in the structure,
    dtypes and devices of ``like``; a generator is a new one in the saved
    state.  With ``mesh``: this rank's file, which must come from a mesh
    of the same shape (``ValueError`` otherwise)."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    if mesh is not None:
        got = torch.load(_rank_file(path, step, mesh), weights_only=True)
        want = [mesh.size("dp"), mesh.size("sp")]
        if got["mesh"] != want:
            raise ValueError(f"checkpoint of step {step} was saved on a "
                             f"(dp, sp) = {tuple(got['mesh'])} mesh, not "
                             f"{tuple(want)}")
        saved = got["leaves"]
    else:
        saved = torch.load(os.path.join(path, f"step_{step:08d}.pt"),
                           weights_only=True)
    leaves, spec = pytree.tree_flatten(like)
    if len(saved) != len(leaves):
        raise ValueError(f"checkpoint of step {step} has {len(saved)} "
                         f"leaves, the structure {len(leaves)}")
    return pytree.tree_unflatten(
        [_restored(s, l) for s, l in zip(saved, leaves)], spec)
