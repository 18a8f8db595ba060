"""Checkpoint and resume of a closed loop's carry
(``mpc_tpu.utils.checkpoint``, its numpy route).

The carry of a loop (``closed_loop.init_carry`` / ``init_batch_carry``: the
step, the plant states, the warm-start solver state, the noise generator
and the progress bases) is saved between chunks, so that a run cut at step
k and resumed is the uninterrupted run, noise included.  The leaves of the
carry go to ``step_{step:08d}.pt`` with ``torch.save``; a
``torch.Generator`` is saved as its ``get_state()``.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import torch
from torch.utils import _pytree as pytree


def _saved(leaf):
    if isinstance(leaf, torch.Generator):
        return leaf.get_state()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    return leaf


def save_checkpoint(path: str, state: Any, step: int) -> str:
    """Save the leaves of ``state`` (tensors, generators, numbers, None)
    at ``step``; returns the file written."""
    os.makedirs(path, exist_ok=True)
    target = os.path.join(os.path.abspath(path), f"step_{step:08d}.pt")
    torch.save([_saved(leaf) for leaf in pytree.tree_leaves(state)], target)
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


def restore_checkpoint(path: str, like: Any, step: Optional[int] = None
                       ) -> Any:
    """The state saved at ``step`` (default: the latest) in the structure,
    dtypes and devices of ``like``; a generator is a new one in the saved
    state."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    saved = torch.load(os.path.join(path, f"step_{step:08d}.pt"),
                       weights_only=True)
    leaves, spec = pytree.tree_flatten(like)
    if len(saved) != len(leaves):
        raise ValueError(f"checkpoint of step {step} has {len(saved)} "
                         f"leaves, the structure {len(leaves)}")
    return pytree.tree_unflatten(
        [_restored(s, l) for s, l in zip(saved, leaves)], spec)
