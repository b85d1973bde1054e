"""Checkpointing: atomic, async, restored onto any device.

PyTorch port of `repro.ckpt.checkpoint`, with the reference's layout:

    <dir>/step_<N>/
        manifest.json   — the step, and each key's shape and dtype
        arrays.npz      — the tree's leaves keyed by their path

A tree is made of dicts, NamedTuples (the optimizer states), tensors,
and `nn.Module`s (saved through their ``state_dict``);
a leaf's key is its path joined by "/" (a module's state-dict names
under it, a NamedTuple's field names).  numpy has no bfloat16: a
bfloat16 leaf is stored as its raw uint16 bits and the manifest names
its dtype, so a restore gives back the saved bits exactly.

  * atomicity — written to ``step_<N>.tmp`` then `os.rename`d, so a
    crash mid-write never corrupts the latest checkpoint;
  * async — `save_async` copies to host memory synchronously and writes
    on a background thread, overlapping I/O with the next steps;
  * restore — `restore` rebuilds the structure of ``tree_like``: its
    tensors come back as new tensors of the like's dtype on ``device``
    (by default each like's own device; the reference's ``shardings=``),
    its modules are loaded **in place** (and moved to ``device`` if one
    is given) and returned;
  * GC — ``keep_last`` bounds disk usage.

Data-pipeline state needs no saving: pipelines are pure functions of
(seed, step) (see `repro_torch.data.pipeline`).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch._tensor import DeviceLike

__all__ = ["save", "save_async", "restore", "latest_step", "CheckpointManager"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node):
    """(key, child) pairs of an inner node of a tree, or None for a leaf."""
    if isinstance(node, nn.Module):
        return list(node.state_dict(keep_vars=True).items())
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    return None


def _flatten(tree, prefix: str = "") -> dict:
    """path -> tensor leaf, in tree order."""
    kids = _children(tree)
    if kids is None:
        if not isinstance(tree, torch.Tensor):
            raise TypeError(f"checkpoint leaf {prefix or '<root>'} is a "
                            f"{type(tree).__name__}, not a tensor")
        return {prefix: tree}
    out = {}
    for k, v in kids:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def _to_host(named: dict) -> tuple[dict, dict]:
    """(arrays for the npz, the manifest's keys): a copy on the host of
    every leaf (a CPU tensor is copied too: training goes on updating it
    in place), bfloat16 as its uint16 bits."""
    arrays, keys = {}, {}
    for k, t in named.items():
        t = t.detach().to("cpu", copy=True)
        keys[k] = {"shape": list(t.shape), "dtype": str(t.dtype)[6:]}
        arrays[k] = (t.view(torch.int16).numpy().view(np.uint16)
                     if t.dtype == torch.bfloat16 else t.numpy())
    return arrays, keys


def _write(ckpt_dir: str, step: int, arrays: dict, keys: dict,
           keep_last: int) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "keys": keys}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep_last)
    return final


def save(ckpt_dir: str, step: int, tree, *, keep_last: int = 3) -> str:
    """Write ``tree`` as step ``step``; returns the checkpoint's path."""
    arrays, keys = _to_host(_flatten(tree))
    return _write(ckpt_dir, step, arrays, keys, keep_last)


def save_async(ckpt_dir: str, step: int, tree, *, keep_last: int = 3
               ) -> threading.Thread:
    """Copy to the host synchronously, write on a background thread."""
    arrays, keys = _to_host(_flatten(tree))
    t = threading.Thread(target=_write, daemon=True,
                         args=(ckpt_dir, step, arrays, keys, keep_last))
    t.start()
    return t


def _gc(ckpt_dir: str, keep_last: int):
    steps = sorted(
        d for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _load(data, keys: dict, k: str, like: torch.Tensor,
          device: DeviceLike) -> torch.Tensor:
    arr = data[k]
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint key {k}: shape {arr.shape}, the "
                         f"tree expects {tuple(like.shape)}")
    if keys[k]["dtype"] == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device if device is None else device,
                dtype=like.dtype)


def restore(ckpt_dir: str, step: int, tree_like, *,
            device: DeviceLike = None):
    """Restore step ``step`` into the structure of ``tree_like`` (see the
    module docstring: tensors new, modules loaded in place)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        keys = json.load(f)["keys"]
    with np.load(os.path.join(path, "arrays.npz")) as data:

        def build(node, prefix):
            if isinstance(node, nn.Module):
                if device is not None:
                    node.to(device)
                own = node.state_dict(keep_vars=True)
                with torch.no_grad():
                    for name, t in own.items():
                        k = f"{prefix}/{name}" if prefix else name
                        t.copy_(_load(data, keys, k, t, t.device))
                return node
            kids = _children(node)
            if kids is None:
                return _load(data, keys, prefix, node, device)
            vals = [build(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in kids]
            if isinstance(node, dict):
                return dict(zip(node.keys(), vals))
            return type(node)(*vals)                    # a NamedTuple
        return build(tree_like, "")


class CheckpointManager:
    """Every-N-steps async checkpointing with restart discovery."""

    def __init__(self, ckpt_dir: str, *, every: int = 100,
                 keep_last: int = 3):
        self.dir = ckpt_dir
        self.every = every
        self.keep_last = keep_last
        self._pending: Optional[threading.Thread] = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def maybe_save(self, step: int, tree):
        if step % self.every != 0:
            return
        self.wait()
        self._pending = save_async(self.dir, step, tree,
                                   keep_last=self.keep_last)

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def restore_latest(self, tree_like, *, device: DeviceLike = None):
        step = latest_step(self.dir)
        if step is None:
            return None, None
        return step, restore(self.dir, step, tree_like, device=device)
