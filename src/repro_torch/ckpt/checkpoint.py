"""Flat-npz tree checkpointing — the counterpart of the JAX package's
``ckpt/checkpoint.py``, in the same format.

A checkpoint is a directory of ``step_<n>.npz`` files; each leaf of the
tree is stored under its slash-joined key path (``utils.path_str``, the
reference's keys: ``segments/0/0/attn/wq`` …), so restoration is
structure-checked and a checkpoint written by either package loads into
the other.  A bfloat16 leaf is stored as its raw two bytes (``|V2``, what
``np.savez`` writes for the reference's bfloat16 arrays) and read back
bit for bit, without ml_dtypes.  Atomic via write-to-temp + rename.
"""
from __future__ import annotations

import hashlib
import os
import re
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.nn import tree_unflatten
from repro_torch.utils import (numpy_to_tensor, path_str, tensor_to_numpy,
                               tree_flatten_with_path)

_INT_OF_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        a = tensor_to_numpy(leaf)
        # a bfloat16 leaf as its two raw bytes, as the reference's file
        return a.view("V2") if a.dtype.kind == "V" else a
    return np.asarray(leaf)


def _flatten(tree) -> dict:
    return {path_str(p): _to_host(leaf)
            for p, leaf in tree_flatten_with_path(tree)}


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)\.npz", f))]
    return max(steps) if steps else None


def _restore(arr: np.ndarray, leaf):
    if not isinstance(leaf, torch.Tensor):
        return arr.astype(np.asarray(leaf).dtype)
    if arr.dtype.kind == "V":           # a bfloat16 leaf's raw bytes
        t = numpy_to_tensor(arr, leaf.device)
        if leaf.dtype != torch.bfloat16:
            raise ValueError(f"a bfloat16 leaf for a {leaf.dtype} one")
        return t
    return numpy_to_tensor(arr, leaf.device).to(leaf.dtype)


def load_checkpoint(ckpt_dir: str, like: Any, step: Optional[int] = None
                    ) -> Any:
    """Restore into the structure of ``like`` (shape- and key-checked);
    each tensor leaf lands on ``like``'s device in its dtype."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with np.load(path) as data:
        stored = dict(data)
    leaves = []
    for path_keys, leaf in tree_flatten_with_path(like):
        key = path_str(path_keys)
        if key not in stored:
            raise KeyError(f"checkpoint {path} missing leaf {key}")
        arr = stored[key]
        if tuple(arr.shape) != tuple(np.shape(leaf)):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} "
                             f"vs model {tuple(np.shape(leaf))}")
        leaves.append(_restore(arr, leaf))
    return tree_unflatten(like, leaves)


@torch.no_grad()
def tree_digest(tree) -> str:
    """A digest of a tree of tensors — every leaf's key, shape, dtype and
    bits (two wrapping int64 sums of its bit patterns, computed on the
    leaf's device), in key order — to compare a checkpoint with the tree
    it came from without moving either to the host."""
    lines = []
    for path, leaf in tree_flatten_with_path(tree):
        bits = leaf.detach().reshape(-1).view(
            _INT_OF_SIZE[leaf.element_size()]).long()
        s1, s2 = int(bits.sum()), int((bits * bits).sum())
        lines.append(f"{path_str(path)}|{tuple(leaf.shape)}|{leaf.dtype}|"
                     f"{s1}|{s2}")
    # by key, so the dicts' insertion order does not matter
    return hashlib.sha256("\n".join(sorted(lines)).encode()).hexdigest()
