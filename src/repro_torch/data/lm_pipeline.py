"""Synthetic language-model token stream.

A numpy copy of ``SyntheticLMStream`` in the JAX package's
``data/lm_pipeline.py``: a deterministic, offline token stream whose
next-token distribution has learnable structure *and* per-position
difficulty variation (so cascade exits are exercised end to end).  Tokens
come from a small random Markov chain over the vocabulary: runs of
high-probability transitions (easy positions) interleaved with
uniform-noise segments (hard positions).  The same seed gives the same
batches bit for bit.

``shard_batch`` (placing a batch on a device mesh) comes with the mesh
slice of the port and is refused by name.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


class SyntheticLMStream:
    """Markov-chain token stream: ``next = argmax-ish(P[cur])`` with noise."""

    def __init__(self, vocab_size: int, seq_len: int, batch_size: int,
                 branch: int = 4, easy_frac: float = 0.7, seed: int = 0):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.easy_frac = easy_frac
        rng = np.random.default_rng(seed)
        # sparse transition table: each token has `branch` likely successors,
        # chosen with a skewed distribution so easy positions are genuinely
        # predictable (the per-position difficulty the cascade exploits)
        self.next_tok = rng.integers(
            0, vocab_size, size=(vocab_size, branch)).astype(np.int64)
        p = 0.15 ** np.arange(branch)   # [0.85, 0.13, 0.02, …] after norm
        self.branch_p = p / p.sum()
        self._rng = rng

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        r = self._rng
        b, s, v = self.batch_size, self.seq_len, self.vocab_size
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = r.integers(0, v, b)
        easy = r.random((b, s)) < self.easy_frac
        choice = r.choice(self.next_tok.shape[1], size=(b, s),
                          p=self.branch_p)
        rand_tok = r.integers(0, v, (b, s))
        for t in range(s):
            markov = self.next_tok[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(easy[:, t], markov, rand_tok[:, t])
        return toks[:, :-1], toks[:, 1:]  # inputs, labels


def shard_batch(batch, mesh, batch_axes=("data",)):
    """Place a batch (a tree of numpy arrays or tensors) on ``mesh``, each
    leaf's batch dim (dim 0) sharded over ``batch_axes``: a tree of
    DTensors on the mesh's device type (see
    :func:`repro_torch.launch.shard_rules.place`)."""
    import torch
    from repro_torch.launch.shard_rules import P, map_with_path, place
    axes = tuple(batch_axes)
    entry = axes[0] if len(axes) == 1 else axes

    def tensor(_, x):
        return torch.as_tensor(x).to(mesh.device_type)

    batch = map_with_path(tensor, batch)
    specs = map_with_path(
        lambda _, x: P(entry, *([None] * (x.dim() - 1))), batch)
    return place(mesh, batch, specs)
