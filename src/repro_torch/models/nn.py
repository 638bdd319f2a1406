"""Parameter-initialization helpers over explicit ``torch.Generator``s.

The same distributions as the JAX package's ``models/nn.py``; the numbers
differ (a torch generator is not a JAX key), so tests that compare the two
packages bridge one set of weights instead of drawing twice.  Values are
drawn in float32 on the generator's device, then cast.
"""
from __future__ import annotations

import math
from typing import Callable

import torch


def dense_init(gen: torch.Generator, shape, dtype=torch.float32,
               scale: float | None = None):
    """He/Lecun style fan-in init: N(0, sqrt(scale / fan_in)).  ``scale``
    defaults to 1.0 (lecun) for transformer weights."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = math.sqrt((scale if scale is not None else 1.0) / max(1, fan_in))
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * std).to(dtype)


def zeros_init(gen: torch.Generator, shape, dtype=torch.float32):
    return torch.zeros(tuple(shape), dtype=dtype, device=gen.device)


def ones_init(gen: torch.Generator, shape, dtype=torch.float32):
    return torch.ones(tuple(shape), dtype=dtype, device=gen.device)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32):
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * 0.02).to(dtype)


def stack_init(init_fn: Callable, gen: torch.Generator, n: int):
    """Initialize ``n`` identical blocks, each leaf stacked on axis 0.

    The stacked leaves are allocated once and filled layer by layer, so a
    stage never exists twice (as a list of ``n`` layers and their stack):
    a stage of a model that fills the card must fit beside the others
    once.  ``init_fn`` is called ``n`` times in layer order, so the values
    are those of stacking ``n`` calls."""
    first = init_fn(gen)
    out = tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), first)
    _fill_layer(out, first, 0)
    del first
    for i in range(1, n):
        _fill_layer(out, init_fn(gen), i)
    return out


def _fill_layer(stacked, layer, i: int) -> None:
    if isinstance(stacked, dict):
        for k, v in stacked.items():
            _fill_layer(v, layer[k], i)
    else:
        stacked[i].copy_(layer)


def tree_index(tree, i: int):
    """Layer ``i`` of a stacked parameter or cache tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    return tree[i]


def tree_leaves(tree):
    """Every tensor leaf of nested dicts/lists, in order (None skipped)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    elif tree is not None:
        yield tree


def tree_unflatten(like, leaves):
    """A tree of the structure of ``like`` holding ``leaves``, in
    :func:`tree_leaves` order (None stays None)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_map(fn, tree):
    """``fn`` over every tensor leaf of nested dicts/lists (None kept)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)
