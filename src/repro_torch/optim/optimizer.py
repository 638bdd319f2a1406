"""Optimizers as (init, update) pairs over parameter trees — the
counterparts of the JAX package's ``optim/optimizer.py``.

* ``sgd_momentum`` — the paper trains CI-ResNet with SGD (+momentum 0.9,
  L2 1e-4 folded into the loss per the paper).
* ``adamw`` — for the LLM cascade's training step.

An :class:`Optimizer` carries ``init(params) -> state`` and
``update(grads, state, params, step, mask=None) -> (updates, state)``; the
caller applies the updates with :func:`apply_updates`.  A trainability
mask (a tree of bools, the structure of params) serves the paper's
backtrack training, where phase m freezes everything but head m: a masked
leaf gets a zero update and keeps its moments.

The semantics are the reference's leaf for leaf: SGD's weight decay is
added to the gradients; AdamW's is decoupled, inside the update; the
moments keep the params' dtype; AdamW's ``count`` steps for every leaf.
The arithmetic is PyTorch's: the moments are updated in place (the state
returned is the state given, written), under ``torch.no_grad``, with
``torch._foreach_*`` over the leaves a mask leaves trainable.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List

import torch

from repro_torch.models.nn import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.schedule import constant_schedule

Schedule = Callable[[int], float]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params, step, mask=None)


def _leaves(tree) -> List:
    return list(tree_leaves(tree))


def _trainable(mask, n: int) -> List[bool]:
    if mask is None:
        return [True] * n
    on = [bool(m) for m in _leaves(mask)]
    if len(on) != n:
        raise ValueError(f"mask has {len(on)} leaves for {n} parameters")
    return on


def _lr_fn(lr) -> Schedule:
    return lr if callable(lr) else constant_schedule(lr)


def _zeros_tree(params):
    return tree_map(torch.zeros_like, params)


def sgd_momentum(lr: Schedule | float, momentum: float = 0.9,
                 nesterov: bool = False,
                 weight_decay: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"mu": _zeros_tree(params)}

    @torch.no_grad()
    def update(grads, state, params, step, mask=None):
        g, p, mu = _leaves(grads), _leaves(params), _leaves(state["mu"])
        on = _trainable(mask, len(g))
        idx = [i for i in range(len(g)) if on[i]]
        updates = [None if on[i] else torch.zeros_like(g[i])
                   for i in range(len(g))]
        if idx:
            gs = [g[i] for i in idx]
            if weight_decay:
                gs = torch._foreach_add(gs, [p[i] for i in idx],
                                        alpha=weight_decay)
            mus = [mu[i] for i in idx]            # mu = momentum·mu + g
            torch._foreach_mul_(mus, momentum)
            torch._foreach_add_(mus, gs)
            upd = mus
            if nesterov:
                upd = torch._foreach_mul(mus, momentum)
                torch._foreach_add_(upd, gs)
            for i, u in zip(idx, torch._foreach_mul(upd, -lr_fn(step))):
                updates[i] = u
        return tree_unflatten(grads, updates), state

    return Optimizer(init=init, update=update)


def adamw(lr: Schedule | float, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        dev = _leaves(params)[0].device
        return {"m": _zeros_tree(params), "v": _zeros_tree(params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(grads, state, params, step, mask=None):
        g, p = _leaves(grads), _leaves(params)
        m, v = _leaves(state["m"]), _leaves(state["v"])
        on = _trainable(mask, len(g))
        idx = [i for i in range(len(g)) if on[i]]
        count = state["count"]
        count.add_(1)
        c = count.float()
        bc1 = 1 - torch.pow(torch.full_like(c, b1), c)
        bc2 = 1 - torch.pow(torch.full_like(c, b2), c)
        step_lr = lr_fn(step)
        updates = [None if on[i] else torch.zeros_like(g[i])
                   for i in range(len(g))]
        if idx:
            gs = [g[i] for i in idx]
            ms, vs = [m[i] for i in idx], [v[i] for i in idx]
            torch._foreach_mul_(ms, b1)           # m = b1·m + (1−b1)·g
            torch._foreach_add_(ms, gs, alpha=1 - b1)
            torch._foreach_mul_(vs, b2)           # v = b2·v + (1−b2)·g²
            torch._foreach_add_(vs, torch._foreach_mul(gs, gs),
                                alpha=1 - b2)
            for i in idx:
                # in float32 (a bf16 moment over the f32 bias correction
                # promotes there in the reference); the cast to the param
                # dtype is the one apply_updates would make
                den = (v[i].float() / bc2).sqrt_().add_(eps)
                u = (m[i].float() / bc1).div_(den)
                u.add_(p[i].float(), alpha=weight_decay).mul_(-step_lr)
                updates[i] = u.to(p[i].dtype)
        return tree_unflatten(grads, updates), state

    return Optimizer(init=init, update=update)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before).  The norm is summed in float32; each leaf keeps its dtype."""
    leaves = _leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda x: (x * scale).to(x.dtype), grads), gn


@torch.no_grad()
def apply_updates(params, updates):
    """``params + updates``, each update cast to its param's dtype, written
    into the params in place; returns the params."""
    for p, u in zip(_leaves(params), _leaves(updates)):
        p.add_(u.to(p.dtype))
    return params
