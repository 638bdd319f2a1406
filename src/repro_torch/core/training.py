"""Backtrack training — Algorithm 2 of the paper — plus the joint-loss
baseline (BranchyNet-style): the counterpart of the JAX package's
``core/training.py``.

BT(M, T, n_e):
  1. optimize Θ_conv ∪ θ_fc_{n_m−1} with L(out_{n_m−1}) for 1.25·n_e epochs
  2. for m = 0 … n_m−2: optimize θ_fc_m with L(out_m) for n_e epochs

Phases are realized with *trainability masks* over the parameter tree fed
to the optimizer (:mod:`repro_torch.optim`): the mask zeroes the updates
(and momentum writes) of frozen leaves.  A mask here is a tree of Python
bools (the reference's holds 0-d bool arrays, for its jitted step).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from repro_torch.models.nn import tree_leaves, tree_unflatten
from repro_torch.parallel import tensor_parallel
from repro_torch.utils import path_str, tree_flatten_with_path


@dataclasses.dataclass(frozen=True)
class Phase:
    name: str
    loss_head: int          # which exit's loss to optimize (-1 = last)
    epochs: float           # multiplier on n_e
    train_backbone: bool
    train_heads: Tuple[int, ...]  # exit-head indices receiving updates


def backtrack_training_plan(n_components: int) -> List[Phase]:
    """The paper's Algorithm 2 as a phase list."""
    phases = [Phase("backbone+last", loss_head=n_components - 1,
                    epochs=1.25, train_backbone=True, train_heads=())]
    for m in range(n_components - 1):
        phases.append(Phase(f"head{m}", loss_head=m, epochs=1.0,
                            train_backbone=False, train_heads=(m,)))
    return phases


def _is_exit_leaf(path: str) -> Tuple[bool, int]:
    parts = path.split("/")
    if "exits" in parts:
        i = parts.index("exits")
        return True, int(parts[i + 1])
    return False, -1


def trainability_mask(params, phase: Phase):
    """Bool tree (the LLM cascade's layout): True where the optimizer may
    update in this phase.  Exit head m trains in the phases that name it;
    everything else — the final norm and head included, which train with
    the backbone (Algorithm 2, line 1) — in the backbone phase."""
    flags = []
    for path, _ in tree_flatten_with_path(params):
        is_exit, idx = _is_exit_leaf(path_str(path))
        flags.append(idx in phase.train_heads if is_exit
                     else phase.train_backbone)
    return tree_unflatten(params, flags)


def cross_entropy(logits, labels):
    """Mean CE in float32.  logits (..., C); labels integer (...)."""
    logz = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logz, -1, labels.long()[..., None])[..., 0]
    return -torch.mean(ll)


class _VocabParallelCE(torch.autograd.Function):
    """Mean CE in f32 over logits sharded by vocab across ``axis``: rank r
    holds columns [r·Vr, (r + 1)·Vr).  The row max is all-reduced (max),
    then Σ exp and the label's logit (from the rank whose slice holds it,
    0 elsewhere) in one all-reduce (sum): two collectives, no logits
    moved.  The backward writes softmax − one-hot on this rank's slice,
    with no collective."""

    @staticmethod
    def forward(ctx, logits, labels, t, axis):
        x = logits.float()
        Vr = x.shape[-1]
        m = t.all_reduce(x.amax(-1), axis, "max")
        e = torch.exp(x - m[..., None])
        idx = labels.long() - t.rank(axis) * Vr
        hold = (idx >= 0) & (idx < Vr)
        idx = idx.clamp(0, Vr - 1)
        picked = torch.where(hold, torch.gather(x, -1, idx[..., None])[..., 0],
                             torch.zeros_like(m))
        sums = t.all_reduce(torch.stack([e.sum(-1), picked]), axis)
        s, picked = sums[0], sums[1]
        loss = -torch.mean(picked - m - torch.log(s))
        ctx.save_for_backward(e, s, idx, hold)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        e, s, idx, hold = ctx.saved_tensors
        p = e / s[..., None]
        p.scatter_add_(-1, idx[..., None], -hold.float()[..., None])
        p.mul_(g / s.numel())
        return p.to(ctx.dtype), None, None, None


def vocab_parallel_cross_entropy(logits, labels, t, axis: str = "model"):
    """:func:`cross_entropy` of the whole logits, from this rank's vocab
    slice ``logits`` (..., V / R) of a vocab sharded over ``axis``."""
    return _VocabParallelCE.apply(logits, labels, t, axis)


def l2_loss(params, coef: float):
    """The paper regularizes with an L2 loss, coefficient 1e-4: the sum of
    squares (in float32) of the floating leaves with ndim >= 2."""
    leaves = list(tree_leaves(params))
    acc = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    if not coef:
        return acc
    for leaf in leaves:
        if leaf.is_floating_point() and leaf.dim() >= 2:
            acc = acc + torch.sum(torch.square(leaf.float()))
    return coef * acc


def cascade_loss(exit_logits: Sequence[torch.Tensor], labels, mode: str,
                 head: int = -1, joint_weights: Sequence[float] = (),
                 aux=None, aux_coef: float = 0.0):
    """Loss over cascade exits.

    mode "single": L(out_head) — used by every BT phase (Algorithm 2).
    mode "joint":  Σ_m w_m · L(out_m) / Σ_m w_m — the BranchyNet baseline
                   the paper contrasts with.

    Under a ``model`` axis (a tensor-parallel transport active) the logits
    are each rank's vocab slice (``CascadeModel.forward_train``) and every
    exit's loss is :func:`vocab_parallel_cross_entropy`.
    """
    tp = tensor_parallel()

    def _ce(lg, y):
        # intermediate exits may be position-strided (exit_loss_stride)
        if lg.dim() == y.dim() + 1 and lg.shape[-2] != y.shape[-1]:
            stride = y.shape[-1] // lg.shape[-2]
            y = y[..., ::stride]
        if tp is not None:
            return vocab_parallel_cross_entropy(lg, y, tp)
        return cross_entropy(lg, y)

    if mode == "single":
        loss = _ce(exit_logits[head], labels)
    elif mode == "joint":
        n = len(exit_logits)
        w = list(joint_weights) or [1.0] * n
        loss = sum(wi * _ce(lg, labels)
                   for wi, lg in zip(w, exit_logits)) / sum(w)
    else:
        raise ValueError(mode)
    if aux is not None and aux_coef:
        loss = loss + aux_coef * aux
    return loss
