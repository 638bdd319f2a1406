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
    """
    def _ce(lg, y):
        # intermediate exits may be position-strided (exit_loss_stride)
        if lg.dim() == y.dim() + 1 and lg.shape[-2] != y.shape[-1]:
            stride = y.shape[-1] // lg.shape[-2]
            y = y[..., ::stride]
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
