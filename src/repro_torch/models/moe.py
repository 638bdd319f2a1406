"""Mixture-of-Experts layer: top-k router + capacity-based GShard dispatch.

The counterpart of the JAX package's ``models/moe.py``, with the same
semantics and names.  Tokens are routed in groups of ``GROUP_TOKENS``
(the last one padded with zero rows); each expert has ``capacity(...)``
slots a group; a (slot, token) pair takes its place in its expert's queue
slot-major (every token's first choice before any token's second), and a
pair past the capacity is dropped.  Every expert computes all its slots,
filled or not (the GShard formulation), as a batched matmul over experts.

The reference dispatches and combines with one-hot (T, E, C) einsums.
Here both are index operations with the same results:

* dispatch gathers each (expert, slot)'s token row, a zero row for an
  empty slot — bit-equal to the one-hot einsum, since a slot holds at
  most one token;
* combine sums each token's kept outputs x gate over its k choices in
  slot order, in f32, rounded once to the activation dtype (the einsum's
  f32 accumulation).  No float atomics: the sum's order is fixed, so a
  run on the card repeats its bits.

Nothing here reads a device value to the host and no shape depends on the
data, so the layer runs inside a captured CUDA graph and its IF-node
bodies.

Router load-balance auxiliary loss (Switch/GShard):
``aux = E * Σ_e f_e · p_e`` with f the fraction of (token, choice) pairs
routed to e before the capacity cut and p the mean router probability of
e, averaged over the groups.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import nn
from repro_torch.models.layers import norm_init

# routing-group size: bounds the (G, E, C) slot tables; read at call time
GROUP_TOKENS = 4096


def moe_init(gen, cfg):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": nn.dense_init(gen, (d, E)),
        "w_gate": nn.dense_init(gen, (E, d, ff)),
        "w_up": nn.dense_init(gen, (E, d, ff)),
        "w_down": nn.dense_init(gen, (E, ff, d)),
        "norm": norm_init(gen, cfg, d),
    }


def capacity(n_tokens: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    c = int(math.ceil(top_k * n_tokens / n_experts * capacity_factor))
    return max(4, c)


class Routing(NamedTuple):
    """One routing of (..., T) tokens over E experts of C slots each.

    slot_token  (..., E, C) int64: the token in each expert slot, T for
                an empty slot (the zero row the dispatch appends).
    choice_slot (..., T, k) int64: the flat slot ``e * C + pos`` of each
                of a token's choices, in slot order; 0 where dropped.
    gates       (..., T, k) f32: the renormalised gate of each choice,
                0 where dropped.
    experts     (..., T, k) int64: the chosen experts, dropped or not.
    kept        (..., T, k) bool: the choices that found a slot.
    aux         (...) f32: the load-balance loss of each group.
    """
    slot_token: torch.Tensor
    choice_slot: torch.Tensor
    gates: torch.Tensor
    experts: torch.Tensor
    kept: torch.Tensor
    aux: torch.Tensor


def topk_first(probs, k: int):
    """The top ``k`` of ``probs`` along its last axis, the lower index
    first on ties (``lax.top_k``'s order): k rounds of ``argmax``, which
    returns the first maximum, each winner masked out.  Returns (values,
    indices), each (..., k)."""
    work = probs.clone()
    idx = []
    for _ in range(k):
        i = torch.argmax(work, dim=-1, keepdim=True)
        idx.append(i)
        work.scatter_(-1, i, float("-inf"))
    idx = torch.cat(idx, dim=-1)
    return torch.gather(probs, -1, idx), idx


def route_topk(router_logits, top_k: int, cap: int) -> Routing:
    """Route (..., T, E) router logits: softmax in f32, the top-k
    renormalised, each (slot, token) pair queued slot-major in its expert
    and dropped at ``pos >= cap``.  Leading axes are independent groups."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    _, gate_idx = topk_first(probs, top_k)                       # (..., T, k)
    return route_experts(probs, gate_idx, cap)


def route_experts(probs, gate_idx, cap: int) -> Routing:
    """Queue the chosen experts ``gate_idx`` (..., T, k) of router
    probabilities ``probs`` (..., T, E): the gates renormalised over the
    k choices, each (slot, token) pair placed slot-major then by token in
    its expert's queue, dropped at ``pos >= cap``."""
    *lead, T, E = probs.shape
    top_k = gate_idx.shape[-1]
    gate_vals = torch.gather(probs, -1, gate_idx)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # queue position of each pair, slot-major then token: (..., k*T)
    order = gate_idx.transpose(-1, -2).reshape(*lead, top_k * T)
    # one-hot by scatter (F.one_hot checks its values on the host)
    onehot = torch.zeros((*lead, top_k * T, E), dtype=torch.int32,
                         device=order.device).scatter_(-1, order[..., None],
                                                       1)         # (..., kT, E)
    before = torch.cumsum(onehot, dim=-2) - onehot
    pos = torch.gather(before, -1, order[..., None])[..., 0]
    keep = pos < cap
    flat = order * cap + pos
    # kept pairs own distinct slots; dropped ones write the trash slot
    # E*C, which is cut off before it is read
    tokens = torch.arange(T, device=order.device).repeat(top_k)
    slot_token = torch.full((*lead, E * cap + 1), T, dtype=torch.int64,
                            device=order.device)
    slot_token.scatter_(-1, torch.where(keep, flat, E * cap),
                        tokens.expand_as(flat).contiguous())
    slot_token = slot_token[..., :E * cap].reshape(*lead, E, cap)

    keep_tk = keep.reshape(*lead, top_k, T).transpose(-1, -2)
    choice_slot = torch.where(keep_tk, flat.reshape(*lead, top_k, T)
                              .transpose(-1, -2), 0)
    gates = torch.where(keep_tk, gate_vals, 0.0)

    frac_dispatch = onehot.sum(dim=-2).float() / T               # (..., E)
    frac_prob = probs.mean(dim=-2)
    aux = E * (frac_dispatch * frac_prob).sum(dim=-1)
    return Routing(slot_token, choice_slot.contiguous(), gates, gate_idx,
                   keep_tk, aux)


def expert_ffn(params, cfg, xe):
    """Every expert over its slots: (E, N, d) -> (E, N, d), swiglu (or
    gelu without a gate), batched over the experts."""
    dt = xe.dtype
    up = torch.bmm(xe, params["w_up"].to(dt))
    if cfg.act == "swiglu":
        h = F.silu(torch.bmm(xe, params["w_gate"].to(dt))) * up
    else:
        h = F.gelu(up, approximate="tanh")   # jax.nn.gelu's default
    return torch.bmm(h, params["w_down"].to(dt))


def moe_apply(params, cfg, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss).

    Tokens are routed in groups of ``min(GROUP_TOKENS, B*S)``, the last
    padded with zero rows (a zero row's router logits are 0, so it picks
    experts 0..k-1 and queues before the real tokens' later choices, as in
    the reference)."""
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    Tg = min(GROUP_TOKENS, T)
    pad = (-T) % Tg
    xt = x.reshape(T, d)
    if pad:
        xt = torch.cat([xt, xt.new_zeros(pad, d)])
    G = xt.shape[0] // Tg
    xg = xt.reshape(G, Tg, d)
    logits = xg @ params["router"].to(x.dtype)
    cap = capacity(Tg, E, k, cfg.capacity_factor)
    r = route_topk(logits, k, cap)

    # dispatch: each slot's token row (the appended zero row when empty)
    xz = torch.cat([xg, xg.new_zeros(G, 1, d)], dim=1)
    xe = torch.gather(xz, 1, r.slot_token.reshape(G, E * cap, 1)
                      .expand(G, E * cap, d))
    xe = xe.reshape(G, E, cap, d).transpose(0, 1).reshape(E, G * cap, d)
    ye = expert_ffn(params, cfg, xe)
    ye = ye.reshape(E, G, cap, d).transpose(0, 1).reshape(G, E * cap, d)

    # combine: Σ_j gate_j · out[slot_j] over the k choices, in f32
    g = r.gates.to(x.dtype).float()
    out = None
    for j in range(k):
        idx = r.choice_slot[..., j:j + 1].expand(G, Tg, d)
        term = g[..., j:j + 1] * torch.gather(ye, 1, idx).float()
        out = term if out is None else out + term
    out = out.to(x.dtype).reshape(G * Tg, d)[:T]
    return out.reshape(B, S, d), r.aux.mean().float()
