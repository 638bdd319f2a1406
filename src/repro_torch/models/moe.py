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

On a mesh (:func:`moe_apply` under the active transport) a rank holds its
experts, or every expert's slice of d_ff, and one all-reduce over
``model`` completes the layer; a call whose rows are split over ``data``
ranks gathers its chosen experts over them, so that every rank queues the
whole call as one rank would.  Under autograd (the train step) the layer
is differentiable on the shards: the expert path's inputs go through
``parallel.copy_to`` and its completion through ``parallel.reduce_from``,
and a call split over ``data`` whose router needs a gradient gathers its
router probabilities too, so that its aux loss is the whole call's.

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

from repro_torch import parallel
from repro_torch.models import nn
from repro_torch.models.layers import norm_init
from repro_torch.parallel import tensor_parallel

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


def _queue(gate_idx, E: int, cap: int):
    """Each (slot, token) pair of the chosen experts ``gate_idx`` (..., T,
    k) placed slot-major then by token in its expert's queue and dropped
    at ``pos >= cap``: (slot_token (..., E, C), choice_slot (..., T, k),
    kept (..., T, k), the pairs' (..., kT, E) int32 one-hot)."""
    *lead, T, top_k = gate_idx.shape
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
    return slot_token, choice_slot.contiguous(), keep_tk, onehot


def _gates(probs, gate_idx):
    """The chosen experts' router probabilities renormalised over the k
    choices."""
    gate_vals = torch.gather(probs, -1, gate_idx)
    return gate_vals / gate_vals.sum(dim=-1, keepdim=True)


def _aux(probs, onehot):
    """The load-balance loss of each group from its router probabilities
    (..., T, E) and its pairs' one-hot (..., kT, E)."""
    E, T = probs.shape[-1], probs.shape[-2]
    frac_dispatch = onehot.sum(dim=-2).float() / T               # (..., E)
    return E * (frac_dispatch * probs.mean(dim=-2)).sum(dim=-1)


def route_experts(probs, gate_idx, cap: int) -> Routing:
    """Queue the chosen experts ``gate_idx`` (..., T, k) of router
    probabilities ``probs`` (..., T, E): the gates renormalised over the
    k choices, each (slot, token) pair placed slot-major then by token in
    its expert's queue, dropped at ``pos >= cap``."""
    slot_token, choice_slot, kept, onehot = _queue(gate_idx, probs.shape[-1],
                                                   cap)
    gates = torch.where(kept, _gates(probs, gate_idx), 0.0)
    return Routing(slot_token, choice_slot, gates, gate_idx, kept,
                   _aux(probs, onehot))


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


def _route_call(xt, router, cfg, t, rows: str):
    """Route the tokens of one call whose rows are split over the ranks of
    ``rows`` (an axis of transport ``t``): this rank holds ``xt`` (T_l,
    d), the call's T_l-token block at the rank's place in ``rows``' rank
    order.  The chosen experts of every rank's tokens are gathered (one
    all-gather of (T_l, k) int32), so that every rank queues the whole
    call — its groups, pad rows, capacity and queue positions — as one
    rank routing all its tokens would.  Returns (the call's slot_token
    (G, E, C), Tg, C, and this rank's tokens' choice_slot, kept, gates
    and experts (T_l, k) and aux).

    Where the router probabilities need a gradient (the train step)
    ``aux`` is the whole call's, the reference's: every rank's router
    probabilities gathered too (``parallel.gather_from``, whose backward
    reduce-scatters: each rank's probabilities take the sum of every
    rank's upstream gradient, which the train step's mean over ``data``
    divides back), the pad rows' uniform 1/E rows appended, the loss of
    each group averaged.  Elsewhere (serving, which reads no aux and
    whose params need no gradient, with grad mode on or off) it is the
    rank's own tokens' and costs no collective."""
    T_l = xt.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    T = t.size(rows) * T_l
    Tg = min(GROUP_TOKENS, T)
    pad = (-T) % Tg
    cap = capacity(Tg, E, k, cfg.capacity_factor)
    probs = torch.softmax((xt @ router.to(xt.dtype)).float(), dim=-1)
    _, idx = topk_first(probs, k)                                 # (T_l, k)
    whole = t.all_gather(idx.to(torch.int32), rows).reshape(T, k).long()
    if pad:
        # the zero pad rows' router logits are 0: experts 0..k-1
        whole = torch.cat([whole, torch.arange(k, device=xt.device)
                           .expand(pad, k)])
    G = whole.shape[0] // Tg
    slot_token, choice_slot, kept, onehot = _queue(whole.view(G, Tg, k), E,
                                                   cap)
    lo = t.rank(rows) * T_l
    choice_slot = choice_slot.reshape(G * Tg, k)[lo:lo + T_l]
    kept = kept.reshape(G * Tg, k)[lo:lo + T_l]
    if parallel.tracks(probs):
        p = parallel.gather_from(t, probs, rows).reshape(T, E)
        if pad:
            p = torch.cat([p, torch.softmax(p.new_zeros(pad, E), dim=-1)])
        aux = _aux(p.view(G, Tg, E), onehot).mean()
    else:
        own = torch.zeros((T_l * k, E), dtype=torch.int32,
                          device=xt.device).scatter_(-1, idx.view(-1, 1), 1)
        aux = _aux(probs, own)
    return (slot_token, Tg, cap, choice_slot, kept,
            torch.where(kept, _gates(probs, idx), 0.0), idx, aux)


def moe_apply(params, cfg, x, rows=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss).

    Tokens are routed in groups of ``min(GROUP_TOKENS, B*S)``, the last
    padded with zero rows (a zero row's router logits are 0, so it picks
    experts 0..k-1 and queues before the real tokens' later choices, as in
    the reference).

    Over the serve1d shards (the active transport's ``model`` axis of more
    than one rank, :func:`~repro_torch.parallel.tensor_parallel`) the
    router is replicated and every rank routes alike; a rank holds E/M
    experts (expert parallel, E a multiple of M) or every expert's d_ff/M
    columns of ``w_gate`` / ``w_up`` and rows of ``w_down`` (the
    fallback).  It computes its experts' slots (its partial products),
    combines them in f32 — a choice of another rank's expert adds 0 — and
    one all-reduce over ``model`` of that f32 sum completes the layer,
    rounded once to the activation dtype.  No all-to-all: the activations
    are replicated over ``model``.

    ``rows``: the axis of the active transport over whose ranks this
    call's rows are split (each rank a block of them, in rank order), or
    None when the rank's rows are the whole call.  The call is then routed
    as one (:func:`_route_call`): its capacity, groups, pad rows and queue
    positions are those of one rank routing every row, and the rank
    computes and combines its own rows; where the router needs a gradient
    (training) the aux loss is the whole call's (every rank's the same),
    elsewhere (serving) the rank's own tokens'.

    Under autograd on the shards the expert path's inputs — the rows it
    dispatches and the gates — go through ``parallel.copy_to`` (only this
    rank's experts consume them: their gradients are summed over
    ``model``) and the completion through ``parallel.reduce_from`` (the
    gradient passed to every rank as it is).  The router, its softmax and
    the aux are computed alike on every ``model`` rank from the replicated
    input, so their gradients are whole there and pass no collective."""
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(T, d)
    t = parallel.active() if rows is not None else None
    if t is None or t.size(rows) == 1:
        Tg = min(GROUP_TOKENS, T)
        pad = (-T) % Tg
        xg = xt if not pad else torch.cat([xt, xt.new_zeros(pad, d)])
        G = xg.shape[0] // Tg
        logits = xg.reshape(G, Tg, d) @ params["router"].to(x.dtype)
        cap = capacity(Tg, E, k, cfg.capacity_factor)
        r = route_topk(logits, k, cap)
        slot_token, lo = r.slot_token, 0
        choice_slot = r.choice_slot.reshape(G * Tg, k)[:T]
        kept = r.kept.reshape(G * Tg, k)[:T]
        gates, experts = r.gates.reshape(G * Tg, k)[:T], \
            r.experts.reshape(G * Tg, k)[:T]
        aux = r.aux.mean()
    else:
        slot_token, Tg, cap, choice_slot, kept, gates, experts, aux = \
            _route_call(xt, params["router"], cfg, t, rows)
        lo = t.rank(rows) * T

    # this rank's experts [e_lo, e_lo + E_l) and the groups its tokens
    # [lo, lo + T) of the call touch
    tp = tensor_parallel()
    E_l = params["w_up"].shape[0]
    e_lo = 0 if E_l == E else tp.rank("model") * E_l
    g_lo, g_hi = lo // Tg, (lo + T - 1) // Tg + 1
    sharded = tp is not None and (E_l != E
                                  or params["w_up"].shape[-1] != cfg.d_ff)
    xd = xt
    if sharded:
        xd, gates = parallel.copy_to(tp, xt), parallel.copy_to(tp, gates)

    # dispatch: each slot's token row (a zero row when the slot is empty
    # or holds another rank's token)
    st = slot_token[g_lo:g_hi, e_lo:e_lo + E_l]                 # (Gl, E_l, C)
    Gl = st.shape[0]
    q = st + (torch.arange(g_lo, g_hi, device=x.device) * Tg - lo
              ).view(Gl, 1, 1)
    src = torch.where((st < Tg) & (q >= 0) & (q < T), q, T)
    xz = torch.cat([xd, xd.new_zeros(1, d)])
    xe = xz[src.reshape(-1)].view(Gl, E_l, cap, d)
    xe = xe.transpose(0, 1).reshape(E_l, Gl * cap, d)
    ye = expert_ffn(params, cfg, xe)
    ye = ye.reshape(E_l, Gl, cap, d).transpose(0, 1).reshape(
        Gl * E_l * cap, d)

    # combine: Σ_j gate_j · out[slot_j] over the k choices, in f32; a
    # choice of another rank's expert (or a dropped one) adds 0
    g = gates.to(x.dtype).float()
    grp = (torch.arange(lo, lo + T, device=x.device) // Tg - g_lo)[:, None]
    local = kept & (experts >= e_lo) & (experts < e_lo + E_l)
    idx = torch.where(local, grp * (E_l * cap) + choice_slot - e_lo * cap, 0)
    out = None
    for j in range(k):
        term = g[:, j:j + 1] * ye[idx[:, j]].float()
        if E_l != E:
            term = torch.where(local[:, j:j + 1], term, 0.0)
        out = term if out is None else out + term
    if sharded:
        out = parallel.reduce_from(tp, out, "model")
    return out.to(x.dtype).reshape(B, S, d), aux.float()
