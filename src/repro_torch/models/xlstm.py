"""xLSTM blocks [arXiv:2405.04517]: mLSTM (matrix memory, chunkwise
parallel) and sLSTM (scalar memory, sequential scan).

The counterpart of the JAX package's ``models/xlstm.py``.  The mLSTM
full-sequence forward is the chunkwise form: within a chunk an
attention-like product under a masked, stabilised decay matrix, across
chunks a Python loop carrying the stabilised (C, n, m) state, where the
reference scans.  The sLSTM prefill is a Python loop over the sequence of
the one-step cell (the reference's ``lax.scan``); decode is the one-step
recurrence of each.

Recurrences (stabilised, per head; q scaled by 1/sqrt(p)):
    m_t = max(f̃_t + m_{t-1}, ĩ_t)
    C_t = e^{f̃_t + m_{t-1} - m_t} C_{t-1} + e^{ĩ_t - m_t} k_t v_tᵀ
    n_t = e^{f̃_t + m_{t-1} - m_t} n_{t-1} + e^{ĩ_t - m_t} k_t
    h_t = (q_tᵀ C_t) / max(|q_tᵀ n_t|, e^{-m_t})

Cache layout (per layer), every leaf a STATE leaf (a decode step rewrites
it whole): mLSTM ``C`` (B, h, p, p), ``n`` (B, h, p) and ``m`` (B, h) in
f32 whatever the model dtype, and ``conv`` (B, CONV_W - 1, d_inner), the
rolling input window, in the model dtype; sLSTM ``state``, a dict of
``c``, ``h``, ``m`` and ``n``, each (B, d) f32.  The keys are in the
reference's leaf order (sorted), so the two packages' flattened caches
line up.  The stabilisers start at sentinels, not zero: mLSTM's ``m`` at
-1e30 (``exp(-m)`` is then inf until a write lands, and the readout 0),
sLSTM's at -30.  Caches are written in place into the tensors the block
was given, so a cohort's view of a slab and a captured graph's fixed
addresses see the new state.

Dtypes follow the reference op by op: with a bf16 model every float
parameter is bf16 (``CascadeModel.init`` casts every float leaf) and is
promoted against the f32 operands where the reference's JAX promotes it
(the conv taps and bias, the gate projections ``w_i`` / ``w_f`` and
biases, sLSTM's recurrent matrices ``r`` and bias).  ``gelu`` is the tanh
approximation (``jax.nn.gelu``'s default), written out as its formula.
The einsums are written as batched matmuls over (batch, head); the outer
product k vᵀ, which sums nothing, is a broadcast multiply.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import nn
from repro_torch.models.layers import norm_init, rmsnorm

CONV_W = 4
M_INIT_MLSTM = -1e30
M_INIT_SLSTM = -30.0


def mlstm_dims(cfg):
    d_inner = 2 * cfg.d_model          # pre-up-projection factor 2
    n_heads = cfg.n_heads
    p = d_inner // n_heads
    return d_inner, n_heads, p


def mlstm_init(gen, cfg):
    """One mLSTM layer's parameters (the reference's distributions)."""
    d = cfg.d_model
    d_inner, h, _ = mlstm_dims(cfg)
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "up_proj": nn.dense_init(gen, (d, 2 * d_inner)),   # -> (u, z)
        "conv_w": torch.randn((CONV_W, d_inner), generator=gen, **f32)
        * (1.0 / math.sqrt(CONV_W)),
        "conv_b": torch.zeros((d_inner,), **f32),
        "wq": nn.dense_init(gen, (d_inner, d_inner)),
        "wk": nn.dense_init(gen, (d_inner, d_inner)),
        "wv": nn.dense_init(gen, (d_inner, d_inner)),
        "w_i": nn.dense_init(gen, (d_inner, h)),
        "w_f": nn.dense_init(gen, (d_inner, h)),
        "b_i": torch.zeros((h,), **f32),
        "b_f": torch.full((h,), 3.0, **f32),    # forget-gate bias init
        "out_norm_w": torch.ones((d_inner,), **f32),
        "down_proj": nn.dense_init(gen, (d_inner, d)),
        "norm": norm_init(gen, cfg, d),
    }


def _gates(params, c):
    """The input and forget gates' pre-activations (B, ..., h), in f32:
    ``c`` promoted, the projections and biases promoted to it."""
    c32 = c.float()
    i_pre = c32 @ params["w_i"].float() + params["b_i"].float()
    f_pre = c32 @ params["w_f"].float() + params["b_f"].float()
    return i_pre, f_pre


def _mlstm_qkvif(params, cfg, u, conv_cache=None):
    """u: (B, S, d_inner) -> q, k, v (B, S, h, p) in u's dtype, the i and
    f pre-activations (B, S, h) f32, and the new conv window."""
    d_inner, h, p = mlstm_dims(cfg)
    B, S, _ = u.shape
    if conv_cache is None:
        padc = u.new_zeros((B, CONV_W - 1, d_inner))
    else:
        padc = conv_cache.to(u.dtype)
    up = torch.cat([padc, u], dim=1)
    c = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for i in range(CONV_W):
        c = c + params["conv_w"][i].float() * up[:, i:i + S].float()
    c = F.silu(c + params["conv_b"].float()).to(u.dtype)
    new_conv = up[:, up.shape[1] - (CONV_W - 1):]
    q = (c @ params["wq"].to(u.dtype)).reshape(B, S, h, p)
    k = (c @ params["wk"].to(u.dtype)).reshape(B, S, h, p)
    v = (u @ params["wv"].to(u.dtype)).reshape(B, S, h, p)
    i_pre, f_pre = _gates(params, c)
    return q, k, v, i_pre, f_pre, new_conv


def mlstm_chunked(q, k, v, i_pre, f_pre, chunk: int, init=None):
    """Chunkwise stabilised mLSTM.  q, k, v: (B, S, h, p); i_pre, f_pre:
    (B, S, h) f32; ``init`` a (C, n, m) state or None (zeros, m at its
    sentinel).  Returns (hidden (B, S, h, p) in q's dtype, (C, n, m) the
    final state, f32)."""
    B, S, h, p = q.shape
    assert S % chunk == 0, (S, chunk)
    scale = 1.0 / math.sqrt(p)
    dev = q.device
    logf = F.logsigmoid(f_pre).transpose(1, 2)            # (B, h, S)
    ih = i_pre.transpose(1, 2)
    qf = (q.float() * scale).transpose(1, 2)              # (B, h, S, p)
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    if init is None:
        C = torch.zeros((B, h, p, p), dtype=torch.float32, device=dev)
        n = torch.zeros((B, h, p), dtype=torch.float32, device=dev)
        m = torch.full((B, h), M_INIT_MLSTM, dtype=torch.float32,
                       device=dev)
    else:
        C, n, m = init
    upper = ~torch.ones((chunk, chunk), dtype=torch.bool, device=dev).tril()
    hs = []
    for c0 in range(0, S, chunk):
        qj, kj, vj = (x[:, :, c0:c0 + chunk] for x in (qf, kf, vf))
        ij = ih[:, :, c0:c0 + chunk]                      # (B, h, Q)
        b = torch.cumsum(logf[:, :, c0:c0 + chunk], dim=-1)
        # per-step stabiliser: m_t = max(m_prev + b_t, max_{s<=t}(b_t -
        # b_s + i_s)).  Mask BEFORE the exponent: where(mask, exp(g), 0)
        # would propagate NaN through the backward.
        g = b[..., :, None] - b[..., None, :] + ij[..., None, :]  # [t, s]
        g = g.masked_fill(upper, float("-inf"))
        m_intra = g.amax(dim=-1)                          # (B, h, Q)
        m_t = torch.maximum(m[..., None] + b, m_intra)
        D = torch.exp(g - m_t[..., None])                 # (B, h, t, s)
        # intra-chunk attention-like term and its normaliser
        intra = ((qj @ kj.transpose(-1, -2)) * D) @ vj    # (B, h, t, p)
        n_intra = D @ kj
        # inter-chunk, from the carried state
        w_prev = torch.exp(m[..., None] + b - m_t)        # (B, h, Q)
        inter = (qj @ C) * w_prev[..., None]
        qn_inter = n[:, :, None, :] * w_prev[..., None]
        n_vec = n_intra + qn_inter
        qn = (qj * n_vec).sum(-1)
        denom = torch.maximum(qn.abs(), torch.exp(-m_t))
        hs.append((intra + inter) / denom[..., None])
        # the carry at the end of the chunk
        b_last = b[..., -1]                               # (B, h)
        m_new = m_t[..., -1]
        wC = torch.exp(m + b_last - m_new)
        s_w = torch.exp(b_last[..., None] - b + ij - m_new[..., None])
        C = wC[..., None, None] * C \
            + (kj * s_w[..., None]).transpose(-1, -2) @ vj
        n = wC[..., None] * n + (s_w[..., None, :] @ kj)[..., 0, :]
        m = m_new
    hidden = (torch.cat(hs, dim=2) if len(hs) > 1 else hs[0]).transpose(1, 2)
    return hidden.to(q.dtype), (C, n, m)


def _mlstm_full_recurrence(params, cfg, x, cache):
    """The full-sequence path up to the chunkwise scan: (z, hidden (B, S,
    h, p), the new conv window, the final (C, n, m))."""
    d_inner = mlstm_dims(cfg)[0]
    S = x.shape[1]
    uz = x @ params["up_proj"].to(x.dtype)
    u, z = uz[..., :d_inner], uz[..., d_inner:]
    conv_cache = cache["conv"] if cache is not None else None
    q, k, v, i_pre, f_pre, new_conv = _mlstm_qkvif(params, cfg, u,
                                                   conv_cache)
    init = (cache["C"], cache["n"], cache["m"]) if cache is not None \
        else None
    chunk = min(256, S)
    if S % chunk:
        # pad to a chunk multiple: i = -1e30 writes nothing and f = 1e3
        # decays by exactly 1, so each padded step is the identity
        pad = chunk - S % chunk
        hid, state = mlstm_chunked(
            *(F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v)),
            F.pad(i_pre, (0, 0, 0, pad), value=-1e30),
            F.pad(f_pre, (0, 0, 0, pad), value=1e3), chunk, init)
        hid = hid[:, :S]
    else:
        hid, state = mlstm_chunked(q, k, v, i_pre, f_pre, chunk, init)
    return z, hid, new_conv, state


def _mlstm_out(params, cfg, x, hid, z):
    """The plain rmsnorm over d_inner (never the kernel: the reference's
    block calls ``rmsnorm``, not ``norm_apply``), the silu(z) gate, then
    the down projection."""
    hid = rmsnorm(hid, params["out_norm_w"].to(hid.dtype), cfg.norm_eps)
    return (hid * F.silu(z)) @ params["down_proj"].to(x.dtype)


def _mlstm_write(cache, new_conv, state):
    C, n, m = state
    cache["conv"].copy_(new_conv.to(cache["conv"].dtype))
    cache["C"].copy_(C)
    cache["n"].copy_(n)
    cache["m"].copy_(m)
    return cache


def mlstm_forward_full(params, cfg, x, cache=None):
    """Full-sequence mLSTM sublayer (residual + norm handled by the
    caller).  Returns (y (B, S, d), the cache rewritten in place — None
    without one)."""
    d_inner = mlstm_dims(cfg)[0]
    B, S, _ = x.shape
    z, hid, new_conv, state = _mlstm_full_recurrence(params, cfg, x, cache)
    out = _mlstm_out(params, cfg, x, hid.reshape(B, S, d_inner), z)
    if cache is not None:
        _mlstm_write(cache, new_conv, state)
    return out, cache


def mlstm_backfill_full(params, cfg, x, cache):
    """The full-sequence recurrence for the cache only: no out norm, gate
    or down projection."""
    _, _, new_conv, state = _mlstm_full_recurrence(params, cfg, x, cache)
    return _mlstm_write(cache, new_conv, state)


def _mlstm_decode_recurrence(params, cfg, x, cache, readout: bool):
    """One step of the conv window and the recurrence, the state written
    in place.  Returns (z, q (B, h, p) f32 scaled — None without
    ``readout``, the new m); C and n are the cache's, already new."""
    d_inner, h, p = mlstm_dims(cfg)
    B = x.shape[0]
    uz = x[:, 0] @ params["up_proj"].to(x.dtype)
    u, z = uz[..., :d_inner], uz[..., d_inner:]
    window = torch.cat([cache["conv"].to(x.dtype), u[:, None, :]], dim=1)
    c = (window.float() * params["conv_w"].float()).sum(1)
    c = F.silu(c + params["conv_b"].float()).to(x.dtype)
    q = None
    if readout:
        q = (c @ params["wq"].to(x.dtype)).reshape(B, h, p).float() \
            * (1.0 / math.sqrt(p))
    k = (c @ params["wk"].to(x.dtype)).reshape(B, h, p).float()
    v = (u @ params["wv"].to(x.dtype)).reshape(B, h, p).float()
    i_pre, f_pre = _gates(params, c)                      # (B, h)
    logf = F.logsigmoid(f_pre)
    C, n, m = cache["C"], cache["n"], cache["m"]
    m_new = torch.maximum(logf + m, i_pre)
    wf = torch.exp(logf + m - m_new)[:, :, None]
    wi = torch.exp(i_pre - m_new)[:, :, None]
    # C <- wf C + wi (k vᵀ), in place, in the reference's rounding order
    C.mul_(wf[..., None]).add_(wi[..., None] * (k[..., :, None]
                                                * v[..., None, :]))
    n.copy_(wf * n + wi * k)
    m.copy_(m_new)
    cache["conv"].copy_(window[:, 1:].to(cache["conv"].dtype))
    return z, q, m_new


def mlstm_decode_step(params, cfg, x, cache):
    """x: (B, 1, d) single-token recurrent update.  Returns (out (B, 1,
    d), the cache rewritten in place)."""
    d_inner = mlstm_dims(cfg)[0]
    B = x.shape[0]
    z, q, m_new = _mlstm_decode_recurrence(params, cfg, x, cache, True)
    hid_num = (q[:, :, None, :] @ cache["C"])[:, :, 0]   # (B, h, p)
    qn = (q * cache["n"]).sum(-1)
    denom = torch.maximum(qn.abs(), torch.exp(-m_new))
    hid = (hid_num / denom[..., None]).reshape(B, d_inner).to(x.dtype)
    return _mlstm_out(params, cfg, x, hid, z)[:, None], cache


def mlstm_backfill_step(params, cfg, x, cache):
    """The decode step's state update alone: no q, readout or output."""
    _mlstm_decode_recurrence(params, cfg, x, cache, False)
    return cache


def mlstm_init_cache(cfg, batch: int, dtype, device):
    d_inner, h, p = mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, h, p, p), **f32),
            "conv": torch.zeros((batch, CONV_W - 1, d_inner), dtype=dtype,
                                device=device),
            "m": torch.full((batch, h), M_INIT_MLSTM, **f32),
            "n": torch.zeros((batch, h, p), **f32)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(gen, cfg):
    """One sLSTM layer's parameters (the reference's distributions)."""
    d = cfg.d_model
    h = cfg.n_heads
    p = d // h
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        # fused input projections for (z, i, f, o)
        "w_in": nn.dense_init(gen, (d, 4 * d)),
        # head-wise recurrent matrices for (z, i, f, o): (4, h, p, p)
        "r": torch.randn((4, h, p, p), generator=gen, **f32)
        * (1.0 / math.sqrt(p)),
        "b": torch.cat([torch.zeros((2 * d,), **f32),
                        torch.full((d,), 3.0, **f32),
                        torch.zeros((d,), **f32)]),
        # post-up-projection MLP (factor 4/3, GeLU) per the xLSTM paper
        "w_up": nn.dense_init(gen, (d, (4 * d) // 3)),
        "w_dn": nn.dense_init(gen, ((4 * d) // 3, d)),
        "norm": norm_init(gen, cfg, d),
    }


def _slstm_cell(params, cfg, xt, state):
    """One timestep.  xt: (B, 4d) pre-projected input, f32; state: dict of
    (B, d) f32.  Returns the new state dict (new tensors)."""
    d = cfg.d_model
    h = cfg.n_heads
    p = d // h
    B = xt.shape[0]
    c, n, m, hprev = state["c"], state["n"], state["m"], state["h"]
    # "bhp,khpq->kbhq": per gate k and head, (B, p) @ (p, q)
    hh = hprev.reshape(B, h, p).transpose(0, 1)           # (h, B, p)
    rec = (hh[None] @ params["r"].float()).transpose(1, 2).reshape(4, B, d)
    xt4 = xt.reshape(B, 4, d).transpose(0, 1)             # (4, B, d)
    pre = xt4 + rec + params["b"].float().reshape(4, d)[:, None, :]
    z_pre, i_pre, f_pre, o_pre = pre[0], pre[1], pre[2], pre[3]
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + m, i_pre)
    i_ = torch.exp(i_pre - m_new)
    f_ = torch.exp(logf + m - m_new)
    c_new = f_ * c + i_ * z
    n_new = f_ * n + i_
    h_new = o * c_new / torch.clamp_min(n_new, 1e-6)
    return {"c": c_new, "h": h_new, "m": m_new, "n": n_new}


def _slstm_write(cache, state):
    for k, x in cache["state"].items():
        x.copy_(state[k])
    return cache


def _slstm_scan(params, cfg, x, cache):
    """The sequential scan over x's positions: (hs (B, S, d) f32, the final
    state).  A Python loop over S of the cell, nothing read to the host;
    the recurrent matrices and bias promoted to f32 once, not a step."""
    B, S, _ = x.shape
    xt = (x @ params["w_in"].to(x.dtype)).float()
    state = cache["state"] if cache is not None \
        else slstm_zero_state(cfg, B, x.device)
    cell_params = {"r": params["r"].float(), "b": params["b"].float()}
    hs = []
    for s in range(S):
        state = _slstm_cell(cell_params, cfg, xt[:, s], state)
        hs.append(state["h"])
    return torch.stack(hs, dim=1), state


def _gelu_tanh(x):
    """``jax.nn.gelu``'s default, the tanh approximation, in its formula.
    Elementwise ops only: ``F.gelu(approximate="tanh")``'s CPU kernel
    rounds a vector's tail elements otherwise than its body, so a row
    would round differently in a batch of 2 than in one of 4 (the port
    holds select mode's per-cohort steps to cond_batch's whole-batch ones
    bit for bit)."""
    c = math.sqrt(2.0 / math.pi)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x)))))


def _slstm_out(params, x, hid):
    """The post-up-projection MLP: tanh-approximated GeLU."""
    up = _gelu_tanh(hid @ params["w_up"].to(x.dtype))
    return up @ params["w_dn"].to(x.dtype)


def slstm_forward_full(params, cfg, x, cache=None):
    """Full-sequence sLSTM sublayer.  Returns (y (B, S, d), the cache
    rewritten in place — None without one)."""
    hs, state = _slstm_scan(params, cfg, x, cache)
    out = _slstm_out(params, x, hs.to(x.dtype))
    if cache is not None:
        _slstm_write(cache, state)
    return out, cache


def slstm_backfill_full(params, cfg, x, cache):
    """The scan for the cache only: no up / down projection."""
    return _slstm_write(cache, _slstm_scan(params, cfg, x, cache)[1])


def _slstm_step_state(params, cfg, x, cache):
    xt = (x[:, 0] @ params["w_in"].to(x.dtype)).float()
    return _slstm_cell(params, cfg, xt, cache["state"])


def slstm_decode_step(params, cfg, x, cache):
    """x: (B, 1, d).  Returns (out (B, 1, d), the cache rewritten in
    place)."""
    state = _slstm_step_state(params, cfg, x, cache)
    out = _slstm_out(params, x, state["h"].to(x.dtype)[:, None, :])
    return out, _slstm_write(cache, state)


def slstm_backfill_step(params, cfg, x, cache):
    """The decode step's state update alone: no up / down projection."""
    return _slstm_write(cache, _slstm_step_state(params, cfg, x, cache))


def slstm_zero_state(cfg, batch: int, device=None):
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, d), **f32),
            "h": torch.zeros((batch, d), **f32),
            "m": torch.full((batch, d), M_INIT_SLSTM, **f32),
            "n": torch.zeros((batch, d), **f32)}


def slstm_init_cache(cfg, batch: int, dtype, device):
    del dtype
    return {"state": slstm_zero_state(cfg, batch, device)}
