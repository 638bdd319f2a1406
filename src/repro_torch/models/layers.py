"""Core transformer layers: norms, RoPE, GQA/SWA attention (full / chunked /
decode), and MLPs — the counterpart of the JAX package's
``models/layers.py`` for the dense family.

All attention paths take a ``kpos`` vector giving the *absolute position*
of each key slot (-1 ⇒ empty slot), which uniformly encodes causal,
sliding-window and ring-buffer masking: key j is visible to the query at
position t iff ``0 <= kpos[j] <= t`` and ``kpos[j] > t - window`` (when
window > 0).
"""
from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F

from repro_torch.parallel import (copy_to, gather_from, reduce_from,
                                 tensor_parallel)
from repro_torch.models import nn

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x, weight, eps: float = 1e-5):
    """The non-kernel norm: casts to x's dtype BEFORE multiplying by the
    weight (the kernel multiplies in f32 first — the two round differently
    below f32, and each route mirrors its own reference)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * weight


def layernorm(x, weight, bias, eps: float = 1e-5):
    """Mean and variance in f32 (the variance the mean of squared
    deviations, as ``jnp.var``), cast to x's dtype before the affine."""
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mean), dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * weight + bias


def norm_init(gen, cfg, dim=None):
    d = dim or cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"w": nn.ones_init(gen, (d,))}
    return {"w": nn.ones_init(gen, (d,)), "b": nn.zeros_init(gen, (d,))}


def norm_apply(params, cfg, x):
    """Layernorm when the norm has a bias (plain ops: the reference has no
    layernorm kernel either), else rmsnorm — the kernel with
    ``use_kernels``."""
    if "b" in params:
        return layernorm(x, params["w"].to(x.dtype), params["b"].to(x.dtype),
                         cfg.norm_eps)
    if cfg.use_kernels:
        from repro_torch.kernels.ops import rmsnorm_fused
        return rmsnorm_fused(x, params["w"], eps=cfg.norm_eps)
    return rmsnorm(x, params["w"].to(x.dtype), cfg.norm_eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    angles = positions[..., None].float() * freqs             # (..., S, hd/2)
    angles = angles[..., None, :]                             # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention parameters
# ---------------------------------------------------------------------------

def attn_init(gen, cfg, *, cross: bool = False, d_model: int | None = None):
    """One attention sublayer's weights; with ``cross`` also the scalar
    tanh ``gate`` of llama-3.2-vision's gated cross-attention, zero (f32,
    cast with the other float leaves by the model's init)."""
    d = d_model or cfg.d_model
    hd = cfg.resolved_head_dim
    p = {
        "wq": nn.dense_init(gen, (d, cfg.n_heads * hd)),
        "wk": nn.dense_init(gen, (d, cfg.n_kv_heads * hd)),
        "wv": nn.dense_init(gen, (d, cfg.n_kv_heads * hd)),
        "wo": nn.dense_init(gen, (cfg.n_heads * hd, d)),
        "norm": norm_init(gen, cfg, d),
    }
    if cfg.qkv_bias:
        p["bq"] = nn.zeros_init(gen, (cfg.n_heads * hd,))
        p["bk"] = nn.zeros_init(gen, (cfg.n_kv_heads * hd,))
        p["bv"] = nn.zeros_init(gen, (cfg.n_kv_heads * hd,))
    if cross:
        p["gate"] = nn.zeros_init(gen, ())
    return p


def qkv_project(params, cfg, x, *, rope_positions=None):
    """Project x -> (q, k, v) with head reshape and optional RoPE."""
    hd = cfg.resolved_head_dim
    q = x @ params["wq"].to(x.dtype)
    k = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    B, S = x.shape[0], x.shape[1]
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if rope_positions is not None:
        q = apply_rope(q, rope_positions, cfg.rope_theta)
        k = apply_rope(k, rope_positions, cfg.rope_theta)
    return q, k, v


def _local_bias(b, cols: int, tp):
    """This rank's slice of a 1-D bias of a column-parallel projection with
    ``cols`` local columns: the shard rules replicate 1-D leaves, so each
    rank takes the columns its weight shard holds.  In training each rank's
    gradient covers its columns only: :func:`copy_to` sums it over
    ``model``."""
    if b.shape[-1] == cols:
        return b
    r = tp.rank("model")
    return copy_to(tp, b)[r * cols:(r + 1) * cols]


def kv_gather(tp, k, v):
    """The column shards of K and V ((B, S, c) each, this rank's columns)
    gathered over ``model`` in rank order in one collective: the whole (B,
    S, KV * hd) K and V, as every rank's replicated KV cache holds them.
    In training its backward reduce-scatters: a rank's heads read only
    their KV group, so each rank's gradient of the whole K / V is
    partial."""
    kv = gather_from(tp, torch.stack([k, v]), "model")   # (M, 2, B, S, c)
    B, S = k.shape[0], k.shape[1]
    full = kv.permute(1, 2, 3, 0, 4).reshape(2, B, S, -1)
    return full[0], full[1]


def kv_group(cfg, n_local_heads: int, tp):
    """The KV heads [lo, lo + n) this rank's query heads read (GQA): its
    q heads [r·Hl, (r + 1)·Hl) map to KV head h // (H / KV)."""
    qpk = cfg.n_heads // cfg.n_kv_heads
    lo = tp.rank("model") * n_local_heads // qpk
    return lo, max(1, n_local_heads // qpk)


def qkv_project_tp(params, cfg, x, tp, *, rope_positions=None, bias=True):
    """:func:`qkv_project` over column shards of wq / wk / wv (the serve1d
    layout): q on this rank's heads; K and V gathered whole over ``model``
    BEFORE RoPE (a shard of wk may end inside a head), so that every rank
    writes the same replicated cache.  ``bias=False`` drops the q/k/v
    biases (the backfill's projection, as in the reference).  In training
    x's gradient, partial on each rank, is all-reduced (:func:`copy_to`)."""
    hd = cfg.resolved_head_dim
    x = copy_to(tp, x)
    q = x @ params["wq"].to(x.dtype)
    k = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    if bias and "bq" in params:
        q = q + _local_bias(params["bq"], q.shape[-1], tp).to(x.dtype)
        k = k + _local_bias(params["bk"], k.shape[-1], tp).to(x.dtype)
        v = v + _local_bias(params["bv"], v.shape[-1], tp).to(x.dtype)
    k, v = kv_gather(tp, k, v)
    B, S = x.shape[0], x.shape[1]
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if rope_positions is not None:
        q = apply_rope(q, rope_positions, cfg.rope_theta)
        k = apply_rope(k, rope_positions, cfg.rope_theta)
    return q, k, v


def row_parallel(tp, y):
    """The all-reduce (sum over ``model``, in rank order) that completes a
    row-parallel product's partial sums; ``y`` as it is without one.  Its
    backward passes the gradient through (:func:`reduce_from`)."""
    return reduce_from(tp, y, "model")


# ---------------------------------------------------------------------------
# Attention cores
# ---------------------------------------------------------------------------

def _atleast_2d(x):
    return x if x.dim() >= 2 else x[None]


def _mask(qpos, kpos, window, causal):
    qp = _atleast_2d(qpos)[..., :, None]                 # (B?, Sq, 1)
    kp = _atleast_2d(kpos)[..., None, :]                 # (B?, 1, Sk)
    m = kp >= 0
    if causal:
        m = m & (kp <= qp)
    if window:
        m = m & (kp > qp - window)
    return m


def attend_full(q, k, v, qpos, kpos, window: int = 0, causal: bool = True):
    """Plain softmax attention.  q: (B,Sq,H,hd); k,v: (B,Sk,KV,hd).
    Scores in f32 (the inputs upcast exactly), probabilities cast to v's
    dtype for the weighted sum, as the reference does."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qh = q.reshape(B, Sq, KV, H // KV, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qh.float(), k.float())
    scores = scores / math.sqrt(hd)
    mask = _mask(qpos, kpos, window, causal)             # (B?, Sq, Sk)
    mask = mask.expand((B,) + mask.shape[-2:])[:, None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, hd)


def _online_step(qh, kj, vj, qpj, kpj, window, causal, acc, m, l):
    """One KV chunk of the online softmax: qh (B, Sq, KV, qpk, hd) f32
    against kj / vj (B, C, KV, hd) at key positions kpj (B, C); returns
    the updated (acc, m, l)."""
    hd = qh.shape[-1]
    s = torch.einsum("bqkgh,bskh->bqkgs", qh, kj.float()) / math.sqrt(hd)
    msk = _mask(qpj, kpj, window, causal)
    s = torch.where(msk[:, :, None, None, :], s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + torch.sum(p, dim=-1)
    acc = acc * corr[..., None] + torch.einsum(
        "bqkgs,bskh->bqkgh", p.to(vj.dtype), vj).float()
    return acc, m_new, l


def _pad_keys(k, v, kpos, chunk):
    """K / V padded along the sequence to a multiple of ``chunk``, the
    padding's key positions -1 (never visible); kpos comes back 2-D."""
    kpos = _atleast_2d(kpos)
    pad = -k.shape[1] % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kpos = F.pad(kpos, (0, pad), value=-1)
    return k, v, kpos


def _softmax_state(B, Sq, KV, qpk, hd, device):
    return (torch.zeros((B, Sq, KV, qpk, hd), dtype=torch.float32,
                        device=device),
            torch.full((B, Sq, KV, qpk), NEG_INF, dtype=torch.float32,
                       device=device),
            torch.zeros((B, Sq, KV, qpk), dtype=torch.float32,
                        device=device))


def attend_chunked(q, k, v, qpos, kpos, window: int = 0, causal: bool = True,
                   chunk: int = 1024):
    """Online-softmax attention over KV chunks (memory O(S·chunk))."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    k, v, kpos = _pad_keys(k, v, kpos, chunk)
    Sk = k.shape[1]
    qpk = H // KV
    qh = q.reshape(B, Sq, KV, qpk, hd).float()
    kpos = kpos.expand(B, Sk)
    acc, m, l = _softmax_state(B, Sq, KV, qpk, hd, q.device)
    for c0 in range(0, Sk, chunk):
        acc, m, l = _online_step(qh, k[:, c0:c0 + chunk], v[:, c0:c0 + chunk],
                                 qpos, kpos[:, c0:c0 + chunk], window, causal,
                                 acc, m, l)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def attend_decode(q, k_cache, v_cache, t, kpos, window: int = 0):
    """Single-token attention.  q: (B,1,H,hd); caches: (B,W,KV,hd);
    t: the current absolute position (a 0-d int32 tensor, or an int);
    kpos: (W,) or (B,W)."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    k_cache = k_cache.to(q.dtype)
    v_cache = v_cache.to(q.dtype)
    qh = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qh.float(),
                     k_cache.float()) / math.sqrt(hd)
    kp = _atleast_2d(kpos)
    m = (kp >= 0) & (kp <= t)
    if window:
        m = m & (kp > t - window)
    m = m.expand(B, k_cache.shape[1])
    s = torch.where(m[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, hd)


def _visible_chunks(qpos, kpos, nq, qchunk, nk, kchunk, window):
    """Each query chunk's KV-chunk range [lo, hi) (host ints): the chunks
    that hold a key some query of the chunk may see.  Each query chunk's
    position range and each KV chunk's range of written positions are
    read in one device-to-host copy for the whole call, and a chunk is
    visible when its positions meet the queries' causal (and window)
    band — the reference's ``hi = max(qpos) // kchunk + 1``,
    ``lo = max(min(qpos) - window + 1, 0) // kchunk`` (0 without a
    window) wherever keys sit at positions 0, 1, …"""
    B = qpos.shape[0]
    qc = qpos.reshape(B, nq, qchunk)
    kc = kpos.reshape(B, nk, kchunk)
    big = torch.iinfo(torch.int64).max // 4
    valid = kc >= 0
    ranges = torch.cat([
        qc.amin(dim=(0, 2)).long(), qc.amax(dim=(0, 2)).long(),
        torch.where(valid, kc.long(), big).amin(dim=(0, 2)),
        torch.where(valid, kc.long(), -big).amax(dim=(0, 2))]).tolist()
    qmin, qmax = ranges[:nq], ranges[nq:2 * nq]
    kmin, kmax = ranges[2 * nq:2 * nq + nk], ranges[2 * nq + nk:]
    out = []
    for j in range(nq):
        seen = [i for i in range(nk) if kmin[i] <= qmax[j] and (
            not window or kmax[i] > qmin[j] - window)]
        out.append((seen[0], seen[-1] + 1) if seen else (0, 0))
    return out


def attend_chunked_2d(q, k, v, qpos, kpos, window: int = 0,
                      causal: bool = True, qchunk: int = 512,
                      kchunk: int = 1024, causal_skip: bool = True):
    """Query-and-key chunked attention: for each query chunk, the online
    softmax over KV chunks.  Transient scores are O(B·H·qchunk·kchunk),
    independent of S.  Falls back to :func:`attend_chunked` when Sq is
    not a multiple of ``qchunk``, as the reference does.

    ``causal_skip`` (with ``causal``): each query chunk runs only the KV
    chunks inside its causal / window band (:func:`_visible_chunks`), so
    chunks every key of which is masked are never computed — about half
    the FLOPs of the masked-only loop at long S.  Without it every chunk
    runs.  The bounds are host ints: qpos's and kpos's ranges are read
    once for the whole call, never once per chunk."""
    B, Sq, H, hd = q.shape
    if Sq % qchunk != 0:
        return attend_chunked(q, k, v, qpos, kpos, window, causal,
                              chunk=kchunk)
    KV = k.shape[2]
    k, v, kpos = _pad_keys(k, v, kpos, kchunk)
    Sk = k.shape[1]
    nq, nk = Sq // qchunk, Sk // kchunk
    qpk = H // KV
    qpos = _atleast_2d(qpos).expand(B, Sq)
    kpos = kpos.expand(B, Sk)
    if causal_skip and causal:
        bounds = _visible_chunks(qpos, kpos, nq, qchunk, nk, kchunk, window)
    else:
        bounds = [(0, nk)] * nq
    outs = []
    for j, (lo, hi) in enumerate(bounds):
        qs = slice(j * qchunk, (j + 1) * qchunk)
        qh = q[:, qs].reshape(B, qchunk, KV, qpk, hd).float()
        acc, m, l = _softmax_state(B, qchunk, KV, qpk, hd, q.device)
        for i in range(lo, hi):
            ks = slice(i * kchunk, (i + 1) * kchunk)
            acc, m, l = _online_step(qh, k[:, ks], v[:, ks], qpos[:, qs],
                                     kpos[:, ks], window, causal, acc, m, l)
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.reshape(B, qchunk, H, hd).to(q.dtype))
    return torch.cat(outs, dim=1)


def pick_attend(cfg, Sq, Sk, differentiable: bool = False):
    """Choose the attention path by sequence size, as the reference does:
    Sq, Sk >= 4096 the query-and-key chunked path (its causal chunk skip
    off when ``differentiable``, as in the reference, whose skip needs a
    traced loop bound), Sk >= 2048 the KV-chunked one, else the plain
    one."""
    if Sq >= 4096 and Sk >= 4096:
        return partial(attend_chunked_2d, causal_skip=not differentiable,
                       qchunk=cfg.attn_qchunk, kchunk=cfg.attn_kchunk)
    if Sk >= 2048:
        return partial(attend_chunked, chunk=cfg.attn_kchunk)
    return attend_full


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_init(gen, cfg, d_ff: int | None = None, d_model: int | None = None):
    d = d_model or cfg.d_model
    ff = d_ff or cfg.d_ff
    p = {"w_up": nn.dense_init(gen, (d, ff)),
         "w_down": nn.dense_init(gen, (ff, d)),
         "norm": norm_init(gen, cfg, d)}
    if cfg.act == "swiglu":
        p["w_gate"] = nn.dense_init(gen, (d, ff))
    return p


def mlp_apply(params, cfg, x):
    """The MLP; over the serve1d shards (w_up / w_gate by column, w_down
    by row) its output is completed by an all-reduce over ``model`` (and
    in training x's gradient too)."""
    tp = tensor_parallel()
    x = copy_to(tp, x)
    up = x @ params["w_up"].to(x.dtype)
    if "w_gate" in params:
        gate = x @ params["w_gate"].to(x.dtype)
        h = F.silu(gate) * up
    else:
        h = F.gelu(up, approximate="tanh")   # jax.nn.gelu's default
    return row_parallel(tp, h @ params["w_down"].to(x.dtype))
