"""Mamba2 (SSD — state-space duality) block, in the chunked form.

The counterpart of the JAX package's ``models/ssm.py``.  The
full-sequence forward is the chunked SSD algorithm: within a chunk an
attention-like product (masked decay matrix times the C·B Gram matrix),
across chunks a Python loop carrying the (heads, head_dim, state)
recurrent state, where the reference scans.  Decode is the single-step
recurrence.  ngroups = 1 (B and C shared across heads), as in the Mamba2
paper's default.

Cache layout (per layer): ``conv`` (B, ssm_conv-1, conv_ch), the rolling
input window, in the model dtype; ``state`` (B, n_heads, head_dim,
ssm_state) in f32 whatever the model dtype.  Both are STATE leaves: a
decode step rewrites each whole (an attention ring's step writes one
slot).  They are written in place with ``copy_`` into the tensors the
block was given, so a cohort's view of a slab and a captured graph's
fixed addresses see the new state.

Dtypes follow the reference op by op: with a bf16 model the ``A_log``,
``D``, ``dt_bias`` and conv leaves are bf16 (``CascadeModel.init`` casts
every float leaf), ``A = -exp(A_log)`` is taken in bf16, and the conv,
``dt`` and the recurrence are promoted to f32.  The contractions are
written as batched matmuls over (batch, head), never a three-operand
einsum whose contraction order could materialise (B, Q, Q, h, p).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import nn
from repro_torch.models.layers import norm_init, rmsnorm


def dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    conv_ch = d_inner + 2 * cfg.ssm_state  # x, B, C share the conv
    return d_inner, n_heads, conv_ch


def ssm_init(gen, cfg):
    """One layer's parameters, drawn in the reference's order."""
    d = cfg.d_model
    d_inner, n_heads, conv_ch = dims(cfg)
    in_dim = 2 * d_inner + 2 * cfg.ssm_state + n_heads  # z, x, B, C, dt
    dev = gen.device
    in_proj = nn.dense_init(gen, (d, in_dim))
    conv_w = torch.randn((cfg.ssm_conv, conv_ch), generator=gen,
                         dtype=torch.float32, device=dev) \
        * (1.0 / math.sqrt(cfg.ssm_conv))
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((n_heads,), generator=gen, dtype=torch.float32,
                   device=dev) * (hi - lo) + lo
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_ch,), dtype=torch.float32, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads,
                                          dtype=torch.float32, device=dev)),
        "D": torch.ones((n_heads,), dtype=torch.float32, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))),
        "out_proj": nn.dense_init(gen, (d_inner, d)),
        "norm": norm_init(gen, cfg, d),
        "gate_norm_w": torch.ones((d_inner,), dtype=torch.float32,
                                  device=dev),
    }


def _split_in(cfg, zxbcdt):
    d_inner, _, _ = dims(cfg)
    n = cfg.ssm_state
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * n]
    dt = zxbcdt[..., 2 * d_inner + 2 * n:]
    return z, xBC, dt


def _softplus(x):
    """``jax.nn.softplus``'s formula (``logaddexp(x, 0)``)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _dt(params, dt_pre):
    """softplus(dt_pre + dt_bias), promoted to f32."""
    return _softplus(dt_pre.float() + params["dt_bias"])


def _causal_conv_full(xBC, conv_w, conv_b, conv_cache=None):
    """Depthwise causal conv over the sequence dim.  xBC: (B, S, C).
    Returns (silu(conv) in xBC's dtype, the new window (B, W-1, C))."""
    W = conv_w.shape[0]
    if conv_cache is None:
        pad = xBC.new_zeros((xBC.shape[0], W - 1, xBC.shape[2]))
    else:
        pad = conv_cache.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)                  # (B, S+W-1, C)
    S = xBC.shape[1]
    out = torch.zeros(xBC.shape, dtype=torch.float32, device=xBC.device)
    for i in range(W):
        out = out + conv_w[i].float() * xp[:, i:i + S].float()
    out = out + conv_b
    new_cache = xp[:, xp.shape[1] - (W - 1):]
    return F.silu(out).to(xBC.dtype), new_cache


def ssd_chunked(x, dt, A, Bmat, Cmat, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x: (B, S, h, p) — already the conv'd input path;
    dt: (B, S, h) — softplus'd;  A: (h,) negative;
    Bmat, Cmat: (B, S, n) (ngroups=1).
    Returns (y (B, S, h, p) in x's dtype, final_state (B, h, p, n) f32).
    """
    Bsz, S, h, p = x.shape
    n = Bmat.shape[-1]
    assert S % chunk == 0, (S, chunk)
    xd = (x * dt[..., None]).float()                   # dt-scaled input
    dA = (dt * A).float()                              # (B,S,h), negative
    Bf, Cf = Bmat.float(), Cmat.float()
    state = (torch.zeros((Bsz, h, p, n), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state.float())
    upper = ~torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    ys = []
    for c0 in range(0, S, chunk):
        xj = xd[:, c0:c0 + chunk]                      # (B,Q,h,p)
        Bj, Cj = Bf[:, c0:c0 + chunk], Cf[:, c0:c0 + chunk]
        a = torch.cumsum(dA[:, c0:c0 + chunk], dim=1)  # (B,Q,h)
        # intra-chunk: L[t,s] = exp(a_t - a_s) for s<=t.  Mask BEFORE exp:
        # the upper triangle holds large positive values (a is
        # decreasing), and where(mask, exp(seg), 0) propagates NaN
        # through the backward.
        seg = a[:, :, None, :] - a[:, None, :, :]      # (B,Q,Q,h) [b,t,s,h]
        L = torch.exp(seg.masked_fill(upper[None, :, :, None],
                                      float("-inf")))
        G = Cj @ Bj.transpose(1, 2)                    # (B,Q,Q) [b,t,s]
        xh = xj.permute(0, 2, 1, 3)                    # (B,h,Q,p)
        y = (G[:, None] * L.permute(0, 3, 1, 2)) @ xh  # (B,h,Q,p)
        # inter-chunk: the carried state read out by C, decayed
        decay_in = torch.exp(a).transpose(1, 2)        # (B,h,Q)
        y = y + (Cj[:, None] @ state.transpose(-1, -2)) * decay_in[..., None]
        # state' = exp(sum dA) * state + sum_s exp(a_Q - a_s) B_s x_s
        tot = a[:, -1:, :]                             # (B,1,h)
        decay_state = torch.exp(tot - a).transpose(1, 2)   # (B,h,Q)
        chunk_state = (xh * decay_state[..., None]).transpose(-1, -2) \
            @ Bj[:, None]                              # (B,h,p,n)
        state = torch.exp(tot[:, 0, :])[:, :, None, None] * state \
            + chunk_state
        ys.append(y.permute(0, 2, 1, 3))               # (B,Q,h,p)
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    return y.to(x.dtype), state


def _full_recurrence(params, cfg, x, cache):
    """The full-sequence path up to the SSD scan: (z, xin, y, new conv
    window, final state); y (B, S, h, p) before D and the gating."""
    d_inner, n_heads, _ = dims(cfg)
    p = cfg.ssm_head_dim
    B_, S, _ = x.shape
    zxbcdt = x @ params["in_proj"].to(x.dtype)
    z, xBC, dt_pre = _split_in(cfg, zxbcdt)
    conv_cache = cache["conv"] if cache is not None else None
    xBC, new_conv = _causal_conv_full(xBC, params["conv_w"],
                                      params["conv_b"], conv_cache)
    xin = xBC[..., :d_inner].reshape(B_, S, n_heads, p)
    Bmat = xBC[..., d_inner:d_inner + cfg.ssm_state]
    Cmat = xBC[..., d_inner + cfg.ssm_state:]
    dt = _dt(params, dt_pre)                           # (B,S,h)
    A = -torch.exp(params["A_log"])                    # (h,)
    init_state = cache["state"] if cache is not None else None
    chunk = min(cfg.ssm_chunk, S)
    if S % chunk:  # pad to a chunk multiple: dt = 0 makes each an identity
        pad = chunk - S % chunk
        y, state = ssd_chunked(F.pad(xin, (0, 0, 0, 0, 0, pad)),
                               F.pad(dt, (0, 0, 0, pad)), A,
                               F.pad(Bmat, (0, 0, 0, pad)),
                               F.pad(Cmat, (0, 0, 0, pad)), chunk,
                               init_state)
        y = y[:, :S]
    else:
        y, state = ssd_chunked(xin, dt, A, Bmat, Cmat, chunk, init_state)
    return z, xin, y, new_conv, state


def _write_cache(cache, new_conv, state):
    """Rewrite both state leaves whole, in place."""
    cache["conv"].copy_(new_conv.to(cache["conv"].dtype))
    cache["state"].copy_(state.to(cache["state"].dtype))
    return cache


def _gated_out(params, cfg, x, y, z):
    """The gated RMSNorm (Mamba2): norm(y * silu(z)) — the plain norm over
    d_inner — then out_proj."""
    y = rmsnorm(y * F.silu(z), params["gate_norm_w"].to(y.dtype),
                cfg.norm_eps)
    return y @ params["out_proj"].to(x.dtype)


def ssm_forward_full(params, cfg, x, cache=None):
    """Full-sequence Mamba2 sublayer (residual + norm handled by caller).

    Returns (y (B, S, d), cache) — the cache's conv window and SSD state
    rewritten in place (None without a cache)."""
    d_inner = dims(cfg)[0]
    B_, S, _ = x.shape
    z, xin, y, new_conv, state = _full_recurrence(params, cfg, x, cache)
    y = y + params["D"].to(y.dtype)[:, None] * xin
    out = _gated_out(params, cfg, x, y.reshape(B_, S, d_inner), z)
    if cache is not None:
        _write_cache(cache, new_conv, state)
    return out, cache


def ssm_backfill_full(params, cfg, x, cache):
    """The full-sequence recurrence for the cache only: no D term, gating
    or out_proj."""
    _, _, _, new_conv, state = _full_recurrence(params, cfg, x, cache)
    return _write_cache(cache, new_conv, state)


def _decode_recurrence(params, cfg, x, cache):
    """One step of the conv window and the recurrence: (z, xin f32 (B, h,
    p), C (B, n) f32, new window, new state f32)."""
    d_inner, n_heads, _ = dims(cfg)
    p = cfg.ssm_head_dim
    B_ = x.shape[0]
    zxbcdt = x[:, 0] @ params["in_proj"].to(x.dtype)
    z, xBC, dt_pre = _split_in(cfg, zxbcdt)
    # conv: rolling window
    window = torch.cat([cache["conv"].to(x.dtype), xBC[:, None, :]], dim=1)
    conv_out = (window.float() * params["conv_w"].float()).sum(1) \
        + params["conv_b"]
    xBC = F.silu(conv_out).to(x.dtype)
    new_conv = window[:, 1:]
    xin = xBC[..., :d_inner].reshape(B_, n_heads, p).float()
    Bmat = xBC[..., d_inner:d_inner + cfg.ssm_state].float()
    Cmat = xBC[..., d_inner + cfg.ssm_state:].float()
    dt = _dt(params, dt_pre)                           # (B,h)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt * A)                             # (B,h)
    dBx = (dt[:, :, None] * xin)[..., None] * Bmat[:, None, None, :]
    state = cache["state"].float() * dA[:, :, None, None] + dBx
    return z, xin, Cmat, new_conv, state


def ssm_decode_step(params, cfg, x, cache):
    """Single-token recurrence.  x: (B, 1, d).  Returns (out (B, 1, d),
    cache rewritten in place)."""
    d_inner = dims(cfg)[0]
    B_ = x.shape[0]
    z, xin, Cmat, new_conv, state = _decode_recurrence(params, cfg, x, cache)
    y = (state @ Cmat[:, None, :, None])[..., 0]       # (B,h,p)
    y = y + params["D"][:, None] * xin
    y = y.reshape(B_, d_inner).to(x.dtype)
    out = _gated_out(params, cfg, x, y, z)[:, None, :]
    _write_cache(cache, new_conv, state)
    return out, cache


def ssm_backfill_step(params, cfg, x, cache):
    """The decode step's cache update alone: no readout, gating or
    out_proj."""
    _, _, _, new_conv, state = _decode_recurrence(params, cfg, x, cache)
    return _write_cache(cache, new_conv, state)


def ssm_init_cache(cfg, batch: int, dtype, device):
    _, n_heads, conv_ch = dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, n_heads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=device),
    }
