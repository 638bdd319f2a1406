"""Block kinds of the cascade backbone: the dense, moe, mamba,
attn_shared, mlstm, slstm, xattn, encdec and enc kinds (the dense, moe,
hybrid, ssm, vlm and audio families).

A block kind provides, as in the JAX package's ``models/blocks.py``:
  init(gen, cfg)                      -> params (one layer)
  apply(cfg, params, h, ctx, cache)   -> (h, cache, aux)
  init_cache(cfg, batch, W, dtype, device) -> per-layer cache dict
  backfill(cfg, params, h, ctx, cache)-> cache   (cascade state backfill:
        write this layer's KV / recurrent state from the early-exit hidden
        state WITHOUT computing the layer's output.)
and, the port's own, ``state_keys``: the names of its cache leaves that a
decode step rewrites WHOLE (a recurrent state, a rolling conv window); a
key that names a dict (sLSTM's ``state``) names every leaf beneath it;
and ``read_keys``: the names of its cache leaves that a decode step never
writes (an xattn layer's K/V and an encdec layer's ``cross`` K/V, written
by the prefill from the image tokens or the encoder's memory and only
read after).  Every other leaf is a RING leaf
(B, W, ...), written at ring slot ``t % W`` on axis 1 of a layer (axis 2
of a stage's stacked leaf).  The staged executor snapshots and lands a
step's writes by that three-way split (``core/exec.py``); it never
guesses it from shapes.

``ctx`` carries what is invariant across the layers of a step:
  mode: "full" | "decode"
  positions: (S,) absolute positions of the current tokens (full mode)
  write_slots: (W,) token index landing in each ring slot, -1 = none (full)
  t: 0-d int32 tensor, the current decode position; slot: 0-d int64
      tensor, its ring slot t % W (decode; both on the device, never read
      to the host, so a captured step reads them at every replay)
  kpos: (W,) absolute position of each KV slot (-1 empty), committed
  kpos_t: kpos with the current slot set to t (decode; what attention sees)
  live: (B,) bool per-slot exit mask, or None (decode)
  block_table: (B, nblk) int32 block-table rows of this segment (paged
      layout only; kpos is then the per-slot (B, W) ring)
  shared: the hybrid family's shared attention + MLP parameters (the
      'attn_shared' blocks' full-rank weights), or None
  cross: the memory cross-attention reads, (B, T, d) — the image
      embeddings or the audio encoder's output (full mode; None at
      decode, which reads the cross K/V cached at prefill)

Caches are written IN PLACE: where the reference returns updated arrays
(and donates the old buffers to the jitted step), the port writes the
ring slots of the very tensors it was given and returns them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from repro_torch.models import nn, ssm, xlstm
from repro_torch.parallel import tensor_parallel
from repro_torch.models.layers import (apply_rope, attend_decode,
                                       attend_full, attn_init, kv_gather,
                                       kv_group, mlp_apply, mlp_init,
                                       norm_apply, pick_attend, qkv_project,
                                       qkv_project_tp, row_parallel)
from repro_torch.models.moe import moe_apply, moe_init


@dataclasses.dataclass(frozen=True)
class BlockDef:
    init: Callable
    apply: Callable
    init_cache: Callable
    backfill: Callable
    state_keys: Tuple[str, ...] = ()
    read_keys: Tuple[str, ...] = ()


# ---------------------------------------------------------------------------
# attention cache helpers (ring buffer)
# ---------------------------------------------------------------------------

def attn_cache_init(cfg, batch, W, dtype, device):
    hd = cfg.resolved_head_dim
    shape = (batch, W, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _write_full(cache, k, v, gather_idx):
    """Fill ring slots from a full-sequence prefill.  gather_idx: (W,) —
    for each cache slot, the token index that lands in it (-1 = slot stays
    empty).  A gather per slot, written in place."""
    if cache is None:
        return None
    valid = gather_idx >= 0
    idx = gather_idx.clamp(min=0).long()
    sel = valid[None, :, None, None]
    for name, x in (("k", k), ("v", v)):
        c = cache[name]
        c.copy_(torch.where(sel, x[:, idx].to(c.dtype), c))
    return cache


def _slot_index(slot, device) -> torch.Tensor:
    """A ring slot as a 0-d int64 tensor on ``device`` (the carried device
    slot as it is; an int made into one)."""
    if isinstance(slot, torch.Tensor):
        return slot
    return torch.full((), int(slot), dtype=torch.int64, device=device)


def _write_decode(cache, k, v, slot):
    """Write one decode token's k/v ((B, 1, KV, hd)) at ring slot ``slot``
    (a 0-d int64 device tensor, or an int), in place (the reference's
    dynamic_update_slice on a donated buffer)."""
    idx = _slot_index(slot, k.device).view(1)
    cache["k"].index_copy_(1, idx, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, idx, v.to(cache["v"].dtype))
    return cache


# ---------------------------------------------------------------------------
# paged-layout variants (cache_layout="paged"): the per-layer cache leaf is a
# SHARED block store (num_blocks, block_size, kv, hd) addressed through the
# slot's block-table row ``table`` (B, nblk) — ring position p lives at
# (table[b, p // bs], p % bs).  Dead and uncovered rows point at the trash
# block 0: duplicate scatters there land in no fixed order, but the
# per-slot kpos ring masks those positions out of every read (masking, not
# zeroing, is the coherence mechanism).
# ---------------------------------------------------------------------------

def slot_rows(table, slot, bs: int):
    """The (block, offset) row of ring slot ``slot`` (0-d int64 device
    tensor, or an int) for every table row: two (B,) int64 index
    tensors."""
    slot = _slot_index(slot, table.device)
    phys = table.index_select(1, (slot // bs).view(1))[:, 0].long()
    return phys, (slot % bs).expand(phys.shape)


def _write_decode_paged(cache, k, v, slot, table):
    """One decode token through the block table, in place.  slot = t % W
    (a 0-d int64 device tensor, or an int); k/v (B, 1, kv, hd)."""
    rows = slot_rows(table, slot, cache["k"].shape[1])
    cache["k"].index_put_(rows, k[:, 0].to(cache["k"].dtype))
    cache["v"].index_put_(rows, v[:, 0].to(cache["v"].dtype))
    return cache


def _write_full_paged(cache, k, v, gather_idx, table):
    """Prefill fill through the block table: gather the current logical
    ring view, apply the same valid-masked merge as :func:`_write_full`,
    scatter whole table rows back in place."""
    if cache is None:
        return None
    B, nblk = table.shape
    idx_t = table.long()
    valid = gather_idx >= 0
    idx = gather_idx.clamp(min=0).long()
    sel = valid[None, :, None, None]
    for name, x in (("k", k), ("v", v)):
        store = cache[name]
        bs = store.shape[1]
        cur = store[idx_t].reshape((B, nblk * bs) + store.shape[2:])
        new = torch.where(sel, x[:, idx].to(store.dtype), cur)
        store[idx_t] = new.reshape((B, nblk, bs) + store.shape[2:])
    return cache


def _paged_kv_view(cache, table):
    """The slot-logical (B, W, kv, hd) ring views of a layer's paged k and
    v stores — the gather that makes the downstream plain attention
    identical to the dense layout's, and therefore bit-identical
    (re-tiling attention to block granularity would change its
    accumulation order).  The kernel route needs no view: decode
    attention's ``paged`` route reads the rows through the table in the
    dense route's tile order (``kernels/decode_attention.py``)."""
    B, nblk = table.shape
    idx = table.long()

    def view(store):
        return store[idx].reshape((B, nblk * store.shape[1]) + store.shape[2:])

    return view(cache["k"]), view(cache["v"])


def _self_attention(cfg, params, h, ctx, cache):
    """Self-attention sublayer for full and decode modes.

    Over the serve1d shards (a ``model`` axis of more than one rank,
    :func:`~repro_torch.parallel.tensor_parallel`) each rank
    projects q for its own heads and its columns of K and V, gathers K
    and V whole before RoPE (:func:`qkv_project_tp`) and writes the
    replicated cache whole; it attends with its heads over the KV heads
    of their group (a strided view of the cache, :func:`kv_group`), and
    the row-parallel ``wo`` product is completed by an all-reduce."""
    tp = tensor_parallel()
    x = norm_apply(params["norm"], cfg, h)

    def project(positions):
        if tp is None:
            return qkv_project(params, cfg, x, rope_positions=positions)
        return qkv_project_tp(params, cfg, x, tp, rope_positions=positions)

    def group(k, v):
        """The K / V heads this rank's q heads read (all without tp)."""
        if tp is None:
            return k, v
        lo, n = kv_group(cfg, q.shape[2], tp)
        return k[:, :, lo:lo + n], v[:, :, lo:lo + n]

    if ctx["mode"] == "full":
        q, k, v = project(ctx["positions"])
        kg, vg = group(k, v)
        S = x.shape[1]
        if cfg.use_kernels and S % 128 == 0 and q.shape[-1] % 8 == 0:
            from repro_torch.kernels.ops import flash_attention_bshd
            out = flash_attention_bshd(q, kg, vg, causal=True,
                                       window=cfg.attn_window)
        else:
            attend = pick_attend(cfg, S, S, differentiable=cache is None)
            out = attend(q, kg, vg, ctx["positions"], ctx["positions"],
                         window=cfg.attn_window, causal=True)
        table = ctx.get("block_table")
        if cache is None:
            new_cache = None
        elif table is not None:
            new_cache = _write_full_paged(cache, k, v, ctx["write_slots"],
                                          table)
        else:
            new_cache = _write_full(cache, k, v, ctx["write_slots"])
    else:
        t = ctx["t"]
        q, k, v = project(t.view(1, 1))
        table = ctx.get("block_table")
        if table is not None:
            new_cache = _write_decode_paged(cache, k, v, ctx["slot"], table)
        else:
            new_cache = _write_decode(cache, k, v, ctx["slot"])
        # the ring position of this step is visible to its own query
        # (dense: the lane-wide (W,) ring; paged: per-slot (B, W) rows)
        kpos = ctx["kpos_t"]
        if cfg.use_kernels and q.shape[-1] % 8 == 0:
            from repro_torch.kernels.ops import decode_attention_cache
            # dead slots (ctx["live"] False) do no attention work and get
            # zero rows; live rows are unaffected (attention is
            # batch-separable).  Paged stores are read through the table.
            kc, vc = group(new_cache["k"], new_cache["v"])
            out = decode_attention_cache(q, kc, vc, t, kpos,
                                         window=cfg.attn_window,
                                         live=ctx.get("live"), table=table)
        else:
            kv_k, kv_v = (_paged_kv_view(new_cache, table)
                          if table is not None
                          else (new_cache["k"], new_cache["v"]))
            out = attend_decode(q, *group(kv_k, kv_v), t, kpos,
                                window=cfg.attn_window)
    B, S = x.shape[0], x.shape[1]
    out = out.reshape(B, S, -1) @ params["wo"].to(x.dtype)
    return row_parallel(tp, out), new_cache


def _attn_backfill(cfg, params, h, ctx, cache):
    """KV backfill: project k/v from the exit hidden state, write, skip
    attention.  (No q/k/v bias here, exactly as the reference.)"""
    if cache is None:
        return None
    x = norm_apply(params["norm"], cfg, h)
    hd = cfg.resolved_head_dim
    B, S = x.shape[0], x.shape[1]
    k = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    tp = tensor_parallel()
    if tp is not None:
        # column shards: K and V gathered whole before RoPE, as in
        # qkv_project_tp
        k, v = kv_gather(tp, k, v)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    table = ctx.get("block_table")
    if ctx["mode"] == "decode":
        k = apply_rope(k, ctx["t"].view(1, 1), cfg.rope_theta)
        if table is not None:
            return _write_decode_paged(cache, k, v, ctx["slot"], table)
        return _write_decode(cache, k, v, ctx["slot"])
    k = apply_rope(k, ctx["positions"], cfg.rope_theta)
    if table is not None:
        return _write_full_paged(cache, k, v, ctx["write_slots"], table)
    return _write_full(cache, k, v, ctx["write_slots"])


# ---------------------------------------------------------------------------
# dense block
# ---------------------------------------------------------------------------

def dense_init_block(gen, cfg):
    return {"attn": attn_init(gen, cfg), "mlp": mlp_init(gen, cfg)}


def dense_apply(cfg, params, h, ctx, cache):
    a, new_cache = _self_attention(cfg, params["attn"], h, ctx, cache)
    h = h + a
    m = mlp_apply(params["mlp"], cfg,
                  norm_apply(params["mlp"]["norm"], cfg, h))
    return h + m, new_cache, 0.0


def dense_backfill(cfg, params, h, ctx, cache):
    return _attn_backfill(cfg, params["attn"], h, ctx, cache)


# ---------------------------------------------------------------------------
# moe block: the dense block's attention, then norm -> MoE -> residual
# ---------------------------------------------------------------------------

def moe_init_block(gen, cfg):
    return {"attn": attn_init(gen, cfg), "moe": moe_init(gen, cfg)}


def moe_apply_block(cfg, params, h, ctx, cache):
    """The moe block; ``ctx["route_rows"]`` (absent: None) is the axis
    over whose ranks the call's rows are split (:func:`moe_apply`)."""
    a, new_cache = _self_attention(cfg, params["attn"], h, ctx, cache)
    h = h + a
    x = norm_apply(params["moe"]["norm"], cfg, h)
    m, aux = moe_apply(params["moe"], cfg, x, rows=ctx.get("route_rows"))
    return h + m, new_cache, aux


# ---------------------------------------------------------------------------
# mamba / hybrid shared-attention blocks
# ---------------------------------------------------------------------------

def mamba_init_block(gen, cfg):
    return {"ssm": ssm.ssm_init(gen, cfg)}


def mamba_apply(cfg, params, h, ctx, cache):
    x = norm_apply(params["ssm"]["norm"], cfg, h)
    if ctx["mode"] == "full":
        y, new_cache = ssm.ssm_forward_full(params["ssm"], cfg, x, cache)
    else:
        y, new_cache = ssm.ssm_decode_step(params["ssm"], cfg, x, cache)
    return h + y, new_cache, 0.0


def mamba_cache(cfg, batch, W, dtype, device):
    del W
    return ssm.ssm_init_cache(cfg, batch, dtype, device)


def mamba_backfill(cfg, params, h, ctx, cache):
    """SSM state backfill = run the recurrence but skip out_proj and the
    gating (and the readout they take)."""
    if cache is None:
        return None
    x = norm_apply(params["ssm"]["norm"], cfg, h)
    if ctx["mode"] == "full":
        return ssm.ssm_backfill_full(params["ssm"], cfg, x, cache)
    return ssm.ssm_backfill_step(params["ssm"], cfg, x, cache)


def shared_attn_init(gen, cfg):
    """Per-invocation params of the zamba2-style shared block: LoRA deltas
    on q/k/v.  The shared full-rank weights live in ctx['shared']."""
    r = 16
    hd = cfg.resolved_head_dim
    return {
        "lora_q_a": nn.dense_init(gen, (cfg.d_model, r)),
        "lora_q_b": nn.zeros_init(gen, (r, cfg.n_heads * hd)),
        "lora_k_a": nn.dense_init(gen, (cfg.d_model, r)),
        "lora_k_b": nn.zeros_init(gen, (r, cfg.n_kv_heads * hd)),
        "lora_v_a": nn.dense_init(gen, (cfg.d_model, r)),
        "lora_v_b": nn.zeros_init(gen, (r, cfg.n_kv_heads * hd)),
    }


def shared_attn_apply(cfg, params, h, ctx, cache):
    """The shared attention block with this invocation's LoRA outputs added
    to q, k and v, then the shared MLP.  Its attention is the plain one in
    both modes, with or without ``use_kernels`` (the reference's block calls
    ``pick_attend`` / ``attend_decode`` directly); the norms take the
    kernel with ``use_kernels``."""
    shared = ctx["shared"]          # full attention + mlp params, shared
    attn_p = shared["attn"]

    def proj_with_lora(x, w, a, b):
        return x @ w.to(x.dtype) + (x @ a.to(x.dtype)) @ b.to(x.dtype)

    x = norm_apply(attn_p["norm"], cfg, h)
    hd = cfg.resolved_head_dim
    B, S = x.shape[0], x.shape[1]
    q = proj_with_lora(x, attn_p["wq"], params["lora_q_a"],
                       params["lora_q_b"]).reshape(B, S, cfg.n_heads, hd)
    k = proj_with_lora(x, attn_p["wk"], params["lora_k_a"],
                       params["lora_k_b"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = proj_with_lora(x, attn_p["wv"], params["lora_v_a"],
                       params["lora_v_b"]).reshape(B, S, cfg.n_kv_heads, hd)
    if ctx["mode"] == "full":
        q = apply_rope(q, ctx["positions"], cfg.rope_theta)
        k = apply_rope(k, ctx["positions"], cfg.rope_theta)
        attend = pick_attend(cfg, S, S, differentiable=cache is None)
        out = attend(q, k, v, ctx["positions"], ctx["positions"],
                     window=0, causal=True)
        new_cache = (_write_full(cache, k, v, ctx["write_slots"])
                     if cache is not None else None)
    else:
        t = ctx["t"]
        q = apply_rope(q, t.view(1, 1), cfg.rope_theta)
        k = apply_rope(k, t.view(1, 1), cfg.rope_theta)
        new_cache = _write_decode(cache, k, v, ctx["slot"])
        out = attend_decode(q, new_cache["k"], new_cache["v"], t,
                            ctx["kpos_t"])
    out = out.reshape(B, S, -1) @ attn_p["wo"].to(x.dtype)
    h = h + out
    m = mlp_apply(shared["mlp"], cfg, norm_apply(shared["mlp"]["norm"], cfg,
                                                 h))
    return h + m, new_cache, 0.0


def shared_attn_backfill(cfg, params, h, ctx, cache):
    """K/V projected from the SHARED weights, without this invocation's
    LoRA deltas (as the reference's backfill does)."""
    if cache is None:
        return None
    return _attn_backfill(cfg, ctx["shared"]["attn"], h, ctx, cache)


# ---------------------------------------------------------------------------
# xLSTM blocks (the ssm family)
# ---------------------------------------------------------------------------

def mlstm_init_block(gen, cfg):
    return {"mlstm": xlstm.mlstm_init(gen, cfg)}


def mlstm_apply(cfg, params, h, ctx, cache):
    x = norm_apply(params["mlstm"]["norm"], cfg, h)
    if ctx["mode"] == "full":
        y, new_cache = xlstm.mlstm_forward_full(params["mlstm"], cfg, x,
                                                cache)
    else:
        y, new_cache = xlstm.mlstm_decode_step(params["mlstm"], cfg, x, cache)
    return h + y, new_cache, 0.0


def mlstm_cache(cfg, batch, W, dtype, device):
    del W
    return xlstm.mlstm_init_cache(cfg, batch, dtype, device)


def mlstm_backfill(cfg, params, h, ctx, cache):
    """mLSTM state backfill = run the recurrence but skip the readout's
    norm, gate and down projection."""
    if cache is None:
        return None
    x = norm_apply(params["mlstm"]["norm"], cfg, h)
    if ctx["mode"] == "full":
        return xlstm.mlstm_backfill_full(params["mlstm"], cfg, x, cache)
    return xlstm.mlstm_backfill_step(params["mlstm"], cfg, x, cache)


def slstm_init_block(gen, cfg):
    return {"slstm": xlstm.slstm_init(gen, cfg)}


def slstm_apply(cfg, params, h, ctx, cache):
    x = norm_apply(params["slstm"]["norm"], cfg, h)
    if ctx["mode"] == "full":
        y, new_cache = xlstm.slstm_forward_full(params["slstm"], cfg, x,
                                                cache)
    else:
        y, new_cache = xlstm.slstm_decode_step(params["slstm"], cfg, x, cache)
    return h + y, new_cache, 0.0


def slstm_cache(cfg, batch, W, dtype, device):
    del W
    return xlstm.slstm_init_cache(cfg, batch, dtype, device)


def slstm_backfill(cfg, params, h, ctx, cache):
    """sLSTM state backfill = run the cell but skip the up / down
    projection."""
    if cache is None:
        return None
    x = norm_apply(params["slstm"]["norm"], cfg, h)
    if ctx["mode"] == "full":
        return xlstm.slstm_backfill_full(params["slstm"], cfg, x, cache)
    return xlstm.slstm_backfill_step(params["slstm"], cfg, x, cache)


# ---------------------------------------------------------------------------
# cross-attention blocks (the vlm and audio families)
# ---------------------------------------------------------------------------

def _cross_attention(cfg, params, h, ctx, cache):
    """Cross-attend to the memory ``ctx["cross"]`` (B, T, d), non-causal
    (every query sees all T memory rows) and plain (``attend_full``, as
    the reference's: no kernel).  Full mode projects the memory's K/V and,
    with a cache, copies them into it in place; decode mode reads the
    cached K/V and writes nothing.  A ``gate`` (llama-3.2-vision's) scales
    the output by its tanh."""
    x = norm_apply(params["norm"], cfg, h)
    hd = cfg.resolved_head_dim
    B, S = x.shape[0], x.shape[1]
    q = (x @ params["wq"].to(x.dtype)).reshape(B, S, cfg.n_heads, hd)
    if cache is not None and ctx["mode"] == "decode":
        k, v = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
    else:
        mem = ctx["cross"].to(x.dtype)
        T = mem.shape[1]
        k = (mem @ params["wk"].to(x.dtype)).reshape(B, T, cfg.n_kv_heads,
                                                      hd)
        v = (mem @ params["wv"].to(x.dtype)).reshape(B, T, cfg.n_kv_heads,
                                                      hd)
        if cache is not None:
            cache["k"].copy_(k)
            cache["v"].copy_(v)
    T = k.shape[1]
    kpos = torch.arange(T, device=x.device)
    qpos = torch.full((S,), T, dtype=torch.int64, device=x.device)
    out = attend_full(q, k, v, qpos, kpos, window=0, causal=False)
    out = out.reshape(B, S, -1) @ params["wo"].to(x.dtype)
    if "gate" in params:
        out = out * torch.tanh(params["gate"]).to(out.dtype)
    return out, cache


def cross_cache_init(cfg, batch, W, dtype, device):
    del W
    hd = cfg.resolved_head_dim
    T = cfg.n_image_tokens or cfg.n_audio_frames
    shape = (batch, T, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def xattn_init_block(gen, cfg):
    return {"xattn": attn_init(gen, cfg, cross=True),
            "mlp": mlp_init(gen, cfg)}


def xattn_apply(cfg, params, h, ctx, cache):
    """Gated cross-attention to the image tokens (their K/V cached at
    prefill), then the MLP: llama-3.2-vision's image layer.  Its cache is
    the cross K/V alone, read-only at decode."""
    a, _ = _cross_attention(cfg, params["xattn"], h, ctx, cache)
    h = h + a
    m = mlp_apply(params["mlp"], cfg,
                  norm_apply(params["mlp"]["norm"], cfg, h))
    return h + m, cache, 0.0


def encdec_init_block(gen, cfg):
    return {"attn": attn_init(gen, cfg), "xattn": attn_init(gen, cfg),
            "mlp": mlp_init(gen, cfg)}


def encdec_apply(cfg, params, h, ctx, cache):
    """Self-attention over the decoder's ring, cross-attention to the
    encoder's memory (its K/V cached at prefill), then the MLP."""
    a, _ = _self_attention(cfg, params["attn"], h, ctx,
                           None if cache is None else cache["self"])
    h = h + a
    c, _ = _cross_attention(cfg, params["xattn"], h, ctx,
                            None if cache is None else cache["cross"])
    h = h + c
    m = mlp_apply(params["mlp"], cfg,
                  norm_apply(params["mlp"]["norm"], cfg, h))
    return h + m, cache, 0.0


def encdec_cache(cfg, batch, W, dtype, device):
    """``cross`` before ``self``: the reference's key order (the paged
    layout's refusal names the stage's keys in it)."""
    return {"cross": cross_cache_init(cfg, batch, W, dtype, device),
            "self": attn_cache_init(cfg, batch, W, dtype, device)}


def encdec_backfill(cfg, params, h, ctx, cache):
    """The self-attention K/V backfill; the cross K/V depend only on the
    encoder's memory and stay as they are."""
    if cache is None:
        return None
    _attn_backfill(cfg, params["attn"], h, ctx, cache["self"])
    return cache


def enc_init_block(gen, cfg):
    return {"attn": attn_init(gen, cfg), "mlp": mlp_init(gen, cfg)}


def enc_apply(cfg, params, h, ctx, cache):
    """Bidirectional encoder layer (whisper's encoder): plain attention
    over every frame, no cache, no kernel."""
    x = norm_apply(params["attn"]["norm"], cfg, h)
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)
    q, k, v = qkv_project(params["attn"], cfg, x, rope_positions=None)
    out = attend_full(q, k, v, pos, pos, window=0, causal=False)
    out = out.reshape(x.shape[0], S, -1) @ params["attn"]["wo"].to(x.dtype)
    h = h + out
    m = mlp_apply(params["mlp"], cfg,
                  norm_apply(params["mlp"]["norm"], cfg, h))
    return h + m, None, 0.0


def _no_cache(cfg, batch, W, dtype, device):
    return {}


def _no_backfill(cfg, params, h, ctx, cache):
    return cache


# an xattn layer's K/V depend only on the image tokens: nothing to backfill
xattn_backfill = _no_backfill


BLOCKS: Dict[str, BlockDef] = {
    "dense": BlockDef(dense_init_block, dense_apply, attn_cache_init,
                      dense_backfill),
    "moe": BlockDef(moe_init_block, moe_apply_block, attn_cache_init,
                    dense_backfill),
    "mamba": BlockDef(mamba_init_block, mamba_apply, mamba_cache,
                      mamba_backfill, state_keys=("conv", "state")),
    "attn_shared": BlockDef(shared_attn_init, shared_attn_apply,
                            attn_cache_init, shared_attn_backfill),
    "mlstm": BlockDef(mlstm_init_block, mlstm_apply, mlstm_cache,
                      mlstm_backfill, state_keys=("conv", "C", "n", "m")),
    "slstm": BlockDef(slstm_init_block, slstm_apply, slstm_cache,
                      slstm_backfill, state_keys=("state",)),
    "xattn": BlockDef(xattn_init_block, xattn_apply, cross_cache_init,
                      xattn_backfill, read_keys=("k", "v")),
    "encdec": BlockDef(encdec_init_block, encdec_apply, encdec_cache,
                       encdec_backfill, read_keys=("cross",)),
    "enc": BlockDef(enc_init_block, enc_apply, _no_cache, _no_backfill),
}


def layer_kinds(cfg) -> list[str]:
    """The per-layer kind sequence of an architecture."""
    if cfg.family == "dense":
        return ["dense"] * cfg.n_layers
    if cfg.family == "moe":
        return ["moe"] * cfg.n_layers
    if cfg.family == "ssm":  # xlstm
        k = cfg.slstm_every
        if k:
            return ["slstm" if i % k == k - 1 else "mlstm"
                    for i in range(cfg.n_layers)]
        return ["mamba"] * cfg.n_layers
    if cfg.family == "hybrid":
        k = cfg.shared_attn_every
        return ["attn_shared" if (k and i % k == 0) else "mamba"
                for i in range(cfg.n_layers)]
    if cfg.family == "vlm":
        k = cfg.cross_attn_every
        return ["xattn" if (k and i % k == k - 1) else "dense"
                for i in range(cfg.n_layers)]
    if cfg.family == "audio":
        return ["encdec"] * cfg.n_layers
    raise ValueError(f"unknown family {cfg.family}")
