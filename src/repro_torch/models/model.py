"""CascadeModel — the early-exit model: dense, moe, hybrid, ssm, vlm and
audio families.

The counterpart of the JAX package's ``models/model.py``.  The backbone is
the per-layer kind sequence from ``blocks.layer_kinds(cfg)``, split into
``n_components`` segments at the cascade exit boundaries.  Within a
segment, consecutive layers of one kind form a *stage* whose parameters
(and caches) are stacked on a leading layer axis, as in the reference; a
Python loop over the layers takes the place of ``lax.scan``.

Exit heads branch after every segment but the last (``norm →
[enhancement MLP] → unembed``, the unembedding shared with the final head
by default); the final head is the standard norm + unembedding.  Norms are
rmsnorm or layernorm (``cfg.norm``); positions are RoPE, or learned
absolute ones (``pos_embed``) when ``rope_theta <= 0``; with
``tie_embeddings`` the unembedding is ``embed.T`` and there is no
``lm_head``.  The hybrid family (zamba2) interleaves Mamba2 layers with
invocations of ONE shared attention + MLP block (``params["shared"]``,
handed to every layer in ``ctx["shared"]``), each invocation adding its
own LoRA deltas.  The ssm family (xlstm) interleaves mLSTM and sLSTM
layers (every ``slstm_every``-th an sLSTM one), whose caches are
recurrent states only: an sLSTM stage's cache nests a dict of four state
leaves under ``"state"``.  The audio family (whisper) is an
encoder-decoder: a bidirectional encoder (``params["encoder"]``) turns the
stubbed frame embeddings ``extra["audio_embeds"]`` (B, n_audio_frames, d)
into the memory every decoder layer (``encdec``) cross-attends to; the
prefill caches each layer's cross K/V, which decode reads and never
writes (the block kind's ``read_keys``).  The vlm family (llama-3.2-vision)
interleaves dense layers with gated cross-attention layers (``xattn``,
every ``cross_attn_every``-th) over the stubbed image embeddings
``extra["image_embeds"]`` (B, n_image_tokens, d); an xattn layer's cache
is its cross K/V alone, written at prefill and read-only after, so a
segment may hold no ring or state leaf at all.

Public entry points:
  init(generator)                                -> params
  forward_train(params, tokens, extra)           -> (exit_logits, aux)
  init_cache(batch, cache_len, dtype)            -> cache
  prefill(params, tokens, cache, extra[, block_tables])
                                                 -> (exit_logits_last, cache)
  prefill_into(params, tokens, cache, ...)       -> exit_logits_last (paged)
  decode_step(params, token, t, cache, extra)    -> (exit_logits, cache)
  decode(params, token, cache, state, extra)     -> (decision, cache, state)
(``t`` a 0-d int32 device tensor or an int; caches and the kpos ring are
written in place; ``decode`` is the staged step of ``core/exec.py``;
``extra`` the modality inputs of :func:`extra_input_shapes`, None for the
families that take none)
and the segment primitives the staged executor (``core/exec.py``) runs:
``begin_decode`` / ``run_segment`` / ``backfill_segment`` / ``exit_logits``
/ ``commit_decode``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch import parallel
from repro_torch.parallel import copy_to, reduce_from, tensor_parallel
from repro_torch.models import nn
from repro_torch.models.blocks import BLOCKS, layer_kinds
from repro_torch.models.layers import (attn_init, mlp_init, norm_apply,
                                       norm_init)
from repro_torch.utils import dtype_of, resolve_device


def _runs(kinds: List[str]) -> List[Tuple[str, int]]:
    runs = []
    for k in kinds:
        if runs and runs[-1][0] == k:
            runs[-1][1] += 1
        else:
            runs.append([k, 1])
    return [(k, n) for k, n in runs]


def _check_supported(cfg: ModelConfig) -> None:
    """The cnn family (CI-ResNet) is :mod:`repro_torch.models.resnet`'s,
    not a cascade LM; an unknown family is refused by ``layer_kinds`` with
    the reference's ``ValueError``."""
    if cfg.family == "cnn":
        raise NotImplementedError(
            "family 'cnn' has no CascadeModel: CI-ResNet is "
            "repro_torch.models.resnet")


def _no_extra(cfg: ModelConfig, extra) -> None:
    """Refuse extra model inputs for a family that takes none."""
    if extra and not extra_input_shapes(cfg, 1):
        raise NotImplementedError(
            f"extra model inputs {sorted(extra)}: the {cfg.family} family "
            f"takes none")


class CascadeModel:
    def __init__(self, cfg: ModelConfig, device=None):
        _check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        kinds = layer_kinds(cfg)
        self.segment_runs: List[List[Tuple[str, int]]] = [
            _runs(kinds[start:end]) for start, end in cfg.segments]
        self.n_exits = cfg.cascade.n_components
        self.param_dtype = dtype_of(cfg.dtype)

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def init(self, generator) -> Dict[str, Any]:
        """Random parameters drawn from ``generator`` (a torch.Generator on
        this model's device, or an int seed for one)."""
        cfg = self.cfg
        dt = self.param_dtype
        gen = generator
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=self.device).manual_seed(int(gen))
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")
        cast = (lambda x: x.to(dt) if x.is_floating_point() else x)
        p: Dict[str, Any] = {}
        p["embed"] = nn.embed_init(gen, (cfg.vocab_size, cfg.d_model), dt)
        if cfg.family == "audio" or cfg.rope_theta <= 0:
            p["pos_embed"] = nn.embed_init(
                gen, (cfg.max_seq_len, cfg.d_model), dt)
        segs = []
        for runs in self.segment_runs:
            stages = []
            for kind, n in runs:
                block = BLOCKS[kind]
                stages.append(nn.stack_init(
                    lambda g, _b=block: nn.tree_map(cast, _b.init(g, cfg)),
                    gen, n))
            segs.append(stages)
        p["segments"] = segs
        if cfg.family == "hybrid":
            shared = {"attn": attn_init(gen, cfg), "mlp": mlp_init(gen, cfg)}
            p["shared"] = nn.tree_map(cast, shared)
        if cfg.family == "audio":
            p["encoder"] = self._init_encoder(gen, cast)
        exits = []
        for _ in range(self.n_exits - 1):
            e: Dict[str, Any] = {"norm": norm_init(gen, cfg)}
            if cfg.cascade.enhance_dim:
                e["enh_w1"] = nn.dense_init(
                    gen, (cfg.d_model, cfg.cascade.enhance_dim), dt)
                e["enh_w2"] = nn.zeros_init(
                    gen, (cfg.cascade.enhance_dim, cfg.d_model), dt)
            if not cfg.cascade.share_unembed:
                e["head"] = nn.dense_init(
                    gen, (cfg.d_model, cfg.vocab_size), dt)
            exits.append(e)
        p["exits"] = exits
        p["final_norm"] = norm_init(gen, cfg)
        if not cfg.tie_embeddings:
            p["lm_head"] = nn.dense_init(
                gen, (cfg.d_model, cfg.vocab_size), dt)
        return p

    def _init_encoder(self, gen, cast):
        """The audio encoder: its stacked ``enc`` layers (cast to the
        model dtype), the final norm (f32, as the reference leaves it) and
        the learned frame positions (n_audio_frames, d)."""
        cfg = self.cfg
        block = BLOCKS["enc"]
        return {
            "stages": nn.stack_init(
                lambda g: nn.tree_map(cast, block.init(g, cfg)), gen,
                cfg.encoder_layers),
            "norm": norm_init(gen, cfg),
            "pos_embed": nn.embed_init(
                gen, (cfg.n_audio_frames, cfg.d_model), self.param_dtype),
        }

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------
    def _run_stage(self, kind, stacked, h, ctx, stacked_cache):
        """The stage's layers in order: (h', caches written in place, the
        sum of the layers' aux losses — 0.0 for kinds that have none)."""
        block = BLOCKS[kind]
        n = next(nn.tree_leaves(stacked)).shape[0]
        aux = 0.0
        for i in range(n):
            ca = (None if stacked_cache is None
                  else nn.tree_index(stacked_cache, i))
            h, _, a = block.apply(self.cfg, nn.tree_index(stacked, i), h,
                                  ctx, ca)
            aux = aux + a
        return h, stacked_cache, aux

    @staticmethod
    def _segment_ctx(si, ctx):
        """Paged layout: segment ``si`` addresses the shared stores
        through its OWN table rows (B, nblk) — exit depth m frees the rows
        of components m+1.. while shallower components keep theirs."""
        if ctx.get("block_tables") is not None:
            return {**ctx, "block_table": ctx["block_tables"][si]}
        return ctx

    def run_segment(self, si, params, h, ctx, seg_cache):
        """Compute segment ``si``: (h', seg_cache written in place, aux —
        the MoE layers' load-balance losses summed, 0.0 without any)."""
        ctx = self._segment_ctx(si, ctx)
        aux = 0.0
        for pi, (kind, _) in enumerate(self.segment_runs[si]):
            cache_i = seg_cache[pi] if seg_cache is not None else None
            h, _, a = self._run_stage(kind, params["segments"][si][pi], h,
                                      ctx, cache_i)
            aux = aux + a
        return h, seg_cache, aux

    def backfill_segment(self, si, params, h, ctx, seg_cache):
        """Write segment ``si``'s caches from the exit hidden state without
        computing the segment (the skip path's cache-coherence write)."""
        ctx = self._segment_ctx(si, ctx)
        for pi, (kind, _) in enumerate(self.segment_runs[si]):
            block = BLOCKS[kind]
            stacked = params["segments"][si][pi]
            n = next(nn.tree_leaves(stacked)).shape[0]
            for i in range(n):
                block.backfill(self.cfg, nn.tree_index(stacked, i), h, ctx,
                               nn.tree_index(seg_cache[pi], i))
        return seg_cache

    def leaf_kinds(self, si, seg_cache) -> List[str]:
        """For each leaf of segment ``si``'s cache tree (a slab, a cohort's
        view of it, or a paged store), in :func:`nn.tree_leaves` order, the
        kind of write a decode step makes in it: ``"state"`` (rewritten
        whole — the block kind's ``state_keys``), ``"read"`` (never
        written: read-only — its ``read_keys``, an encdec layer's cross
        K/V) or ``"ring"`` (one slot written a step).  A key naming a dict
        marks every leaf beneath it."""
        kinds = []
        for (kind, _), stage in zip(self.segment_runs[si], seg_cache):
            block = BLOCKS[kind]
            for name, sub in stage.items():
                what = ("state" if name in block.state_keys else
                        "read" if name in block.read_keys else "ring")
                kinds += [what] * len(list(nn.tree_leaves(sub)))
        return kinds

    def state_leaf_mask(self, si, seg_cache) -> List[bool]:
        """:meth:`leaf_kinds` as a mask: True for a STATE leaf."""
        return [k == "state" for k in self.leaf_kinds(si, seg_cache)]

    # ------------------------------------------------------------------
    # heads
    # ------------------------------------------------------------------
    def _unembed(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["lm_head"]

    def exit_logits(self, params, m: int, h, local: bool = False):
        """Exit head m (m < n_exits-1: intermediate; else final).

        Over a head sharded by vocab across the ``model`` ranks (serve1d,
        and the training layout) the product gives this rank's columns:
        ``local`` returns them (the exit kernels' partial contract and the
        vocab-parallel loss read them), else they are gathered over
        ``model`` into the whole vocab.  In training the normed input's
        gradient, partial on each rank, is all-reduced (``copy_to``); an
        enhancement sharded by column / row is completed by an all-reduce."""
        cfg = self.cfg
        tp = tensor_parallel()
        if m >= self.n_exits - 1:
            x = norm_apply(params["final_norm"], cfg, h)
            head = self._unembed(params)
        else:
            e = params["exits"][m]
            x = norm_apply(e["norm"], cfg, h)
            if "enh_w1" in e:
                w2 = e["enh_w2"]
                tpe = tp if w2.shape[-2] != cfg.cascade.enhance_dim else None
                x = x + reduce_from(tpe, F.gelu(
                    copy_to(tpe, x) @ e["enh_w1"].to(x.dtype),
                    approximate="tanh") @ w2.to(x.dtype))
            head = e["head"] if "head" in e else self._unembed(params)
        if head.shape[-1] != cfg.vocab_size:
            x = copy_to(tp, x)
        logits = x @ head.to(x.dtype)
        if tp is None or local:
            return logits
        parts = tp.all_gather(logits, "model")           # (M, ..., V / M)
        return torch.cat(list(parts), dim=-1)

    def exit_head_params(self, params, m: int):
        """``(norm_w, head)`` when exit head ``m`` fits the fused exit-head
        shape (rmsnorm + one unembed matmul over a head whose rows are
        contiguous), else None: a layernorm bias, an enhancement MLP or a
        tied head (``embed.T``, a transposed view the megakernel does not
        read) take ``exit_logits`` + the exit-update kernel instead."""
        if m >= self.n_exits - 1:
            norm = params["final_norm"]
            head = self._unembed(params)
        else:
            e = params["exits"][m]
            if "enh_w1" in e:
                return None
            norm = e["norm"]
            head = e["head"] if "head" in e else self._unembed(params)
        if "b" in norm or head.stride(-1) != 1:
            return None
        return norm["w"], head

    def _encode_audio(self, params, audio_embeds):
        """The whisper encoder over stubbed frame embeddings (B, T, d):
        the learned frame positions added, the bidirectional ``enc``
        layers, the final norm.  Plain ops only (the reference's encoder
        has no kernel)."""
        enc = params["encoder"]
        h = audio_embeds.to(self.param_dtype) + enc["pos_embed"][None]
        ctx = {"mode": "full", "positions": None, "write_slots": None,
               "cross": None, "shared": None}
        block = BLOCKS["enc"]
        stages = enc["stages"]
        for i in range(next(nn.tree_leaves(stages)).shape[0]):
            h, _, _ = block.apply(self.cfg, nn.tree_index(stages, i), h, ctx,
                                  None)
        return norm_apply(enc["norm"], self.cfg, h)

    def _make_cross(self, params, extra, mode):
        """The memory cross-attention reads in ``mode``: in full mode the
        image embeddings cast to the parameter dtype (vlm) or the audio
        encoder's output; None at decode (the layers read the cross K/V
        cached at prefill, so a captured decode step takes no memory) and
        for families without one."""
        if mode == "decode":
            return None
        if self.cfg.family == "vlm":
            return extra["image_embeds"].to(self.param_dtype)
        if self.cfg.family == "audio":
            return self._encode_audio(params, extra["audio_embeds"])
        return None

    def _embed(self, params, tokens, positions=None):
        """Token embeddings, plus the learned position embeddings at
        ``positions`` (a tensor; ``arange(S)`` by default) when the model
        has them.  Positions past the table read its last row, as the
        reference's clamped gather does."""
        table = params["embed"]
        tp = tensor_parallel()
        if tp is None or table.shape[0] == self.cfg.vocab_size:
            h = table[tokens.long()]
        else:
            # rows sharded by vocab over model: each rank looks up the
            # tokens its rows hold (zeros elsewhere), and the all-reduce
            # sums one row and zeros: the row itself, exactly
            idx = tokens.long() - tp.rank("model") * table.shape[0]
            hold = (idx >= 0) & (idx < table.shape[0])
            h = table[idx.clamp(0, table.shape[0] - 1)]
            h = reduce_from(tp, torch.where(hold[..., None], h,
                                            torch.zeros_like(h)), "model")
        if "pos_embed" in params:
            if positions is None:
                positions = torch.arange(tokens.shape[1], device=h.device)
            table = params["pos_embed"]
            h = h + table[positions.long().clamp(max=table.shape[0] - 1)]
        return h

    # ------------------------------------------------------------------
    # training / full-sequence forward
    # ------------------------------------------------------------------
    def _train_segment(self, si, params, h, ctx):
        """Segment ``si`` over a full sequence with no cache: (h', aux).
        With ``cfg.remat`` each block is recomputed in the backward pass
        (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``
        of the scan body: the same numbers, less activation memory).  The
        recompute runs inside the backward (on CUDA on autograd's device
        thread, where no transport is active): it re-activates this
        forward's transport, so the layer runs tensor-parallel again and
        makes its forward collectives again, in the same order on every
        rank."""
        remat = self.cfg.remat and torch.is_grad_enabled()
        tp = parallel.active()
        aux = 0.0
        for pi, (kind, _) in enumerate(self.segment_runs[si]):
            block = BLOCKS[kind]
            stacked = params["segments"][si][pi]

            def layer(h, pa, _block=block):
                with parallel.activate(tp):
                    h2, _, a = _block.apply(self.cfg, pa, h, ctx, None)
                return h2, a
            for i in range(next(nn.tree_leaves(stacked)).shape[0]):
                pa = nn.tree_index(stacked, i)
                h, a = (checkpoint(layer, h, pa, use_reentrant=False)
                        if remat else layer(h, pa))
                aux = aux + a
        return h, aux

    def forward_train(self, params, tokens, extra=None, route_rows=None):
        """tokens: (B, S).  Returns ([exit logits (B, S', V)] * n_exits,
        aux): the intermediate exits at every ``cascade.exit_loss_stride``-th
        position, the final exit at every position; aux the MoE layers'
        load-balance losses summed (0 for the dense family).  Under a
        ``model`` axis (the training layout's shards, a transport active)
        each logits tensor is this rank's vocab slice, (B, S', V / M),
        which the vocab-parallel loss reads: nothing is gathered.
        ``route_rows``: the axis of the active transport over whose ranks
        ``tokens`` is one block of the batch's rows (the MoE layers then
        route the whole batch as one call and take its aux loss), or None
        when ``tokens`` is the whole batch.

        It computes with the plain ops only: no kernel of the port has a
        backward (nor has any of the reference's), so a ``use_kernels``
        config is refused rather than differentiated around a kernel."""
        cfg = self.cfg
        if cfg.use_kernels:
            raise NotImplementedError(
                "forward_train with use_kernels: no kernel of the port has "
                "a backward; train with use_kernels off (as the reference's "
                "training configs do)")
        _no_extra(cfg, extra)
        S = tokens.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
        h = self._embed(params, tokens, positions)
        ctx = {"mode": "full", "positions": positions, "write_slots": None,
               "kpos": None, "shared": params.get("shared"),
               "cross": self._make_cross(params, extra or {}, "full"),
               "route_rows": route_rows}
        logits = []
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        stride = max(1, cfg.cascade.exit_loss_stride)
        for si in range(self.n_exits):
            h, a = self._train_segment(si, params, h, ctx)
            aux = aux + a
            if si < self.n_exits - 1:
                logits.append(self.exit_logits(params, si, h[:, ::stride],
                                               local=True))
        logits.append(self.exit_logits(params, self.n_exits - 1, h,
                                       local=True))
        return logits, aux

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------
    def cache_capacity(self, cache_len: int) -> int:
        w = self.cfg.attn_window
        return min(w, cache_len) if w else cache_len

    def init_cache(self, batch: int, cache_len: int, dtype=None,
                   device=None):
        """Fresh dense caches on ``device`` (the model's by default;
        ``"meta"`` gives the shapes without allocating), each leaf at its
        block kind's init value: attention rings zero in ``dtype``; a
        Mamba2 layer's conv window zero in ``dtype`` and its recurrent
        state zero in f32; an xLSTM layer's conv window zero in ``dtype``
        and its states in f32, the stabilisers ``m`` at their sentinels
        (:mod:`repro_torch.models.xlstm`).  Each stage's leaves are
        stacked on a leading layer axis, nested dicts leaf by leaf."""
        cfg = self.cfg
        dtype = dtype or self.param_dtype
        device = device or self.device
        W = self.cache_capacity(cache_len)
        segs = []
        for runs in self.segment_runs:
            stages = []
            for kind, n in runs:
                one = BLOCKS[kind].init_cache(cfg, batch, W, dtype, device)
                stages.append(nn.tree_map(
                    lambda v, n=n: v[None].repeat((n,) + (1,) * v.dim()),
                    one))
            segs.append(stages)
        return {"kpos": torch.full((W,), -1, dtype=torch.int32,
                                   device=device),
                "segments": segs}

    def reset_cache(self, cache) -> None:
        """Put every leaf of a dense cache back to its init value, in place
        (each keeps its address), and the kpos ring to empty: the
        values of :meth:`init_cache`, broadcast from a one-row, one-slot
        template (an xLSTM stabiliser restarts at its sentinel, not 0)."""
        fresh = self.init_cache(1, 1)
        for x, v in zip(nn.tree_leaves(cache["segments"]),
                        nn.tree_leaves(fresh["segments"]), strict=True):
            x.copy_(v.expand_as(x))
        cache["kpos"].fill_(-1)

    # ------------------------------------------------------------------
    # prefill
    # ------------------------------------------------------------------
    def prefill(self, params, tokens, cache, extra=None, block_tables=None):
        """Full-sequence forward writing the KV caches (in place).

        tokens (B, S) int; ``extra`` the modality inputs (the vlm
        family's ``image_embeds`` or the audio family's ``audio_embeds``,
        whose encoder runs here: each cross-attending layer's K/V are
        copied into the cache).  Returns ([exit logits at
        last position (B,V)] * n_exits, cache with its kpos ring for the S
        prompt positions, written in place).  ``block_tables``
        ((n_components, B, nblk) int32) switches the cache writes to the
        paged layout; the ring is then the per-slot (B, W) one (continuous
        admission rewrites one row at a time) instead of the lane-wide
        (W,).  On a mesh the rows are this rank's ``data`` block of the
        batch, routed as one call with the other blocks
        (``ctx["route_rows"]``, the MoE layers').
        """
        _no_extra(self.cfg, extra)
        S = tokens.shape[1]
        W = cache["kpos"].shape[-1]
        positions = torch.arange(S, dtype=torch.int32, device=self.device)
        # per-slot gather index == the absolute position held by the slot
        write_slots = torch.as_tensor(_prefill_kpos(S, W), device=self.device)
        h = self._embed(params, tokens, positions)
        ctx = {"mode": "full", "positions": positions,
               "write_slots": write_slots, "kpos": cache["kpos"],
               "shared": params.get("shared"),
               "cross": self._make_cross(params, extra or {}, "full"),
               "route_rows": parallel.batch_rows()}
        if block_tables is not None:
            ctx["block_tables"] = block_tables
        logits = []
        for si in range(self.n_exits):
            h, _, _ = self.run_segment(si, params, h, ctx,
                                       cache["segments"][si])
            logits.append(self.exit_logits(params, si, h[:, -1:, :])[:, 0, :])
        kpos = cache["kpos"]
        kpos.copy_(write_slots.expand_as(kpos))
        return logits, {"kpos": kpos, "segments": cache["segments"]}

    def prefill_into(self, params, tokens, cache, positions, write_slots,
                     block_tables, extra=None):
        """Single-request prefill at OFFSET positions into an occupied
        paged lane (continuous admission).

        tokens: (1, S); ``positions`` (S,) the absolute positions the lane
        cursor will have covered when the slot starts decoding;
        ``write_slots`` (W,) the token index each ring slot keeps (-1 =
        unwritten), computed by the engine; ``block_tables``
        (n_components, 1, nblk) the admitted slot's table rows.  Writes go
        in place through the slot's own blocks only, so the rest of the
        lane's cache is untouched.  Returns [exit logits at the last
        position (1, V)] * n_exits.
        """
        _no_extra(self.cfg, extra)
        h = self._embed(params, tokens, positions)
        ctx = {"mode": "full", "positions": positions,
               "write_slots": write_slots, "kpos": None,
               "block_tables": block_tables, "shared": params.get("shared"),
               "cross": self._make_cross(params, extra or {}, "full")}
        logits = []
        for si in range(self.n_exits):
            h, _, _ = self.run_segment(si, params, h, ctx,
                                       cache["segments"][si])
            logits.append(self.exit_logits(params, si, h[:, -1:, :])[:, 0, :])
        return logits

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def position(self, t) -> torch.Tensor:
        """The decode position as a 0-d int32 tensor on this model's
        device: a tensor is taken as it is (the carried
        ``DecodeState.t``), an int is made into one."""
        if isinstance(t, torch.Tensor):
            return t
        return torch.full((), int(t), dtype=torch.int32, device=self.device)

    @staticmethod
    def _record(kpos, t):
        """``kpos`` with ring slot ``t % W`` set to t, in place, computed on
        the device from the 0-d tensor t (no host read)."""
        slot = (t % kpos.shape[-1]).long().view(1)
        return kpos.index_copy_(
            -1, slot, t.view(1).expand(kpos.shape[:-1] + (1,)))

    def begin_decode(self, params, token, t, cache):
        """Embed one decode token and build the step context.

        token: (B,1) int; t: the position, a 0-d int32 tensor on the
        device (an int is accepted and made into one).  Returns (h, ctx)
        for the segment primitives.  ``ctx["slot"]`` is the ring slot
        ``t % W`` as a 0-d int64 tensor; ``ctx["kpos_t"]`` — the committed
        ring with this step's slot set to t, which every layer's attention
        reads — is built once here instead of once per layer.  Nothing
        here reads t to the host, so a captured step reads it from device
        memory at every replay.  ``ctx["route_rows"]`` is the ``data`` axis
        of a mesh that splits the batch (the MoE layers route its rows as
        one call), else None; the executor narrows it for a cohort's cell.
        """
        t = self.position(t)
        W = cache["kpos"].shape[-1]
        slot = (t % W).long()
        kpos_t = self._record(cache["kpos"].clone(), t)
        h = self._embed(params, token, t.view(1))
        ctx = {"mode": "decode", "t": t, "slot": slot,
               "kpos": cache["kpos"], "kpos_t": kpos_t,
               "shared": params.get("shared"), "cross": None,
               "route_rows": parallel.batch_rows()}
        return h, ctx

    def commit_decode(self, cache, new_segs, t):
        """Finish a decode step: record position t in the kpos ring, in
        place (the ring keeps its address from step to step)."""
        kpos = self._record(cache["kpos"], self.position(t))
        return {"kpos": kpos, "segments": new_segs}

    def decode_step(self, params, token, t, cache, extra=None):
        """One DENSE decode step: every segment computes, every exit's
        logits are returned (list of (B,V)).  The reference path the
        consistency tests pin; the staged decode lives in
        :class:`repro_torch.core.exec.StagedExecutor`.  ``extra`` as for
        :meth:`decode`."""
        _no_extra(self.cfg, extra)
        h, ctx = self.begin_decode(params, token, t, cache)
        logits = []
        for si in range(self.n_exits):
            h, _, _ = self.run_segment(si, params, h, ctx,
                                       cache["segments"][si])
            logits.append(self.exit_logits(params, si, h)[:, 0, :])
        return logits, self.commit_decode(cache, cache["segments"], t)

    def decode(self, params, token, cache, state, extra=None, decider=None):
        """The staged decode step under ``cfg.cascade.exit_mode``: token
        (B, 1) int32 and a :class:`repro_torch.core.exec.DecodeState` ->
        (ExitDecision, cache, state), cond_batch skipping the segments no
        live sequence needs.  The executor is built once and kept (a new
        one for each ``decider`` given).  ``extra`` is taken for the
        families that have modality inputs and ignored, as the reference
        does (decode reads the cross K/V cached at prefill); for the
        others it is refused."""
        _no_extra(self.cfg, extra)
        from repro_torch.core.exec import StagedExecutor
        if decider is not None:
            executor = StagedExecutor(self, self.cfg, decider)
        else:
            executor = getattr(self, "_staged_executor", None)
            if executor is None:
                executor = self._staged_executor = StagedExecutor(self,
                                                                  self.cfg)
        return executor.decode_step(params, token, cache, state)


def _prefill_kpos(S: int, W: int) -> np.ndarray:
    s = np.arange(W)
    if S >= W:
        kpos = S - 1 - ((S - 1 - s) % W)
    else:
        kpos = np.where(s < S, s, -1)
    return kpos.astype(np.int32)


def build_model(cfg: ModelConfig, device=None) -> CascadeModel:
    return CascadeModel(cfg, device=device)


def extra_input_shapes(cfg: ModelConfig, batch: int):
    """Shapes of the stubbed modality-frontend inputs, if any."""
    if cfg.family == "vlm":
        return {"image_embeds": (batch, cfg.n_image_tokens, cfg.d_model)}
    if cfg.family == "audio":
        return {"audio_embeds": (batch, cfg.n_audio_frames, cfg.d_model)}
    return {}
