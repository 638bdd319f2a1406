"""Staged cascade execution: the :class:`DecodeState` carry and the
segment-skipping executor that makes early exit mean early *termination*.

The counterpart of the JAX package's ``core/exec.py``, on the dense and
the paged cache layouts.  :class:`StagedExecutor` runs the cascade one
segment at a time, feeding each segment's exit to the shared
:class:`~repro_torch.core.policy.ExitDecider` scan: the fused exit-update
kernel when ``cfg.use_kernels``, and the exit-head megakernel (the (B, V)
logits never stored) with ``cfg.kernel_tune.megakernel`` as well.

* ``exit_mode == "cond_batch"`` — once every live sequence has exited,
  deeper segments take only the cheap ``backfill`` path (cache coherence
  writes) and skip their matmuls.  The reference's ``lax.cond`` becomes a
  Python branch on the device predicate: one host sync per deep segment
  per step, counted in :attr:`StagedExecutor.host_syncs` (the
  device-resident form comes with the device runtime).
* ``exit_mode == "select"`` — every segment computes and the skip predicate
  selects the results, with no host sync; the two modes produce identical
  tokens, exit indices and carried state.

Cohort-split execution (``cascade.n_cohorts > 1``) gives each of C
contiguous, equal-size cohorts its own skip predicate, in one of two
layouts (identical outputs; see :meth:`StagedExecutor.decode_step`):
``"major"`` dispatches each deep segment on the lane's exit state (all
cohorts skip / mixed / all run), ``"copy"`` always slices and re-joins per
cohort.  The host runtime reads the C stacked skip predicates once per
deep segment (:attr:`StagedExecutor.host_syncs`) and counts the dispatch
branch it took (:attr:`StagedExecutor.dispatch`).

Caches are written in place, so a cohort's segment step over a view of the
cache slab leaves its rows in the slab: the reference's per-cohort cache
re-join (a concat, or the cohort-scatter kernel) has no counterpart under
``cond_batch``.  Only ``select`` mode computes a cohort's rows out of place
(the skip-masked selection); they land through per-leaf copies, or through
one cohort-scatter launch per cohort with ``kernel_tune.cohort_scatter``.

Under the paged layout (``DecodeState.block_tables`` set) the stores are
shared by every slot and have no batch axis: each cohort steps over the
whole store through its own table rows, and ``select`` mode lands its
selection by copies (the cohort scatter has no rows to write).

The per-slot ``DecodeState.active`` mask also rides in the decode context
(``ctx["live"]``), where the decode-attention kernel skips dead slots and
the megakernel passes dead rows' carries through.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core.policy import ExitDecider, ExitDecision
from repro_torch.models import nn

# EMA decay for the per-slot answering-confidence telemetry carried in
# DecodeState (same decay as DepthCompactor's host-side depth prior).
CONF_EMA_DECAY = 0.8


def effective_cohorts(n_cohorts: int, batch: int) -> int:
    """Largest divisor of ``batch`` that is <= ``n_cohorts`` (>= 1)."""
    c = max(1, min(int(n_cohorts), int(batch)))
    while batch % c:
        c -= 1
    return c


@dataclasses.dataclass
class DecodeState:
    """Per-lane decode carry.

    t             int        — decode position == cache-write cursor
                               (host-side: the host runtime knows it).
    active        (B,) bool  — sequences still generating.
    policy        stateful-measure carry ((n_components, B) int32 patience
                               streaks) or None.
    ema_conf      (B,) f32   — EMA of the answering confidence per slot.
    segments_run  (n_components,) int32 numpy — how many decode steps
                               actually computed each segment (host-side:
                               the branch that ran is known on the host).
    block_tables  (n_components, B, W/block_size) int32 paged-cache block
                               tables (``cache_layout="paged"``), or None
                               (dense slab).
    """

    t: int
    active: torch.Tensor
    policy: Optional[torch.Tensor]
    ema_conf: torch.Tensor
    segments_run: np.ndarray
    block_tables: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "DecodeState":
        return dataclasses.replace(self, **kw)


def init_decode_state(decider: ExitDecider, batch: int, n_components: int,
                      t: int = 0, active=None, device=None,
                      block_tables=None) -> DecodeState:
    """Fresh decode carry for a lane of ``batch`` sequences."""
    active = (torch.ones(batch, dtype=torch.bool, device=device)
              if active is None
              else torch.as_tensor(active, dtype=torch.bool, device=device))
    return DecodeState(
        t=int(t), active=active,
        policy=decider.measure.init_state(n_components, batch, device),
        ema_conf=torch.zeros(batch, dtype=torch.float32, device=device),
        segments_run=np.zeros(n_components, np.int32),
        block_tables=block_tables)


def _slice_ctx(ctx, lo: int, hi: int):
    """Batch-slice a decode context: the per-slot exit mask ``live`` (B,),
    ``cross`` (B, T, d), the paged layout's block tables (K, B, nblk) and
    per-slot kpos rings (B, W) carry a batch dim; everything else (the
    lane-wide kpos ring, scalars) passes through."""
    out = dict(ctx)
    for key in ("live", "cross"):
        if ctx.get(key) is not None:
            out[key] = ctx[key][lo:hi]
    if ctx.get("block_tables") is not None:
        out["block_tables"] = ctx["block_tables"][:, lo:hi]
    for key in ("kpos", "kpos_t"):
        if ctx.get(key) is not None and ctx[key].dim() == 2:
            out[key] = ctx[key][lo:hi]
    return out


def _check_supported(cfg) -> None:
    if cfg.kernel_tune.enabled:
        raise NotImplementedError(
            "kernel tile autotuning comes with the autotune slice of the "
            "port")
    if cfg.autotune.enabled:
        raise NotImplementedError(
            "the autotune telemetry rider and live thresholds come with the "
            "autotune slice of the port")


class StagedExecutor:
    """Segment-at-a-time cascade decode under one :class:`ExitDecider`."""

    def __init__(self, model, cfg=None, decider: Optional[ExitDecider] = None):
        self.model = model
        self.cfg = cfg or model.cfg
        _check_supported(self.cfg)
        self.decider = decider or ExitDecider.from_config(self.cfg)
        self.mode = self.cfg.cascade.exit_mode
        self.layout = self.cfg.cascade.cohort_layout
        self.n_components = self.cfg.cascade.n_components
        kt = self.cfg.kernel_tune
        # the exit-head megakernel needs the fused-scan decider; heads the
        # fusion cannot express fall back per segment inside _scan_exit
        self.use_megakernel = bool(kt.megakernel and self.decider.fused_scan)
        self.use_cohort_scatter = bool(kt.cohort_scatter)
        # device -> host reads of the skip predicates (cond_batch branches)
        self.host_syncs = 0
        # which branch each deep segment of a cohort-split step took: under
        # cond_batch in the major layout the one the exit state picked;
        # select mode always runs the per-cohort ("mixed") path
        self.dispatch = {"all_skip": 0, "mixed": 0, "all_run": 0}

    # ------------------------------------------------------------------
    def init_state(self, batch: int, t: int = 0, active=None,
                   block_tables=None) -> DecodeState:
        """Fresh carry; ``block_tables`` (paged layout) ride it as data."""
        return init_decode_state(self.decider, batch, self.n_components, t=t,
                                 active=active, device=self.model.device,
                                 block_tables=block_tables)

    def _carry_forward(self, state: DecodeState,
                       decision: ExitDecision) -> DecodeState:
        conf = decision.confidence.float()
        ema = torch.where(state.active,
                          CONF_EMA_DECAY * state.ema_conf
                          + (1.0 - CONF_EMA_DECAY) * conf,
                          state.ema_conf)
        return state.replace(policy=decision.state, ema_conf=ema)

    # ------------------------------------------------------------------
    def prefill(self, params, tokens, cache,
                state: Optional[DecodeState] = None):
        """Full-sequence prefill; returns (decision, cache, state) with the
        prefill decision seeding the stateful-measure carry and ``t`` set
        past the prompt."""
        if state is None:
            state = self.init_state(tokens.shape[0])
        logits, cache = self.model.prefill(params, tokens, cache,
                                           block_tables=state.block_tables)
        decision, _ = self.decider.decide_with_carry(
            logits, state=state.policy, active=state.active)
        state = self._carry_forward(state, decision).replace(
            t=int(tokens.shape[1]))
        return decision, cache, state

    # ------------------------------------------------------------------
    def _scan_exit(self, si, params, h, ths, sc=None, state=None, live=None):
        """Measure segment ``si``'s exit from its hidden state ``h``
        ((B, 1, d)) and fold it into the decision scan — THE exit-head call
        of every decode path.  With the megakernel it is
        :meth:`ExitDecider.scan_hidden` (``live`` lets dead rows pass
        through); heads the fusion cannot express (enhancement MLP,
        layernorm bias) and non-fused deciders take ``exit_logits`` +
        :meth:`ExitDecider.scan_logits`."""
        if self.use_megakernel:
            hp = self.model.exit_head_params(params, si)
            if hp is not None:
                return self.decider.scan_hidden(
                    si, self.n_components, h[:, 0, :], hp[0], hp[1], ths,
                    carry=sc, state=state, live=live, eps=self.cfg.norm_eps)
        lg = self.model.exit_logits(params, si, h)[:, 0, :]
        return self.decider.scan_logits(si, self.n_components, lg, ths, sc,
                                        state=state)

    def _segment_paths(self, si, ctx, params, ths):
        """(run, skip) closures for one deeper segment over one cohort's
        (h, seg_cache, carry): ``run`` computes the segment and folds its
        exit into the scan; ``skip`` only backfills the segment's caches
        from the exit hidden state.  The confidence EMA folds once at the
        step boundary (:meth:`_carry_forward`), never inside these
        branches."""
        model = self.model

        def run(h, seg_cache, sc):
            h2, nc2, _ = model.run_segment(si, params, h, ctx, seg_cache)
            return h2, nc2, self._scan_exit(si, params, h2, ths, sc,
                                            live=ctx.get("live"))

        def skip(h, seg_cache, sc):
            if self.cfg.cascade.state_backfill:
                seg_cache = model.backfill_segment(si, params, h, ctx,
                                                   seg_cache)
            return h, seg_cache, sc

        return run, skip

    def _segment_step(self, si, ctx, params, ths, h, seg_cache, sc, active,
                      skip=None, land=None):
        """One (segment, cohort) cell: branch-skip in ``cond_batch`` mode,
        compute-and-select in ``select`` mode.  Returns (h, carry, ran) with
        ``ran`` 0/1 for ``segments_run``.

        ``skip`` is the cell's skip predicate when the caller already read
        it to the host (cohort-split steps read all C at once); otherwise
        ``cond_batch`` reads it here, one host sync.  ``land(selected)``
        writes ``select`` mode's selected cache leaves into the slab (the
        cohort scatter); without it each leaf lands by ``copy_``."""
        run, skip_fn = self._segment_paths(si, ctx, params, ths)
        if self.mode == "cond_batch":
            if skip is None:
                self.host_syncs += 1
                skip = bool(self.decider.should_skip(sc, active))
            if skip:
                h, _, sc = skip_fn(h, seg_cache, sc)
                return h, sc, 0
            h, _, sc = run(h, seg_cache, sc)
            return h, sc, 1
        # select: both paths compute and the predicate selects.  Caches are
        # written in place, so the skip path writes into a snapshot of the
        # segment's caches and the selected rows land back in place.  Under
        # the paged layout the snapshot is the engine-wide store: correct
        # (other slots' blocks are equal in both copies), but one full-store
        # copy per cell.
        pred = self.decider.should_skip(sc, active)
        snap = nn.tree_map(torch.clone, seg_cache)
        h_full, nc, sc_full = run(h, seg_cache, sc)
        h_lite, lite, sc_lite = skip_fn(h, snap, sc)
        sel = [torch.where(pred, lite_t, full_t) for full_t, lite_t in
               zip(nn.tree_leaves(nc), nn.tree_leaves(lite))]
        if land is None:
            for full_t, sel_t in zip(nn.tree_leaves(nc), sel):
                full_t.copy_(sel_t)
        else:
            land(sel)
        sc = {k: (None if v is None else torch.where(pred, sc_lite[k], v))
              for k, v in sc_full.items()}
        return torch.where(pred, h_lite, h_full), sc, 1

    def _read_skips(self, sc_parts, act_parts):
        """The C cohorts' skip predicates, stacked and read to the host in
        one sync."""
        self.host_syncs += 1
        return torch.stack([self.decider.should_skip(s, a) for s, a in
                            zip(sc_parts, act_parts)]).tolist()

    # ------------------------------------------------------------------
    def decode_step(self, params, token, cache, state: DecodeState):
        """One staged decode step.  token: (B, 1) int32.

        Returns (decision, cache, state).  Segment 0 always runs; each
        deeper segment runs only while some live sequence (of the cohort,
        with ``n_cohorts > 1``) has not exited (cond_batch), or
        computes-but-masks (select).  ``segments_run`` counts in cohort
        units: C per segment per step when nothing skips.

        ``cascade.cohort_layout`` (outputs identical):

        * ``"major"`` — h, the decision carry, the context and the active
          mask split into per-cohort views ONCE; each deep segment then
          dispatches on the C predicates: all skip -> one whole-batch
          backfill; none skip -> one whole-batch segment; mixed -> the
          per-cohort steps over cohort views of the cache slab.
        * ``"copy"`` — every deep segment steps each cohort on its slice
          and re-joins h and the carry, whatever the exit state.
        """
        model, decider, n_m = self.model, self.decider, self.n_components
        ths = decider.resolved_thresholds(n_m)
        t = state.t
        C = effective_cohorts(self.cfg.cascade.n_cohorts, token.shape[0])
        h, ctx = model.begin_decode(params, token, t, cache)
        ctx["live"] = state.active
        # paged layout: the block tables ride the carry; the model hands
        # each segment its own rows
        if state.block_tables is not None:
            ctx["block_tables"] = state.block_tables
        segs = cache["segments"]
        h, _, _ = model.run_segment(0, params, h, ctx, segs[0])
        sc = self._scan_exit(0, params, h, ths, state=state.policy,
                             live=state.active)
        if C == 1:
            ran = [1]
            for si in range(1, n_m):
                h, sc, r = self._segment_step(si, ctx, params, ths, h,
                                              segs[si], sc, state.active)
                ran.append(r)
        else:
            step = self._cohorts_copy if self.layout == "copy" \
                else self._cohorts_major
            sc, ran = step(params, ths, h, ctx, segs, sc, state.active, C)
            ran = [C] + ran
        decision = decider.finish_scan(sc)
        cache = model.commit_decode(cache, segs, t)
        state = self._carry_forward(state, decision).replace(
            t=t + 1,
            segments_run=state.segments_run + np.asarray(ran, np.int32))
        return decision, cache, state

    @staticmethod
    def _cohort_views(seg, lo, hi, ctx):
        """Cohort [lo, hi) of a segment's caches: views of the slab, so
        every in-place write lands in the slab.  A paged store has no
        batch axis: every cohort gets the whole shared store and addresses
        it through its own table rows (sliced in its context)."""
        if ctx.get("block_tables") is not None:
            return seg
        return nn.tree_map(lambda x: x[:, lo:hi], seg)

    def _cohorts_copy(self, params, ths, h, ctx, segs, sc, active, C):
        """The copy layout: slice every deep segment per cohort, step each
        cohort, re-join h and the carry.  Returns (carry, ran[1:])."""
        decider = self.decider
        Bc = h.shape[0] // C
        spans = [(c * Bc, (c + 1) * Bc) for c in range(C)]
        ran = []
        for si in range(1, self.n_components):
            sc_parts = [decider.slice_carry(sc, lo, hi) for lo, hi in spans]
            preds = (self._read_skips(sc_parts, [active[lo:hi]
                                                 for lo, hi in spans])
                     if self.mode == "cond_batch" else [None] * C)
            h_parts, r_si = [], 0
            for c, (lo, hi) in enumerate(spans):
                h_c, sc_parts[c], r = self._segment_step(
                    si, _slice_ctx(ctx, lo, hi), params, ths, h[lo:hi],
                    self._cohort_views(segs[si], lo, hi, ctx), sc_parts[c],
                    active[lo:hi], skip=preds[c])
                h_parts.append(h_c)
                r_si += r
            h = torch.cat(h_parts, dim=0)
            sc = decider.concat_carry(sc_parts)
            ran.append(r_si)
        return sc, ran

    def _cohorts_major(self, params, ths, h, ctx, segs, sc, active, C):
        """The major layout's three-way dispatch per deep segment.  Returns
        (carry, ran[1:])."""
        model, decider = self.model, self.decider
        Bc = h.shape[0] // C
        spans = [(c * Bc, (c + 1) * Bc) for c in range(C)]
        h_parts = [h[lo:hi] for lo, hi in spans]
        sc_parts = [decider.slice_carry(sc, lo, hi) for lo, hi in spans]
        ctx_parts = [_slice_ctx(ctx, lo, hi) for lo, hi in spans]
        act_parts = [active[lo:hi] for lo, hi in spans]
        ran = []
        for si in range(1, self.n_components):
            seg = segs[si]
            if self.mode == "cond_batch":
                preds = self._read_skips(sc_parts, act_parts)
                n_skip = sum(preds)
                branch = ("all_skip" if n_skip == C else
                          "all_run" if n_skip == 0 else "mixed")
            else:
                # select: the fixed-graph per-cohort path every step
                preds, branch = [None] * C, "mixed"
            self.dispatch[branch] += 1
            if branch == "all_skip":
                if self.cfg.cascade.state_backfill:
                    model.backfill_segment(si, params, torch.cat(h_parts),
                                           ctx, seg)
                ran.append(0)
            elif branch == "all_run":
                h2, _, _ = model.run_segment(si, params, torch.cat(h_parts),
                                             ctx, seg)
                sc2 = self._scan_exit(si, params, h2, ths,
                                      decider.concat_carry(sc_parts),
                                      live=ctx["live"])
                h_parts = [h2[lo:hi] for lo, hi in spans]
                sc_parts = [decider.slice_carry(sc2, lo, hi)
                            for lo, hi in spans]
                ran.append(C)
            else:
                r_si = 0
                for c, (lo, hi) in enumerate(spans):
                    # under cond_batch the cohort's rows are written in
                    # place through the views: no re-join, no scatter
                    # (a paged store has no cohort rows to scatter: the
                    # selection lands through copies of the whole store)
                    land = None
                    if (self.mode == "select" and self.use_cohort_scatter
                            and ctx.get("block_tables") is None):
                        land = functools.partial(self._scatter, seg, c, C)
                    h_parts[c], sc_parts[c], r = self._segment_step(
                        si, ctx_parts[c], params, ths, h_parts[c],
                        self._cohort_views(seg, lo, hi, ctx), sc_parts[c],
                        act_parts[c], skip=preds[c], land=land)
                    r_si += r
                ran.append(r_si)
        return decider.concat_carry(sc_parts), ran

    @staticmethod
    def _scatter(seg, c, C, selected):
        """Land cohort c's selected cache leaves in the slab: one
        cohort-scatter launch for the whole segment tree."""
        from repro_torch.kernels.ops import cohort_scatter_tree
        cohort_scatter_tree(list(nn.tree_leaves(seg)), selected, c, C)
