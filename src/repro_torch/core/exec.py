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
  writes) and skip their matmuls.  The reference's ``lax.cond`` takes one
  of two forms, picked by :attr:`StagedExecutor.branches`: on the host
  runtime (``None``) a Python branch on the predicate read to the host,
  one host sync per deep segment per step, counted in
  :attr:`StagedExecutor.host_syncs`; inside the device runtime's captured
  CUDA graph an IF node per branch, the predicate read on the device
  (:mod:`repro_torch.kernels.cond_node`).
* ``exit_mode == "select"`` — every segment computes and the skip predicate
  selects the results, with no host sync; the two modes produce identical
  tokens, exit indices and carried state.

Both branches of a cell write their results in place — h and the
decision-scan carry into the tensors the step reads after the branch, the
caches into their slabs — so that what follows a branch reads the same
addresses whichever side ran (what a captured graph needs).

Cohort-split execution (``cascade.n_cohorts > 1``) gives each of C
contiguous, equal-size cohorts its own skip predicate, in one of two
layouts (identical outputs; see :meth:`StagedExecutor.decode_step`):
``"major"`` dispatches each deep segment on the lane's exit state (all
cohorts skip / mixed / all run), ``"copy"`` always slices and re-joins per
cohort.  The host runtime reads the C stacked skip predicates once per
deep segment (:attr:`StagedExecutor.host_syncs`) and counts the dispatch
branch it took (:attr:`StagedExecutor.dispatch`); under a capture the
three branches are IF nodes, the mixed one holding each cohort's, and the
branch counts and ``segments_run`` are device counters of the runner.

Caches are written in place, so a cohort's segment step over a view of the
cache slab leaves its rows in the slab: the reference's per-cohort cache
re-join (a concat, or the cohort-scatter kernel) has no counterpart under
``cond_batch``.  Only ``select`` mode computes a cohort's rows out of place
(the skip-masked selection).  What a decode step writes depends on the
leaf's kind (the block kind's ``state_keys`` and ``read_keys``, read
through ``model.leaf_kinds``): a RING leaf (an attention k/v ring) only at
ring slot ``t % W``, so ``select`` snapshots just that slot's rows; a
STATE leaf (a Mamba2 layer's recurrent state and conv window) whole, so
``select`` snapshots the whole leaf, into scratch the executor allocates
once per leaf shape outside any capture (:class:`_SlotRows`) — both
branches must start from the step's entry state, since re-running a
recurrence in place would advance it twice; a READ-ONLY leaf (an encdec
layer's cross K/V, written by the prefill) not at all, so it is neither
snapshotted, selected nor landed — a cohort's step only reads it through
its view of the slab.  The run's writes and the skip
path's are read after each, and the selection lands back — through
in-place copies, or with ``kernel_tune.cohort_scatter`` through the
cohort-scatter kernel: one launch per cohort writes the cohort's ring slot
rows straight into the segment's slab (its slot route), one more its state
leaves whole (the whole-cohort route, the TPU kernel's own contract).

Under the paged layout (``DecodeState.block_tables`` set) the stores are
shared by every slot and have no batch axis: each cohort steps over the
whole store through its own table rows, and ``select`` mode's slot rows
are the (block, offset) rows its table points at (the cohort scatter has
no cohort rows to write there).

The per-slot ``DecodeState.active`` mask also rides in the decode context
(``ctx["live"]``), where the decode-attention kernel skips dead slots and
the megakernel passes dead rows' carries through.

The threshold vector δ̂ is always an ``(n_components,)`` f32 device tensor
the exit kernels read from device memory: the lane's live vector
(``DecodeState.thresholds``, autotune) or, without one, the executor's own
copy of the config's resolved vector, rewritten in place if it changes.
A captured step therefore reads δ̂ at replay time.

With ``cfg.autotune.enabled`` the decision carry holds the telemetry rider
(``tcode``) and the step folds it into ``DecodeState.tel``
(:mod:`repro_torch.autotune.telemetry`).  Every
``autotune.shadow_every``-th step (``t % shadow_every == 0``) is a shadow
step: a cell the skip predicate drops is OBSERVED — the segment computes
from the shadow hidden chain ``hs`` and lands only its rider row, while
the caches (its slot rows put back, then the skip path's backfill), h, the
decision carry and the streaks keep skip semantics — so token streams are
those of autotune off.  Under ``cond_batch`` the skip branch becomes
``IF(shadow) observe else skip`` (two IF nodes under a capture), the major
layout takes the mixed branch on a shadow step whenever a cohort skips,
and ``select`` mode runs from the shadow chain and takes the rider row
from the run.  An observation snapshots and restores a segment's writes as
``select`` does (ring slot rows, state leaves whole).  On the host runtime
the shadow flag is a host bool from the caller's position mirror; under a
capture it is read on the device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core.policy import ExitDecider, ExitDecision
from repro_torch import parallel
from repro_torch.models import nn
from repro_torch.models.blocks import slot_rows

# EMA decay for the per-slot answering-confidence telemetry carried in
# DecodeState (same decay as DepthCompactor's host-side depth prior).
CONF_EMA_DECAY = 0.8
# the major layout's deep-segment dispatch branches, in counter order
DISPATCH = ("all_skip", "mixed", "all_run")


def effective_cohorts(n_cohorts: int, batch: int) -> int:
    """Largest divisor of ``batch`` that is <= ``n_cohorts`` (>= 1)."""
    c = max(1, min(int(n_cohorts), int(batch)))
    while batch % c:
        c -= 1
    return c


@dataclasses.dataclass(frozen=True)
class _MeshCohorts:
    """The cohorts of a batch split over the mesh's ``data`` ranks: the
    lane's C_g cohorts are the one-rank run's (``effective_cohorts`` of
    the whole batch); this rank holds ``local`` of them — whole cohorts
    (C_g a multiple of the data size), or a fragment of one (the data size
    a multiple of C_g, ``ranks_per`` ranks a cohort) — at global indices
    [base, base + local)."""

    total: int
    local: int
    base: int
    ranks_per: int


def mesh_cohorts(n_cohorts: int, batch: int, t=None):
    """:class:`_MeshCohorts` of a rank's ``batch`` rows under transport
    ``t`` (the active one by default), or None without a mesh of more than
    one rank.  On a ``model``-only mesh every rank holds the whole lane
    (its predicates are still agreed, :meth:`StagedExecutor._skip_preds`).
    A cohort count the data size neither divides nor is divided by is
    refused."""
    t = t if t is not None else parallel.active()
    if t is None or t.size("world") == 1:
        return None
    D, di = t.size("data"), t.rank("data")
    total = effective_cohorts(n_cohorts, batch * D)
    if total % D == 0:
        local = total // D
        return _MeshCohorts(total, local, di * local, 1)
    if D % total == 0:
        per = D // total
        return _MeshCohorts(total, 1, di // per, per)
    raise ValueError(f"{total} cohorts over a data axis of {D} ranks: "
                     "neither divides the other")


@dataclasses.dataclass
class DecodeState:
    """Per-lane decode carry.

    t             () int32   — decode position == cache-write cursor, a
                               0-d tensor on the lane's device (a captured
                               step reads it from device memory; the
                               engine keeps a host mirror).
    active        (B,) bool  — sequences still generating.
    policy        stateful-measure carry ((n_components, B) int32 patience
                               streaks) or None.
    ema_conf      (B,) f32   — EMA of the answering confidence per slot.
    segments_run  (n_components,) int32 numpy — how many decode steps
                               actually computed each segment (host-side:
                               the host runtime knows the branch that ran;
                               the device runtime counts on the device and
                               adds its counts at the chunk's sync).
    block_tables  (n_components, B, W/block_size) int32 paged-cache block
                               tables (``cache_layout="paged"``), or None
                               (dense slab).
    tel           :class:`repro_torch.autotune.telemetry.ExitTelemetry`
                               counters (updated in place), or None
                               (autotune off).
    thresholds    (n_components,) f32 device tensor: the live threshold
                               vector (autotune; a push writes into it), or
                               None (the config's vector).
    """

    t: torch.Tensor
    active: torch.Tensor
    policy: Optional[torch.Tensor]
    ema_conf: torch.Tensor
    segments_run: np.ndarray
    block_tables: Optional[torch.Tensor] = None
    tel: Optional[object] = None
    thresholds: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "DecodeState":
        return dataclasses.replace(self, **kw)


def init_decode_state(decider: ExitDecider, batch: int, n_components: int,
                      t: int = 0, active=None, device=None,
                      block_tables=None, telemetry=None,
                      thresholds=None) -> DecodeState:
    """Fresh decode carry for a lane of ``batch`` sequences; ``telemetry``
    and a ``thresholds`` vector (autotune) ride it as given."""
    active = (torch.ones(batch, dtype=torch.bool, device=device)
              if active is None
              else torch.as_tensor(active, dtype=torch.bool, device=device))
    return DecodeState(
        t=torch.full((), int(t), dtype=torch.int32, device=active.device),
        active=active,
        policy=decider.measure.init_state(n_components, batch, device),
        ema_conf=torch.zeros(batch, dtype=torch.float32, device=device),
        segments_run=np.zeros(n_components, np.int32),
        block_tables=block_tables,
        tel=telemetry,
        thresholds=(None if thresholds is None else torch.as_tensor(
            np.asarray(thresholds, np.float32)).to(active.device)))


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


class StagedExecutor:
    """Segment-at-a-time cascade decode under one :class:`ExitDecider`."""

    def __init__(self, model, cfg=None, decider: Optional[ExitDecider] = None):
        self.model = model
        self.cfg = cfg or model.cfg
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
        self.dispatch = dict.fromkeys(DISPATCH, 0)
        # the branch runner (repro_torch.kernels.cond_node): None reads each
        # predicate to the host; a capture makes each branch an IF node
        self.branches = None
        # the config's resolved threshold vector: (tuple, (n_m,) f32 tensor
        # on the model's device, written in place when the tuple changes)
        self._static_ths = None
        # snapshot scratch for whole state leaves: (role, the leaf's place
        # among its segment's state leaves, shape, dtype, device) -> tensor,
        # allocated on first use outside any capture (a capture's warm-up
        # iteration forces every branch first); the lanes step one at a
        # time on one stream, so they share it
        self._scratch = {}

    # ------------------------------------------------------------------
    # sentinel: init_state should build fresh telemetry itself
    _AUTO_TELEMETRY = object()

    def init_state(self, batch: int, t: int = 0, active=None,
                   block_tables=None, mac_weights=None,
                   telemetry=_AUTO_TELEMETRY) -> DecodeState:
        """Fresh carry; ``block_tables`` (paged layout) ride it as data.
        With ``cfg.autotune.enabled`` it also gets zeroed telemetry
        (``mac_weights`` prices the exits) — or ``telemetry``, existing
        counters a lane's re-prefill carries over — and a live threshold
        vector seeded from the config."""
        tel = thresholds = None
        if self.cfg.autotune.enabled:
            if telemetry is self._AUTO_TELEMETRY:
                from repro_torch.autotune.telemetry import telemetry_for
                tel = telemetry_for(self.cfg, mac_weights,
                                    device=self.model.device)
            else:
                tel = telemetry
            thresholds = self.cfg.cascade.thresholds
        return init_decode_state(self.decider, batch, self.n_components, t=t,
                                 active=active, device=self.model.device,
                                 block_tables=block_tables, telemetry=tel,
                                 thresholds=thresholds)

    def thresholds(self, state: DecodeState) -> torch.Tensor:
        """The δ̂ vector a step gates on, as an (n_components,) f32 device
        tensor: the live vector when the state has one, else the
        executor's copy of the resolved config vector (rewritten in place
        when the resolution changes, e.g. a refitted budget policy: a
        captured step reads its address)."""
        n_m = self.n_components
        if state.thresholds is not None:
            return self.decider.resolved_thresholds(n_m, state.thresholds)
        ths = self.decider.resolved_thresholds(n_m)
        if self._static_ths is None:
            self._static_ths = (ths, torch.tensor(
                ths, dtype=torch.float32, device=self.model.device))
        elif self._static_ths[0] != ths:
            vec = self._static_ths[1]
            vec.copy_(torch.tensor(ths, dtype=torch.float32))
            self._static_ths = (ths, vec)
        return self._static_ths[1]

    def _shadow(self, state: DecodeState, position: Optional[int]):
        """This step's shadow flag: False without telemetry; a 0-d device
        bool under a branch runner (read from ``state.t`` when the graph
        runs); else a host bool from ``position`` (the caller's mirror of
        ``state.t``) or, without one, from a read of ``state.t``."""
        if state.tel is None:
            return False
        every = int(self.cfg.autotune.shadow_every)
        if self.branches is not None:
            return (state.t % every) == 0
        if position is None:
            if state.t.device.type != "cpu":
                self.host_syncs += 1
            position = int(state.t)
        return position % every == 0

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
                state: Optional[DecodeState] = None, extra=None):
        """Full-sequence prefill; returns (decision, cache, state) with the
        prefill decision seeding the stateful-measure carry and ``t`` set
        past the prompt.  ``extra`` (the modality inputs) goes to the
        model's prefill."""
        if state is None:
            state = self.init_state(tokens.shape[0])
        logits, cache = self.model.prefill(params, tokens, cache, extra,
                                           block_tables=state.block_tables)
        decision, carry = self.decider.decide_with_carry(
            logits, thresholds=self.thresholds(state), state=state.policy,
            active=state.active)
        if state.tel is not None:
            # prefill computed every component: a free shadow observation
            from repro_torch.autotune.telemetry import accumulate_prefill
            accumulate_prefill(state.tel, carry["tcode"], state.active)
        state = self._carry_forward(state, decision).replace(
            t=self.model.position(tokens.shape[1]))
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
        tp = parallel.tensor_parallel()
        if tp is not None and self.decider.fused_scan:
            return self._scan_exit_parts(tp, si, params, h, ths, sc, state,
                                         live)
        if self.use_megakernel:
            hp = self.model.exit_head_params(params, si)
            if hp is not None:
                return self.decider.scan_hidden(
                    si, self.n_components, h[:, 0, :], hp[0], hp[1], ths,
                    carry=sc, state=state, live=live, eps=self.cfg.norm_eps)
        lg = self.model.exit_logits(params, si, h)[:, 0, :]
        return self.decider.scan_logits(si, self.n_components, lg, ths, sc,
                                        state=state)

    def _scan_exit_parts(self, tp, si, params, h, ths, sc, state, live):
        """:meth:`_scan_exit` over a head sharded by vocab across the
        ``model`` ranks (the exit kernels' partial contract): this rank's
        (max, Σexp, global argmax) triples — the megakernel's from h, or
        the exit-update kernel's from the rank's logits — gathered over
        ``model`` in rank order, then one combine launch folds them into
        the scan as the single-rank kernel does."""
        from repro_torch.kernels import ops
        hp = (self.model.exit_head_params(params, si)
              if self.use_megakernel else None)
        if hp is not None:
            off = tp.rank("model") * hp[1].shape[1]
            part = ops.exit_head_partial(h[:, 0, :], hp[0], hp[1],
                                         vocab_offset=off, live=live,
                                         eps=self.cfg.norm_eps)
        else:
            lg = self.model.exit_logits(params, si, h, local=True)[:, 0, :]
            part = ops.exit_partial(lg.contiguous(), vocab_offset=tp.rank(
                "model") * lg.shape[1])
        parts = tp.all_gather(part, "model")
        return self.decider.scan_parts(
            si, self.n_components, parts, ths, carry=sc, state=state,
            live=live if hp is not None else None)

    # -- branches ----------------------------------------------------------
    def _if(self, pred, fn, negate: bool = False) -> None:
        """``fn()`` when ``pred`` (negated with ``negate``) holds: a Python
        branch on a host bool, or through the branch runner — an IF node
        on a 0-d device bool under a capture."""
        if self.branches is None or isinstance(pred, bool):
            if bool(pred) != negate:
                fn()
        else:
            self.branches.run_if(pred, fn, negate=negate)

    def _read_skip(self, sc, active):
        """A cell's skip predicate: read to the host (one sync) on the host
        runtime, left on the device under a branch runner."""
        pred = self.decider.should_skip(sc, active)
        if self.branches is not None:
            return pred
        self.host_syncs += 1
        return bool(pred)

    def _read_skips(self, sc_parts, act_parts, mc=None):
        """The C cohorts' skip predicates: stacked and read to the host in
        one sync on the host runtime, device bools under a branch runner;
        with the whole lane's agreed skip vector on a multi-rank mesh
        (``mc``, :meth:`_skip_preds`), else None."""
        preds, whole = self._skip_preds(sc_parts, act_parts, mc)
        if self.branches is not None:
            return preds, whole
        self.host_syncs += 1
        return torch.stack(preds).tolist(), whole

    def _skip_preds(self, sc_parts, act_parts, mc=None):
        """The cohorts' skip predicates as device bools, never read to the
        host, and None.  On a multi-rank mesh (``mc``, the step's
        :func:`mesh_cohorts`) they are the one-rank run's over the whole
        lane: each local cohort's "some row still undecided" flag at its
        global index of a (C_g,) vector, OR-reduced over the mesh
        (:func:`~repro_torch.parallel.agree`), so that a cohort split over
        data ranks skips only where all its rows have exited and every
        rank takes the same branches; that vector's negation (the whole
        lane's skips, for the dispatch) comes with them."""
        preds = [self.decider.should_skip(s, a) for s, a in
                 zip(sc_parts, act_parts)]
        if mc is None:
            return preds, None
        vec = torch.zeros(mc.total, dtype=torch.bool,
                          device=preds[0].device)
        vec[mc.base:mc.base + mc.local] = ~torch.stack(preds)
        undecided = parallel.agree(vec)
        return list(~undecided[mc.base:mc.base + mc.local]), ~undecided

    def _cell_skips(self, sc_parts, act_parts, mc):
        """A deep segment's C cohort skip predicates and the whole lane's
        skips (:meth:`_skip_preds`): read under cond_batch; computed in
        select mode only on a multi-rank mesh, where its selectors must
        agree; else ``[None] * C`` (each cell computes its own)."""
        if self.mode == "cond_batch":
            return self._read_skips(sc_parts, act_parts, mc)
        if mc is not None:
            return self._skip_preds(sc_parts, act_parts, mc)
        return [None] * len(sc_parts), None

    @staticmethod
    def _land(h, sc, h_new, sc_new) -> None:
        """Write a branch's results into the step's h and carry tensors."""
        h.copy_(h_new)
        for k, v in sc_new.items():
            if v is not None and v is not sc[k]:
                sc[k].copy_(v)

    # -- one (segment, cohort) cell ----------------------------------------
    def _run_cell(self, si, ctx, params, ths, h, seg_cache, sc):
        """Compute segment ``si`` (caches written in place) and fold its
        exit into the scan: returns the new (h, carry)."""
        h2, _, _ = self.model.run_segment(si, params, h, ctx, seg_cache)
        return h2, self._scan_exit(si, params, h2, ths, sc,
                                   live=ctx.get("live"))

    def _skip_cell(self, si, ctx, params, h, seg_cache) -> None:
        """The skip path: only backfill the segment's caches from the exit
        hidden state.  h and the carry pass through.  The confidence EMA
        folds once at the step boundary (:meth:`_carry_forward`), never
        inside a branch."""
        if self.cfg.cascade.state_backfill:
            self.model.backfill_segment(si, params, h, ctx, seg_cache)

    def _observe_cell(self, si, ctx, params, ths, h, hs, seg_cache, sc):
        """A shadow step's skipped cell: compute segment ``si`` from the
        shadow chain ``hs`` for observation only — its slot rows put back,
        only the rider row landed, ``hs`` advanced — then take the skip
        path, so the caches, h and the carry keep skip semantics."""
        rows = self._rows(seg_cache, ctx, si)
        before = rows.read("before")
        h2s, _, _ = self.model.run_segment(si, params, hs, ctx, seg_cache)
        rows.write(before)
        obs = self._scan_exit(si, params, h2s, ths, sc, live=ctx.get("live"))
        sc["tcode"].copy_(obs["tcode"])
        hs.copy_(h2s)
        self._skip_cell(si, ctx, params, h, seg_cache)

    def _segment_step(self, si, ctx, params, ths, h, seg_cache, sc, active,
                      skip=None, land=None, shadow=False, hs=None):
        """One (segment, cohort) cell: branch-skip in ``cond_batch`` mode,
        compute-and-select in ``select`` mode.  ``h`` and the carry ``sc``
        (views of the step's tensors for a cohort) are updated in place.
        Returns ``ran`` for ``segments_run``: 0/1 on the host, a 0-d int
        device tensor under a branch runner.

        ``skip`` is the cell's skip predicate when the caller already read
        it (cohort-split steps read all C at once); otherwise ``cond_batch``
        reads it here.  ``land(selected)`` writes ``select`` mode's
        selected slot rows into the slab (the cohort scatter); without it
        they land by index copies.

        ``shadow`` / ``hs`` are the telemetry shadow pass (False / None on
        steps that are not shadow steps, and without telemetry): a skipped
        cell is observed (:meth:`_observe_cell`), a computed one carries
        the shadow chain along (``hs`` = h), and ``ran`` counts the
        observation."""
        if self.mode == "cond_batch":
            if skip is None:
                skip = self._read_skip(sc, active)
            if shadow is False:
                self._if(skip, lambda: self._skip_cell(si, ctx, params, h,
                                                       seg_cache))
                self._if(skip, lambda: self._land(h, sc, *self._run_cell(
                    si, ctx, params, ths, h, seg_cache, sc)), negate=True)
                if self.branches is None:
                    return 0 if skip else 1
                return (~skip).to(torch.int32)

            def skipped():
                self._if(shadow, lambda: self._observe_cell(
                    si, ctx, params, ths, h, hs, seg_cache, sc))
                self._if(shadow, lambda: self._skip_cell(
                    si, ctx, params, h, seg_cache), negate=True)

            def computed():
                self._land(h, sc, *self._run_cell(si, ctx, params, ths, h,
                                                  seg_cache, sc))
                hs.copy_(h)

            self._if(skip, skipped)
            self._if(skip, computed, negate=True)
            if self.branches is None:
                return 0 if (skip and not shadow) else 1
            return (~skip | shadow).to(torch.int32)
        # select: both paths compute and the predicate selects.  Caches are
        # written in place: snapshot what a step writes (ring slot rows,
        # state leaves whole), run, read the run's writes, put the
        # snapshot back, take the skip path from the entry state, select,
        # land the selection.  On a shadow step the run starts from the
        # shadow chain (equal to h while any sample is undecided) and its
        # rider row lands even where the cell skips.
        pred = (skip if skip is not None
                else self.decider.should_skip(sc, active))
        rows = self._rows(seg_cache, ctx, si)
        before = rows.read("before")
        h_full, sc_full = self._run_cell(si, ctx, params, ths,
                                         h if hs is None else hs,
                                         seg_cache, sc)
        full = rows.read("full")
        rows.write(before)
        self._skip_cell(si, ctx, params, h, seg_cache)
        sel = rows.select(pred, full)
        if land is None:
            rows.write(sel)
        else:
            land(rows, sel)
        picked = {k: (None if v is None else torch.where(pred, sc[k], v))
                  for k, v in sc_full.items()}
        if shadow is not False and sc_full["tcode"] is not None:
            picked["tcode"] = torch.where(~pred | shadow, sc_full["tcode"],
                                          sc["tcode"])
        self._land(h, sc, torch.where(pred, h, h_full), picked)
        if hs is not None:
            hs.copy_(h_full)
        return 1

    # ------------------------------------------------------------------
    def decode_step(self, params, token, cache, state: DecodeState,
                    position: Optional[int] = None):
        """One staged decode step.  token: (B, 1) int32.

        Returns (decision, cache, state).  Segment 0 always runs; each
        deeper segment runs only while some live sequence (of the cohort,
        with ``n_cohorts > 1``) has not exited (cond_batch), or
        computes-but-masks (select).  ``segments_run`` counts in cohort
        units: C per segment per step when nothing skips; a shadow step's
        observations count too.  Under a branch runner (:attr:`branches`)
        the counts go to its device counters and ``state.segments_run`` is
        returned as it came.  ``position`` is the caller's host mirror of
        ``state.t`` (the shadow schedule reads it on the host runtime).

        ``cascade.cohort_layout`` (outputs identical):

        * ``"major"`` — h, the decision carry, the context and the active
          mask split into per-cohort views ONCE; each deep segment then
          dispatches on the C predicates: all skip -> one whole-batch
          backfill; none skip -> one whole-batch segment; mixed -> the
          per-cohort steps over cohort views of the cache slab.  A shadow
          step takes the mixed branch whenever a cohort skips.  An MoE
          config's rows are not separable (expert capacity): it has no
          whole-batch segment branch, so none-skip steps take mixed.  An
          ssm (xLSTM) config has no whole-batch branch at all: every step
          steps per cohort (:meth:`_dispatch`).
        * ``"copy"`` — every deep segment steps each cohort on its slice
          of h and the carry, whatever the exit state.
        """
        model, decider, n_m = self.model, self.decider, self.n_components
        ths = self.thresholds(state)
        shadow = self._shadow(state, position)
        t = state.t
        # the step's cohorts over a data axis of more than one rank
        mc = mesh_cohorts(self.cfg.cascade.n_cohorts, token.shape[0])
        C = (effective_cohorts(self.cfg.cascade.n_cohorts, token.shape[0])
             if mc is None else mc.local)
        h, ctx = model.begin_decode(params, token, t, cache)
        ctx["live"] = state.active
        # paged layout: the block tables ride the carry; the model hands
        # each segment its own rows
        if state.block_tables is not None:
            ctx["block_tables"] = state.block_tables
        segs = cache["segments"]
        h, _, _ = model.run_segment(0, params, h, ctx, segs[0])
        if mc is not None:
            # a deep cell routes its cohort's rows as one call (the MoE
            # layers): the ranks_per data ranks that hold them
            ctx = {**ctx, "route_rows": parallel.active().data_block(
                mc.ranks_per)}
        sc = self._scan_exit(0, params, h, ths, state=state.policy,
                             live=state.active)
        # the shadow chain starts at the committed hidden state
        hs = None if shadow is False else h.clone()
        if C == 1:
            ran = [1] + [self._segment_step(
                si, ctx, params, ths, h, segs[si], sc, state.active,
                skip=(None if mc is None else self._cell_skips(
                    [sc], [state.active], mc)[0][0]),
                shadow=shadow, hs=hs)
                for si in range(1, n_m)]
        else:
            step = self._cohorts_copy if self.layout == "copy" \
                else self._cohorts_major
            ran = [C] + step(params, ths, h, ctx, segs, sc, state.active, C,
                             shadow, hs, mc)
        decision = decider.finish_scan(sc)
        cache = model.commit_decode(cache, segs, t)
        if state.tel is not None:
            from repro_torch.autotune.telemetry import accumulate_decode
            accumulate_decode(state.tel, sc["tcode"], decision.exit_index,
                              state.active, shadow, run_if=self._if)
        segments_run = state.segments_run
        if self.branches is None:
            segments_run = segments_run + np.asarray(ran, np.int32)
        else:
            for si, r in enumerate(ran):
                self.branches.segments[si:si + 1].add_(r)
        state = self._carry_forward(state, decision).replace(
            t=t + 1, segments_run=segments_run)
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

    def _cohorts_copy(self, params, ths, h, ctx, segs, sc, active, C,
                      shadow=False, hs=None, mc=None):
        """The copy layout: step every deep segment per cohort, on views of
        h and the carry.  Returns ran[1:]."""
        decider = self.decider
        Bc = h.shape[0] // C
        spans = [(c * Bc, (c + 1) * Bc) for c in range(C)]
        ran = []
        for si in range(1, self.n_components):
            sc_parts = [decider.slice_carry(sc, lo, hi) for lo, hi in spans]
            preds, _ = self._cell_skips(
                sc_parts, [active[lo:hi] for lo, hi in spans], mc)
            ran.append(sum(
                self._segment_step(
                    si, _slice_ctx(ctx, lo, hi), params, ths, h[lo:hi],
                    self._cohort_views(segs[si], lo, hi, ctx), sc_parts[c],
                    active[lo:hi], skip=preds[c], shadow=shadow,
                    hs=None if hs is None else hs[lo:hi])
                for c, (lo, hi) in enumerate(spans)))
        return ran

    def _dispatch(self, preds, C, shadow=False, whole=None):
        """The major layout's branch predicates {all_skip, mixed, all_run}
        from the C cohort skip predicates, counted; and the segment's
        ``ran`` (cohorts that compute or, on a shadow step, observe).  A
        shadow step never takes all_skip: its skipped cohorts are observed
        in the mixed branch.

        An MoE config (``n_experts > 0``) never takes all_run: expert
        capacity couples the rows routed together, so a whole-batch
        segment is not the per-cohort one (the reference's two-way
        dispatch).  Its all_run predicate is the constant False — no IF
        node is recorded for it — and every step that is not all_skip is
        mixed.

        An ssm (xLSTM) config never takes a whole-batch branch: its
        segments step per cohort every step, as select mode's do (the
        counters still count the branch the exit state picked).  Its
        decode cells round a row otherwise in a batch of C rows than in a
        cohort's (the batched products and reductions over the recurrent
        state — mLSTM's ``q @ C`` and ``q · n``, sLSTM's ``h @ r`` — take
        other cuBLAS and PyTorch kernels by batch size), and at random
        weights the family amplifies such rounding into other tokens
        (PERF.md §6), so only the per-cohort cell keeps cond_batch's
        streams bit for bit select mode's and autotune's shadow steps'."""
        separable = self.cfg.n_experts == 0
        # on a multi-rank mesh the branches follow the whole lane's C_g
        # cohorts (``whole``, their agreed skips); ``ran`` counts this
        # rank's
        Cg = C if whole is None else whole.numel()
        if self.mode == "select":
            # select: the fixed-graph per-cohort path every step
            cases = {"all_skip": False, "mixed": True, "all_run": False}
            ran = C
        elif self.branches is None:
            n_skip = sum(preds) if whole is None else int(whole.sum())
            cases = {"all_skip": n_skip == Cg and not shadow,
                     "all_run": separable and n_skip == 0}
            cases["mixed"] = not (cases["all_skip"] or cases["all_run"])
            ran = C if shadow else C - sum(preds)
        else:
            n_skip = torch.stack(preds).sum(dtype=torch.int32)
            ran = C - n_skip
            if whole is not None:
                n_skip = whole.sum(dtype=torch.int32)
            cases = {"all_skip": n_skip == Cg,
                     "all_run": (n_skip == 0) if separable else False}
            if shadow is not False:
                cases["all_skip"] = cases["all_skip"] & ~shadow
                ran = torch.where(shadow, C, ran)
            cases["mixed"] = ~(cases["all_skip"] | cases["all_run"])
        if self.branches is None:
            self.dispatch[next(k for k in DISPATCH if cases[k])] += 1
        elif self.mode == "select":
            self.branches.dispatch[1:2].add_(1)
        else:
            # MoE's all_run is the constant False: its counter stays 0
            keys = DISPATCH if separable else DISPATCH[:2]
            self.branches.dispatch[:len(keys)].add_(torch.stack(
                [cases[k] for k in keys]).to(torch.int32))
        if self.cfg.family == "ssm":
            # counted as the exit state picked, stepped per cohort
            cases = {"all_skip": False, "mixed": True, "all_run": False}
        return cases, ran

    def _cohorts_major(self, params, ths, h, ctx, segs, sc, active, C,
                       shadow=False, hs=None, mc=None):
        """The major layout's three-way dispatch per deep segment, on views
        of h and the carry.  Returns ran[1:]."""
        decider = self.decider
        Bc = h.shape[0] // C
        spans = [(c * Bc, (c + 1) * Bc) for c in range(C)]
        h_parts = [h[lo:hi] for lo, hi in spans]
        hs_parts = [None if hs is None else hs[lo:hi] for lo, hi in spans]
        sc_parts = [decider.slice_carry(sc, lo, hi) for lo, hi in spans]
        ctx_parts = [_slice_ctx(ctx, lo, hi) for lo, hi in spans]
        act_parts = [active[lo:hi] for lo, hi in spans]
        ran = []
        for si in range(1, self.n_components):
            seg = segs[si]
            preds, whole = self._cell_skips(sc_parts, act_parts, mc)
            cases, r_si = self._dispatch(preds, C, shadow, whole)

            def all_skip(si=si, seg=seg):
                self._skip_cell(si, ctx, params, h, seg)

            def all_run(si=si, seg=seg):
                self._land(h, sc, *self._run_cell(si, ctx, params, ths, h,
                                                  seg, sc))
                if hs is not None:
                    hs.copy_(h)

            def mixed(si=si, seg=seg):
                for c, (lo, hi) in enumerate(spans):
                    # under cond_batch the cohort's rows are written in
                    # place through the views: no re-join, no scatter
                    # (a paged store has no cohort rows to scatter: the
                    # selection lands through index copies)
                    land = None
                    if (self.mode == "select" and self.use_cohort_scatter
                            and ctx.get("block_tables") is None):
                        land = functools.partial(self._scatter, seg, c, C)
                    self._segment_step(
                        si, ctx_parts[c], params, ths, h_parts[c],
                        self._cohort_views(seg, lo, hi, ctx), sc_parts[c],
                        act_parts[c], skip=preds[c], land=land,
                        shadow=shadow, hs=hs_parts[c])

            self._if(cases["all_skip"], all_skip)
            self._if(cases["all_run"], all_run)
            self._if(cases["mixed"], mixed)
            ran.append(r_si)
        return ran

    def _rows(self, seg_cache, ctx, si) -> "_SlotRows":
        return _SlotRows(seg_cache, ctx, si,
                         self.model.leaf_kinds(si, seg_cache),
                         self._scratch_for)

    def _scratch_for(self, role: str, i: int,
                     like: torch.Tensor) -> torch.Tensor:
        """The ``role`` snapshot buffer for state leaf ``i`` of a segment
        (two stages of one length hold leaves of one shape: each needs its
        own), shaped ``like``, allocated once — never inside a capture,
        whose warm-up iteration has run every branch and so allocated
        every buffer a step needs."""
        key = (role, i, tuple(like.shape), like.dtype, like.device)
        buf = self._scratch.get(key)
        if buf is None:
            if like.is_cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"state snapshot scratch {key} first needed inside a "
                    "capture: the warm-up iteration must run every branch")
            buf = self._scratch[key] = torch.empty(
                like.shape, dtype=like.dtype, device=like.device)
        return buf

    def _scatter(self, seg, c, C, rows, selected):
        """Land cohort c's selection in the slab ``seg`` with the cohort
        scatter: one launch writes every ring leaf's slot rows at the ring
        slot (read by the kernel from device memory), one more every state
        leaf whole (the whole-cohort route; the two routes cannot share a
        launch).  Read-only leaves are not landed: nothing wrote them."""
        from repro_torch.kernels.ops import cohort_scatter_tree
        ring, state = _split_leaves(seg, rows.kinds)
        if ring:
            cohort_scatter_tree(ring, selected.ring, c, C, slot=rows.slot)
        if state:
            cohort_scatter_tree(state, selected.state, c, C)


def _split_leaves(seg_cache, kinds):
    """A segment's cache leaves split by their ``kinds``
    (:meth:`CascadeModel.leaf_kinds`) into (ring leaves, state leaves),
    each in :func:`nn.tree_leaves` order; read-only leaves are in neither.
    A list that does not have one entry per leaf is refused: a leaf it
    misses would be neither snapshotted nor landed."""
    leaves = list(nn.tree_leaves(seg_cache))
    if len(leaves) != len(kinds):
        raise ValueError(f"leaf kind list of {len(kinds)} entries for "
                         f"{len(leaves)} cache leaves")
    return ([x for x, k in zip(leaves, kinds) if k == "ring"],
            [x for x, k in zip(leaves, kinds) if k == "state"])


@dataclasses.dataclass
class _Snapshot:
    """What a decode step writes in a segment's caches: the ring leaves'
    slot rows (fresh tensors) and the state leaves whole (scratch
    buffers), each in its leaves' order."""

    ring: list
    state: list


class _SlotRows:
    """The writes of a decode step in segment ``si``'s caches, by leaf
    kind (``kinds``, :meth:`CascadeModel.leaf_kinds`; a read-only leaf
    has none and is left out):

    * a RING leaf's ring slot ``ctx["slot"]`` of every layer — (L, B, 1,
      kv, hd) of each dense leaf (L, B, W, kv, hd), or each table row's
      (block, offset) of a paged store (L, NB, bs, kv, hd), (L, B, kv,
      hd) — read and written by index ops on the device slot (no host
      read);
    * a STATE leaf (L, B, ...) whole, copied into and out of the
      executor's scratch (``scratch(role, i, like)`` for the segment's
      i-th state leaf), so its snapshot allocates nothing."""

    def __init__(self, seg_cache, ctx, si, kinds, scratch):
        self.kinds = kinds
        self.ring, self.state = _split_leaves(seg_cache, kinds)
        self.scratch = scratch
        self.slot = ctx["slot"]
        self.index = None
        if ctx.get("block_tables") is not None and self.ring:
            self.index = slot_rows(ctx["block_tables"][si], self.slot,
                                   self.ring[0].shape[2])

    def _read_ring(self):
        if self.index is None:
            return [x.index_select(2, self.slot.view(1)) for x in self.ring]
        return [x[(slice(None),) + self.index] for x in self.ring]

    def read(self, role: str) -> _Snapshot:
        """Snapshot the step's writes; ``role`` names the state leaves'
        scratch (two snapshots alive at once need two roles)."""
        return _Snapshot(self._read_ring(),
                         [self.scratch(role, i, x).copy_(x)
                          for i, x in enumerate(self.state)])

    def write(self, snap: _Snapshot) -> None:
        for x, r in zip(self.ring, snap.ring):
            if self.index is None:
                x.index_copy_(2, self.slot.view(1), r)
            else:
                x[(slice(None),) + self.index] = r
        for x, r in zip(self.state, snap.state):
            x.copy_(r)

    def select(self, pred, full: _Snapshot) -> _Snapshot:
        """``where(pred, what the leaves hold now, full)``: fresh ring rows,
        and the state leaves' selection written into ``full``'s own
        scratch."""
        ring = [torch.where(pred, now, f)
                for f, now in zip(full.ring, self._read_ring())]
        for x, f in zip(self.state, full.state):
            torch.where(pred, x, f, out=f)
        return _Snapshot(ring, full.state)
