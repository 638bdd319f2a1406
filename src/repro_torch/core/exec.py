"""Staged cascade execution: the :class:`DecodeState` carry and the
segment-skipping executor that makes early exit mean early *termination*.

The counterpart of the JAX package's ``core/exec.py`` for one cohort
(``n_cohorts == 1``).  :class:`StagedExecutor` runs the cascade one segment
at a time, feeding each segment's exit logits to the shared
:class:`~repro_torch.core.policy.ExitDecider` scan (the fused exit-update
kernel when ``cfg.use_kernels``):

* ``exit_mode == "cond_batch"`` — once every live sequence has exited,
  deeper segments take only the cheap ``backfill`` path (cache coherence
  writes) and skip their matmuls.  The reference's ``lax.cond`` becomes a
  Python branch on the device predicate: one host sync per deep segment
  per step, counted in :attr:`StagedExecutor.host_syncs` (the
  device-resident form comes with the device runtime).
* ``exit_mode == "select"`` — every segment computes and the skip predicate
  selects the results, with no host sync; the two modes produce identical
  tokens, exit indices and carried state.

The per-slot ``DecodeState.active`` mask also rides in the decode context
(``ctx["live"]``), where the decode-attention kernel skips dead slots.
"""
from __future__ import annotations

import dataclasses
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
    """

    t: int
    active: torch.Tensor
    policy: Optional[torch.Tensor]
    ema_conf: torch.Tensor
    segments_run: np.ndarray

    def replace(self, **kw) -> "DecodeState":
        return dataclasses.replace(self, **kw)


def init_decode_state(decider: ExitDecider, batch: int, n_components: int,
                      t: int = 0, active=None, device=None) -> DecodeState:
    """Fresh decode carry for a lane of ``batch`` sequences."""
    active = (torch.ones(batch, dtype=torch.bool, device=device)
              if active is None
              else torch.as_tensor(active, dtype=torch.bool, device=device))
    return DecodeState(
        t=int(t), active=active,
        policy=decider.measure.init_state(n_components, batch, device),
        ema_conf=torch.zeros(batch, dtype=torch.float32, device=device),
        segments_run=np.zeros(n_components, np.int32))


def _check_supported(cfg) -> None:
    if cfg.cascade.n_cohorts > 1:
        raise NotImplementedError(
            "n_cohorts > 1 (cohort-split skipping) comes in a later slice of "
            "the port")
    if cfg.kernel_tune.megakernel or cfg.kernel_tune.cohort_scatter:
        raise NotImplementedError(
            "kernel_tune.megakernel / cohort_scatter come in later slices of "
            "the port (the fused exit-head megakernel is the next one)")
    if cfg.kernel_tune.enabled:
        raise NotImplementedError(
            "kernel tile autotuning comes with the autotune slice of the "
            "port")
    if cfg.paged_cache.layout != "dense":
        raise NotImplementedError(
            "the paged KV layout comes in a later slice of the port")


class StagedExecutor:
    """Segment-at-a-time cascade decode under one :class:`ExitDecider`."""

    def __init__(self, model, cfg=None, decider: Optional[ExitDecider] = None):
        self.model = model
        self.cfg = cfg or model.cfg
        _check_supported(self.cfg)
        self.decider = decider or ExitDecider.from_config(self.cfg)
        self.mode = self.cfg.cascade.exit_mode
        self.n_components = self.cfg.cascade.n_components
        # device -> host reads of the skip predicate (cond_batch branches)
        self.host_syncs = 0

    # ------------------------------------------------------------------
    def init_state(self, batch: int, t: int = 0, active=None) -> DecodeState:
        return init_decode_state(self.decider, batch, self.n_components, t=t,
                                 active=active, device=self.model.device)

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
        logits, cache = self.model.prefill(params, tokens, cache)
        decision, _ = self.decider.decide_with_carry(
            logits, state=state.policy, active=state.active)
        state = self._carry_forward(state, decision).replace(
            t=int(tokens.shape[1]))
        return decision, cache, state

    # ------------------------------------------------------------------
    def _scan_exit(self, si, params, h, ths, sc=None, state=None):
        """Measure segment ``si``'s exit from its hidden state ``h``
        ((B, 1, d)) and fold it into the decision scan."""
        lg = self.model.exit_logits(params, si, h)[:, 0, :]
        return self.decider.scan_logits(si, self.n_components, lg, ths, sc,
                                        state=state)

    def _segment_paths(self, si, ctx, params, ths):
        """(run, skip) closures for one deeper segment: ``run`` computes
        the segment and folds its exit into the scan; ``skip`` only
        backfills the segment's caches from the exit hidden state.  The
        confidence EMA folds once at the step boundary
        (:meth:`_carry_forward`), never inside these branches."""
        model = self.model

        def run(h, seg_cache, sc):
            h2, nc2, _ = model.run_segment(si, params, h, ctx, seg_cache)
            return h2, nc2, self._scan_exit(si, params, h2, ths, sc)

        def skip(h, seg_cache, sc):
            if self.cfg.cascade.state_backfill:
                seg_cache = model.backfill_segment(si, params, h, ctx,
                                                   seg_cache)
            return h, seg_cache, sc

        return run, skip

    def _segment_step(self, si, ctx, params, ths, h, seg_cache, sc, active):
        """One deeper segment: branch-skip in ``cond_batch`` mode,
        compute-and-select in ``select`` mode.  Returns
        (h, seg_cache, carry, ran) with ``ran`` 0/1 for ``segments_run``."""
        run, skip_fn = self._segment_paths(si, ctx, params, ths)
        skip = self.decider.should_skip(sc, active)
        if self.mode == "cond_batch":
            self.host_syncs += 1
            if bool(skip):
                h, nc, sc = skip_fn(h, seg_cache, sc)
                return h, nc, sc, 0
            h, nc, sc = run(h, seg_cache, sc)
            return h, nc, sc, 1
        # select: both paths compute and the predicate selects.  Caches are
        # written in place, so the skip path writes into a snapshot of the
        # segment's caches and the selected values land back in place.
        snap = nn.tree_map(torch.clone, seg_cache)
        h_full, nc, sc_full = run(h, seg_cache, sc)
        h_lite, lite, sc_lite = skip_fn(h, snap, sc)
        for full_t, lite_t in zip(nn.tree_leaves(nc), nn.tree_leaves(lite)):
            full_t.copy_(torch.where(skip, lite_t, full_t))
        sc = {k: (None if v is None else torch.where(skip, sc_lite[k], v))
              for k, v in sc_full.items()}
        return torch.where(skip, h_lite, h_full), nc, sc, 1

    # ------------------------------------------------------------------
    def decode_step(self, params, token, cache, state: DecodeState):
        """One staged decode step.  token: (B, 1) int32.

        Returns (decision, cache, state).  Segment 0 always runs; each
        deeper segment runs only while some live sequence has not exited
        (cond_batch) or computes-but-masks (select)."""
        model, decider, n_m = self.model, self.decider, self.n_components
        ths = decider.resolved_thresholds(n_m)
        t = state.t
        h, ctx = model.begin_decode(params, token, t, cache)
        ctx["live"] = state.active
        segs = cache["segments"]
        ran = [1]
        h, _, _ = model.run_segment(0, params, h, ctx, segs[0])
        sc = self._scan_exit(0, params, h, ths, state=state.policy)
        for si in range(1, n_m):
            h, _, sc, r = self._segment_step(si, ctx, params, ths, h,
                                             segs[si], sc, state.active)
            ran.append(r)
        decision = decider.finish_scan(sc)
        cache = model.commit_decode(cache, segs, t)
        state = self._carry_forward(state, decision).replace(
            t=t + 1,
            segments_run=state.segments_run + np.asarray(ran, np.int32))
        return decision, cache, state
