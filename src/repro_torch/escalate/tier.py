"""Cross-model escalation tier: one ε-knob over a pool of engines.

The counterpart of the JAX package's ``escalate/tier.py``.
:class:`ModelCascadeTier` fronts an ORDERED pool of
:class:`repro_torch.serving.engine.CascadeServingEngine` instances — small
drafts first, large authorities last (Streeter's model-pool cascade, on
top of each model's own intra-model early-exit cascade).  A request
decodes on stage 0; every token its intra-model cascade answers at the
stage's FINAL component is additionally gated by the stage's escalation
threshold (:mod:`repro_torch.escalate.router` — the IDK answer-or-defer
rule).
A defer cancels the request at that token, keeps the committed prefix,
and re-submits the remainder to the next stage — replaying the prefix as
prefill when the stages can share it (:mod:`repro_torch.escalate.replay`).

The tier's one knob is solved, not hand-set:
:class:`TierThresholdController` merges the stages' live exit telemetry
into ONE joint histogram (stage 0 accumulated under
``autotune.route_final`` so its final-component confidence is a routing
axis; :func:`repro_torch.autotune.solver.compose_escalation` chains the
stages through the measured ``stage_agree``), prices every (stage,
component) exit with the heterogeneous per-stage analytic MACs
(:func:`repro_torch.autotune.solver.compose_mac_prefix` over each engine's
own ``mac_prefix``), runs the UNCHANGED ε / budget solver over the
composed histogram, and pushes the split result back: intra-model
thresholds into each engine's live δ̂ vectors (written in device memory,
which the exit kernels read: no capture on either engine), the
escalation threshold into the router.

The engines may share one device: each keeps its own lanes, caches and
(under the device runtime) captured graphs.  A defer found after a device
runtime chunk cancels the request at the deferring token; the slot leaves
the engine's next chunk through the live mask the chunk loads, and the
chunk's tail tokens stay counted as spent compute, as in the reference.

A tier is also a fleet member (:mod:`repro_torch.fleet`) through its entry
stage, and with the stages' flight recorders on, :meth:`ModelCascadeTier.
dump_flight` returns a request's flight on every stage it touched.

Parity corners (pinned by ``tests/test_torch_escalate.py``): escalation
threshold 0.0 never defers — the tier is bit-identical to stage 0 alone;
threshold 1.1 with stage 0's intra thresholds at the 1.1 never-exit
sentinel defers every request at its first token with an empty committed
prefix — the next stage sees the exact original workload and the tier is
bit-identical to that stage alone.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.autotune.solver import (ExitHistogram, compose_escalation,
                                         compose_mac_prefix, solve_budget,
                                         solve_epsilon, split_tier_thresholds)
from repro_torch.autotune.telemetry import merge_telemetry
from repro_torch.escalate.replay import build_replay, resolve_share_prefix
from repro_torch.escalate.router import EscalationRouter
from repro_torch.serving.engine import CascadeServingEngine, Request
from repro_torch.utils import get_logger

log = get_logger("escalate")


@dataclasses.dataclass
class _TierRequest:
    """Tier-side tracking of one request across stages."""
    request: Request
    order: int                       # submission index (FIFO restore)
    stage: int = 0
    cursor: int = 0                  # tokens cleared at the current stage
    escalations: int = 0
    committed: List[int] = dataclasses.field(default_factory=list)
    committed_depths: List[int] = dataclasses.field(default_factory=list)
    committed_confs: List[float] = dataclasses.field(default_factory=list)
    spans: List[dict] = dataclasses.field(default_factory=list)
    # rejected token awaiting its next-stage regeneration (stage-agree
    # telemetry); only meaningful when the prefix was shared — an
    # unshared restart regenerates a different context
    pending_regen: Optional[int] = None


class ModelCascadeTier:
    """Escalation across an ordered pool of serving engines."""

    def __init__(self, engines: Sequence[CascadeServingEngine],
                 controller: Optional["TierThresholdController"] = None,
                 auto_rebalance: bool = False,
                 donate_quantum: int = 4):
        if not engines:
            raise ValueError("need at least one engine")
        self.engines = list(engines)
        if len(set(id(e) for e in self.engines)) != len(self.engines):
            raise ValueError(
                "each stage needs its own engine instance (finished-"
                "record keys and KV state are per-engine)")
        v0 = self.engines[0].cfg.vocab_size
        for s, e in enumerate(self.engines[1:], start=1):
            if e.cfg.vocab_size != v0:
                # the ORIGINAL prompt must be valid input to every stage
                # (family mismatch only disables prefix replay; vocab
                # mismatch makes the request itself unservable)
                raise ValueError(
                    f"stage {s} vocab_size {e.cfg.vocab_size} != stage 0 "
                    f"vocab_size {v0}: every stage must share the prompt "
                    "token space")
        self.router = EscalationRouter([e.cfg for e in self.engines])
        self.controller = controller
        self.auto_rebalance = bool(auto_rebalance)
        self.donate_quantum = int(donate_quantum)
        self._tracked: Dict[int, _TierRequest] = {}
        self.finished: Dict[int, dict] = {}
        self._order = 0
        self._tick = 0
        self._escalations_total = 0
        self._discarded_draft_tokens = 0
        self._blocks_donated = 0
        if controller is not None:
            controller.attach(self)

    # -- public API ------------------------------------------------------
    def submit(self, req: Request):
        if req.rid in self._tracked or req.rid in self.finished:
            raise ValueError(f"duplicate rid {req.rid}")
        self._tracked[req.rid] = _TierRequest(request=req,
                                              order=self._order)
        self._order += 1
        self.engines[0].submit(req)

    # -- fleet member surface --------------------------------------------
    # A tier can be a FleetScheduler member beside plain engines: the fleet
    # talks to a tier through its ENTRY stage (stage 0), where fresh
    # traffic lands, queues and is admission-gated.  Deeper stages are
    # internal to the tier (escalated requests carry committed prefixes
    # the fleet must not requeue), so anything past the stage-0 queue
    # counts as live.  A tier has no fleet ``cancel``: a drain of it
    # degrades to "finish" mode.
    @property
    def cfg(self):
        """The ENTRY stage's config: what fleet placement and the
        aggregator's config_key check see."""
        return self.engines[0].cfg

    @property
    def admitting(self) -> bool:
        return self.engines[0].admitting

    @admitting.setter
    def admitting(self, value: bool) -> None:
        self.engines[0].admitting = bool(value)

    def free_slot_count(self) -> int:
        return self.engines[0].free_slot_count()

    def queued_count(self) -> int:
        return self.engines[0].queued_count()

    def live_rids(self) -> List[int]:
        """Tracked rids past the entry queue: decoding on some stage, or
        escalated (committed prefix held; never requeued by a fleet)."""
        queued = {r.rid for r in self.engines[0].queue}
        return [rid for rid in self._tracked if rid not in queued]

    def take_queue(self) -> List[Request]:
        """Fleet drain hook: remove and return the ENTRY queue's fresh
        requests (nothing decoded yet) and untrack them, so that a
        scheduler can requeue them to a sibling member.  Escalated
        requests never sit in the stage-0 queue (escalation only moves
        forward), so everything returned is an original submission."""
        taken = self.engines[0].take_queue()
        for req in taken:
            self._tracked.pop(req.rid, None)
        return taken

    def lane_telemetry(self) -> List:
        """The ENTRY stage's lane telemetry only: deeper stages run other
        cascades (another mac_prefix, maybe route_final axes), so their
        telemetry does not merge into a homogeneous fleet histogram —
        cross-stage solving is the TierThresholdController's job."""
        return self.engines[0].lane_telemetry()

    def current_thresholds(self):
        return self.engines[0].current_thresholds()

    def push_thresholds(self, thresholds) -> None:
        """Fleet-pushed thresholds land on the ENTRY stage (the cascade the
        fleet's merged histogram describes)."""
        self.engines[0].push_thresholds(thresholds)

    def set_escalation_threshold(self, stage: int, threshold: float):
        """Live escalation-threshold swap — plain data, like the engines'
        ``push_thresholds``; the next drain pass uses it."""
        self.router.set_threshold(stage, threshold)

    def step(self):
        """One tier tick: each stage steps, then its deferrals drain into
        the next stage (in original submission order, so escalated
        workloads replay FIFO — the bit-identity the parity corners
        pin)."""
        self._tick += 1
        for s in range(len(self.engines)):
            self.engines[s].step()
            self._drain(s)
        if self.controller is not None:
            self.controller.maybe_update(self)
        if self.auto_rebalance:
            self._rebalance()

    def run(self, max_ticks: int = 1000) -> Dict[int, dict]:
        for _ in range(max_ticks):
            if not self._tracked:
                break
            self.step()
        return self.finished

    # -- drain: defer / finalize ----------------------------------------
    def _streams(self, eng: CascadeServingEngine, rid: int):
        """A tracked request's live streams in ``eng``: (tokens, depths,
        confs, live) — or None while it still queues."""
        rec = eng.finished.get(rid)
        if rec is not None:
            return rec["tokens"], rec["exit_depths"], rec["confs"], False
        for lane in eng.lanes:
            for s in lane["slots"]:
                if not s.done and s.request is not None \
                        and s.request.rid == rid:
                    return s.generated, s.exit_depths, s.confs, True
        return None

    def _drain(self, stage: int):
        eng = self.engines[stage]
        deferrals: List[_TierRequest] = []
        for tr in list(self._tracked.values()):
            if tr.stage != stage:
                continue
            got = self._streams(eng, tr.request.rid)
            if got is None:
                continue                       # still queued
            tokens, depths, confs, live = got
            if tr.pending_regen is not None and len(tokens) > tr.cursor:
                # first regenerated token at the SAME context the draft
                # was rejected at — the stage-agree observation
                self.router.observe_regeneration(tr.pending_regen,
                                                 tokens[tr.cursor])
                tr.pending_regen = None
            d = self.router.first_defer(stage, depths, confs,
                                        start=tr.cursor)
            if d is None:
                tr.cursor = len(tokens)
                if not live:
                    self._finalize(tr, tokens, depths, confs, stage)
                continue
            if live:
                eng.cancel(tr.request.rid, keep=d)
            self._escalate(tr, tokens, depths, confs, d, stage)
            deferrals.append(tr)
        # restore FIFO before the next stage sees the deferred workload
        deferrals.sort(key=lambda tr: tr.order)
        for tr in deferrals:
            self.engines[tr.stage].submit(tr.request)

    def _escalate(self, tr: _TierRequest, tokens, depths, confs,
                  d: int, stage: int):
        """Commit ``tokens[:d]``, rebuild the request for stage+1."""
        if stage + 1 >= len(self.engines):
            raise AssertionError("last stage cannot defer")
        share = resolve_share_prefix(self.engines[stage].cfg,
                                     self.engines[stage + 1].cfg)
        rejected = int(tokens[d])
        if share:
            tr.committed.extend(int(t) for t in tokens[:d])
            tr.committed_depths.extend(int(x) for x in depths[:d])
            tr.committed_confs.extend(float(c) for c in confs[:d])
            tr.spans.append({"stage": stage, "n_tokens": d,
                             "kept": True})
        else:
            # the next stage restarts from the original prompt: every
            # earlier committed token (this stage's AND prior stages')
            # is draft output the tier discards from the final record
            self._discarded_draft_tokens += len(tr.committed) + d
            tr.committed.clear()
            tr.committed_depths.clear()
            tr.committed_confs.clear()
            tr.spans.append({"stage": stage, "n_tokens": d,
                             "kept": False})
        base = self._base_request(tr)
        prompt, max_new, replayed = build_replay(
            base.prompt, tr.committed, base.max_new_tokens, share)
        extra = dict(base.extra or {})
        extra["escalation"] = {"stage": stage + 1, "rid": base.rid,
                               "replayed": replayed}
        tr.request = Request(rid=base.rid, prompt=prompt,
                             max_new_tokens=max_new, extra=extra)
        tr.stage = stage + 1
        tr.cursor = 0
        tr.escalations += 1
        tr.pending_regen = rejected if share else None
        self._escalations_total += 1
        # flight recorder (repro_torch.obs): the source engine's flight
        # already carries its terminal ("escalate" through cancel, or
        # "exit" when the defer fired after a natural finish); stamp the
        # routing context only the tier knows, and log the hop on the
        # source engine's event track
        flight = self.engines[stage].flight
        if flight is not None:
            flight.annotate(base.rid, {
                "escalated_to_stage": stage + 1, "deferred_at": d,
                "replayed": replayed, "committed": len(tr.committed)})
            flight.on_event("escalate", {
                "rid": base.rid, "from_stage": stage,
                "to_stage": stage + 1, "deferred_at": d,
                "replayed": replayed, "kept": share})

    def _base_request(self, tr: _TierRequest) -> Request:
        """The ORIGINAL submission (prompt/budget before any replay)."""
        if tr.escalations == 0:
            return tr.request
        req = tr.request
        esc = (req.extra or {}).get("escalation", {})
        replayed = int(esc.get("replayed", 0))
        prompt = req.prompt[:len(req.prompt) - replayed] \
            if replayed else req.prompt
        extra = {k: v for k, v in (req.extra or {}).items()
                 if k != "escalation"}
        return Request(rid=req.rid, prompt=prompt,
                       max_new_tokens=req.max_new_tokens + replayed,
                       extra=extra or None)

    def _finalize(self, tr: _TierRequest, tokens, depths, confs,
                  stage: int):
        rid = tr.request.rid
        self.finished[rid] = {
            # committed prefixes + the answering stage's tokens; exit
            # depths and confidences stay STAGE-LOCAL (no global
            # component offsets — the parity corners compare these
            # streams bit-for-bit against a single engine's)
            "tokens": tr.committed + [int(t) for t in tokens],
            "exit_depths": tr.committed_depths + [int(x) for x in depths],
            "confs": tr.committed_confs + [float(c) for c in confs],
            "final_stage": stage,
            "escalations": tr.escalations,
            "spans": tr.spans + [{"stage": stage,
                                  "n_tokens": len(tokens),
                                  "kept": True}],
        }
        del self._tracked[rid]

    # -- cross-engine block donation -------------------------------------
    def _paged_pool(self, stage: int):
        eng = self.engines[stage]
        return eng.pcache.pool if getattr(eng, "paged", False) else None

    def _donation_compatible(self, a: int, b: int) -> bool:
        pa, pb = self._paged_pool(a), self._paged_pool(b)
        return (pa is not None and pb is not None
                and pa.block_bytes > 0 and pb.block_bytes > 0)

    def donate_blocks(self, src: int, dst: int, n: int) -> int:
        """Move ``n`` of stage ``src``'s soft-cap block units to stage
        ``dst``.  Physical stores never move (each engine owns its device
        buffers); what moves is ADMISSION headroom under a tier-level HBM
        budget — the donor stops admitting into the donated capacity, the
        recipient may use that much more of its own free list.  The trade
        is priced in BYTES: a draft-stage block and an authority-stage
        block cover different cache planes, so the recipient gains
        ``floor(n * src.block_bytes / dst.block_bytes)`` of ITS blocks
        (any remainder bytes stay unspent — the budget never inflates).
        Requires both pools paged with byte-priced blocks and soft caps
        already set; returns the recipient blocks actually granted,
        clamped so the donor's cap never drops below its current
        usage."""
        if src == dst:
            raise ValueError("src == dst")
        if not self._donation_compatible(src, dst):
            raise ValueError(
                f"stages {src} and {dst} cannot trade blocks: both must "
                "be paged with byte-priced blocks (block_bytes > 0)")
        ps, pd = self._paged_pool(src), self._paged_pool(dst)
        if ps.soft_cap is None or pd.soft_cap is None:
            raise ValueError(
                "block donation needs soft caps on both pools "
                "(set_soft_cap — a tier-level block budget); without "
                "caps each pool already admits to its physical limit")
        n = max(0, min(int(n), ps.soft_cap - ps.used))
        gained = (n * ps.block_bytes) // pd.block_bytes
        if n == 0 or gained == 0:
            return 0
        before = pd.soft_cap
        pd.set_soft_cap(pd.soft_cap + gained)
        granted = pd.soft_cap - before     # clamped at dst's physical
        # only charge the donor for what the recipient could bank
        charged = -(-(granted * pd.block_bytes) // ps.block_bytes)
        ps.set_soft_cap(ps.soft_cap - min(n, charged))
        self._blocks_donated += granted
        return granted

    def _rebalance(self):
        """One conservative auto-donation step: a stage that has queued
        work its capped pool cannot admit borrows ``donate_quantum``
        units from the compatible stage with the most idle cap slack."""
        for s, eng in enumerate(self.engines):
            pool = self._paged_pool(s)
            if (pool is None or pool.soft_cap is None
                    or not eng.queue or pool._cap_free() > 0):
                continue
            donors = [(self._paged_pool(d).soft_cap
                       - self._paged_pool(d).used, d)
                      for d in range(len(self.engines))
                      if d != s and self._donation_compatible(d, s)
                      and self._paged_pool(d).soft_cap is not None
                      and not self.engines[d].queue]
            donors = [x for x in donors if x[0] > 0]
            if not donors:
                continue
            slack, d = max(donors)
            self.donate_blocks(d, s, min(self.donate_quantum, slack))

    # -- observability (repro_torch.obs) ----------------------------------
    def dump_flight(self, rid: int):
        """Every stage's flight for ``rid`` (an escalated request shows one
        per stage it touched), or None when no stage recorded it."""
        out = []
        for k, eng in enumerate(self.engines):
            d = eng.dump_flight(rid)
            if d is not None:
                out.append({"stage": k, **d})
        return out or None

    # -- metrics ---------------------------------------------------------
    def stats(self) -> dict:
        final_stage = np.bincount(
            [r["final_stage"] for r in self.finished.values()],
            minlength=len(self.engines)).tolist() if self.finished else \
            [0] * len(self.engines)
        return {
            "requests_finished": len(self.finished),
            "requests_live": len(self._tracked),
            "escalations_total": self._escalations_total,
            "final_stage_histogram": final_stage,
            "discarded_draft_tokens": self._discarded_draft_tokens,
            "blocks_donated": self._blocks_donated,
            "router": self.router.stats(),
            "controller": (self.controller.stats()
                           if self.controller is not None else None),
            "stages": [e.stats() for e in self.engines],
        }


class TierThresholdController:
    """Heterogeneous-cost threshold autotuning for a 2-stage tier.

    Periodically merges both engines' live telemetry, composes the joint
    tier histogram (:func:`repro_torch.autotune.solver.compose_escalation`),
    runs the unchanged ε / budget solver over it with the composed
    per-(stage, component) MAC prefix, and pushes the split thresholds
    back as data — intra-model vectors via each engine's
    ``push_thresholds``, the escalation threshold via the tier router.

    Stage 0's engine must be built with ``autotune.route_final=True``
    (its final-component confidence is the escalation routing axis: the
    decode step folds it into the shadow histogram on both runtimes);
    stage 1 with ordinary autotune telemetry.  ``stage_agree`` is read
    from the router's online regeneration scoring once
    ``min_escalations`` rejections have been scored, ``stage_agree_prior``
    before that.
    """

    def __init__(self, epsilon: Optional[float] = None,
                 mac_budget: Optional[float] = None,
                 interval: int = 64, min_shadow: float = 64.0,
                 min_escalations: int = 8,
                 stage_agree_prior: float = 1.0,
                 replay_overhead: float = 0.0):
        if (epsilon is None) == (mac_budget is None):
            raise ValueError("pass exactly one of epsilon= / mac_budget=")
        if interval < 1:
            raise ValueError(f"interval must be >= 1, got {interval}")
        self.epsilon = epsilon
        self.mac_budget = mac_budget
        self.interval = int(interval)
        self.min_shadow = float(min_shadow)
        self.min_escalations = int(min_escalations)
        self.stage_agree_prior = float(stage_agree_prior)
        self.replay_overhead = float(replay_overhead)
        self.solves = 0
        self.skipped_starved = 0
        self.last_result = None
        self.last_thresholds = None
        self.last_stage_agree = None

    def attach(self, tier: ModelCascadeTier):
        if len(tier.engines) != 2:
            raise ValueError(
                f"TierThresholdController solves 2-stage tiers, got "
                f"{len(tier.engines)} stages (chain pairs for deeper "
                "pools)")
        for s, eng in enumerate(tier.engines):
            if not eng.cfg.autotune.enabled:
                raise ValueError(
                    f"stage {s} engine lacks autotune telemetry "
                    "(cfg.with_autotune(enabled=True))")
        if not tier.engines[0].cfg.autotune.route_final:
            raise ValueError(
                "stage 0 must be built with autotune.route_final=True — "
                "the escalation threshold is solved over its final-"
                "component confidence axis")

    def maybe_update(self, tier: ModelCascadeTier):
        if tier._tick % self.interval:
            return
        self.update(tier)

    def update(self, tier: ModelCascadeTier) -> bool:
        """One solve attempt; False when telemetry is still starved."""
        eng0, eng1 = tier.engines
        tels0, tels1 = eng0.lane_telemetry(), eng1.lane_telemetry()
        if not tels0 or not tels1:
            self.skipped_starved += 1
            return False
        tel0, tel1 = merge_telemetry(tels0), merge_telemetry(tels1)
        if (float(tel0["shadow_steps"]) < self.min_shadow
                or float(tel1["shadow_steps"]) < self.min_shadow):
            self.skipped_starved += 1
            return False
        # the route-final extra entry prices deferring PAST stage 0's
        # final component at stage-0 cost; the composed prefix then
        # re-prices every cell with the true heterogeneous tier costs
        p0 = [float(x) for x in eng0.mac_prefix]
        p1 = [float(x) for x in eng1.mac_prefix]
        h0 = ExitHistogram.from_telemetry(tel0,
                                          mac_prefix=p0 + [p0[-1]])
        h1 = ExitHistogram.from_telemetry(tel1, mac_prefix=p1)
        agree = tier.router.stage_agree(prior=self.stage_agree_prior,
                                        min_observations=self.min_escalations)
        joint = compose_escalation(
            h0, h1, stage_agree=agree,
            mac_prefix=compose_mac_prefix(
                [p0, p1], [self.replay_overhead]))
        if self.epsilon is not None:
            res = solve_epsilon(joint, self.epsilon)
        else:
            res = solve_budget(joint, self.mac_budget)
        n0 = eng0.cfg.cascade.n_components
        ths0, esc, ths1 = split_tier_thresholds(res.thresholds, n0)
        eng0.push_thresholds(ths0)
        eng1.push_thresholds(ths1)
        tier.set_escalation_threshold(0, esc)
        self.solves += 1
        self.last_result = res
        self.last_thresholds = (ths0, esc, ths1)
        self.last_stage_agree = agree
        log.info("tier solve #%d: esc=%.3f stage0=%s stage1=%s "
                 "(stage_agree=%.3f)", self.solves, esc, ths0, ths1, agree)
        return True

    def stats(self) -> dict:
        return {
            "solves": self.solves,
            "skipped_starved": self.skipped_starved,
            "interval": self.interval,
            "epsilon": self.epsilon,
            "mac_budget": self.mac_budget,
            "stage_agree": self.last_stage_agree,
            "thresholds": (
                {"stage0": list(self.last_thresholds[0]),
                 "escalation": float(self.last_thresholds[1]),
                 "stage1": list(self.last_thresholds[2])}
                if self.last_thresholds is not None else None),
            "predicted": (
                {"avg_macs": self.last_result.avg_macs,
                 "agreement": self.last_result.agreement}
                if self.last_result is not None else None),
        }
