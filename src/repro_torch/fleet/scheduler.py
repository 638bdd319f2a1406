"""Cross-engine fleet scheduler: depth-aware placement, drain/migration,
health-gated stepping.

The counterpart of the JAX package's ``fleet/scheduler.py``, with the same
placement, drain and rescue rules.  The layer above
:class:`~repro_torch.serving.engine.CascadeServingEngine` /
:class:`~repro_torch.escalate.tier.ModelCascadeTier`: one
:class:`FleetScheduler` fronts N members and owns the fleet queue.
Placement generalizes the engine's lane placement one level up — where the engine's
DepthCompactor co-locates requests in *lanes* by predicted exit depth,
the fleet treats each MEMBER as a lane of a fleet-level compactor (same
banded depth-EMA init, same retire decay), and scores candidates by

    depth_weight · |member depth EMA − predicted depth| / (n_comp − 1)
  + load_weight  · (live + queued) / capacity
  + block_weight · used-block fraction        (paged members only)

lowest score wins (FIFO head-of-queue, like engine admission).  A member
whose observed traffic runs shallow keeps attracting shallow requests —
cond_batch skips fire fleet-wide, not just lane-wide — while the load and
block terms stop the depth signal from piling everything onto one engine.

**Drain** (rolling restarts): ``drain(idx)`` stops the member admitting
(the engine's ``admitting`` gate), pulls its still-queued requests back
into the fleet queue (requeue — nothing was decoded, nothing is lost),
and then either lets in-flight slots run to exit or budget on the
draining member (``"finish"``) or cancels them and **migrates** their
committed prefixes to siblings (``"migrate"``): the committed tokens ride
the escalation replay path (:func:`repro_torch.escalate.replay.
build_replay`) verbatim into the target engine as replayed prompt
positions, so a drain mid-decode loses
zero committed tokens.  The fleet queue re-sorts by original submission
order after every requeue — the same FIFO-restore rule the escalation
tier uses — so placement order stays deterministic.

**Health**: every ``fleet.heartbeat_every`` ticks each member's
``stats()`` is probed through :class:`~repro_torch.fleet.health.
EngineHealth`
(consecutive-failure counting, bounded exponential backoff); a member
whose probe or ``step()`` keeps raising is marked unhealthy, its queued
work is rescued into the fleet queue, its live work is migrated if the
member can still ``cancel`` (else resubmitted from the original prompt),
and placement/stepping skip it until a probe succeeds again.

The scheduler also exposes the controller surface (``lane_telemetry`` /
``current_thresholds`` / ``push_thresholds``), which is how a
:class:`~repro_torch.fleet.aggregator.TelemetryAggregator` drives one
merged solve for the whole fleet — see that module.  Everything here is
pure-host scheduling: no device state ever moves between members (members
on one card share nothing but the weights they were built with).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.autotune.artifacts import config_key
from repro_torch.escalate.replay import build_replay, resolve_share_prefix
from repro_torch.fleet.health import EngineHealth
from repro_torch.obs.metrics import MetricsRegistry, engine_metrics_into
from repro_torch.obs.recorder import EventLog
from repro_torch.obs.traceviz import export_trace, trace_events
from repro_torch.serving.batching import DepthCompactor, LaneStats
from repro_torch.serving.engine import Request
from repro_torch.utils import get_logger

log = get_logger("fleet")


def _cancel_member(m, rid: int, reason: str):
    """Call a member's ``cancel`` with the terminal reason when it takes
    one (the engine stamps it on the flight's terminal span) and without
    it for members predating the kwarg."""
    try:
        return m.cancel(rid, reason=reason)
    except TypeError:
        return m.cancel(rid)


@dataclasses.dataclass
class _FleetRequest:
    """Fleet-side tracking of one submitted request across members."""

    request: Request
    order: int                       # submission order (FIFO restore key)
    engine: Optional[int] = None     # member currently holding it
    src_engine: Optional[int] = None  # member the committed prefix is from
    migrations: int = 0              # live-slot migrations (drain/unhealthy)
    requeues: int = 0                # queued-request requeues
    committed: List[int] = dataclasses.field(default_factory=list)
    committed_depths: List[int] = dataclasses.field(default_factory=list)
    committed_confs: List[float] = dataclasses.field(default_factory=list)
    spans: List[dict] = dataclasses.field(default_factory=list)
    discarded_tokens: int = 0        # committed tokens an incompatible
    #                                  migration target could not replay


class FleetScheduler:
    """Places requests across N serving engines / escalation tiers.

    ``members`` need the fleet surface the engine (and tier) provide:
    ``cfg``, ``submit`` / ``step`` / ``stats`` / ``finished``,
    ``admitting``, ``free_slot_count`` / ``queued_count`` / ``live_rids``
    / ``take_queue``; ``cancel`` enables live-slot migration (members
    without it drain in ``"finish"`` mode regardless of the requested
    mode), and the ``lane_telemetry`` / ``push_thresholds`` pair enables
    the aggregator.  ``fleet`` (a :class:`~repro_torch.configs.base.
    FleetConfig`) defaults to ``members[0].cfg.fleet``.
    """

    def __init__(self, members: List, fleet=None, aggregator=None):
        if not members:
            raise ValueError("a fleet needs at least one member")
        self.members = list(members)
        self.fleet = fleet if fleet is not None else members[0].cfg.fleet
        n = len(self.members)
        n_comp = members[0].cfg.cascade.n_components
        # member i is "lane" i of a fleet-level compactor: same banded
        # depth-EMA init, same retire decay toward the population prior
        self.compactor = DepthCompactor(n, n_comp)
        self.health = EngineHealth(
            n, max_failures=self.fleet.max_failures,
            backoff_base=self.fleet.backoff_base,
            backoff_cap=self.fleet.backoff_cap)
        self.queue: List[_FleetRequest] = []
        self.finished: Dict[int, dict] = {}
        self._tracked: Dict[int, _FleetRequest] = {}
        self._order = 0
        self._tick = 0
        self._live_thresholds = None
        self._rescued: set = set()     # members whose work was rescued
        self.draining: set = set()     # drain() called, in-flight remains
        self.drained: set = set()      # drain complete (empty member)
        self.migrations = 0
        self.requeues = 0
        self.placements = 0
        # fleet-level event log (repro_torch.obs): drains, migrations, rescues,
        # threshold pushes — always on (bounded host bookkeeping), shown
        # as the `fleet` track in the Perfetto export
        obs_cfg = getattr(members[0].cfg, "obs", None)
        self.events = EventLog(obs_cfg.max_events if obs_cfg is not None
                               else 1024)
        self.aggregator = aggregator
        if aggregator is not None:
            keys = set()
            for i, m in enumerate(self.members):
                if not m.cfg.autotune.enabled:
                    raise ValueError(
                        f"member {i} has autotune disabled — a fleet "
                        "aggregator needs telemetry in every member's "
                        "decode graphs (cfg.with_autotune(enabled=True))")
                if getattr(m, "controller", None) is not None:
                    raise ValueError(
                        f"member {i} carries its own controller — one "
                        "fleet aggregator and one per-engine controller "
                        "would push thresholds at each other; build the "
                        "member without autotune=/controller=")
                keys.add(config_key(m.cfg))
            if len(keys) > 1:
                raise ValueError(
                    "fleet members have different calibration identities "
                    "(config_key) — merged telemetry is only meaningful "
                    "across engines running the same cascade")
            aggregator.attach(self)

    # -- submission / placement ------------------------------------------
    def submit(self, req: Request) -> None:
        if req.rid in self._tracked or req.rid in self.finished:
            raise ValueError(f"duplicate rid {req.rid}")
        fr = _FleetRequest(request=req, order=self._order)
        self._order += 1
        self._tracked[req.rid] = fr
        self.queue.append(fr)

    def _predict_depth(self, req: Request) -> float:
        hint = (req.extra or {}).get("predicted_depth")
        return self.compactor.predict_depth(hint)

    def _candidates(self) -> List[int]:
        out = []
        for i, m in enumerate(self.members):
            if not self.health.healthy(i):
                continue
            if i in self.draining or i in self.drained:
                continue
            try:
                if not m.admitting or m.free_slot_count() <= 0:
                    continue
            except Exception as e:                    # noqa: BLE001
                self.health.note_failure(i, self._tick, e)
                self._rescue_if_unhealthy(i)
                continue
            out.append(i)
        return out

    def _score(self, idx: int, depth: float) -> float:
        """Placement score (lower = better); see module docstring."""
        m = self.members[idx]
        fl = self.fleet
        n_comp = m.cfg.cascade.n_components
        depth_term = (abs(self.compactor.lane_stats[idx].depth_ema - depth)
                      / max(1, n_comp - 1))
        free = m.free_slot_count()
        live = len(m.live_rids())
        capacity = max(1, free + live)
        load_term = (live + m.queued_count()) / capacity
        block_term = 0.0
        if fl.block_weight and getattr(m, "paged", False):
            pool = m.pcache.pool
            # block 0 is the reserved trash block, never allocatable
            block_term = 1.0 - pool.free_blocks / max(1, pool.num_blocks - 1)
        return (fl.depth_weight * depth_term + fl.load_weight * load_term
                + fl.block_weight * block_term)

    def _place(self) -> None:
        """Head-of-queue FIFO placement (same discipline as engine
        admission: if the head fits nowhere, the queue waits)."""
        while self.queue:
            cands = self._candidates()
            if not cands:
                return
            fr = self.queue[0]
            depth = self._predict_depth(fr.request)
            scores = [self._score(i, depth) for i in cands]
            best = cands[int(np.argmin(scores))]
            self.queue.pop(0)
            self._dispatch(fr, best)

    def _dispatch(self, fr: _FleetRequest, idx: int) -> None:
        """Submit ``fr`` to member ``idx``; a migrated request's committed
        prefix rides the escalation replay path when the source and target
        configs share a prefix (vocab + family), else the target restarts
        from the original prompt and the committed tokens are discarded
        (counted, like the tier's ``discarded_draft_tokens``)."""
        m = self.members[idx]
        req = fr.request
        if fr.committed:
            share = (idx == fr.src_engine or resolve_share_prefix(
                self.members[fr.src_engine].cfg, m.cfg))
            if share:
                prompt2, max_new2, replayed = build_replay(
                    req.prompt, fr.committed, req.max_new_tokens,
                    share_prefix=True)
                extra = dict(req.extra or {})
                # the engine's ordinary escalation replay accounting —
                # migrated prefixes are replayed prefill, not fresh traffic
                extra["escalation"] = {"rid": req.rid, "replayed": replayed,
                                       "migrated": True}
                m.submit(Request(rid=req.rid, prompt=prompt2,
                                 max_new_tokens=max_new2, extra=extra))
            else:
                fr.discarded_tokens += len(fr.committed)
                fr.committed = []
                fr.committed_depths = []
                fr.committed_confs = []
                fr.spans.append({"engine": fr.src_engine, "tokens": 0,
                                 "discarded": True})
                m.submit(req)
        else:
            m.submit(req)
        fr.engine = idx
        self.placements += 1

    # -- stepping ---------------------------------------------------------
    def step(self) -> None:
        """One fleet tick: place, step every live member, collect finished
        work, settle drains, run the aggregator's (rarely firing) merged
        solve, heartbeat."""
        self._tick += 1
        self._place()
        for idx, m in enumerate(self.members):
            if not self.health.healthy(idx) or idx in self.drained:
                continue
            try:
                m.step()
            except Exception as e:                    # noqa: BLE001
                self.health.note_failure(idx, self._tick, e)
                self._rescue_if_unhealthy(idx)
        self._collect()
        self._finish_drains()
        if self.aggregator is not None:
            self.aggregator.maybe_update(self)
        if self._tick % self.fleet.heartbeat_every == 0:
            self._heartbeat()

    def _heartbeat(self) -> None:
        for idx, m in enumerate(self.members):
            if idx in self.drained:
                continue
            self.health.beat(idx, self._tick, m.stats)
            if not self.health.healthy(idx):
                self._rescue_if_unhealthy(idx)
            elif idx in self._rescued and self.health.healthy(idx):
                # a recovered member serves fresh traffic again
                self._rescued.discard(idx)

    def _collect(self) -> None:
        for rid, fr in list(self._tracked.items()):
            if fr.engine is None:
                continue
            m = self.members[fr.engine]
            rec = m.finished.get(rid)
            if rec is None:
                continue
            m.finished.pop(rid, None)
            self._finalize(fr, rec, fr.engine)

    def _finalize(self, fr: _FleetRequest, rec: Optional[dict],
                  idx: Optional[int]) -> None:
        """Stitch the committed prefix (earlier members) and the finishing
        member's record into one fleet-level finished record."""
        rid = fr.request.rid
        tokens = list(fr.committed)
        depths = list(fr.committed_depths)
        confs = list(fr.committed_confs)
        spans = list(fr.spans)
        if rec is not None:
            tokens += list(rec["tokens"])
            depths += list(rec["exit_depths"])
            confs += list(rec["confs"])
            spans.append({"engine": idx, "tokens": len(rec["tokens"])})
        self.finished[rid] = {
            "tokens": tokens,
            "exit_depths": depths,
            "confs": confs,
            "engine": idx,
            "spans": spans,
            "migrations": fr.migrations,
            "requeues": fr.requeues,
            "discarded_tokens": fr.discarded_tokens,
            "escalated": bool(rec and rec.get("escalated", False)),
        }
        del self._tracked[rid]
        if idx is not None and rec is not None and rec["exit_depths"]:
            # feed the fleet-level depth prior exactly like an engine
            # feeds its lane compactor (skip accounting stays with the
            # engines — the fleet only learns depth placement)
            d = np.asarray(rec["exit_depths"])
            self.compactor.observe(idx, d, 0.0, steps=len(d))
            self.compactor.observe_retire(idx)
            if not fr.committed:
                self.compactor.observe_prefill_exit(float(d[0]))

    # -- drain / migration ------------------------------------------------
    def drain(self, idx: int, mode: Optional[str] = None) -> dict:
        """Drain member ``idx`` for a rolling restart.

        Stops admission immediately; queued requests requeue to the fleet
        (they were never decoded — nothing to preserve).  In-flight slots
        either run to exit or budget on the draining member
        (``"finish"``) or are cancelled and migrated (``"migrate"``):
        the cancel record's tokens become the fleet request's committed
        prefix, replayed into whichever sibling placement picks next.  A
        request whose committed tokens already meet its budget finalizes
        right here instead of requeueing (replay would have nothing left
        to decode).  Returns a summary; the member reports ``drained``
        once its last in-flight slot retires."""
        if mode is None:
            mode = self.fleet.drain_mode
        if mode not in ("finish", "migrate"):
            raise ValueError(f"drain mode {mode!r}")
        m = self.members[idx]
        m.admitting = False
        self.draining.add(idx)
        requeued, migrated, completed = [], [], []
        for req in m.take_queue():
            fr = self._tracked[req.rid]
            fr.engine = None
            fr.requeues += 1
            self.requeues += 1
            self.queue.append(fr)
            requeued.append(req.rid)
        if mode == "migrate" and hasattr(m, "cancel"):
            for rid in list(m.live_rids()):
                rec = _cancel_member(m, rid, "migrate")
                if rec is None:
                    continue
                # the cancel record is migration bookkeeping, not a
                # completion — keep it out of the member's finished set
                # so its stats count only requests it answered
                m.finished.pop(rid, None)
                fr = self._tracked[rid]
                fr.committed += list(rec["tokens"])
                fr.committed_depths += list(rec["exit_depths"])
                fr.committed_confs += list(rec["confs"])
                fr.spans.append({"engine": idx, "tokens": len(rec["tokens"])})
                fr.src_engine = idx
                fr.engine = None
                fr.migrations += 1
                self.migrations += 1
                if len(fr.committed) >= fr.request.max_new_tokens:
                    self._finalize(fr, None, idx)
                    completed.append(rid)
                else:
                    self.queue.append(fr)
                    migrated.append(rid)
        # FIFO restore: placement order is original submission order,
        # the same rule the escalation tier applies before resubmits
        self.queue.sort(key=lambda f: f.order)
        log.info("drain(%d, mode=%s): %d requeued, %d migrated, %d "
                 "completed-at-drain", idx, mode, len(requeued),
                 len(migrated), len(completed))
        summary = {"engine": idx, "mode": mode, "requeued": requeued,
                   "migrated": migrated, "completed": completed}
        self.events.add("drain", {"member": idx, "mode": mode,
                                  "requeued": len(requeued),
                                  "migrated": len(migrated),
                                  "completed": len(completed),
                                  "rids_migrated": migrated,
                                  "tick": self._tick})
        return summary

    def _finish_drains(self) -> None:
        for idx in list(self.draining):
            m = self.members[idx]
            try:
                empty = not m.live_rids() and not m.queued_count()
            except Exception:                         # noqa: BLE001
                empty = True
            if empty:
                self.draining.discard(idx)
                self.drained.add(idx)
                log.info("member %d drained", idx)

    def resume(self, idx: int) -> None:
        """Bring a drained (restarted) member back into rotation, pushing
        the fleet's live thresholds so it decodes with the current
        calibration from its first request (fleet warm-start)."""
        m = self.members[idx]
        self.draining.discard(idx)
        self.drained.discard(idx)
        m.admitting = True
        self.events.add("resume", {"member": idx, "tick": self._tick})
        if (self._live_thresholds is not None
                and hasattr(m, "push_thresholds")):
            m.push_thresholds(self._live_thresholds)

    def add_member(self, member) -> int:
        """Grow the fleet: the new member starts at the population depth
        prior (no banded guess — the fleet has real evidence) and
        inherits the current fleet thresholds immediately, which is the
        artifact store's warm-start promise made live."""
        self.members.append(member)
        self.compactor.lane_stats.append(
            LaneStats(depth_ema=self.compactor.population_prior))
        self.health.add_member()
        if (self._live_thresholds is not None
                and hasattr(member, "push_thresholds")):
            member.push_thresholds(self._live_thresholds)
        return len(self.members) - 1

    # -- failure rescue ---------------------------------------------------
    def _rescue_if_unhealthy(self, idx: int) -> None:
        """Once per unhealthy transition: pull the member's queued work
        back to the fleet and migrate-or-resubmit its live work."""
        if self.health.healthy(idx) or idx in self._rescued:
            return
        self._rescued.add(idx)
        m = self.members[idx]
        try:
            taken = m.take_queue()
        except Exception:                             # noqa: BLE001
            taken = []
        for req in taken:
            fr = self._tracked.get(req.rid)
            if fr is None:
                continue
            fr.engine = None
            fr.requeues += 1
            self.requeues += 1
            self.queue.append(fr)
        try:
            live = list(m.live_rids())
        except Exception:                             # noqa: BLE001
            live = [rid for rid, fr in self._tracked.items()
                    if fr.engine == idx]
        for rid in live:
            fr = self._tracked.get(rid)
            if fr is None or fr.engine != idx:
                continue
            rec = None
            if hasattr(m, "cancel"):
                try:
                    rec = _cancel_member(m, rid, "migrate")
                    m.finished.pop(rid, None)
                except Exception:                     # noqa: BLE001
                    rec = None
            if rec is not None:
                fr.committed += list(rec["tokens"])
                fr.committed_depths += list(rec["exit_depths"])
                fr.committed_confs += list(rec["confs"])
                fr.spans.append({"engine": idx,
                                 "tokens": len(rec["tokens"])})
                fr.src_engine = idx
                fr.migrations += 1
                self.migrations += 1
            # a dead member's un-cancellable slots lose their uncommitted
            # work; the request restarts from whatever we hold
            fr.engine = None
            if len(fr.committed) >= fr.request.max_new_tokens:
                self._finalize(fr, None, idx)
            else:
                self.queue.append(fr)
        self.queue.sort(key=lambda f: f.order)
        self.events.add("rescue", {"member": idx, "requeued": len(taken),
                                   "live_recovered": len(live),
                                   "tick": self._tick})
        log.warning("rescued member %d: %d queued requeued, %d live "
                    "recovered", idx, len(taken), len(live))

    # -- controller surface (what the TelemetryAggregator drives) --------
    def lane_telemetry(self) -> List:
        """Every healthy member's lane telemetry, concatenated — the
        merged-solve input.  ``merge_telemetry`` sums fixed-size counters,
        so lanes from different members merge exactly like lanes from one
        (homogeneous configs enforced at construction)."""
        out = []
        for idx, m in enumerate(self.members):
            if not self.health.healthy(idx):
                continue
            if not hasattr(m, "lane_telemetry"):
                continue
            try:
                out.extend(m.lane_telemetry())
            except Exception as e:                    # noqa: BLE001
                self.health.note_failure(idx, self._tick, e)
        return out

    def current_thresholds(self):
        return self._live_thresholds

    def push_thresholds(self, thresholds) -> None:
        """Fan one threshold vector to every healthy member — the fleet
        half of the capture-free push path (each member's own
        ``push_thresholds`` writes its lanes' device δ̂ in place)."""
        pushed = tuple(float(t) for t in thresholds)
        for idx, m in enumerate(self.members):
            if not self.health.healthy(idx):
                continue
            if not hasattr(m, "push_thresholds"):
                continue
            try:
                m.push_thresholds(pushed)
            except Exception as e:                    # noqa: BLE001
                self.health.note_failure(idx, self._tick, e)
        self._live_thresholds = pushed
        self.events.add("threshold_push", {"thresholds": list(pushed),
                                           "tick": self._tick})

    # -- driving / reporting ----------------------------------------------
    def run(self, max_ticks: int = 1000) -> Dict[int, dict]:
        for _ in range(max_ticks):
            if not self._tracked:
                break
            self.step()
        return self.finished

    # -- observability (repro_torch.obs) ----------------------------------
    @property
    def obs_events(self):
        """The fleet-level event log — also the hook a fleet-attached
        ThresholdController/TelemetryAggregator records resolves into."""
        return self.events

    def _recorders(self):
        """(name, FlightRecorder) per member that has one (obs enabled)."""
        out = []
        for i, m in enumerate(self.members):
            fl = getattr(m, "flight", None)
            if fl is not None:
                out.append((f"member{i}", fl))
        return out

    def dump_flight(self, rid: int) -> Optional[dict]:
        """Every member's flight for ``rid`` (a migrated request shows
        one per member it touched) stitched with the fleet-level record
        — None when nobody recorded it."""
        flights = []
        for i, m in enumerate(self.members):
            dump = getattr(m, "dump_flight", None)
            d = dump(rid) if dump is not None else None
            if isinstance(d, list):          # tier member: one per stage
                flights.extend({"member": i, **x} for x in d)
            elif d is not None:
                flights.append({"member": i, **d})
        if not flights and rid not in self.finished:
            return None
        return {"rid": rid, "members": flights,
                "record": self.finished.get(rid)}

    def scrape(self) -> str:
        """Prometheus text: per-member metrics (``member=`` label), the
        merged latency summaries (``member="merged"``) and fleet-level
        placement/drain/health metrics."""
        return self._registry().render_text()

    def scrape_json(self) -> dict:
        return self._registry().render_json()

    def _registry(self):
        reg = MetricsRegistry()
        merged = {}
        for i, m in enumerate(self.members):
            try:
                engine_metrics_into(reg, m, {"member": str(i)})
            except Exception as e:                    # noqa: BLE001
                self.health.note_failure(i, self._tick, e)
            fl = getattr(m, "flight", None)
            if fl is not None:
                for key, res in fl.reservoirs.items():
                    agg = merged.setdefault(key, ([], [0], [0.0]))
                    agg[0].extend(res.values())
                    agg[1][0] += res.count
                    agg[2][0] += res.total
        names = {"e2e_seconds": ("repro_request_latency_seconds",
                                 "Submit-to-finalize latency per request."),
                 "per_token_seconds": (
                     "repro_token_latency_seconds",
                     "Decode wall-clock attributed per generated token."),
                 "macs_per_request": (
                     "repro_macs_per_request",
                     "Analytic decode MACs spent per finished request.")}
        for key, (vals, cnt, tot) in merged.items():
            if key not in names:
                continue
            name, help_ = names[key]
            reg.summary(name, help_, vals, {"member": "merged"},
                        count=cnt[0], total=tot[0])
        for i in range(len(self.members)):
            h = self.health.summary(i)
            lm = {"member": str(i)}
            reg.gauge("repro_fleet_member_healthy",
                      "1 while the member passes health probes.",
                      1.0 if h["healthy"] else 0.0, lm)
            reg.gauge("repro_fleet_member_consecutive_failures",
                      "Consecutive probe/step failures (resets on a "
                      "successful probe).", h["consecutive_failures"], lm)
            reg.gauge("repro_fleet_member_backoff_ticks",
                      "Current exponential-backoff window before the "
                      "next probe.", h["backoff"], lm)
            reg.counter("repro_fleet_member_unhealthy_marks_total",
                        "Times the member crossed max_failures.",
                        h["unhealthy_marks"], lm)
        reg.gauge("repro_fleet_queue_depth",
                  "Requests waiting in the fleet queue.", len(self.queue))
        reg.counter("repro_fleet_placements_total",
                    "Requests placed onto members.", self.placements)
        reg.counter("repro_fleet_migrations_total",
                    "Live requests migrated off a member.", self.migrations)
        reg.counter("repro_fleet_requeues_total",
                    "Queued requests pulled back to the fleet queue.",
                    self.requeues)
        for name in ("drain", "rescue", "resume", "threshold_push"):
            reg.counter(f"repro_fleet_{name}_events_total",
                        f"Fleet-level {name} events.",
                        self.events.counts.get(name, 0))
        if self.aggregator is not None and hasattr(self.aggregator,
                                                   "metrics_into"):
            self.aggregator.metrics_into(reg, self)
        return reg

    def trace_events(self) -> List[dict]:
        """Chrome trace-event list: one process per member (lane tracks,
        chunk slices) plus the fleet event track (drains, migrations,
        pushes) — ready for Perfetto."""
        return trace_events(self._recorders(),
                            extra_events=self.events.snapshot())

    def export_trace(self, path: str) -> dict:
        return export_trace(path, self._recorders(),
                            extra_events=self.events.snapshot())

    def stats(self) -> dict:
        members = []
        for idx, m in enumerate(self.members):
            try:
                members.append({
                    "free_slots": m.free_slot_count(),
                    "queued": m.queued_count(),
                    "live": len(m.live_rids()),
                    "finished": len(m.finished),
                    "depth_ema": self.compactor.lane_stats[idx].depth_ema,
                    # the EngineHealth satellite: flapping is visible per
                    # member without digging into stats()["health"]
                    **self.health.summary(idx),
                })
            except Exception as e:                    # noqa: BLE001
                members.append({"error": repr(e),
                                **self.health.summary(idx)})
        return {
            "n_members": len(self.members),
            "requests_finished": len(self.finished),
            "requests_live": len(self._tracked),
            "queue_len": len(self.queue),
            "placements": self.placements,
            "migrations": self.migrations,
            "requeues": self.requeues,
            "discarded_tokens": sum(r["discarded_tokens"]
                                    for r in self.finished.values()),
            "draining": sorted(self.draining),
            "drained": sorted(self.drained),
            "thresholds": (list(self._live_thresholds)
                           if self._live_thresholds is not None else None),
            "aggregator": (self.aggregator.stats()
                           if self.aggregator is not None else None),
            "health": self.health.stats(),
            "events": dict(self.events.counts),
            "members": members,
        }
