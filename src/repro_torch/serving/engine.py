"""Cascade-aware serving engine: prefill + decode with confidence-thresholded
early exit (Algorithm 1 applied per generated token), KV backfill,
depth-compacted lane batching and cohort-split segment skipping — the dense
layout on the host runtime.

The counterpart of the JAX package's ``serving/engine.py``.  Each lane
carries one :class:`~repro_torch.core.exec.DecodeState` through the
:class:`~repro_torch.core.exec.StagedExecutor`; under ``cascade.exit_mode
== "cond_batch"`` exited segments skip their compute, per cohort with
``cascade.n_cohorts > 1`` (the depth compactor places similar-depth
requests in the same cohort).  With ``kernel_tune.megakernel`` every decode
exit head runs the fused exit-head megakernel.  The engine reports the
paper's analytic MAC speedup (§6.2), the measured decode wall-clock per
token, the executed skip rate next to the scheduling opportunity, the host
syncs per token, the cohort dispatch branches taken, and which kernels ran
(:meth:`stats`).

Two cache layouts (``cfg.paged_cache.layout``): ``"dense"`` keeps one
worst-case slab per lane; ``"paged"`` serves every lane from one shared
block pool (:mod:`repro_torch.serving.paged`), claims blocks at admission
for exactly the positions a request will span, admits into a freed slot
of a LIVE lane without re-prefilling its siblings (continuous single-slot
admission), and returns a finished slot's blocks at the next host sync —
those of components deeper than its exit depth as ``reclaimed_by_exit``.

Two execution runtimes (``runtime=`` at construction):

* ``"host"`` — one decode step per lane per tick, its result read back
  every tick (plus one read per cond_batch skip predicate);
* ``"device"`` — a :class:`repro_torch.serving.runtime.DeviceDecodeLoop`
  decodes up to ``chunk`` tokens per lane per dispatch, on CUDA by
  replaying a captured CUDA graph whose skips are conditional nodes, and
  syncs to the host once a chunk.  Token and exit streams equal the host
  runtime's for requests admitted at the same points; queued requests
  admit at chunk boundaries (up to ``chunk`` tokens later than on the host
  runtime), the one sanctioned divergence.  The graph reads fixed
  addresses, so a lane's cache, kpos ring and DecodeState tensors keep
  theirs for the engine's life: both runtimes write them in place, and a
  re-prefill refills them.

A family with modality inputs (the vlm family's image embeddings, the
audio family's frame embeddings) gets
the reference engine's stub at every lane prefill: f32 zeros of
:func:`~repro_torch.models.model.extra_input_shapes`, made once on the
engine's device.  Decode takes none: it reads the cross K/V the prefill
cached, which a re-prefill rewrites in place.

Each lane keeps a host mirror of its position (``DecodeState.t`` is a
device scalar): a prefill sets it, a host tick adds 1, a chunk adds its
steps, and the finish rule, the paged admission and the telemetry shadow
schedule read it, so the host runtime adds no sync for it.  Both runtimes
time their first dispatch (a device-runtime capture) as
``compile_seconds``, outside every window metric.

Autotune (``autotune=True`` or a
:class:`~repro_torch.autotune.controller.ThresholdController`, with
``cfg.autotune.enabled``): every lane's DecodeState carries exit
telemetry, accumulated inside the decode step on both runtimes, and a live
(n_components,) f32 threshold vector; both live as long as the lane,
across its re-prefills.  :meth:`push_thresholds` writes the vector in
place — the exit kernels read it from device memory, so a push costs no
capture — and the controller resolves and pushes from
:meth:`lane_telemetry` at its resolve ticks (``maybe_update`` each tick).

Cross-model escalation (:mod:`repro_torch.escalate`): a tier drives the
engine through :meth:`cancel` (retire a live request at its defer point,
or drop a queued one) and re-submits deferred requests tagged with
``extra["escalation"]``; the engine attributes their replayed prompt
prefix to the escalation window of :meth:`stats` (``"escalation"``), not
to fresh traffic.

Fleet members (:mod:`repro_torch.fleet`): :meth:`free_slot_count`,
:meth:`queued_count`, :meth:`live_rids` and :meth:`take_queue` are the
surface a scheduler in front of several engines reads, the ``admitting``
gate stops admission for a drain, and ``cancel(..., reason="migrate")``
hands a live request's committed prefix to a sibling.

Observability (``cfg.obs.enabled``, :mod:`repro_torch.obs`): a
:class:`~repro_torch.obs.recorder.FlightRecorder` files each request's
spans (queue wait, admit, prefill, chunks, one terminal) from data the
engine already holds on the host at its sync points — the result of a host
tick's fetch, a device-runtime chunk's one fetch (``DecodeChunk``), the
host mirror of ``segments_run`` — and host clocks around them; it reads no
CUDA tensor, so it adds no host sync and no capture.  Its flights carry
the port's kernel provenance: ``kernel_backend`` is ``"cuda"`` (the
hand-written kernels), ``"torch-cpu"`` (their plain versions) or
``"off"``, where the reference records ``"interpret"`` or ``"compiled"``
(the Pallas interpreter or Mosaic).  :meth:`scrape` renders the reference's
Prometheus metric names.

``mesh=`` (a :class:`DeviceMesh`, ``launch/mesh.py``) goes to the
device runtime's loop, which places each lane's carry on it by the shard
rules; the host runtime refuses a mesh, as the reference's does.  On a
mesh of more than one rank (``make_mesh``, the dense family) the engine
runs SPMD: every rank runs the same engine over the same requests, its
params are the rank's serve1d shards (:meth:`DeviceDecodeLoop.
shard_params`), a lane's device cache and DecodeState hold the rank's
``data`` rows, and each prefill's decisions and each chunk's rows are
gathered over ``data`` on the host, so every rank's host bookkeeping —
slots, streams, metrics — is the whole lane's.
"""
from __future__ import annotations

import copy
import dataclasses
import itertools
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.autotune.telemetry import sync_telemetry
from repro_torch.configs.base import ModelConfig
from repro_torch.core.exec import (CONF_EMA_DECAY, StagedExecutor,
                                   effective_cohorts)
from repro_torch.core.macs import segment_macs_per_token
from repro_torch.kernels.autotune import ensure_tuned
from repro_torch import parallel
from repro_torch.models import nn
from repro_torch.models.model import CascadeModel, extra_input_shapes
from repro_torch.obs.metrics import MetricsRegistry, engine_metrics_into
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.serving.batching import DepthCompactor, cohort_capacity
from repro_torch.serving.paged import PagedCascadeCache
from repro_torch.serving.runtime import DeviceDecodeLoop, kernel_provenance
from repro_torch.utils import quantiles, resolve_device

# flight-recorder process naming (trace tracks, fleet scrape labels):
# engines number themselves in construction order
_ENGINE_SEQ = itertools.count()


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int = 16
    extra: Optional[dict] = None


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    generated: Optional[List[int]] = None
    exit_depths: Optional[List[int]] = None
    confs: Optional[List[float]] = None
    done: bool = True


def _escalation_extra(req: Request) -> Optional[dict]:
    """The tier's re-submission tag, set by :mod:`repro_torch.escalate`
    when a deferred request is replayed into this engine (None for fresh
    traffic).  Its ``replayed`` is how many of the prompt's trailing tokens
    are a prefix another stage already decoded."""
    esc = (req.extra or {}).get("escalation")
    return esc if isinstance(esc, dict) else None


def _spread(log) -> Optional[dict]:
    """(min, median, max) of the dispatches' ms and µs per token."""
    if not log:
        return None
    ms = [1e3 * sec for sec, _ in log]
    per = [1e6 * sec / n for sec, n in log if n]

    def mmm(x):
        return [min(x), float(np.median(x)), max(x)] if x else None
    return {"n": len(log), "ms": mmm(ms), "us_per_token": mmm(per)}


class CascadeServingEngine:
    """Multi-lane batched decode with cascade early exit.

    Each lane holds ``lane_batch`` sequences sharing one KV cache; lanes
    step independently so the DepthCompactor can group easy
    (shallow-exit) traffic away from hard traffic, letting ``cond_batch``
    skips fire.  Runs on ``device`` (CUDA unless the caller passes
    ``device="cpu"``), which must be the model's.
    """

    def __init__(self, cfg: ModelConfig, model: CascadeModel, params,
                 lane_batch: int = 4, n_lanes: int = 2,
                 cache_len: int = 256, runtime: str = "host",
                 chunk: int = 8, mesh=None, autotune=None, device=None):
        if runtime not in ("host", "device"):
            raise ValueError(
                f"runtime must be 'host' or 'device', got {runtime!r}")
        if mesh is not None and runtime != "device":
            raise ValueError(
                "mesh sharding is only applied by the device decode loop; "
                "the host per-token step runs unsharded — pass "
                "runtime='device' (or drop mesh=) rather than silently "
                "serving single-device")
        if autotune is not None and autotune is not False \
                and not cfg.autotune.enabled:
            raise ValueError(
                "autotune= needs telemetry in the decode steps: build the "
                "model/engine with cfg.with_autotune(enabled=True) (plus "
                "epsilon= or mac_budget=) before passing a controller")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.model = model
        self.params = params
        # flight recorder (repro_torch.obs): host bookkeeping at the
        # existing sync points, so it can neither capture nor change streams
        self.flight = None
        self._provenance = None
        if cfg.obs.enabled:
            self.flight = FlightRecorder.from_config(
                cfg.obs, name=f"engine{next(_ENGINE_SEQ)}")
            self._provenance = kernel_provenance(cfg, self.device)
        # tuned kernel tiles install before anything runs or is captured
        if cfg.kernel_tune.enabled:
            ensure_tuned(cfg, device=self.device)
        lane_batch = cohort_capacity(lane_batch, cfg.cascade.n_cohorts)
        self.lane_batch = lane_batch
        self.n_lanes = n_lanes
        self.cache_len = cache_len
        self.runtime = runtime
        self.chunk = chunk
        self.cohorts = effective_cohorts(cfg.cascade.n_cohorts, lane_batch)
        self.compactor = DepthCompactor(n_lanes, cfg.cascade.n_components)
        # the device runtime's loop first: on a multi-rank mesh the params
        # are the rank's shards and a lane holds the rank's data rows
        self.loop = (DeviceDecodeLoop(model, cfg, chunk=chunk,
                                      cache_len=cache_len, mesh=mesh)
                     if runtime == "device" else None)
        self.transport = None if self.loop is None else self.loop.transport
        if self.transport is not None:
            if lane_batch % self.transport.size("data"):
                raise ValueError(
                    f"lane_batch {lane_batch} does not split over a data "
                    f"axis of {self.transport.size('data')} ranks")
            self.params = params = self.loop.shard_params(params)
        self._rows = (slice(0, lane_batch) if self.loop is None
                      else self.loop.rows(lane_batch))
        local_batch = self._rows.stop - self._rows.start
        self.executor = StagedExecutor(model, cfg)
        self.decider = self.executor.decider
        self.mac_prefix = segment_macs_per_token(cfg, cache_len)
        # paged KV layout: shared block stores + per-slot block tables
        self.paged = cfg.paged_cache.layout == "paged"
        self.pcache = (PagedCascadeCache(model, cfg, lane_batch, n_lanes,
                                         cache_len)
                       if self.paged else None)
        # dense-equivalent cache footprint (the stats() memory comparison,
        # in both layouts)
        tmpl = model.init_cache(local_batch, cache_len, device="meta")
        self._dense_cache_bytes = n_lanes * sum(
            x.numel() * x.element_size()
            for x in nn.tree_leaves(tmpl["segments"]))
        self.lanes = []
        for i in range(n_lanes):
            lane = {
                "slots": [_Slot() for _ in range(lane_batch)],
                "state": self.executor.init_state(
                    local_batch, mac_weights=self.mac_prefix, block_tables=(
                        self.pcache.device_tables(i).clone() if self.paged
                        else None)),
                # host mirror of the lane's position (state.t)
                "t": 0,
            }
            if self.paged:
                lane["kpos"] = self.pcache.fresh_kpos()
            else:
                lane["cache"] = model.init_cache(local_batch, cache_len)
            self.lanes.append(lane)
        self.queue: List[Request] = []
        self.finished: Dict[int, dict] = {}
        # the stubbed modality inputs every lane prefill feeds (the
        # reference engine's zeros), or None for a family without any
        self._extra = {k: torch.zeros(v, dtype=torch.float32,
                                      device=self.device)
                       for k, v in extra_input_shapes(cfg, lane_batch)
                       .items()} or None
        # admission gate (a fleet drain): False stops step() admitting
        # while the in-flight slots decode on to exit or budget
        self.admitting = True
        # admission-latency accounting (ticks between submit and admit) and
        # lanes whose block tables changed since their state last synced
        self._tick = 0
        self._submit_tick: Dict[int, int] = {}
        self._tables_stale: set = set()
        # the first decode dispatch also pays one-time set-up (kernel
        # build/load, library handles): it is reported as compile_seconds
        # and never counted in the decode window
        self._compile_seconds = 0.0
        self._decode_warm = False
        # live thresholds (autotune): the vector every lane decodes with, as
        # pushed (its f32 rounding lives in the lanes' device tensors)
        self._live_thresholds = (tuple(cfg.cascade.thresholds)
                                 if cfg.autotune.enabled else None)
        # a ThresholdController (or True: one built from cfg.autotune)
        self.controller = None
        if autotune is True:
            from repro_torch.autotune.controller import ThresholdController
            self.controller = ThresholdController(cfg, self.mac_prefix)
        elif autotune:
            self.controller = autotune
        self.reset_metrics()
        if self.controller is not None:
            self.controller.attach(self)

    def reset_metrics(self):
        """Zero the MAC / wall-clock / skip-rate / host-sync accounting and
        the escalation window (replayed-prefix prefill, escalated
        admissions, cancels); the compactor's learned depth EMAs and
        ``compile_seconds`` survive, and per-request outputs (``finished``)
        are not cleared."""
        self.compactor.reset_skip_counters()
        self._macs_spent = 0.0
        self._macs_dense = 0.0
        self._decode_seconds = 0.0
        self._decode_tokens = 0
        self._prefill_seconds = 0.0
        self._prefills = 0
        self._slot_prefills = 0
        self._segments_run = np.zeros(self.cfg.cascade.n_components, np.int64)
        self._decode_steps = 0
        self._skip_opportunities = 0
        self._skip_opportunity_total = 0
        self._admit_waits: List[int] = []
        self._host_syncs = 0
        self._decode_dispatches = 0
        # (seconds, tokens) of each decode dispatch in the window
        self._dispatch_log: List[tuple] = []
        self._dispatch = dict.fromkeys(self.executor.dispatch, 0)
        # escalation window: replayed-prefix prefill is attributed to the
        # escalated requests that caused it, never to fresh traffic
        self._prefill_positions_fresh = 0
        self._prefill_positions_replayed = 0
        self._replay_prefill_macs = 0.0
        self._replay_prefill_seconds = 0.0
        self._escalated_admitted = 0
        self._cancelled_for_escalation = 0
        # the pool's peak occupancy and lifetime reclaim counters survive
        # (high-water capacity); only its per-chunk reclaim window clears
        if self.paged:
            self.pcache.pool.reset_window()

    # -- cache layout plumbing -------------------------------------------
    def _lane_cache(self, lane):
        """The cache a dispatch consumes: the lane's private slab (dense)
        or its kpos ring over the shared block stores (paged)."""
        if self.paged:
            return self.pcache.lane_cache(lane["kpos"])
        return lane["cache"]

    def _set_state(self, lane, state):
        """Adopt ``state`` as the lane's DecodeState by writing its tensors
        into the lane's own, in place: they keep their addresses for the
        engine's life (what a captured graph reads)."""
        own = lane["state"]
        for f in ("t", "active", "policy", "ema_conf", "block_tables",
                  "thresholds"):
            new = getattr(state, f)
            if new is not None and new is not getattr(own, f):
                getattr(own, f).copy_(new)
        if state.tel is not None and state.tel is not own.tel:
            for dst, src in zip(own.tel.tensors(), state.tel.tensors()):
                dst.copy_(src)
        own.segments_run = state.segments_run

    def _sync_tables(self, lane, lane_id: int):
        """Push rebuilt block tables into the lane's DecodeState after
        release/alloc changed its rows."""
        if self.paged and lane_id in self._tables_stale:
            lane["state"].block_tables.copy_(
                self.pcache.device_tables(lane_id))
            self._tables_stale.discard(lane_id)

    # -- public API -----------------------------------------------------
    def submit(self, req: Request):
        self._submit_tick.setdefault(req.rid, self._tick)
        self.queue.append(req)
        if self.flight is not None:
            self.flight.on_submit(req.rid, self._tick)

    def free_slot_count(self) -> int:
        """Slots a placement could admit into right now (all lanes)."""
        return sum(1 for ln in self.lanes for s in ln["slots"] if s.done)

    def queued_count(self) -> int:
        return len(self.queue)

    def live_rids(self) -> List[int]:
        """Rids decoding in a slot (admitted, not finished)."""
        return [s.request.rid for ln in self.lanes for s in ln["slots"]
                if not s.done and s.request is not None]

    def take_queue(self) -> List[Request]:
        """Remove and return every queued request (FIFO order) and forget
        their submit ticks, so a scheduler can requeue them elsewhere
        without this engine counting them as admitted or dropped."""
        taken, self.queue = self.queue, []
        for req in taken:
            self._submit_tick.pop(req.rid, None)
            if self.flight is not None:
                # the rid leaves without being admitted: its flight ends
                # here (the engine that takes it records a new one)
                self.flight.on_finish(req.rid, "cancelled",
                                      {"queued": True, "reason": "requeue",
                                       "n_tokens": 0})
        return taken

    def _predict_depth(self, req: Request) -> float:
        hint = (req.extra or {}).get("predicted_depth")
        return self.compactor.predict_depth(hint)

    def _record_admit(self, req: Request, lane_id: int, slot_idx: int,
                      depth: float):
        sub = self._submit_tick.pop(req.rid, self._tick)
        wait = self._tick - sub
        self._admit_waits.append(wait)
        esc = _escalation_extra(req)
        if esc is not None:
            self._escalated_admitted += 1
        if self.flight is not None:
            attrs = dict(self._provenance)
            if esc is not None:
                attrs["escalated_from"] = esc.get("rid")
                attrs["replayed"] = esc.get("replayed")
                attrs["migrated"] = bool(esc.get("migrated"))
            self.flight.on_admit(
                req.rid, lane=lane_id, slot=slot_idx,
                cohort=slot_idx // max(1, self.lane_batch // self.cohorts),
                predicted_depth=float(depth), wait_ticks=wait,
                tick=self._tick, attrs=attrs)

    def _replayed_len(self, req: Request) -> int:
        """Trailing prompt tokens another stage already decoded (0 for
        fresh traffic)."""
        esc = _escalation_extra(req)
        if esc is None:
            return 0
        return max(0, min(int(esc.get("replayed", 0)), len(req.prompt)))

    def _account_prefill(self, req: Request, seconds: float,
                         padded_positions: int):
        """Attribute one newly admitted request's prefill: its prompt
        positions split into fresh traffic and a replayed prefix.  Replayed
        positions are priced at the full-depth MAC cost a token (prefill
        computes every component) and charged to the escalation window,
        never to the decode window; ``seconds`` of a shared dispatch are
        attributed by the request's replayed share of its padded
        positions."""
        replayed = self._replayed_len(req)
        self._prefill_positions_fresh += len(req.prompt) - replayed
        self._prefill_positions_replayed += replayed
        if replayed:
            self._replay_prefill_macs += replayed * float(self.mac_prefix[-1])
            self._replay_prefill_seconds += seconds * (
                replayed / max(1, padded_positions))

    @staticmethod
    def _claim(slot: _Slot, req: Request):
        slot.request = req
        slot.generated = []
        slot.exit_depths = []
        slot.confs = []
        slot.done = False

    def _admit(self):
        if self.paged:
            return self._admit_paged()
        while self.queue:
            free = [i for i, lane in enumerate(self.lanes)
                    if any(s.done for s in lane["slots"])]
            if not free:
                break
            req = self.queue.pop(0)
            depth = self._predict_depth(req)
            lane_id = self.compactor.assign(depth, free)
            lane = self.lanes[lane_id]
            free_slots = [i for i, s in enumerate(lane["slots"]) if s.done]
            slot_idx = self.compactor.pick_slot(
                depth, free_slots, self.lane_batch, self.cohorts)
            self._claim(lane["slots"][slot_idx], req)
            # the cache is shared per lane: admission re-prefills the lane
            lane["dirty"] = True
            self._record_admit(req, lane_id, slot_idx, depth)

    # -- paged admission --------------------------------------------------
    def _free_per_cohort(self, lane) -> List[int]:
        per = self.lane_batch // self.cohorts
        return [sum(1 for i in range(c * per, (c + 1) * per)
                    if lane["slots"][i].done)
                for c in range(self.cohorts)]

    @staticmethod
    def _pad_prompt(n: int) -> int:
        """Continuous-admission prompts pad to a power of two (>= 2), as
        the reference pads them (its B = 1 prefill compiles per shape)."""
        return max(2, 1 << max(0, int(n - 1).bit_length()))

    def _continuous_feasible(self, lane_id: int, req: Request) -> bool:
        """Can ``req`` join this LIVE lane now?  Needs a free slot, enough
        decoded history for the padded prompt's offset positions
        (P_pad <= t), and pool coverage for exactly the positions the
        slot will span, beside the blocks that lanes waiting for their
        re-prefill have been promised.  Host state only: no device
        sync."""
        lane = self.lanes[lane_id]
        if not any(s.done for s in lane["slots"]):
            return False
        t0 = lane["t"]
        P_pad = self._pad_prompt(len(req.prompt))
        if P_pad > t0:
            return False
        need = self.pcache.blocks_needed(t0 - P_pad,
                                         t0 + req.max_new_tokens)
        return self.pcache.can_admit(need + self._promised_blocks())

    def _lane_plan(self, lane_id: int, req: Optional[Request] = None) -> int:
        """Blocks the lane's whole-lane re-prefill claims: every live slot
        (and ``req``) covered from 0 to the common context length plus
        its remaining budget."""
        ctxs = [(len(s.request.prompt) + len(s.generated),
                 max(1, s.request.max_new_tokens - len(s.generated)))
                for s in self.lanes[lane_id]["slots"] if not s.done]
        if req is not None:
            ctxs.append((len(req.prompt), req.max_new_tokens))
        if not ctxs:
            return 0
        S = max(2, max(c for c, _ in ctxs))
        return sum(self.pcache.blocks_needed(0, S + rem) for _, rem in ctxs)

    def _lane_held(self, lane_id: int) -> int:
        return sum(self.pcache.slot_blocks(lane_id, i)
                   for i in range(self.lane_batch))

    def _promised_blocks(self, but: Optional[int] = None) -> int:
        """Blocks that dirty lanes (other than ``but``) will claim beyond
        what they hold when their re-prefill runs.  The reference checks
        each lane's plan against the free list alone, so two lanes planned
        in one tick (or a continuous admission after a plan) can promise
        the same blocks and fail the later prefill's allocation; the port
        books the promise."""
        return sum(max(0, self._lane_plan(i) - self._lane_held(i))
                   for i, ln in enumerate(self.lanes)
                   if ln.get("dirty") and i != but)

    def _lane_plan_fits(self, lane_id: int, req: Request) -> bool:
        """Whole-lane path feasibility: would the lane's re-prefill plan
        (every live slot + ``req``, padded to the common context length)
        fit the pool once the lane's current reservations are released,
        under the pool's soft cap (a tier's block budget)?  The reference
        checks the free list alone, so a binding cap fails the prefill's
        allocation; the port keeps the request queued instead."""
        pool = self.pcache.pool
        held = self._lane_held(lane_id)
        have = pool.free_blocks + held
        if pool.soft_cap is not None:
            have = min(have, pool.soft_cap - pool.used + held)
        have -= self._promised_blocks(but=lane_id)
        return self._lane_plan(lane_id, req) <= have

    def _admit_paged(self):
        """Admission under the paged layout: a request needs a free slot
        AND block coverage for the positions it will span.  A live lane
        takes it by continuous single-slot admission (siblings untouched);
        an empty or dirty lane by the whole-lane re-prefill, checked
        against the pool.  FIFO with head-of-queue blocking: pool
        exhaustion backpressures admission and never corrupts a resident
        slot, because ``alloc_slot`` is all-or-nothing."""
        while self.queue:
            req = self.queue[0]
            if not self.pcache.fits_ever(
                    0, max(2, len(req.prompt)) + req.max_new_tokens):
                raise ValueError(
                    f"request rid={req.rid} can never fit: prompt + "
                    f"max_new_tokens spans more blocks than the pool owns; "
                    f"raise paged_cache.num_blocks or shrink the request")
            depth = self._predict_depth(req)
            whole = [i for i, ln in enumerate(self.lanes)
                     if (ln.get("dirty") or all(s.done for s in ln["slots"]))
                     and any(s.done for s in ln["slots"])]
            live = [i for i, ln in enumerate(self.lanes)
                    if i not in whole and any(s.done for s in ln["slots"])]
            cands = [i for i in live if self._continuous_feasible(i, req)]
            if cands:
                lane_id = self.compactor.assign(depth, cands)
                self.queue.pop(0)
                self._admit_continuous(lane_id, req, depth)
                continue
            cands = [i for i in whole if self._lane_plan_fits(i, req)]
            if not cands:
                break
            lane_id = self.compactor.assign(depth, cands)
            lane = self.lanes[lane_id]
            free_slots = [i for i, s in enumerate(lane["slots"]) if s.done]
            slot_idx = self.compactor.pick_slot(
                depth, free_slots, self.lane_batch, self.cohorts,
                free_per_cohort=self._free_per_cohort(lane))
            self._claim(lane["slots"][slot_idx], req)
            lane["dirty"] = True
            self.queue.pop(0)
            self._record_admit(req, lane_id, slot_idx, depth)

    def _admit_continuous(self, lane_id: int, req: Request, depth: float):
        """Prefill ``req`` into a single freed slot of a live lane.

        The prompt left-pads to ``P_pad`` and runs a B = 1 full-mode
        forward at absolute positions ``[t - P_pad, t)``, writing only
        through the slot's freshly allocated blocks; its kpos row masks
        everything it did not write.  The admitted stream's history starts
        at an offset, so its tokens are its own (the sanctioned divergence
        from the dense layout, which re-prefills the whole lane); sibling
        streams are untouched."""
        lane = self.lanes[lane_id]
        state = lane["state"]
        t0 = lane["t"]
        P = len(req.prompt)
        P_pad = self._pad_prompt(P)
        free_slots = [i for i, s in enumerate(lane["slots"]) if s.done]
        slot_idx = self.compactor.pick_slot(
            depth, free_slots, self.lane_batch, self.cohorts,
            free_per_cohort=self._free_per_cohort(lane))
        self._record_admit(req, lane_id, slot_idx, depth)
        ok = self.pcache.alloc_slot(lane_id, slot_idx, t0 - P_pad,
                                    t0 + req.max_new_tokens)
        assert ok, "continuous admission raced the feasibility check"
        start = t0 - P_pad
        toks = np.zeros((1, P_pad), np.int32)
        toks[0, P_pad - P:] = req.prompt
        W = self.pcache.W
        # ring slot -> (kept token index, kept absolute position): newest
        # position wins on ring wrap, everything unwritten stays masked
        write_slots = np.full((W,), -1, np.int32)
        krow = np.full((W,), -1, np.int32)
        for p in range(max(start, t0 - W), t0):
            write_slots[p % W] = p - start
            krow[p % W] = p
        dev = self.device
        tables = self.pcache.device_tables(lane_id)[:, slot_idx:slot_idx + 1]
        t_pre = time.perf_counter()
        logits = self.model.prefill_into(
            self.params, torch.as_tensor(toks, device=dev),
            self.pcache.lane_cache(None),
            torch.as_tensor(start + np.arange(P_pad, dtype=np.int32),
                            device=dev),
            torch.as_tensor(write_slots, device=dev), tables)
        d, _ = self.decider.decide_with_carry(
            logits, thresholds=self.executor.thresholds(state),
            state=self.decider.measure.init_state(
                self.cfg.cascade.n_components, 1, dev),
            active=torch.ones(1, dtype=torch.bool, device=dev))
        tok = int(d.prediction[0])         # syncs the device
        exit_idx = int(d.exit_index[0])
        conf = float(d.confidence[0])
        dt_pre = time.perf_counter() - t_pre
        self._prefill_seconds += dt_pre
        self._slot_prefills += 1
        self._account_prefill(req, dt_pre, P_pad)
        if self.flight is not None:
            self.flight.on_prefill(lane_id, t_pre, dt_pre, [req.rid],
                                   [req.rid], P_pad)
        # merge the B = 1 prefill decision into the lane's carried state:
        # it seeds the stateful-measure streak as a whole-lane prefill does
        if state.policy is not None and d.state is not None:
            state.policy[..., slot_idx] = d.state[..., 0]
        state.ema_conf[slot_idx] = (1.0 - CONF_EMA_DECAY) * conf
        lane["kpos"][slot_idx] = torch.as_tensor(krow, device=dev)
        s = lane["slots"][slot_idx]
        self._claim(s, req)
        state.active.copy_(torch.as_tensor(self._live_mask(lane)))
        state.block_tables.copy_(self.pcache.device_tables(lane_id))
        self._tables_stale.discard(lane_id)
        self.compactor.observe_prefill_exit(float(exit_idx))
        s.generated.append(tok)
        s.exit_depths.append(exit_idx)
        s.confs.append(conf)
        self._finish_if_done(s, t0, lane_id, slot_idx)

    def _finish_if_done(self, s: _Slot, pos: int, lane_id: int,
                        slot_idx: int):
        if (len(s.generated) >= s.request.max_new_tokens
                or pos >= self.cache_len - 1):
            self._retire(s, lane_id, slot_idx)

    def _retire(self, s: _Slot, lane_id: int, slot_idx: int,
                escalated: bool = False, reason: str = "escalate"):
        s.done = True
        self.finished[s.request.rid] = {
            "tokens": list(s.generated),
            "exit_depths": list(s.exit_depths),
            "confs": list(s.confs),
            "lane": lane_id,
            "escalated": escalated,
        }
        if self.flight is not None:
            ds = np.asarray(s.exit_depths, np.int64)
            self.flight.on_finish(
                s.request.rid, reason if escalated else "exit", {
                    "n_tokens": len(s.generated),
                    "exit_component_last": int(ds[-1]) if ds.size else None,
                    "mean_exit_depth": (float(ds.mean()) if ds.size
                                        else None),
                    "macs": (float(np.sum(np.asarray(self.mac_prefix)[ds]))
                             if ds.size else 0.0),
                    "lane": lane_id,
                    "slot": slot_idx,
                })
        self.compactor.observe_retire(lane_id)
        if self.paged:
            # skip-aware reclamation at the first host sync after the slot
            # finished: components the cascade never answered from come
            # back as reclaimed_by_exit, the rest at retire
            md = max(s.exit_depths) if s.exit_depths else None
            self.pcache.release_slot(lane_id, slot_idx, max_exit_depth=md)
            self._tables_stale.add(lane_id)

    def cancel(self, rid: int, keep: Optional[int] = None,
               reason: str = "escalate") -> Optional[dict]:
        """Retire request ``rid`` early, keeping only its first ``keep``
        generated tokens (None = all): the escalation tier's defer hook and
        a fleet drain's migration hook (``reason="migrate"``, the terminal
        its flight records), called between engine ticks.  Returns the
        finished record (its ``escalated`` flag set), or None if ``rid`` is
        not known here.

        A live slot retires through the ordinary path: it leaves the next
        dispatch's active mask (under the device runtime, through the live
        mask the chunk loads into the buffers its graph reads: no
        capture), and a paged slot's blocks return to the pool.  Tokens
        past ``keep`` were decoded and their compute stays in the MAC
        window: it was spent.  A queued request (never admitted) leaves the
        queue with an empty record (no tokens, no lane) and does not count
        toward ``cancelled_for_escalation``."""
        for lane_id, lane in enumerate(self.lanes):
            for slot_idx, s in enumerate(lane["slots"]):
                if s.done or s.request is None or s.request.rid != rid:
                    continue
                if keep is not None:
                    s.generated = s.generated[:keep]
                    s.exit_depths = s.exit_depths[:keep]
                    s.confs = s.confs[:keep]
                self._cancelled_for_escalation += 1
                self._retire(s, lane_id, slot_idx, escalated=True,
                             reason=reason)
                return self.finished[rid]
        for qi, req in enumerate(self.queue):
            if req.rid != rid:
                continue
            self.queue.pop(qi)
            self._submit_tick.pop(rid, None)
            self.finished[rid] = {"tokens": [], "exit_depths": [],
                                  "confs": [], "lane": None,
                                  "escalated": True}
            if self.flight is not None:
                # never admitted: "cancelled" whatever the reason
                self.flight.on_finish(rid, "cancelled",
                                      {"queued": True, "reason": reason,
                                       "n_tokens": 0})
            return self.finished[rid]
        return None

    def _live_mask(self, lane) -> np.ndarray:
        return np.array([not s.done for s in lane["slots"]])


    def _lane_prefill(self, lane, lane_id: int):
        """(Re)prefill a lane: contexts left-padded to a common length (the
        reference's semantics: the pad tokens are attended over).  In-flight
        slots re-prefill with their full context (prompt + tokens generated
        so far), so admission never truncates a live sequence."""
        slots = lane["slots"]
        prompts = [np.concatenate([s.request.prompt,
                                   np.asarray(s.generated, np.int32)])
                   if not s.done else np.zeros((1,), np.int32)
                   for s in slots]
        S = max(2, max(len(p) for p in prompts))
        toks = np.zeros((self.lane_batch, S), np.int32)
        for i, p in enumerate(prompts):
            toks[i, -len(p):] = p          # left-pad
        if self.paged:
            # the re-prefill restarts every resident at the common length:
            # release ALL the lane's reservations, then claim coverage for
            # each live slot's full span at the new one (_lane_plan_fits
            # guaranteed that it fits)
            for i in range(self.lane_batch):
                self.pcache.release_slot(lane_id, i)
            for i, s in enumerate(slots):
                if s.done:
                    continue
                rem = max(1, s.request.max_new_tokens - len(s.generated))
                ok = self.pcache.alloc_slot(lane_id, i, 0, S + rem)
                assert ok, "lane prefill outgrew its admission plan"
            lane["kpos"].fill_(-1)
            self._tables_stale.discard(lane_id)
        else:
            # the lane's slab, back to its init values in place (it keeps
            # its address; an xLSTM stabiliser restarts at its sentinel)
            self.model.reset_cache(lane["cache"])
        cache_in = self._lane_cache(lane)
        # the re-prefill restarts the lane's DecodeState (streaks, EMA,
        # cursor); its telemetry and live thresholds live as long as the
        # lane and carry over (the prefill adds its shadow observation)
        old = lane["state"]
        state = self.executor.init_state(
            old.active.shape[0], active=self._live_mask(lane)[self._rows],
            mac_weights=self.mac_prefix, telemetry=old.tel,
            block_tables=(self.pcache.device_tables(lane_id)
                          if self.paged else None))
        if old.thresholds is not None:
            state = state.replace(thresholds=old.thresholds)
        fresh_admits = [s for s in slots if not s.done and not s.generated]
        t_pre = time.perf_counter()
        with parallel.activate(self.transport):
            d, cache, state = self.executor.prefill(
                self.params, torch.as_tensor(toks[self._rows],
                                             device=self.device),
                cache_in, state, extra=self._extra)
        tok = d.prediction.cpu().numpy()   # syncs the device
        exit_idx = d.exit_index.cpu().numpy()
        conf = d.confidence.cpu().numpy()
        if self.transport is not None:
            # the other data ranks' rows, and their shadow observations
            tok, exit_idx, conf = self.transport.gather_rows(
                tok.astype(np.int32), exit_idx.astype(np.int32),
                conf.astype(np.float32))
            if state.tel is not None:
                sync_telemetry(state.tel, self.transport)
        dt_pre = time.perf_counter() - t_pre
        self._prefill_seconds += dt_pre
        self._prefills += 1
        # this shared dispatch's replayed-prefix share goes to the newly
        # admitted escalated requests riding in it
        for s in fresh_admits:
            self._account_prefill(s.request, dt_pre, self.lane_batch * S)
        if self.flight is not None:
            # before the slot loop below, which may retire flights
            self.flight.on_prefill(
                lane_id, t_pre, dt_pre,
                [s.request.rid for s in slots if not s.done],
                [s.request.rid for s in fresh_admits], S)
        self._set_state(lane, state)
        lane["t"] = S
        for i, s in enumerate(slots):
            if s.done:
                continue
            if not s.generated:
                # warm the admission depth prior with a FIRST prefill exit
                self.compactor.observe_prefill_exit(float(exit_idx[i]))
            s.generated.append(int(tok[i]))
            s.exit_depths.append(int(exit_idx[i]))
            s.confs.append(float(conf[i]))
            self._finish_if_done(s, S, lane_id, i)
        self._sync_tables(lane, lane_id)
        lane["dirty"] = False

    def step(self):
        """One engine tick: admit, prefill dirty lanes, then decode one
        token per live lane (``runtime="host"``) or up to ``chunk`` tokens
        per lane in one dispatch (``runtime="device"``)."""
        self._tick += 1
        if self.admitting:
            self._admit()
        for lane_id, lane in enumerate(self.lanes):
            if all(s.done for s in lane["slots"]):
                continue
            if lane.get("dirty"):
                self._lane_prefill(lane, lane_id)
                continue
            if self.runtime == "device":
                self._device_tick(lane, lane_id)
            else:
                self._host_tick(lane, lane_id)
        if self.controller is not None:
            self.controller.maybe_update(self)

    # -- autotune surface -------------------------------------------------
    def lane_telemetry(self) -> List:
        """The lanes' device telemetry counters (lane order)."""
        return [lane["state"].tel for lane in self.lanes
                if lane["state"].tel is not None]

    def current_thresholds(self):
        """The live threshold vector lanes decode with, or None (static
        config thresholds)."""
        return self._live_thresholds

    def push_thresholds(self, thresholds) -> None:
        """Write a threshold vector into every lane's live vector, in
        place: the exit kernels read it from device memory, so neither
        runtime rebuilds or re-captures anything."""
        pushed = tuple(float(t) for t in thresholds)
        ths = np.asarray(pushed, np.float32)
        n_m = self.cfg.cascade.n_components
        if ths.shape != (n_m,):
            raise ValueError(f"threshold vector shape {ths.shape} != "
                             f"({n_m},)")
        if not self.cfg.autotune.enabled:
            raise ValueError(
                "live threshold pushes need autotune-enabled decode steps "
                "(cfg.with_autotune(enabled=True)); without them the "
                "config's thresholds are fixed")
        src = torch.as_tensor(ths)
        for lane in self.lanes:
            lane["state"].thresholds.copy_(src)
        # report what the caller pushed, not its f32 rounding (the 1.1
        # never-exit sentinel must round-trip exactly)
        self._live_thresholds = pushed
        if self.flight is not None:
            self.flight.on_event("threshold_push",
                                 {"thresholds": list(pushed),
                                  "tick": self._tick})

    # -- observability surface (repro_torch.obs) --------------------------
    @property
    def obs_events(self):
        """The engine-level event log (None with the recorder off): where
        a ThresholdController records its resolves."""
        return self.flight.events if self.flight is not None else None

    def dump_flight(self, rid: int) -> Optional[dict]:
        """One request's span tree (live or from the done ring), or None
        if unknown, evicted from the ring or the recorder is off."""
        return self.flight.dump(rid) if self.flight is not None else None

    def flights(self, include_live: bool = False) -> List[dict]:
        return (self.flight.flights(include_live)
                if self.flight is not None else [])

    def latency_stats(self) -> dict:
        """p50/p95/p99 latency summaries: ``admission_wait_ticks`` from
        the window counter (it resets with :meth:`reset_metrics`), the rest
        from the recorder's lifetime reservoirs (None with it off)."""
        out = {"admission_wait_ticks": quantiles(self._admit_waits)}
        if self.flight is not None:
            lat = self.flight.latency()
            lat.pop("admission_wait_ticks", None)
            out.update(lat)
        else:
            out.update({"e2e_seconds": None, "per_token_seconds": None,
                        "macs_per_request": None,
                        "tokens_per_request": None})
        return out

    def scrape(self) -> str:
        """Prometheus text exposition of this engine's metrics."""
        return engine_metrics_into(MetricsRegistry(), self).render_text()

    def scrape_json(self) -> dict:
        return engine_metrics_into(MetricsRegistry(), self).render_json()

    def _account(self, lane_id: int, depths: np.ndarray, n_tokens: int,
                 ran: np.ndarray, steps: int, max_depths):
        """Per-tick accounting of ``steps`` decode steps of one lane."""
        n_comp = self.cfg.cascade.n_components
        self._decode_steps += steps
        self._segments_run += ran.astype(np.int64)
        C = self.cohorts
        skipped_real = float(np.sum((C * steps - ran[1:]) / C))
        for md in max_depths:
            self._skip_opportunities += max(0, (n_comp - 1) - md)
            self._skip_opportunity_total += n_comp - 1
        self._macs_dense += n_tokens * self.mac_prefix[-1]
        self._macs_spent += float(
            np.sum(np.asarray(self.mac_prefix)[depths])) if n_tokens else 0.0
        self.compactor.observe(lane_id, depths, skipped_real, steps=steps)

    def _host_tick(self, lane, lane_id: int):
        """Decode ONE token for every live slot of a lane."""
        last = [s.generated[-1] if not s.done else 0 for s in lane["slots"]]
        token = torch.as_tensor(np.array(last, np.int32)[:, None],
                                device=self.device)
        live = self._live_mask(lane)
        state = lane["state"].replace(
            active=torch.as_tensor(live, device=self.device))
        run_before = state.segments_run.copy()
        syncs_before = self.executor.host_syncs
        dispatch_before = dict(self.executor.dispatch)
        if self.paged:
            self.pcache.pool.begin_chunk()
        t0 = time.perf_counter()
        d, cache, state = self.executor.decode_step(
            self.params, token, self._lane_cache(lane), state,
            position=lane["t"])
        tok = d.prediction.cpu().numpy()   # syncs the device
        exit_idx = d.exit_index.cpu().numpy()
        conf = d.confidence.cpu().numpy()
        dt = time.perf_counter() - t0
        n_live = int(live.sum())
        warm = self._decode_warm
        if warm:
            self._decode_seconds += dt
            self._decode_tokens += n_live
            self._decode_dispatches += 1
            self._dispatch_log.append((dt, n_live))
            # the result fetch + the executor's skip-predicate reads
            self._host_syncs += 1 + self.executor.host_syncs - syncs_before
            for k, n in self.executor.dispatch.items():
                self._dispatch[k] += n - dispatch_before[k]
        else:
            self._compile_seconds += dt
            self._decode_warm = True
        lane["state"] = state
        lane["t"] += 1
        depths = exit_idx[live]
        ran = state.segments_run - run_before
        if self.flight is not None:
            # the chunk span lands before the slot loop below, which may
            # retire flights
            self.flight.on_chunk(
                lane_id, t0, dt, 1,
                [(s.request.rid, [int(tok[i])], [int(exit_idx[i])],
                  [float(conf[i])])
                 for i, s in enumerate(lane["slots"]) if not s.done],
                compiled=not warm, segments_run=ran)
        if warm:
            # the warm-up dispatch is excluded from every window metric
            self._account(lane_id, depths, n_live, ran, steps=1,
                          max_depths=[int(depths.max()) if n_live else 0])
        for i, s in enumerate(lane["slots"]):
            if s.done:
                continue
            s.generated.append(int(tok[i]))
            s.exit_depths.append(int(exit_idx[i]))
            s.confs.append(float(conf[i]))
            self._finish_if_done(s, lane["t"], lane_id, i)
        self._sync_tables(lane, lane_id)
        if self.paged:
            self.pcache.pool.end_chunk()

    def _device_tick(self, lane, lane_id: int):
        """Decode up to ``chunk`` tokens for a lane in ONE dispatch of the
        device loop, synced to the host once; finished slots drain from
        the returned buffers."""
        slots = lane["slots"]
        last = [s.generated[-1] if not s.done else 0 for s in slots]
        live = self._live_mask(lane)
        remaining = np.array(
            [s.request.max_new_tokens - len(s.generated) if not s.done else 0
             for s in slots], np.int32)
        state = lane["state"]
        run_before = state.segments_run.copy()
        syncs_before = self.loop.host_syncs
        dispatch_before = dict(self.loop.executor.dispatch)
        if self.paged:
            self.pcache.pool.begin_chunk()
        chunk, _, state = self.loop.run_chunk(
            self.params, np.array(last, np.int32)[:, None],
            self._lane_cache(lane), state, remaining, active=live)
        n = chunk.n_steps
        lane["t"] += n
        if n and chunk.t != lane["t"]:
            raise RuntimeError(f"lane {lane_id}: the device position "
                               f"{chunk.t} left its host mirror {lane['t']}")
        n_tok = int(chunk.live.sum())
        if chunk.compiled:                 # the capture chunk
            self._compile_seconds += chunk.seconds
        else:
            self._decode_seconds += chunk.seconds
            self._decode_tokens += n_tok
            self._decode_dispatches += 1
            self._dispatch_log.append((chunk.seconds, n_tok))
            # one result fetch per chunk on CUDA; none on a CPU lane,
            # where the loop's reads cost no sync
            self._host_syncs += self.loop.host_syncs - syncs_before
            for k, c in self.loop.executor.dispatch.items():
                self._dispatch[k] += c - dispatch_before[k]
        if not n:
            if self.paged:
                self.pcache.pool.end_chunk()
            return
        ran = state.segments_run - run_before
        if self.flight is not None:
            # the chunk's one fetch already brought every row to the host
            entries = []
            for i, s in enumerate(slots):
                if s.done:
                    continue
                rows = [step for step in range(n) if chunk.live[step, i]]
                entries.append((
                    s.request.rid,
                    [int(chunk.tokens[r, i]) for r in rows],
                    [int(chunk.exits[r, i]) for r in rows],
                    [float(chunk.confs[r, i]) for r in rows]))
            self.flight.on_chunk(lane_id, chunk.t_host, chunk.seconds, n,
                                 entries, compiled=chunk.compiled,
                                 segments_run=ran)
        if not chunk.compiled:
            # like the host tick: the capture chunk is excluded from every
            # window metric so that all stats() rates cover the same steps
            max_depths = []
            for step in range(n):
                d = chunk.exits[step][chunk.live[step]]
                max_depths.append(int(d.max()) if d.size else 0)
            self._account(lane_id, chunk.exits[chunk.live], n_tok, ran,
                          steps=n, max_depths=max_depths)
        for i, s in enumerate(slots):
            if s.done:
                continue
            for step in range(n):
                if chunk.live[step, i]:
                    s.generated.append(int(chunk.tokens[step, i]))
                    s.exit_depths.append(int(chunk.exits[step, i]))
                    s.confs.append(float(chunk.confs[step, i]))
            self._finish_if_done(s, lane["t"], lane_id, i)
        self._sync_tables(lane, lane_id)
        if self.paged:
            self.pcache.pool.end_chunk()

    def run(self, max_ticks: int = 1000):
        for _ in range(max_ticks):
            if not self.queue and all(
                    s.done for ln in self.lanes for s in ln["slots"]):
                break
            self.step()
        return self.finished

    # -- metrics ---------------------------------------------------------
    def speedup(self) -> float:
        """Analytic MAC speedup vs always running the full cascade."""
        if not self._macs_spent:
            return 1.0
        return self._macs_dense / self._macs_spent

    def wallclock_us_per_token(self) -> Optional[float]:
        """Measured decode wall-clock per generated token (µs), warm-up
        dispatch excluded."""
        if not self._decode_tokens:
            return None
        return 1e6 * self._decode_seconds / self._decode_tokens

    def kernel_provenance(self) -> dict:
        """Which backend each kernel takes on this engine's device, and its
        launches since the counters were last reset (process-wide; under
        the device runtime those its graph replays ran)."""
        prov = kernel_provenance(self.cfg, self.device)
        return {
            "device": prov["kernel_platform"],
            "kernels": {name: {"backend": prov["kernel_backend"],
                               "launches": n}
                        for name, n in kernels.launch_counts().items()},
        }

    def stats(self) -> dict:
        """A snapshot of the engine's metrics."""
        depths = list(itertools.chain.from_iterable(
            r["exit_depths"] for r in self.finished.values()))
        opp = (self._skip_opportunities / self._skip_opportunity_total
               if self._skip_opportunity_total else 0.0)
        syncs = self._host_syncs
        tokens = self._decode_tokens
        return copy.deepcopy({
            "requests_finished": len(self.finished),
            "mean_exit_depth": float(np.mean(depths)) if depths else None,
            "exit_histogram": np.bincount(
                depths, minlength=self.cfg.cascade.n_components).tolist()
            if depths else None,
            "analytic_speedup": self.speedup(),
            "cond_batch_skip_rate": self.compactor.skip_rate(),
            "skip_opportunity_rate": opp,
            "segments_run": self._segments_run.tolist(),
            "wallclock_us_per_token": self.wallclock_us_per_token(),
            "compile_seconds": self._compile_seconds,
            "prefill_seconds": self._prefill_seconds,
            "prefills": self._prefills,
            # continuous single-slot admissions (paged layout), each a B = 1
            # prefill into a live lane; their time is in prefill_seconds
            "slot_prefills": self._slot_prefills,
            "decode_seconds": self._decode_seconds,
            "decode_tokens": tokens,
            # decode-window device -> host syncs: host runtime, one result
            # fetch per dispatch plus one skip-predicate read per deep
            # segment per cond_batch step; device runtime on CUDA, one per
            # lane chunk
            "host_syncs": syncs,
            "host_syncs_per_token": (syncs / tokens) if tokens else None,
            # decode dispatches in the window: host ticks, or lane chunks
            "decode_dispatches": self._decode_dispatches,
            # their spread: (min, median, max) of each dispatch's
            # wall-clock ms and of its µs per token
            "dispatch_spread": _spread(self._dispatch_log),
            "runtime": self.runtime,
            # tokens per lane per dispatch
            "chunk": self.chunk if self.runtime == "device" else 1,
            # CUDA graphs the device runtime captured (one per lane: a
            # threshold push captures nothing), cumulative
            "captures": self.loop.captures if self.loop is not None else 0,
            "n_cohorts": self.cohorts,
            "cohort_layout": self.cfg.cascade.cohort_layout,
            # deep-segment dispatch branches of cohort-split steps (major
            # layout: all cohorts skip / mixed / all run)
            "cohort_dispatch": dict(self._dispatch),
            "use_kernels": self.cfg.use_kernels,
            "lane_batch": self.lane_batch,
            "cache_layout": "paged" if self.paged else "dense",
            # ticks a request waited between submit and admission
            "admission_wait_ticks": list(self._admit_waits),
            "admission_wait_mean": (float(np.mean(self._admit_waits))
                                    if self._admit_waits else None),
            # block-pool occupancy (paged) vs the always-resident slab
            # footprint (dense), under the same keys
            "memory": (self.pcache.stats() if self.paged else {
                "cache_layout": "dense",
                "num_blocks": None,
                "block_size": None,
                "block_bytes": None,
                "blocks_free": None,
                "blocks_used": None,
                "peak_blocks_used": None,
                "reclaimed_by_exit": 0,
                "reclaimed_at_retire": 0,
                "blocks_reclaimed_per_chunk": [],
                "peak_cache_bytes": self._dense_cache_bytes,
                "dense_slab_bytes": self._dense_cache_bytes,
            }),
            "lane_conf_ema": [
                float(lane["state"].ema_conf.float().mean().item())
                for lane in self.lanes],
            "provenance": self.kernel_provenance(),
            "latency": self.latency_stats(),
            "obs": (self.flight.stats() if self.flight is not None
                    else None),
            "autotune": self._autotune_stats(),
            # cross-model escalation: the replayed-prefix prefill split from
            # fresh traffic, so a tier never counts a committed prefix twice
            "escalation": {
                "escalated_requests_admitted": self._escalated_admitted,
                "cancelled_for_escalation": self._cancelled_for_escalation,
                "prefill_positions_fresh": self._prefill_positions_fresh,
                "prefill_positions_replayed":
                    self._prefill_positions_replayed,
                "replay_prefill_macs": self._replay_prefill_macs,
                "replay_prefill_seconds": self._replay_prefill_seconds,
            },
        })

    def _autotune_stats(self):
        if not self.cfg.autotune.enabled:
            return None
        from repro_torch.autotune.telemetry import merge_telemetry
        out = {
            "thresholds": (list(self._live_thresholds)
                           if self._live_thresholds is not None else None),
            "controller": (self.controller.stats()
                           if self.controller is not None else None),
        }
        tels = self.lane_telemetry()
        if tels:
            tel = merge_telemetry(tels)
            out.update({
                "steps": float(tel["steps"]),
                "shadow_steps": float(tel["shadow_steps"]),
                "exit_counts": [float(c) for c in tel["exit_counts"]],
                "mac_spent": float(tel["mac_spent"]),
            })
        return out
