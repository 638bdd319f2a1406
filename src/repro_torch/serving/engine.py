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

One decode step per lane per tick, synced to the host every tick
(``runtime="host"``).  The device runtime, paged layout, autotune,
escalation, fleet and observability hooks come in later slices of the port
and are refused here.
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
from repro_torch.configs.base import ModelConfig
from repro_torch.core.exec import StagedExecutor, effective_cohorts
from repro_torch.core.macs import segment_macs_per_token
from repro_torch.models.model import CascadeModel
from repro_torch.serving.batching import DepthCompactor, cohort_capacity
from repro_torch.utils import resolve_device


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


def _refuse_unported(cfg: ModelConfig, runtime, mesh, autotune) -> None:
    later = []
    if runtime != "host":
        later.append(f"runtime={runtime!r} (the device decode loop)")
    if mesh is not None:
        later.append("mesh sharding")
    if autotune is not None and autotune is not False:
        later.append("autotune")
    if cfg.obs.enabled:
        later.append("the observability flight recorder")
    if cfg.escalation.enabled:
        later.append("cross-model escalation")
    if later:
        raise NotImplementedError(
            "not ported yet (later slices of the port): " + ", ".join(later))


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
                 cache_len: int = 256, runtime: str = "host", mesh=None,
                 autotune=None, device=None):
        if runtime not in ("host", "device"):
            raise ValueError(
                f"runtime must be 'host' or 'device', got {runtime!r}")
        _refuse_unported(cfg, runtime, mesh, autotune)
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.model = model
        self.params = params
        lane_batch = cohort_capacity(lane_batch, cfg.cascade.n_cohorts)
        self.lane_batch = lane_batch
        self.n_lanes = n_lanes
        self.cache_len = cache_len
        self.runtime = runtime
        self.cohorts = effective_cohorts(cfg.cascade.n_cohorts, lane_batch)
        self.compactor = DepthCompactor(n_lanes, cfg.cascade.n_components)
        self.executor = StagedExecutor(model, cfg)
        self.decider = self.executor.decider
        self.mac_prefix = segment_macs_per_token(cfg, cache_len)
        self.lanes = []
        for _ in range(n_lanes):
            self.lanes.append({
                "slots": [_Slot() for _ in range(lane_batch)],
                "state": self.executor.init_state(lane_batch),
                "cache": model.init_cache(lane_batch, cache_len),
            })
        self.queue: List[Request] = []
        self.finished: Dict[int, dict] = {}
        self._tick = 0
        self._submit_tick: Dict[int, int] = {}
        # the first decode dispatch also pays one-time set-up (kernel
        # build/load, library handles): it is reported as compile_seconds
        # and never counted in the decode window
        self._compile_seconds = 0.0
        self._decode_warm = False
        self.reset_metrics()

    def reset_metrics(self):
        """Zero the MAC / wall-clock / skip-rate / host-sync accounting;
        the compactor's learned depth EMAs and ``compile_seconds`` survive,
        and per-request outputs (``finished``) are not cleared."""
        self.compactor.reset_skip_counters()
        self._macs_spent = 0.0
        self._macs_dense = 0.0
        self._decode_seconds = 0.0
        self._decode_tokens = 0
        self._prefill_seconds = 0.0
        self._prefills = 0
        self._segments_run = np.zeros(self.cfg.cascade.n_components, np.int64)
        self._decode_steps = 0
        self._skip_opportunities = 0
        self._skip_opportunity_total = 0
        self._admit_waits: List[int] = []
        self._host_syncs = 0
        self._dispatch = dict.fromkeys(self.executor.dispatch, 0)

    # -- public API -----------------------------------------------------
    def submit(self, req: Request):
        self._submit_tick.setdefault(req.rid, self._tick)
        self.queue.append(req)

    def _predict_depth(self, req: Request) -> float:
        hint = (req.extra or {}).get("predicted_depth")
        return self.compactor.predict_depth(hint)

    def _admit(self):
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
            slot = lane["slots"][slot_idx]
            slot.request = req
            slot.generated = []
            slot.exit_depths = []
            slot.confs = []
            slot.done = False
            # the cache is shared per lane: admission re-prefills the lane
            lane["dirty"] = True
            sub = self._submit_tick.pop(req.rid, self._tick)
            self._admit_waits.append(self._tick - sub)

    def _finish_if_done(self, s: _Slot, pos: int, lane_id: int):
        if (len(s.generated) >= s.request.max_new_tokens
                or pos >= self.cache_len - 1):
            self._retire(s, lane_id)

    def _retire(self, s: _Slot, lane_id: int):
        s.done = True
        self.finished[s.request.rid] = {
            "tokens": list(s.generated),
            "exit_depths": list(s.exit_depths),
            "confs": list(s.confs),
            "lane": lane_id,
            "escalated": False,
        }
        self.compactor.observe_retire(lane_id)

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
        cache_in = self.model.init_cache(self.lane_batch, self.cache_len)
        state = self.executor.init_state(self.lane_batch,
                                         active=self._live_mask(lane))
        t_pre = time.perf_counter()
        d, cache, state = self.executor.prefill(
            self.params, torch.as_tensor(toks, device=self.device), cache_in,
            state)
        tok = d.prediction.cpu().numpy()   # syncs the device
        exit_idx = d.exit_index.cpu().numpy()
        conf = d.confidence.cpu().numpy()
        self._prefill_seconds += time.perf_counter() - t_pre
        self._prefills += 1
        lane["cache"] = cache
        lane["state"] = state
        for i, s in enumerate(slots):
            if s.done:
                continue
            if not s.generated:
                # warm the admission depth prior with a FIRST prefill exit
                self.compactor.observe_prefill_exit(float(exit_idx[i]))
            s.generated.append(int(tok[i]))
            s.exit_depths.append(int(exit_idx[i]))
            s.confs.append(float(conf[i]))
            self._finish_if_done(s, S, lane_id)
        lane["dirty"] = False

    def step(self):
        """One engine tick: admit, prefill dirty lanes, then decode one
        token per live lane."""
        self._tick += 1
        self._admit()
        for lane_id, lane in enumerate(self.lanes):
            if all(s.done for s in lane["slots"]):
                continue
            if lane.get("dirty"):
                self._lane_prefill(lane, lane_id)
                continue
            self._host_tick(lane, lane_id)

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
        t0 = time.perf_counter()
        d, cache, state = self.executor.decode_step(
            self.params, token, lane["cache"], state)
        tok = d.prediction.cpu().numpy()   # syncs the device
        exit_idx = d.exit_index.cpu().numpy()
        conf = d.confidence.cpu().numpy()
        dt = time.perf_counter() - t0
        n_live = int(live.sum())
        warm = self._decode_warm
        if warm:
            self._decode_seconds += dt
            self._decode_tokens += n_live
            # the result fetch + the executor's skip-predicate reads
            self._host_syncs += 1 + self.executor.host_syncs - syncs_before
            for k, n in self.executor.dispatch.items():
                self._dispatch[k] += n - dispatch_before[k]
        else:
            self._compile_seconds += dt
            self._decode_warm = True
        lane["cache"] = cache
        lane["state"] = state
        depths = exit_idx[live]
        ran = state.segments_run - run_before
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
            self._finish_if_done(s, state.t, lane_id)

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
        """Which route each kernel takes on this engine's device, and its
        launches since the counters were last reset (process-wide)."""
        on_gpu = self.device.type == "cuda"
        backend = ("cuda" if on_gpu else "torch-cpu") if self.cfg.use_kernels \
            else "off"
        counts = kernels.launch_counts()
        return {
            "device": (torch.cuda.get_device_name(self.device) if on_gpu
                       else "cpu"),
            "kernels": {name: {"backend": backend, "launches": n}
                        for name, n in counts.items()},
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
            "decode_seconds": self._decode_seconds,
            "decode_tokens": tokens,
            # decode-window device -> host syncs: one result fetch per
            # dispatch plus one skip-predicate read per deep segment per
            # cond_batch step
            "host_syncs": syncs,
            "host_syncs_per_token": (syncs / tokens) if tokens else None,
            "runtime": self.runtime,
            "n_cohorts": self.cohorts,
            "cohort_layout": self.cfg.cascade.cohort_layout,
            # deep-segment dispatch branches of cohort-split steps (major
            # layout: all cohorts skip / mixed / all run)
            "cohort_dispatch": dict(self._dispatch),
            "use_kernels": self.cfg.use_kernels,
            "lane_batch": self.lane_batch,
            "cache_layout": "dense",
            "admission_wait_ticks": list(self._admit_waits),
            "lane_conf_ema": [
                float(lane["state"].ema_conf.float().mean().item())
                for lane in self.lanes],
            "provenance": self.kernel_provenance(),
        })
