"""Depth-compacted continuous batching.

The TPU adaptation of the paper's per-sample early termination (DESIGN.md §5):
``cond_batch`` segment skipping only saves compute when *every* co-resident
sequence is confident, so the scheduler's job is to co-locate requests with
similar expected exit depth.  Each *lane* is an independent (cache, batch)
decode stream; requests are admitted to the lane whose running depth estimate
matches the request's predicted depth (from its prefill exit, then an EMA of
observed exits).

This is a pure-host scheduling layer: no device state moves between lanes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


def cohort_capacity(lane_batch: int, n_cohorts: int) -> int:
    """Round a lane's slot capacity UP to a multiple of ``n_cohorts``.

    Cohorts are contiguous equal-size slot ranges, so a lane whose capacity
    is not a cohort multiple silently degrades to fewer cohorts (see
    :func:`repro.core.exec.effective_cohorts`) — forfeiting exactly the
    per-cohort skip granularity the config asked for.  The serving engine
    admits with this rounded capacity so the degradation path never
    triggers in default configs; the extra slots are ordinary admission
    capacity (idle slots cost one masked row each).
    """
    n = max(1, int(n_cohorts))
    lane_batch = max(1, int(lane_batch))
    return ((lane_batch + n - 1) // n) * n


@dataclasses.dataclass
class LaneStats:
    depth_ema: float
    steps: int = 0
    # float: with cohort-split skipping (cascade.n_cohorts > 1) a segment
    # can be skipped for a fraction of the lane (skipped cohorts / cohorts)
    skipped_segments: float = 0.0
    total_segments: int = 0


class DepthCompactor:
    """Assigns requests to lanes by predicted exit depth.

    Also owns THE population depth prior: one EMA (decay ``ema``) over the
    prefill exits actually observed, used to predict the depth of requests
    that arrive without a hint.  (The serving engine used to keep its own
    copy of this EMA with hard-coded constants; there is exactly one now.)
    """

    def __init__(self, n_lanes: int, n_components: int, ema: float = 0.8):
        self.n_lanes = n_lanes
        self.n_components = n_components
        self.ema = ema
        # lane i targets depth band [i * n_c / n_lanes, (i+1) * n_c / n_lanes)
        self.lane_stats = [LaneStats(depth_ema=(i + 0.5) * n_components
                                     / n_lanes)
                           for i in range(n_lanes)]
        self.population_prior = (n_components - 1) / 2

    def predict_depth(self, hint: Optional[float] = None) -> float:
        """Expected exit depth of an incoming request: an explicit hint
        (e.g. an earlier turn's prefill exit) wins; otherwise the running
        population prior over observed prefill exits."""
        return self.population_prior if hint is None else float(hint)

    def observe_prefill_exit(self, depth: float):
        """Warm the population prior with a FIRST prefill exit."""
        self.population_prior = (self.ema * self.population_prior
                                 + (1 - self.ema) * float(depth))

    def assign(self, predicted_depth: float, free_slots: List[int]) -> int:
        """Pick the free lane whose depth estimate is closest."""
        if not free_slots:
            raise ValueError("no free lanes")
        dists = [abs(self.lane_stats[i].depth_ema - predicted_depth)
                 for i in free_slots]
        return free_slots[int(np.argmin(dists))]

    # -- cohort placement (within-lane skip granularity) -----------------
    def preferred_cohort(self, predicted_depth: float, n_cohorts: int,
                         free_per_cohort: Optional[List[int]] = None) -> int:
        """Cohort band for a predicted exit depth: cohort c of C targets
        depths in [c, c+1) * n_components / C — shallow traffic lands in
        low cohorts, deep traffic in high ones, so per-cohort skip
        predicates fire on homogeneous subgroups.

        ``free_per_cohort`` (length ``n_cohorts``) is the paged-admission
        fix: the count of slots each cohort can actually admit NOW (free
        slot with block-pool coverage behind it).  Without it, the pure
        depth-band answer could point continuous admission at a cohort
        with no admissible slot, stalling the request a whole chunk even
        while another cohort had both a slot and free blocks — worst-case
        -slot thinking surviving into the paged layout.  With it, the
        depth band only breaks ties among cohorts that CAN admit; if the
        band cohort has capacity it wins unchanged."""
        if n_cohorts <= 1:
            return 0
        frac = predicted_depth / max(1, self.n_components - 1)
        band = int(np.clip(int(frac * n_cohorts), 0, n_cohorts - 1))
        if free_per_cohort is None:
            return band
        open_cohorts = [c for c in range(n_cohorts)
                        if c < len(free_per_cohort) and free_per_cohort[c] > 0]
        if not open_cohorts or band in open_cohorts:
            return band
        return min(open_cohorts, key=lambda c: (abs(c - band), c))

    def pick_slot(self, predicted_depth: float, free_slots: List[int],
                  lane_batch: int, n_cohorts: int,
                  free_per_cohort: Optional[List[int]] = None) -> int:
        """Among a lane's free slots, pick the one whose cohort (contiguous
        ``lane_batch / n_cohorts`` slot ranges) best matches the request's
        predicted depth.  n_cohorts == 1 degenerates to first-free;
        ``free_per_cohort`` passes through to :meth:`preferred_cohort`
        (admissibility-aware cohort choice for paged admission)."""
        if not free_slots:
            raise ValueError("no free slots")
        pref = self.preferred_cohort(predicted_depth, n_cohorts,
                                     free_per_cohort)
        return min(free_slots,
                   key=lambda s: (abs(s * n_cohorts // lane_batch - pref), s))

    def observe(self, lane: int, exit_depths: np.ndarray,
                segments_skipped: float, steps: int = 1):
        """Record ``steps`` decode steps of a lane: the exit depths of every
        live (slot, step), and how many segment-executions were skipped
        (fractional under cohort splitting).  The device runtime reports a
        whole K-token chunk at once (steps = chunk length run)."""
        st = self.lane_stats[lane]
        if len(exit_depths):
            # one EMA blend per STEP, compounded: a K-step chunk report
            # must move depth_ema as far as K per-token reports would,
            # or device-runtime lanes adapt ~chunk-times slower than host
            decay = self.ema ** steps
            st.depth_ema = (decay * st.depth_ema
                            + (1 - decay) * float(np.mean(exit_depths)))
        st.steps += steps
        st.skipped_segments += segments_skipped
        st.total_segments += (self.n_components - 1) * steps

    def observe_retire(self, lane: int):
        """A slot in ``lane`` finished: decay the lane's depth EMA toward
        the population prior.  Without this, a lane that drained its deep
        requests keeps a stale high ``depth_ema`` and repels the shallow
        traffic that should now fill it (and vice versa)."""
        st = self.lane_stats[lane]
        st.depth_ema = (self.ema * st.depth_ema
                        + (1 - self.ema) * self.population_prior)

    def skip_rate(self) -> float:
        tot = sum(s.total_segments for s in self.lane_stats)
        if not tot:
            return 0.0
        return sum(s.skipped_segments for s in self.lane_stats) / tot

    def reset_skip_counters(self):
        """Zero the skip accounting without losing the learned depth EMAs
        (scheduler state) — used when the engine resets its metrics after
        jit warm-up so every reported rate covers the same step window."""
        for s in self.lane_stats:
            s.steps = 0
            s.skipped_segments = 0
            s.total_segments = 0
