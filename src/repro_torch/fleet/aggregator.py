"""Fleet-wide telemetry merge + one shared solve.

The counterpart of the JAX package's ``fleet/aggregator.py``.
:class:`TelemetryAggregator` IS a :class:`~repro_torch.autotune.controller.
ThresholdController` — the fleet scheduler exposes the same three-method
surface an engine does (``lane_telemetry()`` concatenating every healthy
member's lanes, ``current_thresholds()``, ``push_thresholds()`` fanning
out to every member), so the controller's whole pipeline — window
accounting, min-shadow / hysteresis / drift guards, histogram build,
coordinate-descent solve, artifact persistence — runs UNCHANGED one
level up.  There is no fleet-specific solver: fixed-bin histograms merge
by elementwise addition (:func:`repro_torch.autotune.solver.merge_histograms`),
so the merged solve is exactly the pooled-sample solve.

The aggregation win is warm-up: the ``min_shadow`` evidence window fills
from K engines' shadow samplers at once, so the fleet reaches its first
stable threshold push in ~1/K the per-engine shadow samples any single
engine would need.  Each member's ``push_thresholds`` writes the vector
into its lanes' device δ̂ tensors, which the exit kernels read from device
memory, so a fleet push captures no CUDA graph.  Artifacts written here carry ``source="fleet"`` so a warm-starting
engine (or a member added later via ``FleetScheduler.add_member``) can
tell it is seeding from fleet-scale evidence.
"""
from __future__ import annotations

from typing import List

from repro_torch.autotune.controller import ThresholdController
from repro_torch.autotune.solver import ExitHistogram, merge_histograms
from repro_torch.autotune.telemetry import merge_telemetry


class TelemetryAggregator(ThresholdController):
    """A ThresholdController whose "engine" is a whole FleetScheduler.

    Construction is the controller's (``cfg``, ``mac_prefix``, the guard
    overrides, ``artifact_dir``); pass the instance as
    ``FleetScheduler(..., aggregator=...)`` and the scheduler attaches it
    (warm-start push fans to every member) and drives
    :meth:`maybe_update` once per fleet tick.  Members must NOT carry
    their own controllers — two solvers pushing thresholds at each other
    through the same engines is churn, and the scheduler refuses the
    combination at construction.
    """

    source = "fleet"

    # ------------------------------------------------------------------
    # introspection helpers (tests and the fleet scrape; the solve path
    # never calls these)
    def per_member_shadow(self, fleet) -> List[float]:
        """Each member's own accumulated shadow evidence — what that
        engine would be solving from if it were alone (the per-member
        share of the merged solve's evidence)."""
        out = []
        for m in fleet.members:
            tels = m.lane_telemetry()
            out.append(float(merge_telemetry(tels)["shadow_steps"])
                       if tels else 0.0)
        return out

    def metrics_into(self, reg, fleet) -> None:
        """Contribute the aggregator's view to a fleet scrape: solver
        counters plus each member's own shadow evidence (the per-member
        share of the merged solve's evidence pool)."""
        st = self.stats()
        reg.counter("repro_fleet_autotune_resolves_total",
                    "Merged telemetry solves attempted.", st["resolves"])
        reg.counter("repro_fleet_autotune_pushes_total",
                    "Merged solves that pushed thresholds.", st["pushes"])
        reg.counter("repro_fleet_autotune_drift_resets_total",
                    "Confidence-drift telemetry rebases.",
                    st["drift_resets"])
        try:
            shadows = self.per_member_shadow(fleet)
        except Exception:                             # noqa: BLE001
            return
        for i, s in enumerate(shadows):
            reg.gauge("repro_fleet_member_shadow_steps",
                      "Shadow full-depth evidence accumulated per member.",
                      s, {"member": str(i)})

    def merged_histogram(self, fleet) -> ExitHistogram:
        """Merge per-member histograms explicitly (members → histograms →
        :func:`merge_histograms`).  Equivalent to the solve path's merged-
        telemetry histogram — by construction, since fixed-bin counts sum
        — but built the long way so tests/benches can pin that equality
        member-by-member."""
        hists = [ExitHistogram.from_telemetry(merge_telemetry(tels),
                                              mac_prefix=self.mac_prefix)
                 for m in fleet.members
                 for tels in [m.lane_telemetry()] if tels]
        return merge_histograms(hists)
