"""Online exit-telemetry + threshold-autotuning subsystem: pick an
acceptable accuracy degradation ε (or an average-MAC budget) and the
serving engine determines per-component thresholds δ̂_m from live traffic.

The counterpart of the JAX package's ``autotune`` package, with the same
names:

* :mod:`repro_torch.autotune.telemetry` — the device
  :class:`~repro_torch.autotune.telemetry.ExitTelemetry` counters
  accumulated inside the decode step (host runtime and captured CUDA graph
  alike), including the sampled shadow full-depth correctness proxy;
* :mod:`repro_torch.autotune.solver` — the histogram-space
  coordinate-descent threshold solver (a numpy copy);
* :mod:`repro_torch.autotune.controller` — the
  :class:`~repro_torch.autotune.controller.ThresholdController` that
  periodically resolves thresholds from live telemetry and writes them
  into running engines (no re-capture);
* :mod:`repro_torch.autotune.artifacts` — config-hash-keyed calibration
  artifacts, interchangeable with the JAX package's.
"""
from repro_torch.autotune.artifacts import (CalibrationArtifact, config_key,
                                            load_artifact, save_artifact)
from repro_torch.autotune.controller import ThresholdController
from repro_torch.autotune.solver import (ExitHistogram, SolveResult,
                                         compose_escalation,
                                         compose_mac_prefix,
                                         edges_from_thresholds,
                                         merge_histograms,
                                         split_tier_thresholds, solve_budget,
                                         solve_epsilon, thresholds_from_edges)
from repro_torch.autotune.telemetry import (ExitTelemetry, conf_to_bin,
                                            init_telemetry, merge_telemetry,
                                            pack_rider, telemetry_for,
                                            telemetry_to_host)

__all__ = [
    "CalibrationArtifact", "config_key", "load_artifact", "save_artifact",
    "ThresholdController",
    "ExitHistogram", "SolveResult", "compose_escalation",
    "compose_mac_prefix", "edges_from_thresholds", "merge_histograms",
    "split_tier_thresholds", "solve_budget", "solve_epsilon",
    "thresholds_from_edges",
    "ExitTelemetry", "conf_to_bin", "init_telemetry", "merge_telemetry",
    "pack_rider", "telemetry_for", "telemetry_to_host",
]
