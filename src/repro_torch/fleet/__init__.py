"""Fleet tier: one scheduler over N serving engines — the counterpart of
the JAX package's ``fleet`` package, with the same names.

* :mod:`repro_torch.fleet.scheduler` — :class:`FleetScheduler`:
  depth/load/block-aware placement (the engine's DepthCompactor prior
  lifted one level up), drain with committed-prefix migration (the
  escalation replay path), failure rescue.
* :mod:`repro_torch.fleet.aggregator` — :class:`TelemetryAggregator`: the
  ThresholdController run against the whole fleet through the same
  three-method surface an engine exposes; fixed-bin histograms merge by
  addition, so one merged solve equals the pooled-sample solve.
* :mod:`repro_torch.fleet.health` — :class:`EngineHealth`: heartbeat
  probes, consecutive-failure counting, bounded exponential backoff.
"""
from repro_torch.fleet.aggregator import TelemetryAggregator
from repro_torch.fleet.health import EngineHealth, HealthState
from repro_torch.fleet.scheduler import FleetScheduler

__all__ = [
    "EngineHealth",
    "FleetScheduler",
    "HealthState",
    "TelemetryAggregator",
]
