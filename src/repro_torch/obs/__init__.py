"""Observability for the port's serving stack: the counterpart of the JAX
package's ``obs`` package, with the same names.

Three layers, all on the host and all assembled from data the serving
engine already brings to the host at its existing sync points:

* :mod:`repro_torch.obs.recorder` — the **flight recorder**: a structured
  span tree per request (submit → queue-wait → admit → prefill →
  per-chunk decode → exit | escalate | migrate → finalize) kept in a
  bounded ring, plus an engine-level event log (threshold pushes, drains)
  and bounded latency reservoirs.
* :mod:`repro_torch.obs.metrics` — a small metrics registry (counters /
  gauges / quantile summaries) rendered as Prometheus text exposition or
  JSON; ``engine_metrics_into`` maps an engine's ``stats()`` + recorder
  onto it, ``parse_prometheus`` round-trips the text format.
* :mod:`repro_torch.obs.traceviz` — Perfetto / Chrome trace-event JSON
  export (one track per lane/member, chunk-level slices, instant markers
  for threshold pushes and drains) plus a schema validator.

Nothing in here reads a CUDA tensor: recording adds ZERO host syncs and
ZERO CUDA-graph captures, so streams are identical recorder-on and off
(``tests/test_torch_obs.py`` and ``chip_smoke.py``'s "obs" phase).
"""
from repro_torch.obs.metrics import (MetricsRegistry, engine_metrics_into,
                                     parse_prometheus)
from repro_torch.obs.recorder import EventLog, FlightRecorder, Span
from repro_torch.obs.server import MetricsServer
from repro_torch.obs.traceviz import (export_trace, trace_events,
                                      validate_trace_events)

__all__ = [
    "EventLog",
    "FlightRecorder",
    "MetricsRegistry",
    "MetricsServer",
    "Span",
    "engine_metrics_into",
    "export_trace",
    "parse_prometheus",
    "trace_events",
    "validate_trace_events",
]
