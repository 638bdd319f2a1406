"""Serving launcher: cascade early-exit decode through the port's serving
engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --smoke --requests 8 --max-new 8 --threshold 0.5 \\
        --cache-layout paged --cohorts 2 --exit-mode cond_batch

The counterpart of the JAX package's ``launch/serve.py``, with its
flags.  Runs on CUDA unless ``--device cpu``.  The hot ops always take the
port's hand-written kernels (``cfg.use_kernels``; on the CPU their wrappers
take the plain versions).  ``--runtime device --chunk K`` decodes K tokens
per lane per dispatch (on CUDA from a captured CUDA graph).  ``--autotune``
turns on the exit telemetry and a
:class:`~repro_torch.autotune.ThresholdController` that re-solves the
thresholds from live traffic (``--epsilon`` or ``--budget-macs``) and
pushes them into the running engine, warm-starting from and persisting to
``--artifacts``.  ``--escalate-layers N`` / ``--escalate-arch ARCH``
serve a two-stage cross-model escalation tier
(:class:`~repro_torch.escalate.ModelCascadeTier`): stage 0 is ``--arch``,
stage 1 the same arch at N layers (or ARCH, which must share the prompt
vocabulary); stage-0 final-component answers below
``--escalate-threshold`` defer to stage 1, and with ``--autotune`` a
:class:`~repro_torch.escalate.TierThresholdController` solves and pushes
both stages' thresholds and the escalation threshold.  The tier path ends
with a one-line JSON summary on standard output.  ``--fleet N`` serves a
:class:`~repro_torch.fleet.FleetScheduler` over N engines sharing one
set of weights (with ``--autotune``, one
:class:`~repro_torch.fleet.TelemetryAggregator` instead of per-engine
controllers); ``--drain`` drains member 0 in ``migrate`` mode three fleet
ticks in.  ``--obs`` turns on the flight recorder; ``--metrics-port P``
serves ``/metrics``, ``/metrics.json``, ``/flights`` and ``/trace`` on
127.0.0.1:P for one round-tripped scrape, ``--trace-out PATH`` writes the
recording as Chrome trace-event JSON and ``--flight-dump RID`` logs one
request's span tree (each implies ``--obs``).  Weights are random, drawn
from ``torch.Generator(...).manual_seed(s)`` for stage s.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --smoke --device cpu --fleet 2 --drain --obs --trace-out trace.json
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.autotune import ThresholdController
from repro_torch.configs import get_config, reduced
from repro_torch.core.macs import segment_macs_per_token
from repro_torch.models.model import build_model
from repro_torch.serving.engine import CascadeServingEngine, Request
from repro_torch.utils import get_logger, resolve_device

log = get_logger("serve")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Serve random-weight cascade requests through "
                    "CascadeServingEngine and log its stats.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (2 layers, d_model 256, f32)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--confidence", default=None,
                    help="confidence-measure registry spec (softmax_max, "
                         "entropy, margin, patience@k[:base])")
    ap.add_argument("--exit-mode", default="select",
                    choices=["select", "cond_batch"])
    ap.add_argument("--runtime", default="host", choices=["host", "device"],
                    help="host: one dispatch per token; device: up to "
                         "--chunk tokens per lane per dispatch, one host "
                         "sync a chunk")
    ap.add_argument("--chunk", type=int, default=8,
                    help="device-runtime tokens per dispatch")
    ap.add_argument("--cohorts", type=int, default=1,
                    help="cohort-split skip granularity (cascade.n_cohorts)")
    ap.add_argument("--lanes", type=int, default=2)
    ap.add_argument("--lane-batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--cache-layout", default="dense",
                    choices=["dense", "paged"],
                    help="dense: per-lane worst-case KV slabs; paged: "
                         "shared block pool + per-slot block tables with "
                         "exit-triggered reclamation and continuous "
                         "single-slot admission")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged layout: ring positions per KV block (must "
                         "divide the cache capacity)")
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="paged layout: total pool blocks; 0 sizes the "
                         "pool to the dense-equivalent footprint (+1 "
                         "trash block)")
    ap.add_argument("--autotune", action="store_true",
                    help="online exit telemetry + a ThresholdController "
                         "that periodically re-solves the thresholds from "
                         "live traffic and pushes them into the engine "
                         "(no re-capture)")
    ap.add_argument("--epsilon", type=float, default=0.05,
                    help="autotune target accuracy degradation ε (ignored "
                         "when --budget-macs is set)")
    ap.add_argument("--budget-macs", type=float, default=0.0,
                    help="autotune target average MACs/token (> 0 overrides "
                         "--epsilon as the direction)")
    ap.add_argument("--artifacts", default=None,
                    help="autotune artifact directory: warm-start from a "
                         "matching artifact, persist new resolutions")
    ap.add_argument("--escalate-layers", type=int, default=0,
                    help="> 0 serves a 2-stage escalation tier: stage 0 is "
                         "--arch as configured, stage 1 the same arch with "
                         "this many layers (same vocab and family, so "
                         "committed prefixes replay as prefill)")
    ap.add_argument("--escalate-arch", default=None,
                    help="stage-1 arch id of the escalation tier (instead "
                         "of the same arch; must share the prompt vocab)")
    ap.add_argument("--escalate-threshold", type=float, default=0.5,
                    help="stage-0 escalation threshold: final-component "
                         "answers below it defer to stage 1 (0.0 never, "
                         "1.1 always)")
    ap.add_argument("--fleet", type=int, default=1,
                    help="> 1 serves a FleetScheduler over this many engine "
                         "replicas sharing one set of weights: depth/load-"
                         "aware placement, and with --autotune one "
                         "TelemetryAggregator solving the merged fleet "
                         "telemetry instead of per-engine controllers")
    ap.add_argument("--drain", action="store_true",
                    help="fleet: drain engine 0 (mode migrate) three ticks "
                         "into the run — queued work requeues, in-flight "
                         "committed prefixes replay into a sibling, and "
                         "every request must still finish")
    ap.add_argument("--obs", action="store_true",
                    help="the flight recorder: a bounded per-request span "
                         "tree assembled at the existing host syncs (no "
                         "extra sync, no capture)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics (Prometheus text), /metrics.json, "
                         "/flights and /trace on 127.0.0.1:<port> and "
                         "round-trip one scrape before exiting (0 picks a "
                         "free port); implies --obs")
    ap.add_argument("--flight-dump", type=int, default=None, metavar="RID",
                    help="after the run, log this request's span tree as "
                         "JSON; implies --obs")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="after the run, write the recording as Chrome "
                         "trace-event JSON (Perfetto, chrome://tracing); "
                         "implies --obs")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if (args.metrics_port is not None or args.flight_dump is not None
            or args.trace_out):
        args.obs = True
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    n = cfg.cascade.n_components
    ths = tuple([args.threshold] * (n - 1) + [0.0])
    cfg = cfg.replace(use_kernels=True).with_cascade(
        thresholds=ths, exit_mode=args.exit_mode, n_cohorts=args.cohorts)
    if args.confidence:
        cfg = cfg.with_cascade(confidence=args.confidence)
    escalate = bool(args.escalate_layers > 0 or args.escalate_arch)
    if args.autotune:
        # under a tier the escalation threshold is solved over stage 0's
        # final-component confidence axis: route_final telemetry
        cfg = cfg.with_autotune(enabled=True, epsilon=args.epsilon,
                                mac_budget=args.budget_macs,
                                route_final=escalate)
    if args.cache_layout == "paged":
        cfg = cfg.with_paged_cache(layout="paged",
                                   block_size=args.block_size,
                                   num_blocks=args.num_blocks)
    if args.obs:
        cfg = cfg.with_obs()
    if escalate:
        if args.fleet > 1:
            raise SystemExit("--fleet combines with plain engines; to "
                             "fleet escalation tiers build them "
                             "programmatically (repro_torch.fleet)")
        return _serve_tier(args, cfg, device)
    if args.fleet > 1 or args.drain:
        return _serve_fleet(args, cfg, device)
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    controller = None
    if args.autotune:
        controller = ThresholdController(
            cfg, segment_macs_per_token(cfg, args.cache_len),
            artifact_dir=args.artifacts)
    engine = CascadeServingEngine(cfg, model, params,
                                  lane_batch=args.lane_batch,
                                  n_lanes=args.lanes,
                                  cache_len=args.cache_len,
                                  runtime=args.runtime, chunk=args.chunk,
                                  autotune=controller, device=device)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        engine.submit(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size,
                                args.prompt_len).astype(np.int32),
            max_new_tokens=args.max_new))
    engine.run()
    stats = engine.stats()
    log.info("stats: %s", json.dumps(stats, indent=2, default=str))
    if args.autotune:
        log.info("autotune: live thresholds %s, controller %s",
                 engine.current_thresholds(), engine.controller.stats())
    if args.exit_mode == "cond_batch":
        log.info("real skip rate %.3f (opportunity %.3f), %.1f us/token "
                 "(%s runtime, first dispatch %.2fs)",
                 stats["cond_batch_skip_rate"],
                 stats["skip_opportunity_rate"],
                 stats["wallclock_us_per_token"] or 0.0,
                 stats["runtime"], stats["compile_seconds"])
    if args.cache_layout == "paged":
        mem = stats["memory"]
        log.info("paged pool: peak %d/%d blocks (%.1f%% of the dense "
                 "slab), reclaimed by exit %d / at retire %d, mean "
                 "admission wait %.2f ticks, %d continuous admissions",
                 mem["peak_blocks_used"], mem["num_blocks"],
                 100.0 * mem["peak_cache_bytes"]
                 / max(1, mem["dense_slab_bytes"]),
                 mem["reclaimed_by_exit"], mem["reclaimed_at_retire"],
                 stats["admission_wait_mean"] or 0.0,
                 stats["slot_prefills"])
    if args.obs:
        lat = stats["latency"]
        log.info("latency: admission %s ticks, e2e %s s",
                 json.dumps(lat["admission_wait_ticks"]),
                 json.dumps(lat["e2e_seconds"]))
        _obs_wrapup(args, scrape_text=engine.scrape,
                    scrape_json=engine.scrape_json,
                    recorders=[("engine", engine.flight)],
                    dump=engine.dump_flight, flights=engine.flights)
    if stats["requests_finished"] != args.requests:
        raise SystemExit(f"finished {stats['requests_finished']} of "
                         f"{args.requests} requests")
    return stats


def _obs_wrapup(args, *, scrape_text, scrape_json=None, recorders=(),
                extra_events=None, dump=None, flights=None):
    """The --metrics-port / --trace-out / --flight-dump epilogue.

    The metrics server round-trips one scrape through a loopback socket
    (the text must parse back), the trace export validates against the
    Chrome trace-event schema before it is written, and the flight dump
    logs one request's span tree."""
    from repro_torch.obs import (MetricsServer, export_trace,
                                 parse_prometheus, trace_events)
    if args.metrics_port is not None:
        from urllib.request import urlopen
        with MetricsServer(args.metrics_port, scrape_text,
                           scrape_json=scrape_json,
                           flights=flights, flight=dump,
                           trace=(lambda: trace_events(
                               recorders, extra_events=extra_events))
                           if recorders else None) as srv:
            body = urlopen(f"http://127.0.0.1:{srv.port}/metrics",
                           timeout=10).read().decode()
            samples = parse_prometheus(body)
            log.info("metrics: %d samples served on port %d "
                     "(scrape round trip OK)", len(samples), srv.port)
    if args.trace_out:
        recs = [(n, r) for n, r in recorders if r is not None]
        if recs or extra_events:
            doc = export_trace(args.trace_out, recs,
                               extra_events=extra_events)
            log.info("trace: %d events -> %s",
                     len(doc["traceEvents"]), args.trace_out)
        else:
            log.warning("trace: nothing recorded (pass --obs)")
    if args.flight_dump is not None and dump is not None:
        fl = dump(args.flight_dump)
        if fl is None:
            log.warning("flight %d: not recorded (evicted, or recorder "
                        "off)", args.flight_dump)
        else:
            log.info("flight %d: %s", args.flight_dump,
                     json.dumps(fl, indent=2, default=str))


def _serve_fleet(args, cfg, device) -> dict:
    """An N-engine fleet (:mod:`repro_torch.fleet`): one scheduler, one
    merged solve.

    The replicas share ONE set of weights: fleet placement moves requests
    between engines, so migrated streams are only exact when every member
    computes the same function (replicas serving one checkpoint)."""
    from repro_torch.fleet import FleetScheduler, TelemetryAggregator

    n_engines = max(2, args.fleet)
    cfg = cfg.with_fleet(n_engines=n_engines, drain_mode="migrate")
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    members = [CascadeServingEngine(cfg, model, params,
                                    lane_batch=args.lane_batch,
                                    n_lanes=args.lanes,
                                    cache_len=args.cache_len,
                                    runtime=args.runtime, chunk=args.chunk,
                                    device=device)
               for _ in range(n_engines)]
    aggregator = None
    if args.autotune:
        aggregator = TelemetryAggregator(
            cfg, segment_macs_per_token(cfg, args.cache_len),
            # smoke runs are dozens of ticks: resolve early so the merged
            # solve and its fan-out push run
            resolve_every=8 if args.smoke else None,
            min_shadow=4 if args.smoke else None,
            artifact_dir=args.artifacts)
    fleet = FleetScheduler(members, aggregator=aggregator)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        fleet.submit(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size,
                                args.prompt_len).astype(np.int32),
            max_new_tokens=args.max_new))
    if args.drain:
        for _ in range(3):
            fleet.step()
        summary = fleet.drain(0, mode="migrate")
        log.info("drain(0): %s", json.dumps(summary))
    fleet.run()
    stats = fleet.stats()
    log.info("fleet: %d members, %d finished (%d placements, %d "
             "migrations, %d requeues, %d tokens discarded), drained %s",
             stats["n_members"], stats["requests_finished"],
             stats["placements"], stats["migrations"], stats["requeues"],
             stats["discarded_tokens"], stats["drained"])
    for i, ms in enumerate(stats["members"]):
        log.info("member %d: %s", i, json.dumps(ms, default=str))
    if args.autotune:
        log.info("aggregator: thresholds %s, %s",
                 fleet.current_thresholds(),
                 json.dumps(stats["aggregator"], default=str))
    if args.obs:
        log.info("fleet events: %s", json.dumps(stats["events"]))
        _obs_wrapup(args, scrape_text=fleet.scrape,
                    scrape_json=fleet.scrape_json,
                    recorders=fleet._recorders(),
                    extra_events=fleet.events.snapshot(),
                    dump=fleet.dump_flight)
    if stats["requests_finished"] != args.requests:
        raise SystemExit(f"finished {stats['requests_finished']} of "
                         f"{args.requests} requests")
    if stats["discarded_tokens"]:
        raise SystemExit("a same-config migration discarded "
                         f"{stats['discarded_tokens']} committed tokens")
    return stats


def _serve_tier(args, cfg0, device) -> dict:
    """Two-stage cross-model escalation (:mod:`repro_torch.escalate`)."""
    from repro_torch.escalate import ModelCascadeTier, TierThresholdController

    cfg0 = cfg0.with_escalation(enabled=True,
                                threshold=args.escalate_threshold)
    if args.escalate_arch:
        cfg1 = get_config(args.escalate_arch)
        if args.smoke:
            cfg1 = reduced(cfg1)
        cfg1 = cfg1.replace(dtype=cfg0.dtype, use_kernels=True)
        if args.escalate_layers > 0:
            cfg1 = cfg1.replace(n_layers=args.escalate_layers)
        cfg1 = cfg1.with_cascade(exit_mode=args.exit_mode,
                                 n_cohorts=args.cohorts)
        if args.confidence:
            cfg1 = cfg1.with_cascade(confidence=args.confidence)
    else:
        cfg1 = cfg0.replace(n_layers=args.escalate_layers) \
            .with_escalation(enabled=False)
    n1 = cfg1.cascade.n_components
    cfg1 = cfg1.with_cascade(
        thresholds=tuple([args.threshold] * (n1 - 1) + [0.0]))
    if args.autotune:
        # stage 1 carries ordinary telemetry; only stage 0 routes on its
        # final confidence (the escalation axis)
        cfg1 = cfg1.with_autotune(enabled=True, epsilon=args.epsilon,
                                  mac_budget=args.budget_macs,
                                  route_final=False)
    if args.cache_layout == "paged":
        cfg1 = cfg1.with_paged_cache(layout="paged",
                                     block_size=args.block_size,
                                     num_blocks=args.num_blocks)
    if args.obs:
        cfg1 = cfg1.with_obs()
    engines = []
    for s, cfg in enumerate((cfg0, cfg1)):
        model = build_model(cfg, device=device)
        params = model.init(torch.Generator(device=device).manual_seed(s))
        engines.append(CascadeServingEngine(
            cfg, model, params, lane_batch=args.lane_batch,
            n_lanes=args.lanes, cache_len=args.cache_len,
            runtime=args.runtime, chunk=args.chunk, device=device))
    controller = None
    if args.autotune:
        controller = TierThresholdController(
            epsilon=None if args.budget_macs > 0 else args.epsilon,
            mac_budget=args.budget_macs if args.budget_macs > 0 else None,
            # smoke runs are dozens of ticks: solve early so the whole
            # solve-split-push path runs
            interval=8 if args.smoke else 64,
            min_shadow=4.0 if args.smoke else 64.0,
            min_escalations=2 if args.smoke else 8)
    tier = ModelCascadeTier(engines, controller=controller)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        tier.submit(Request(
            rid=i,
            prompt=rng.integers(0, cfg0.vocab_size,
                                args.prompt_len).astype(np.int32),
            max_new_tokens=args.max_new))
    tier.run()
    stats = tier.stats()
    log.info("tier: %d finished, %d escalations, final-stage histogram "
             "%s, %d draft tokens discarded",
             stats["requests_finished"], stats["escalations_total"],
             stats["final_stage_histogram"],
             stats["discarded_draft_tokens"])
    log.info("router: %s", json.dumps(stats["router"]))
    for s, es in enumerate(stats["stages"]):
        esc = es["escalation"]
        log.info("stage %d: speedup %.2fx, %d replayed / %d fresh "
                 "prefill positions, %d escalated admissions, %s us/token",
                 s, es["analytic_speedup"],
                 esc["prefill_positions_replayed"],
                 esc["prefill_positions_fresh"],
                 esc["escalated_requests_admitted"],
                 es["wallclock_us_per_token"])
    if args.autotune:
        log.info("tier controller: %s",
                 json.dumps(stats["controller"], default=str))
    if args.obs:
        from repro_torch.obs import MetricsRegistry, engine_metrics_into

        def _tier_scrape(as_json=False):
            reg = MetricsRegistry()
            for s, e in enumerate(tier.engines):
                engine_metrics_into(reg, e, {"stage": str(s)})
            return reg.render_json() if as_json else reg.render_text()

        _obs_wrapup(args, scrape_text=_tier_scrape,
                    scrape_json=lambda: _tier_scrape(as_json=True),
                    recorders=[(f"stage{s}", e.flight)
                               for s, e in enumerate(tier.engines)
                               if e.flight is not None],
                    dump=tier.dump_flight)
    print(json.dumps({
        "requests_finished": stats["requests_finished"],
        "escalations_total": stats["escalations_total"],
        "final_stage_histogram": stats["final_stage_histogram"],
        "discarded_draft_tokens": stats["discarded_draft_tokens"],
        "router": stats["router"],
        "controller": stats["controller"],
        "stages": [{"arch": e.cfg.name, "n_layers": e.cfg.n_layers,
                    "escalation": es["escalation"],
                    "decode_us_per_token": es["wallclock_us_per_token"],
                    "captures": es["captures"]}
                   for e, es in zip(engines, stats["stages"])],
    }, default=str), flush=True)
    if stats["requests_finished"] != args.requests:
        raise SystemExit(f"finished {stats['requests_finished']} of "
                         f"{args.requests} requests")
    return stats


if __name__ == "__main__":
    main()
