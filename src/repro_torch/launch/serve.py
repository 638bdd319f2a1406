"""Serving launcher: cascade early-exit decode through the port's serving
engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --smoke --requests 8 --max-new 8 --threshold 0.5 \\
        --cache-layout paged --cohorts 2 --exit-mode cond_batch

The single-engine path of the JAX package's ``launch/serve.py``, with its
flags.  Runs on CUDA unless ``--device cpu``.  The hot ops always take the
port's hand-written kernels (``cfg.use_kernels``; on the CPU their wrappers
take the plain versions).  ``--runtime device --chunk K`` decodes K tokens
per lane per dispatch (on CUDA from a captured CUDA graph).  ``--autotune``
turns on the exit telemetry and a
:class:`~repro_torch.autotune.ThresholdController` that re-solves the
thresholds from live traffic (``--epsilon`` or ``--budget-macs``) and
pushes them into the running engine, warm-starting from and persisting to
``--artifacts``.  Weights are random, drawn from
``torch.Generator(...).manual_seed(0)``.  The flags of later slices
(escalation tiers, fleets, observability) are accepted and refused with an
error naming the slice.
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
                         "patience@k[:base])")
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
    # flags of later slices: parsed, then refused by name
    ap.add_argument("--escalate-layers", type=int, default=0)
    ap.add_argument("--escalate-arch", default=None)
    ap.add_argument("--escalate-threshold", type=float, default=0.5)
    ap.add_argument("--fleet", type=int, default=1)
    ap.add_argument("--drain", action="store_true")
    ap.add_argument("--obs", action="store_true")
    ap.add_argument("--metrics-port", type=int, default=None)
    ap.add_argument("--flight-dump", type=int, default=None, metavar="RID")
    ap.add_argument("--trace-out", default=None, metavar="PATH")
    return ap


def _refuse_later_slices(args) -> None:
    later = []
    if args.escalate_layers > 0 or args.escalate_arch:
        later.append("--escalate-* (the cross-model escalation slice)")
    if args.fleet > 1 or args.drain:
        later.append("--fleet/--drain (the fleet slice)")
    if (args.obs or args.metrics_port is not None
            or args.flight_dump is not None or args.trace_out):
        later.append("--obs/--metrics-port/--flight-dump/--trace-out (the "
                     "observability slice)")
    if later:
        raise SystemExit("not ported yet (later slices of the port): "
                         + "; ".join(later))


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    _refuse_later_slices(args)
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
    if args.autotune:
        cfg = cfg.with_autotune(enabled=True, epsilon=args.epsilon,
                                mac_budget=args.budget_macs)
    if args.cache_layout == "paged":
        cfg = cfg.with_paged_cache(layout="paged",
                                   block_size=args.block_size,
                                   num_blocks=args.num_blocks)
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
    if stats["requests_finished"] != args.requests:
        raise SystemExit(f"finished {stats['requests_finished']} of "
                         f"{args.requests} requests")
    return stats


if __name__ == "__main__":
    main()
