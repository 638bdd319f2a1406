"""Autotune calibration launcher: drive traffic, accumulate exit
telemetry, resolve thresholds, persist the artifact.

    PYTHONPATH=src python -m repro_torch.launch.calibrate --arch qwen2.5-3b \\
        --smoke --device cpu --epsilon 0.05 --requests 8 --max-new 16 \\
        --out artifacts/

The counterpart of the JAX package's ``launch/calibrate.py``, with its
flags, JSON summary and exit codes, plus ``--device`` (CUDA unless
``--device cpu``).  Runs the serving engine with ``cfg.autotune.enabled``
and an attached :class:`repro_torch.autotune.ThresholdController`, forces
a final resolve once traffic drains, writes the config-hash-keyed
calibration artifact and checks that it round-trips (load + key +
thresholds).  ``--budget-macs`` switches the solve from the ε direction to
the average-MAC direction.  Weights are random, drawn from
``torch.Generator(...).manual_seed(0)``; prints the summary as one JSON
line and exits 0, or 1 when too little shadow telemetry accumulated.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from repro_torch.autotune import ThresholdController, load_artifact
from repro_torch.autotune.artifacts import artifact_path
from repro_torch.configs import get_config, reduced
from repro_torch.core.macs import segment_macs_per_token
from repro_torch.models.model import build_model
from repro_torch.serving.engine import CascadeServingEngine, Request
from repro_torch.utils import get_logger, resolve_device

log = get_logger("calibrate")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.calibrate",
        description="Calibrate cascade exit thresholds from live exit "
                    "telemetry (repro_torch.autotune) and persist the "
                    "artifact.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    ap.add_argument("--epsilon", type=float, default=0.05,
                    help="target accuracy degradation ε (solve direction "
                         "when --budget-macs is not given)")
    ap.add_argument("--budget-macs", type=float, default=0.0,
                    help="target average MACs/token; > 0 switches the "
                         "solver to the budget direction")
    ap.add_argument("--out", default="artifacts",
                    help="artifact directory (config-hash-keyed JSON)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--threshold", type=float, default=0.5,
                    help="initial thresholds while telemetry accumulates")
    ap.add_argument("--runtime", default="device",
                    choices=["host", "device"])
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--lanes", type=int, default=2)
    ap.add_argument("--lane-batch", type=int, default=2)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--bins", type=int, default=32,
                    help="confidence histogram resolution")
    ap.add_argument("--shadow-every", type=int, default=4,
                    help="shadow full-depth pass every k-th decode step")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    n = cfg.cascade.n_components
    cfg = cfg.replace(use_kernels=True).with_cascade(
        thresholds=tuple([args.threshold] * (n - 1) + [0.0]),
        exit_mode="cond_batch")
    cfg = cfg.with_autotune(
        enabled=True, bins=args.bins, shadow_every=args.shadow_every,
        epsilon=args.epsilon, mac_budget=args.budget_macs)

    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    controller = ThresholdController(
        cfg, segment_macs_per_token(cfg, args.cache_len),
        artifact_dir=args.out)
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

    # final resolve on everything accumulated (bypasses the periodic tick
    # and the hysteresis guard; still refuses on zero shadow evidence).
    # A push with artifact_dir set persists the artifact itself.
    ths = controller.update(engine, force=True)
    if ths is None:
        log.error("no thresholds resolved — not enough shadow telemetry "
                  "(%d requests produced too few decode steps?)",
                  args.requests)
        return 1
    art = load_artifact(args.out, cfg)
    assert art is not None, "artifact did not round-trip"
    assert tuple(art.thresholds) == tuple(controller.thresholds), \
        (art.thresholds, controller.thresholds)
    path = artifact_path(args.out, art.config_key)

    summary = {
        "artifact": path,
        "config_key": art.config_key,
        "thresholds": list(art.thresholds),
        "direction": art.direction,
        "target": art.target,
        "agreement": art.agreement,
        "avg_macs": art.avg_macs,
        "shadow_steps": art.shadow_steps,
        "requests_finished": engine.stats()["requests_finished"],
    }
    log.info("calibration: %s", json.dumps(summary, indent=2))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
