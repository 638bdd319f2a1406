#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving path, on one GPU.

Serves qwen2.5-3b (or ``--arch``'s model) at full width (bf16, 3
components, kernels on, cond_batch) through ``CascadeServingEngine``
with the settings of ``chip_smoke.py`` (lane_batch 4, 2 lanes, cache_len
512, 8 requests of 128/256 prompt tokens, 16 new tokens each), once to
warm up and once under
``torch.profiler``.  Prints JSON lines: the card, the profiled run's wall
time, the device kernel time summed over the run and its share of the
wall time (the device's busy share; the rest is the host), each device
kernel of the port's attention (``decode_attention``'s split and combine,
``flash_attention``'s wgmma and CUDA-core routes), exit-head megakernel
(``head_tc_kernel``, ``head_partial_kernel``, ``head_combine_kernel``),
``rmsnorm`` (warp and block routes), ``exit_update`` and paged gather with
its device time, calls and share of the device time, the totals of the
megakernel, rmsnorm, exit_update and decode attention over their device
kernels, the wrappers' launch counts in the profiled run (and the routes
of the kernels that count them), and the kernels ranked by device time.

The decode window: the profiled run drives the engine one public
``step()`` at a time, each inside a ``record_function`` range; the steps
that ran no prefill (``stats()["prefills"]`` and ``["slot_prefills"]``
unchanged) are the decode window, and ``decode_busy_share`` is the device
kernel time that starts inside their ranges over their summed wall time,
beside the whole run's ``device_busy_share``.

Run from the root of a checkout: ``python3 scripts/profile_torch_serving.py
[--arch zamba2-1.2b] [--n-layers N] [--thresholds 0.9,0.9,0.0]
[--n-cohorts 2] [--megakernel] [--paged] [--runtime device --chunk 8]
[--top N] [--root DIR]``.  ``--n-layers`` cuts the model's depth (the
published widths kept; llama-3.2-vision-90b fits one 80 GB card at 30
of its 100 layers, as ``chip_smoke.py`` serves it).  ``--n-cohorts 2`` serves with cohort-split skipping in
the ``major`` layout; ``--megakernel`` turns
on the exit-head megakernel and the cohort scatter; ``--paged`` serves
from the paged KV layout (block size 16); ``--runtime device`` decodes
``--chunk`` tokens per lane per dispatch by replaying a captured CUDA
graph.  The warm-up serves the requests once and the profiled run serves
them again on the same engine, its lanes re-prefilled (under the device
runtime into the captured buffers: it profiles replayed chunks);
``--root`` profiles the port of another checkout (e.g. the parent
unpacked by ``git archive``), so two versions are profiled by one script
in turns.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the record_function range around every engine step
WINDOW = "engine_step"


def _device_time_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--thresholds", default="0.9,0.9,0.0")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--n-cohorts", type=int, default=1)
    ap.add_argument("--megakernel", action="store_true")
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--runtime", default="host", choices=["host", "device"])
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import CascadeServingEngine, Request

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    ths = tuple(float(x) for x in args.thresholds.split(","))
    cfg = get_config(args.arch)
    if args.n_layers:
        cfg = cfg.replace(n_layers=args.n_layers)
    cfg = cfg.replace(use_kernels=True).with_cascade(
        exit_mode="cond_batch", thresholds=ths, n_cohorts=args.n_cohorts,
        cohort_layout="major").with_kernel_tune(
        megakernel=args.megakernel, cohort_scatter=args.megakernel)
    if args.paged:
        cfg = cfg.with_paged_cache(layout="paged", block_size=16)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=(128, 256)[i % 2])
               .astype(np.int32) for i in range(8)]

    def engine():
        return CascadeServingEngine(cfg, model, params, lane_batch=4,
                                    n_lanes=2, cache_len=512,
                                    runtime=args.runtime, chunk=args.chunk)

    def prefills(eng):
        st = eng.stats()
        return st["prefills"] + st["slot_prefills"]

    def serve(eng, rid0):
        """Serve the prompts one step at a time; returns (wall seconds,
        stats, per step whether it ran no prefill)."""
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=rid0 + i, prompt=p, max_new_tokens=16))
        torch.cuda.synchronize()
        eng.reset_metrics()
        decode_only = []
        t0 = time.perf_counter()
        for _ in range(10_000):
            if len(eng.finished) == rid0 + len(prompts):
                break
            before = prefills(eng)
            with record_function(WINDOW):
                eng.step()
            decode_only.append(prefills(eng) == before)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, eng.stats(), decode_only

    eng = engine()
    serve(eng, 0)                             # warm-up (device: captures)
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, st, decode_only = serve(eng, len(prompts))
    launches = kernels.launch_counts()
    routes = {name: dict(fn.launches_by_route)
              for name, (_, fn) in kernels._KERNELS.items()
              if hasattr(fn, "launches_by_route")}
    # device events, the step ranges' own device-side copies
    # (a user annotation spanning the range's kernels) left out
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and "CUDA" in str(e.device_type) and e.key != WINDOW]
    dev_us = sum(_device_time_us(e) for e in events)
    # the decode window: device kernels starting inside decode dispatches
    fevents = prof.events()

    def on_device(e):
        return "CUDA" in str(getattr(e, "device_type", ""))

    steps = sorted((e.time_range.start, e.time_range.end)
                   for e in fevents if e.name == WINDOW and not on_device(e))
    if len(steps) != len(decode_only):
        print(f"profile_torch_serving: {len(steps)} step ranges for "
              f"{len(decode_only)} steps", file=sys.stderr)
        return 1
    windows = [w for w, pure in zip(steps, decode_only) if pure]
    kern = [e for e in fevents if on_device(e) and e.name != WINDOW]
    window_us = sum(b - a for a, b in windows)
    busy_us = sum(e.time_range.end - e.time_range.start for e in kern
                  if any(a <= e.time_range.start < b for a, b in windows))
    ranked = sorted(events, key=_device_time_us, reverse=True)
    # each device kernel of the port (its launches and time), and the two
    # kernels with two routes summed over their device kernels
    families = {}
    groups = {"megakernel": "head_", "rmsnorm": "rmsnorm",
              "exit_update": "exit_update", "decode_attention":
              "decode_attention", "paged_gather": "paged_gather"}
    totals = {g: {"calls": 0, "device_s": 0.0} for g in groups}
    for e in events:
        if any(f in e.key for f in ("attention", "paged_gather", "head_",
                                    "rmsnorm", "exit_update")):
            rec = families.setdefault(e.key[:90], {"calls": 0,
                                                   "device_s": 0.0})
            rec["calls"] += e.count
            rec["device_s"] += _device_time_us(e) / 1e6
            group = next((g for g, f in groups.items() if f in e.key), None)
            if group:
                totals[group]["calls"] += e.count
                totals[group]["device_s"] += _device_time_us(e) / 1e6
    for rec in (*families.values(), *totals.values()):
        rec["share_of_device"] = rec["device_s"] / (dev_us / 1e6) \
            if dev_us else None
    print(json.dumps({"card": smi, "root": str(Path(args.root).resolve()),
                      "arch": args.arch, "n_layers": cfg.n_layers,
                      "thresholds": list(ths),
                      "n_cohorts": args.n_cohorts,
                      "megakernel": args.megakernel,
                      "paged": args.paged, "runtime": args.runtime,
                      "chunk": st["chunk"], "captures": st["captures"],
                      "cohort_dispatch": st["cohort_dispatch"],
                      "wall_s": wall, "device_kernel_s": dev_us / 1e6,
                      "device_busy_share": dev_us / 1e6 / wall,
                      "decode_steps": len(windows),
                      "decode_dispatches": st["decode_dispatches"],
                      "decode_window_s": window_us / 1e6,
                      "decode_device_s": busy_us / 1e6,
                      "decode_busy_share": (busy_us / window_us
                                            if window_us else None),
                      "decode_us_per_token": st["wallclock_us_per_token"],
                      "prefill_seconds": st["prefill_seconds"],
                      "host_syncs_per_token": st["host_syncs_per_token"],
                      "segments_run": st["segments_run"]}), flush=True)
    print(json.dumps({"kernels_of_the_port": families,
                      "by_kernel": totals, "launches": launches,
                      "routes": routes}), flush=True)
    print(json.dumps({"top_kernels": [
        {"name": e.key, "calls": e.count,
         "device_ms": _device_time_us(e) / 1e3}
        for e in ranked[:args.top]]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
