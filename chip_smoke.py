#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card and builds the port's kernels itself (``nvcc``, one process per
source, all at once).  Phases, each of which fails the run on a miss:

1. card line: ``nvidia-smi`` name and power limit, torch/CUDA versions,
   kernel build time;
2. every kernel against its plain PyTorch version on the card at the
   serving path's shapes (bf16 and f32), ints exact and floats within the
   stated tolerances, with CUDA-event timings of the kernel, the plain
   version and one library call, and each kernel's bound; the routes of
   the kernels that have two, each checked to be taken: flash attention
   (wgmma for causal bf16 / fp16 at hd = 128 over views TMA can address,
   CUDA cores for f32 and unaligned views), the exit-head megakernel (tc
   at B = 1, 2, 4, 8, 16 in bf16 and for a vocab 8 columns short of a
   whole tile, after a one-hot layout diagnostic; CUDA cores for f32 and
   a vocab not a multiple of 8), rmsnorm (warp at the model width in bf16
   and f32, block for a width that is not a whole number of 16-byte
   chunks and for 32 chunks a lane);
   decode attention's split-KV at its edges (a short last chunk, chunks
   with no visible key, a slot that sees no key, every slot dead), its
   bits repeated from run to run, and so the megakernel's; decode
   attention's paged route (a layer slice of a stacked store read through
   a block table with trash, duplicate and all-trash rows) bit for bit
   against the dense route over ``paged_gather_kv``'s views; exit_update's
   vocab split at B = 1, 4, 8, 16 with ties across and straddling CTA
   tiles; the confidence kernel's cluster split at B = 1 .. 64 in bf16,
   in f32 and fp16, at (70000, 10) f32 and at vocabularies that make the
   plan pick each cluster size, with ties across and straddling the CTA
   ranges, its C++ column ranges against the Python mirror, one device
   launch a call (``torch.profiler``) and a CUDA graph's replays bit for
   bit like the eager call; decode attention reading its position from
   device memory, both routes replayed in a CUDA graph at positions the
   capture never saw; exit_update and the megakernel reading δ̂ from
   device memory, the same bits for δ̂ as a vector element and as a float
   at 0, 0.3, 1.1 and a threshold equal to a row's confidence, and
   replayed in a CUDA graph with δ̂ rewritten between replays; the
   cohort scatter at the ring-slot rows select mode lands and at a whole
   segment slab;
3. slice 1 at full width: qwen2.5-3b (36 layers, bf16, 3 components,
   kernels on, cond_batch, one cohort) through ``CascadeServingEngine`` —
   8 requests at thresholds (0.9, 0.9, 0.0) and again at (0, 0, 0);
4. slice 2 at full width: the same model with 2 cohorts in the major
   layout and the exit-head megakernel and cohort scatter on, at (0, 0, 0),
   (0.9, 0.9, 0.0) and a component-0 threshold at the median of the
   (0, 0, 0) run's confidences (cohorts disagree: the mixed dispatch
   branch runs), megakernel on and off in turns (on, off, off, on);
5. Algorithm 1 (``cascade_infer_sequential``) on the full-width model's
   exit logits for 4 prompts of 128 tokens, confidence kernel vs plain
   measure, with each call's wall time and its 3 confidence
   computations' device time;
6. slice 3 at full width: the paged KV layout (2 cohorts, major,
   cond_batch, block size 16) — the 8 requests at (0.9, 0.9, 0.0) and
   (0, 0, 0), paged and dense in turns with identical streams, then an
   equal-memory burst of 24 requests (paged: 8 slots per lane in the
   4-slot dense block count, with continuous single-slot admission and
   skip-aware reclamation; dense: 4 slots); every paged decode attention
   takes the paged route, so no paged_gather launches;
7. slice 8 at full width: the device runtime (chunk 8: a captured CUDA
   graph replayed 8 times a lane a dispatch, the cond_batch skips as
   conditional nodes, one host sync a chunk) against the host runtime in
   turns (host, device, device, host) — dense with one cohort and paged
   (block size 16, 2 cohorts) at (0.9, 0.9, 0.0) and (0, 0, 0), dense
   with 2 cohorts and the megakernel at those and at phase 4's mixed
   vector; identical streams, carried segments_run, launches and routes,
   one host sync per lane chunk, one capture per lane, no sync during a
   replay (sync debug mode "error");
8. route parity at 4 layers in f32: kernel route vs plain route (dense,
   paged at block size 16, and paged at block size 64, which the paged
   decode route does not take: there paged_gather gathers the views),
   megakernel on vs off, 1 vs 2 cohorts, major vs copy layout, select mode
   with the cohort scatter vs cond_batch, each on the dense and the paged
   layout — identical token and exit streams; and the device runtime
   against the host runtime in select and cond_batch, dense and paged;
9. slice 9 at full width: autotune (exit telemetry with a shadow step
   every 4 positions, live thresholds the exit kernels read from device
   memory) — the device runtime with autotune off and on in turns (off,
   on, on, off) at (0.9, 0.9, 0.0) and (0, 0, 0), one cohort and two with
   the megakernel, identical streams; the host runtime with autotune on,
   every telemetry counter, segments_run and launch count equal to the
   device runtime's; a threshold push that captures nothing and serves
   what a fresh engine at the pushed vector serves; and the calibrate CLI
   (``python -m repro_torch.launch.calibrate ... --runtime device``) in a
   subprocess, which must exit 0 with an artifact that round-trips;
10. the serve CLI (``python -m repro_torch.launch.serve ... --cache-layout
   paged``) in a subprocess, which must exit 0;
11. the ``{"kernels": [...]}`` line, then the final ``{"ok": true, ...}``
    line.

Every path is driven with the launch counters set to 0 just before it and
read just after, and fails unless exactly its expected kernels launched;
every prefill of a bf16 model must take flash attention's wgmma route and
every exit head the megakernel's tc route, of an f32 one their CUDA-core
routes, every norm rmsnorm's warp route, and every decode attention the
paged route on paged stores of block size 16, else the dense one.

Every line of standard output but the ``nvidia-smi`` line is one JSON
object.  Without a CUDA device, or outside a checkout, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEV = "cuda"

# H100 SXM data-sheet peaks (dense): HBM bandwidth, bf16 and fp16
# tensor-core rate, f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}

# the serving shapes of qwen2.5-3b: model width, vocabulary, and one deep
# segment's cache leaf (layers, lane batch, cache_len, KV heads, head dim)
D_MODEL = 2048
VOCAB = 151936
SEG_CACHE = (12, 4, 512, 2, 128)
# the ring slot of phase 2's slot-route cohort scatter (select mode lands
# a cohort's rows of the one slot a decode step writes)
SCATTER_SLOT = 137
# the paged layout's shared store at full width (the auto-sized pool:
# 2 lanes x 4 slots x 3 components x 32 ring blocks + the trash block) and
# one lane's block table (4 slots x 32 ring blocks of 16 positions)
PAGED_STORE = (769, 16, 2, 128)
PAGED_TABLE = (4, 32)
# the route-parity run's paged store at block size 64, where paged_gather
# serves decode (2 lanes x 4 slots x 3 components x 8 ring blocks + the
# trash block), and one lane's block table (4 slots x 8 ring blocks)
GATHER_STORE = (193, 64, 2, 128)
GATHER_TABLE = (4, 8)

# where each TPU kernel's pallas_call sits in the reference package
REPLACES = {
    "rmsnorm": "src/repro/kernels/rmsnorm.py:42",
    "exit_update": "src/repro/kernels/exit_update.py:206",
    "decode_attention": "src/repro/kernels/decode_attention.py:120",
    "flash_attention": "src/repro/kernels/flash_attention.py:102",
    "confidence": "src/repro/kernels/confidence.py:72",
    "megakernel": "src/repro/kernels/megakernel.py:231",
    "cohort_scatter": "src/repro/kernels/cohort_cache.py:53",
    "paged_gather": "src/repro/kernels/paged_gather.py:61",
}
SOURCES = {name: f"src/repro_torch/kernels/csrc/{name}.cu"
           for name in REPLACES}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    """Device time of one call of ``fn``: the median over ``iters``
    back-to-back calls of the CUDA-event interval around each, after
    warm-up.  A spin kernel queued first keeps the device busy while the
    host enqueues every call, so the intervals measure the device's work
    and not the host's launch overhead (which the serving run reports as
    its own, end to end)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    torch.cuda._sleep(100_000_000)     # ~50 ms of spinning at ~2 GHz
    events[0].record()
    for i in range(iters):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b)
                             for a, b in zip(events, events[1:]))


def bound_ms(bytes_moved: float, flops: float, dtype: str):
    """Least time for the work: max(bytes / HBM rate, flops / peak)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max().item())


def check_close(name, got, want, atol, rtol):
    import torch
    if not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
        fail(f"{name}: kernel and plain version differ by "
             f"{max_err(got, want):.3e} (atol {atol}, rtol {rtol})")


def check_equal(name, got, want):
    import torch
    if not torch.equal(got.cpu(), want.cpu()):
        fail(f"{name}: kernel and plain version disagree on integers")


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

# tolerances: f32 paths differ only in summation order and rsqrt/exp
# rounding (~1e-6 relative); bf16 outputs round to 8 mantissa bits, so one
# bf16 ulp (2**-8 relative) can flip between two f32 results that agree
TOL = {"float32": (2e-5, 1e-4), "bfloat16": (2e-2, 1e-2)}
# fp16 keeps 3 more mantissa bits than bf16: the bf16 bound covers it
TOL["float16"] = TOL["bfloat16"]


def route_of(fn, counted):
    """Run ``fn`` (one launch of the wrapper ``counted``) and return (its
    result, the route it took)."""
    before = dict(counted.launches_by_route)
    out = fn()
    taken = [r for r, n in counted.launches_by_route.items()
             if n != before[r]]
    if len(taken) != 1:
        fail(f"{counted.__name__}: one launch moved the route counters "
             f"{taken}")
    return out, taken[0]


def phase_rmsnorm(dev, gen):
    """Both routes: the model width in bf16 and f32 (the warp route, timed
    at the serving path's decode and prefill rows), a width that is not a
    whole number of 16-byte chunks and an f32 row of 32 chunks a lane (the
    block route)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm
    cases = []
    shapes = [(R, D_MODEL, dt, "warp") for R in (4 * 256, 4)
              for dt in (torch.bfloat16, torch.float32)]
    shapes += [(4, D_MODEL + 4, torch.bfloat16, "block"),
               (4 * 256, 2 * D_MODEL, torch.float32, "block")]
    for R, d, dt, want_route in shapes:
        for wdt in (torch.float32, dt):
            x = torch.randn(R, d, generator=gen, device=dev).to(dt)
            w = (1 + 0.1 * torch.randn(d, generator=gen,
                                       device=dev)).to(wdt)
            got, route = route_of(lambda: rmsnorm(x, w, 1e-5), rmsnorm)
            want = ref.ref_rmsnorm(x, w, 1e-5)
            torch.cuda.synchronize()
            name = str(dt).split(".")[-1]
            tag = f"rmsnorm {R}x{d} {name} w={wdt}"
            check_close(tag, got, want, *TOL[name])
            if route != want_route:
                fail(f"{tag}: took the {route} route, expected {want_route}")
            if wdt != torch.float32:
                continue
            nbytes = 2 * x.numel() * x.element_size() + \
                w.numel() * w.element_size()
            b, by = bound_ms(nbytes, 4 * x.numel(), name)
            cases.append({
                "shape": [R, d], "dtype": name, "route": route,
                "max_abs_err": max_err(got, want),
                "ms": time_ms(lambda: rmsnorm(x, w, 1e-5)),
                "plain_ms": time_ms(lambda: ref.ref_rmsnorm(x, w, 1e-5)),
                "library_ms": time_ms(lambda: F.rms_norm(
                    x, (d,), w.to(x.dtype), 1e-5)),
                "bound_ms": b, "bound_by": by})
    return cases


def phase_flash(dev, gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    B, H, KV, hd = 4, 16, 2, 128
    # bf16 / fp16 views TMA can address take the wgmma route, f32 and
    # unaligned views the CUDA-core one
    want_route = {"bfloat16": "wgmma", "float16": "wgmma",
                  "float32": "cuda_core"}
    cases = []
    for S in (128, 256):
        for window in (0, 64):
            for dt in (torch.bfloat16, torch.float32, torch.float16):
                name = str(dt).split(".")[-1]
                q = torch.randn(B, H, S, hd, generator=gen, device=dev).to(dt)
                k = torch.randn(B, KV, S, hd, generator=gen,
                                device=dev).to(dt)
                v = torch.randn(B, KV, S, hd, generator=gen,
                                device=dev).to(dt)
                got, route = route_of(lambda: flash_attention(
                    q, k, v, causal=True, window=window), flash_attention)
                want = ref.ref_flash_attention(q, k, v, causal=True,
                                               window=window)
                torch.cuda.synchronize()
                check_close(f"flash S={S} window={window} {name}", got, want,
                            *TOL[name])
                if route != want_route[name]:
                    fail(f"flash S={S} window={window} {name}: took the "
                         f"{route} route, expected {want_route[name]}")
                if dt == torch.float16:     # checked, not timed
                    continue
                pos = torch.arange(S, device=dev)
                vis = pos[None, :] <= pos[:, None]
                if window:
                    vis &= pos[None, :] > pos[:, None] - window
                pairs = B * H * int(vis.sum().item())
                nbytes = (2 * q.numel() + k.numel() + v.numel()) * \
                    q.element_size()
                b, by = bound_ms(nbytes, 4 * hd * pairs, name)
                lib = None
                if window == 0:
                    lib = time_ms(lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True))
                cases.append({
                    "shape": [B, H, KV, S, hd], "window": window,
                    "dtype": name, "route": route,
                    "max_abs_err": max_err(got, want),
                    "ms": time_ms(lambda: flash_attention(
                        q, k, v, causal=True, window=window)),
                    "plain_ms": time_ms(lambda: ref.ref_flash_attention(
                        q, k, v, causal=True, window=window)),
                    "library_ms": lib, "bound_ms": b, "bound_by": by})
    # unaligned views (one element off 16 bytes) take the CUDA-core route
    # and its element-wise tile loads
    q, k, v = (torch.randn(B, 128, n, hd + 1, generator=gen,
                           device=dev).bfloat16()[..., 1:].transpose(1, 2)
               for n in (H, KV, KV))
    got, route = route_of(lambda: flash_attention(q, k, v),
                          flash_attention)
    check_close("flash unaligned q/k/v", got,
                ref.ref_flash_attention(q, k, v), *TOL["bfloat16"])
    if route != "cuda_core":
        fail(f"flash unaligned q/k/v: took the {route} route")
    return cases


def decode_ring(t, W):
    """The dense ring's kpos after position t: slot s holds the newest
    position congruent to s mod W, -1 while empty."""
    import numpy as np
    s = np.arange(W)
    return np.where(s <= t, t - ((t - s) % W), -1).astype(np.int32)


def phase_decode(dev, gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      split_plan)
    B, H, KV, hd = 4, 16, 2, 128
    cases = []
    # (t, W, window, live, kpos form): the serving shape all live; a
    # window over the wrap with dead slots; per-slot rings; W = 500 (the
    # last 32-key chunk holds 20 keys); a partly filled ring (t = 100:
    # 12 of 16 chunks hold no visible key) with one live slot whose ring is
    # empty (no visible key at all); every slot dead
    for t, W, window, live_l, form in (
            (700, 512, 0, [1, 1, 1, 1], "lane"),
            (700, 512, 64, [1, 0, 1, 0], "lane"),
            (300, 512, 0, [0, 1, 1, 1], "per-slot"),
            (700, 500, 0, [1, 1, 1, 1], "lane"),
            (100, 512, 0, [1, 1, 1, 1], "per-slot, slot 3 empty"),
            (700, 512, 0, [0, 0, 0, 0], "lane")):
        kpos = torch.as_tensor(decode_ring(t, W), device=dev)
        # the position as the serving path hands it over: one int32 in
        # device memory
        t_dev = torch.full((), t, dtype=torch.int32, device=dev)
        if form != "lane":   # (B, W) rows, each slot's own ring
            kpos = torch.stack([kpos - 2 * b if b else kpos
                                for b in range(B)]).clamp(min=-1)
            if "empty" in form:
                kpos[3] = -1
        live = torch.as_tensor(live_l, dtype=torch.bool, device=dev)
        for dt in (torch.bfloat16, torch.float32):
            q = torch.randn(B, H, hd, generator=gen, device=dev).to(dt)
            kc = torch.randn(B, W, KV, hd, generator=gen, device=dev).to(dt)
            vc = torch.randn(B, W, KV, hd, generator=gen, device=dev).to(dt)
            got, route = route_of(lambda: decode_attention(
                q, kc, vc, t_dev, kpos, live, window=window), decode_attention)
            if route != "dense":
                fail(f"decode t={t} W={W}: took the {route} route")
            want = ref.ref_decode_attention(q, kc, vc, t, kpos,
                                            window=window, live=live)
            torch.cuda.synchronize()
            name = str(dt).split(".")[-1]
            check_close(f"decode t={t} W={W} window={window} {form} "
                        f"live={live_l} {name}", got, want, *TOL[name])
            if not torch.equal(got[~live].float().abs().sum().cpu(),
                               torch.zeros(())):
                fail("decode: dead slots' rows are not zero")
            again = decode_attention(q, kc, vc, t_dev, kpos, live,
                                     window=window)
            if not torch.equal(got, again):
                fail(f"decode t={t} W={W} {name}: two runs differ")
            kp = kpos if kpos.dim() == 2 else kpos[None].expand(B, W)
            vis = (kp >= 0) & (kp <= t)
            if window:
                vis &= kp > t - window
            n_vis = int(vis[live].sum().item())
            esz = q.element_size()
            nbytes = (2 * n_vis * KV * hd + 2 * q.numel()) * esz + \
                kpos.numel() * 4
            b, by = bound_ms(nbytes, 4 * (H // KV) * hd * KV * n_vis, name)
            mask = vis[:, None, None, :]
            qs, ks, vs = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
            cases.append({
                "shape": [B, H, KV, W, hd], "t": t, "window": window,
                "live": live_l, "kpos": form, "dtype": name, "route": route,
                "split": list(split_plan(W)),
                "max_abs_err": max_err(got, want),
                "ms": time_ms(lambda: decode_attention(
                    q, kc, vc, t_dev, kpos, live, window=window)),
                "plain_ms": time_ms(lambda: ref.ref_decode_attention(
                    q, kc, vc, t, kpos, window=window, live=live)),
                "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask, enable_gqa=True)),
                "bound_ms": b, "bound_by": by})
    # caches that are views one element off 16-byte alignment take the
    # kernel's element-wise tile loads instead of its 16-byte cp.async
    W = 512
    q = torch.randn(B, H, hd, generator=gen, device=dev).bfloat16()
    kc, vc = (torch.randn(B, W, KV, hd + 1, generator=gen,
                          device=dev).bfloat16()[..., 1:] for _ in range(2))
    kpos = torch.arange(W, device=dev, dtype=torch.int32)
    check_close("decode unaligned caches",
                decode_attention(q, kc, vc, W - 1, kpos),
                ref.ref_decode_attention(q, kc, vc, W - 1, kpos),
                *TOL["bfloat16"])
    decode_position_replays(dev, gen)
    return cases + decode_paged_cases(dev, gen)


def decode_position_replays(dev, gen):
    """The kernel reads t from device memory, in both routes: one call of
    each route captured in a CUDA graph, then replayed at positions the
    capture never saw (the device scalar rewritten between replays), each
    replay bit for bit like the eager call at that position."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.paged_gather import paged_gather_kv
    B, H, KV, hd, W = 4, 16, 2, 128, 512
    NB, bs = PAGED_STORE[0], PAGED_STORE[1]
    q = torch.randn(B, H, hd, generator=gen, device=dev).bfloat16()
    kc, vc = (torch.randn(B, W, KV, hd, generator=gen, device=dev)
              .bfloat16() for _ in range(2))
    ks, vs = (torch.randn(PAGED_STORE, generator=gen, device=dev).bfloat16()
              for _ in range(2))
    table = torch.randint(1, NB, PAGED_TABLE, generator=gen, device=dev,
                          dtype=torch.int32)
    kpos = torch.as_tensor(decode_ring(W + 100, W), device=dev)
    t_dev = torch.full((), 300, dtype=torch.int32, device=dev)
    calls = {"dense": lambda: decode_attention(q, kc, vc, t_dev, kpos),
             "paged": lambda: decode_attention(q, ks, vs, t_dev,
                                               kpos[None].expand(B, W),
                                               table=table)}
    for route, call in calls.items():
        call()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = call()
        for t in (300, 450, W + 7, W + 100):
            t_dev.fill_(t)
            g.replay()
            want = call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                fail(f"decode {route}: a replay at t={t} differs from the "
                     f"eager call by {max_err(out, want):.3e}")
        del g
    kv = paged_gather_kv(ks, vs, table)
    t_dev.fill_(450)
    if not torch.equal(calls["paged"](), decode_attention(
            q, *kv, t_dev, kpos[None].expand(B, W))):
        fail("decode: paged route at a device t differs from the dense "
             "route over the gathered views")


def decode_paged_cases(dev, gen):
    """The paged route: a layer slice of stacked (2, NB, 16, KV, hd) stores
    read through a (4, 32) block table with trash-block ranges, duplicate
    ids and an all-trash row, against the dense route over
    ``paged_gather_kv``'s views — bit for bit — at t >= W and t < W, with
    a window and a dead slot, and with a live slot whose ring is empty (no
    visible key: the mean of V over all W rows, trash included).  Times
    the paged route, the dense route alone and the gather + dense pair it
    replaces."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      split_plan)
    from repro_torch.kernels.paged_gather import paged_gather_kv
    NB, bs, KV, hd = PAGED_STORE
    B, nblk = PAGED_TABLE
    H, W = 16, nblk * bs
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        ks = torch.randn((2,) + PAGED_STORE, generator=gen, device=dev).to(dt)
        vs = torch.randn((2,) + PAGED_STORE, generator=gen, device=dev).to(dt)
        k, v = ks[1], vs[1]
        table = torch.randint(1, NB, PAGED_TABLE, generator=gen, device=dev,
                              dtype=torch.int32)
        table[1, 20:] = 0                  # uncovered ring ranges: trash
        table[3] = 0                       # an all-trash row
        table[2, :4] = table[0, 7]         # duplicate ids
        kv_views = paged_gather_kv(k, v, table)
        for t, window, live_l, empty in ((700, 0, [1, 1, 1, 1], False),
                                         (300, 0, [1, 1, 1, 1], False),
                                         (700, 64, [1, 1, 1, 0], False),
                                         (100, 0, [1, 1, 1, 1], True)):
            kpos = torch.as_tensor(decode_ring(t, W), device=dev)
            kpos = torch.stack([kpos - 2 * b for b in range(B)]).clamp(min=-1)
            if empty:
                kpos[3] = -1
            live = torch.as_tensor(live_l, dtype=torch.bool, device=dev)
            q = torch.randn(B, H, hd, generator=gen, device=dev).to(dt)
            t_dev = torch.full((), t, dtype=torch.int32, device=dev)
            got, route = route_of(lambda: decode_attention(
                q, k, v, t_dev, kpos, live, window=window, table=table),
                decode_attention)
            dense = decode_attention(q, *kv_views, t_dev, kpos, live,
                                     window=window)
            want = ref.ref_decode_attention(q, *kv_views, t, kpos,
                                            window=window, live=live)
            torch.cuda.synchronize()
            tag = (f"decode paged t={t} window={window} live={live_l} "
                   f"empty={empty} {name}")
            if route != "paged":
                fail(f"{tag}: took the {route} route")
            if not torch.equal(got, dense):
                fail(f"{tag}: the paged route differs from the dense route "
                     f"over the gathered views by {max_err(got, dense):.3e}")
            check_close(tag, got, want, *TOL[name])
            again = decode_attention(q, k, v, t_dev, kpos, live,
                                     window=window, table=table)
            if not torch.equal(got, again):
                fail(f"{tag}: two runs differ")
            if t != 700 or window or empty:
                continue
            vis = (kpos >= 0) & (kpos <= t)
            n_vis = int(vis[live].sum().item())
            esz = q.element_size()
            nbytes = (2 * n_vis * KV * hd + 2 * q.numel()) * esz + \
                kpos.numel() * 4 + table.numel() * 4
            b, by = bound_ms(nbytes, 4 * (H // KV) * hd * KV * n_vis, name)
            qs = q[:, :, None]
            kt, vt = (x.transpose(1, 2) for x in kv_views)
            cases.append({
                "shape": [B, H, KV, W, hd], "t": t, "window": window,
                "live": live_l, "kpos": "per-slot", "dtype": name,
                "route": route, "store": list(PAGED_STORE),
                "table": list(PAGED_TABLE), "split": list(split_plan(W)),
                "max_abs_err": max_err(got, want),
                "ms": time_ms(lambda: decode_attention(
                    q, k, v, t_dev, kpos, live, table=table)),
                "dense_ms": time_ms(lambda: decode_attention(
                    q, *kv_views, t_dev, kpos, live)),
                "gather_and_dense_ms": time_ms(lambda: decode_attention(
                    q, *paged_gather_kv(k, v, table), t_dev, kpos, live)),
                "plain_ms": time_ms(lambda: ref.ref_decode_attention(
                    q, ref.ref_paged_gather(k, table),
                    ref.ref_paged_gather(v, table), t, kpos, live=live)),
                "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    qs, kt, vt, attn_mask=vis[:, None, None, :],
                    enable_gqa=True)),
                "bound_ms": b, "bound_by": by})
        del ks, vs, kv_views
    return cases


def _exit_logits(B, V, dt, dev, gen):
    """(B, V) logits with rows by role (b % 4): noise; a confident row
    (column 77); a tie across CTA tiles (columns 5 and V - 100); a tie
    straddling the first tile boundary (columns 4095 and 4096)."""
    import torch
    x = torch.randn(B, V, generator=gen, device=dev)
    for b in range(B):
        role = b % 4
        if role == 1:
            x[b, 77] += 20.0
        elif role == 2:
            x[b, 5] = x[b, V - 100] = x[b].max() + 15.0
        elif role == 3:
            x[b, 4095] = x[b, 4096] = x[b].max() + 15.0
    return x.to(dt)


THRESHOLD_TIE = "tie"


def threshold_forms(tag, kernel, plain, check, carry, n_m):
    """Rows 3 and 4 read δ̂ from device memory (the ``dynamic`` route of
    the reference): ``kernel(*carry, threshold=, m=, n_components=)``
    given δ̂ as element m of an (n_m,) f32 vector on the card must give,
    bit for bit, what it gives for δ̂ as a float (filled into a 0-d
    tensor by the wrapper), at δ̂ = 0, 0.3, 1.1 and a tie (δ̂ equal to a
    row's confidence as the kernel computes it: ``conf >= δ̂`` opens that
    row's gate), and agree with the plain version given the same tensor
    (``check``).  Then one call on a 0-d δ̂ tensor captured in a CUDA graph
    and replayed with the tensor rewritten between replays: each replay
    bit for bit the eager call at that δ̂.  Returns the tie value and the
    replayed δ̂s."""
    import torch
    m = 0
    fresh = (torch.zeros_like(carry[0]),) + tuple(carry[1:])
    raw = kernel(*fresh, threshold=0.0, m=m, n_components=n_m)[3]
    tie = float(raw[1])
    vec = torch.zeros(n_m, device=carry[0].device)
    values = [0.0, 0.3, tie, 1.1]
    for value in values:
        vec[m] = value
        kw = dict(m=m, n_components=n_m)
        got = kernel(*carry, threshold=vec, **kw)
        flt = kernel(*carry, threshold=value, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, flt)):
            fail(f"{tag} δ̂={value}: the vector and float forms differ")
        if value != tie:
            check(f"{tag} δ̂={value} device", got, plain(*carry,
                                                         threshold=vec, **kw))
    vec[m] = tie
    opened = kernel(*fresh, threshold=vec, m=m, n_components=n_m)
    if not bool(opened[0][1]) or int(opened[2][1]) != m:
        fail(f"{tag}: δ̂ equal to row 1's confidence must open its gate")
    thr = torch.zeros((), device=carry[0].device)
    kernel(*carry, threshold=thr, m=m, n_components=n_m)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = kernel(*carry, threshold=thr, m=m, n_components=n_m)
    replayed = [1.1, 0.0, tie, 0.3]
    for value in replayed:
        thr.fill_(value)
        g.replay()
        want = kernel(*carry, threshold=value, m=m, n_components=n_m)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out, want)):
            fail(f"{tag}: a replay at δ̂={value} differs from the eager "
                 f"call")
    del g
    return {"values": values, "tie": tie, "replayed": replayed,
            "vector_bit_equal_float": True, "replays_bit_equal": True}


def phase_exit_update(dev, gen):
    """The vocab split over the SMs at B = 1, 4, 8, 16 in bf16 and f32:
    ints equal the plain version's (every carry case at B = 4: m, patience,
    EMA, telemetry), confidences within 1e-5 relative; ties across and
    straddling CTA tiles resolve to the first index; two calls give the
    same bits.  Times the kernel, the plain version and the library
    call."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.exit_update import exit_update
    V, n_m = VOCAB, 3
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        for B in (4, 1, 8, 16):
            x = _exit_logits(B, V, dt, dev, gen)
            carry = _carries(B, n_m, dev)
            errs = []
            sweep = [dict(m=m, patience_k=pk, ema_decay=decay, tel_bins=bins)
                     for m in (0, n_m - 1) for pk in (0, 2)
                     for decay in (0.0, 0.8) for bins in (0, 32)]
            if B != 4:
                sweep = sweep[-1:] + sweep[5:6]
            for case in sweep:
                kw = dict(threshold=0.3, n_components=n_m, **case)
                got = exit_update(x, *carry, **kw)
                want = ref.ref_exit_update(x, *carry, **kw)
                torch.cuda.synchronize()
                tag = f"exit_update B={B} {name} {kw}"
                for idx in (0, 1, 2, 4) + ((6,) if kw["tel_bins"] else ()):
                    check_equal(tag, got[idx], want[idx])
                for idx in (3, 5):
                    check_close(tag, got[idx], want[idx], 0.0, 1e-5)
                    errs.append(max_err(got[idx], want[idx]))
                again = exit_update(x, *carry, **kw)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    fail(f"{tag}: a second call gave other bits")
            # nothing answered yet: every row's prediction is its argmax
            kw = dict(threshold=0.3, m=0, n_components=n_m)
            fresh = exit_update(x, torch.zeros_like(carry[0]), *carry[1:],
                                **kw)
            pred = fresh[1].tolist()
            for b, want_idx in ((2, 5), (3, 4095)):
                if b < B and pred[b] != want_idx:
                    fail(f"exit_update B={B} {name}: a tie must pick index "
                         f"{want_idx}, got {pred[b]}")
            if B == 4 and int(exit_update(x, *carry, threshold=0.0, m=0,
                                          n_components=n_m)[1][2]) != 7:
                fail("exit_update: answered rows must keep their prediction")
            nbytes = x.numel() * x.element_size() + B * 4 * 13
            b, by = bound_ms(nbytes, 4 * x.numel(), name)
            extra = {}
            if B == 4:

                def check(tag, got, want):
                    for idx in (0, 1, 2, 4):
                        check_equal(tag, got[idx], want[idx])
                    for idx in (3, 5):
                        check_close(tag, got[idx], want[idx], 0.0, 1e-5)

                extra["device_threshold"] = threshold_forms(
                    f"exit_update B={B} {name}",
                    functools.partial(exit_update, x),
                    functools.partial(ref.ref_exit_update, x), check, carry,
                    n_m)
            # timed as the serving path calls it: δ̂ a device vector
            kw["threshold"] = torch.full((n_m,), 0.3, device=dev)
            cases.append({**extra,
                "shape": [B, V], "dtype": name, "max_abs_err": max(errs),
                "ms": time_ms(lambda: exit_update(x, *carry, **kw)),
                "plain_ms": time_ms(lambda: ref.ref_exit_update(x, *carry,
                                                                **kw)),
                "library_ms": time_ms(
                    lambda: torch.softmax(x.float(), -1).max(-1)),
                "bound_ms": b, "bound_by": by})
    return cases


def _carries(B, n_m, dev):
    import torch
    i32 = dict(dtype=torch.int32, device=dev)
    ar = torch.arange(B, device=dev)
    return (ar % 3 == 2, torch.full((B,), 7, **i32), ar.to(torch.int32) % n_m,
            0.1 + 0.1 * ar.float(), ar.to(torch.int32) % 4,
            torch.full((B,), 0.5, device=dev), ar % 4 != 2)


# the confidence kernel's shapes: Algorithm 1's (4, V) at B = 1 .. 64 in
# bf16, (4, V) in f32 and fp16, and (70000, 10) f32 (the paper's 10-class
# heads over more rows than grid.y's 65535, which the two-launch form could
# not launch); then rows whose V makes the plan pick each cluster size
# (1000: a lane group a row; 8000: C = 1; 16000, 32000, 64000: C = 2, 4,
# 8) and a V that is not a whole number of 16-byte chunks (scalar loads)
CONF_SHAPES = [(4, VOCAB, "bfloat16"), (1, VOCAB, "bfloat16"),
               (8, VOCAB, "bfloat16"), (16, VOCAB, "bfloat16"),
               (64, VOCAB, "bfloat16"), (4, VOCAB, "float32"),
               (4, VOCAB, "float16"), (70000, 10, "float32"),
               (4, 1000, "bfloat16"), (4, 8000, "bfloat16"),
               (4, 16000, "bfloat16"), (4, 32000, "bfloat16"),
               (4, 64000, "bfloat16"), (4, VOCAB - 3, "bfloat16")]


def _conf_logits(B, V, dt, dev, gen):
    """(B, V) logits with rows by role (b % 4): noise; a tie straddling
    the end of CTA 0's column range (the row's last two columns when one
    CTA holds the row); a tie across the first and last ranges (columns 1
    and V - 1); a confident row (column V // 3)."""
    import torch
    from repro_torch.kernels.confidence import plan, ranges
    x = torch.randn(B, V, generator=gen, device=dev)
    top = x.amax(-1, keepdim=True) + 15.0
    e = ranges(V, plan(V))[0][1]
    straddle = [e - 1, e] if e < V else [V - 2, V - 1]
    x[1::4, straddle] = top[1::4].expand(-1, 2)
    x[2::4, [1, V - 1]] = top[2::4].expand(-1, 2)
    x[3::4, V // 3] += 20.0
    return x.to(dt), straddle[0]


def _device_kernels(fn):
    """The device kernels one call of ``fn`` launches, by torch.profiler:
    [(name, count)]."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.key, e.count) for e in prof.key_averages()
            if "CUDA" in str(getattr(e, "device_type", ""))
            and e.count > 0 and "Activity Buffer" not in e.key]


def phase_confidence(dev, gen):
    """The cluster split at every shape of ``CONF_SHAPES``, through the
    wrapper a caller uses (so at the plan's cluster size, and every size
    in {1, 2, 4, 8, 16} across the shapes): argmax equal to the plain
    version's (ties straddling and across CTA ranges resolve to the first
    index), δ within 1e-5 relative (0 absolute); two calls give the same
    bits.  The kernel's column ranges equal the Python mirror's.  At the
    headline shape (4, 151936) bf16: one call is one device launch (by
    torch.profiler), and a CUDA graph that captured the call replays it on
    3 new inputs with the eager call's bits.  Times the kernel, the plain
    version and the library call at every shape."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import confidence as conf_mod
    from repro_torch.kernels.confidence import confidence, plan
    if {plan(V) for _, V, _ in CONF_SHAPES} != {1, 2, 4, 8, 16}:
        fail("confidence: the shapes no longer drive every cluster size")
    # the kernel's cut of a row against the Python mirror's
    for V in sorted({V for _, V, _ in CONF_SHAPES} | {1, 100, 1025, 8193,
                                                      65536}):
        if conf_mod.device_ranges(V, plan(V)) != conf_mod.ranges(V, plan(V)):
            fail(f"confidence: C++ and Python ranges differ at V = {V}")
    cases = []
    for B, V, name in CONF_SHAPES:
        dt = getattr(torch, name)
        x, first_straddle = _conf_logits(B, V, dt, dev, gen)
        tag = f"confidence ({B}, {V}) {name}"
        want = ref.ref_confidence(x)
        got = confidence(x)
        torch.cuda.synchronize()
        check_equal(f"{tag} argmax", got[0], want[0])
        check_close(f"{tag} delta", got[1], want[1], 0.0, 1e-5)
        again = confidence(x)
        if not (torch.equal(got[0], again[0])
                and torch.equal(got[1], again[1])):
            fail(f"{tag}: a second call gave other bits")
        idx = got[0].tolist()
        for b, col in ((1, first_straddle), (2, 1)):
            if b < B and idx[b] != col:
                fail(f"{tag}: a tie must pick index {col}, got {idx[b]}")
        b_, by = bound_ms(x.numel() * x.element_size() + B * 8,
                          4 * x.numel(), name)
        case = {"shape": [B, V], "dtype": name, "cluster": plan(V),
                "max_abs_err": max_err(got[1], want[1]),
                "ms": time_ms(lambda: confidence(x)),
                "plain_ms": time_ms(lambda: ref.ref_confidence(x)),
                "library_ms": time_ms(
                    lambda: torch.softmax(x.float(), -1).max(-1)),
                "bound_ms": b_, "bound_by": by}
        if (B, V, name) == CONF_SHAPES[0]:
            kern = _device_kernels(lambda: confidence(x))
            if len(kern) != 1 or kern[0][1] != 1 \
                    or "conf_cluster_kernel" not in kern[0][0]:
                fail(f"{tag}: one call must be one device launch of "
                     f"conf_cluster_kernel, the profiler saw {kern}")
            case["device_kernels"] = kern
            case["graph_replays"] = _confidence_graph(x, gen)
        cases.append(case)
    return cases


def _confidence_graph(x, gen):
    """Capture ``confidence`` on a static input in a CUDA graph, replay it
    on 3 new inputs copied into that input, and hold each replay's outputs
    to the eager call's bits.  Returns the replays checked."""
    import torch
    from repro_torch.kernels.confidence import confidence
    static = x.clone()
    confidence(static)                # first use outside the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = confidence(static)
    for k in range(3):
        new = _conf_logits(x.shape[0], x.shape[1], x.dtype, x.device,
                           gen)[0]
        static.copy_(new)
        g.replay()
        eager = confidence(new)
        torch.cuda.synchronize()
        if not (torch.equal(out[0], eager[0])
                and torch.equal(out[1], eager[1])):
            fail(f"confidence: graph replay {k} differs from the eager "
                 "call's bits")
    return 3


# the megakernel's logits sum d products in another order than cuBLAS:
# f32 agrees to ~1e-6 relative; bf16 logits are rounded to bf16 on both
# sides, so a logit can land one bf16 ulp apart and the confidence moves
# by up to ~1 %.  The argmax may then flip only on a row whose plain top
# two logits lie within the tie window (2 bf16 ulps; 1e-4 relative in
# f32): such rows are exempt from the prediction check and reported.
MEGA_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TIE_WINDOW = {"float32": 1e-4, "bfloat16": 2.0 ** -6}


def _mega_ties(h, w, head, name):
    """Rows whose plain top two logits lie within the tie window."""
    import torch
    from repro_torch.kernels import ref
    lg = (ref.ref_rmsnorm(h, w) @ head).float()
    top2 = torch.topk(lg, 2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]) <= TIE_WINDOW[name] * top2[:, 0].abs()


def _mega_check(tag, got, want, carry, live, ties, name):
    """Ints exact (the prediction except on tie rows), conf and EMA within
    MEGA_TOL, dead rows passed through; returns the largest float error."""
    for idx in (0, 2, 4):
        check_equal(tag, got[idx], want[idx])
    check_equal(tag + " pred", got[1][~ties], want[1][~ties])
    for idx in (3, 5):
        check_close(tag, got[idx], want[idx], 0.0, MEGA_TOL[name])
    if live is not None:
        for o, c in zip(got, carry):
            check_equal(tag + " dead rows", o[~live], c[~live].to(o.dtype))
    return max(max_err(got[3], want[3]), max_err(got[5], want[5]))


def megakernel_layout_diagnostic(dev):
    """The tc route's operand layouts, first: row b of h is one-hot at
    head row k_b (spread over k16 steps, swizzle phases and stages), the
    head is zero but for a 1 at (k_b, c_b) (spread over tiles, CTAs and
    accumulator rows), so row b's only non-zero logit sits at c_b; a
    misread descriptor, swizzle or transpose bit answers another column.
    N = 8 and N = 16 (B = 8 and 16)."""
    import torch
    from repro_torch.kernels.megakernel import exit_head_update, route
    d, V, n_m = D_MODEL, VOCAB, 3
    head = torch.zeros(d, V, dtype=torch.bfloat16, device=dev)
    w = torch.ones(d, device=dev)
    for B in (8, 16):
        ks = [(37 * b + 5) % d for b in range(B)]
        cs = [(9533 * b + 77) % V for b in range(B)]
        h = torch.zeros(B, d, dtype=torch.bfloat16, device=dev)
        for b in range(B):
            h[b, ks[b]] = 1.0
            head[ks[b], cs[b]] = 1.0
        if route(h, head, w) != "tc":
            fail(f"megakernel diagnostic B={B}: not on the tc route")
        carry = list(_carries(B, n_m, dev))
        carry[0] = torch.zeros_like(carry[0])       # none answered yet
        got = exit_head_update(h, w, head, *carry, threshold=0.5,
                               m=n_m - 1, n_components=n_m)
        torch.cuda.synchronize()
        pred = got[1].tolist()
        if pred != cs:
            bad = [(b, cs[b], pred[b]) for b in range(B) if pred[b] != cs[b]]
            fail(f"megakernel diagnostic B={B}: (row, want, got) {bad}")
        for b in range(B):
            head[ks[b], cs[b]] = 0.0
    del head
    torch.cuda.empty_cache()


def phase_megakernel(dev, gen):
    """bf16 at B = 1, 2, 4, 8, 16 on the tc route, f32 at B = 4, 8 on the
    CUDA-core one, a vocab not a multiple of 64 (tc) and one not a
    multiple of 8 (CUDA cores); live patterns with a dead row, every row
    dead, and two calls on one input bit for bit."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.exit_update import exit_update
    from repro_torch.kernels.megakernel import exit_head_update
    megakernel_layout_diagnostic(dev)
    d, V, n_m = D_MODEL, VOCAB, 3
    cases = []
    for dt, batches, want_route in ((torch.bfloat16, (1, 2, 4, 8, 16), "tc"),
                                    (torch.float32, (4, 8), "cuda_core")):
        name = str(dt).split(".")[-1]
        w = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
        head = (0.02 * torch.randn(d, V, generator=gen, device=dev)).to(dt)
        for B in batches:
            h = torch.randn(B, d, generator=gen, device=dev).to(dt)
            hc = head.clone()
            # row 1 is confident: column 77 points along its normalised row
            r1 = 1 if B > 1 else 0
            hc[:, 77] = (ref.ref_rmsnorm(h[r1:r1 + 1], w)[0].float()
                         * 0.05).to(dt)
            carry = _carries(B, n_m, dev)
            live = torch.arange(B, device=dev) % 4 != 2
            ties = _mega_ties(h, w, hc, name)
            errs = []
            for m, pk, decay in ((0, 0, 0.0), (1, 2, 0.0), (2, 0, 0.8)):
                kw = dict(threshold=0.5, m=m, n_components=n_m,
                          patience_k=pk, ema_decay=decay, live=live)
                got, route = route_of(lambda: exit_head_update(
                    h, w, hc, *carry, **kw), exit_head_update)
                want = ref.ref_exit_head_update(h, w, hc, *carry, **kw)
                torch.cuda.synchronize()
                tag = f"megakernel B={B} {name} m={m} k={pk} d={decay}"
                if route != want_route:
                    fail(f"{tag}: took the {route} route, expected "
                         f"{want_route}")
                errs.append(_mega_check(tag, got, want, carry, live, ties,
                                        name))
            if int(got[1][r1]) != 77:
                fail(f"megakernel B={B} {name}: confident row must answer "
                     f"77, got {int(got[1][r1])}")
            again = exit_head_update(h, w, hc, *carry, **kw)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"megakernel B={B} {name}: two calls on one input "
                     f"differ")
            dead = exit_head_update(h, w, hc, *carry, threshold=0.0, m=0,
                                    n_components=n_m,
                                    live=torch.zeros_like(live))
            for o, c in zip(dead, carry):
                check_equal(f"megakernel B={B} {name} all dead", o,
                            c.to(o.dtype))
            # timed as the serving path calls it: δ̂ a device vector
            ths = torch.full((n_m,), 0.5, device=dev)
            kw = dict(threshold=ths, m=0, n_components=n_m, live=live)
            extra = {}
            if B == 4:

                def check(tag, got, want, ties=ties):
                    _mega_check(tag, got, want, carry, live, ties, name)

                extra["device_threshold"] = threshold_forms(
                    f"megakernel B={B} {name}",
                    functools.partial(exit_head_update, h, w, hc, live=live),
                    functools.partial(ref.ref_exit_head_update, h, w, hc,
                                      live=live), check, carry, n_m)
            es = h.element_size()
            nbytes = hc.numel() * es + h.numel() * es + d * 4 + B * 4 * 14
            b, by = bound_ms(nbytes, 2 * B * d * V, name)

            def library():
                x = F.rms_norm(h, (d,), w.to(dt), 1e-5)
                return exit_update(x @ hc, *carry, threshold=ths, m=0,
                                   n_components=n_m)

            cases.append({
                **extra,
                "shape": [B, d, V], "dtype": name, "route": route,
                "live": live.tolist(), "tie_rows": int(ties.sum()),
                "max_abs_err": max(errs),
                "ms": time_ms(lambda: exit_head_update(h, w, hc, *carry,
                                                       **kw)),
                "plain_ms": time_ms(lambda: ref.ref_exit_head_update(
                    h, w, hc, *carry, **kw)),
                "library_ms": time_ms(library),
                "cublas_only_ms": time_ms(
                    lambda: F.rms_norm(h, (d,), w.to(dt), 1e-5) @ hc),
                "bound_ms": b, "bound_by": by})
            del hc
        del head
    # a vocab 8 columns short of a whole tile (the last tile's TMA box
    # reads past V) stays on the tc route; one not a multiple of 8 columns
    # takes the CUDA-core route and its element-wise head loads
    h = torch.randn(4, d, generator=gen, device=dev).bfloat16()
    w = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
    head = (0.02 * torch.randn(d, V, generator=gen, device=dev)).bfloat16()
    carry = _carries(4, n_m, dev)
    kw = dict(threshold=0.5, m=n_m - 1, n_components=n_m)
    for cut, want_route in ((8, "tc"), (3, "cuda_core")):
        hu = head[:, :V - cut]
        got, route = route_of(lambda: exit_head_update(h, w, hu, *carry,
                                                       **kw),
                              exit_head_update)
        want = ref.ref_exit_head_update(h, w, hu, *carry, **kw)
        tag = f"megakernel vocab {V - cut}"
        if route != want_route:
            fail(f"{tag}: took the {route} route, expected {want_route}")
        _mega_check(tag, got, want, carry, None,
                    _mega_ties(h, w, hu, "bfloat16"), "bfloat16")
    del head, hu
    torch.cuda.empty_cache()
    return cases


def phase_cohort_scatter(dev, gen):
    """The scatter, exact: its slot route (what select mode lands on the
    serving path: cohort c's rows of one ring slot of a deep segment's
    cache, the slot read from device memory) at the serving cache, also
    under graph replays that move the slot; and the whole-cohort form (the
    TPU kernel's contract) at the same cache."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.cohort_cache import cohort_scatter_tree
    C, c = 2, 1
    L, B = SEG_CACHE[:2]
    Bc = B // C
    cases = []
    for slot_route, dt in ((True, torch.bfloat16), (True, torch.float32),
                           (False, torch.bfloat16), (False, torch.float32)):
        name = str(dt).split(".")[-1]
        dst = [torch.randn(SEG_CACHE, generator=gen, device=dev).to(dt)
               for _ in range(2)]
        rows = (L, Bc, 1) + SEG_CACHE[3:] if slot_route \
            else (L, Bc) + SEG_CACHE[2:]
        src = [torch.randn(rows, generator=gen, device=dev).to(dt)
               for _ in range(2)]
        slot = torch.tensor(SCATTER_SLOT, device=dev) if slot_route \
            else None
        want = [x.clone() for x in dst]

        def plain(want=want, src=src, slot=slot):
            for wd, sd in zip(want, src):
                if slot is None:
                    ref.ref_cohort_scatter(wd, sd, c, C)
                else:
                    ref.ref_cohort_scatter_slot(wd, sd, c, C, slot)

        def library(want=want, src=src, slot=slot):
            for wd, sd in zip(want, src):
                view = wd[:, c * Bc:(c + 1) * Bc]
                if slot is None:
                    view.copy_(sd)
                else:
                    view.index_copy_(2, slot.view(1), sd)

        def kernel(dst=dst, src=src, slot=slot):
            cohort_scatter_tree(dst, src, c, C, slot=slot)

        def staged(dst=dst, src=src, slot=slot):
            # the land before the slot route, timed for the record: gather
            # the batch's slot rows, scatter the cohort's into them, write
            # them back
            rows = [x.index_select(2, slot.view(1)) for x in dst]
            cohort_scatter_tree(rows, src, c, C)
            for x, r in zip(dst, rows):
                x.index_copy_(2, slot.view(1), r)

        plain()
        kernel()
        torch.cuda.synchronize()
        tag = f"cohort_scatter {'slot' if slot_route else 'whole'} {name}"
        for a, b in zip(dst, want):
            check_equal(tag, a, b)
        if slot_route:
            # a captured land follows the slot in device memory
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                kernel()
            for s in (0, 300, SEG_CACHE[2] - 1):
                slot.fill_(s)
                for x in src:
                    x.normal_(generator=gen)
                graph.replay()
                plain()
                torch.cuda.synchronize()
                for a, b in zip(dst, want):
                    check_equal(f"{tag} replay at slot {s}", a, b)
            slot.fill_(SCATTER_SLOT)
            del graph

        nbytes = 2 * sum(x.numel() * x.element_size() for x in src)
        b, by = bound_ms(nbytes, 0, name)
        cases.append({
            "route": "slot" if slot_route else "whole",
            "shape": list(SEG_CACHE), "rows": list(rows), "leaves": 2,
            "cohort": [c, C], "dtype": name,
            "max_abs_err": max(max_err(a, b) for a, b in zip(dst, want)),
            "ms": time_ms(kernel), "plain_ms": time_ms(plain),
            "library_ms": time_ms(library),
            "staged_land_ms": time_ms(staged) if slot_route else None,
            "bound_ms": b, "bound_by": by})
    # odd-sized bool leaves take the byte-wise copy
    dst = torch.rand((3, 4, 5), generator=gen, device=dev) > 0.5
    src = torch.rand((3, 2, 5), generator=gen, device=dev) > 0.5
    want = dst.clone()
    want[:, 0:2] = src
    cohort_scatter_tree([dst], [src], 0, 2)
    check_equal("cohort_scatter bool leaf", dst, want)
    return cases


def phase_paged_gather(dev, gen):
    """The gather, exact, at the serving store (bf16, f32; block size 16)
    and at the route-parity run's f32 store of block size 64, the one
    serving path that launches it (the paged decode route reads block
    size 16 through the table)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_gather import paged_gather, paged_gather_kv
    cases = []
    for store, tshape, dt in ((PAGED_STORE, PAGED_TABLE, torch.bfloat16),
                              (PAGED_STORE, PAGED_TABLE, torch.float32),
                              (GATHER_STORE, GATHER_TABLE, torch.float32)):
        name = str(dt).split(".")[-1]
        NB = store[0]
        B, nblk = tshape
        # a layer slice of stacked (2, NB, ...) stores, as the model hands
        # it over
        ks = torch.randn((2,) + store, generator=gen, device=dev).to(dt)
        vs = torch.randn((2,) + store, generator=gen, device=dev).to(dt)
        k, v = ks[1], vs[1]
        table = torch.randint(1, NB, tshape, generator=gen, device=dev,
                              dtype=torch.int32)
        table[1, 5 * nblk // 8:] = 0           # uncovered ring ranges: trash
        table[3] = 0                           # a dead slot: all trash
        table[2, :nblk // 8] = table[0, nblk // 4]   # duplicate ids
        got = paged_gather_kv(k, v, table)
        want = (ref.ref_paged_gather(k, table), ref.ref_paged_gather(v, table))
        one = paged_gather(v, table)
        torch.cuda.synchronize()
        for g, w in zip(got + (one,), want + (want[1],)):
            check_equal(f"paged_gather {name}", g, w)

        def library():
            return tuple(torch.index_select(x, 0, table.flatten()).view(
                (B, nblk * x.shape[1]) + x.shape[2:]) for x in (k, v))

        lib = library()
        check_equal(f"paged_gather {name} library", lib[0], want[0])
        nbytes = 2 * 2 * want[0].numel() * want[0].element_size() + \
            table.numel() * 4
        b, by = bound_ms(nbytes, 0, name)
        cases.append({
            "shape": [list(store), list(tshape)], "stores": 2,
            "dtype": name, "max_abs_err": max(max_err(g, w)
                                              for g, w in zip(got, want)),
            "ms": time_ms(lambda: paged_gather_kv(k, v, table)),
            "plain_ms": time_ms(lambda: (ref.ref_paged_gather(k, table),
                                         ref.ref_paged_gather(v, table))),
            "library_ms": time_ms(library),
            "bound_ms": b, "bound_by": by})
        del ks, vs
    return cases


# ---------------------------------------------------------------------------
# phases 3 to 6: the serving path
# ---------------------------------------------------------------------------

def make_requests(n: int, lens, vocab: int, max_new: int, seed: int):
    import numpy as np
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(
        0, vocab, size=lens[i % len(lens)]).astype(np.int32),
        max_new_tokens=max_new) for i in range(n)]


SLICE1 = {"rmsnorm", "exit_update", "decode_attention", "flash_attention"}


def check_launched(tag, launches, expected):
    """Exactly the ``expected`` kernels launched in this path's run."""
    ran = {k for k, n in launches.items() if n}
    if ran != set(expected):
        fail(f"{tag}: launched {sorted(ran)}, expected {sorted(expected)} "
             f"({launches})")


def make_engine(cfg, model, params, **engine_kw):
    from repro_torch.serving.engine import CascadeServingEngine
    engine = CascadeServingEngine(cfg, model, params, device=DEV,
                                  **engine_kw)
    if engine.loop is not None:
        # the device runtime's replays: any device sync there raises
        engine.loop.sync_check = True
    return engine


def serve(cfg, model, params, reqs, engine=None, **engine_kw):
    """One engine run (on ``engine``, or a fresh one); returns (finished,
    stats, seconds, launches).  With autotune on, ``stats["telemetry"]``
    holds every lane's counters merged (fetched after the run)."""
    import torch
    from repro_torch import kernels
    if engine is None:
        engine = make_engine(cfg, model, params, **engine_kw)
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    finished = engine.run(max_ticks=10_000)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    stats = engine.stats()
    # the lanes' carried segments_run: every decode step, warm-up included
    stats["carried_segments_run"] = [
        int(x) for x in sum(ln["state"].segments_run for ln in engine.lanes)]
    # every prefill of a bf16 / fp16 model takes flash's wgmma route and
    # every exit head the megakernel's tc route, of an f32 one their
    # CUDA-core routes; every norm of the model's width takes rmsnorm's
    # warp route; every decode attention over paged stores whose block
    # size divides the 32-key tile takes the paged route (no gather), any
    # other the dense one
    from repro_torch.kernels.decode_attention import TILE, decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.megakernel import exit_head_update
    from repro_torch.kernels.rmsnorm import rmsnorm
    f32 = cfg.dtype == "float32"
    paged = (cfg.paged_cache.layout == "paged"
             and TILE % cfg.paged_cache.block_size == 0)
    for name, fn, want in (
            ("flash_attention", flash_attention,
             "cuda_core" if f32 else "wgmma"),
            ("megakernel", exit_head_update, "cuda_core" if f32 else "tc"),
            ("rmsnorm", rmsnorm, "warp"),
            ("decode_attention", decode_attention,
             "paged" if paged else "dense")):
        routes = dict(fn.launches_by_route)
        if routes[want] != launches[name]:
            fail(f"{cfg.name} {cfg.dtype}: {name} routes {routes}, expected "
                 f"all {launches[name]} launches on {want}")
        stats[f"{name}_routes"] = routes
    if cfg.autotune.enabled:
        from repro_torch.autotune import merge_telemetry
        stats["telemetry"] = {k: v.tolist() for k, v in merge_telemetry(
            engine.lane_telemetry()).items()}
    return finished, stats, seconds, launches


def phase_full_width():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import nn
    from repro_torch.models.model import build_model
    base = get_config("qwen2.5-3b").replace(use_kernels=True).with_cascade(
        exit_mode="cond_batch")
    model = build_model(base, device=DEV)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    n_params = sum(x.numel() for x in nn.tree_leaves(params))
    reqs = make_requests(8, (128, 256), base.vocab_size, 16, seed=0)
    runs = {}
    for ths in ((0.9, 0.9, 0.0), (0.0, 0.0, 0.0)):
        cfg = base.with_cascade(thresholds=ths)
        fin, st, secs, launches = serve(cfg, model, params, reqs,
                                        lane_batch=4, n_lanes=2,
                                        cache_len=512)
        if sorted(fin) != list(range(8)):
            fail(f"full width {ths}: finished {sorted(fin)}")
        for rid, r in fin.items():
            if len(r["tokens"]) != 16:
                fail(f"full width {ths}: request {rid} got "
                     f"{len(r['tokens'])} tokens")
        depths = {d for r in fin.values() for d in r["exit_depths"]}
        want_depth = 2 if ths[0] > 0 else 0
        if depths != {want_depth}:
            fail(f"full width {ths}: exit depths {sorted(depths)}, expected "
                 f"all {want_depth}")
        if ths[0] == 0 and st["segments_run"][1:] != [0, 0]:
            fail(f"full width {ths}: segments 1-2 ran "
                 f"{st['segments_run']} at threshold 0")
        check_launched(f"full width {ths}", launches, SLICE1)
        n_tok = sum(len(r["tokens"]) for r in fin.values())
        rec = {"phase": "full_width", "config": "qwen2.5-3b",
               "n_layers": base.n_layers, "dtype": base.dtype,
               "params": n_params, "thresholds": list(ths),
               "requests": len(fin), "tokens": n_tok,
               "seconds": secs, "tokens_per_s": n_tok / secs,
               "decode_us_per_token": st["wallclock_us_per_token"],
               "prefill_seconds": st["prefill_seconds"],
               "prefills": st["prefills"],
               "first_dispatch_seconds": st["compile_seconds"],
               "host_syncs_per_token": st["host_syncs_per_token"],
               "segments_run": st["segments_run"],
               "exit_histogram": st["exit_histogram"],
               "analytic_speedup": st["analytic_speedup"],
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "launches": launches,
               "flash_routes": st["flash_attention_routes"],
               "rmsnorm_routes": st["rmsnorm_routes"],
               "decode_routes": st["decode_attention_routes"],
               "provenance": st["provenance"]}
        emit(rec)
        runs[ths] = rec
    del params
    torch.cuda.empty_cache()
    run = runs[(0.9, 0.9, 0.0)]
    return run["launches"], {"flash_attention": run["flash_routes"],
                             "rmsnorm": run["rmsnorm_routes"],
                             "decode_attention": run["decode_routes"]}


def _streams(fin):
    return {rid: (r["tokens"], r["exit_depths"]) for rid, r in fin.items()}


def mixed_threshold(fin, run, tag):
    """A component-0 threshold at which the cohorts disagree, so that the
    mixed dispatch branch runs: the midpoint of two neighbouring decode
    confidences of ``fin`` (a run where every token answers at component
    0), at the median first and then at other quantiles, until
    ``run(threshold)`` — a serving run at (threshold, 0.9, 0.0) that
    returns its ``cohort_dispatch`` counts — took the mixed branch.  Which
    slots' confidences clear a threshold decides whether both slots of a
    cohort exit together, so no single quantile reaches the branch for
    every set of weights and kernel numerics.  Returns (threshold,
    quantile)."""
    import numpy as np
    c = np.sort([x for r in fin.values() for x in r["confs"][1:]])
    for q in (0.5, 0.25, 0.75, 0.375, 0.625, 0.125, 0.875):
        i = min(max(int(q * len(c)), 1), len(c) - 1)
        th = float((c[i - 1] + c[i]) / 2)
        if run(th)["mixed"]:
            return th, q
    fail(f"{tag}: no component-0 threshold made the cohorts disagree")


def phase_full_width_cohorts():
    """Slice 2's path: 2 cohorts, major layout, megakernel + cohort
    scatter, cond_batch, at three threshold vectors; megakernel on and off
    in turns (on, off, off, on) for the end-to-end comparison.  Returns
    (launches of the mixed run, model, params, records)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    base = get_config("qwen2.5-3b").replace(use_kernels=True).with_cascade(
        exit_mode="cond_batch", n_cohorts=2, cohort_layout="major")
    model = build_model(base, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    reqs = make_requests(8, (128, 256), base.vocab_size, 16, seed=0)
    kw = dict(lane_batch=4, n_lanes=2, cache_len=512)
    records, mixed_launches, fin0, calib, quantile = [], None, None, None, None
    mixed_routes = None
    for vi in range(3):
        # the third vector's component-0 threshold: from the (0, 0, 0)
        # run's confidences (all answered at component 0), one at which
        # the cohorts disagree
        if vi == 2:
            calib, quantile = mixed_threshold(
                fin0, lambda th: serve(
                    base.with_cascade(thresholds=(th, 0.9, 0.0))
                    .with_kernel_tune(megakernel=True, cohort_scatter=True),
                    model, params, reqs, **kw)[1]["cohort_dispatch"],
                "full width cohorts")
        ths = ((0.0, 0.0, 0.0), (0.9, 0.9, 0.0), (calib, 0.9, 0.0))[vi]
        runs = {True: [], False: []}
        for mk in (True, False, False, True):
            cfg = base.with_cascade(thresholds=ths).with_kernel_tune(
                megakernel=mk, cohort_scatter=mk)
            fin, st, secs, launches = serve(cfg, model, params, reqs, **kw)
            tag = f"cohorts {ths} megakernel={mk}"
            if sorted(fin) != list(range(8)) or any(
                    len(r["tokens"]) != 16 for r in fin.values()):
                fail(f"{tag}: not every request got its 16 tokens")
            check_launched(tag, launches,
                           SLICE1 | ({"megakernel"} if mk else set()))
            if mk and launches["exit_update"] != 3 * st["prefills"]:
                fail(f"{tag}: exit_update launched {launches['exit_update']}"
                     f" times for {st['prefills']} prefills: a decode exit "
                     f"head left the megakernel")
            depths = {d for r in fin.values() for d in r["exit_depths"][1:]}
            disp = st["cohort_dispatch"]
            if vi == 0 and (depths != {0} or st["segments_run"][1:] != [0, 0]
                            or disp["mixed"] or disp["all_run"]):
                fail(f"{tag}: expected every cohort to skip: {depths} "
                     f"{st['segments_run']} {disp}")
            if vi == 1 and (depths != {2} or disp["mixed"]
                            or disp["all_skip"]):
                fail(f"{tag}: expected full depth: {depths} {disp}")
            if vi == 2 and mk and (not {0, 2} <= depths
                                   or disp["mixed"] == 0):
                fail(f"{tag}: expected cohorts to disagree: {depths} {disp}")
            runs[mk].append({
                "us_per_token": st["wallclock_us_per_token"],
                "tokens_per_s": sum(len(r["tokens"]) for r in fin.values())
                / secs,
                "host_syncs_per_token": st["host_syncs_per_token"],
                "seconds": secs, "prefill_seconds": st["prefill_seconds"],
                "segments_run": st["segments_run"],
                "exit_histogram": st["exit_histogram"],
                "cohort_dispatch": disp, "launches": launches,
                "megakernel_routes": st["megakernel_routes"],
                "streams": _streams(fin)})
            if vi == 0 and mk and fin0 is None:
                fin0 = fin
            if vi == 2 and mk:
                mixed_launches = launches
                mixed_routes = st["megakernel_routes"]
        on, off = runs[True], runs[False]
        rec = {"phase": "full_width_cohorts", "config": "qwen2.5-3b",
               "n_layers": base.n_layers, "dtype": base.dtype,
               "n_cohorts": 2, "cohort_layout": "major",
               "exit_mode": "cond_batch", "thresholds": list(ths),
               "order": "on, off, off, on",
               "megakernel_on": [{k: v for k, v in r.items()
                                  if k != "streams"} for r in on],
               "megakernel_off": [{k: v for k, v in r.items()
                                   if k != "streams"} for r in off],
               "streams_on_equal_off": on[0]["streams"] == off[0]["streams"],
               "threshold_quantile": quantile if vi == 2 else None,
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        records.append(rec)
        emit(rec)
    return (mixed_launches, mixed_routes), model, params, records


def paged_config(base, **paged):
    return base.with_paged_cache(**{"layout": "paged", "block_size": 16,
                                    **paged})


def phase_full_width_paged(params):
    """Slice 3's path at full width: the JAX serving bench's paged
    configuration (2 cohorts, major, cond_batch, block size 16, lane batch
    4, 2 lanes, cache_len 512) with kernels on.

    (a) at capacity: the 8 requests of phase 3 at (0.9, 0.9, 0.0) and
    (0, 0, 0), paged and dense in turns (paged, dense, dense, paged);
    identical token and exit streams.  (b) an equal-memory burst: a paged
    engine with 8 slots per lane and its pool capped at the 4-slot dense
    count beside a dense engine with 4; 24 requests of 128/256 prompt
    tokens and 8/16 new tokens at (0, 0, 0).  Every paged decode attention
    reads the stores through the block table (route ``paged``): no
    ``paged_gather`` launch.  Returns the decode routes of the paged run at
    (0.9, 0.9, 0.0)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    base = get_config("qwen2.5-3b").replace(use_kernels=True).with_cascade(
        exit_mode="cond_batch", n_cohorts=2, cohort_layout="major")
    reqs = make_requests(8, (128, 256), base.vocab_size, 16, seed=0)
    kw = dict(lane_batch=4, n_lanes=2, cache_len=512)
    headline = None
    for ths in ((0.9, 0.9, 0.0), (0.0, 0.0, 0.0)):
        runs = {True: [], False: []}
        streams = {}
        for paged in (True, False, False, True):
            cfg = base.with_cascade(thresholds=ths)
            if paged:
                cfg = paged_config(cfg)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            fin, st, secs, launches = serve(
                cfg, build_model(cfg, device=DEV), params, reqs, **kw)
            tag = f"paged at capacity {ths} paged={paged}"
            if sorted(fin) != list(range(8)) or any(
                    len(r["tokens"]) != 16 for r in fin.values()):
                fail(f"{tag}: not every request got its 16 tokens")
            # serve() has checked that every decode took the paged route
            check_launched(tag, launches, SLICE1)
            if paged and (st["memory"]["blocks_used"] != 0
                          or st["slot_prefills"] != 0):
                fail(f"{tag}: {st['memory']['blocks_used']} blocks left, "
                     f"{st['slot_prefills']} slot prefills at capacity")
            streams.setdefault(paged, _streams(fin))
            if _streams(fin) != streams[paged]:
                fail(f"{tag}: a repeated run changed the streams")
            runs[paged].append({
                "us_per_token": st["wallclock_us_per_token"],
                "tokens_per_s": sum(len(r["tokens"]) for r in fin.values())
                / secs,
                "seconds": secs, "prefill_seconds": st["prefill_seconds"],
                "host_syncs_per_token": st["host_syncs_per_token"],
                "segments_run": st["segments_run"],
                "cohort_dispatch": st["cohort_dispatch"],
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "memory": st["memory"], "launches": launches,
                "decode_routes": st["decode_attention_routes"]})
            if paged and ths[0] > 0 and headline is None:
                headline = st["decode_attention_routes"]
        if streams[True] != streams[False]:
            bad = [rid for rid in streams[True]
                   if streams[True][rid] != streams[False].get(rid)]
            fail(f"paged at capacity {ths}: paged and dense streams differ "
                 f"on requests {bad}")
        emit({"phase": "full_width_paged", "config": "qwen2.5-3b",
              "n_layers": base.n_layers, "dtype": base.dtype,
              "n_cohorts": 2, "cohort_layout": "major",
              "exit_mode": "cond_batch", "block_size": 16,
              "thresholds": list(ths), "order": "paged, dense, dense, paged",
              "streams_paged_equal_dense": True,
              "paged": runs[True], "dense": runs[False]})

    # (b) the equal-memory admission burst
    ths = (0.0, 0.0, 0.0)
    dense_cfg = base.with_cascade(thresholds=ths)
    nb = 2 * 4 * 3 * (512 // 16) + 1          # the 4-slot dense count
    burst = make_requests(24, (128, 256), base.vocab_size, 16, seed=3)
    for i, r in enumerate(burst):
        r.max_new_tokens = (8, 16)[(i // 2) % 2]
    out = {}
    for paged in (True, False):
        cfg = paged_config(dense_cfg, num_blocks=nb) if paged else dense_cfg
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fin, st, secs, launches = serve(
            cfg, build_model(cfg, device=DEV), params, burst,
            lane_batch=8 if paged else 4, n_lanes=2, cache_len=512)
        tag = f"paged burst paged={paged}"
        if sorted(fin) != list(range(24)) or any(
                len(fin[r.rid]["tokens"]) != r.max_new_tokens for r in burst):
            fail(f"{tag}: not every request finished with its budget")
        mem = st["memory"]
        if paged and (st["slot_prefills"] < 1 or mem["blocks_used"] != 0
                      or mem["peak_blocks_used"] > nb - 1
                      or mem["reclaimed_by_exit"] <= 0):
            fail(f"{tag}: slot prefills {st['slot_prefills']}, memory {mem}")
        check_launched(tag, launches, SLICE1)
        out[paged] = {
            "lane_batch": st["lane_batch"], "seconds": secs,
            "us_per_token": st["wallclock_us_per_token"],
            "admission_wait_mean": st["admission_wait_mean"],
            "admission_wait_ticks": st["admission_wait_ticks"],
            "prefills": st["prefills"], "slot_prefills": st["slot_prefills"],
            "prefill_seconds": st["prefill_seconds"],
            "peak_cache_bytes": mem["peak_cache_bytes"], "memory": mem,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": launches,
            "decode_routes": st["decode_attention_routes"]}
    emit({"phase": "full_width_paged_burst", "config": "qwen2.5-3b",
          "thresholds": list(ths), "requests": len(burst),
          "num_blocks": nb, "paged": out[True], "dense": out[False]})
    return headline


def phase_device_runtime(params, mixed):
    """Slice 8's path at full width: the device runtime (K = 8 tokens a
    lane a dispatch from a captured CUDA graph, cond_batch skips as IF
    nodes, one host sync a chunk) against the host runtime, in turns
    (host, device, device, host), on the 8 prompts of phase 3 with 32
    tokens each (so that every device window holds three replayed chunks
    a lane after the capture chunk): dense with one cohort and paged
    (block size 16, 2 cohorts) at (0.9, 0.9, 0.0) and (0, 0, 0); dense
    with 2 cohorts and the megakernel at those and at phase 4's mixed
    vector ``(mixed, 0.9, 0.0)``; and dense with one cohort at (0.9, 0.9,
    0.0) on 16 requests of 16 tokens, whose second wave is admitted at a
    chunk boundary and re-prefilled into the captured buffers.  Fails
    unless, in each, tokens, exits and the carried segments_run are equal,
    every launch count and route agrees, the device runtime synced once
    per lane chunk, captured one graph per lane and no replay synced (they
    run under ``torch.cuda.set_sync_debug_mode("error")``, see
    :func:`serve`).  Returns the launches of the device runtime's dense
    one-cohort run at (0.9, 0.9, 0.0)."""
    import statistics as stats_mod
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    base = get_config("qwen2.5-3b").replace(use_kernels=True).with_cascade(
        exit_mode="cond_batch")
    two = base.with_cascade(n_cohorts=2, cohort_layout="major")
    reqs = make_requests(8, (128, 256), base.vocab_size, 32, seed=0)
    waves = make_requests(16, (128, 256), base.vocab_size, 16, seed=0)
    kw = dict(lane_batch=4, n_lanes=2, cache_len=512, chunk=8)
    corners = [(0.9, 0.9, 0.0), (0.0, 0.0, 0.0)]
    configs = [
        ("dense, 1 cohort", base, corners, reqs),
        ("dense, 1 cohort, two waves", base, corners[:1], waves),
        ("dense, 2 cohorts, megakernel",
         two.with_kernel_tune(megakernel=True, cohort_scatter=True),
         corners + [(mixed, 0.9, 0.0)], reqs),
        ("paged, 2 cohorts", paged_config(two), corners, reqs)]
    headline = None
    for name, cfg0, vectors, reqs in configs:
        model = build_model(cfg0, device=DEV)
        n_req, n_new = len(reqs), reqs[0].max_new_tokens
        for ths in vectors:
            cfg = cfg0.with_cascade(thresholds=ths)
            runs = {"host": [], "device": []}
            ref = None
            for runtime in ("host", "device", "device", "host"):
                fin, st, secs, launches = serve(cfg, model, params, reqs,
                                                runtime=runtime, **kw)
                tag = f"device runtime {name} {ths} {runtime}"
                if sorted(fin) != list(range(n_req)) or any(
                        len(r["tokens"]) != n_new for r in fin.values()):
                    fail(f"{tag}: not every request got its {n_new} tokens")
                got = {"streams": _streams(fin),
                       "segments": st["carried_segments_run"],
                       "launches": launches,
                       "routes": {k: st[k] for k in st
                                  if k.endswith("_routes")}}
                if ref is None:
                    ref = got
                for key, what in got.items():
                    if what != ref[key]:
                        fail(f"{tag}: {key} differ from the host runtime's: "
                             f"{what} against {ref[key]}")
                if runtime == "device":
                    if st["host_syncs"] != st["decode_dispatches"]:
                        fail(f"{tag}: {st['host_syncs']} host syncs for "
                             f"{st['decode_dispatches']} lane chunks")
                    if st["captures"] != kw["n_lanes"]:
                        fail(f"{tag}: {st['captures']} captures for "
                             f"{kw['n_lanes']} lanes x 1 threshold vector")
                    if headline is None:
                        headline = launches
                n_tok = sum(len(r["tokens"]) for r in fin.values())
                runs[runtime].append({
                    "decode_us_per_token": st["wallclock_us_per_token"],
                    "tokens_per_s": n_tok / secs, "seconds": secs,
                    "host_syncs_per_token": st["host_syncs_per_token"],
                    "host_syncs": st["host_syncs"],
                    "decode_dispatches": st["decode_dispatches"],
                    "dispatch_spread": st["dispatch_spread"],
                    "decode_tokens": st["decode_tokens"],
                    "compile_seconds": st["compile_seconds"],
                    "captures": st["captures"],
                    "prefill_seconds": st["prefill_seconds"],
                    "segments_run": st["segments_run"],
                    "carried_segments_run": st["carried_segments_run"],
                    "cohort_dispatch": st["cohort_dispatch"],
                    # a capture's private pool must not outlive its engine
                    "memory_reserved": torch.cuda.memory_reserved()})
            med = {rt: stats_mod.median(r["decode_us_per_token"]
                                        for r in rr)
                   for rt, rr in runs.items()}
            emit({"phase": "device_runtime", "config": "qwen2.5-3b",
                  "n_layers": cfg.n_layers, "dtype": cfg.dtype,
                  "variant": name, "thresholds": list(ths), "chunk": 8,
                  "requests": n_req, "max_new_tokens": n_new,
                  "order": "host, device, device, host",
                  "identical": True, "host": runs["host"],
                  "device": runs["device"],
                  "decode_us_per_token_median": med,
                  "host_over_device": med["host"] / med["device"],
                  "launches": ref["launches"]})
        del model
        torch.cuda.empty_cache()
    return headline


AUTOTUNE = dict(enabled=True, bins=32, shadow_every=4)


def phase_autotune(params):
    """Slice 9's path at full width (dense, lane_batch 4, 2 lanes,
    cache_len 512, chunk 8, autotune with 32 bins and a shadow step every
    4 positions, 8 requests x 32 tokens):

    (a) the device runtime with autotune off and on, in turns (off, on,
        on, off), at (0.9, 0.9, 0.0) and (0, 0, 0), one cohort and two
        with the megakernel: identical streams and exits, decode µs/token
        of both, shadow_steps;
    (b) the host runtime with autotune on, on the same requests: every
        telemetry counter, the carried segments_run and the launches by
        route and by threshold form equal the device runtime's;
    (c) an engine at (0.9, 0.9, 0.0) serves, is pushed (1.1, 0.5, 0.0) —
        current_thresholds() must return those floats — then (0, 0, 0),
        and serves 8 requests of one prompt length again: its captures are
        unchanged and its streams are a fresh (0, 0, 0) engine's;
    (d) the calibrate CLI in a subprocess on the device runtime: exit 0,
        and its artifact round-trips.

    Returns the launches of the device runtime's autotune-on runs at
    (0, 0, 0): {variant: launches}."""
    import statistics as stats_mod
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    base = get_config("qwen2.5-3b").replace(use_kernels=True).with_cascade(
        exit_mode="cond_batch")
    reqs = make_requests(8, (128, 256), base.vocab_size, 32, seed=0)
    kw = dict(lane_batch=4, n_lanes=2, cache_len=512, chunk=8)
    variants = [
        ("dense, 1 cohort", base),
        ("dense, 2 cohorts, megakernel",
         base.with_cascade(n_cohorts=2, cohort_layout="major")
         .with_kernel_tune(megakernel=True, cohort_scatter=True))]
    launches_on = {}
    for name, cfg0 in variants:
        model = build_model(cfg0, device=DEV)
        for ths in ((0.9, 0.9, 0.0), (0.0, 0.0, 0.0)):
            off = cfg0.with_cascade(thresholds=ths)
            on = off.with_autotune(**AUTOTUNE)
            runs = {"off": [], "on": []}
            ref = on_run = None
            for which in ("off", "on", "on", "off"):
                fin, st, secs, launches = serve(
                    on if which == "on" else off, model, params, reqs,
                    runtime="device", **kw)
                tag = f"autotune {name} {ths} {which}"
                if sorted(fin) != list(range(8)) or any(
                        len(r["tokens"]) != 32 for r in fin.values()):
                    fail(f"{tag}: not every request got its 32 tokens")
                if ref is None:
                    ref = _streams(fin)
                if _streams(fin) != ref:
                    fail(f"{tag}: streams differ from autotune off's")
                if st["host_syncs"] != st["decode_dispatches"]:
                    fail(f"{tag}: {st['host_syncs']} host syncs for "
                         f"{st['decode_dispatches']} lane chunks")
                if st["captures"] != kw["n_lanes"]:
                    fail(f"{tag}: {st['captures']} captures for "
                         f"{kw['n_lanes']} lanes")
                if which == "on":
                    on_run = (st, launches)
                runs[which].append({
                    "decode_us_per_token": st["wallclock_us_per_token"],
                    "seconds": secs,
                    "host_syncs_per_token": st["host_syncs_per_token"],
                    "compile_seconds": st["compile_seconds"],
                    "segments_run": st["segments_run"],
                    "carried_segments_run": st["carried_segments_run"],
                    "shadow_steps": (st["autotune"]["shadow_steps"]
                                     if which == "on" else None)})
            # (b) the host runtime, autotune on
            fin, st, secs, launches = serve(on, model, params, reqs,
                                            runtime="host", **kw)
            dev_st, dev_launches = on_run
            tag = f"autotune {name} {ths} host runtime"
            if _streams(fin) != ref:
                fail(f"{tag}: streams differ from the device runtime's")
            for key in ("telemetry", "carried_segments_run"):
                if st[key] != dev_st[key]:
                    fail(f"{tag}: {key} differ from the device runtime's: "
                         f"{st[key]} against {dev_st[key]}")
            if launches != dev_launches or any(
                    st[k] != dev_st[k] for k in st if k.endswith("_routes")):
                fail(f"{tag}: launches differ from the device runtime's: "
                     f"{launches} against {dev_launches}")
            if ths == (0.0, 0.0, 0.0):
                launches_on[name] = dev_launches
            med = {w: stats_mod.median(r["decode_us_per_token"]
                                       for r in rr)
                   for w, rr in runs.items()}
            emit({"phase": "autotune", "config": "qwen2.5-3b",
                  "dtype": base.dtype, "variant": name,
                  "thresholds": list(ths), "chunk": kw["chunk"],
                  "requests": 8, "max_new_tokens": 32, "autotune": AUTOTUNE,
                  "order": "off, on, on, off", "identical": True,
                  "runs": runs, "decode_us_per_token_median": med,
                  "on_over_off": med["on"] / med["off"],
                  "telemetry_equal_host_runtime": True,
                  "shadow_steps": dev_st["autotune"]["shadow_steps"],
                  "exit_counts": dev_st["autotune"]["exit_counts"],
                  "host_runtime_us_per_token": st["wallclock_us_per_token"],
                  "launches_on": dev_launches})
        del model
        torch.cuda.empty_cache()
    phase_autotune_push(params, base, kw)
    phase_autotune_cli()
    return launches_on


def phase_autotune_push(params, base, kw):
    """(c) of :func:`phase_autotune`: a push costs no capture."""
    import torch
    from repro_torch.models.model import build_model
    cfg = base.with_autotune(**AUTOTUNE)
    model = build_model(cfg, device=DEV)
    reqs = make_requests(8, (128,), base.vocab_size, 32, seed=1)
    engine = make_engine(cfg.with_cascade(thresholds=(0.9, 0.9, 0.0)), model,
                         params, runtime="device", **kw)
    serve(cfg, model, params, reqs, engine=engine)
    captures = engine.stats()["captures"]
    engine.finished.clear()
    for push in ((1.1, 0.5, 0.0), (0.0, 0.0, 0.0)):
        engine.push_thresholds(push)
        if engine.current_thresholds() != push:
            fail(f"autotune push: current_thresholds() "
                 f"{engine.current_thresholds()} after pushing {push}")
    t0 = time.perf_counter()
    fin, st, _, _ = serve(cfg, model, params, reqs, engine=engine)
    pushed = _streams(fin)
    if st["captures"] != captures:
        fail(f"autotune push: {st['captures'] - captures} new captures")
    if st["host_syncs"] != st["decode_dispatches"]:
        fail("autotune push: more than one host sync a lane chunk")
    fresh, _, _, _ = serve(cfg.with_cascade(thresholds=(0.0, 0.0, 0.0)),
                           model, params, reqs, runtime="device", **kw)
    if _streams(fresh) != pushed:
        fail("autotune push: the pushed engine's streams differ from a "
             "fresh engine's at the pushed thresholds")
    emit({"phase": "autotune_push", "captures_before": captures,
          "captures_after": st["captures"],
          "pushed": [[1.1, 0.5, 0.0], [0.0, 0.0, 0.0]],
          "current_thresholds": list(engine.current_thresholds()),
          "streams_equal_fresh_engine": True,
          "serve_seconds_after_push": time.perf_counter() - t0,
          "compile_seconds": st["compile_seconds"]})
    del engine, model
    torch.cuda.empty_cache()


def phase_autotune_cli():
    """(d) of :func:`phase_autotune`: ``python -m
    repro_torch.launch.calibrate`` on the card, in a subprocess."""
    import os
    import tempfile
    from repro_torch.autotune import load_artifact
    from repro_torch.configs import get_config
    with tempfile.TemporaryDirectory() as out:
        cmd = [sys.executable, "-m", "repro_torch.launch.calibrate",
               "--arch", "qwen2.5-3b", "--epsilon", "0.05", "--requests",
               "8", "--max-new", "32", "--runtime", "device", "--out", out]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                                   if env.get("PYTHONPATH") else []))
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"calibrate CLI exited {proc.returncode}:\n"
                 f"{proc.stderr[-3000:]}")
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        art = load_artifact(out, get_config("qwen2.5-3b").with_autotune(
            enabled=True, bins=32))
        if art is None or list(art.thresholds) != summary["thresholds"]:
            fail("calibrate CLI: its artifact does not round-trip")
    emit({"phase": "autotune_cli", "command": " ".join(cmd[1:-1]), "rc": 0,
          "seconds": time.perf_counter() - t0,
          "thresholds": summary["thresholds"],
          "shadow_steps": summary["shadow_steps"],
          "agreement": summary["agreement"],
          "requests_finished": summary["requests_finished"]})


def phase_algorithm1(model, params):
    """Algorithm 1 on the full-width model: component m runs segment m on
    the prompt's hidden state and returns the exit logits at the last
    position.  The confidence kernel (use_kernels) against the plain
    measure on the same logits."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core.cascade import cascade_infer_sequential
    from repro_torch.core.policy import ExitDecider
    S = 128
    x = torch.as_tensor(np.random.default_rng(2).integers(
        0, model.cfg.vocab_size, (4, S)), device=DEV)
    ctx = {"mode": "full",
           "positions": torch.arange(S, dtype=torch.int32, device=DEV)}
    logits = []

    def component(m):
        def fn(tokens, h):
            if len(logits) <= m:     # the model runs once per component
                if h is None:
                    h = model._embed(params, tokens)
                h, _, _ = model.run_segment(m, params, h, ctx, None)
                logits.append((model.exit_logits(params, m, h[:, -1:, :])
                               [:, 0, :], h))
            return logits[m]
        return fn

    fns = [component(m) for m in range(model.n_exits)]
    # the model's own kernels run here, outside the counted runs below
    h = None
    for fn in fns:
        _, h = fn(x, h)
    out = []
    for ths in ((0.9, 0.9, 0.0), (0.0, 0.0, 0.0)):
        res = {}
        for use_kernels in (False, True):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            pred, conf = cascade_infer_sequential(
                fns, ths, x, ExitDecider("softmax_max",
                                         use_kernels=use_kernels))
            torch.cuda.synchronize()
            res[use_kernels] = (pred, conf, kernels.launch_counts())
        launches = res[True][2]
        check_launched(f"algorithm 1 {ths}", launches, {"confidence"})
        if launches["confidence"] != model.n_exits:
            fail(f"algorithm 1 {ths}: {launches['confidence']} confidence "
                 f"launches, expected {model.n_exits}")
        check_launched(f"algorithm 1 {ths} plain", res[False][2], set())
        check_equal(f"algorithm 1 {ths} predictions", res[True][0],
                    res[False][0])
        check_close(f"algorithm 1 {ths} confidences", res[True][1],
                    res[False][1], 0.0, 1e-5)
        out.append({"thresholds": list(ths),
                    "predictions": res[True][0].tolist(),
                    "max_abs_err": max_err(res[True][1], res[False][1]),
                    "launches": launches,
                    **_algorithm1_times(fns, ths, x)})
    emit({"phase": "algorithm1", "config": "qwen2.5-3b", "prompts": [4, S],
          "runs": out})
    return out[0]["launches"]


def _algorithm1_times(fns, ths, x):
    """One ``cascade_infer_sequential`` call with the confidence kernel,
    then one with the plain measure (the components' logits already
    computed): each call's wall time (host clock, synchronised), and, in a
    second call behind a spin kernel that keeps the device busy while the
    host enqueues, the CUDA-event device time of its 3 confidence
    computations (the decider's ``measure_one``: the kernel's launch, or
    the plain measure's ops)."""
    import torch
    from repro_torch.core.cascade import cascade_infer_sequential
    from repro_torch.core.policy import ExitDecider
    out = {}
    for use_kernels, key in ((True, "kernel"), (False, "plain")):
        decider = ExitDecider("softmax_max", use_kernels=use_kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cascade_infer_sequential(fns, ths, x, decider)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        spans = []
        measure_one = decider.measure_one

        def timed(logits):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            res = measure_one(logits)
            b.record()
            spans.append((a, b))
            return res

        decider.measure_one = timed
        torch.cuda._sleep(100_000_000)
        cascade_infer_sequential(fns, ths, x, decider)
        torch.cuda.synchronize()
        if len(spans) != len(fns):
            fail(f"algorithm 1 {ths} {key}: {len(spans)} confidence "
                 f"computations timed, expected {len(fns)}")
        each = [a.elapsed_time(b) for a, b in spans]
        out[key] = {"wall_s": wall, "confidence_device_ms": sum(each),
                    "confidence_device_ms_each": each}
    return out


def phase_route_parity():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    base = get_config("qwen2.5-3b").replace(
        n_layers=4, dtype="float32").with_cascade(exit_mode="cond_batch")
    model = build_model(base, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(1))
    reqs = make_requests(8, (128, 256), base.vocab_size, 8, seed=1)
    kw = dict(lane_batch=4, n_lanes=2, cache_len=512)

    def run(cfg):
        fin, st, _, launches = serve(cfg, build_model(cfg, device=DEV),
                                     params, reqs, **kw)
        return _streams(fin), st, launches

    gather_launches = None
    for ths in ((0.9, 0.9, 0.0), (0.0, 0.0, 0.0)):
        streams = {}
        # kernel and plain routes, dense and paged (slice 3), one cohort;
        # paged at block size 16 (decode reads through the table) and 64
        # (too large for the paged route: the gather + the dense route)
        for use_kernels in (True, False):
            for paged in (0, 16, 64):
                cfg = base.replace(use_kernels=use_kernels).with_cascade(
                    thresholds=ths)
                if paged:
                    cfg = paged_config(cfg, block_size=paged)
                streams[use_kernels, paged], _, launches = run(cfg)
                expect = (SLICE1 | ({"paged_gather"} if paged == 64
                                    else set())
                          if use_kernels else set())
                check_launched(f"route parity {ths} kernels={use_kernels} "
                               f"paged={paged}", launches, expect)
                if use_kernels and paged == 64:
                    if launches["paged_gather"] != \
                            launches["decode_attention"]:
                        fail(f"route parity {ths} block size 64: "
                             f"{launches['paged_gather']} gathers for "
                             f"{launches['decode_attention']} decode "
                             f"attentions")
                    if ths[0] > 0:
                        gather_launches = launches
        want = streams[True, 0]
        for key, got in streams.items():
            if got != want:
                bad = [rid for rid in want if got.get(rid) != want[rid]]
                fail(f"route parity {ths}: kernels={key[0]} paged={key[1]} "
                     f"differs from the dense kernel route on {bad}")
        emit({"phase": "route_parity", "n_layers": 4, "dtype": "float32",
              "thresholds": list(ths), "requests": len(want),
              "identical": True, "paged_identical": True})

    # slice 2: cohorts, megakernel, layouts, select + cohort scatter
    on = base.replace(use_kernels=True).with_cascade(
        n_cohorts=2, cohort_layout="major").with_kernel_tune(
        megakernel=True, cohort_scatter=True)
    zero = on.with_cascade(thresholds=(0.0, 0.0, 0.0))
    calib = serve(zero, build_model(zero, device=DEV), params, reqs,
                  **kw)[0]
    th, quantile = mixed_threshold(
        calib, lambda th: run(on.with_cascade(
            thresholds=(th, 0.9, 0.0)))[1]["cohort_dispatch"],
        "cohort parity")
    scatter_launches = None
    for ths in ((0.9, 0.9, 0.0), (0.0, 0.0, 0.0), (th, 0.9, 0.0)):
        ref_cfg = on.with_cascade(thresholds=ths)
        want, st, launches = run(ref_cfg)
        check_launched(f"cohort parity {ths}", launches,
                       SLICE1 | {"megakernel"})
        variants = {
            "megakernel_off": ref_cfg.with_kernel_tune(
                megakernel=False, cohort_scatter=False),
            "one_cohort": ref_cfg.with_cascade(n_cohorts=1),
            "copy_layout": ref_cfg.with_cascade(cohort_layout="copy"),
            "select_scatter": ref_cfg.with_cascade(exit_mode="select"),
        }
        # slice 3: each variant again on the paged layout, and the paged
        # reference configuration itself
        variants.update({f"paged_{name}": paged_config(cfg)
                         for name, cfg in variants.items()})
        variants["paged"] = paged_config(ref_cfg)
        rec = {"phase": "route_parity_cohorts", "n_layers": 4,
               "dtype": "float32", "thresholds": list(ths),
               "threshold_quantile": quantile if ths[0] == th else None,
               "dispatch": st["cohort_dispatch"], "identical": {}}
        for name, cfg in variants.items():
            got, vst, vl = run(cfg)
            expect = SLICE1 | ({"megakernel"} if cfg.kernel_tune.megakernel
                               else set())
            if name.startswith("paged"):
                # a paged store has no cohort rows: no cohort scatter
                if name == "paged_select_scatter" and \
                        vst["cohort_dispatch"]["mixed"] == 0:
                    fail(f"cohort parity {ths}: paged select mode never "
                         f"took the mixed (per-cohort) path")
            elif name == "select_scatter":
                expect = expect | {"cohort_scatter"}
                if vst["cohort_dispatch"]["mixed"] == 0:
                    fail(f"cohort parity {ths}: select mode never took the "
                         f"mixed (per-cohort) path")
                scatter_launches = vl
            check_launched(f"cohort parity {ths} {name}", vl, expect)
            if got != want:
                bad = [rid for rid in want if got.get(rid) != want[rid]]
                fail(f"cohort parity {ths}: {name} differs on requests {bad}")
            rec["identical"][name] = True
        if ths[0] == th and st["cohort_dispatch"]["mixed"] == 0:
            fail(f"cohort parity {ths}: cond_batch never took the mixed "
                 f"branch")
        emit(rec)

    # slice 8: the device runtime against the host runtime, select and
    # cond_batch, dense and paged, at the mixed vector
    mixed_cfg = on.with_cascade(thresholds=(th, 0.9, 0.0))
    rec = {"phase": "route_parity_device_runtime", "n_layers": 4,
           "dtype": "float32", "thresholds": [th, 0.9, 0.0], "chunk": 8,
           "identical": {}}
    for mode in ("select", "cond_batch"):
        for paged in (False, True):
            cfg = mixed_cfg.with_cascade(exit_mode=mode)
            if paged:
                cfg = paged_config(cfg)
            got = {}
            for runtime in ("host", "device"):
                fin, st, _, launches = serve(cfg, build_model(cfg, device=DEV),
                                             params, reqs, runtime=runtime,
                                             chunk=8, **kw)
                got[runtime] = (_streams(fin), st["carried_segments_run"],
                                launches)
            tag = f"device runtime parity {mode} paged={paged}"
            for i, what in enumerate(("streams", "segments_run",
                                      "launches")):
                if got["host"][i] != got["device"][i]:
                    fail(f"{tag}: {what} differ between the runtimes")
            if mode == "select" and not paged and \
                    not got["device"][2]["cohort_scatter"]:
                fail(f"{tag}: the cohort scatter never launched")
            rec["identical"][f"{mode}, {'paged' if paged else 'dense'}"] = \
                True
    emit(rec)
    del params
    torch.cuda.empty_cache()
    return scatter_launches, gather_launches


def phase_cli():
    """The port's serve CLI on the paged layout, as a user starts it: one
    subprocess on the card, which must exit 0."""
    import os
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "qwen2.5-3b", "--smoke", "--cache-layout", "paged", "--cohorts",
           "2", "--exit-mode", "cond_batch"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"serve CLI exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    pool = [ln for ln in proc.stderr.splitlines() if "paged pool" in ln]
    emit({"phase": "cli", "command": " ".join(cmd[1:]), "rc": 0,
          "seconds": time.perf_counter() - t0,
          "pool_line": pool[-1] if pool else None})


def main() -> int:
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout (src/repro_torch "
              "not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import build
    from repro_torch.utils import resolve_device

    dev = resolve_device(DEV)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build_times = build.build_all(verbose=True)
    emit({"phase": "card", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "build_seconds": time.perf_counter() - t0,
          "build_seconds_per_kernel": build_times})

    gen = torch.Generator(device=DEV).manual_seed(0)
    checks = {"rmsnorm": phase_rmsnorm(dev, gen),
              "flash_attention": phase_flash(dev, gen),
              "decode_attention": phase_decode(dev, gen),
              "exit_update": phase_exit_update(dev, gen),
              "confidence": phase_confidence(dev, gen),
              "megakernel": phase_megakernel(dev, gen),
              "cohort_scatter": phase_cohort_scatter(dev, gen),
              "paged_gather": phase_paged_gather(dev, gen)}
    for name, cases in checks.items():
        emit({"phase": "kernel_check", "kernel": name, "cases": cases})

    # each kernel's launches come from the path that runs it: slice 1's
    # one-cohort run, slice 2's cohort run at the mixed threshold vector,
    # Algorithm 1, slice 3's paged run at capacity, and the select-mode
    # cohort run of the parity phase
    slice1, slice1_routes = phase_full_width()
    (cohorts, cohort_routes), model, params, records = \
        phase_full_width_cohorts()
    algorithm1 = phase_algorithm1(model, params)
    paged_routes = phase_full_width_paged(params)
    device_runtime = phase_device_runtime(params, records[2]["thresholds"][0])
    autotune = phase_autotune(params)
    del model, params
    torch.cuda.empty_cache()
    select, gathers = phase_route_parity()
    phase_cli()
    paths = {"rmsnorm": ("slice 1 full width (0.9, 0.9, 0.0)", slice1),
             "exit_update": ("slice 1 full width (0.9, 0.9, 0.0)", slice1),
             "decode_attention": ("slice 1 full width (0.9, 0.9, 0.0)",
                                  slice1),
             "flash_attention": ("slice 1 full width (0.9, 0.9, 0.0)",
                                 slice1),
             "megakernel": ("slice 2 full width, mixed thresholds", cohorts),
             "confidence": ("algorithm 1, full width", algorithm1),
             "cohort_scatter": ("route parity, select mode, 2 cohorts",
                                select),
             "paged_gather": ("route parity, paged at block size 64 (the "
                              "paged decode route takes 16), 4 layers f32, "
                              "(0.9, 0.9, 0.0)", gathers)}

    # the headline case of each kernel: the serving path's bf16 shape;
    # paged_gather's is the f32 block-64 store its launches come from
    headline = {
        "rmsnorm": lambda c: c["shape"] == [4, D_MODEL]
        and c["route"] == "warp",
        "flash_attention": lambda c: c["shape"][3] == 256 and not c["window"],
        "decode_attention": lambda c: c["live"] == [1, 1, 1, 1]
        and c["route"] == "dense",
        "exit_update": lambda c: c["shape"][0] == 4,
        "confidence": lambda c: True,
        "megakernel": lambda c: c["shape"][0] == 4 and c["route"] == "tc",
        "cohort_scatter": lambda c: c["route"] == "slot",
        "paged_gather": lambda c: c["shape"] == [list(GATHER_STORE),
                                                 list(GATHER_TABLE)],
    }
    # the launches on the path by route, for the kernels that have two
    paged_case = next(c for c in checks["decode_attention"]
                      if c["dtype"] == "bfloat16" and c["route"] == "paged")
    extra = {"flash_attention": {"routes": slice1_routes["flash_attention"]},
             "rmsnorm": {"routes": slice1_routes["rmsnorm"]},
             "megakernel": {"routes": cohort_routes},
             # decode's dense route on slice 1's path, its paged route on
             # slice 3's (paged at capacity, (0.9, 0.9, 0.0))
             "decode_attention": {
                 "routes": {
                     "dense": slice1_routes["decode_attention"]["dense"],
                     "paged": paged_routes["paged"]},
                 "paged_route": {k: paged_case[k] for k in (
                     "ms", "dense_ms", "gather_and_dense_ms", "plain_ms",
                     "library_ms", "bound_ms", "bound_by", "max_abs_err")}}}
    rows = []
    for name, cases in checks.items():
        c = next(c for c in cases if headline[name](c) and (
            c["dtype"] == "bfloat16" or name == "paged_gather"))
        path, launches = paths[name]
        rows.append({"name": name, "route": "cuda",
                     "source": SOURCES[name], "replaces": REPLACES[name],
                     "launches": launches[name], "path": path,
                     # launches under the device runtime (replays: each IF
                     # body's captured launches times its executions), in
                     # the device-runtime phase's run named here, equal to
                     # the host runtime's on the same requests
                     "launches_device_runtime": device_runtime[name],
                     "path_device_runtime": "device runtime, dense 1 "
                     "cohort, (0.9, 0.9, 0.0), 8 requests x 32 tokens",
                     # launches on the autotune path: the device runtime
                     # with autotune on at (0, 0, 0) (shadow steps observe
                     # the skipped segments), one cohort and two with the
                     # megakernel
                     "launches_autotune": {v: n[name]
                                           for v, n in autotune.items()},
                     "max_abs_err": max(x["max_abs_err"] for x in cases),
                     "ms": c["ms"], "plain_ms": c["plain_ms"],
                     "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                     "library_ms": c["library_ms"],
                     **extra.get(name, {}),
                     # rows 3 and 4 read δ̂ from device memory ("ms"):
                     # bit-equality with δ̂ given as a float, eager and
                     # under replays that rewrite δ̂
                     **({"device_threshold": c["device_threshold"]}
                        if "device_threshold" in c else {}),
                     "headline_case": {k: c[k] for k in c
                                       if k not in ("ms", "plain_ms",
                                                    "bound_ms", "bound_by",
                                                    "library_ms",
                                                    "device_threshold")}})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
