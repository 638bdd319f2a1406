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
   whole tile, after a one-hot layout diagnostic; tc past d 4096 at
   deepseek-coder-33b's (B, 7168) x (7168, 32256) for B = 1, 4, 8, its
   normalised rows bit for bit against rmsnorm's block kernel, its ints
   against the unfused route's, δ̂ in device memory replayed in a CUDA
   graph, and the cuda_core route timed beside it; CUDA cores for f32, a
   vocab not a multiple of 8 and B = 16 at d 7168), rmsnorm (warp at the
   model width in bf16
   and f32, block for a width that is not a whole number of 16-byte
   chunks and for 32 chunks a lane);
   decode attention's split-KV at its edges (a short last chunk, chunks
   with no visible key, a slot that sees no key, every slot dead), its
   bits repeated from run to run, and so the megakernel's; decode
   attention's paged route (a layer slice of a stacked store read through
   a block table with trash, duplicate and all-trash rows) bit for bit
   against the dense route over ``paged_gather_kv``'s views; the paged
   gather (bulk copies) at the serving store, the block-64 stores and
   qwen2.5-3b's 134 MB layer store of block size 64 for 16 slots, with
   trash, duplicate and all-trash rows, CUDA-event and profiler device
   times, a CUDA graph's replays over a rewritten table, and an unaligned
   store refused; exit_update's
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
   takes the paged route, so no paged_gather launches; then the paged
   cache at block size 64 (slice 13), which the paged decode route does
   not take: 2 cohorts, major, cond_batch on the device and host
   runtimes in turns at (0.9, 0.9, 0.0) and (0, 0, 0), every decode
   attention on the dense route over views paged_gather gathers (one
   gather a decode attention), the streams the dense layout's;
7. slice 8 at full width cut to RUNTIME_LAYERS: the device runtime
   (chunk 8: a captured CUDA
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
9. slice 9 at full width cut to RUNTIME_LAYERS: autotune (exit
   telemetry with a shadow step
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
11. slice 10, the paper's experiment: CI-RESNET(18) (n = 18, enhance_dim
    128, 10 classes) backtrack-trained (Algorithm 2) in f32 on 4096
    synthetic images for n_e = 6 epochs at a base LR of 0.01; its
    component accuracies, the
    Fig. 3 ε-sweep, Fig. 4's linearity r, the staged evaluation's measured
    wall clock against the dense cascade at ε = 0.10 and 0.02; then
    Algorithm 1 on a 256-image batch, the confidence kernel (3 launches a
    call) against the plain measure;
12. slice 10, full-width training: the train CLI (qwen2.5-3b, 8 steps of
    4 x 64 tokens) in a subprocess, which must exit 0, and its checkpoint
    loaded back bit for bit;
13. slice 11, cross-model escalation: a 12-layer draft of qwen2.5-3b
    (seed 0) in front of the 36-layer model (seed 1), two engines on one
    card — the corners (escalation threshold 0.0: the draft alone; 1.1:
    the 36-layer model alone) bit for bit in host and device runtimes x
    dense and paged; a middle threshold with defers at a token > 0,
    replay accounting and identical streams on both runtimes; the tier
    controller's solves and pushes capturing nothing; yi-9b at full width
    (48 layers, d 4096, vocab 64000) as a restarting second stage, bit
    for bit yi-9b alone; the serve CLI's tier path in a subprocess; and
    phase 2's kernels at yi-9b's shapes;
14. slice 12, the dense family whole: phase 2's kernels at
    deepseek-coder-33b's shapes (GQA group 7, d 7168: rmsnorm's block
    route, the megakernel's tc route past d 4096) and minitron-4b's
    (group 3, vocab 256000: the megakernel's tc route, confidence at its
    16-CTA cap); then deepseek-coder-33b (62 layers, 67 GB of bf16
    weights) and minitron-4b at full width, each alone on the card —
    init time, peak memory, the prefill's and first decode steps' logits
    against the plain path, 8 requests on the host and device runtimes
    in turns with identical streams, and for both 2 cohorts with the
    megakernel at a mixed threshold (deepseek-coder-33b's exit heads on
    the tc route since slice 13), streams equal with it on and off;
15. a 4-layer f32 model of qwen2.5-3b's widths with layernorm, learned
    positions and tied embeddings through the engine, kernels on (the
    megakernel falls back: 0 launches) and off, identical streams;
16. the kernel tile autotuner: both presets swept into a temporary
    directory and loaded back with no sweep; the full-width qwen2.5-3b
    model at cache 1024 in two cells at thresholds that split the exit
    decisions (one cohort; two with the megakernel), each on the default,
    the tuned and other non-default tiles with identical tokens and exit
    depths; and an install after a capture capturing again;
17. slice 14, observability and the fleet tier: qwen2.5-3b at full width
    on the device runtime (chunk 8, lane batch 4, 2 lanes, cache 512) —
    the flight recorder off, on, on and off in turns with identical
    streams, launches, routes, host syncs and captures, complete flights
    on the host runtime and on the paged layout (block 16, 2 cohorts,
    megakernel), the scrape, the metrics server over loopback and the
    trace export, and the recorder-on / off µs per token ratio ("obs");
    then two members on one set of weights ("fleet"): 16 dense requests
    against one 4-lane engine, paged members with member 0 drained in
    migrate mode mid-decode (no request or committed token lost, flights
    on both members, the drain on the trace's fleet track, no block
    held), and autotune members under a TelemetryAggregator whose pushes
    capture nothing; and ``python -m repro_torch.launch.serve --fleet 2
    --drain --obs --trace-out ... --runtime device`` in a subprocess;
18. slice 15, the moe family ("moe"): phase 2's kernels at
    mixtral-8x7b's shapes (decode attention over a ring of 4096 with
    window 4096 past the wrap, flash attention at S 4224 with the window
    live) and qwen3-moe-235b-a22b's (GQA group 16, the megakernel's tc
    route at (4096, 151936)); then mixtral-8x7b cut to 16 of its 32
    layers and qwen3-moe-235b-a22b to 8 of its 94 at their published
    widths, each alone on the card — init time, peak memory, the logits
    against the plain path with the router's choices compared layer by
    layer (the plain path routed on the kernel path's experts; every
    disagreement a near-tie), 8 requests on the host and device runtimes
    in turns, 2 cohorts with the megakernel at a mixed threshold (on and
    off, host and device: the two-way dispatch, never all_run) and, for
    mixtral, 4 requests of 4224 prompt tokens over its 4096 window past
    the ring's wrap on both runtimes;
19. slice 16, the hybrid family ("hybrid"): phase 2's kernels at
    zamba2-1.2b's shapes (rmsnorm (4, 2048) on warp, exit_update (4,
    32000), the megakernel's tc route at (2048, 32000); no attention
    kernel: the shared block's attention is the plain one) and the cohort
    scatter's whole-cohort route over a 5-layer mamba stage's f32 state
    and bf16 conv window; then zamba2-1.2b at full width cut to 19 of its
    38 layers (d 2048, bf16) alone on the card — init time, peak memory, the
    logits against the plain path, 13 requests (one of 300 prompt tokens:
    the padded SSD chunk; a lane re-prefills) on the host and device
    runtimes in turns at (0.9, 0.9, 0.0) and (0, 0, 0), 2 cohorts with the
    megakernel at a mixed threshold (on and off), select mode with the
    cohort scatter and autotune's shadow step there (streams equal to
    cond_batch's), and the paged layout refused;
20. slice 17, the ssm family ("ssm"): phase 2's kernels at xlstm-350m's
    shapes (rmsnorm (4, 1024) on warp, exit_update (4, 50304) over 13
    tiles, the megakernel's tc route at (1024, 50304); no attention
    kernel) and the cohort scatter's whole-cohort route over a 5-layer
    mLSTM stage (f32 C, n, m and the bf16 conv window) and an sLSTM
    stage's four f32 leaves; then xlstm-350m at full width and depth (24
    layers, d 1024, bf16) alone on the card — init time, peak memory, the
    logits against the plain path (gated in f32, where the family's
    amplified rounding stays small; the bf16 paths' drift reported), a
    lane prefill of 4 x 256 tokens
    timed and its device kernels counted, the hybrid phase's 13 requests
    (the 300-token prompt takes the padded mLSTM chunk; a lane
    re-prefills from the caches' init values) on both runtimes in turns
    at (0.9, 0.9, 0.0) and (0, 0, 0), 2 cohorts with the megakernel at a
    mixed threshold (on and off), select mode with the cohort scatter
    (whole-cohort route only) and autotune's shadow step there (streams
    equal to cond_batch's), and the paged layout refused;
21. slice 18, the audio family ("audio"): phase 2's kernels at
    whisper-tiny's shapes (head dim 64: decode attention over the W 448
    ring, flash attention on its CUDA-core route in bf16 at S 256 and
    128; exit_update (4, 51865) over 13 tiles; the cohort scatter's slot
    route over a 2-layer stage's self K/V rings; no rmsnorm or megakernel
    case: the path has neither); then whisper-tiny at full width and
    depth (4 encdec layers, a 4-layer encoder over 1500 frames, bf16)
    alone on the card — init time, peak memory, the logits against the
    plain path over random frames, a lane prefill of 4 x 256 tokens timed
    with the encoder's share, the hybrid phase's 13 requests at cache_len
    448 (a lane re-prefills, its cross K/V rewritten in place) on both
    runtimes in turns at (0.9, 0.9, 0.0) and (0, 0, 0), 2 cohorts with
    the megakernel on at a mixed threshold (0 megakernel launches: the
    layernorm heads take exit_update; streams equal with it off), select
    mode with the cohort scatter (slot route only: the cross K/V are
    read-only leaves) and autotune's shadow step there (streams equal to
    cond_batch's), and the paged layout refused;
22. slice 19, the vlm family ("vlm"): phase 2's kernels at
    llama-3.2-vision-90b's shapes (rmsnorm (4, 8192) on its block route,
    exit_update (4, 128256) over 32 tiles, decode attention at 8 query
    heads a KV head over the W 512 ring, flash attention on wgmma at S
    256 and 128; the megakernel's tc route at (B, 8192) x (8192, 128256)
    for B = 1, 4, 8 on a 6-stage ring and cuda_core at B = 16, against
    cuBLAS + exit_update; the cohort scatter's slot route over a 4-layer
    dense stage's rings); then the model at its published widths cut to
    15 of 100 layers (three xattn layers, bf16, gates drawn non-zero) alone
    on the card — init time, peak memory, the logits against the plain
    path over random images, a lane prefill of 4 x 256 tokens timed with
    the cross K/V projection's share, the hybrid phase's 13 requests (a
    lane re-prefills, its xattn K/V rewritten in place) on both runtimes
    in turns at (0.9, 0.9, 0.0) and (0, 0, 0), 2 cohorts with the
    megakernel at a mixed threshold (every launch on tc; streams equal
    with it off), select mode with the cohort scatter (slot route only:
    the xattn K/V are read-only leaves, a whole segment's at a time) and
    autotune's shadow step there (streams equal to cond_batch's), and the
    paged layout refused (R4);
23. slice 21, the trained cascade ("trained cascade"): qwen2.5-3b at its
    published widths (vocabulary 151936) cut to 6 of its 36 layers,
    trained 300 steps in f32 on the synthetic Markov stream (vocabulary
    256, 8 x 64 tokens) through ``examples/train_llm_cascade_torch.py``'s
    functions, cast to bf16, calibrated (§5) on the bf16 model's held-out
    δ for both rules at ε 0 .. 0.2, and served (device runtime, 2 cohorts,
    select mode, megakernel and cohort scatter; 8 requests of 128 stream
    tokens + 32) at (self, 0.05), (final, 0.05) and full depth — the exit
    histogram, speedup, µs/token, launches and served agreement of each;
    the (final, 0.05) streams equal with kernels off and on the host
    runtime, the full-depth streams equal with kernels off;
24. the four port examples (``examples/*_torch.py``) as subprocesses on
    the card ("examples"), and ``attend_chunked_2d`` with the causal skip
    on and off against ``attend_chunked`` at (1, 4096, 16 / 2, 128) bf16;
25. slice 22, multi-rank serving ("multirank"), ranks as processes
    spawned on the one card (a pool of four, each joining a gloo world
    through a FileStore for each mesh; ``compute_mode`` recorded): (a)
    the IPC all-reduce kernel at (4, 2048) and (1024, 2048) in bf16 and
    f32 on 2 and 4 ranks, bit for bit against the plain rank-ordered sum
    (its arithmetic), the gather against the stacked inputs, µs a call
    and its spread, and PyTorch's gloo all-reduce of the same CUDA tensor
    timed as the library call; (b) the exit kernels' partial route at (4, 151936)
    bf16 in 2 and 4 vocab slices (``exit_update``; the megakernel's tc
    over a (2048, 151936) head) against the unsharded kernels and the
    plain version, carries exact, δ within 1e-5; (c) qwen2.5-3b's widths
    at 4 layers in f32 (2 cohorts, select, megakernel, scatter, autotune
    on) on 1 x 2, 2 x 1 and 2 x 2: every rank's streams, segments_run and
    telemetry equal to the one-rank run's; (d) the main cell, qwen2.5-3b
    at 12 of its 36 layers (36 until slice 24) in bf16 on 1 x 2 (8
    requests x (128/256 + 16)): the exit logits of a prefill and of a
    decode step against the one-rank model's (normwise ≤ 0.1), the
    streams' agreement, µs per token, the collectives a step (counted from
    the replayed IF bodies) beside the dry run's formula, and the launches
    (the all-reduce's included); (e) the moe family on the mesh:
    qwen3-moe's config narrowed in f32 on 1 x 2 (expert parallel and the
    d_ff fallback), 2 x 1, 2 x 2 and 2 x 1 under cond_batch, streams equal
    to one rank's with pairs dropped at prefill and one routing gather a
    data-split call, then its published widths at 4 of 94 layers in bf16
    on 1 x 2 (logits, router near-ties, collectives by op, memory,
    launches); then slices 23 and 25, multi-rank training
    ("multirank_train", on the same ranks): the reduce-scatter kernel,
    ``train()`` of the dense model (qwen2.5-3b's widths at 6 layers) and
    of the moe family (mixtral-8x7b at its published widths cut to 2
    layers on 1 x 2; the narrowed MoE model on 2 x 1, 2 x 2 and on 1 x 2
    with 3 experts) against one rank's ``train()`` — losses, final
    params, replicated leaves' bits, step ms, peak memory, collectives a
    step;
26. the ``{"kernels": [...]}`` line (the all-reduce a row of its own),
    then the final ``{"ok": true, ...}`` line.

Every path is driven with the launch counters set to 0 just before it and
read just after, and fails unless exactly its expected kernels launched;
every prefill of a bf16 model at hd 128 must take flash attention's wgmma
route (whisper's hd 64 its CUDA-core route) and
every exit head the megakernel's tc route (d 7168 included), of an f32 one
their CUDA-core routes, every norm rmsnorm's warp route up to 512 16-byte
chunks a row (the block route beyond), and every decode attention the
paged route on paged stores of block size 16, else the dense one.

Every line of standard output but the ``nvidia-smi`` line is one JSON
object.  Without a CUDA device, or outside a checkout, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEV = "cuda"


def hbm_bytes_per_s() -> float:
    """The H100 SXM data sheet's HBM rate (``launch/roofline.py``)."""
    from repro_torch.launch.roofline import HBM_BW
    return HBM_BW


def peak_flops(dtype: str) -> float:
    """The data sheet's dense rate for ``dtype``: the bf16 / fp16 tensor
    cores, f32 outside them (``launch/roofline.py``)."""
    from repro_torch.launch import roofline
    return (roofline.PEAK_FLOPS_F32 if dtype == "float32"
            else roofline.PEAK_FLOPS)

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
# a shape where the bytes dominate the gather: qwen2.5-3b's layer store at
# block size 64 for 16 slots of a 4096-position ring (16 x 64 blocks and
# the trash block; 134 MB moved for k and v)
GATHER_BIG_STORE = (1025, 64, 2, 128)
GATHER_BIG_TABLE = (16, 64)

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
    t_bytes = bytes_moved / hbm_bytes_per_s()
    t_ops = flops / peak_flops(dtype)
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


# the marker launched beside a profiled call: torch.cuda._sleep's kernel
PROFILER_MARKER = "spin_kernel"
# host seconds of idle before and after the work in each try's window:
# a window that lost a marker is traced once more, padded.  Why windows
# come back without the device's work is not known
PROFILER_PADS = (0.0, 4.0)


def _device_kernels(fn):
    """The device kernels one call of ``fn`` launches, by torch.profiler:
    [(name, count)].  A marker kernel (:data:`PROFILER_MARKER`) launched
    just before the call and just after it shows that the profiler kept
    the device's whole stretch of work: a window without both markers is
    traced once more, with idle host time of :data:`PROFILER_PADS` around
    the work, and then the run fails.  Nothing else runs on the
    device in a window (synchronised before it), so the padding adds no
    kernel.  The markers are left out of the result."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for attempt, pad in enumerate(PROFILER_PADS):
        if attempt:
            print(f"chip_smoke: profiler window {attempt} lost a marker "
                  f"kernel; tracing again with {pad} s of padding",
                  file=sys.stderr)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            torch.cuda._sleep(1000)
            fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(pad)
        kernels = [(e.key, e.count) for e in prof.key_averages()
                   if "CUDA" in str(getattr(e, "device_type", ""))
                   and e.count > 0 and "Activity Buffer" not in e.key]
        if sum(n for k, n in kernels if PROFILER_MARKER in k) == 2:
            return [(k, n) for k, n in kernels if PROFILER_MARKER not in k]
    fail(f"torch.profiler did not keep both marker kernels in any of "
         f"{len(PROFILER_PADS)} windows")


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
        if route(h, head) != "tc":
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


def phase_megakernel_wide(dev, gen, arch="deepseek-coder-33b"):
    """The tc route past d 4096: ``arch``'s exit head in bf16 —
    deepseek-coder-33b's h (B, 7168) x (7168, 32256), or
    llama-3.2-vision-90b's (B, 8192) x (8192, 128256) — at B = 1, 4, 8 on
    tc (its ring 7 stages beside the 112 KB of rows at d 7168, 6 beside
    the 128 KB at d 8192) and B = 16 on cuda_core (the rows alone take
    224 KB and 256 KB).  Against the plain version (ints exact but the
    prediction on tie rows, floats within MEGA_TOL), the normalised rows
    the tc prologue computes (``xn_out``) bit for bit against rmsnorm's
    block-route kernel, the ints against the unfused route's (rmsnorm +
    the head product + exit_update), δ̂ read from device memory and
    replayed in a CUDA graph (B = 4), two calls bit for bit; timed against
    the plain version, cuBLAS + exit_update, and the cuda_core route at
    the same shape (the parent's route there, its kernel unchanged)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import megakernel, ref
    from repro_torch.kernels.exit_update import exit_update
    from repro_torch.kernels.megakernel import exit_head_update
    from repro_torch.kernels.rmsnorm import rmsnorm
    shp = {**DENSE_SHAPES, **VISION_SHAPES}[arch]
    d, V, n_m, bf, name = shp["d"], shp["vocab"], 3, torch.bfloat16, \
        "bfloat16"
    w = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
    head = (0.02 * torch.randn(d, V, generator=gen, device=dev)).to(bf)
    cases = []
    for B, want_route in ((1, "tc"), (4, "tc"), (8, "tc"),
                          (16, "cuda_core")):
        h = torch.randn(B, d, generator=gen, device=dev).to(bf)
        hc = head.clone()
        r1 = 1 if B > 1 else 0
        hc[:, 77] = (ref.ref_rmsnorm(h[r1:r1 + 1], w)[0].float()
                     * 0.05).to(bf)
        carry = _carries(B, n_m, dev)
        live = torch.arange(B, device=dev) % 4 != 2
        ties = _mega_ties(h, w, hc, name)
        tag = f"megakernel d={d} B={B}"
        xn = rmsnorm(h, w)
        errs = []
        for m, pk, decay in ((1, 2, 0.0), (2, 0, 0.8)):
            kw = dict(threshold=0.5, m=m, n_components=n_m, patience_k=pk,
                      ema_decay=decay, live=live)
            got, route = route_of(lambda: exit_head_update(
                h, w, hc, *carry, **kw), exit_head_update)
            if route != want_route or \
                    megakernel.route(h, hc) != want_route:
                fail(f"{tag}: took the {route} route, expected "
                     f"{want_route}")
            want = ref.ref_exit_head_update(h, w, hc, *carry, **kw)
            errs.append(_mega_check(f"{tag} m={m}", got, want, carry, live,
                                    ties, name))
            unfused = ref._pass_dead(
                exit_update(xn @ hc, *carry, **{k: v for k, v in kw.items()
                                                if k != "live"}),
                live, *carry[:6], 0)
            _mega_check(f"{tag} m={m} unfused", got, unfused, carry, live,
                        ties, name)
        err = max(errs)
        extra = {}
        if route == "tc":
            rows = torch.empty_like(h)
            exit_head_update(h, w, hc, *carry, **kw, xn_out=rows)
            torch.cuda.synchronize()
            if not torch.equal(rows, xn):
                fail(f"{tag}: the tc prologue's rows differ from rmsnorm's "
                     f"block route by {max_err(rows, xn):.3e}")
        again = exit_head_update(h, w, hc, *carry, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{tag}: two calls on one input differ")
        if int(got[1][r1]) != 77:
            fail(f"{tag}: the confident row must answer 77, got "
                 f"{int(got[1][r1])}")
        ths = torch.full((n_m,), 0.5, device=dev)
        kw = dict(threshold=ths, m=0, n_components=n_m, live=live)
        if B == 4:

            def check(t, g, w_, ties=ties, carry=carry, live=live):
                _mega_check(t, g, w_, carry, live, ties, name)

            extra["device_threshold"] = threshold_forms(
                tag, functools.partial(exit_head_update, h, w, hc,
                                       live=live),
                functools.partial(ref.ref_exit_head_update, h, w, hc,
                                  live=live), check, carry, n_m)
            # the parent's route at this shape, its kernel unchanged
            real = megakernel.route
            megakernel.route = lambda *a: "cuda_core"
            try:
                extra["cuda_core_ms"] = time_ms(
                    lambda: exit_head_update(h, w, hc, *carry, **kw))
            finally:
                megakernel.route = real

        def library(h=h, hc=hc, carry=carry, ths=ths):
            x = F.rms_norm(h, (d,), w.to(bf), 1e-5)
            return exit_update(x @ hc, *carry, threshold=ths, m=0,
                               n_components=n_m)

        b, by = bound_ms(hc.numel() * 2 + h.numel() * 2 + d * 4 + B * 56,
                         2 * B * d * V, name)
        cases.append({
            **extra, "config": arch, "shape": [B, d, V],
            "dtype": name, "route": route,
            "stages": megakernel.tc_stages(B, d), "live": live.tolist(),
            "tie_rows": int(ties.sum()), "max_abs_err": err,
            "xn_bit_equal_block_rmsnorm": route == "tc",
            "ms": time_ms(lambda: exit_head_update(h, w, hc, *carry, **kw)),
            "plain_ms": time_ms(lambda: ref.ref_exit_head_update(
                h, w, hc, *carry, **kw)),
            "library_ms": time_ms(library),
            "cublas_only_ms": time_ms(
                lambda: F.rms_norm(h, (d,), w.to(bf), 1e-5) @ hc),
            "bound_ms": b, "bound_by": by})
        del hc
    del head
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


def phase_state_scatter(dev, gen, arch="zamba2-1.2b", leaves=None,
                        stage="mamba"):
    """The cohort scatter's whole-cohort route at a stage's state leaves
    (zamba2-1.2b's by default, :data:`HYBRID_STATE_LEAVES`; xlstm-350m's
    mLSTM and sLSTM stages, :data:`XLSTM_STATE_LEAVES`): select mode's
    land of cohort 1 of 2 of the stage, every leaf in one launch, exact
    against the plain version; timed with its bound (each source byte
    read once and written once) and the library copy (one ``copy_`` a
    leaf).  Returns the case."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.cohort_cache import cohort_scatter_tree
    C, c = 2, 1
    leaves = leaves or HYBRID_STATE_LEAVES
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    dst = [torch.randn(shape, generator=gen, device=dev).to(dts[dt])
           for shape, dt in leaves]
    Bc = dst[0].shape[1] // C
    src = [torch.randn((x.shape[0], Bc) + x.shape[2:], generator=gen,
                       device=dev).to(x.dtype) for x in dst]
    want = [x.clone() for x in dst]

    def plain():
        for wd, sd in zip(want, src):
            ref.ref_cohort_scatter(wd, sd, c, C)

    def library():
        for wd, sd in zip(want, src):
            wd[:, c * Bc:(c + 1) * Bc].copy_(sd)

    def kernel():
        cohort_scatter_tree(dst, src, c, C)

    plain()
    kernel()
    torch.cuda.synchronize()
    for a, b in zip(dst, want):
        check_equal(f"cohort_scatter whole {arch} {stage} state", a, b)
    nbytes = 2 * sum(x.numel() * x.element_size() for x in src)
    b, by = bound_ms(nbytes, 0, "float32")
    return {"config": arch, "stage": stage, "route": "whole",
            "shape": [list(x.shape) for x in dst],
            "rows": [list(x.shape) for x in src], "leaves": len(dst),
            "cohort": [c, C], "dtype": " + ".join(sorted({
                dt for _, dt in leaves})), "bytes": nbytes,
            "max_abs_err": max(max_err(a, b) for a, b in zip(dst, want)),
            "ms": time_ms(kernel), "plain_ms": time_ms(plain),
            "library_ms": time_ms(library), "bound_ms": b, "bound_by": by}


def phase_ring_scatter(dev, gen, arch, shape, slot):
    """The cohort scatter's slot route at a stage's self K/V rings of
    ``shape`` (whisper-tiny's, :data:`WHISPER_RING`): select mode's land
    of cohort 1 of 2's rows of ring slot ``slot`` (read from device
    memory) into both leaves in one launch, exact against the plain
    version; timed with its bound and the library copy (one
    ``index_copy_`` a leaf).  Returns the case."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.cohort_cache import cohort_scatter_tree
    C, c = 2, 1
    L, B = shape[:2]
    Bc = B // C
    dst = [torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
           for _ in range(2)]
    src = [torch.randn((L, Bc, 1) + tuple(shape[3:]), generator=gen,
                       device=dev).to(torch.bfloat16) for _ in range(2)]
    at = torch.tensor(slot, device=dev)
    want = [x.clone() for x in dst]

    def plain():
        for wd, sd in zip(want, src):
            ref.ref_cohort_scatter_slot(wd, sd, c, C, at)

    def library():
        for wd, sd in zip(want, src):
            wd[:, c * Bc:(c + 1) * Bc].index_copy_(2, at.view(1), sd)

    def kernel():
        cohort_scatter_tree(dst, src, c, C, slot=at)

    plain()
    kernel()
    torch.cuda.synchronize()
    for a, b in zip(dst, want):
        check_equal(f"cohort_scatter slot {arch}", a, b)
    nbytes = 2 * sum(x.numel() * x.element_size() for x in src)
    b, by = bound_ms(nbytes, 0, "bfloat16")
    return {"config": arch, "route": "slot", "shape": list(shape),
            "rows": list(src[0].shape), "leaves": 2, "slot": slot,
            "cohort": [c, C], "dtype": "bfloat16",
            "max_abs_err": max(max_err(a, b) for a, b in zip(dst, want)),
            "ms": time_ms(kernel), "plain_ms": time_ms(plain),
            "library_ms": time_ms(library), "bound_ms": b, "bound_by": by}


def _device_us(fn, kernel: str, calls: int = 20) -> float:
    """Device µs per call of ``fn`` spent in kernels whose name holds
    ``kernel``, by torch.profiler over ``calls`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", None)
                or getattr(e, "cuda_time_total", 0)
                for e in prof.key_averages() if kernel in e.key)
    return total / calls


def phase_paged_gather(dev, gen):
    """The gather, exact, at the serving store (bf16, f32; block size 16),
    at the block-64 stores (f32: the route-parity run's; bf16: the
    full-width qwen2.5-3b run's, where the paged decode route does not
    take the block size and the gather serves every decode attention) and
    at qwen2.5-3b's layer store of block size 64 for 16 slots of a 4096
    ring (134 MB: the bytes, not the launch, set the time); trash,
    duplicate and all-trash rows, a layer slice of a stacked store, both
    stores in one launch; the CUDA-event time and the profiler's device
    time a call; and one launch captured in a CUDA graph, replayed with
    the table rewritten between replays."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_gather import paged_gather, paged_gather_kv
    cases = []
    for store, tshape, dt in ((PAGED_STORE, PAGED_TABLE, torch.bfloat16),
                              (PAGED_STORE, PAGED_TABLE, torch.float32),
                              (GATHER_STORE, GATHER_TABLE, torch.float32),
                              (GATHER_STORE, GATHER_TABLE, torch.bfloat16),
                              (GATHER_BIG_STORE, GATHER_BIG_TABLE,
                               torch.bfloat16)):
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
        extra = {}
        if store == PAGED_STORE and dt == torch.bfloat16:
            # captured once; each replay reads the table as it then is
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = paged_gather_kv(k, v, table)
            for shift in (1, 2, 0):
                table.copy_(torch.roll(table, shift, 1))
                graph.replay()
                torch.cuda.synchronize()
                for g, x in zip(out, (k, v)):
                    check_equal(f"paged_gather {name} replay",
                                g, ref.ref_paged_gather(x, table))
            extra["graph_replays_bit_equal"] = 3
            del graph, out
        nbytes = 2 * 2 * want[0].numel() * want[0].element_size() + \
            table.numel() * 4
        b, by = bound_ms(nbytes, 0, name)
        cases.append({
            **extra, "shape": [list(store), list(tshape)], "stores": 2,
            "dtype": name, "bytes": nbytes,
            "max_abs_err": max(max_err(g, w) for g, w in zip(got, want)),
            "ms": time_ms(lambda: paged_gather_kv(k, v, table)),
            "device_ms_profiler": 1e-3 * _device_us(
                lambda: paged_gather_kv(k, v, table), "paged_gather"),
            "plain_ms": time_ms(lambda: (ref.ref_paged_gather(k, table),
                                         ref.ref_paged_gather(v, table))),
            "library_ms": time_ms(library),
            "bound_ms": b, "bound_by": by})
        del ks, vs, got, want, one, lib
    torch.cuda.empty_cache()
    return cases


def paged_gather_refuses_unaligned(dev):
    """The bulk copy moves 16-byte aligned bytes only: a store whose base
    or block size is off 16 bytes is refused before the launch (a
    ValueError, no launch counted), never copied another way."""
    import torch
    from repro_torch.kernels.paged_gather import paged_gather
    table = torch.ones((2, 3), dtype=torch.int32, device=dev)
    base = torch.zeros(4 * 16 * 2 * 128 + 4, dtype=torch.bfloat16,
                       device=dev)[4:].view(4, 16, 2, 128)
    odd = torch.zeros((4, 3, 1, 5), dtype=torch.bfloat16, device=dev)
    for tag, store in (("base off 8 bytes", base),
                       ("30-byte blocks", odd)):
        before = paged_gather.launches
        try:
            paged_gather(store, table)
        except ValueError:
            pass
        else:
            fail(f"paged_gather: an unaligned store ({tag}) was copied")
        if paged_gather.launches != before:
            fail(f"paged_gather: a refused store ({tag}) counted a launch")
    return {"refused": ["base off 8 bytes", "30-byte blocks"]}


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


def check_routes(cfg, launches):
    """Every prefill of a bf16 / fp16 model takes flash's wgmma route and
    every exit head the megakernel's tc route (d 7168 included: the
    serving paths' cohorts hold at most 8 rows), of an f32 one their
    CUDA-core routes; every norm of the
    model's width takes rmsnorm's warp route while a row is at most 512
    16-byte chunks, else the block route (d 7168 in bf16); every decode
    attention over paged stores whose block size divides the 32-key tile
    takes the paged route (no gather), any other the dense one.  The
    hybrid and ssm families' paths launch no attention kernel at all
    (:data:`HYBRID`, :data:`SSM`), and the ssm family's cohort scatter
    only its whole-cohort route (it has no ring leaf).  The audio family's
    (:data:`AUDIO`): flash on its CUDA-core route (hd 64: wgmma is hd 128
    only), decode attention dense, no rmsnorm, megakernel or paged_gather
    launch (layernorm heads), the cohort scatter's slot route only (its
    cross K/V are read-only leaves, never landed); the vlm family's
    (:data:`VLM`) the cohort scatter's slot route only too (the xattn
    K/V are read-only).  Returns each kernel's launches by route since
    the counters were last reset."""
    from repro_torch.kernels.decode_attention import TILE, decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.megakernel import exit_head_update
    from repro_torch.kernels.rmsnorm import MAX_CHUNKS, rmsnorm
    f32 = cfg.dtype == "float32"
    paged = (cfg.paged_cache.layout == "paged"
             and TILE % cfg.paged_cache.block_size == 0)
    wide_norm = cfg.d_model * (4 if f32 else 2) > 16 * MAX_CHUNKS
    flash = "cuda_core" if f32 or cfg.resolved_head_dim != 128 else "wgmma"
    if cfg.family == "audio":
        for name in ("rmsnorm", "megakernel", "paged_gather"):
            if launches[name]:
                fail(f"{cfg.name}: {launches[name]} {name} launches on the "
                     f"audio path")
    if cfg.family in ("hybrid", "ssm"):
        for name in ("flash_attention", "decode_attention"):
            if launches[name]:
                fail(f"{cfg.name}: {launches[name]} {name} launches on the "
                     f"{cfg.family} path (it has no attention kernel)")
    out = {}
    if cfg.family in ("ssm", "audio", "vlm"):
        from repro_torch.kernels.cohort_cache import cohort_scatter_tree
        routes = dict(cohort_scatter_tree.launches_by_route)
        only = "whole" if cfg.family == "ssm" else "slot"
        if routes[only] != launches["cohort_scatter"]:
            fail(f"{cfg.name}: cohort_scatter routes {routes}, expected all "
                 f"{launches['cohort_scatter']} launches on {only}")
        out["cohort_scatter"] = routes
    for name, fn, want in (
            ("flash_attention", flash_attention, flash),
            ("megakernel", exit_head_update,
             "cuda_core" if f32 else "tc"),
            ("rmsnorm", rmsnorm, "block" if wide_norm else "warp"),
            ("decode_attention", decode_attention,
             "paged" if paged else "dense")):
        routes = dict(fn.launches_by_route)
        if routes[want] != launches[name]:
            fail(f"{cfg.name} {cfg.dtype}: {name} routes {routes}, expected "
                 f"all {launches[name]} launches on {want}")
        out[name] = routes
    return out


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
    for name, routes in check_routes(cfg, launches).items():
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


def phase_paged_gather_full_width(params):
    """The gather's serving path at full width: qwen2.5-3b with the paged
    cache at block size 64, which the paged decode route does not take (it
    reads block sizes dividing its 32-key tile), so every decode attention
    takes the dense route over views ``paged_gather_kv`` gathers first —
    one gather launch per decode attention call.  2 cohorts, major,
    cond_batch, lane batch 4, 2 lanes, cache_len 512, chunk 8; the 8
    requests of phase 3 at (0.9, 0.9, 0.0) and (0, 0, 0) on the device and
    host runtimes in turns (identical streams, launches and routes), the
    streams equal to the dense layout's (device runtime).  Returns the
    device runtime's launches at (0.9, 0.9, 0.0)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    base = get_config("qwen2.5-3b").replace(use_kernels=True).with_cascade(
        exit_mode="cond_batch", n_cohorts=2, cohort_layout="major")
    reqs = make_requests(8, (128, 256), base.vocab_size, 16, seed=0)
    out = None
    for ths in ((0.9, 0.9, 0.0), (0.0, 0.0, 0.0)):
        dense = base.with_cascade(thresholds=ths)
        cfg = paged_config(dense, block_size=64)
        tag = f"paged block 64 {ths}"
        turns, dev_launches, streams = _runtime_turns(
            tag, cfg, build_model(cfg, device=DEV), params, reqs,
            ("device", "host"))
        launches = turns["launches"]
        check_launched(tag, launches, SLICE1 | {"paged_gather"})
        if launches["paged_gather"] != launches["decode_attention"]:
            fail(f"{tag}: {launches['paged_gather']} gathers for "
                 f"{launches['decode_attention']} decode attentions")
        fin = serve(dense, build_model(dense, device=DEV), params, reqs,
                    runtime="device", **DENSE_ENGINE)[0]
        if _streams(fin) != streams:
            fail(f"{tag}: the paged streams differ from the dense layout's")
        emit({"phase": "paged_gather_full_width", "config": "qwen2.5-3b",
              "n_layers": base.n_layers, "dtype": base.dtype,
              "n_cohorts": 2, "cohort_layout": "major",
              "exit_mode": "cond_batch", "block_size": 64,
              "thresholds": list(ths), "streams_equal_dense": True,
              "turns": turns})
        if out is None:
            out = dev_launches
    return out


# the depth of the device runtime's and autotune's cells: qwen2.5-3b's
# widths cut to 6 of its 36 layers, the trained cell's cut (slice 23 cut
# them for the script's time limit: the host runtime they are held
# against costs ~12x the device runtime a layer); each draws its own
# seed-0 weights
RUNTIME_LAYERS = 6


def _runtime_cell():
    """qwen2.5-3b cut to :data:`RUNTIME_LAYERS`, kernels on, cond_batch,
    and its seed-0 params on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    base = get_config("qwen2.5-3b").replace(
        n_layers=RUNTIME_LAYERS, use_kernels=True).with_cascade(
            exit_mode="cond_batch")
    params = build_model(base, device=DEV).init(
        torch.Generator(device=DEV).manual_seed(0))
    return base, params


def phase_device_runtime(mixed):
    """Slice 8's path at full width cut to :data:`RUNTIME_LAYERS`
    (:func:`_runtime_cell`): the device runtime (K = 8 tokens a
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
    :func:`serve`).  ``mixed`` is phase 4's vector, found on the 36-layer
    model.  Returns the launches of the device runtime's dense one-cohort
    run at (0.9, 0.9, 0.0)."""
    import statistics as stats_mod
    import torch
    from repro_torch.models.model import build_model
    base, params = _runtime_cell()
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


# ---------------------------------------------------------------------------
# slice 20: the launch layer — the device mesh, the dry run, the card's peaks
# ---------------------------------------------------------------------------

# the mesh phase's engine: phase 4's lanes, three replayed chunks a lane
MESH_ENGINE = dict(lane_batch=4, n_lanes=2, cache_len=512, chunk=8)
MESH_NEW_TOKENS = 32
# peak device memory with the mesh against without (placing copies nothing)
MESH_PEAK_SLACK = 64 << 20
# the mesh_train phase's depth: 6 of qwen2.5-3b's 36 layers (slice 23 cut
# it to keep the script near its time with the multi-rank train phase)
MESH_TRAIN_LAYERS = 6


def _two_rank_refusals(cfg, model, params):
    """A shape-only mesh of two ranks asked of the engine and of the
    trainer's placement, and the production layout in a world of one:
    each refused, by name (a MoE config on a real two-rank mesh is phase
    "multirank_train"'s, :func:`_mr_train_refusals`)."""
    from repro_torch.launch.mesh import AbstractMesh, production_device_mesh
    from repro_torch.launch.train import place_on_mesh
    two = AbstractMesh((2, 1), ("data", "model"))
    out = {}
    for what, call in (
            ("engine", lambda: make_engine(cfg, model, params,
                                           runtime="device", mesh=two,
                                           **MESH_ENGINE)),
            ("train", lambda: place_on_mesh(two, cfg, {}))):
        try:
            call()
            fail(f"mesh: a 2-rank mesh was not refused by the {what}")
        except NotImplementedError as err:
            out[what] = str(err)
        if "2 ranks" not in out[what] or "multi-rank" not in out[what]:
            fail(f"mesh: the {what}'s refusal {out[what]!r}")
    try:
        production_device_mesh(DEV)
        fail("mesh: the production mesh was built in a world of 1")
    except RuntimeError as err:
        out["production"] = str(err)
    if "256 ranks" not in out["production"]:
        fail(f"mesh: the production refusal {out['production']!r}")
    return out


def phase_mesh(model, params, mixed, smi):
    """The paper's serving path through a 1x1 device mesh
    (``make_host_mesh("cuda")``) at full width: qwen2.5-3b, 2 cohorts,
    major layout, select mode, megakernel and cohort scatter, the device
    runtime, phase 4's 8 prompts with 32 new tokens each at (mixed, 0.9,
    0.0), served with ``mesh=None`` and with the mesh in turns (none,
    mesh, mesh, none).  Fails unless tokens and exits are equal bit for
    bit, every kernel's launch count and route, the captures and the host
    syncs (one a lane chunk) are equal, each lane's carry was placed on
    the mesh once, and the peak device memory with the mesh is within
    :data:`MESH_PEAK_SLACK` of without; then a mesh of two ranks is
    refused by the engine, the trainer and the production layout.  Returns
    the launches of the first mesh run."""
    import statistics as stats_mod
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.kernels.cohort_cache import cohort_scatter_tree
    t_phase = time.perf_counter()
    cfg = get_config("qwen2.5-3b").replace(use_kernels=True).with_cascade(
        exit_mode="select", n_cohorts=2, cohort_layout="major",
        thresholds=(mixed, 0.9, 0.0)).with_kernel_tune(
            megakernel=True, cohort_scatter=True)
    mesh = make_host_mesh(DEV)
    reqs = make_requests(8, (128, 256), cfg.vocab_size, MESH_NEW_TOKENS,
                         seed=0)
    runs = {"none": [], "mesh": []}
    ref = mesh_launches = None
    for which in ("none", "mesh", "mesh", "none"):
        tag = f"mesh phase ({which})"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        engine = make_engine(cfg, model, params, runtime="device",
                             mesh=mesh if which == "mesh" else None,
                             **MESH_ENGINE)
        fin, st, secs, launches = serve(cfg, model, params, reqs,
                                        engine=engine)
        peak = torch.cuda.max_memory_allocated()
        if sorted(fin) != list(range(len(reqs))) or any(
                len(r["tokens"]) != MESH_NEW_TOKENS for r in fin.values()):
            fail(f"{tag}: not every request got its {MESH_NEW_TOKENS} "
                 "tokens")
        check_launched(tag, launches,
                       SLICE1 | {"megakernel", "cohort_scatter"})
        if st["host_syncs"] != st["decode_dispatches"]:
            fail(f"{tag}: {st['host_syncs']} host syncs for "
                 f"{st['decode_dispatches']} lane chunks")
        placed = len(engine.loop.placed)
        if placed != (MESH_ENGINE["n_lanes"] if which == "mesh" else 0):
            fail(f"{tag}: {placed} lane carries placed on the mesh")
        got = {"streams": _streams(fin), "launches": launches,
               "captures": st["captures"],
               "segments": st["carried_segments_run"],
               "routes": {k: st[k] for k in st if k.endswith("_routes")},
               "scatter_routes": dict(cohort_scatter_tree.launches_by_route)}
        if ref is None:
            ref = got
        for key, what in got.items():
            if what != ref[key]:
                fail(f"{tag}: {key} differ from mesh=None's: {what} "
                     f"against {ref[key]}")
        if which == "mesh" and mesh_launches is None:
            mesh_launches = launches
        n_tok = sum(len(r["tokens"]) for r in fin.values())
        runs[which].append({
            "decode_us_per_token": st["wallclock_us_per_token"],
            "tokens_per_s": n_tok / secs, "seconds": secs,
            "host_syncs": st["host_syncs"],
            "decode_dispatches": st["decode_dispatches"],
            "captures": st["captures"], "compile_seconds":
                st["compile_seconds"], "placed_lanes": placed,
            "max_memory_allocated": peak,
            "cohort_dispatch": st["cohort_dispatch"]})
        del engine
        torch.cuda.empty_cache()
    peaks = {w: max(r["max_memory_allocated"] for r in rr)
             for w, rr in runs.items()}
    if abs(peaks["mesh"] - peaks["none"]) > MESH_PEAK_SLACK:
        fail(f"mesh: peak memory {peaks['mesh']} with the mesh against "
             f"{peaks['none']} without")
    refusals = _two_rank_refusals(cfg, model, params)
    med = {w: stats_mod.median(r["decode_us_per_token"] for r in rr)
           for w, rr in runs.items()}
    emit({"phase": "mesh", "config": "qwen2.5-3b", "n_layers": cfg.n_layers,
          "dtype": cfg.dtype, "mesh": {"data": 1, "model": 1},
          "mesh_backend": torch.distributed.get_backend(),
          "n_cohorts": 2, "cohort_layout": "major", "exit_mode": "select",
          "thresholds": [mixed, 0.9, 0.0], **MESH_ENGINE,
          "requests": len(reqs), "max_new_tokens": MESH_NEW_TOKENS,
          "order": "none, mesh, mesh, none", "identical": True,
          "none": runs["none"], "mesh": runs["mesh"],
          "decode_us_per_token_median": med,
          "max_memory_allocated": peaks, "launches": ref["launches"],
          "routes": {**ref["routes"],
                     "cohort_scatter_routes": ref["scatter_routes"]},
          "refusals": refusals,
          "phase_seconds": time.perf_counter() - t_phase,
          "nvidia_smi": smi})
    return mesh_launches


def phase_mesh_train(smi):
    """``launch.train`` at phase "train"'s widths (qwen2.5-3b cut to
    :data:`MESH_TRAIN_LAYERS` layers, 8 steps, batch 4, seq 64) with no
    mesh and with its params and AdamW state placed on the 1x1 device mesh
    (no mesh, mesh): the losses equal bit for bit, and the peak memory
    within :data:`MESH_PEAK_SLACK`."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train
    t_phase = time.perf_counter()
    cfg = get_config("qwen2.5-3b").replace(n_layers=MESH_TRAIN_LAYERS)
    mesh = make_host_mesh(DEV)
    out = {}
    for which in ("none", "mesh"):
        _free_card()
        torch.cuda.reset_peak_memory_stats()
        params, _, summary = train(cfg, torch.device(DEV), 8, 4, 64,
                                   mesh=mesh if which == "mesh" else None,
                                   log_every=8)
        del params
        out[which] = summary
    _free_card()
    # the phases' world of one rank ends here
    torch.distributed.destroy_process_group()
    if out["mesh"]["losses"] != out["none"]["losses"]:
        fail(f"mesh train: losses {out['mesh']['losses']} with the mesh, "
             f"{out['none']['losses']} without")
    peaks = {w: s["max_memory_allocated"] for w, s in out.items()}
    if abs(peaks["mesh"] - peaks["none"]) > MESH_PEAK_SLACK:
        fail(f"mesh train: peak memory {peaks}")
    emit({"phase": "mesh_train", "config": "qwen2.5-3b",
          "n_layers": MESH_TRAIN_LAYERS, "steps": 8,
          "batch": 4, "seq": 64, "order": "none, mesh",
          "losses_bit_equal": True, "losses": out["mesh"]["losses"],
          "step_ms": {w: s["step_ms"] for w, s in out.items()},
          "max_memory_allocated": peaks,
          "phase_seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})


# the dry run's combinations on the host: the serving cell's decode at the
# serve1d layout, and training at the default (FSDP) layout
DRYRUN_COMBOS = (("qwen2.5-3b", "decode_32k", "serve1d", None),
                 ("qwen2.5-3b", "train_4k", "default", 4))


def phase_dryrun():
    """The dry run of :data:`DRYRUN_COMBOS` on the 16x16 production mesh,
    shape-only on the host (fake tensors, no process group), and each
    record's roofline row from the H100 data sheet's constants.  A
    combination's fourth field cuts its depth (widths as published):
    train_4k's to 4 of 36 layers since slice 21, for the script's time
    limit — its trace takes ``pick_attend``'s query-and-key chunked path,
    32 chunk steps a layer."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch import roofline
    from repro_torch.launch.dryrun import adjust_config, lower_combo
    for arch, shape, mode, layers in DRYRUN_COMBOS:
        cfg = None if layers is None else adjust_config(
            get_config(arch).replace(n_layers=layers), INPUT_SHAPES[shape])
        rec = lower_combo(arch, shape, False, param_mode=mode,
                          cfg_override=cfg)
        t = roofline.terms(rec)
        if not rec["ok"] or t is None or not rec["flops"] > 0:
            fail(f"dryrun {arch} {shape} {mode}: {rec}")
        emit({"phase": "dryrun", "arch": arch, "shape": shape,
              "param_mode": mode, "mesh": rec["mesh"], "ok": rec["ok"],
              "n_layers": layers or get_config(arch).n_layers,
              "published_layers": get_config(arch).n_layers,
              "trace_seconds": rec["t_lower_s"],
              "argument_bytes_per_device":
                  rec["memory"]["argument_size_in_bytes"],
              "bytes_accessed_per_device": rec["bytes_accessed"],
              "flops_per_device": rec["flops"],
              "collective_bytes": rec["collective_bytes"],
              "model_flops": rec["model_flops"],
              "roofline_predicted": t,
              "roofline_row": roofline.table({(arch, shape): rec})
              .splitlines()[-1]})


PEAK_COPY_BYTES = 1 << 30
PEAK_GEMM = 8192


def phase_peaks(dev, gen, smi):
    """What the card reaches against the data sheet's constants: a
    device-to-device copy of :data:`PEAK_COPY_BYTES` (read + write bytes
    over its time) and a :data:`PEAK_GEMM`-cubed bf16 ``torch.mm``
    (2·N³ over its time), each the median of CUDA-event intervals."""
    import torch
    from repro_torch.launch import roofline
    a = torch.empty(PEAK_COPY_BYTES, dtype=torch.uint8, device=dev)
    b = torch.empty_like(a)
    copy_ms = time_ms(lambda: b.copy_(a), iters=20)
    del a, b
    n = PEAK_GEMM
    x = torch.randn((n, n), generator=gen, device=dev).to(torch.bfloat16)
    y = torch.randn((n, n), generator=gen, device=dev).to(torch.bfloat16)
    gemm_ms = time_ms(lambda: torch.mm(x, y), iters=20)
    del x, y
    torch.cuda.empty_cache()
    copy_rate = 2 * PEAK_COPY_BYTES / (copy_ms * 1e-3)
    gemm_rate = 2 * n ** 3 / (gemm_ms * 1e-3)
    if copy_rate > 1.05 * roofline.HBM_BW or gemm_rate > 1.05 * \
            roofline.PEAK_FLOPS:
        fail(f"peaks: {copy_rate:.3g} B/s and {gemm_rate:.3g} FLOP/s "
             "exceed the data sheet: the timing is wrong")
    emit({"phase": "peaks", "copy_bytes": PEAK_COPY_BYTES,
          "copy_ms": copy_ms, "copy_bytes_per_s": copy_rate,
          "datasheet_hbm_bytes_per_s": roofline.HBM_BW,
          "copy_share": copy_rate / roofline.HBM_BW,
          "gemm": [n, n, n], "gemm_dtype": "bfloat16", "gemm_ms": gemm_ms,
          "gemm_flops_per_s": gemm_rate,
          "datasheet_bf16_flops_per_s": roofline.PEAK_FLOPS,
          "gemm_share": gemm_rate / roofline.PEAK_FLOPS,
          "nvidia_smi": smi})


AUTOTUNE = dict(enabled=True, bins=32, shadow_every=4)


def phase_autotune():
    """Slice 9's path at full width cut to :data:`RUNTIME_LAYERS`
    (:func:`_runtime_cell`; dense, lane_batch 4, 2 lanes,
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
    from repro_torch.models.model import build_model
    base, params = _runtime_cell()
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
                  "n_layers": base.n_layers, "dtype": base.dtype,
                  "variant": name,
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


# ---------------------------------------------------------------------------
# slice 10: the paper's experiment and training on the card
# ---------------------------------------------------------------------------

# the paper phase's data and training, cut from the paper's CIFAR runs
# (50000 images, 64000 SGD steps) to under a minute of card time: 4096
# synthetic training images, n_e = 6 epochs (phases of 1.25 n_e, then n_e
# a head).  The base LR is 0.01, the rate He et al. start ResNet-110 with
# (resnet_paper_schedule's docstring): at 0.1 and n_e = 3, CI-RESNET(18)
# ended with component accuracies of 0.10-0.43 in each of three runs on
# the card, its sweep not monotone in two; at 0.01 and n_e = 3 the early
# heads (trained at a tenth of the base LR) stayed at 0.37 / 0.43, with
# component 0's confidence anti-correlated with its accuracy (Fig. 4's r
# = -0.59); scripts/paper_recipes.py reruns both.  cuDNN's deterministic
# algorithms make a run repeat its bits.
PAPER_SPLITS = dict(n_classes=10, n_train=4096, n_val=1024, n_test=2048,
                    seed=11)
PAPER_TRAIN = dict(n_epochs=6, batch_size=128, augment=False, base_lr=0.01)
# Fig. 3's grid (benchmarks/bench_fig3.py), the ε of its wall-clock rows,
# and its monotonicity slack
PAPER_EPSILONS = [0.20, 0.15, 0.10, 0.08, 0.06, 0.04, 0.02, 0.01, 0.0]
PAPER_WALLCLOCK_EPSILONS = (0.10, 0.02)
MONOTONE_SLACK = 0.02
ALG1_BATCH = 256


def phase_paper():
    """CI-RESNET(18) (``ci-resnet18``: n = 18, enhance_dim 128), 10
    classes: backtrack training (Algorithm 2) in f32 with TF32 off and
    cuDNN's deterministic algorithms, the
    component accuracies, the Fig. 3 ε-sweep calibrated on the validation
    split (§5, ``self``), Fig. 4's linearity r of α_m(δ) per component,
    and the staged evaluation's measured wall clock against the dense
    cascade at ε = 0.10 and 0.02.  Training and evaluation launch no
    hand-written kernel (convolutions are cuDNN's): checked.  Then
    Algorithm 1 on a 256-image test batch through CI-ResNet's
    ``component_fns``, the confidence kernel against the plain measure:
    predictions equal, δ within 1e-5 relative, exactly 3 launches a call
    (the Python counter and the profiler's ``conf_cluster_kernel``
    count).  Fails on a non-finite loss, a phase-0 loss that does not
    fall, or a sweep that is not monotone within 0.02."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.calibration import accuracy_vs_confidence
    from repro_torch.core.cascade import cascade_infer_sequential
    from repro_torch.core.macs import resnet_component_macs
    from repro_torch.core.policy import ExitDecider, get_calibrator
    from repro_torch.core.resnet_trainer import (collect_logits,
                                                 evaluate_tradeoff,
                                                 evaluate_wallclock,
                                                 score_logits,
                                                 train_backtrack)
    from repro_torch.data.synth_images import make_image_splits
    from repro_torch.kernels import ref
    from repro_torch.kernels.confidence import confidence
    from repro_torch.models.resnet import CIResNet
    cfg = get_config("ci-resnet18")
    n, enh = cfg.cascade.exit_boundaries[0], cfg.cascade.enhance_dim
    classes = PAPER_SPLITS["n_classes"]
    model = CIResNet(n, classes, enh, device=DEV)
    train, val, test = make_image_splits(**PAPER_SPLITS)
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        fail("paper: TF32 is on")
    kernels.reset_launch_counts()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = train_backtrack(model, train, test=test, seed=0, **PAPER_TRAIN)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = deterministic
    losses = {k: np.asarray(v) for k, v in rep.phase_losses.items()}
    steps = {k: len(v) for k, v in losses.items()}
    if not all(np.isfinite(v).all() for v in losses.values()):
        fail("paper: a non-finite training loss (finite steps by phase: "
             f"{ {k: int(np.isfinite(v).sum()) for k, v in losses.items()} })")
    first = losses["backbone+last"]
    if not first[-20:].mean() < first[0]:
        fail(f"paper: the phase-0 loss did not fall ({first[0]:.4f} -> "
             f"{first[-20:].mean():.4f})")
    t0 = time.perf_counter()
    sweep = evaluate_tradeoff(model, rep.params, rep.state, val, test,
                              PAPER_EPSILONS, classes,
                              measure="softmax_max", calibrator="self")
    sweep_s = time.perf_counter() - t0
    accs = np.array([r.accuracy for _, r in sweep])
    macs = np.array([r.avg_macs for _, r in sweep])
    monotone = bool(np.all(np.diff(accs[np.argsort(macs)])
                           >= -MONOTONE_SLACK))
    if not monotone:
        fail(f"paper: the ε-sweep is not monotone within {MONOTONE_SLACK} "
             f"(accuracies {accs.round(4).tolist()} at average MACs "
             f"{macs.round(-3).tolist()}; component accuracies "
             f"{rep.component_acc})")
    logits_t = collect_logits(model, rep.params, rep.state, test)
    conf_t, _, corr_t = score_logits(logits_t, test.labels)
    linearity = []
    for m in range(3):
        grid, alpha = accuracy_vs_confidence(conf_t[m], corr_t[m])
        linearity.append(float(np.corrcoef(grid, alpha)[0, 1])
                         if len(grid) > 10 else None)
    logits_v = collect_logits(model, rep.params, rep.state, val)
    conf_v, _, corr_v = score_logits(logits_v, val.labels)
    analytic = {eps: r for eps, r in sweep}
    wallclock = []
    for eps in PAPER_WALLCLOCK_EPSILONS:
        cal = get_calibrator("self").calibrate(conf_v, corr_v, eps)
        wc = evaluate_wallclock(model, rep.params, rep.state, test,
                                cal.thresholds, repeats=3)
        wallclock.append({"epsilon": eps,
                          "thresholds": list(cal.thresholds),
                          "t_staged_s": wc["t_staged_s"],
                          "t_dense_s": wc["t_dense_s"],
                          "wallclock_speedup": wc["wallclock_speedup"],
                          "exit_fractions": wc["exit_fractions"],
                          "analytic_speedup": analytic[eps].speedup,
                          "analytic_exit_fractions":
                              analytic[eps].exit_fractions.tolist()})
    torch.cuda.synchronize()
    idle = kernels.launch_counts()
    if any(idle.values()):
        fail(f"paper: training and evaluation launched kernels {idle}")

    # Algorithm 1 on CI-ResNet's components: the confidence kernel at the
    # (256, 10) f32 logits of each component against the plain measure
    fns = model.component_fns(rep.params, rep.state)
    x = torch.from_numpy(test.images[:ALG1_BATCH]).to(DEV)
    ths = tuple(wallclock[0]["thresholds"])
    res = {}
    with torch.no_grad():
        for use_kernels in (False, True):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            pred, conf = cascade_infer_sequential(
                fns, ths, x, ExitDecider("softmax_max",
                                         use_kernels=use_kernels))
            torch.cuda.synchronize()
            res[use_kernels] = (pred, conf, kernels.launch_counts())
        launches = res[True][2]
        check_launched("paper algorithm 1", launches, {"confidence"})
        if launches["confidence"] != 3:
            fail(f"paper algorithm 1: {launches['confidence']} confidence "
                 "launches, expected 3")
        check_launched("paper algorithm 1 plain", res[False][2], set())
        check_equal("paper algorithm 1 predictions", res[True][0],
                    res[False][0])
        check_close("paper algorithm 1 confidences", res[True][1],
                    res[False][1], 0.0, 1e-5)
        prof = [(k, c) for k, c in _device_kernels(
            lambda: cascade_infer_sequential(
                fns, ths, x, ExitDecider("softmax_max", use_kernels=True)))
            if "conf_cluster_kernel" in k]
        if sum(c for _, c in prof) != 3:
            fail(f"paper algorithm 1: the profiler saw {prof} confidence "
                 "kernels in one call, expected 3")
        times = _algorithm1_times(fns, ths, x)
        # the kernel at the path's shape: each component's logits
        cases = []
        carry = None
        for m, fn in enumerate(fns):
            lg, carry = fn(x, carry)
            got, want = confidence(lg), ref.ref_confidence(lg)
            check_equal(f"paper confidence m={m} argmax", got[0], want[0])
            check_close(f"paper confidence m={m} delta", got[1], want[1],
                        0.0, 1e-5)
            b_, by = bound_ms(lg.numel() * 4 + lg.shape[0] * 8,
                              4 * lg.numel(), "float32")
            cases.append({
                "component": m, "shape": list(lg.shape), "dtype": "float32",
                "max_abs_err": max_err(got[1], want[1]),
                "ms": time_ms(lambda: confidence(lg)),
                "plain_ms": time_ms(lambda: ref.ref_confidence(lg)),
                "library_ms": time_ms(
                    lambda: torch.softmax(lg.float(), -1).max(-1)),
                "bound_ms": b_, "bound_by": by})
    emit({"phase": "paper", "config": "ci-resnet18",
          "n_blocks": n, "enhance_dim": enh, "n_classes": classes,
          "reduced": "synthetic images (data/synth_images.py): "
                     f"{len(train)} train, {len(val)} val, {len(test)} "
                     f"test; n_e = {PAPER_TRAIN['n_epochs']} epochs (the "
                     "paper: CIFAR, 64000 steps); f32, TF32 off",
          "macs_per_image": resnet_component_macs(n, classes,
                                                  enhance_dim=enh),
          "train_recipe": PAPER_TRAIN, "cudnn_deterministic": True,
          "train_seconds": train_s, "steps": steps,
          "phase_loss": {k: {"first": float(v[0]),
                             "last20_mean": float(v[-20:].mean())}
                         for k, v in losses.items()},
          "component_acc": rep.component_acc,
          "sweep_seconds": sweep_s,
          "sweep": [{"epsilon": eps, "accuracy": r.accuracy,
                     "avg_macs": r.avg_macs, "speedup": r.speedup,
                     "exit_fractions": r.exit_fractions.tolist(),
                     "thresholds": list(r.thresholds)} for eps, r in sweep],
          "monotone": monotone, "linearity_r": linearity,
          "wallclock": wallclock,
          "algorithm1": {"batch": ALG1_BATCH, "thresholds": list(ths),
                         "launches": launches,
                         "profiler_conf_kernels": prof,
                         "max_abs_err": max_err(res[True][1],
                                                res[False][1]),
                         **times},
          "confidence_cases": cases})
    return launches


def phase_train():
    """Full-width LM training on one card: the train CLI (``python -m
    repro_torch.launch.train --arch qwen2.5-3b --steps 8 --batch 4 --seq
    64 --ckpt-dir ...``, the reference CLI's batch and sequence) in a
    subprocess, which must exit 0 (its own checks: finite losses, a loss
    that trends down); its per-step ms, peak device memory and loss curve;
    then the checkpoint loaded back into the full-width tree on the card,
    its digest equal to the trained params' bit for bit."""
    import os
    import shutil
    import torch
    from repro_torch.ckpt import load_checkpoint, tree_digest
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen2.5-3b", "--steps", "8", "--batch", "4", "--seq", "64",
           "--ckpt-dir", str(ckpt), "--log-every", "1"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=900)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        shutil.rmtree(ckpt, ignore_errors=True)
        fail(f"train CLI exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    try:
        t0 = time.perf_counter()
        like = build_model(get_config("qwen2.5-3b"), device=DEV).init(0)
        init_digest = tree_digest(like)
        loaded = load_checkpoint(str(ckpt), like)
        digest = tree_digest(loaded)
        load_s = time.perf_counter() - t0
        ckpt_bytes = os.path.getsize(summary["checkpoint"])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    if digest != summary["params_digest"]:
        fail("train: the checkpoint does not load back bit for bit")
    if digest == init_digest:
        fail("train: the checkpoint holds the untrained params")
    del like, loaded
    torch.cuda.empty_cache()
    emit({"phase": "train", "command": " ".join(cmd[1:-4]), "rc": 0,
          "seconds": seconds, "params": summary["params"],
          "steps": summary["steps"], "batch": summary["batch"],
          "seq": summary["seq"], "losses": summary["losses"],
          "step_ms": summary["step_ms"],
          "max_memory_allocated": summary["max_memory_allocated"],
          "checkpoint_bytes": ckpt_bytes, "checkpoint_load_seconds": load_s,
          "checkpoint_bit_exact": True})


# ---------------------------------------------------------------------------
# slice 11: cross-model escalation on the card
# ---------------------------------------------------------------------------

# the serving shapes of the dense family's other published widths: model
# width, heads over KV heads, vocabulary, and the routes their norms and
# exit heads take in bf16 (d 7168 is past rmsnorm's warp route, 896
# 16-byte chunks a row; the megakernel's tc route takes it at B <= 8 with
# a 7-stage ring beside 8 x 7168 x 2 bytes of rows, its prologue in the
# block route's order)
DENSE_SHAPES = {
    "yi-9b": dict(d=4096, H=32, KV=4, vocab=64000, norm="warp", head="tc"),
    "deepseek-coder-33b": dict(d=7168, H=56, KV=8, vocab=32256,
                               norm="block", head="tc"),
    "minitron-4b": dict(d=3072, H=24, KV=8, vocab=256000, norm="warp",
                        head="tc", confidence=True),
}
# the moe family's serving shapes (slice 15), which the paged layout
# refuses (no paged decode case): mixtral-8x7b's windowed attention —
# decode over a ring of W 4096 with window 4096 at t past the wrap, the
# prefill's flash attention at S 4224 (33 x 128, the window run's prompt)
# with the window live — and qwen3-moe-235b-a22b's GQA group 16 and its
# exit head (4096, 151936)
MOE_SHAPES = {
    "mixtral-8x7b": dict(d=4096, H=32, KV=8, vocab=32000, norm="warp",
                         head="tc", W=4096, t=4096 + 700, window=4096,
                         S=4224, paged=False),
    "qwen3-moe-235b-a22b": dict(d=4096, H=64, KV=4, vocab=151936,
                                norm="warp", head="tc", paged=False),
}


# the hybrid family's serving shapes (slice 16): zamba2-1.2b's norms and
# exit heads (the megakernel's tc route at (2048, 32000), the qwen2.5-3b
# width at mixtral's vocabulary).  Its shared attention block calls the
# plain attention, as the reference's block does: the hybrid path launches
# no flash or decode attention, so the shape has no attention case
HYBRID_SHAPES = {
    "zamba2-1.2b": dict(d=2048, H=32, KV=32, vocab=32000, norm="warp",
                        head="tc", attention=False),
}
# select mode's land of a 5-layer mamba stage of zamba2-1.2b at lane batch
# 4, 2 cohorts: the recurrent state (L, B, heads, head_dim, state) f32 and
# the conv window (L, B, ssm_conv - 1, d_inner + 2 state) bf16, both whole
HYBRID_STATE_LEAVES = (((5, 4, 64, 64, 64), "float32"),
                       ((5, 4, 3, 4224), "bfloat16"))
# the ssm family's serving shapes (slice 17): xlstm-350m's norms and exit
# heads — the megakernel's tc route at (1024, 50304), the narrowest d so
# far, and exit_update over 13 tiles of 4096 columns a row.  Its path
# launches no attention kernel
XLSTM_SHAPES = {
    "xlstm-350m": dict(d=1024, H=4, KV=4, vocab=50304, norm="warp",
                       head="tc", attention=False),
}
# select mode's land of cohort 1 of 2 at lane batch 4, whole-cohort route:
# xlstm-350m's 5-layer mLSTM stage (C (L, B, heads, p, p), its conv window
# (L, B, 3, d_inner) bf16, m (L, B, heads) — 16-byte rows — and n (L, B,
# heads, p), in the cache's leaf order) and an sLSTM stage's four (1, B,
# d) f32 leaves (c, h, m, n)
# the audio family's serving shapes (slice 18): whisper-tiny's head dim 64
# (6 / 6 heads, d 384) — decode attention over the W 448 ring at the last
# position a lane of cache_len 448 reaches (every slot visible: 14 chunks
# of 32 keys), flash attention on its CUDA-core route in bf16 (wgmma is
# hd 128 only) at the 256- and 128-token lanes' S — and exit_update over
# 13 tiles of V 51865 (the layernorm heads never take the megakernel, and
# the path has no rmsnorm: no norm or megakernel case)
WHISPER_SHAPES = {
    "whisper-tiny": dict(d=384, H=6, KV=6, hd=64, vocab=51865, norm=None,
                         head=None, W=448, t=447, S=(256, 128),
                         flash="cuda_core", paged=False),
}
# select mode's land of cohort 1 of 2 at lane batch 4 in whisper-tiny's
# segment 1 (an encdec stage of 2 layers): the self K/V rings (L, B, W 448,
# 6, 64) bf16 at one ring slot; its cross K/V are read-only, never landed
WHISPER_RING = ((2, 4, 448, 6, 64), 300)
# the vlm family's serving shapes (slice 19): llama-3.2-vision-90b's d
# 8192 — rmsnorm (4, 8192) on the block route (1024 16-byte chunks a row),
# exit_update over 32 tiles of V 128256, decode attention q (4, 64, 128)
# over 8 KV heads (8 query heads a KV head) at W 512, flash attention on
# wgmma at the 256- and 128-token lanes' S.  Its megakernel cases are
# phase_megakernel_wide's (tc at B 1, 4, 8 on a 6-stage ring beside the
# rows' 128 KB, cuda_core at B 16); the paged layout refuses the family
# (R4): no paged decode case
VISION_SHAPES = {
    "llama-3.2-vision-90b": dict(d=8192, H=64, KV=8, vocab=128256,
                                 norm="block", head=None, S=(256, 128),
                                 paged=False),
}
# select mode's land of cohort 1 of 2 at lane batch 4 in a 4-layer dense
# stage of the 30-layer vlm model: the K/V rings (L, B, W 512, 8, 128)
# bf16 at one ring slot; the xattn stages' K/V are read-only, never landed
VISION_RING = ((4, 4, 512, 8, 128), 300)
XLSTM_STATE_LEAVES = {
    "mlstm": (((5, 4, 4, 512, 512), "float32"),
              ((5, 4, 3, 2048), "bfloat16"), ((5, 4, 4), "float32"),
              ((5, 4, 4, 512), "float32")),
    "slstm": (((1, 4, 1024), "float32"),) * 4,
}


def phase_yi_kernels(dev, gen):
    """Phase 2's cases at yi-9b's shapes (:func:`config_kernel_cases`)."""
    return config_kernel_cases(dev, gen, "yi-9b")


def config_kernel_cases(dev, gen, arch):
    """Phase 2's cases at ``arch``'s serving shapes (:data:`DENSE_SHAPES`,
    :data:`MOE_SHAPES`, :data:`HYBRID_SHAPES`, :data:`XLSTM_SHAPES`,
    :data:`WHISPER_SHAPES`, :data:`VISION_SHAPES`; B = 4, bf16), each
    against
    its plain version at the tolerances above: rmsnorm (4, d) on the route
    the width takes (none where the shape's ``norm`` is None); exit_update
    (4, V); the megakernel at h (4, d) x (d, V) on its route (against
    cuBLAS + ``exit_update`` as the library call; none where ``head`` is
    None); decode attention q (4, H, hd) over KV heads at W 512 (or the
    shape's W, t and window; hd 128 or the shape's), dense and, unless
    marked, paged (the paged route bit for bit like the dense one over the
    gathered views); flash attention (4, H/KV, 256, hd) (or the shape's S
    — one case each — and window) on the wgmma route (or the shape's
    ``flash`` route); where marked, confidence (4, V) at its cluster cap;
    a shape marked ``attention=False`` (the hybrid's and the ssm family's)
    has no attention case.
    Returns {kernel: [case]}, each case marked ``"config": arch``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.confidence import confidence, plan
    from repro_torch.kernels.exit_update import exit_update
    from repro_torch.kernels.megakernel import exit_head_update
    from repro_torch.kernels.rmsnorm import rmsnorm
    shp = {**DENSE_SHAPES, **MOE_SHAPES, **HYBRID_SHAPES, **XLSTM_SHAPES,
           **WHISPER_SHAPES, **VISION_SHAPES}[arch]
    D, H, KV, V = shp["d"], shp["H"], shp["KV"], shp["vocab"]
    bf = torch.bfloat16
    name, B, hd, n_m = "bfloat16", 4, shp.get("hd", 128), 3
    out = {}

    def case(kernel, **c):
        out.setdefault(kernel, []).append({"config": arch, "dtype": name,
                                           **c})

    # rmsnorm
    w = 1 + 0.1 * torch.randn(D, generator=gen, device=dev)
    if shp["norm"] is not None:
        x = torch.randn(B, D, generator=gen, device=dev).to(bf)
        got, route = route_of(lambda: rmsnorm(x, w, 1e-5), rmsnorm)
        want = ref.ref_rmsnorm(x, w, 1e-5)
        check_close(f"rmsnorm {arch}", got, want, *TOL[name])
        if route != shp["norm"]:
            fail(f"rmsnorm {arch}: took the {route} route")
        b, by = bound_ms(2 * x.numel() * 2 + D * 4, 4 * x.numel(), name)
        case("rmsnorm", shape=[B, D], route=route,
             max_abs_err=max_err(got, want),
             ms=time_ms(lambda: rmsnorm(x, w, 1e-5)),
             plain_ms=time_ms(lambda: ref.ref_rmsnorm(x, w, 1e-5)),
             library_ms=time_ms(lambda: F.rms_norm(x, (D,), w.to(bf),
                                                   1e-5)),
             bound_ms=b, bound_by=by)
    # exit_update
    x = _exit_logits(B, V, bf, dev, gen)
    carry = _carries(B, n_m, dev)
    kw = dict(threshold=torch.full((n_m,), 0.3, device=dev), m=0,
              n_components=n_m, tel_bins=32)
    got = exit_update(x, *carry, **kw)
    want = ref.ref_exit_update(x, *carry, **kw)
    for idx in (0, 1, 2, 4, 6):
        check_equal(f"exit_update {arch}", got[idx], want[idx])
    for idx in (3, 5):
        check_close(f"exit_update {arch}", got[idx], want[idx], 0.0, 1e-5)
    b, by = bound_ms(x.numel() * 2 + B * 4 * 13, 4 * x.numel(), name)
    case("exit_update", shape=[B, V],
         max_abs_err=max(max_err(got[3], want[3]), max_err(got[5], want[5])),
         ms=time_ms(lambda: exit_update(x, *carry, **kw)),
         plain_ms=time_ms(lambda: ref.ref_exit_update(x, *carry, **kw)),
         library_ms=time_ms(lambda: torch.softmax(x.float(), -1).max(-1)),
         bound_ms=b, bound_by=by)
    if shp.get("confidence"):
        xc, _ = _conf_logits(B, V, bf, dev, gen)
        got = confidence(xc)
        want = ref.ref_confidence(xc)
        check_equal(f"confidence {arch}", got[0], want[0])
        check_close(f"confidence {arch}", got[1], want[1], 0.0, 1e-5)
        b, by = bound_ms(xc.numel() * 2 + B * 8, 4 * xc.numel(), name)
        case("confidence", shape=[B, V], cluster=plan(V),
             max_abs_err=max_err(got[1], want[1]),
             ms=time_ms(lambda: confidence(xc)),
             plain_ms=time_ms(lambda: ref.ref_confidence(xc)),
             library_ms=time_ms(lambda: torch.softmax(xc.float(),
                                                      -1).max(-1)),
             bound_ms=b, bound_by=by)
        del xc
    if shp["head"] is None:
        return _attention_cases(out, case, shp, arch, dev, gen, name, B, hd)
    # the megakernel on the route the width takes
    h = torch.randn(B, D, generator=gen, device=dev).to(bf)
    head = (0.02 * torch.randn(D, V, generator=gen, device=dev)).to(bf)
    head[:, 77] = (ref.ref_rmsnorm(h[1:2], w)[0].float() * 0.05).to(bf)
    live = torch.arange(B, device=dev) % 4 != 2
    ties = _mega_ties(h, w, head, name)
    kw = dict(threshold=torch.full((n_m,), 0.5, device=dev), m=0,
              n_components=n_m, live=live)
    got, route = route_of(lambda: exit_head_update(h, w, head, *carry, **kw),
                          exit_head_update)
    want = ref.ref_exit_head_update(h, w, head, *carry, **kw)
    if route != shp["head"]:
        fail(f"megakernel {arch}: took the {route} route")
    err = _mega_check(f"megakernel {arch}", got, want, carry, live, ties,
                      name)
    if int(got[1][1]) != 77:
        fail(f"megakernel {arch}: the confident row must answer 77")
    b, by = bound_ms(head.numel() * 2 + h.numel() * 2 + D * 4 + B * 56,
                     2 * B * D * V, name)

    def library():
        xn = F.rms_norm(h, (D,), w.to(bf), 1e-5)
        return exit_update(xn @ head, *carry, threshold=kw["threshold"],
                           m=0, n_components=n_m)

    case("megakernel", shape=[B, D, V], route=route,
         live=live.tolist(), tie_rows=int(ties.sum()), max_abs_err=err,
         ms=time_ms(lambda: exit_head_update(h, w, head, *carry, **kw)),
         plain_ms=time_ms(lambda: ref.ref_exit_head_update(h, w, head,
                                                           *carry, **kw)),
         library_ms=time_ms(library), bound_ms=b, bound_by=by)
    del head
    return _attention_cases(out, case, shp, arch, dev, gen, name, B, hd)


def _attention_cases(out, case, shp, arch, dev, gen, name, B, hd):
    """:func:`config_kernel_cases`' decode and flash attention cases, added
    to ``out`` through ``case``; none for a shape marked
    ``attention=False``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    bf = torch.bfloat16
    H, KV = shp["H"], shp["KV"]
    if not shp.get("attention", True):
        torch.cuda.empty_cache()
        return out
    # decode attention, dense and paged
    t, W, win = shp.get("t", 700), shp.get("W", 512), shp.get("window", 0)
    t_dev = torch.full((), t, dtype=torch.int32, device=dev)
    kpos = torch.as_tensor(decode_ring(t, W), device=dev)
    live = torch.ones(B, dtype=torch.bool, device=dev)
    q = torch.randn(B, H, hd, generator=gen, device=dev).to(bf)
    kc = torch.randn(B, W, KV, hd, generator=gen, device=dev).to(bf)
    vc = torch.randn(B, W, KV, hd, generator=gen, device=dev).to(bf)
    got, route = route_of(lambda: decode_attention(
        q, kc, vc, t_dev, kpos, live, window=win), decode_attention)
    want = ref.ref_decode_attention(q, kc, vc, t, kpos, window=win,
                                    live=live)
    check_close(f"decode {arch} dense", got, want, *TOL[name])
    if route != "dense":
        fail(f"decode {arch}: took the {route} route")
    # the keys the slots see: in the ring, at most t, inside the window
    vis = (kpos >= 0) & (kpos <= t)
    if win:
        vis &= t - kpos < win
    n_vis = int(vis.sum().item())
    nbytes = (2 * B * n_vis * KV * hd + 2 * q.numel()) * 2 + W * 4
    b, by = bound_ms(nbytes, 4 * H * hd * B * n_vis, name)
    mask = vis.view(1, 1, 1, W).expand(B, 1, 1, W)
    case("decode_attention", shape=[B, H, KV, W, hd], t=t, window=win,
         live=[1] * B, kpos="lane", route=route, visible_keys=n_vis,
         max_abs_err=max_err(got, want),
         ms=time_ms(lambda: decode_attention(q, kc, vc, t_dev, kpos, live,
                                             window=win)),
         plain_ms=time_ms(lambda: ref.ref_decode_attention(
             q, kc, vc, t, kpos, window=win, live=live)),
         library_ms=time_ms(lambda: F.scaled_dot_product_attention(
             q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
             attn_mask=mask, enable_gqa=True)),
         bound_ms=b, bound_by=by)
    if shp.get("paged", True):
        _paged_decode_case(case, arch, dev, gen, q, t, t_dev, kpos, live)
    del kc, vc
    lens = shp.get("S", 256)
    for S in lens if isinstance(lens, tuple) else (lens,):
        _flash_case(case, shp, arch, dev, gen, name, B, H, KV, S, hd, win)
    torch.cuda.empty_cache()
    return out


def _flash_case(case, shp, arch, dev, gen, name, B, H, KV, S, hd, win):
    """One flash attention case of :func:`config_kernel_cases` at S: the
    kernel against its plain version on the shape's route (``flash``,
    wgmma by default), timed beside the plain version and SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    bf = torch.bfloat16
    q = torch.randn(B, H, S, hd, generator=gen, device=dev).to(bf)
    k = torch.randn(B, KV, S, hd, generator=gen, device=dev).to(bf)
    v = torch.randn(B, KV, S, hd, generator=gen, device=dev).to(bf)
    got, route = route_of(lambda: flash_attention(q, k, v, causal=True,
                                                  window=win),
                          flash_attention)
    want = ref.ref_flash_attention(q, k, v, causal=True, window=win)
    check_close(f"flash {arch}", got, want, *TOL[name])
    err = max_err(got, want)
    del got, want
    if route != shp.get("flash", "wgmma"):
        fail(f"flash {arch}: took the {route} route")
    # the (query, key) pairs inside the causal band and the window
    i = torch.arange(S, dtype=torch.int64)
    pairs = int((torch.minimum(i + 1, torch.full_like(i, win))
                 if win else i + 1).sum())
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    b, by = bound_ms(nbytes, 4 * hd * B * H * pairs, name)
    pos = torch.arange(S, device=dev)
    band = pos[:, None] >= pos[None, :]
    if win:
        band &= pos[:, None] - pos[None, :] < win
    case("flash_attention", shape=[B, H, KV, S, hd], window=win,
         route=route, max_abs_err=err,
         ms=time_ms(lambda: flash_attention(q, k, v, causal=True,
                                            window=win)),
         # the plain version holds the (S, S) scores: fewer calls at 4224
         plain_ms=time_ms(lambda: ref.ref_flash_attention(
             q, k, v, causal=True, window=win),
             **({} if S <= 1024 else dict(iters=5, warmup=1))),
         library_ms=time_ms(lambda: F.scaled_dot_product_attention(
             q, k, v, attn_mask=band, enable_gqa=True) if win else
             F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                            enable_gqa=True)),
         bound_ms=b, bound_by=by)


def _paged_decode_case(case, arch, dev, gen, q, t, t_dev, kpos, live):
    """The paged route at ``arch``'s decode shape: a layer's paged stores
    read through a block table with trash rows, bit for bit like the
    dense route over the gathered views."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.paged_gather import paged_gather_kv
    bf, name = torch.bfloat16, "bfloat16"
    B, H, hd = q.shape
    KV = DENSE_SHAPES[arch]["KV"]
    W = PAGED_TABLE[1] * 16
    store = (769, 16, KV, hd)
    ks = torch.randn(store, generator=gen, device=dev).to(bf)
    vs = torch.randn(store, generator=gen, device=dev).to(bf)
    table = torch.randint(1, store[0], PAGED_TABLE, generator=gen,
                          device=dev, dtype=torch.int32)
    table[1, 20:] = 0
    views = paged_gather_kv(ks, vs, table)
    kpos = torch.stack([kpos - 2 * i for i in range(B)]).clamp(min=-1)
    got, route = route_of(lambda: decode_attention(
        q, ks, vs, t_dev, kpos, live, table=table), decode_attention)
    dense = decode_attention(q, *views, t_dev, kpos, live)
    want = ref.ref_decode_attention(q, *views, t, kpos, live=live)
    if route != "paged":
        fail(f"decode {arch} paged: took the {route} route")
    if not torch.equal(got, dense):
        fail(f"decode {arch} paged: differs from the dense route over the "
             "gathered views")
    check_close(f"decode {arch} paged", got, want, *TOL[name])
    n_vis = int(((kpos >= 0) & (kpos <= t)).sum().item())
    nbytes = (2 * n_vis * KV * hd + 2 * q.numel()) * 2 + \
        kpos.numel() * 4 + table.numel() * 4
    b, by = bound_ms(nbytes, 4 * H * hd * n_vis, name)
    case("decode_attention", shape=[B, H, KV, W, hd], t=t, window=0,
         live=[1] * B, kpos="per-slot", route=route, store=list(store),
         table=list(PAGED_TABLE), max_abs_err=max_err(got, want),
         ms=time_ms(lambda: decode_attention(q, ks, vs, t_dev, kpos, live,
                                             table=table)),
         dense_ms=time_ms(lambda: decode_attention(q, *views, t_dev, kpos,
                                                   live)),
         plain_ms=time_ms(lambda: ref.ref_decode_attention(
             q, ref.ref_paged_gather(ks, table),
             ref.ref_paged_gather(vs, table), t, kpos, live=live)),
         library_ms=time_ms(lambda: F.scaled_dot_product_attention(
             q[:, :, None], *(v.transpose(1, 2) for v in views),
             attn_mask=((kpos >= 0) & (kpos <= t))[:, None, None, :],
             enable_gqa=True)),
         bound_ms=b, bound_by=by)
    del ks, vs, views


# the escalate phase's stack: qwen2.5-3b widths throughout, bf16, kernels
# on, cond_batch; a draft cut to 12 layers (seed 0) in front of the full
# 36-layer model (seed 1); lane_batch 4, 2 lanes, cache_len 512, chunk 8;
# 8 requests of 128-token prompts and 32 new tokens
ESC_ENGINE = dict(lane_batch=4, n_lanes=2, cache_len=512, chunk=8)
ESC_DRAFT_LAYERS = 12
ESC_INTRA = (0.9, 0.9, 0.0)
ESC_ALWAYS = (1.1, 1.1, 0.0)


def _records(fin):
    """Every field of the tier's (or an engine's) finished records that
    the bit-identity checks compare."""
    return {rid: (r["tokens"], r["exit_depths"], r["confs"],
                  r.get("final_stage"), r.get("spans"))
            for rid, r in fin.items()}


def serve_tier(cfgs, models, params, reqs, runtime, controller=None):
    """One tier run of ``reqs`` over fresh engines (``cfgs[s]`` on
    ``models[s]`` / ``params[s]``), with the launch counters set to 0
    just before and read just after.  Returns (tier, finished, seconds,
    launches, routes): every bf16 prefill on flash's wgmma route, every
    norm on rmsnorm's warp route, every decode on the layout's route."""
    import torch
    from repro_torch import kernels
    from repro_torch.escalate import ModelCascadeTier
    engines = [make_engine(c, m, p, runtime=runtime, **ESC_ENGINE)
               for c, m, p in zip(cfgs, models, params)]
    tier = ModelCascadeTier(engines, controller=controller)
    for r in reqs:
        tier.submit(r)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    finished = tier.run(max_ticks=10_000)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    routes = check_routes(cfgs[0], launches)
    if sorted(finished) != [r.rid for r in reqs] or any(
            len(f["tokens"]) != r.max_new_tokens
            for f, r in zip((finished[r.rid] for r in reqs), reqs)):
        fail(f"tier {runtime}: not every request got its budget")
    return tier, finished, seconds, launches, routes


def _defer_points(fin, th, n_m):
    """Each request's first token answered at the final component below
    ``th`` (the router's rule), or None."""
    return {rid: next((i for i, (d, c) in enumerate(zip(r["exit_depths"],
                                                         r["confs"]))
                       if d == n_m - 1 and c < th), None)
            for rid, r in fin.items()}


def escalation_middle(fin, n_m):
    """The middle escalation threshold: the midpoint of two neighbouring
    sorted final-component confidences of the draft's own run, the median
    first and then outward, until (a) a request defers at a token > 0,
    (b) a request never defers, and (c) every deferring request defers at
    the same token, so that both runtimes hand stage 1 its escalated
    requests in one admission (the host runtime finds a defer at token d
    the tick after it; the device runtime at the chunk's end, and a dense
    lane re-prefilled by a later admission re-pads its residents: admission
    points decide streams, the reference's sanctioned divergence).  None
    if no threshold has all three.  Returns (threshold, its rank from the
    median, the defer points, the median threshold and its defer
    points)."""
    import numpy as np
    c = np.unique([x for r in fin.values()
                   for d, x in zip(r["exit_depths"], r["confs"])
                   if d == n_m - 1])
    mids = [(abs(i - len(c) / 2), float((c[i - 1] + c[i]) / 2))
            for i in range(1, len(c))]
    mids.sort()
    median = mids[0][1], _defer_points(fin, mids[0][1], n_m)
    for rank, (_, th) in enumerate(mids):
        pts = _defer_points(fin, th, n_m)
        deferred = {d for d in pts.values() if d is not None}
        if (len(deferred) == 1 and min(deferred) > 0
                and None in pts.values()):
            return th, rank, pts, median
    return None, None, None, median


def phase_escalate():
    """Slice 11's path at full width: the cross-model escalation tier
    (``repro_torch.escalate``), two engines on one card.

    (a) corners, host and device runtimes x dense and paged (block size
        16): escalation threshold 0.0 gives the draft alone bit for bit
        (tokens, exit depths, confidences); 1.1 with the draft's intra
        thresholds at 1.1 gives the 36-layer model alone bit for bit, with
        nothing replayed; paged pools end with no block in use;
    (b) the middle threshold (:func:`escalation_middle`), host and device
        runtimes, dense: a request defers at a token > 0 and one never
        does; each committed prefix is the draft's stream up to its defer;
        escalated admissions equal the deferred requests and replayed
        prefill positions the sum of the defer points; both runtimes'
        streams identical;
    (b') the median of the draft's confidences on the device runtime,
        dense and paged (:func:`phase_escalate_median`): defers at several
        tokens, held to the draft's stream and the replay accounting;
    (c) TierThresholdController(epsilon=0.05) on the device runtime,
        route_final telemetry on the draft, escalation threshold at the
        median of the draft's confidences: at least one solve and push,
        each engine's captures the same before and after every push, the
        lanes' δ̂ the pushed vectors; stage_agree reported;
    (d) the restart path: yi-9b at full width (48 layers, seed 1) behind
        a 12-layer draft of qwen2.5-3b's widths at yi-9b's vocabulary
        (a tier's stages share the prompt vocabulary) with share_prefix
        off: at 1.1 the tier is yi-9b alone bit for bit, nothing replayed
        (every request defers at token 0, so this shows only that an
        empty prefix is routed to the other vocabulary; the restart of a
        request with draft tokens to discard is held to the JAX tier on
        the CPU, ``tests/test_torch_escalate.py``);
    (e) the serve CLI's tier path in a subprocess.

    Returns the launches of the device runtime's middle run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    target = get_config("qwen2.5-3b").replace(use_kernels=True).with_cascade(
        exit_mode="cond_batch", thresholds=ESC_INTRA)
    draft = target.replace(n_layers=ESC_DRAFT_LAYERS)
    n_m = draft.cascade.n_components
    reqs = make_requests(8, (128,), target.vocab_size, 32, seed=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = [build_model(c, device=DEV).init(
        torch.Generator(device=DEV).manual_seed(s))
        for s, c in enumerate((draft, target))]
    torch.cuda.synchronize()
    init_seconds = time.perf_counter() - t0
    layouts = {"dense": (draft, target),
               "paged": (paged_config(draft), paged_config(target))}
    models = {k: [build_model(c, device=DEV) for c in v]
              for k, v in layouts.items()}
    alone = {}
    for layout, (d_cfg, t_cfg) in layouts.items():
        for runtime in ("host", "device"):
            tag = f"escalate {layout} {runtime}"
            fin0, st0, secs0, _ = serve(d_cfg, models[layout][0], params[0],
                                        reqs, runtime=runtime, **ESC_ENGINE)
            fin1, st1, secs1, _ = serve(t_cfg, models[layout][1], params[1],
                                        reqs, runtime=runtime, **ESC_ENGINE)
            alone[layout, runtime] = (fin0, st0, secs0, st1, secs1)
            corners = {}
            for th, intra, want, stage in ((0.0, ESC_INTRA, fin0, 0),
                                           (1.1, ESC_ALWAYS, fin1, 1)):
                cfg0 = d_cfg.with_cascade(thresholds=intra).with_escalation(
                    enabled=True, threshold=th)
                tier, fin, secs, _, _ = serve_tier(
                    (cfg0, t_cfg), models[layout], params, reqs, runtime)
                got = {rid: r[:3] for rid, r in _records(fin).items()}
                if got != {rid: r[:3] for rid, r in _records(want).items()}:
                    fail(f"{tag} threshold {th}: the tier is not stage "
                         f"{stage} alone bit for bit")
                st = tier.stats()
                # cancels return their blocks: both pools end empty
                if any(e.paged and e.pcache.pool.used for e in tier.engines):
                    fail(f"{tag} threshold {th}: blocks left in a pool "
                         f"after the run")
                esc1 = st["stages"][1]["escalation"]
                if (st["final_stage_histogram"][stage] != len(reqs)
                        or esc1["escalated_requests_admitted"]
                        != stage * len(reqs)
                        or esc1["prefill_positions_replayed"] != 0):
                    fail(f"{tag} threshold {th}: escalations "
                         f"{st['final_stage_histogram']}, {esc1}")
                corners[th] = {"seconds": secs,
                               "escalations": st["escalations_total"],
                               "final_stage_histogram":
                                   st["final_stage_histogram"]}
            emit({"phase": "escalate_corners", "layout": layout,
                  "runtime": runtime, "draft_layers": ESC_DRAFT_LAYERS,
                  "target_layers": target.n_layers,
                  "never_equals_draft": True, "always_equals_target": True,
                  "corners": corners,
                  "draft_alone": {"seconds": secs0, "decode_us_per_token":
                                  st0["wallclock_us_per_token"]},
                  "target_alone": {"seconds": secs1, "decode_us_per_token":
                                   st1["wallclock_us_per_token"]}})
    # (b) the middle threshold
    draft_fin = alone["dense", "host"][0]
    th, rank, pts, (median_th, median_pts) = escalation_middle(draft_fin,
                                                                n_m)
    if th is None:
        fail(f"escalate middle: no threshold defers one group at a token "
             f"> 0 and spares a request (median's defer points "
             f"{median_pts})")
    runs = {}
    for runtime in ("host", "device"):
        cfg0 = draft.with_escalation(enabled=True, threshold=th)
        torch.cuda.reset_peak_memory_stats()
        tier, fin, secs, launches, _ = serve_tier(
            (cfg0, target), models["dense"], params, reqs, runtime)
        check_launched(f"escalate middle {runtime}", launches, SLICE1)
        tag = f"escalate middle {runtime}"
        for rid, d in pts.items():
            want, r = draft_fin[rid], fin[rid]
            if d is None:
                ok = (r["tokens"] == want["tokens"]
                      and r["final_stage"] == 0)
            else:
                ok = (r["tokens"][:d] == want["tokens"][:d]
                      and r["confs"][:d] == want["confs"][:d]
                      and r["spans"][0] == {"stage": 0, "n_tokens": d,
                                            "kept": True}
                      and r["final_stage"] == 1 and r["escalations"] == 1)
            if not ok:
                fail(f"{tag}: request {rid} (defer point {d}) left the "
                     f"draft's committed stream")
        st = tier.stats()
        deferred = [d for d in pts.values() if d is not None]
        esc1 = st["stages"][1]["escalation"]
        if (esc1["escalated_requests_admitted"] != len(deferred)
                or esc1["prefill_positions_replayed"] != sum(deferred)
                or not esc1["replay_prefill_seconds"] > 0):
            fail(f"{tag}: escalation accounting {esc1} for defer points "
                 f"{pts}")
        n_tok = sum(len(r["tokens"]) for r in fin.values())
        runs[runtime] = (fin, launches)
        emit({"phase": "escalate_middle", "runtime": runtime,
              "threshold": th, "rank_from_median": rank,
              "defer_points": pts, "median_threshold": median_th,
              "median_defer_points": median_pts,
              "seconds": secs, "tier_tokens_per_s": n_tok / secs,
              "escalations": st["escalations_total"],
              "final_stage_histogram": st["final_stage_histogram"],
              "router": st["router"],
              "stages": [{
                  "n_layers": e.cfg.n_layers,
                  "decode_us_per_token": s_["wallclock_us_per_token"],
                  "decode_tokens": s_["decode_tokens"],
                  "prefill_seconds": s_["prefill_seconds"],
                  "captures": s_["captures"],
                  **s_["escalation"]}
                  for e, s_ in zip(tier.engines, st["stages"])],
              "replay_share_of_wall": sum(
                  s_["escalation"]["replay_prefill_seconds"]
                  for s_ in st["stages"]) / secs,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "launches": launches})
    if _records(runs["host"][0]) != _records(runs["device"][0]):
        fail("escalate middle: the host and device runtimes' streams "
             "differ")
    # (b') the median threshold itself, device runtime, both layouts
    for layout in ("dense", "paged"):
        phase_escalate_median(layouts[layout], models[layout], params, reqs,
                              alone[layout, "device"][0], median_th, layout)
    # (c) the tier controller on the device runtime, at the median
    # threshold: most requests defer early, so both stages' telemetry
    # fills within the run
    phase_escalate_autotune(draft, target, models["dense"], params, reqs,
                            median_th)
    del tier, models, layouts, alone
    params.clear()
    torch.cuda.empty_cache()
    phase_escalate_restart(draft)
    phase_escalate_cli()
    emit({"phase": "escalate", "init_seconds": init_seconds,
          "streams_host_equal_device": True})
    return runs["device"][1]


def phase_escalate_median(cfgs, models, params, reqs, draft_fin, th,
                          layout):
    """(b') of :func:`phase_escalate`: the device runtime at the median of
    the draft's final-component confidences, where requests defer at
    several tokens and several escalated admissions share stage 1's lanes.
    Held to the draft's own stream (``draft_fin``, the draft alone on the
    same runtime and layout), not to the host runtime: there admission
    points differ (see :func:`escalation_middle`).  Each committed prefix
    is the draft's stream up to its defer point, a request that never
    defers is the draft's stream whole; escalated admissions equal the
    deferred requests, replayed prefill positions the sum of the defer
    points; paged pools end with no block in use and no lane's promise
    outstanding."""
    import torch
    n_m = cfgs[0].cascade.n_components
    pts = _defer_points(draft_fin, th, n_m)
    deferred = [d for d in pts.values() if d is not None]
    tag = f"escalate median device {layout}"
    if not any(d > 0 for d in deferred):
        fail(f"{tag}: no request defers at a token > 0 ({pts})")
    cfg0 = cfgs[0].with_escalation(enabled=True, threshold=th)
    torch.cuda.reset_peak_memory_stats()
    tier, fin, secs, launches, _ = serve_tier(
        (cfg0, cfgs[1]), models, params, reqs, "device")
    check_launched(tag, launches, SLICE1)
    for rid, d in pts.items():
        want, r = draft_fin[rid], fin[rid]
        if d is None:
            ok = r["tokens"] == want["tokens"] and r["final_stage"] == 0
        else:
            ok = (r["tokens"][:d] == want["tokens"][:d]
                  and r["confs"][:d] == want["confs"][:d]
                  and r["spans"][0] == {"stage": 0, "n_tokens": d,
                                        "kept": True}
                  and r["final_stage"] == 1 and r["escalations"] == 1)
        if not ok:
            fail(f"{tag}: request {rid} (defer point {d}) left the "
                 f"draft's committed stream")
    st = tier.stats()
    esc1 = st["stages"][1]["escalation"]
    if (esc1["escalated_requests_admitted"] != len(deferred)
            or esc1["prefill_positions_replayed"] != sum(deferred)):
        fail(f"{tag}: escalation accounting {esc1} for defer points {pts}")
    for e in tier.engines:
        if e.paged and (e.pcache.pool.used or e._promised_blocks()):
            fail(f"{tag}: {e.pcache.pool.used} blocks in use and "
                 f"{e._promised_blocks()} promised after the run")
    n_tok = sum(len(r["tokens"]) for r in fin.values())
    emit({"phase": "escalate_median", "runtime": "device",
          "layout": layout, "threshold": th, "defer_points": pts,
          "distinct_defer_points": sorted(set(deferred)),
          "seconds": secs, "tier_tokens_per_s": n_tok / secs,
          "escalations": st["escalations_total"],
          "final_stage_histogram": st["final_stage_histogram"],
          "stages": [{"decode_us_per_token": s_["wallclock_us_per_token"],
                      "captures": s_["captures"], **s_["escalation"]}
                     for s_ in st["stages"]],
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches})
    del tier


def phase_escalate_autotune(draft, target, models, params, reqs, th):
    """(c) of :func:`phase_escalate`: solves and pushes that capture
    nothing."""
    import numpy as np
    from repro_torch.escalate import TierThresholdController
    # 8 bins: the composed tier histogram has 3 + 2 routing axes (the
    # draft's three with route_final, the target's two), 8^5 cells
    auto = dict(AUTOTUNE, bins=8, epsilon=0.05)
    cfgs = (draft.with_autotune(**auto, route_final=True).with_escalation(
        enabled=True, threshold=th), target.with_autotune(**auto))
    ctl = TierThresholdController(epsilon=0.05, interval=1, min_shadow=4.0,
                                  min_escalations=2)
    pushes = []
    solve = ctl.update

    def update(tier):
        before = [e.loop.captures for e in tier.engines]
        solved = solve(tier)
        if solved:
            pushes.append({"captures_before": before,
                           "captures_after": [e.loop.captures
                                              for e in tier.engines],
                           "thresholds": ctl.stats()["thresholds"]})
            for e, ths in zip(tier.engines, (ctl.last_thresholds[0],
                                             ctl.last_thresholds[2])):
                for lane in e.lanes:
                    if not np.array_equal(
                            lane["state"].thresholds.cpu().numpy(),
                            np.asarray(ths, np.float32)):
                        fail("escalate autotune: a lane's δ̂ is not the "
                             "pushed vector")
        return solved

    ctl.update = update
    tier, fin, secs, launches, _ = serve_tier(cfgs, models, params, reqs,
                                              "device", controller=ctl)
    if not pushes:
        fail(f"escalate autotune: no solve ({ctl.stats()})")
    for p in pushes:
        if p["captures_before"] != p["captures_after"]:
            fail(f"escalate autotune: a push captured: {p}")
    st = tier.stats()
    for e, s_ in zip(tier.engines, st["stages"]):
        if s_["captures"] > ESC_ENGINE["n_lanes"]:
            fail(f"escalate autotune: {s_['captures']} captures for "
                 f"{ESC_ENGINE['n_lanes']} lanes")
    emit({"phase": "escalate_autotune", "epsilon": 0.05, "seconds": secs,
          "solves": ctl.solves, "pushes": pushes,
          "controller": st["controller"], "router": st["router"],
          "stage_agree": st["controller"]["stage_agree"],
          "final_stage_histogram": st["final_stage_histogram"],
          "captures": [s_["captures"] for s_ in st["stages"]],
          "decode_us_per_token": [s_["wallclock_us_per_token"]
                                  for s_ in st["stages"]]})


def phase_escalate_restart(draft):
    """(d) of :func:`phase_escalate`: yi-9b at full width as the second
    stage of a tier that restarts, not replays."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import nn
    from repro_torch.models.model import build_model
    yi = get_config("yi-9b").replace(use_kernels=True).with_cascade(
        exit_mode="cond_batch", thresholds=ESC_INTRA)
    rdraft = draft.replace(vocab_size=yi.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    models = [build_model(c, device=DEV) for c in (rdraft, yi)]
    params = [m.init(torch.Generator(device=DEV).manual_seed(s))
              for s, m in enumerate(models)]
    torch.cuda.synchronize()
    init_seconds = time.perf_counter() - t0
    n_params = sum(x.numel() for x in nn.tree_leaves(params[1]))
    reqs = make_requests(8, (128,), yi.vocab_size, 32, seed=0)
    fin, st, secs, launches = serve(yi, models[1], params[1], reqs,
                                    runtime="device", **ESC_ENGINE)
    check_launched("yi-9b alone", launches, SLICE1)
    cfg0 = rdraft.with_cascade(thresholds=ESC_ALWAYS).with_escalation(
        enabled=True, threshold=1.1, share_prefix=False)
    tier, tfin, tsecs, tlaunches, _ = serve_tier((cfg0, yi), models, params,
                                                 reqs, "device")
    if {rid: r[:3] for rid, r in _records(tfin).items()} != \
            {rid: r[:3] for rid, r in _records(fin).items()}:
        fail("escalate restart: the tier at 1.1 is not yi-9b alone bit for "
             "bit")
    tst = tier.stats()
    esc1 = tst["stages"][1]["escalation"]
    if (tst["final_stage_histogram"] != [0, len(reqs)]
            or esc1["prefill_positions_replayed"] != 0
            or any(r["spans"][0]["kept"] for r in tfin.values())):
        fail(f"escalate restart: {tst['final_stage_histogram']}, {esc1}")
    n_tok = sum(len(r["tokens"]) for r in fin.values())
    emit({"phase": "escalate_restart", "config": "yi-9b",
          "n_layers": yi.n_layers, "d_model": yi.d_model,
          "vocab": yi.vocab_size, "params": n_params,
          "init_seconds": init_seconds, "identical": True,
          "alone": {"seconds": secs, "tokens_per_s": n_tok / secs,
                    "decode_us_per_token": st["wallclock_us_per_token"],
                    "compile_seconds": st["compile_seconds"],
                    "captures": st["captures"], "launches": launches},
          "tier": {"seconds": tsecs,
                   "discarded_draft_tokens": tst["discarded_draft_tokens"],
                   "decode_us_per_token": [
                       s_["wallclock_us_per_token"] for s_ in tst["stages"]],
                   "launches": tlaunches},
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    del tier, models, params
    torch.cuda.empty_cache()


def phase_escalate_cli():
    """(e) of :func:`phase_escalate`: ``python -m repro_torch.launch.serve
    --escalate-layers 36 --runtime device --autotune`` on the card, in a
    subprocess that must exit 0 and end with its JSON summary."""
    import os
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "qwen2.5-3b", "--escalate-layers", "36", "--runtime", "device",
           "--autotune", "--requests", "8", "--max-new", "16"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"serve --escalate-layers exited {proc.returncode}:\n"
             f"{proc.stderr[-3000:]}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    if summary["requests_finished"] != 8:
        fail(f"serve --escalate-layers: {summary}")
    emit({"phase": "escalate_cli", "command": " ".join(cmd[1:]), "rc": 0,
          "seconds": time.perf_counter() - t0,
          "escalations": summary["escalations_total"],
          "final_stage_histogram": summary["final_stage_histogram"],
          "controller": summary["controller"],
          "stages": summary["stages"]})


# ---------------------------------------------------------------------------
# slice 12: the dense family whole on the card
# ---------------------------------------------------------------------------

# the full-width phases' serving cell: lane_batch 4, 2 lanes, cache_len
# 512, chunk 8; 8 requests of 128 / 256 prompt tokens and 16 new
DENSE_ENGINE = dict(lane_batch=4, n_lanes=2, cache_len=512, chunk=8)
# kernels against plain logits at full depth in bf16: both paths round the
# residual stream to bf16 at every layer, at other points (the kernel norm
# multiplies by w in f32 before its rounding, the plain one after; flash
# rounds P to bf16 before P·V; split-KV decode merges in f32), so the
# hidden states part by a few bf16 ulps (2^-8 relative) a layer, summing
# like a random walk over the layers: ~sqrt(62 x 4) x 2^-8 ≈ 6 % at
# deepseek-coder-33b's depth, as a normwise relative error of the logits
LOGIT_REL_TOL = 0.1


def _free_card():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def _logits_against_plain(cfg, model, params, n_steps=2, probe=None,
                          plain_cfg=None, plain_params=None, gate=True,
                          extra=None):
    """The prefill's last-position logits of every exit and the first
    ``n_steps`` dense decode steps' final-exit logits, kernels on against
    the port's plain path (``use_kernels`` off) on the same parameters,
    the kernels' greedy tokens fed to both: normwise relative error each,
    within :data:`LOGIT_REL_TOL`.  With an MoE ``probe``
    (:class:`_RouterProbe`) the plain path routes on the kernel path's
    expert choices, and the errors held to the tolerance are those of the
    rows whose own choices agreed at every layer (the errors over all
    rows are reported beside them).  ``plain_cfg`` / ``plain_params``
    replace the plain side (another dtype's model and weights); with
    ``gate`` False nothing fails; ``extra`` (the audio family's frames,
    4 rows) rides both prefills.  Returns the errors and the share of
    rows whose argmax agrees."""
    import numpy as np
    import torch
    from repro_torch.models.model import build_model
    plain = build_model(plain_cfg or cfg.replace(use_kernels=False),
                        device=DEV)
    plain_params = params if plain_params is None else plain_params
    rng = np.random.default_rng(5)
    B, S = 4, 256
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                           dtype=torch.int32, device=DEV)
    caches = [m.init_cache(B, DENSE_ENGINE["cache_len"])
              for m in (model, plain)]

    def both(kernel, plain_fn, n_tokens, compared):
        """Run the kernel path, then the plain one; the compared rows'
        mask (all rows without a probe)."""
        if probe is not None:
            probe.start("record", n_tokens)
        a = kernel()
        if probe is not None:
            probe.start("replay", n_tokens)
        b = plain_fn()
        rows = (torch.ones(B, dtype=torch.bool) if probe is None
                else probe.finish(compared))
        return a, b, rows.to(DEV)

    with torch.no_grad():
        got, want, rows = both(
            lambda: model.prefill(params, toks, caches[0], extra),
            lambda: plain.prefill(plain_params, toks, caches[1], extra),
            B * S, np.arange(B) * S + S - 1)
        (got, caches[0]), (want, caches[1]) = got, want
        errs = {"prefill": [], "decode": []}
        errs_all = {"prefill": [], "decode": []}
        agree = []

        def rel(a, b, rows):
            a, b = a.float(), b.float()
            agree.append(float((a.argmax(-1) == b.argmax(-1))
                               .float().mean()))
            every = float((a - b).norm() / b.norm())
            if not rows.any():
                return None, every
            a, b = a[rows], b[rows]
            return float((a - b).norm() / b.norm()), every

        for a, b in zip(got, want):
            e, every = rel(a, b, rows)
            errs["prefill"].append(e)
            errs_all["prefill"].append(every)
        for i in range(n_steps):
            tok = got[-1].argmax(-1).to(torch.int32)[:, None]
            (got, caches[0]), (want, caches[1]), rows = both(
                lambda: model.decode_step(params, tok, S + i, caches[0]),
                lambda: plain.decode_step(plain_params, tok, S + i,
                                          caches[1]),
                B, np.arange(B))
            e, every = rel(got[-1], want[-1], rows)
            errs["decode"].append(e)
            errs_all["decode"].append(every)
    held = [e for e in errs["prefill"] + errs["decode"] if e is not None]
    if not held:
        fail(f"{cfg.name}: no compared row's experts agreed at every layer")
    worst = max(held)
    if gate and not worst <= LOGIT_REL_TOL:
        fail(f"{cfg.name}: kernel logits part from the plain path's by "
             f"{worst:.3e} (normwise, tolerance {LOGIT_REL_TOL})")
    del caches, plain
    out = {"rel_err": errs, "max_rel_err": worst, "tolerance":
           LOGIT_REL_TOL, "argmax_agree": agree}
    if probe is not None:
        out["rel_err_all_rows"] = errs_all
        out["max_rel_err_all_rows"] = max(errs_all["prefill"]
                                          + errs_all["decode"])
        out["routing"] = probe.report()
    return out


def _runtime_turns(tag, cfg, model, params, reqs, order,
                   engine=DENSE_ENGINE):
    """Serve ``reqs`` on each runtime of ``order`` in turn (engine settings
    ``engine``): identical streams, carried segments_run, launches and
    routes, one capture a lane and one host sync a lane chunk on the
    device runtime.  Returns (per-runtime records, the device runtime's
    launches, the streams)."""
    import statistics as stats_mod
    runs = {"host": [], "device": []}
    ref = None
    dev_launches = None
    n_req, n_new = len(reqs), reqs[0].max_new_tokens
    for runtime in order:
        fin, st, secs, launches = serve(cfg, model, params, reqs,
                                        runtime=runtime, **engine)
        t = f"{tag} {runtime}"
        if sorted(fin) != list(range(n_req)) or any(
                len(r["tokens"]) != n_new for r in fin.values()):
            fail(f"{t}: not every request got its {n_new} tokens")
        got = {"streams": _streams(fin),
               "segments": st["carried_segments_run"], "launches": launches,
               "routes": {k: st[k] for k in st if k.endswith("_routes")}}
        if ref is None:
            ref = got
        for key, what in got.items():
            if what != ref[key]:
                fail(f"{t}: {key} differ from the first run's: {what} "
                     f"against {ref[key]}")
        if runtime == "device":
            if st["host_syncs"] != st["decode_dispatches"]:
                fail(f"{t}: {st['host_syncs']} host syncs for "
                     f"{st['decode_dispatches']} lane chunks")
            if st["captures"] != engine["n_lanes"]:
                fail(f"{t}: {st['captures']} captures for "
                     f"{engine['n_lanes']} lanes")
            dev_launches = launches
        n_tok = sum(len(r["tokens"]) for r in fin.values())
        runs[runtime].append({
            "decode_us_per_token": st["wallclock_us_per_token"],
            "tokens_per_s": n_tok / secs, "seconds": secs,
            "prefill_seconds": st["prefill_seconds"],
            "compile_seconds": st["compile_seconds"],
            "host_syncs_per_token": st["host_syncs_per_token"],
            "captures": st["captures"], "prefills": st["prefills"],
            "segments_run": st["segments_run"],
            "cohort_dispatch": st["cohort_dispatch"]})
    med = {rt: stats_mod.median(r["decode_us_per_token"] for r in rr)
           for rt, rr in runs.items() if rr}
    return ({"order": ", ".join(order), "identical": True, **runs,
             "decode_us_per_token_median": med, "launches": ref["launches"],
             "routes": ref["routes"]}, dev_launches, ref["streams"])


def phase_dense_full_width(arch, smi, megakernel=False):
    """``arch`` (deepseek-coder-33b or minitron-4b) at its published
    widths and full depth, bf16, seed 0, 3 components, kernels on,
    cond_batch, one cohort, at (0.9, 0.9, 0.0) (untrained heads never
    exit): the card freed of every earlier model first; the parameters'
    init time and the peak device memory; the prefill's and the first
    decode steps' logits against the plain path
    (:func:`_logits_against_plain`); 8 requests on the host and device
    runtimes in turns (host, device, device, host), identical streams.
    With ``megakernel``: the same model with 2 cohorts and
    ``kernel_tune.megakernel`` at a mixed component-0 threshold on the
    device runtime, megakernel on and off (identical streams), so the
    megakernel's route runs at the model's vocabulary.  Returns the
    device runtime's launches by path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import nn
    from repro_torch.models.model import build_model
    held = _free_card()
    base = get_config(arch).replace(use_kernels=True).with_cascade(
        exit_mode="cond_batch", thresholds=(0.9, 0.9, 0.0))
    torch.cuda.reset_peak_memory_stats()
    model = build_model(base, device=DEV)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    init_seconds = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    leaves = list(nn.tree_leaves(params))
    n_params = sum(x.numel() for x in leaves)
    param_bytes = sum(x.numel() * x.element_size() for x in leaves)
    logits = _logits_against_plain(base, model, params)
    reqs = make_requests(8, (128, 256), base.vocab_size, 16, seed=0)
    turns, dev_launches, _ = _runtime_turns(
        arch, base, model, params, reqs, ("host", "device", "device",
                                          "host"))
    check_launched(arch, turns["launches"], SLICE1)
    out = {"one_cohort": dev_launches}
    mega = None
    if megakernel:
        two = base.with_cascade(n_cohorts=2, cohort_layout="major") \
            .with_kernel_tune(megakernel=True)
        zero = two.with_cascade(thresholds=(0.0, 0.0, 0.0))
        calib = serve(zero, model, params, reqs, runtime="device",
                      **DENSE_ENGINE)[0]
        th, quantile = mixed_threshold(
            calib, lambda th: serve(two.with_cascade(
                thresholds=(th, 0.9, 0.0)), model, params, reqs,
                runtime="device", **DENSE_ENGINE)[1]["cohort_dispatch"],
            f"{arch} megakernel")
        mixed = two.with_cascade(thresholds=(th, 0.9, 0.0))
        on, on_launches, on_streams = _runtime_turns(
            f"{arch} megakernel", mixed, model, params, reqs,
            ("device", "host"))
        off, _, off_streams = _runtime_turns(
            f"{arch} megakernel off", mixed.with_kernel_tune(
                megakernel=False), model, params, reqs, ("device",))
        if on_streams != off_streams:
            fail(f"{arch}: the megakernel's streams differ from the unfused "
                 "exit heads'")
        check_launched(f"{arch} megakernel", on["launches"],
                       SLICE1 | {"megakernel"})
        out["megakernel"] = on_launches
        mega = {"thresholds": [th, 0.9, 0.0], "threshold_quantile": quantile,
                "n_cohorts": 2, "on": on, "off": off}
    emit({"phase": "dense_full_width", "config": arch,
          "n_layers": base.n_layers, "d_model": base.d_model,
          "n_heads": base.n_heads, "n_kv_heads": base.n_kv_heads,
          "vocab": base.vocab_size, "dtype": base.dtype, "params": n_params,
          "param_bytes": param_bytes, "held_before": held,
          "init_seconds": init_seconds,
          "init_max_memory_allocated": init_peak,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "logits_against_plain": logits, "thresholds": [0.9, 0.9, 0.0],
          "requests": len(reqs), "max_new_tokens": 16, "turns": turns,
          "megakernel": mega, "nvidia_smi": smi})
    del model, params
    _free_card()
    return out


def phase_dense_variants():
    """A 4-layer f32 model of qwen2.5-3b's widths with layernorm, learned
    absolute positions (``rope_theta=0``) and tied embeddings, all three,
    through the engine at (0.9, 0.9, 0.0) and (0, 0, 0): kernels off; on
    with one cohort; on with 2 cohorts and ``kernel_tune.megakernel`` on
    both runtimes — identical streams, and the megakernel never launched
    (a layernorm head has a bias, a tied head is ``embed.T``: both take
    ``exit_logits`` + ``exit_update``), nor rmsnorm (every norm is a
    layernorm).  Returns the launches of the megakernel run at (0.9, 0.9,
    0.0) on the device runtime."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    import torch
    _free_card()
    base = get_config("qwen2.5-3b").replace(
        n_layers=4, dtype="float32", norm="layernorm", rope_theta=0.0,
        tie_embeddings=True).with_cascade(exit_mode="cond_batch")
    model = build_model(base, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(1))
    if "lm_head" in params or "pos_embed" not in params:
        fail("dense variants: the tree has an lm_head or no pos_embed")
    reqs = make_requests(8, (128, 256), base.vocab_size, 16, seed=1)
    expect = {"exit_update", "decode_attention", "flash_attention"}
    out = None
    for ths in ((0.9, 0.9, 0.0), (0.0, 0.0, 0.0)):
        cfg = base.with_cascade(thresholds=ths)
        mega = cfg.replace(use_kernels=True).with_cascade(
            n_cohorts=2, cohort_layout="major").with_kernel_tune(
            megakernel=True)
        runs = {"kernels_off": (cfg, "host"),
                "kernels_on": (cfg.replace(use_kernels=True), "host"),
                "megakernel_host": (mega, "host"),
                "megakernel_device": (mega, "device")}
        want = None
        rec = {}
        for name, (c, runtime) in runs.items():
            fin, st, secs, launches = serve(
                c, build_model(c, device=DEV), params, reqs,
                runtime=runtime, **DENSE_ENGINE)
            check_launched(f"dense variants {ths} {name}", launches,
                           expect if c.use_kernels else set())
            got = _streams(fin)
            if want is None:
                want = got
            if got != want:
                fail(f"dense variants {ths}: {name} differs from kernels "
                     "off")
            rec[name] = {"launches": launches, "seconds": secs,
                         "decode_us_per_token": st[
                             "wallclock_us_per_token"]}
            if name == "megakernel_device" and ths[0] > 0:
                out = launches
        emit({"phase": "dense_variants", "config": "qwen2.5-3b widths",
              "n_layers": 4, "dtype": "float32", "norm": "layernorm",
              "rope_theta": 0.0, "tie_embeddings": True,
              "thresholds": list(ths), "identical": True,
              "megakernel_launches": 0, "runs": rec})
    del model, params
    _free_card()
    return out


# non-default tiles for the kernel-tune phase's identity runs: another
# vocab split in both exit kernels (exit_update's tile, the megakernel's
# tc CTAs), the megakernel's cuda_core rows, the confidence cluster cap
# and rmsnorm's block rows
TUNE_OTHER = {"exit_update": {"vt": 2048},
              "megakernel": {"tc_ctas": 66, "rows": 2},
              "confidence": {"max_cluster": 4},
              "rmsnorm": {"rows": 4}}


def _median_threshold(fin):
    """The midpoint of the two decode confidences around the median of
    ``fin`` (a run where every token answers at component 0)."""
    import numpy as np
    c = np.sort([x for r in fin.values() for x in r["confs"][1:]])
    i = max(len(c) // 2, 1)
    return float((c[i - 1] + c[i]) / 2)


def phase_kernel_tune():
    """The kernel tile autotuner on the card: ``ensure_tuned`` on the
    tiny and serving presets into a temporary artifact directory (each
    kernel's default and tuned µs and its winner, every row at or above
    1.0), each artifact loaded a second time with no sweep.  Then the
    full-width qwen2.5-3b model (8 requests, device runtime, cache 1024)
    in two cells whose exit decisions the tiles could move: one cohort
    (``exit_update`` decides) at the median of the component-0
    confidences, and 2 cohorts with the megakernel (it decides) at a
    threshold where the cohorts disagree; each served with the default
    tiles, the serving preset's tuned tiles (the engine's constructor
    installs them) and :data:`TUNE_OTHER` — identical tokens and exit
    depths, and both exit depths taken.  Last, tiles installed after a
    lane's capture in the megakernel cell make the lane capture again
    (the capture key holds the registry's generation), the streams still
    the defaults'.  Returns each cell's launches under the tuned tiles."""
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import autotune as kat
    from repro_torch.models.model import build_model
    _free_card()
    kat.reset_tiles()
    arts = {}
    with tempfile.TemporaryDirectory() as tmp:
        for preset in ("tiny", "serving"):
            t0 = time.perf_counter()
            art = kat.ensure_tuned(artifact_dir=tmp, shapes=preset,
                                   device=DEV)
            sweep_s = time.perf_counter() - t0
            bad = [r for r in art.rows if r["tuned_speedup"] < 1.0]
            if bad:
                fail(f"kernel tune {preset}: tuned slower than default "
                     f"{bad}")
            kat.reset_tiles()
            real = kat.sweep

            def no_sweep(*a, **k):
                fail(f"kernel tune {preset}: swept again despite the "
                     "artifact")
            kat.sweep = no_sweep
            try:
                again = kat.ensure_tuned(artifact_dir=tmp, shapes=preset,
                                         device=DEV)
            finally:
                kat.sweep = real
            if again.tiles != art.tiles:
                fail(f"kernel tune {preset}: the artifact loaded other "
                     "tiles")
            kat.reset_tiles()
            arts[preset] = art
            emit({"phase": "kernel_tune", "preset": preset,
                  "sweep_seconds": sweep_s, "device": art.device,
                  "backend": art.backend, "winners": art.tiles,
                  "defaults": kat.DEFAULT_TILES, "rows": art.rows,
                  "loaded_without_sweep": True})
        base = get_config("qwen2.5-3b").replace(use_kernels=True) \
            .with_cascade(exit_mode="cond_batch")
        model = build_model(base, device=DEV)
        params = model.init(torch.Generator(device=DEV).manual_seed(0))
        reqs = make_requests(8, (128, 256), base.vocab_size, 16, seed=0)
        kw = dict(DENSE_ENGINE, cache_len=1024, runtime="device")
        one = base
        two = base.with_cascade(n_cohorts=2, cohort_layout="major") \
            .with_kernel_tune(megakernel=True)
        launches = {}
        wants = {}
        for tag, cell, decider in (("one cohort", one, "exit_update"),
                                   ("two cohorts, megakernel", two,
                                    "megakernel")):
            calib = serve(cell.with_cascade(thresholds=(0.0, 0.0, 0.0)),
                          model, params, reqs, **kw)[0]
            if cell is one:
                th, quantile = _median_threshold(calib), 0.5
            else:
                th, quantile = mixed_threshold(
                    calib, lambda th: serve(cell.with_cascade(
                        thresholds=(th, 0.9, 0.0)), model, params, reqs,
                        **kw)[1]["cohort_dispatch"], f"kernel tune {tag}")
            cfg = cell.with_cascade(thresholds=(th, 0.9, 0.0))
            runs = {}
            for name in ("default", "tuned", "other"):
                kat.reset_tiles()
                c = cfg
                if name == "tuned":
                    c = cfg.with_kernel_tune(enabled=True, artifact_dir=tmp,
                                             shapes="serving")
                elif name == "other":
                    kat.install_tiles(TUNE_OTHER)
                fin, st, _, n = serve(c, model, params, reqs, **kw)
                installed = kat.current_tiles()
                kat.reset_tiles()
                want_tiles = {k: {**kat.DEFAULT_TILES[k], **v} for k, v in (
                    arts["serving"].tiles if name == "tuned" else
                    TUNE_OTHER if name == "other" else {}).items()}
                for k, v in want_tiles.items():
                    if installed[k] != v:
                        fail(f"kernel tune {tag} {name}: {k} ran at "
                             f"{installed[k]}, expected {v}")
                if not n[decider]:
                    fail(f"kernel tune {tag} {name}: {decider} never "
                         "launched")
                depths = [d for r in fin.values() for d in r["exit_depths"]]
                runs[name] = {"streams": _streams(fin), "launches": n,
                              "decode_us_per_token":
                                  st["wallclock_us_per_token"],
                              "exit_depth_counts": {
                                  str(d): depths.count(d)
                                  for d in sorted(set(depths))}}
            if set(runs["default"]["exit_depth_counts"]) != {"0", "2"}:
                fail(f"kernel tune {tag}: exit depths "
                     f"{runs['default']['exit_depth_counts']} at {th}: the "
                     "threshold splits no decisions")
            for name in ("tuned", "other"):
                if runs[name]["streams"] != runs["default"]["streams"]:
                    fail(f"kernel tune {tag}: the {name} tiles' tokens or "
                         "exit depths differ from the defaults'")
            wants[tag] = runs["default"]["streams"]
            launches[tag] = runs["tuned"]["launches"]
            emit({"phase": "kernel_tune_serve", "config": "qwen2.5-3b",
                  "cell": tag, "runtime": "device",
                  "cache_len": kw["cache_len"],
                  "thresholds": [th, 0.9, 0.0],
                  "threshold_quantile": quantile, "identical": True,
                  "tuned_tiles": arts["serving"].tiles,
                  "other_tiles": TUNE_OTHER,
                  **{f"{name}_{k}": r[k] for name, r in runs.items()
                     for k in ("decode_us_per_token", "exit_depth_counts",
                               "launches")}})
            if cell is two:
                mixed = cfg
        # tiles installed after a capture: the lanes capture again
        engine = make_engine(mixed, model, params, **kw)
        for r in reqs:
            engine.submit(r)
        for _ in range(100):    # until a lane's first chunk captured
            if engine.stats()["captures"]:
                break
            engine.step()
        before = engine.stats()["captures"]
        if not before:
            fail("kernel tune: no lane captured in 100 engine steps")
        gen_before = kat.generation()
        after_tiles = {k: TUNE_OTHER[k] for k in ("exit_update",
                                                   "megakernel")}
        kat.install_tiles(after_tiles)
        if kat.generation() == gen_before:
            fail("kernel tune: the install after the capture changed no "
                 "tile")
        fin = engine.run(max_ticks=10_000)
        after = engine.stats()["captures"]
        if after <= before:
            fail(f"kernel tune: {after} captures after an install at "
                 f"{before}: a replay would launch stale tiles")
        if _streams(fin) != wants["two cohorts, megakernel"]:
            fail("kernel tune: the streams after the install differ from "
                 "the defaults'")
        emit({"phase": "kernel_tune_recapture", "config": "qwen2.5-3b",
              "cell": "two cohorts, megakernel", "runtime": "device",
              "captures_before_install": before,
              "captures_after_install": after,
              "installed_after": after_tiles, "recaptured": True,
              "identical": True})
        kat.reset_tiles()
        del engine, model, params
    _free_card()
    return launches


# ---------------------------------------------------------------------------
# slice 14: observability and the fleet tier on the card
# ---------------------------------------------------------------------------

# the slice's serving cell: qwen2.5-3b at full width, the device runtime
# (chunk 8), lane_batch 4, 2 lanes, cache_len 512; 8 requests of 128 / 256
# prompt tokens and 32 new at (0.9, 0.9, 0.0)
OBS_ENGINE = dict(lane_batch=4, n_lanes=2, cache_len=512, chunk=8)
OBS_THRESHOLDS = (0.9, 0.9, 0.0)
# the kernel backend a flight on the card records (the hand-written kernels)
FLIGHT_BACKEND = "cuda"


def qwen_full_width():
    """qwen2.5-3b as registered (36 layers, d 2048, bf16, vocab 151936,
    exits after layers 12 and 24), kernels on, cond_batch, with its seed-0
    weights on the card: (config, model, params)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    base = get_config("qwen2.5-3b").replace(use_kernels=True).with_cascade(
        exit_mode="cond_batch", thresholds=OBS_THRESHOLDS)
    model = build_model(base, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    return base, model, params


def check_launch_total(tag, got, want):
    """A launch count derived from the run's own records (the recorder's
    prefill events, the engine's prefill counters)."""
    if got != want:
        fail(f"{tag}: {got} launches, the run's records give {want}")


def check_device_runtime(tag, st, n_lanes):
    """One host sync a lane chunk and one capture a lane (the recorder
    and a threshold push add neither)."""
    if st["host_syncs"] != st["decode_dispatches"]:
        fail(f"{tag}: {st['host_syncs']} host syncs for "
             f"{st['decode_dispatches']} lane chunks")
    if st["captures"] != n_lanes:
        fail(f"{tag}: {st['captures']} captures for {n_lanes} lanes")


def check_flights(tag, flights, fin):
    """Every finished request's flight is complete: queue_wait, admit, a
    prefill, its chunks and exactly one ``exit`` terminal; the chunks'
    token counts and exit components are the stream after its prefill
    token; the flight records the card's kernels (``cuda``)."""
    from repro_torch.obs.recorder import TERMINAL_KINDS
    for rid, rec in fin.items():
        f = flights.get(rid)
        if f is None:
            fail(f"{tag}: request {rid} has no flight")
        names = [s["name"] for s in f["spans"]]
        terms = [n for n in names if n in TERMINAL_KINDS]
        chunks = [s["attrs"] for s in f["spans"] if s["name"] == "chunk"]
        if (names[:2] != ["queue_wait", "admit"] or "prefill" not in names
                or not chunks or terms != ["exit"]
                or f["terminal"] != "exit"):
            fail(f"{tag}: request {rid}'s flight is incomplete: {names}")
        if (sum(c["tokens"] for c in chunks) != len(rec["tokens"]) - 1
                or [e for c in chunks for e in c["exit_components"]]
                != rec["exit_depths"][1:]):
            fail(f"{tag}: request {rid}'s chunk spans differ from its "
                 "stream")
        if f["attrs"].get("kernel_backend") != FLIGHT_BACKEND:
            fail(f"{tag}: request {rid} recorded kernel backend "
                 f"{f['attrs'].get('kernel_backend')}")


def check_prefill_flash(tag, cfg, launches, recorders):
    """Flash attention launches once a layer for every prefill dispatch
    whose length is a multiple of 128 (fresh 128- and 256-token prompts,
    continuous admissions padded to a power of two) and never for any
    other (a migrated request's prompt + committed prefix), as the
    reference routes them: the recorders' prefill events give the
    lengths."""
    lens = [e["attrs"]["positions"] for rec in recorders
            for e in rec.events.snapshot() if e["name"] == "lane_prefill"]
    if any(rec.events.dropped for rec in recorders):
        fail(f"{tag}: the event log dropped events")
    check_launch_total(f"{tag} flash", launches["flash_attention"],
                       cfg.n_layers * sum(n % 128 == 0 for n in lens))
    return sorted(lens)


def obs_endpoints(eng, fin):
    """The scrape parses back, its exit-component counter sums to the
    tokens served, and the metrics server answers over loopback; the
    trace export validates."""
    import tempfile
    import urllib.request
    from repro_torch.obs import (MetricsServer, export_trace,
                                 parse_prometheus, trace_events)
    samples = parse_prometheus(eng.scrape())
    n_tok = sum(len(r["tokens"]) for r in fin.values())
    exits = sum(s["value"] for s in samples
                if s["name"] == "repro_exit_component_total")
    if exits != n_tok:
        fail(f"obs: repro_exit_component_total sums to {exits}, {n_tok} "
             "tokens were served")
    rid = min(fin)
    with MetricsServer(0, eng.scrape, scrape_json=eng.scrape_json,
                       flights=eng.flights, flight=eng.dump_flight,
                       trace=lambda: trace_events([eng.flight])) as srv:
        base = f"http://127.0.0.1:{srv.port}"

        def get(path):
            return urllib.request.urlopen(base + path, timeout=30).read()

        served = parse_prometheus(get("/metrics").decode())
        if {s["name"] for s in served} != {s["name"] for s in samples}:
            fail("obs: /metrics serves other samples than scrape()")
        as_json = json.loads(get("/metrics.json"))
        flight = json.loads(get(f"/flights/{rid}"))
        trace = json.loads(get("/trace"))["traceEvents"]
    if (flight["rid"] != rid or flight["terminal"] != "exit"
            or "repro_requests_finished_total" not in as_json):
        fail(f"obs: the server answered {flight} / {sorted(as_json)}")
    with tempfile.TemporaryDirectory() as tmp:
        doc = export_trace(f"{tmp}/trace.json", [("engine", eng.flight)])
    return {"samples": len(samples), "exit_component_total": exits,
            "trace_events_served": len(trace),
            "trace_events_exported": len(doc["traceEvents"]),
            "port": srv.port}


def phase_obs(base, model, params):
    """Slice 14's recorder on the card.  (a) The device runtime with the
    recorder off, on, on and off in turns, the 8 requests of phase 3 with
    32 new tokens at (0.9, 0.9, 0.0): identical tokens and exits, launches
    and routes, host syncs (one a lane chunk) and captures (one a lane),
    the replays under sync debug mode "error" (:func:`make_engine`); the
    recorder-on / off µs per token ratio of the medians (not gated: the
    host's clock spreads ~2x between calls).  (b) The host runtime with
    the recorder on: the device runtime's streams.  (c) The paged layout
    (block 16, 2 cohorts, megakernel on), device runtime, recorder on.
    Every flight complete; the scrape, the metrics server over loopback
    and the trace export of (a)'s first recorder-on run."""
    import statistics as stats_mod
    t_phase = time.perf_counter()
    reqs = make_requests(8, (128, 256), base.vocab_size, 32, seed=0)
    n_lanes = OBS_ENGINE["n_lanes"]
    runs = {False: [], True: []}
    ref = endpoints = None
    for obs in (False, True, True, False):
        cfg = base.with_obs() if obs else base
        eng = make_engine(cfg, model, params, runtime="device", **OBS_ENGINE)
        fin, st, secs, launches = serve(cfg, model, params, reqs,
                                        engine=eng)
        tag = f"obs device runtime recorder={'on' if obs else 'off'}"
        if any(len(r["tokens"]) != 32 for r in fin.values()) or len(fin) != 8:
            fail(f"{tag}: not every request got its 32 tokens")
        got = {"streams": _streams(fin), "launches": launches,
               "routes": {k: st[k] for k in st if k.endswith("_routes")},
               "segments": st["carried_segments_run"],
               "host_syncs": st["host_syncs"], "captures": st["captures"]}
        if ref is None:
            ref = got
        for key, what in got.items():
            if what != ref[key]:
                fail(f"{tag}: {key} differ from the recorder-off run's: "
                     f"{what} against {ref[key]}")
        check_device_runtime(tag, st, n_lanes)
        check_launched(tag, launches, SLICE1)
        if obs:
            check_flights(tag, {f["rid"]: f for f in eng.flights()}, fin)
            check_prefill_flash(tag, cfg, launches, [eng.flight])
            if endpoints is None:
                endpoints = obs_endpoints(eng, fin)
        runs[obs].append({
            "decode_us_per_token": st["wallclock_us_per_token"],
            "tokens_per_s": sum(len(r["tokens"]) for r in fin.values())
            / secs, "seconds": secs, "host_syncs": st["host_syncs"],
            "decode_dispatches": st["decode_dispatches"],
            "captures": st["captures"], "obs": st["obs"]})
        del eng
    med = {obs: stats_mod.median(r["decode_us_per_token"] for r in rr)
           for obs, rr in runs.items()}
    # (b) the host runtime, recorder on
    cfg = base.with_obs()
    eng = make_engine(cfg, model, params, runtime="host", **OBS_ENGINE)
    fin, st, _, launches = serve(cfg, model, params, reqs, engine=eng)
    if _streams(fin) != ref["streams"]:
        fail("obs host runtime: its streams differ from the device "
             "runtime's")
    check_launched("obs host runtime", launches, SLICE1)
    check_flights("obs host runtime", {f["rid"]: f for f in eng.flights()},
                  fin)
    host = {"decode_us_per_token": st["wallclock_us_per_token"],
            "host_syncs_per_token": st["host_syncs_per_token"],
            "obs": st["obs"]}
    del eng
    # (c) the paged layout, 2 cohorts, the megakernel, device runtime
    cfg = paged_config(base.with_cascade(n_cohorts=2, cohort_layout="major")
                       ).with_kernel_tune(megakernel=True).with_obs()
    eng = make_engine(cfg, model, params, runtime="device", **OBS_ENGINE)
    fin, st, _, launches = serve(cfg, model, params, reqs, engine=eng)
    check_launched("obs paged", launches, SLICE1 | {"megakernel"})
    check_flights("obs paged", {f["rid"]: f for f in eng.flights()}, fin)
    paged_lens = check_prefill_flash("obs paged", cfg, launches,
                                     [eng.flight])
    if st["memory"]["blocks_used"]:
        fail(f"obs paged: {st['memory']['blocks_used']} blocks still held")
    paged = {"decode_us_per_token": st["wallclock_us_per_token"],
             "captures": st["captures"], "host_syncs": st["host_syncs"],
             "decode_dispatches": st["decode_dispatches"],
             "prefill_lengths": paged_lens, "launches": launches,
             "streams_equal_dense": _streams(fin) == ref["streams"],
             "obs": st["obs"]}
    del eng
    emit({"phase": "obs", "config": "qwen2.5-3b", "n_layers": base.n_layers,
          "dtype": base.dtype, "thresholds": list(OBS_THRESHOLDS),
          "chunk": OBS_ENGINE["chunk"], "requests": 8, "max_new_tokens": 32,
          "order": "off, on, on, off", "identical": True,
          "recorder_off": runs[False], "recorder_on": runs[True],
          "decode_us_per_token_median": {"off": med[False], "on": med[True]},
          "on_over_off_us_per_token": med[True] / med[False],
          "host_runtime": host, "paged": paged, "endpoints": endpoints,
          "launches": ref["launches"],
          "seconds": time.perf_counter() - t_phase})
    return ref["launches"]


def run_fleet(cfg, fleet, reqs, drain_after=None):
    """Submit ``reqs`` to ``fleet`` and run it to the end, with the launch
    counters zeroed before and read after; with ``drain_after``, member 0
    drains in ``migrate`` mode after that many fleet ticks.  Returns
    (seconds, launches, routes, the drain summary, the committed prefixes
    member 0 held when it drained)."""
    import torch
    from repro_torch import kernels
    for r in reqs:
        fleet.submit(r)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    summary, prefixes = None, {}
    if drain_after is not None:
        for _ in range(drain_after):
            fleet.step()
        prefixes = {s.request.rid: list(s.generated)
                    for ln in fleet.members[0].lanes for s in ln["slots"]
                    if not s.done and s.request is not None}
        summary = fleet.drain(0, mode="migrate")
    fleet.run(max_ticks=10_000)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    return seconds, launches, check_routes(cfg, launches), summary, prefixes


def fleet_rates(fleet, seconds):
    """The fleet's decode µs per token (its members' decode windows) and
    tokens per second of wall clock."""
    st = [m.stats() for m in fleet.members]
    sec = sum(s["decode_seconds"] for s in st)
    tok = sum(s["decode_tokens"] for s in st)
    n_tok = sum(len(r["tokens"]) for r in fleet.finished.values())
    return {"decode_us_per_token": 1e6 * sec / tok if tok else None,
            "tokens_per_s": n_tok / seconds, "seconds": seconds,
            "host_syncs": sum(s["host_syncs"] for s in st),
            "decode_dispatches": sum(s["decode_dispatches"] for s in st),
            "captures": [s["captures"] for s in st]}


def phase_fleet(base, model, params):
    """Slice 14's fleet on the card: two members built on one model and
    one set of weights (the serve CLI's rule), device runtime.  (a) Dense,
    one cohort: 16 requests (two members' worth of slots) served in full
    with no migration and by both members, against one engine with 4
    lanes on the same requests (the streams that agree are counted; a
    request's prefill is padded to its lane's longest prompt, so its lane
    mates can change its stream); the fleet's µs per token, tokens per
    second and peak memory beside that engine's.  (b) Paged members
    (block 16, 2 cohorts, megakernel on, recorder on): member 0 drains in
    migrate mode after 3 ticks; every committed prefix kept, no token
    discarded, every budget served, the sibling's replayed prefill > 0,
    one terminal a member flight, migrated requests on both members, a
    valid trace with the drain on the ``fleet`` track, no block held
    after.  (c) Autotune members (32 bins, shadow every 4) under a
    TelemetryAggregator, the 16 requests of (a): at least one resolve and one push, every
    member's thresholds the fleet's, no capture after the first push, and
    a member added afterwards starting at the fleet's vector.  Each run's
    launches are checked by route."""
    import torch
    from repro_torch.fleet import FleetScheduler, TelemetryAggregator
    from repro_torch.obs import validate_trace_events
    t_phase = time.perf_counter()
    out = {}

    def members(cfg, n=2):
        return [make_engine(cfg, model, params, runtime="device",
                            **OBS_ENGINE) for _ in range(n)]

    # (a) dense, one cohort, 16 requests
    reqs16 = make_requests(16, (128, 256), base.vocab_size, 32, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fleet = FleetScheduler(members(base))
    secs, launches, routes, _, _ = run_fleet(base, fleet, reqs16)
    peak_fleet = torch.cuda.max_memory_allocated()
    fin = fleet.finished
    if sorted(fin) != list(range(16)) or any(
            len(r["tokens"]) != 32 or r["migrations"]
            for r in fin.values()):
        fail("fleet dense: not every request got its 32 tokens unmoved")
    if {r["engine"] for r in fin.values()} != {0, 1}:
        fail("fleet dense: one member served everything")
    check_launched("fleet dense", launches, SLICE1)
    dense = fleet_rates(fleet, secs)
    for i, m in enumerate(fleet.members):
        check_device_runtime(f"fleet dense member {i}", m.stats(),
                             OBS_ENGINE["n_lanes"])
    fleet_streams = _streams(fin)
    placements = {rid: r["engine"] for rid, r in fin.items()}
    out["dense"] = launches
    del fleet
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lone_fin, lone_st, lone_secs, lone_launches = serve(
        base, model, params, reqs16, runtime="device",
        **{**OBS_ENGINE, "n_lanes": 4})
    peak_lone = torch.cuda.max_memory_allocated()
    lone_streams = _streams(lone_fin)
    same = sorted(rid for rid in lone_streams
                  if lone_streams[rid] == fleet_streams[rid])
    lone = {"decode_us_per_token": lone_st["wallclock_us_per_token"],
            "tokens_per_s": sum(len(r["tokens"]) for r in lone_fin.values())
            / lone_secs, "seconds": lone_secs,
            "lanes": {rid: r["lane"] for rid, r in lone_fin.items()}}
    torch.cuda.empty_cache()

    # (b) paged members, recorder on, a drain mid-decode
    reqs8 = make_requests(8, (128, 256), base.vocab_size, 32, seed=0)
    pcfg = paged_config(base.with_cascade(n_cohorts=2, cohort_layout="major")
                        ).with_kernel_tune(megakernel=True).with_obs() \
        .with_fleet(n_engines=2, drain_mode="migrate")
    fleet = FleetScheduler(members(pcfg))
    secs, launches, routes_b, summary, prefixes = run_fleet(
        pcfg, fleet, reqs8, drain_after=3)
    fin = fleet.finished
    st = fleet.stats()
    tag = "fleet paged drain"
    if not summary["migrated"]:
        fail(f"{tag}: the drain caught no request in flight: {summary}")
    if sorted(fin) != list(range(8)) or any(len(r["tokens"]) != 32
                                            for r in fin.values()):
        fail(f"{tag}: not every request got its 32 tokens")
    for rid, prefix in prefixes.items():
        if fin[rid]["tokens"][:len(prefix)] != prefix:
            fail(f"{tag}: request {rid} lost its committed prefix")
    sib = fleet.members[1].stats()
    if (st["discarded_tokens"] or 0 not in fleet.drained
            or sib["escalation"]["prefill_positions_replayed"] <= 0):
        fail(f"{tag}: discarded {st['discarded_tokens']}, drained "
             f"{st['drained']}, replayed "
             f"{sib['escalation']['prefill_positions_replayed']}")
    for rid in fin:
        fl = fleet.dump_flight(rid)
        terms = [m["terminal"] for m in fl["members"]]
        if any(t is None for t in terms):
            fail(f"{tag}: request {rid} has a flight with no terminal")
        want = (["migrate"] if rid in summary["completed"]
                else ["migrate", "exit"] if rid in summary["migrated"]
                else ["exit", "cancelled"] if rid in summary["requeued"]
                else ["exit"])
        if sorted(terms, reverse=True) != want:
            fail(f"{tag}: request {rid}'s member flights end {terms}")
        if rid in summary["migrated"] and {m["member"] for m in
                                           fl["members"]} != {0, 1}:
            fail(f"{tag}: migrated request {rid} is not on both members")
    evs = fleet.trace_events()
    validate_trace_events(evs, require_names=("drain",))
    if not any(e["ph"] == "i" and e["name"] == "drain" and e["pid"] == 0
               for e in evs):
        fail(f"{tag}: the trace's fleet track holds no drain")
    for i, m in enumerate(fleet.members):
        if m.stats()["memory"]["blocks_used"]:
            fail(f"{tag}: member {i} still holds blocks")
    check_launched(tag, launches, SLICE1 | {"megakernel"})
    prefill_lens = check_prefill_flash(tag, pcfg, launches,
                                       [m.flight for m in fleet.members])
    n_prefills = sum(m.stats()["prefills"] + m.stats()["slot_prefills"]
                     for m in fleet.members)
    check_launch_total(f"{tag} exit_update", launches["exit_update"],
                       pcfg.cascade.n_components * n_prefills)
    migrated = summary["migrated"]
    drain = {**fleet_rates(fleet, secs), "summary": summary,
             "committed": {rid: len(p) for rid, p in prefixes.items()},
             "replayed_positions":
                 sib["escalation"]["prefill_positions_replayed"],
             "prefill_lengths": prefill_lens,
             "trace_events": len(evs), "launches": launches,
             "routes": routes_b, "events": st["events"]}
    out["paged_drain"] = launches
    del fleet
    torch.cuda.empty_cache()

    # (c) autotune members under a TelemetryAggregator
    acfg = base.with_autotune(**AUTOTUNE)
    ms = members(acfg)
    agg = TelemetryAggregator(acfg, ms[0].mac_prefix, resolve_every=2,
                              min_shadow=8, hysteresis=0.0)
    fleet = FleetScheduler(ms, aggregator=agg)
    from repro_torch import kernels
    # 16 requests fill every slot: each lane of each member captures
    for r in reqs16:
        fleet.submit(r)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    caps_at_push = None
    while fleet._tracked:
        fleet.step()
        if agg.pushes and caps_at_push is None:
            caps_at_push = [m.loop.captures for m in ms]
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    routes_c = check_routes(acfg, launches)
    check_launched("fleet autotune", launches, SLICE1)
    ths = fleet.current_thresholds()
    if agg.resolves < 1 or agg.pushes < 1 or ths is None:
        fail(f"fleet autotune: {agg.resolves} resolves, {agg.pushes} pushes")
    if any(m.current_thresholds() != ths for m in ms):
        fail("fleet autotune: a member's thresholds are not the fleet's")
    caps = [m.loop.captures for m in ms]
    if caps != caps_at_push:
        fail(f"fleet autotune: captures {caps_at_push} at the first push, "
             f"{caps} after")
    for i, m in enumerate(ms):
        check_device_runtime(f"fleet autotune member {i}", m.stats(),
                             OBS_ENGINE["n_lanes"])
    added = make_engine(acfg, model, params, runtime="device", **OBS_ENGINE)
    idx = fleet.add_member(added)
    f32 = [float(torch.tensor(t, dtype=torch.float32)) for t in ths]
    if added.current_thresholds() != ths or any(
            ln["state"].thresholds.tolist() != f32 for ln in added.lanes):
        fail("fleet autotune: the added member did not start at the "
             "fleet's thresholds")
    autotune = {"resolves": agg.resolves, "pushes": agg.pushes,
                "thresholds": list(ths), "captures": caps,
                "added_member": idx, "launches": launches,
                "routes": routes_c,
                "per_member_shadow": agg.per_member_shadow(fleet)}
    del fleet, ms, added
    torch.cuda.empty_cache()
    emit({"phase": "fleet", "config": "qwen2.5-3b",
          "n_layers": base.n_layers, "dtype": base.dtype,
          "thresholds": list(OBS_THRESHOLDS), "members": 2,
          "engine": OBS_ENGINE,
          "dense": {"requests": 16, "max_new_tokens": 32, **dense,
                    "placements": placements,
                    "max_memory_allocated": peak_fleet,
                    "launches": out["dense"], "routes": routes},
          "lone_4_lanes": {**lone, "max_memory_allocated": peak_lone,
                           "launches": lone_launches},
          "streams_equal_lone": len(same), "streams_equal_rids": same,
          "fleet_over_lone_tokens_per_s":
              dense["tokens_per_s"] / lone["tokens_per_s"],
          "fleet_minus_lone_peak_bytes": peak_fleet - peak_lone,
          "paged_drain": {"requests": 8, "max_new_tokens": 32,
                          "migrated": migrated, **drain},
          "autotune": autotune,
          "seconds": time.perf_counter() - t_phase})
    return out


def phase_fleet_cli():
    """``python -m repro_torch.launch.serve --arch qwen2.5-3b --runtime
    device --fleet 2 --drain --obs --trace-out PATH --flight-dump 0
    --max-new 32`` in a subprocess on the card: it must exit 0, its drain
    migrate requests in flight (32 new tokens outlast the 3 ticks before
    it) and its trace validate."""
    import os
    import re
    import tempfile
    from repro_torch.obs import validate_trace_events
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        trace = f"{tmp}/trace.json"
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
               "qwen2.5-3b", "--runtime", "device", "--fleet", "2",
               "--drain", "--obs", "--trace-out", trace, "--flight-dump",
               "0", "--max-new", "32"]
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"serve --fleet 2 exited {proc.returncode}:\n"
                 f"{proc.stderr[-3000:]}")
        with open(trace) as fh:
            doc = json.load(fh)
    validate_trace_events(doc["traceEvents"], require_names=("drain",))
    fleet_line = [ln for ln in proc.stderr.splitlines()
                  if "serve INFO: fleet:" in ln]
    migrated = re.search(r"(\d+) migrations", fleet_line[-1]
                         if fleet_line else "")
    if migrated is None or int(migrated.group(1)) == 0:
        fail(f"serve --fleet 2 --drain migrated nothing: {fleet_line}")
    emit({"phase": "fleet_cli",
          "command": " ".join(cmd[1:]).replace(trace, "TRACE"), "rc": 0,
          "seconds": time.perf_counter() - t0,
          "trace_events": len(doc["traceEvents"]),
          "fleet_line": fleet_line[-1] if fleet_line else None})


# ---------------------------------------------------------------------------
# slice 15: the moe family on the card
# ---------------------------------------------------------------------------

# each model cut in depth only: mixtral-8x7b's 32 layers are 93.9 GB of
# bf16 weights, past one 80 GB card; 8 are ~24 GB (segments (0, 3), (3,
# 5), (5, 8)); qwen3-moe-235b-a22b's 94 layers are 473 GB, 4 are 24.9 GB
# (segments (0, 1), (1, 3), (3, 4)).  16 and 8 layers until slice 24, cut
# for the script's time limit
MOE_LAYERS = {"mixtral-8x7b": 8, "qwen3-moe-235b-a22b": 4}
# mixtral's window run: 4 requests of 33 x 128 prompt tokens (flash takes
# them; T = 16896 routes as 5 groups of 4096, the last padded with 3584
# zero rows) and 32 new, cache_len 4352, so the ring is the 4096-position
# window and decode runs past its wrap
MOE_WINDOW_ENGINE = dict(lane_batch=4, n_lanes=1, cache_len=4352, chunk=8)
MOE_WINDOW_PROMPT = 33 * 128
MOE_WINDOW_NEW = 32
# a router disagreement between the kernel and the plain path is a fault
# unless the k-th and (k+1)-th router logits lie within this many bf16 ulps
# in at least one path (a near-tie that the paths' rounding flips, as the
# reference's routing would).  The ulp is that of the row's largest
# logit: the k-th logit can sit near 0, where its own ulp is far finer
# than the rounding by which the paths' logits part (both ulps are
# reported)
ROUTER_TIE_ULPS = 4


class _RouterProbe:
    """The port's ``moe.route_topk`` wrapped (as the launch counters wrap
    the kernels) inside a ``with`` block: the router of one run held
    against another's on the same inputs — the kernel path against the
    plain one (:func:`_logits_against_plain`), the mesh's model against
    the one-rank model's (:func:`_first_logits`, :func:`_mr_train`).
    Recording (``start("record")``), each call's router logits (f32) and
    chosen experts are kept on the host.  Replaying (``start("replay")``),
    call i routes its own logits, compares them with the recorded call i
    (their normwise relative error) and its expert sets token by token,
    records each disagreement's margins — the gap between the k-th and
    (k+1)-th logit in both runs, in ulps (``mantissa`` bits) of the row's
    largest logit and of its k-th — and the row's largest logit
    difference between the runs, and returns the routing of the recorded
    experts over its own router probabilities: the two runs' hidden
    states then part only by rounding, not by a flipped expert.

    A disagreement is a near-tie, not a fault, where the margin lies
    within ``tie_ulps`` ulps in at least one run (a fixed limit) or, with
    ``tie_ulps`` None, within twice the row's logit difference in both (a
    flip of experts a and b needs |l_a - l_b| that small)."""

    def __init__(self, mantissa=7, tie_ulps=ROUTER_TIE_ULPS):
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe.route_topk
        self.mantissa, self.tie_ulps = mantissa, tie_ulps
        self.mode, self.n_tokens, self.i = None, None, 0
        self.calls = []      # recorded: (logits, experts) a call, host
        self.agree, self.rel = [], []   # this replay's, a call each
        self.layers = []     # per finished replay: (L, T) bool agreement
        self.drift = []      # per finished replay: its rel errs
        self.flips = []      # per disagreement: call, token, margins, tie

    def __enter__(self):
        self.moe.route_topk = self._route
        return self

    def __exit__(self, *exc):
        self.moe.route_topk = self.orig

    def start(self, mode, n_tokens=None):
        """Record (dropping what was recorded) or replay from call 0;
        ``n_tokens``: each call's real tokens (the pad rows after them
        not compared), None for every row."""
        self.mode, self.n_tokens, self.i = mode, n_tokens, 0
        if mode == "record":
            self.calls = []
        else:
            self.agree, self.rel = [], []

    def _route(self, logits, top_k, cap):
        import torch
        own = self.orig(logits, top_k, cap)
        if self.mode == "record":
            self.calls.append((logits.detach().float().cpu(),
                               own.experts.cpu()))
            return own
        call, self.i = self.i, self.i + 1
        if call >= len(self.calls):
            self.rel.append(float("inf"))
            return own
        r_logits, r_experts = self.calls[call]
        E, T = logits.shape[-1], self.n_tokens
        a, b = (x.reshape(-1, E)[:T] for x in (
            r_logits, logits.detach().float().cpu()))
        self.rel.append(float((a - b).norm() / a.norm()))

        def sets(e):
            e = e.reshape(-1, top_k)[:T]
            return torch.zeros(e.shape[0], E, dtype=torch.bool).scatter_(
                1, e, True)
        same = (sets(r_experts) == sets(own.experts.cpu())).all(-1)
        self.agree.append(same)
        for tok in (~same).nonzero().flatten().tolist():
            top = [x[tok].sort(descending=True).values for x in (a, b)]
            gaps = [float(v[top_k - 1] - v[top_k]) for v in top]
            big = [self._ulp(float(x[tok].abs().max())) for x in (a, b)]
            kth = [self._ulp(abs(float(v[top_k - 1]))) for v in top]
            delta = float((a[tok] - b[tok]).abs().max())
            ulps = [g / u for g, u in zip(gaps, big)]
            self.flips.append({
                "call": call, "token": tok, "margin_ulps": ulps,
                "margin_ulps_of_kth": [g / u for g, u in zip(gaps, kth)],
                "row_delta_ulps": delta / big[0],
                "tie": (min(ulps) <= self.tie_ulps
                        if self.tie_ulps is not None
                        else max(gaps) <= 2 * delta)})
        return self.moe.route_experts(torch.softmax(logits.float(), -1),
                                      r_experts.to(logits.device), cap)

    def _ulp(self, x):
        import math
        return 2.0 ** (math.floor(math.log2(max(x, 2.0 ** -126)))
                       - self.mantissa)

    def finish(self, compared):
        """The replayed forward's (L, T) agreement kept; returns whether
        each compared token (indices ``compared``) agreed at every
        layer."""
        import torch
        layers = torch.stack(self.agree)
        self.layers.append(layers)
        self.drift.append(self.rel)
        return layers.all(0)[torch.as_tensor(compared)]

    def report(self, steps=None):
        """The disagreements and faults; by layer over the finished
        forwards, or with ``steps`` (one replay of that many train steps)
        the router logits' error by step."""
        import torch
        faults = [f for f in self.flips if not f["tie"]]
        out = {"disagreements": len(self.flips),
               "max_tie_margin_ulps": max(
                   (min(f["margin_ulps"]) for f in self.flips),
                   default=None),
               "max_tie_margin_ulps_of_kth": max(
                   (min(f["margin_ulps_of_kth"]) for f in self.flips),
                   default=None),
               "mantissa_bits": self.mantissa,
               "tie_ulps_limit": self.tie_ulps,
               "faults": faults[:8], "n_faults": len(faults)}
        if steps is not None:
            n = max(1, len(self.rel) // steps)
            out.update({
                "calls": len(self.calls), "replayed": self.i,
                "logits_rel_err_by_step": [
                    max(self.rel[i:i + n])
                    for i in range(0, len(self.rel), n)],
                "flip_records": self.flips[:20]})
            return out
        layers = torch.cat(self.layers, dim=1)
        every = layers.all(0)
        out.update({
            "tokens": int(every.numel()),
            "agree_share_by_layer": layers.float().mean(1).tolist(),
            # the router logits' normwise relative error between the
            # runs, by layer, worst over the compared forwards
            "logit_rel_err_by_layer": [max(x) for x in zip(*self.drift)],
            "rows_agree_every_layer": float(every.float().mean()),
            "flipped_rows": int((~every).sum())})
        return out


def _expert_bytes(params):
    """Bytes of every expert weight (w_gate, w_up, w_down): what a decode
    step of the GShard formulation reads, every expert's C slots
    computed."""
    return sum(x.numel() * x.element_size()
               for seg in params["segments"] for stage in seg
               for key, x in stage["moe"].items() if key.startswith("w_"))


def phase_moe(arch, smi, window_run=False):
    """``arch`` (mixtral-8x7b or qwen3-moe-235b-a22b) at its published
    widths, cut in depth to :data:`MOE_LAYERS`, bf16, seed 0, 3
    components, kernels on, cond_batch, at (0.9, 0.9, 0.0) (untrained
    heads never exit), alone on the card: the init time and peak memory;
    the logits check (:func:`_logits_against_plain` with a
    :class:`_RouterProbe`: a disagreement wider than a near-tie, fewer
    than half the routed rows agreeing at every layer, or agreeing rows
    past :data:`LOGIT_REL_TOL` fail the phase); 8 requests on the host
    and device runtimes in turns (host, device, device, host), identical
    streams; 2 cohorts with the megakernel at a mixed component-0
    threshold on the device and host runtimes and with the megakernel off,
    identical streams, no step on the all_run branch (the two-way
    dispatch) and some on mixed.  With ``window_run`` (mixtral): 4
    requests of 4224 prompt tokens at cache_len 4352 (the 4096 window's
    ring), device and host runtimes, identical streams past the wrap.
    Prints each run's decode µs per token beside the floor of reading
    every expert weight once a step.  Returns the device runtime's
    launches by path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import nn
    from repro_torch.models.model import build_model
    held = _free_card()
    base = get_config(arch).replace(
        n_layers=MOE_LAYERS[arch], use_kernels=True).with_cascade(
        exit_mode="cond_batch", thresholds=(0.9, 0.9, 0.0))
    torch.cuda.reset_peak_memory_stats()
    model = build_model(base, device=DEV)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    init_seconds = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    leaves = list(nn.tree_leaves(params))
    n_params = sum(x.numel() for x in leaves)
    param_bytes = sum(x.numel() * x.element_size() for x in leaves)
    floor_ms = 1e3 * _expert_bytes(params) / hbm_bytes_per_s()
    with _RouterProbe() as probe:
        logits = _logits_against_plain(base, model, params, probe=probe)
    routing = logits["routing"]
    if routing["n_faults"]:
        fail(f"{arch}: a router disagreement wider than "
             f"{ROUTER_TIE_ULPS} bf16 ulps in both paths: "
             f"{routing['faults']}")
    if routing["rows_agree_every_layer"] < 0.5:
        fail(f"{arch}: {routing['rows_agree_every_layer']:.3f} of the routed "
             "rows agree at every layer (fewer than half)")
    reqs = make_requests(8, (128, 256), base.vocab_size, 16, seed=0)
    turns, dev_launches, _ = _runtime_turns(
        arch, base, model, params, reqs, ("host", "device", "device",
                                          "host"))
    check_launched(arch, turns["launches"], SLICE1)
    out = {"one_cohort": dev_launches}

    two = base.with_cascade(n_cohorts=2, cohort_layout="major") \
        .with_kernel_tune(megakernel=True)
    zero = two.with_cascade(thresholds=(0.0, 0.0, 0.0))
    calib = serve(zero, model, params, reqs, runtime="device",
                  **DENSE_ENGINE)[0]
    th, quantile = mixed_threshold(
        calib, lambda th: serve(two.with_cascade(
            thresholds=(th, 0.9, 0.0)), model, params, reqs,
            runtime="device", **DENSE_ENGINE)[1]["cohort_dispatch"],
        f"{arch} megakernel")
    mixed = two.with_cascade(thresholds=(th, 0.9, 0.0))
    on, on_launches, on_streams = _runtime_turns(
        f"{arch} megakernel", mixed, model, params, reqs,
        ("device", "host"))
    off, _, off_streams = _runtime_turns(
        f"{arch} megakernel off", mixed.with_kernel_tune(megakernel=False),
        model, params, reqs, ("device",))
    if on_streams != off_streams:
        fail(f"{arch}: the megakernel's streams differ from the unfused "
             "exit heads'")
    check_launched(f"{arch} megakernel", on["launches"],
                   SLICE1 | {"megakernel"})
    for rec in on["device"] + on["host"] + off["device"]:
        cd = rec["cohort_dispatch"]
        if cd["all_run"] or not cd["mixed"]:
            fail(f"{arch} 2 cohorts: cohort dispatch {cd} (MoE takes "
                 "all_skip or mixed only)")
    out["megakernel"] = on_launches
    window = None
    if window_run:
        W = model.cache_capacity(MOE_WINDOW_ENGINE["cache_len"])
        if W != base.attn_window:
            fail(f"{arch}: the window run's ring is {W}, not the window")
        wreqs = make_requests(4, (MOE_WINDOW_PROMPT,), base.vocab_size,
                              MOE_WINDOW_NEW, seed=2)
        wturns, w_launches, _ = _runtime_turns(
            f"{arch} window", base, model, params, wreqs,
            ("device", "host"), engine=MOE_WINDOW_ENGINE)
        check_launched(f"{arch} window", wturns["launches"], SLICE1)
        out["window"] = w_launches
        window = {"prompt": MOE_WINDOW_PROMPT, "new": MOE_WINDOW_NEW,
                  "ring": W, "window": base.attn_window,
                  "last_position": MOE_WINDOW_PROMPT + MOE_WINDOW_NEW - 1,
                  **MOE_WINDOW_ENGINE, "turns": wturns}
    dev_us = turns["decode_us_per_token_median"]["device"]
    emit({"phase": "moe", "config": arch, "n_layers": base.n_layers,
          "published_layers": get_config(arch).n_layers,
          "segments": [list(x) for x in base.segments],
          "d_model": base.d_model, "n_heads": base.n_heads,
          "n_kv_heads": base.n_kv_heads, "d_ff": base.d_ff,
          "n_experts": base.n_experts, "top_k": base.top_k,
          "vocab": base.vocab_size, "attn_window": base.attn_window,
          "dtype": base.dtype, "params": n_params,
          "param_bytes": param_bytes, "held_before": held,
          "init_seconds": init_seconds,
          "init_max_memory_allocated": init_peak,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "logits_against_plain": logits, "thresholds": [0.9, 0.9, 0.0],
          "requests": len(reqs), "max_new_tokens": 16, "turns": turns,
          # a decode step of the GShard formulation reads every expert
          # weight once: the floor of a lane step (4 rows) at the data
          # sheet's HBM rate, against the device runtime's µs a token x
          # the lane's 4 rows
          "expert_bytes_per_step": _expert_bytes(params),
          "floor_ms_per_step": floor_ms,
          "device_ms_per_step": (None if dev_us is None
                                 else dev_us * DENSE_ENGINE["lane_batch"]
                                 / 1e3),
          "megakernel": {"thresholds": [th, 0.9, 0.0],
                         "threshold_quantile": quantile, "n_cohorts": 2,
                         "on": on, "off": off},
          "window": window, "nvidia_smi": smi})
    del model, params
    _free_card()
    return out


# the hybrid path's kernels (slice 16): rmsnorm on every pre-norm (the
# gated norm over d_inner stays plain, as the reference's) and exit_update
# on the exit heads; never flash or decode attention (the shared block's
# attention is the plain one)
HYBRID = {"rmsnorm", "exit_update"}
HYBRID_ARCH = "zamba2-1.2b"
# 19 of the 38 layers (all 38 until slice 24, cut for the script's time
# limit): the shared attention block at layers 0, 6, 12 and 18, in every
# segment
HYBRID_LAYERS = 19
# 12 requests of 128 or 256 prompt tokens and one of 300 (the SSD chunk of
# 256 padded to 512) for the 8 slots: a lane re-prefills from a zero state
HYBRID_LONG_PROMPT = 300
HYBRID_AUTOTUNE = dict(enabled=True, bins=32, shadow_every=4)


def _hybrid_requests(vocab):
    import numpy as np
    from repro_torch.serving.engine import Request
    reqs = make_requests(12, (128, 256), vocab, 16, seed=0)
    rng = np.random.default_rng(3)
    reqs.append(Request(rid=12, prompt=rng.integers(
        0, vocab, size=HYBRID_LONG_PROMPT).astype(np.int32),
        max_new_tokens=16))
    return reqs


def _hybrid_step_bytes(model, params, lane_batch, cache_len):
    """Bytes a lane step must move with every segment run: each layer's
    weights once (a mamba, mLSTM or sLSTM layer's, a LoRA delta's), the
    hybrid's shared block's once per invocation, the unembedding once per
    exit head, every state leaf read and written, and every
    shared-attention K/V ring read once (the cache's state leaves at
    ``lane_batch``)."""
    from repro_torch.models import nn

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for x in nn.tree_leaves(tree))
    layers = nbytes(params["segments"])
    n_shared = sum(n for seg in model.segment_runs for k, n in seg
                   if k == "attn_shared")
    cache = model.init_cache(lane_batch, cache_len, device="meta")
    state = ring = 0
    for si, seg in enumerate(cache["segments"]):
        for x, st in zip(nn.tree_leaves(seg), model.state_leaf_mask(si, seg)):
            if st:
                state += 2 * x.numel() * x.element_size()
            else:
                ring += x.numel() * x.element_size()
    heads = model.n_exits * params["lm_head"].numel() \
        * params["lm_head"].element_size()
    parts = {"layer_weights": layers,
             "shared_block": n_shared * nbytes(params.get("shared")),
             "unembeddings": heads, "state_read_write": state,
             "kv_rings": ring}
    return parts, sum(parts.values())


def phase_hybrid(smi):
    """zamba2-1.2b at its published widths cut to :data:`HYBRID_LAYERS` of
    its 38 layers (15 Mamba2 layers, 4 invocations of the shared
    attention block), bf16,
    seed 0, 3 components, kernels on, cond_batch, alone on the card: the
    init time and peak memory; the prefill's and first decode steps'
    logits against the plain path (:func:`_logits_against_plain`); the
    serving engine of the qwen cell (lane batch 4, 2 lanes, cache 512) on
    :func:`_hybrid_requests` (a lane re-prefills; one prompt takes the
    padded SSD chunk) at (0.9, 0.9, 0.0) on the host and device runtimes
    in turns (host, device, device, host) and at (0, 0, 0) (device,
    host), identical streams with one host sync a lane chunk; 2 cohorts
    with the megakernel at a mixed component-0 threshold (the mixed branch
    taken), streams equal with it on and off; select mode with the cohort
    scatter at that vector (its slot route over the shared blocks' rings,
    its whole-cohort route over the state leaves), streams equal to
    cond_batch's; autotune's shadow step there, streams equal on and off;
    and the paged layout refused with the reference's message.  Prints
    each run's µs per token beside the floor of a lane step's bytes.
    Returns the device runtime's launches by path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.macs import param_count
    from repro_torch.models import nn
    from repro_torch.models.model import build_model
    held = _free_card()
    base = get_config(HYBRID_ARCH).replace(
        use_kernels=True, n_layers=HYBRID_LAYERS).with_cascade(
        exit_mode="cond_batch", thresholds=(0.9, 0.9, 0.0))
    torch.cuda.reset_peak_memory_stats()
    model = build_model(base, device=DEV)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    init_seconds = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    leaves = list(nn.tree_leaves(params))
    n_params = sum(x.numel() for x in leaves)
    param_bytes = sum(x.numel() * x.element_size() for x in leaves)
    t_phase = time.perf_counter()
    logits = _logits_against_plain(base, model, params)
    reqs = _hybrid_requests(base.vocab_size)
    turns, dev_launches, _ = _runtime_turns(
        HYBRID_ARCH, base, model, params, reqs,
        ("host", "device", "device", "host"))
    check_launched(HYBRID_ARCH, turns["launches"], HYBRID)
    for rt in ("host", "device"):
        prefills = [r["prefills"] for r in turns[rt]]
        if min(prefills) <= DENSE_ENGINE["n_lanes"]:
            fail(f"{HYBRID_ARCH} {rt}: {prefills} lane prefills (no lane "
                 "re-prefilled)")
    zero = base.with_cascade(thresholds=(0.0, 0.0, 0.0))
    zturns, _, _ = _runtime_turns(f"{HYBRID_ARCH} (0, 0, 0)", zero, model,
                                  params, reqs, ("device", "host"))
    check_launched(f"{HYBRID_ARCH} (0, 0, 0)", zturns["launches"], HYBRID)
    out = {"one_cohort": dev_launches}

    two = base.with_cascade(n_cohorts=2, cohort_layout="major") \
        .with_kernel_tune(megakernel=True)
    calib = serve(two.with_cascade(thresholds=(0.0, 0.0, 0.0)), model,
                  params, reqs, runtime="device", **DENSE_ENGINE)[0]
    th, quantile = mixed_threshold(
        calib, lambda th: serve(two.with_cascade(
            thresholds=(th, 0.9, 0.0)), model, params, reqs,
            runtime="device", **DENSE_ENGINE)[1]["cohort_dispatch"],
        f"{HYBRID_ARCH} megakernel")
    mixed = two.with_cascade(thresholds=(th, 0.9, 0.0))
    on, on_launches, on_streams = _runtime_turns(
        f"{HYBRID_ARCH} megakernel", mixed, model, params, reqs,
        ("device", "host"))
    off, _, off_streams = _runtime_turns(
        f"{HYBRID_ARCH} megakernel off", mixed.with_kernel_tune(
            megakernel=False), model, params, reqs, ("device",))
    if on_streams != off_streams:
        fail(f"{HYBRID_ARCH}: the megakernel's streams differ from the "
             "unfused exit heads'")
    check_launched(f"{HYBRID_ARCH} megakernel", on["launches"],
                   HYBRID | {"megakernel"})
    for rec in on["device"] + on["host"]:
        if not rec["cohort_dispatch"]["mixed"]:
            fail(f"{HYBRID_ARCH} 2 cohorts: the mixed branch never ran "
                 f"({rec['cohort_dispatch']})")
    out["megakernel"] = on_launches
    select, sel_launches, sel_streams = _runtime_turns(
        f"{HYBRID_ARCH} select", mixed.with_cascade(exit_mode="select")
        .with_kernel_tune(cohort_scatter=True), model, params, reqs,
        ("device", "host"))
    if sel_streams != on_streams:
        fail(f"{HYBRID_ARCH}: select mode's streams differ from "
             "cond_batch's")
    check_launched(f"{HYBRID_ARCH} select", select["launches"],
                   HYBRID | {"megakernel", "cohort_scatter"})
    out["select_scatter"] = sel_launches
    shadow, tune_launches, tune_streams = _runtime_turns(
        f"{HYBRID_ARCH} autotune", mixed.with_autotune(**HYBRID_AUTOTUNE),
        model, params, reqs, ("device", "host"))
    if tune_streams != on_streams:
        fail(f"{HYBRID_ARCH}: autotune's shadow steps changed the streams")
    check_launched(f"{HYBRID_ARCH} autotune", shadow["launches"],
                   HYBRID | {"megakernel"})
    out["autotune"] = tune_launches
    from repro_torch.serving.engine import CascadeServingEngine
    paged = base.with_paged_cache(layout="paged", block_size=16)
    try:
        CascadeServingEngine(paged, model, params, device=DEV,
                             **DENSE_ENGINE)
        fail(f"{HYBRID_ARCH}: the paged layout was not refused")
    except ValueError as err:
        refusal = str(err)
    if "non-attention cache stage (['conv', 'state'])" not in refusal:
        fail(f"{HYBRID_ARCH}: paged refusal {refusal!r}")
    phase_seconds = time.perf_counter() - t_phase
    parts, step_bytes = _hybrid_step_bytes(
        model, params, DENSE_ENGINE["lane_batch"], DENSE_ENGINE["cache_len"])
    floor_ms = 1e3 * step_bytes / hbm_bytes_per_s()
    med = turns["decode_us_per_token_median"]
    emit({"phase": "hybrid", "config": HYBRID_ARCH,
          "n_layers": base.n_layers, "segments": [list(x) for x in
                                                  base.segments],
          "segment_runs": model.segment_runs, "d_model": base.d_model,
          "n_heads": base.n_heads, "d_ff": base.d_ff,
          "ssm_state": base.ssm_state, "ssm_head_dim": base.ssm_head_dim,
          "ssm_expand": base.ssm_expand, "vocab": base.vocab_size,
          "dtype": base.dtype, "params": n_params,
          "param_count_analytic": param_count(base),
          "param_bytes": param_bytes, "held_before": held,
          "init_seconds": init_seconds,
          "init_max_memory_allocated": init_peak,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "logits_against_plain": logits, "thresholds": [0.9, 0.9, 0.0],
          "requests": len(reqs), "prompt_lens": sorted(
              {len(r.prompt) for r in reqs}), "max_new_tokens": 16,
          "turns": turns, "turns_all_exit": zturns,
          "decode_us_per_token": med,
          "step_bytes": parts, "floor_ms_per_step": floor_ms,
          "device_ms_per_step": (None if med.get("device") is None
                                 else med["device"]
                                 * DENSE_ENGINE["lane_batch"] / 1e3),
          "host_ms_per_step": (None if med.get("host") is None
                               else med["host"]
                               * DENSE_ENGINE["lane_batch"] / 1e3),
          "megakernel": {"thresholds": [th, 0.9, 0.0],
                         "threshold_quantile": quantile, "n_cohorts": 2,
                         "on": on, "off": off},
          "select_scatter": select, "autotune": {**HYBRID_AUTOTUNE,
                                                 "turns": shadow},
          "paged_refusal": refusal, "phase_seconds": phase_seconds,
          "nvidia_smi": smi})
    del model, params
    _free_card()
    return out


# the ssm path's kernels (slice 17): rmsnorm on every block pre-norm, the
# exit norms and the final norm (the mLSTM out norm over d_inner stays
# plain, as the reference's) and exit_update on the exit heads; the
# megakernel where it is on and the cohort scatter's whole-cohort route in
# select mode; never an attention kernel
SSM = {"rmsnorm", "exit_update"}
SSM_ARCH = "xlstm-350m"
# the ssm phase's depth: 8 of xlstm-350m's 24 layers (slice 22 cut it to
# 12 to keep the script inside its limit with the multi-rank phase, slice
# 23 to 8 with the multi-rank train phase: one sLSTM layer of every six)
SSM_LAYERS = 8
# one lane prefill of 4 fresh rows of 256 tokens (one mLSTM chunk; the
# sLSTM scan a cell a position)
SSM_PREFILL = (4, 256)


def _profile_prefill(model, params, B, S):
    """One lane prefill of B fresh rows of S tokens: its host seconds,
    synchronised (two calls), and the device kernels it launches, by
    torch.profiler (the sLSTM scan's per-position cells are most of
    them)."""
    import numpy as np
    import torch
    toks = torch.as_tensor(np.random.default_rng(11).integers(
        0, model.cfg.vocab_size, (B, S)), dtype=torch.int32, device=DEV)
    secs = []
    with torch.no_grad():
        for _ in range(2):
            cache = model.init_cache(B, DENSE_ENGINE["cache_len"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.prefill(params, toks, cache)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        cache = model.init_cache(B, DENSE_ENGINE["cache_len"])
        kernels = _device_kernels(lambda: model.prefill(params, toks, cache))
    return {"rows": B, "tokens": S, "seconds": secs,
            "device_kernel_launches": sum(n for _, n in kernels),
            "top_kernels": sorted(kernels, key=lambda k: -k[1])[:8]}


def _ssm_logits(base, model, params):
    """xlstm-350m's full-depth logits against the plain path.  At random
    weights the family amplifies rounding (the mLSTM normaliser and the
    sLSTM gates, a few-fold a layer): in bf16 the plain path itself parts
    from its own f32 run by more than :data:`LOGIT_REL_TOL` (0.15 at the
    first exit, 0.7 at the decode steps on an H100), so the bf16
    kernel path's distance from the bf16 plain path measures that
    amplification of a rounding difference, not the kernels.  Gated at
    :data:`LOGIT_REL_TOL`: the same seed-0 weights widened to f32, the
    kernels (their f32 routes) against the plain path.  Reported beside
    it, ungated, on the same tokens: the bf16 kernel path against the
    bf16 plain path, and the bf16 plain path against the f32 one."""
    import torch
    from repro_torch.models import nn
    from repro_torch.models.model import build_model
    cfg32 = base.replace(dtype="float32")
    params32 = nn.tree_map(
        lambda x: x.float() if x.is_floating_point() else x, params)
    out = _logits_against_plain(cfg32, build_model(cfg32, device=DEV),
                                params32)
    out["bf16_kernel_vs_bf16_plain"] = _logits_against_plain(
        base, model, params, gate=False)
    plain = base.replace(use_kernels=False)
    out["bf16_plain_vs_f32_plain"] = _logits_against_plain(
        plain, build_model(plain, device=DEV), params, plain_cfg=cfg32,
        plain_params=params32, gate=False)
    del params32
    torch.cuda.empty_cache()
    return out


def phase_ssm(smi):
    """xlstm-350m at its published widths cut to :data:`SSM_LAYERS` of its
    24 layers (full depth until slice 22, whose multi-rank phase needed
    the time), bf16, seed 0, 3 components, kernels on,
    cond_batch, alone on the card: the init time and peak memory; the
    prefill's and first decode steps' logits against the plain path, in
    f32 (:func:`_ssm_logits`: bf16's own rounding, amplified, parts the
    bf16 paths); one lane prefill of 4 x 256 tokens,
    timed and its device kernels counted; the serving engine of the qwen
    cell (lane batch 4, 2 lanes, cache 512) on :func:`_hybrid_requests`
    (a lane re-prefills from the caches' init values; the 300-token prompt
    takes the padded mLSTM chunk) at (0.9, 0.9, 0.0) on the host and
    device runtimes in turns (host, device, device, host) and at (0, 0, 0)
    (device, host), identical streams with one host sync a lane chunk; 2
    cohorts with the megakernel at a mixed component-0 threshold (the
    mixed branch taken: the cohorts disagree; the family steps every deep
    segment per cohort in any branch), streams equal with it on and off;
    select mode with the cohort scatter at that vector (its whole-cohort
    route only: the family has no ring leaf), streams equal to
    cond_batch's;
    autotune's shadow step there, streams equal on and off; and the paged
    layout refused with the reference's message.  Prints each run's µs
    per token beside the floor of a lane step's bytes.  Returns the device
    runtime's launches by path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.macs import param_count
    from repro_torch.models import nn
    from repro_torch.models.model import build_model
    held = _free_card()
    base = get_config(SSM_ARCH).replace(
        use_kernels=True, n_layers=SSM_LAYERS).with_cascade(
            exit_mode="cond_batch", thresholds=(0.9, 0.9, 0.0))
    torch.cuda.reset_peak_memory_stats()
    model = build_model(base, device=DEV)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    init_seconds = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    leaves = list(nn.tree_leaves(params))
    n_params = sum(x.numel() for x in leaves)
    param_bytes = sum(x.numel() * x.element_size() for x in leaves)
    t_phase = time.perf_counter()
    logits = _ssm_logits(base, model, params)
    prefill = _profile_prefill(model, params, *SSM_PREFILL)
    reqs = _hybrid_requests(base.vocab_size)
    turns, dev_launches, _ = _runtime_turns(
        SSM_ARCH, base, model, params, reqs,
        ("host", "device", "device", "host"))
    check_launched(SSM_ARCH, turns["launches"], SSM)
    for rt in ("host", "device"):
        prefills = [r["prefills"] for r in turns[rt]]
        if min(prefills) <= DENSE_ENGINE["n_lanes"]:
            fail(f"{SSM_ARCH} {rt}: {prefills} lane prefills (no lane "
                 "re-prefilled)")
    zero = base.with_cascade(thresholds=(0.0, 0.0, 0.0))
    zturns, _, _ = _runtime_turns(f"{SSM_ARCH} (0, 0, 0)", zero, model,
                                  params, reqs, ("device", "host"))
    check_launched(f"{SSM_ARCH} (0, 0, 0)", zturns["launches"], SSM)
    out = {"one_cohort": dev_launches}

    two = base.with_cascade(n_cohorts=2, cohort_layout="major") \
        .with_kernel_tune(megakernel=True)
    calib = serve(two.with_cascade(thresholds=(0.0, 0.0, 0.0)), model,
                  params, reqs, runtime="device", **DENSE_ENGINE)[0]
    th, quantile = mixed_threshold(
        calib, lambda th: serve(two.with_cascade(
            thresholds=(th, 0.9, 0.0)), model, params, reqs,
            runtime="device", **DENSE_ENGINE)[1]["cohort_dispatch"],
        f"{SSM_ARCH} megakernel")
    mixed = two.with_cascade(thresholds=(th, 0.9, 0.0))
    on, on_launches, on_streams = _runtime_turns(
        f"{SSM_ARCH} megakernel", mixed, model, params, reqs,
        ("device", "host"))
    off, _, off_streams = _runtime_turns(
        f"{SSM_ARCH} megakernel off", mixed.with_kernel_tune(
            megakernel=False), model, params, reqs, ("device",))
    if on_streams != off_streams:
        fail(f"{SSM_ARCH}: the megakernel's streams differ from the "
             "unfused exit heads'")
    check_launched(f"{SSM_ARCH} megakernel", on["launches"],
                   SSM | {"megakernel"})
    for rec in on["device"] + on["host"]:
        if not rec["cohort_dispatch"]["mixed"]:
            fail(f"{SSM_ARCH} 2 cohorts: the mixed branch never ran "
                 f"({rec['cohort_dispatch']})")
    out["megakernel"] = on_launches
    select, sel_launches, sel_streams = _runtime_turns(
        f"{SSM_ARCH} select", mixed.with_cascade(exit_mode="select")
        .with_kernel_tune(cohort_scatter=True), model, params, reqs,
        ("device", "host"))
    if sel_streams != on_streams:
        fail(f"{SSM_ARCH}: select mode's streams differ from "
             "cond_batch's")
    check_launched(f"{SSM_ARCH} select", select["launches"],
                   SSM | {"megakernel", "cohort_scatter"})
    out["select_scatter"] = sel_launches
    shadow, tune_launches, tune_streams = _runtime_turns(
        f"{SSM_ARCH} autotune", mixed.with_autotune(**HYBRID_AUTOTUNE),
        model, params, reqs, ("device", "host"))
    if tune_streams != on_streams:
        fail(f"{SSM_ARCH}: autotune's shadow steps changed the streams")
    check_launched(f"{SSM_ARCH} autotune", shadow["launches"],
                   SSM | {"megakernel"})
    out["autotune"] = tune_launches
    from repro_torch.serving.engine import CascadeServingEngine
    paged = base.with_paged_cache(layout="paged", block_size=16)
    try:
        CascadeServingEngine(paged, model, params, device=DEV,
                             **DENSE_ENGINE)
        fail(f"{SSM_ARCH}: the paged layout was not refused")
    except ValueError as err:
        refusal = str(err)
    if "non-attention cache stage (['C', 'conv', 'm', 'n'])" not in refusal:
        fail(f"{SSM_ARCH}: paged refusal {refusal!r}")
    phase_seconds = time.perf_counter() - t_phase
    parts, step_bytes = _hybrid_step_bytes(
        model, params, DENSE_ENGINE["lane_batch"], DENSE_ENGINE["cache_len"])
    floor_ms = 1e3 * step_bytes / hbm_bytes_per_s()
    med = turns["decode_us_per_token_median"]
    lane_prefill = {rt: [r["prefill_seconds"] / r["prefills"]
                         for r in turns[rt]] for rt in ("host", "device")}
    emit({"phase": "ssm", "config": SSM_ARCH,
          "n_layers": base.n_layers, "segments": [list(x) for x in
                                                  base.segments],
          "segment_runs": model.segment_runs, "d_model": base.d_model,
          "n_heads": base.n_heads, "d_ff": base.d_ff,
          "slstm_every": base.slstm_every, "vocab": base.vocab_size,
          "dtype": base.dtype, "params": n_params,
          "param_count_analytic": param_count(base),
          "param_bytes": param_bytes, "held_before": held,
          "init_seconds": init_seconds,
          "init_max_memory_allocated": init_peak,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "logits_against_plain": logits, "prefill": prefill,
          "lane_prefill_seconds_mean": lane_prefill,
          "thresholds": [0.9, 0.9, 0.0],
          "requests": len(reqs), "prompt_lens": sorted(
              {len(r.prompt) for r in reqs}), "max_new_tokens": 16,
          "turns": turns, "turns_all_exit": zturns,
          "decode_us_per_token": med,
          "step_bytes": parts, "floor_ms_per_step": floor_ms,
          "device_ms_per_step": (None if med.get("device") is None
                                 else med["device"]
                                 * DENSE_ENGINE["lane_batch"] / 1e3),
          "host_ms_per_step": (None if med.get("host") is None
                               else med["host"]
                               * DENSE_ENGINE["lane_batch"] / 1e3),
          "megakernel": {"thresholds": [th, 0.9, 0.0],
                         "threshold_quantile": quantile, "n_cohorts": 2,
                         "on": on, "off": off},
          "select_scatter": select, "autotune": {**HYBRID_AUTOTUNE,
                                                 "turns": shadow},
          "paged_refusal": refusal, "phase_seconds": phase_seconds,
          "nvidia_smi": smi})
    del model, params
    _free_card()
    return out


# ---------------------------------------------------------------------------
# slice 18: the audio family on the card
# ---------------------------------------------------------------------------

AUDIO = {"exit_update", "decode_attention", "flash_attention"}
AUDIO_ARCH = "whisper-tiny"
# the qwen cell's engine at whisper's position limit (max_seq_len 448):
# no position clamps
AUDIO_ENGINE = dict(lane_batch=4, n_lanes=2, cache_len=448, chunk=8)
# one lane prefill of 4 fresh rows of 256 tokens over the engine's zero
# frames
AUDIO_PREFILL = (4, 256)


def _audio_prefill(model, params, B, S):
    """One lane prefill of B fresh rows of S tokens over the engine's zero
    frames: its host seconds and the encoder's alone (two calls each,
    synchronised), and the device kernels the prefill launches (by
    torch.profiler)."""
    import numpy as np
    import torch
    cfg = model.cfg
    toks = torch.as_tensor(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (B, S)), dtype=torch.int32, device=DEV)
    frames = torch.zeros(B, cfg.n_audio_frames, cfg.d_model, device=DEV)
    extra = {"audio_embeds": frames}
    secs, enc = [], []

    def timed(fn, into):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        into.append(time.perf_counter() - t0)

    with torch.no_grad():
        for _ in range(2):
            cache = model.init_cache(B, AUDIO_ENGINE["cache_len"])
            timed(lambda: model.prefill(params, toks, cache, extra), secs)
        for _ in range(2):
            timed(lambda: model._encode_audio(params, frames), enc)
        cache = model.init_cache(B, AUDIO_ENGINE["cache_len"])
        kernels = _device_kernels(lambda: model.prefill(params, toks, cache,
                                                        extra))
    return {"rows": B, "tokens": S, "frames": cfg.n_audio_frames,
            "seconds": secs, "encoder_seconds": enc,
            "encoder_share": min(enc) / min(secs),
            "device_kernel_launches": sum(n for _, n in kernels),
            "top_kernels": sorted(kernels, key=lambda k: -k[1])[:8]}


def _audio_step_bytes(model, params, lane_batch, cache_len):
    """Bytes a lane step must move with every segment run: each decoder
    layer's weights once but the cross-attention's K and V projections
    (decode reads the cached K/V instead), the unembedding once per exit
    head, and every cross K/V leaf and self K/V ring read once (the audio
    family's encdec stages, the vlm family's dense and xattn stages)."""
    from repro_torch.models import nn

    def nbytes(leaves):
        return sum(x.numel() * x.element_size() for x in leaves)
    layers = nbytes(nn.tree_leaves(params["segments"])) - nbytes(
        stage["xattn"][k] for seg in params["segments"] for stage in seg
        if "xattn" in stage for k in ("wk", "wv"))
    cache = model.init_cache(lane_batch, cache_len, device="meta")
    kinds = {"read": 0, "ring": 0}
    for si, seg in enumerate(cache["segments"]):
        for x, k in zip(nn.tree_leaves(seg), model.leaf_kinds(si, seg)):
            kinds[k] += x.numel() * x.element_size()
    parts = {"decoder_weights": layers,
             "unembeddings": model.n_exits * nbytes([params["lm_head"]]),
             "cross_kv": kinds["read"], "self_kv_rings": kinds["ring"]}
    return parts, sum(parts.values())


def phase_audio(smi):
    """whisper-tiny at its published widths and full depth (4 decoder
    encdec layers, a 4-layer encoder over 1500 frames), bf16, seed 0, 3
    components, kernels on, cond_batch, alone on the card: the init time
    and peak memory; the prefill's and first decode steps' logits against
    the plain path over random frames; one lane prefill of 4 x 256 tokens
    timed with the encoder's share, its device kernels counted; the
    serving engine of the qwen cell at cache_len 448 (lane batch 4, 2
    lanes) on :func:`_hybrid_requests` (12 of 128 or 256 prompt tokens,
    one of 300 whose lane takes the plain attention; a lane re-prefills,
    its cross K/V rewritten in place) at (0.9, 0.9, 0.0) on the host and
    device runtimes in turns (host, device, device, host) and at (0, 0,
    0) (device, host), identical streams with one host sync a lane chunk;
    2 cohorts with the megakernel at a mixed component-0 threshold (the
    mixed branch taken; 0 megakernel launches: the layernorm heads take
    exit_update), streams equal with it on and off; select mode with the
    cohort scatter at that vector (its slot route only: the cross K/V are
    read-only), streams equal to cond_batch's; autotune's shadow step
    there, streams equal on and off; and the paged layout refused with
    the reference's message.  Prints each run's µs per token beside the
    floor of a lane step's bytes.  Returns the device runtime's launches
    by path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.macs import param_count
    from repro_torch.models import nn
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import CascadeServingEngine
    held = _free_card()
    base = get_config(AUDIO_ARCH).replace(use_kernels=True).with_cascade(
        exit_mode="cond_batch", thresholds=(0.9, 0.9, 0.0))
    torch.cuda.reset_peak_memory_stats()
    model = build_model(base, device=DEV)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    init_seconds = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    leaves = list(nn.tree_leaves(params))
    n_params = sum(x.numel() for x in leaves)
    param_bytes = sum(x.numel() * x.element_size() for x in leaves)
    encoder_params = sum(x.numel()
                         for x in nn.tree_leaves(params["encoder"]))
    t_phase = time.perf_counter()
    frames = torch.randn(
        4, base.n_audio_frames, base.d_model, device=DEV,
        generator=torch.Generator(device=DEV).manual_seed(7))
    logits = _logits_against_plain(base, model, params,
                                   extra={"audio_embeds": frames})
    del frames
    prefill = _audio_prefill(model, params, *AUDIO_PREFILL)
    reqs = _hybrid_requests(base.vocab_size)
    turns, dev_launches, _ = _runtime_turns(
        AUDIO_ARCH, base, model, params, reqs,
        ("host", "device", "device", "host"), engine=AUDIO_ENGINE)
    check_launched(AUDIO_ARCH, turns["launches"], AUDIO)
    for rt in ("host", "device"):
        prefills = [r["prefills"] for r in turns[rt]]
        if min(prefills) <= AUDIO_ENGINE["n_lanes"]:
            fail(f"{AUDIO_ARCH} {rt}: {prefills} lane prefills (no lane "
                 "re-prefilled)")
    zero = base.with_cascade(thresholds=(0.0, 0.0, 0.0))
    zturns, _, _ = _runtime_turns(f"{AUDIO_ARCH} (0, 0, 0)", zero, model,
                                  params, reqs, ("device", "host"),
                                  engine=AUDIO_ENGINE)
    check_launched(f"{AUDIO_ARCH} (0, 0, 0)", zturns["launches"], AUDIO)
    out = {"one_cohort": dev_launches}

    two = base.with_cascade(n_cohorts=2, cohort_layout="major") \
        .with_kernel_tune(megakernel=True)
    calib = serve(two.with_cascade(thresholds=(0.0, 0.0, 0.0)), model,
                  params, reqs, runtime="device", **AUDIO_ENGINE)[0]
    th, quantile = mixed_threshold(
        calib, lambda th: serve(two.with_cascade(
            thresholds=(th, 0.9, 0.0)), model, params, reqs,
            runtime="device", **AUDIO_ENGINE)[1]["cohort_dispatch"],
        f"{AUDIO_ARCH} megakernel")
    mixed = two.with_cascade(thresholds=(th, 0.9, 0.0))
    on, on_launches, on_streams = _runtime_turns(
        f"{AUDIO_ARCH} megakernel", mixed, model, params, reqs,
        ("device", "host"), engine=AUDIO_ENGINE)
    off, _, off_streams = _runtime_turns(
        f"{AUDIO_ARCH} megakernel off", mixed.with_kernel_tune(
            megakernel=False), model, params, reqs, ("device",),
        engine=AUDIO_ENGINE)
    if on_streams != off_streams:
        fail(f"{AUDIO_ARCH}: the streams with the megakernel on differ "
             "from those with it off")
    # the layernorm heads never take the fusion: 0 megakernel launches
    check_launched(f"{AUDIO_ARCH} megakernel", on["launches"], AUDIO)
    for rec in on["device"] + on["host"]:
        if not rec["cohort_dispatch"]["mixed"]:
            fail(f"{AUDIO_ARCH} 2 cohorts: the mixed branch never ran "
                 f"({rec['cohort_dispatch']})")
    out["megakernel"] = on_launches
    select, sel_launches, sel_streams = _runtime_turns(
        f"{AUDIO_ARCH} select", mixed.with_cascade(exit_mode="select")
        .with_kernel_tune(cohort_scatter=True), model, params, reqs,
        ("device", "host"), engine=AUDIO_ENGINE)
    if sel_streams != on_streams:
        fail(f"{AUDIO_ARCH}: select mode's streams differ from "
             "cond_batch's")
    check_launched(f"{AUDIO_ARCH} select", select["launches"],
                   AUDIO | {"cohort_scatter"})
    out["select_scatter"] = sel_launches
    shadow, tune_launches, tune_streams = _runtime_turns(
        f"{AUDIO_ARCH} autotune", mixed.with_autotune(**HYBRID_AUTOTUNE),
        model, params, reqs, ("device", "host"), engine=AUDIO_ENGINE)
    if tune_streams != on_streams:
        fail(f"{AUDIO_ARCH}: autotune's shadow steps changed the streams")
    check_launched(f"{AUDIO_ARCH} autotune", shadow["launches"], AUDIO)
    out["autotune"] = tune_launches
    paged = base.with_paged_cache(layout="paged", block_size=16)
    try:
        CascadeServingEngine(paged, model, params, device=DEV,
                             **AUDIO_ENGINE)
        fail(f"{AUDIO_ARCH}: the paged layout was not refused")
    except ValueError as err:
        refusal = str(err)
    if "non-attention cache stage (['cross', 'self'])" not in refusal:
        fail(f"{AUDIO_ARCH}: paged refusal {refusal!r}")
    phase_seconds = time.perf_counter() - t_phase
    parts, step_bytes = _audio_step_bytes(
        model, params, AUDIO_ENGINE["lane_batch"],
        AUDIO_ENGINE["cache_len"])
    floor_ms = 1e3 * step_bytes / hbm_bytes_per_s()
    med = turns["decode_us_per_token_median"]
    lane_prefill = {rt: [r["prefill_seconds"] / r["prefills"]
                         for r in turns[rt]] for rt in ("host", "device")}
    emit({"phase": "audio", "config": AUDIO_ARCH,
          "n_layers": base.n_layers, "encoder_layers": base.encoder_layers,
          "segments": [list(x) for x in base.segments],
          "segment_runs": model.segment_runs, "d_model": base.d_model,
          "n_heads": base.n_heads, "head_dim": base.resolved_head_dim,
          "d_ff": base.d_ff, "vocab": base.vocab_size,
          "n_audio_frames": base.n_audio_frames, "dtype": base.dtype,
          "params": n_params, "encoder_params": encoder_params,
          "param_count_analytic": param_count(base),
          "param_bytes": param_bytes, "held_before": held,
          "init_seconds": init_seconds,
          "init_max_memory_allocated": init_peak,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "logits_against_plain": logits, "prefill": prefill,
          "lane_prefill_seconds_mean": lane_prefill,
          "engine": AUDIO_ENGINE, "thresholds": [0.9, 0.9, 0.0],
          "requests": len(reqs), "prompt_lens": sorted(
              {len(r.prompt) for r in reqs}), "max_new_tokens": 16,
          "turns": turns, "turns_all_exit": zturns,
          "decode_us_per_token": med,
          "step_bytes": parts, "floor_ms_per_step": floor_ms,
          "device_ms_per_step": (None if med.get("device") is None
                                 else med["device"]
                                 * AUDIO_ENGINE["lane_batch"] / 1e3),
          "host_ms_per_step": (None if med.get("host") is None
                               else med["host"]
                               * AUDIO_ENGINE["lane_batch"] / 1e3),
          "megakernel": {"thresholds": [th, 0.9, 0.0],
                         "threshold_quantile": quantile, "n_cohorts": 2,
                         "on": on, "off": off},
          "select_scatter": select, "autotune": {**HYBRID_AUTOTUNE,
                                                 "turns": shadow},
          "paged_refusal": refusal, "phase_seconds": phase_seconds,
          "nvidia_smi": smi})
    del model, params
    _free_card()
    return out


# the vlm path's kernels (slice 19): rmsnorm on every norm (block route at
# d 8192), exit_update on the exit heads, decode attention in the dense
# layers (the xattn layers' cross-attention is the plain one, as the
# reference's), flash attention in the prefills of S % 128 == 0; the
# megakernel where it is on and the cohort scatter's slot route in select
# mode (the xattn K/V are read-only, never landed)
VLM = {"rmsnorm", "exit_update", "decode_attention", "flash_attention"}
VLM_ARCH = "llama-3.2-vision-90b"
# the published widths cut to 15 of 100 layers (30 until slice 21, 20
# until slice 24, cut for the script's time limit): the 1:5 pattern kept,
# xattn at layers 4, 9, 14, every segment holding dense and xattn layers;
# the embedding and the shared unembedding 2.1 GB each
VLM_LAYERS = 15
# the qwen cell's engine
VLM_ENGINE = dict(lane_batch=4, n_lanes=2, cache_len=512, chunk=8)
# one lane prefill of 4 fresh rows of 256 tokens over the engine's zero
# images
VLM_PREFILL = (4, 256)


def _vlm_prefill(model, params, B, S):
    """One lane prefill of B fresh rows of S tokens over the engine's zero
    images: its host seconds and the cross K/V projection's alone (every
    xattn layer's image tokens times its K and V weights, copied into a
    cache; two calls each, synchronised), and the device kernels the
    prefill launches (by torch.profiler)."""
    import numpy as np
    import torch
    from repro_torch.models import nn
    cfg = model.cfg
    toks = torch.as_tensor(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (B, S)), dtype=torch.int32, device=DEV)
    images = torch.zeros(B, cfg.n_image_tokens, cfg.d_model, device=DEV)
    extra = {"image_embeds": images}
    secs, proj = [], []

    def timed(fn, into):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        into.append(time.perf_counter() - t0)

    def project(cache):
        mem = images.to(model.param_dtype)
        hd, kv = cfg.resolved_head_dim, cfg.n_kv_heads
        for si, runs in enumerate(model.segment_runs):
            for pi, (kind, n) in enumerate(runs):
                if kind != "xattn":
                    continue
                st = params["segments"][si][pi]["xattn"]
                c = cache["segments"][si][pi]
                for i in range(n):
                    for w, leaf in (("wk", "k"), ("wv", "v")):
                        c[leaf][i].copy_((mem @ st[w][i]).reshape(
                            B, -1, kv, hd))

    with torch.no_grad():
        for _ in range(2):
            cache = model.init_cache(B, VLM_ENGINE["cache_len"])
            timed(lambda: model.prefill(params, toks, cache, extra), secs)
        for _ in range(2):
            timed(lambda: project(cache), proj)
        cache = model.init_cache(B, VLM_ENGINE["cache_len"])
        kernels = _device_kernels(lambda: model.prefill(params, toks, cache,
                                                        extra))
    n_xattn = sum(n for runs in model.segment_runs for k, n in runs
                  if k == "xattn")
    cross = sum(x.numel() * x.element_size()
                for si, seg in enumerate(cache["segments"])
                for x, k in zip(nn.tree_leaves(seg),
                                model.leaf_kinds(si, seg)) if k == "read")
    return {"rows": B, "tokens": S, "image_tokens": cfg.n_image_tokens,
            "xattn_layers": n_xattn, "cross_kv_bytes": cross,
            "seconds": secs, "cross_kv_projection_seconds": proj,
            "cross_kv_projection_share": min(proj) / min(secs),
            "device_kernel_launches": sum(n for _, n in kernels),
            "top_kernels": sorted(kernels, key=lambda k: -k[1])[:8]}


def phase_vlm(smi):
    """llama-3.2-vision-90b at its published widths (d 8192, 64 / 8 heads
    of 128, d_ff 28672, vocab 128256, 1600 image tokens) cut to
    :data:`VLM_LAYERS` of its 100 layers, bf16, seed 0, 3 components,
    kernels on, cond_batch, alone on the card; its xattn gates (zero at
    init, as the reference's, which hides the sublayer) drawn from N(0, 1)
    with seed 1.  The init time and peak memory; the prefill's and first
    decode steps' logits against the plain path over random images
    (normwise within :data:`LOGIT_REL_TOL`, argmax agreement printed); one
    lane prefill of 4 x 256 tokens timed with the cross K/V projection's
    share, its device kernels counted; the serving engine of the qwen cell
    (lane batch 4, 2 lanes, cache 512) on :func:`_hybrid_requests` (12 of
    128 or 256 prompt tokens, one of 300 whose lane takes the plain
    attention; a lane re-prefills, its xattn K/V rewritten in place from
    the engine's zero images) at (0.9, 0.9, 0.0) on the host and device
    runtimes in turns (host, device, device, host) and at (0, 0, 0)
    (device, host), identical streams with one host sync a lane chunk; 2
    cohorts with the megakernel at a mixed component-0 threshold (the
    mixed branch taken, every launch on tc), streams equal with it off;
    select mode with the cohort scatter at that vector (its slot route
    only), streams equal to cond_batch's; autotune's shadow step there,
    streams equal on and off; and the paged layout refused with R4's
    message.  Prints each run's µs per token beside the floor of a lane
    step's bytes.  Returns the device runtime's launches by path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.macs import param_count
    from repro_torch.models import nn
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import CascadeServingEngine
    held = _free_card()
    base = get_config(VLM_ARCH).replace(
        n_layers=VLM_LAYERS, use_kernels=True).with_cascade(
        exit_mode="cond_batch", thresholds=(0.9, 0.9, 0.0))
    torch.cuda.reset_peak_memory_stats()
    model = build_model(base, device=DEV)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    init_seconds = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    g = torch.Generator(device=DEV).manual_seed(1)
    gates = []
    for seg in params["segments"]:
        for stage in seg:
            if "xattn" in stage:
                gate = stage["xattn"]["gate"]
                gate.copy_(torch.randn(gate.shape, generator=g, device=DEV))
                gates += gate.float().tolist()
    leaves = list(nn.tree_leaves(params))
    n_params = sum(x.numel() for x in leaves)
    param_bytes = sum(x.numel() * x.element_size() for x in leaves)
    t_phase = time.perf_counter()
    images = torch.randn(
        4, base.n_image_tokens, base.d_model, device=DEV,
        generator=torch.Generator(device=DEV).manual_seed(7))
    logits = _logits_against_plain(base, model, params,
                                   extra={"image_embeds": images})
    del images
    prefill = _vlm_prefill(model, params, *VLM_PREFILL)
    reqs = _hybrid_requests(base.vocab_size)
    turns, dev_launches, _ = _runtime_turns(
        VLM_ARCH, base, model, params, reqs,
        ("host", "device", "device", "host"), engine=VLM_ENGINE)
    check_launched(VLM_ARCH, turns["launches"], VLM)
    for rt in ("host", "device"):
        prefills = [r["prefills"] for r in turns[rt]]
        if min(prefills) <= VLM_ENGINE["n_lanes"]:
            fail(f"{VLM_ARCH} {rt}: {prefills} lane prefills (no lane "
                 "re-prefilled)")
    zero = base.with_cascade(thresholds=(0.0, 0.0, 0.0))
    zturns, _, _ = _runtime_turns(f"{VLM_ARCH} (0, 0, 0)", zero, model,
                                  params, reqs, ("device", "host"),
                                  engine=VLM_ENGINE)
    check_launched(f"{VLM_ARCH} (0, 0, 0)", zturns["launches"], VLM)
    out = {"one_cohort": dev_launches}

    two = base.with_cascade(n_cohorts=2, cohort_layout="major") \
        .with_kernel_tune(megakernel=True)
    calib = serve(two.with_cascade(thresholds=(0.0, 0.0, 0.0)), model,
                  params, reqs, runtime="device", **VLM_ENGINE)[0]
    th, quantile = mixed_threshold(
        calib, lambda th: serve(two.with_cascade(
            thresholds=(th, 0.9, 0.0)), model, params, reqs,
            runtime="device", **VLM_ENGINE)[1]["cohort_dispatch"],
        f"{VLM_ARCH} megakernel")
    mixed = two.with_cascade(thresholds=(th, 0.9, 0.0))
    on, on_launches, on_streams = _runtime_turns(
        f"{VLM_ARCH} megakernel", mixed, model, params, reqs,
        ("device", "host"), engine=VLM_ENGINE)
    off, _, off_streams = _runtime_turns(
        f"{VLM_ARCH} megakernel off", mixed.with_kernel_tune(
            megakernel=False), model, params, reqs, ("device",),
        engine=VLM_ENGINE)
    if on_streams != off_streams:
        fail(f"{VLM_ARCH}: the streams with the megakernel on differ from "
             "those with it off")
    # check_routes held every megakernel launch to the tc route
    check_launched(f"{VLM_ARCH} megakernel", on["launches"],
                   VLM | {"megakernel"})
    for rec in on["device"] + on["host"]:
        if not rec["cohort_dispatch"]["mixed"]:
            fail(f"{VLM_ARCH} 2 cohorts: the mixed branch never ran "
                 f"({rec['cohort_dispatch']})")
    out["megakernel"] = on_launches
    select, sel_launches, sel_streams = _runtime_turns(
        f"{VLM_ARCH} select", mixed.with_cascade(exit_mode="select")
        .with_kernel_tune(cohort_scatter=True), model, params, reqs,
        ("device", "host"), engine=VLM_ENGINE)
    if sel_streams != on_streams:
        fail(f"{VLM_ARCH}: select mode's streams differ from cond_batch's")
    check_launched(f"{VLM_ARCH} select", select["launches"],
                   VLM | {"megakernel", "cohort_scatter"})
    out["select_scatter"] = sel_launches
    shadow, tune_launches, tune_streams = _runtime_turns(
        f"{VLM_ARCH} autotune", mixed.with_autotune(**HYBRID_AUTOTUNE),
        model, params, reqs, ("device", "host"), engine=VLM_ENGINE)
    if tune_streams != on_streams:
        fail(f"{VLM_ARCH}: autotune's shadow steps changed the streams")
    check_launched(f"{VLM_ARCH} autotune", shadow["launches"],
                   VLM | {"megakernel"})
    out["autotune"] = tune_launches
    paged = base.with_paged_cache(layout="paged", block_size=16)
    try:
        CascadeServingEngine(paged, model, params, device=DEV, **VLM_ENGINE)
        fail(f"{VLM_ARCH}: the paged layout was not refused")
    except ValueError as err:
        refusal = str(err)
    if "cannot page a read-only cache stage" not in refusal \
            or "family 'vlm'" not in refusal:
        fail(f"{VLM_ARCH}: paged refusal {refusal!r}")
    phase_seconds = time.perf_counter() - t_phase
    parts, step_bytes = _audio_step_bytes(
        model, params, VLM_ENGINE["lane_batch"], VLM_ENGINE["cache_len"])
    floor_ms = 1e3 * step_bytes / hbm_bytes_per_s()
    med = turns["decode_us_per_token_median"]
    lane_prefill = {rt: [r["prefill_seconds"] / r["prefills"]
                         for r in turns[rt]] for rt in ("host", "device")}
    emit({"phase": "vlm", "config": VLM_ARCH,
          "n_layers": base.n_layers, "published_layers": get_config(
              VLM_ARCH).n_layers,
          "segments": [list(x) for x in base.segments],
          "segment_runs": model.segment_runs, "d_model": base.d_model,
          "n_heads": base.n_heads, "n_kv_heads": base.n_kv_heads,
          "head_dim": base.resolved_head_dim, "d_ff": base.d_ff,
          "vocab": base.vocab_size, "n_image_tokens": base.n_image_tokens,
          "dtype": base.dtype, "gates": gates, "params": n_params,
          "param_count_analytic": param_count(base),
          "param_bytes": param_bytes, "held_before": held,
          "init_seconds": init_seconds,
          "init_max_memory_allocated": init_peak,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "logits_against_plain": logits, "prefill": prefill,
          "lane_prefill_seconds_mean": lane_prefill,
          "engine": VLM_ENGINE, "thresholds": [0.9, 0.9, 0.0],
          "requests": len(reqs), "prompt_lens": sorted(
              {len(r.prompt) for r in reqs}), "max_new_tokens": 16,
          "turns": turns, "turns_all_exit": zturns,
          "decode_us_per_token": med,
          "step_bytes": parts, "floor_ms_per_step": floor_ms,
          "device_ms_per_step": (None if med.get("device") is None
                                 else med["device"]
                                 * VLM_ENGINE["lane_batch"] / 1e3),
          "host_ms_per_step": (None if med.get("host") is None
                               else med["host"]
                               * VLM_ENGINE["lane_batch"] / 1e3),
          "megakernel": {"thresholds": [th, 0.9, 0.0],
                         "threshold_quantile": quantile, "n_cohorts": 2,
                         "on": on, "off": off},
          "select_scatter": select, "autotune": {**HYBRID_AUTOTUNE,
                                                 "turns": shadow},
          "paged_refusal": refusal, "phase_seconds": phase_seconds,
          "nvidia_smi": smi})
    del model, params
    _free_card()
    return out


# ---------------------------------------------------------------------------
# slice 21: the trained cascade and the examples on the card
# ---------------------------------------------------------------------------

# qwen2.5-3b at its published widths (d 2048, 16 / 2 heads, hd 128, d_ff
# 11008, vocabulary 151936) with its depth cut from 36 layers to 6: the
# default exit boundaries are then (2, 4), 3 components.  Trained in f32
# (the example's dtype: AdamW's moments live in the params' dtype, and a
# bf16 update at lr 3e-4 is lost under bf16's rounding) on the example's
# own stream, then cast to bf16, calibrated on the bf16 model's held-out
# δ and served
TRAINED_ARCH = "qwen2.5-3b"
TRAINED_LAYERS = 6
TRAINED_STEPS = 300
TRAINED_STREAM = dict(vocab_size=256, seq_len=64, batch_size=8,
                      easy_frac=0.7, seed=0)
TRAINED_EPS = 0.05
TRAINED_PROMPT = 128
TRAINED_NEW = 32
TRAINED_ENGINE = dict(lane_batch=4, n_lanes=2, cache_len=512, chunk=8)
# the path's kernels: the serving kernels plus the exit-head megakernel
# (decode heads) and the cohort scatter (select mode's land)
TRAINED_PATH = SLICE1 | {"megakernel", "cohort_scatter"}


def _load_example(name):
    """``examples/<name>.py`` of this checkout as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def served_agreement(fin, reqs, next_tok):
    """The share of generated tokens equal to the stream's most likely
    successor of the token before them (``next_tok[prev, 0]``; a token
    outside the stream's vocabulary has none): the served counterpart of
    the offline accuracy."""
    prompts = {r.rid: r.prompt for r in reqs}
    hit = n = 0
    for rid, r in fin.items():
        prev = int(prompts[rid][-1])
        for tok in r["tokens"]:
            n += 1
            hit += prev < len(next_tok) and int(tok) == next_tok[prev, 0]
            prev = int(tok)
    return hit / n


def phase_trained_cascade(smi):
    """The LLM cascade trained, calibrated and served on the card, through
    the functions of ``examples/train_llm_cascade_torch.py``: qwen2.5-3b at
    its published widths cut to :data:`TRAINED_LAYERS` of 36 layers,
    trained :data:`TRAINED_STEPS` steps in f32 (kernels off: none has a
    backward) on the example's stream; cast to bf16 with ``tree_cast``
    and calibrated (§5) on the bf16 model's held-out δ (4 batches), both
    rules at ε 0, 0.01, 0.05, 0.1, 0.2; then served through the engine —
    device runtime, 2 cohorts, major layout, select mode, megakernel and
    cohort scatter — 8 requests of 128 prompt tokens from the stream and
    32 new tokens each, at (self, ε 0.05), (final, ε 0.05) and full depth.
    Fails unless the losses are finite and the last 50's mean is below
    the first 50's, every request gets its tokens, exactly
    :data:`TRAINED_PATH` launches on each run (heads on ``tc``, prefills
    on ``wgmma``: :func:`serve`), at (final, 0.05) the token and exit
    streams equal the same engine's with kernels off and the host
    runtime's, and at full depth (where every token goes through all the
    layers, so through every kernel of the path) they equal the same
    engine's with kernels off.  Returns the (final, 0.05) run's
    launches."""
    import contextlib
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.lm_pipeline import SyntheticLMStream
    from repro_torch.models import build_model
    from repro_torch.serving import Request
    from repro_torch.utils import tree_bytes, tree_cast, tree_size
    ex = _load_example("train_llm_cascade_torch")
    t_phase = time.perf_counter()
    _free_card()
    cfg32 = get_config(TRAINED_ARCH).replace(n_layers=TRAINED_LAYERS,
                                             dtype="float32")
    stream = SyntheticLMStream(**TRAINED_STREAM)
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg32, device=DEV)
    params = model.init(0)
    n_params = tree_size(params)
    t0 = time.perf_counter()
    params, losses, step_ms = ex.train(model, cfg32, params, stream,
                                       TRAINED_STEPS, DEV)
    train_s = time.perf_counter() - t0
    train_peak = torch.cuda.max_memory_allocated()
    first, last = (statistics.mean(losses[:50]),
                   statistics.mean(losses[-50:]))
    if not all(np.isfinite(losses)) or not last < first:
        fail(f"trained cascade: losses {losses[:3]} ... {losses[-3:]} "
             f"(first 50 mean {first}, last 50 mean {last})")

    # serve in bf16: δ̂ calibrated on what is served
    params = tree_cast(params, "bfloat16")
    _free_card()
    cfg16 = cfg32.replace(dtype="bfloat16")
    confs, preds, y = ex.held_out(build_model(cfg16, device=DEV), params,
                                  stream, DEV)
    with contextlib.redirect_stdout(sys.stderr):     # the example's table
        per_exit, rows = ex.calibrate_sweep(cfg16, confs, preds, y,
                                            TRAINED_STREAM["seq_len"])
    ths = {(r["rule"], r["eps"]): r["thresholds"] for r in rows}
    settings = {"self": ths[("self", TRAINED_EPS)],
                "final": ths[("final", TRAINED_EPS)],
                "full depth": [1.1] * (cfg16.cascade.n_components - 1)
                + [0.0]}
    # held-out prompts of the same stream: two batches end to end
    prompts = np.concatenate([next(stream)[0], next(stream)[0]], axis=1)
    if prompts.shape != (8, TRAINED_PROMPT):
        fail(f"trained cascade: prompts {prompts.shape}")
    reqs = [Request(rid=i, prompt=prompts[i].astype(np.int32),
                    max_new_tokens=TRAINED_NEW) for i in range(8)]
    serve_base = cfg16.replace(use_kernels=True).with_cascade(
        exit_mode="select", n_cohorts=2,
        cohort_layout="major").with_kernel_tune(megakernel=True,
                                               cohort_scatter=True)

    def run(cfg, runtime):
        fin, st, secs, launches = serve(
            cfg, build_model(cfg, device=DEV), params, reqs,
            runtime=runtime, **TRAINED_ENGINE)
        if sorted(fin) != list(range(len(reqs))) or any(
                len(r["tokens"]) != TRAINED_NEW for r in fin.values()):
            fail(f"trained cascade {cfg.cascade.thresholds}: not every "
                 f"request got its {TRAINED_NEW} tokens")
        return fin, st, secs, launches

    served, kept = {}, {}
    for name, th in settings.items():
        cfg = serve_base.with_cascade(thresholds=tuple(th))
        fin, st, secs, launches = run(cfg, "device")
        check_launched(f"trained cascade ({name})", launches, TRAINED_PATH)
        served[name] = {
            "thresholds": th, "exit_histogram": st["exit_histogram"],
            "mean_exit_depth": st["mean_exit_depth"],
            "analytic_speedup": st["analytic_speedup"],
            "wallclock_us_per_token": st["wallclock_us_per_token"],
            "seconds": secs, "captures": st["captures"],
            "host_syncs": st["host_syncs"],
            "served_agreement": served_agreement(fin, reqs,
                                                 stream.next_tok),
            "launches": launches,
            "routes": {k: st[k] for k in st if k.endswith("_routes")}}
        kept[name] = (cfg, _streams(fin))
    identical = {"final": ["kernels_off", "host_runtime"],
                 "full depth": ["kernels_off"]}
    for name, whats in identical.items():
        cfg, streams = kept[name]
        for what in whats:
            fin, _, secs, _ = run(
                cfg.replace(use_kernels=False) if what == "kernels_off"
                else cfg, "host" if what == "host_runtime" else "device")
            if _streams(fin) != streams:
                fail(f"trained cascade ({name}): the {what} streams differ "
                     "from the device runtime's with kernels on")
            served[name][f"{what}_seconds"] = secs
    del params
    _free_card()
    emit({"phase": "trained_cascade", "config": TRAINED_ARCH,
          "n_layers": cfg32.n_layers,
          "published_layers": get_config(TRAINED_ARCH).n_layers,
          "cut": f"depth {get_config(TRAINED_ARCH).n_layers} -> "
                 f"{TRAINED_LAYERS} layers; widths as published",
          "segments": [list(x) for x in cfg32.segments],
          "d_model": cfg32.d_model, "n_heads": cfg32.n_heads,
          "n_kv_heads": cfg32.n_kv_heads,
          "head_dim": cfg32.resolved_head_dim, "d_ff": cfg32.d_ff,
          "vocab": cfg32.vocab_size, "params": n_params,
          "param_bytes_bf16": 2 * n_params,
          "stream": TRAINED_STREAM,
          "train": {"dtype": "float32", "steps": TRAINED_STEPS,
                    "step_ms_median": statistics.median(step_ms),
                    "step_ms_first": step_ms[0], "seconds": train_s,
                    "max_memory_allocated": train_peak,
                    "loss_first": losses[0], "loss_last": losses[-1],
                    "loss_mean_first_50": first, "loss_mean_last_50": last,
                    "losses_every_25": losses[::25]},
          "calibration": {"dtype": "bfloat16", "held_out_batches": 4,
                          "per_exit_accuracy": per_exit, "rows": rows},
          "serve": {"runtime": "device", "n_cohorts": 2,
                    "cohort_layout": "major", "exit_mode": "select",
                    "megakernel": True, "cohort_scatter": True,
                    **TRAINED_ENGINE, "requests": len(reqs),
                    "prompt_tokens": TRAINED_PROMPT,
                    "max_new_tokens": TRAINED_NEW, "settings": served},
          "identical_streams": identical,
          "phase_seconds": time.perf_counter() - t_phase,
          "nvidia_smi": smi})
    return served["final"]["launches"]


# the four examples as subprocesses at their defaults (reduced sizes); the
# paper reproduction cut to one block, one epoch and 1024 images
EXAMPLES = (("quickstart_torch", []), ("serve_cascade_torch", []),
            ("train_llm_cascade_torch", []),
            ("paper_reproduction_torch", ["--n-blocks", "1", "--epochs", "1",
                                          "--train-size", "1024"]))
ATTN_2D_SHAPE = (1, 4096, 16, 2, 128)
ATTN_2D_TOL = 2e-2


def phase_examples(dev, gen, smi):
    """The four port examples (``examples/*_torch.py``), started together
    as subprocesses on the card at :data:`EXAMPLES`' arguments (each one's
    seconds from the common start to its exit): each must exit 0 and
    print ``cuda`` as its device; then ``attend_chunked_2d`` with the
    causal skip on (prefill) and off (training: ``pick_attend``'s
    differentiable case) against ``attend_chunked`` on the same bf16
    inputs at :data:`ATTN_2D_SHAPE` (B, S, H, KV, hd), normwise within
    :data:`ATTN_2D_TOL`, all three timed."""
    import os
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.layers import attend_chunked, attend_chunked_2d
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name, args in EXAMPLES:
            out_arg = (["--out", os.path.join(tmp, "repro.json")]
                       if name == "paper_reproduction_torch" else [])
            logs = [open(os.path.join(tmp, f"{name}.{x}"), "w+")
                    for x in ("out", "err")]
            procs[name] = (subprocess.Popen(
                [sys.executable, str(ROOT / "examples" / f"{name}.py"),
                 *args, *out_arg], cwd=ROOT, env=env, stdout=logs[0],
                stderr=logs[1], text=True), logs, args)
        t0 = time.perf_counter()
        ended = {}
        while len(ended) < len(procs):
            for name, (proc, _, _) in procs.items():
                if name not in ended and proc.poll() is not None:
                    ended[name] = time.perf_counter() - t0
            if time.perf_counter() - t0 > 600:
                for proc, _, _ in procs.values():
                    proc.kill()
                fail(f"examples: not all ended in 600 s ({sorted(ended)})")
            time.sleep(0.05)
        for name, (proc, logs, args) in procs.items():
            stdout, stderr = ((f.seek(0), f.read())[1] for f in logs)
            for f in logs:
                f.close()
            if proc.returncode != 0:
                fail(f"example {name} exited {proc.returncode}:\n"
                     f"{stderr[-3000:]}")
            first = stdout.splitlines()[0]
            if not first.startswith("device=cuda"):
                fail(f"example {name} ran on {first!r}")
            out[name] = {"args": args, "rc": 0, "seconds": ended[name],
                         "device_line": first,
                         "last_line": stdout.splitlines()[-1]}
    cfg = get_config(TRAINED_ARCH)
    B, S, H, KV, hd = ATTN_2D_SHAPE
    q = torch.randn((B, S, H, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    k, v = (torch.randn((B, S, KV, hd), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    pos = torch.arange(S, dtype=torch.int32, device=dev)

    def two_d(skip=True):
        return attend_chunked_2d(q, k, v, pos, pos, qchunk=cfg.attn_qchunk,
                                 kchunk=cfg.attn_kchunk, causal_skip=skip)

    def one_d():
        return attend_chunked(q, k, v, pos, pos, chunk=cfg.attn_kchunk)
    want = one_d().float()
    rel = {}
    for skip in (True, False):
        got = two_d(skip).float()
        rel[skip] = float((got - want).norm() / want.norm())
        if not rel[skip] <= ATTN_2D_TOL:
            fail(f"attend_chunked_2d (causal_skip={skip}) against "
                 f"attend_chunked: normwise {rel[skip]}")
    emit({"phase": "examples", "examples": out,
          "attend_chunked_2d": {
              "shape": list(ATTN_2D_SHAPE), "dtype": "bfloat16",
              "qchunk": cfg.attn_qchunk, "kchunk": cfg.attn_kchunk,
              "normwise_rel_err": rel[True],
              "normwise_rel_err_no_skip": rel[False], "tol": ATTN_2D_TOL,
              "ms": time_ms(two_d, iters=10, warmup=2),
              "ms_no_skip": time_ms(lambda: two_d(False), iters=10,
                                    warmup=2),
              "attend_chunked_ms": time_ms(one_d, iters=10, warmup=2)},
          "nvidia_smi": smi})


# ---------------------------------------------------------------------------
# slice 22: multi-rank serving, ranks sharing the one card
# ---------------------------------------------------------------------------

# (a): the all-reduce at a decode step's (B, d) and at a prefill's (B x S,
# d), on 2 and 4 ranks; MR_CALLS calls timed in runs of 20
MR_SHAPES = ((4, D_MODEL), (4 * 256, D_MODEL))
MR_RANKS = (2, 4)
MR_CALLS = 60
# (c): the exact-stream meshes at 4 layers in f32; (d): the main cell
MR_PARITY_LAYERS = 4
MR_PARITY_MESHES = ((1, 2), (2, 1), (2, 2))
MR_PARITY_NEW = 8
MR_MESH = (1, 2)
# 12 of the 36 layers (all 36 until slice 24, cut for the script's time
# limit: the cell's decode step is its collectives, ~2.27 ms each)
MR_LAYERS = 12
MR_ENGINE = dict(lane_batch=4, n_lanes=2, cache_len=512, chunk=8)
MR_NEW_TOKENS = 16
MR_AUTOTUNE = dict(enabled=True, bins=32, shadow_every=4)
# seconds a rank task may take before the phase fails (the kernel's own
# wait bound is allreduce.TIMEOUT_S)
MR_TASK_SECONDS = 400
# kernels on the multi-rank path: prefill decisions on the whole vocab
# (exit_update's whole route), the decode scan on the megakernel's partial
# route and its combine, the collectives
MULTIRANK = SLICE1 | {"megakernel", "cohort_scatter", "allreduce"}
# (e): the moe family on the mesh.  (e1) qwen3-moe-235b-a22b's config
# narrowed (8 experts, top 2) at capacity factor 0.5, so that prefill drops
# pairs, in f32 at 4 layers, on each (data, model, experts, mode, cohorts):
# 4 experts a rank on 1 x 2, the data-split routing on 2 x 1 and 2 x 2 (with
# the expert-parallel combine), 3 experts on 1 x 2 (the intra-expert d_ff
# fallback), and one cohort split over 2 x 1 under cond_batch (the routing
# gather inside the captured skip branches); (e2) its published widths cut
# to 4 of 94 layers, bf16, on MR_MESH (64 experts a rank)
MR_MOE_ARCH = "qwen3-moe-235b-a22b"
MR_MOE_NARROW = dict(d_model=512, n_heads=8, n_kv_heads=2, n_experts=8,
                     top_k=2, d_ff=512, capacity_factor=0.5)
MR_MOE_MESHES = ((1, 2, 8, "select", 2), (2, 1, 8, "select", 2),
                 (2, 2, 8, "select", 2), (1, 2, 3, "select", 2),
                 (2, 1, 8, "cond_batch", 1))
MR_MOE_LAYERS = 4


def _rank_main(rank, tasks, results):
    """One rank process of the multi-rank phase, on the one card: for each
    task ``(sizes, store file, function name, args)`` it joins a world of
    ``data x model`` ranks through the FileStore (``make_mesh``), runs the
    function, leaves the world, and reports ``(rank, result, error)``; a
    failed task ends the process (a trapped collective leaves its context
    unusable)."""
    import io
    import os
    import traceback
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    while True:
        task = tasks.get()
        if task is None:
            return
        sizes, init, name, args = task
        try:
            from repro_torch import parallel
            from repro_torch.launch.mesh import make_mesh
            mesh = make_mesh(sizes, DEV, rank=rank,
                             world_size=sizes[0] * sizes[1], init_file=init)
            res = globals()[name](mesh, rank, *args)
            torch.cuda.synchronize()
            parallel.transport(mesh).close()
            dist.destroy_process_group()
            buf = io.BytesIO()
            torch.save(res, buf)
            results.put((rank, buf.getvalue(), None))
        except BaseException:  # noqa: BLE001 (the parent fails the phase)
            err = traceback.format_exc()
            try:
                from repro_torch.kernels import allreduce
                allreduce.raise_if_timed_out()
            except RuntimeError as timed_out:
                err += f"\n{timed_out}"
            results.put((rank, None, err))
            os._exit(1)
        finally:
            # what the task left (an engine's graphs and caches in
            # reference cycles) freed now: a rank idle in a later task's
            # smaller mesh would hold it while the others run
            _free_card()


class _RankPool:
    """Up to four rank processes on the card, spawned once and fed one task
    a mesh (importing torch and the port and reaching the card costs each
    process seconds)."""

    def __init__(self, n: int):
        import tempfile
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.tasks = [ctx.Queue() for _ in range(n)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, self.tasks[r], self.results)) for r in range(n)]
        for p in self.procs:
            p.start()
        (ROOT / "build").mkdir(exist_ok=True)
        self.dir = tempfile.mkdtemp(prefix="multirank_", dir=ROOT / "build")
        self.n = 0

    def run(self, sizes, name, *args):
        """``name(mesh, rank, *args)`` on every rank of a ``sizes`` mesh;
        the results in rank order."""
        import io
        import os
        import queue
        import torch
        world = sizes[0] * sizes[1]
        self.n += 1
        init = os.path.join(self.dir, f"store{self.n}")
        for r in range(world):
            self.tasks[r].put((tuple(sizes), init, name, args))
        got = {}
        deadline = time.monotonic() + MR_TASK_SECONDS
        while len(got) < world:
            try:
                rank, raw, err = self.results.get(
                    timeout=max(1.0, deadline - time.monotonic()))
            except queue.Empty:
                fail(f"multi-rank {name} on {sizes}: {world - len(got)} "
                     f"ranks silent after {MR_TASK_SECONDS} s")
            if err is not None:
                fail(f"multi-rank {name} on {sizes}, rank {rank}:\n{err}")
            got[rank] = torch.load(io.BytesIO(raw), weights_only=False)
        return [got[r] for r in range(world)]

    def shrink(self, n: int):
        """Stop the rank processes past the first ``n``, their contexts
        freed on the card; later tasks run on ranks 0..n-1."""
        for q in self.tasks[n:]:
            q.put(None)
        for p in self.procs[n:]:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
        self.tasks, self.procs = self.tasks[:n], self.procs[:n]

    def close(self):
        import shutil
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
        shutil.rmtree(self.dir, ignore_errors=True)


def _mr_input(shape, dt, rank):
    import torch
    g = torch.Generator().manual_seed(1000 + 17 * rank + shape[0])
    return torch.randn(shape, generator=g).to(dt)


def _mr_transport(mesh, rank):
    """(a) on one rank: at each shape and dtype the kernel's sum over the
    world against the plain rank-ordered sum of every rank's input (drawn
    here from each rank's seed), the gather against the stacked inputs,
    and each call's time (CUDA events around runs of 20 calls).  The
    library time is PyTorch's own all-reduce of the same CUDA tensor over
    the mesh's gloo world group (it stages through the host: timed here,
    outside any capture, and never called by the port)."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import allreduce
    from repro_torch.kernels.ref import ref_allreduce
    from repro_torch import parallel
    t = parallel.transport(mesh)
    R = t.size("world")
    out = []
    for shape in MR_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            xs = [_mr_input(shape, dt, r) for r in range(R)]
            x = xs[rank].to(DEV)
            got = t.all_reduce(x, "world")
            gathered = t.all_gather(x, "world")
            torch.cuda.synchronize()
            want = ref_allreduce(xs)
            name = str(dt).split(".")[-1]
            tag = f"allreduce {R} ranks {list(shape)} {name}"
            check_equal(tag, got, want)
            check_equal(f"{tag} gather", gathered, torch.stack(xs))
            launches = allreduce.allreduce.launches
            per = []
            for _ in range(MR_CALLS // 20):
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                for _ in range(20):
                    t.all_reduce(x, "world")
                e1.record()
                torch.cuda.synchronize()
                per.append(e0.elapsed_time(e1) / 20)
            if allreduce.allreduce.launches - launches != MR_CALLS:
                fail(f"{tag}: {allreduce.allreduce.launches - launches} "
                     f"launches for {MR_CALLS} calls")
            lib = x.clone()
            dist.all_reduce(lib, group=t.groups["world"])
            lib_per = []
            for _ in range(MR_CALLS // 20):
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                for _ in range(20):
                    dist.all_reduce(x.clone(), group=t.groups["world"])
                e1.record()
                torch.cuda.synchronize()
                lib_per.append(e0.elapsed_time(e1) / 20)
            n = x.numel()
            b, by = bound_ms((R + 1) * n * x.element_size(), (R - 1) * n,
                             name)
            parts = [p.to(DEV) for p in xs]
            out.append({
                "ranks": R, "shape": list(shape), "dtype": name,
                "max_abs_err": max_err(got.cpu(), want), "exact": True,
                "ms": statistics.median(per), "ms_min": min(per),
                "ms_max": max(per),
                "plain_ms": time_ms(lambda: ref_allreduce(parts)),
                "library_ms": statistics.median(lib_per),
                "library_ms_min": min(lib_per),
                "library_ms_max": max(lib_per),
                "library_backend": "torch.distributed.all_reduce, gloo",
                "library_max_abs_err": max_err(lib.cpu(), want),
                "bound_ms": b, "bound_by": by})
    return out


def _mr_config(spec):
    """``spec["arch"]`` (qwen2.5-3b unless named) at its published widths
    but for ``spec["over"]``, cut to ``spec["layers"]``, in
    ``spec["dtype"]``: 2 cohorts, major layout, select mode (unless
    ``spec["cohorts"]`` / ``spec["mode"]`` say otherwise), kernels on
    with the megakernel and the cohort scatter, at ``spec["thresholds"]``
    (autotune's telemetry with ``spec["autotune"]``)."""
    from repro_torch.configs import get_config
    cfg = get_config(spec.get("arch", "qwen2.5-3b")).replace(
        n_layers=spec["layers"], dtype=spec["dtype"], use_kernels=True,
        **spec.get("over", {})).with_cascade(
            exit_mode=spec.get("mode", "select"),
            n_cohorts=spec.get("cohorts", 2), cohort_layout="major",
            thresholds=tuple(spec["thresholds"])).with_kernel_tune(
                megakernel=spec.get("megakernel", True),
                cohort_scatter=True)
    if spec.get("autotune"):
        cfg = cfg.with_autotune(**MR_AUTOTUNE)
    return cfg


def _digest(params) -> float:
    """A sum over every leaf (the same draw gives the same bits on every
    rank: this checks it)."""
    from repro_torch.models import nn
    return float(sum(x.float().sum() for x in nn.tree_leaves(params)))


def _first_logits(model, params, cfg, transport=None, router=None):
    """The exit logits of a prefill of four prompts (seed 5, 128 tokens)
    and of the first decode step after it (its tokens drawn from the same
    seed, not argmaxed: a near-tie must not pick the step's input),
    gathered whole: the main cell's numerics against the one-rank
    model's.  With ``router`` (an MoE model, :class:`_RouterProbe`):
    ``"record"`` keeps each forward's router calls (the probe's record
    mode) under ``"router"``; a dict of such records makes each forward
    route on them — the one-rank model's experts — and reports under
    ``"routing"`` where its own choices part from them."""
    import contextlib
    import numpy as np
    import torch
    from repro_torch import parallel
    rng = np.random.default_rng(5)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 129))
                           .astype(np.int32), device=DEV)
    probe = None if router is None else _RouterProbe()
    records = {}

    def forward(name, n_tokens, fn):
        if probe is None:
            return fn()
        if router == "record":
            probe.start("record", n_tokens)
            out = fn()
            records[name] = probe.calls
            return out
        probe.calls = router[name]
        probe.start("replay", n_tokens)
        out = fn()
        probe.finish(np.arange(n_tokens))
        return out

    with torch.no_grad(), parallel.activate(transport), \
            (probe or contextlib.nullcontext()):
        cache = model.init_cache(4, MR_ENGINE["cache_len"])
        pre, cache = forward("prefill", 4 * 128, lambda: model.prefill(
            params, toks[:, :128], cache))
        out, _ = forward("decode", 4, lambda: model.decode_step(
            params, toks[:, 128:], 128, cache))
    res = {"prefill": [x.float().cpu() for x in pre],
           "decode": [x.float().cpu() for x in out]}
    if router == "record":
        res["router"] = records
    elif probe is not None:
        res["routing"] = probe.report()
    return res


class _MoeDrops:
    """The pairs that expert capacity drops in each MoE call of a prefill,
    inside a ``with`` block: ``blocks.moe_apply`` wrapped for the call's
    real tokens (the rank's rows times the ranks they are split over) and
    ``moe._queue`` for its kept mask (the pad rows after them left out).
    A decode call (one token a row) is not read: a captured step must not
    sync.  ``calls``: (tokens, dropped pairs) a prefill call; ``split``:
    for each call whose rows are split over more than one rank (prefill or
    decode, a captured one counted once), the transport's calls over that
    axis it made, by op (host counters: nothing syncs)."""

    def __init__(self):
        from repro_torch.models import blocks, moe
        self.blocks, self.moe = blocks, moe
        self.calls, self.split, self._tokens = [], [], None

    def __enter__(self):
        from repro_torch import parallel
        apply, queue = self.blocks.moe_apply, self.moe._queue
        self._orig = apply, queue

        def moe_apply(params, cfg, x, rows=None):
            t = parallel.active()
            R = 1 if rows is None else t.size(rows)
            self._tokens = (R * x.shape[0] * x.shape[1] if x.shape[1] > 1
                            else None)
            if R == 1:
                return apply(params, cfg, x, rows=rows)
            before = dict(t.op_calls)
            out = apply(params, cfg, x, rows=rows)
            self.split.append({
                k[len(rows) + 1:]: v - before.get(k, 0)
                for k, v in t.op_calls.items()
                if k.rsplit("/", 1)[0] == rows and v > before.get(k, 0)})
            return out

        def _queue(gate_idx, E, cap):
            out = queue(gate_idx, E, cap)
            if self._tokens is not None:
                kept = out[2].reshape(-1, gate_idx.shape[-1])[:self._tokens]
                self.calls.append((self._tokens, int((~kept).sum())))
            return out

        self.blocks.moe_apply, self.moe._queue = moe_apply, _queue
        return self

    def __exit__(self, *exc):
        self.blocks.moe_apply, self.moe._queue = self._orig


def _per_step(before, after):
    """What a decode step's replays ran, by axis: the transport's calls and
    bytes that a run's captured replays counted (each IF body's captured
    collectives times the executions its device counter read) over the
    decode steps the run took; None without a step."""
    steps = after["steps"] - before["steps"]
    if not steps:
        return None
    return {"steps": steps, **{
        kind: {a: (v - before.get(kind, {}).get(a, 0)) / steps
               for a, v in after.get(kind, {}).items()}
        for kind in ("calls", "bytes", "op_calls")}}


def _mr_serve(mesh, rank, spec):
    """(c), (d) and (e) on one rank: the model drawn from ``spec["seed"]``
    on the card, its engine on the device runtime over ``mesh`` (the
    rank's shards and data rows), ``spec``'s requests served; the
    streams, the carried segments_run, the telemetry, the launches,
    routes and collectives of the run, and with ``spec["probe"]`` the
    first decode step's logits (routed on ``spec["router"]``'s records
    for an MoE model).  With ``spec["serial_init"]`` the ranks draw the
    whole params one after another, each cutting its shards and freeing
    the rest before the next rank draws (a store key a rank): the card
    then holds one whole tree at a time.  An MoE model's prefills report
    their dropped pairs (:class:`_MoeDrops`)."""
    import contextlib
    import torch
    from torch.distributed.distributed_c10d import _get_default_store
    from repro_torch import kernels
    from repro_torch.kernels.exit_update import exit_update
    from repro_torch.kernels.megakernel import exit_head_update
    from repro_torch import parallel
    from repro_torch.models.model import build_model
    cfg = _mr_config(spec)
    t = parallel.transport(mesh, DEV)       # every rank together, first
    store = _get_default_store()
    if spec.get("serial_init") and rank:
        store.wait([f"serial_init/{rank - 1}"])
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(
        spec["seed"]))
    digest = _digest(params)
    engine = make_engine(cfg, model, params, runtime="device", mesh=mesh,
                         **spec["engine"])
    del params
    torch.cuda.empty_cache()
    init_peak = torch.cuda.max_memory_allocated()
    if spec.get("serial_init"):
        store.set(f"serial_init/{rank}", "1")
    torch.cuda.reset_peak_memory_stats()
    probe = (_first_logits(model, engine.params, cfg, engine.transport,
                           router=spec.get("router"))
             if spec.get("probe") else None)
    for r in make_requests(8, (128, 256), cfg.vocab_size, spec["new"],
                           seed=spec["seed"]):
        engine.submit(r)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    calls0, bytes0 = dict(t.calls), dict(t.bytes)
    ops0 = dict(t.op_calls)
    rep0 = copy.deepcopy(engine.loop.replayed_collectives)
    t0 = time.perf_counter()
    with (_MoeDrops() if cfg.n_experts else contextlib.nullcontext()
          ) as drops:
        fin = engine.run(max_ticks=10_000)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = kernels.launch_counts()
    st = engine.stats()
    out = {
        "streams": _streams(fin),
        "confs": {rid: r["confs"] for rid, r in fin.items()},
        "carried": [int(x) for x in sum(ln["state"].segments_run
                                        for ln in engine.lanes)],
        "launches": launches,
        "megakernel_routes": dict(exit_head_update.launches_by_route),
        "exit_update_routes": dict(exit_update.launches_by_route),
        "collectives_per_step": _per_step(
            rep0, engine.loop.replayed_collectives),
        "calls": {a: t.calls[a] - calls0[a] for a in t.calls},
        "bytes": {a: t.bytes[a] - bytes0[a] for a in t.bytes},
        "op_calls": {a: n - ops0.get(a, 0) for a, n in t.op_calls.items()},
        "digest": digest, "probe": probe, "seconds": secs,
        "local_batch": int(engine.lanes[0]["state"].active.shape[0]),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "init_max_memory_allocated": init_peak,
        "stats": {k: st[k] for k in (
            "wallclock_us_per_token", "decode_dispatches", "host_syncs",
            "captures", "compile_seconds", "prefill_seconds",
            "segments_run")}}
    if cfg.autotune.enabled:
        from repro_torch.autotune import merge_telemetry
        out["telemetry"] = {k: v.tolist() for k, v in merge_telemetry(
            engine.lane_telemetry()).items()}
    if cfg.n_experts:
        out["drops"], out["split"] = drops.calls, drops.split
        out["w_up"] = list(engine.params["segments"][0][0]["moe"]["w_up"]
                           .shape)
    return out


def _one_rank(spec):
    """The one-rank run ``_mr_serve`` is held against: the same model and
    requests with no mesh, in this process."""
    import torch
    from repro_torch.models.model import build_model
    cfg = _mr_config(spec)
    model = build_model(cfg, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(
        spec["seed"]))
    digest = _digest(params)
    reqs = make_requests(8, (128, 256), cfg.vocab_size, spec["new"],
                         seed=spec["seed"])
    probe = (_first_logits(model, params, cfg, router=spec.get("router"))
             if spec.get("probe") else None)
    fin, st, secs, launches = serve(cfg, model, params, reqs,
                                    runtime="device", **spec["engine"])
    del model, params
    _free_card()
    return {"streams": _streams(fin),
            "confs": {rid: r["confs"] for rid, r in fin.items()},
            "carried": st["carried_segments_run"], "launches": launches,
            "telemetry": st.get("telemetry"), "digest": digest,
            "probe": probe, "seconds": secs,
            "wallclock_us_per_token": st["wallclock_us_per_token"]}


def phase_multirank_transport(pool=None):
    """(a): the IPC all-reduce kernel on 2 and 4 rank processes sharing
    the card (:func:`_mr_transport`); every rank's results."""
    own = pool is None
    pool = pool or _RankPool(max(MR_RANKS))
    try:
        return {R: pool.run((1, R), "_mr_transport") for R in MR_RANKS}
    finally:
        if own:
            pool.close()


def phase_multirank_exit(dev, gen):
    """(b): the exit kernels' partial contract at (4, 151936) bf16 cut into
    2 and 4 vocab slices — each slice's partial launch, the triples
    stacked in rank order (what the gather gives), the combine launch —
    against the unsharded kernel and the plain version: carries and
    predictions exact, δ within 1e-5 relative; the megakernel's partial
    route (tc) over a (2048, 151936) head likewise.  Times one rank's
    route (partial + combine) beside the whole kernel."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.exit_update import (exit_combine, exit_partial,
                                                 exit_update)
    from repro_torch.kernels.megakernel import (exit_head_combine,
                                                exit_head_partial,
                                                exit_head_update, route)
    B, V = (4, VOCAB)
    n_m = 3
    dt = torch.bfloat16
    x = _exit_logits(B, V, dt, dev, gen)
    h = torch.randn(B, D_MODEL, generator=gen, device=dev).to(dt)
    w = 1.0 + 0.1 * torch.randn(D_MODEL, generator=gen, device=dev)
    head = (0.02 * torch.randn(D_MODEL, V, generator=gen, device=dev)).to(dt)
    head[:, 5] = head[:, V - 100] = head[:, 77]       # ties across slices
    carry = _carries(B, n_m, dev)
    live = torch.tensor([True, True, False, True], device=dev)
    kw = dict(threshold=torch.full((n_m,), 0.3, device=dev), m=1,
              n_components=n_m, patience_k=2, ema_decay=0.8, tel_bins=32)
    out = {"exit_update": [], "megakernel": []}

    def check(tag, got, want, plain):
        for idx in (0, 1, 2, 4, 6):
            check_equal(f"{tag} vs unsharded", got[idx], want[idx])
            check_equal(f"{tag} vs plain", got[idx], plain[idx])
        for idx in (3, 5):
            check_close(f"{tag} vs unsharded", got[idx], want[idx], 0.0,
                        1e-5)
            check_close(f"{tag} vs plain", got[idx], plain[idx], 0.0, 1e-5)
        return max(max_err(got[i], plain[i]) for i in (3, 5))

    for R in (2, 4):
        Vr = V // R
        xs = [x[:, r * Vr:(r + 1) * Vr].contiguous() for r in range(R)]
        heads = [head[:, r * Vr:(r + 1) * Vr].contiguous() for r in range(R)]
        if any(route(h, hd) != "tc" for hd in heads):
            fail(f"multi-rank exit: a {Vr}-column head slice left tc")

        def eu_route():
            return exit_combine(torch.stack([
                exit_partial(s, vocab_offset=r * Vr)
                for r, s in enumerate(xs)]), *carry, **kw)

        def mk_route():
            return exit_head_combine(torch.stack([
                exit_head_partial(h, w, hd, vocab_offset=r * Vr, live=live)
                for r, hd in enumerate(heads)]), *carry, live=live, **kw)

        def eu_plain():
            return ref.ref_exit_combine(torch.stack([
                ref.ref_exit_partial(s, r * Vr) for r, s in enumerate(xs)]),
                *carry, **kw)

        def mk_plain():
            return ref.ref_exit_combine(torch.stack([
                ref.ref_exit_head_partial(h, w, hd, r * Vr, live=live)
                for r, hd in enumerate(heads)]), *carry, live=live, **kw)

        err = check(f"exit_update {R} slices", eu_route(),
                    exit_update(x, *carry, **kw), eu_plain())
        nbytes = xs[0].numel() * 2 + B * 4 * 13
        b, by = bound_ms(nbytes, 4 * xs[0].numel(), "bfloat16")
        parts = torch.stack([exit_partial(s, vocab_offset=r * Vr)
                             for r, s in enumerate(xs)])
        out["exit_update"].append({
            "slices": R, "shape": [B, Vr], "dtype": "bfloat16",
            "max_abs_err": err,
            # one rank's route: its partial, then the combine of R triples
            "ms": time_ms(lambda: exit_partial(xs[0], vocab_offset=0))
            + time_ms(lambda: exit_combine(parts, *carry, **kw)),
            "whole_ms": time_ms(lambda: exit_update(x, *carry, **kw)),
            "plain_ms": time_ms(lambda: ref.ref_exit_partial(xs[0], 0))
            + time_ms(lambda: ref.ref_exit_combine(parts, *carry, **kw)),
            "library_ms": time_ms(lambda: torch.softmax(
                xs[0].float(), -1).max(-1)),
            "bound_ms": b, "bound_by": by})
        err = check(f"megakernel {R} slices", mk_route(),
                    exit_head_update(h, w, head, *carry, live=live, **kw),
                    mk_plain())
        nbytes = heads[0].numel() * 2 + h.numel() * 2 + B * 4 * 13
        b, by = bound_ms(nbytes, 2 * B * D_MODEL * Vr, "bfloat16")
        hparts = torch.stack([exit_head_partial(h, w, hd, vocab_offset=r * Vr,
                                                live=live)
                              for r, hd in enumerate(heads)])
        out["megakernel"].append({
            "slices": R, "shape": [B, D_MODEL, Vr], "dtype": "bfloat16",
            "route": "tc", "max_abs_err": err,
            "ms": time_ms(lambda: exit_head_partial(h, w, heads[0],
                                                    live=live))
            + time_ms(lambda: exit_head_combine(hparts, *carry, live=live,
                                                **kw)),
            "whole_ms": time_ms(lambda: exit_head_update(
                h, w, head, *carry, live=live, **kw)),
            "plain_ms": time_ms(lambda: ref.ref_exit_head_partial(
                h, w, heads[0], 0, live=live))
            + time_ms(lambda: ref.ref_exit_combine(hparts, *carry,
                                                   live=live, **kw)),
            "library_ms": time_ms(lambda: torch.softmax(
                (h @ heads[0]).float(), -1).max(-1)),
            "bound_ms": b, "bound_by": by})
    return out


def _dryrun_collectives(spec, sizes, batch):
    """The dry run's per-device collective bytes and counts
    (``launch/dryrun.py`` ``collectives``, ring formulas) for ``spec``'s
    model on a ``sizes`` mesh, one decode step of ``batch`` tokens in the
    serve1d layout: shape-only, on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.shard_rules import param_spec
    from repro_torch.models.model import build_model
    cfg = _mr_config(spec)
    mesh = AbstractMesh(tuple(sizes), ("data", "model"))
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = build_model(cfg, device="cpu").init(0)
        pairs = dryrun._pairs(params, param_spec(params, cfg, mesh,
                                                 mode="serve1d"))
    coll, counts = dryrun.collectives(cfg, pairs, mesh, batch, batch, False,
                                      "serve1d")
    return {"bytes": coll, "counts": counts}


def _mr_agree(tag, ranks, want, floats=False):
    """Every rank's streams, carried segments_run and telemetry equal the
    one-rank run's; confidences within 1e-5 in f32 (``floats``)."""
    for r, got in enumerate(ranks):
        if got["digest"] != want["digest"]:
            fail(f"{tag} rank {r}: the weights drawn differ from the "
                 "one-rank model's")
        for key in ("streams", "carried", "telemetry"):
            if got.get(key) != want.get(key):
                bad = ([rid for rid in want[key] if got[key].get(rid)
                        != want[key][rid]] if key == "streams" else key)
                fail(f"{tag} rank {r}: {key} differ from the one-rank "
                     f"run's ({bad})")
        if floats:
            import numpy as np
            for rid, c in want["confs"].items():
                if not np.allclose(got["confs"][rid], c, rtol=1e-5,
                                   atol=1e-7):
                    fail(f"{tag} rank {r}: request {rid}'s confidences")


def _expert_shard(spec, M):
    """The (E, d, d_ff) of a rank's ``w_up`` on a ``model`` axis of M:
    E/M experts where M divides them, else every expert's d_ff/M."""
    cfg = _mr_config(spec)
    E, ff = cfg.n_experts, cfg.d_ff
    if M > 1:
        E, ff = (E // M, ff) if E % M == 0 else (E, ff // M)
    return [E, cfg.d_model, ff]


def _mr_moe(pool):
    """(e): the moe family over the mesh.  (e1) each of MR_MOE_MESHES in
    f32: streams, segments_run and telemetry equal to the one-rank run's,
    a pair dropped at some prefill of every rank, the rank's expert shard,
    all-reduces over ``model`` and gathers over ``data`` only where rows
    are split over it.  (e2) the published widths at 4 layers in bf16 on
    MR_MESH, the ranks' builds one after another: the first decode step's
    logits against the one-rank model's (routed on its experts; a router
    choice of the mesh's own that parts from them must be a near-tie),
    token agreement, µs per token against one rank, collectives a decode
    step by axis and op beside the dry run's, peak memory a rank, every
    kernel of MULTIRANK launched.  Returns its record."""
    t0 = time.perf_counter()
    wants, parity = {}, {}
    for D, M, E, mode, cohorts in MR_MOE_MESHES:
        spec = dict(arch=MR_MOE_ARCH, over={**MR_MOE_NARROW, "n_experts": E},
                    layers=4, dtype="float32", seed=1, new=MR_PARITY_NEW,
                    engine=MR_ENGINE, autotune=True, mode=mode,
                    cohorts=cohorts, thresholds=(0.0, 0.0, 0.0))
        key = (E, mode, cohorts)
        if key not in wants:
            th = _median_threshold({rid: {"confs": c} for rid, c in
                                    _one_rank(spec)["confs"].items()})
            wants[key] = (th, th, 0.0), _one_rank(
                {**spec, "thresholds": (th, th, 0.0)})
            depths = {d for _, e in wants[key][1]["streams"].values()
                      for d in e}
            if len(depths) < 2:
                fail(f"multi-rank moe {key}: every token exits at "
                     f"{depths}")
        spec["thresholds"], want = wants[key]
        got = pool.run((D, M), "_mr_serve", spec)
        tag = f"multi-rank moe {D}x{M} {E} experts {mode} {cohorts}"
        _mr_agree(tag, got, want, floats=True)
        for r, g in enumerate(got):
            # a rank steps whole cohorts of the lane's two, or, under
            # cond_batch, its rows of one: nothing to scatter
            check_launched(f"{tag} rank {r}", g["launches"],
                           MULTIRANK - ({"cohort_scatter"}
                                        if D > 1 or mode != "select"
                                        else set()))
            if not any(n for _, n in g["drops"]):
                fail(f"{tag} rank {r}: no pair dropped at prefill "
                     f"({g['drops']})")
            if g["w_up"][-3:] != _expert_shard(spec, M):
                fail(f"{tag} rank {r}: expert shard {g['w_up']}")
            ops = g["op_calls"]
            if (bool(ops.get("model/sum")) != (M > 1)
                    or bool(ops.get("data/gather")) != (D > 1)):
                fail(f"{tag} rank {r}: collectives {ops}")
            # a call split over data ranks gathers its chosen experts
            # over them once, and nothing else there (serving reads no aux)
            if (bool(g["split"]) != (D > 1)
                    or any(c != {"gather": 1} for c in g["split"])):
                fail(f"{tag} rank {r}: a data-split MoE call's collectives "
                     f"over its data ranks {g['split'][:8]}")
            # the decode steps' routing gathers, counted on the replays
            per = g["collectives_per_step"] or {"op_calls": {}}
            if bool(per["op_calls"].get("data/gather")) != (D > 1):
                fail(f"{tag} rank {r}: replayed collectives a step {per}")
        parity[f"{D}x{M}_{E}experts_{mode}_{cohorts}"] = {
            "identical": True, "thresholds": list(spec["thresholds"]),
            "drops": got[0]["drops"], "w_up": got[0]["w_up"],
            "op_calls": got[0]["op_calls"],
            "collectives_per_step": got[0]["collectives_per_step"],
            "seconds": got[0]["seconds"],
            "one_rank_seconds": want["seconds"]}
    lap = {"parity": time.perf_counter() - t0}
    cell = dict(arch=MR_MOE_ARCH, layers=MR_MOE_LAYERS, dtype="bfloat16",
                seed=0, new=MR_NEW_TOKENS, engine=MR_ENGINE, probe=True,
                router="record", thresholds=(0.9, 0.9, 0.0))
    one = _one_rank(cell)
    got = pool.run(MR_MESH, "_mr_serve", {
        **cell, "router": one["probe"].pop("router"), "serial_init": True})
    lap["cell"] = time.perf_counter() - t0 - lap["parity"]
    rels = {k: [float((a - b).norm() / b.norm())
                for a, b in zip(got[0]["probe"][k], one["probe"][k])]
            for k in ("prefill", "decode")}
    rel = max(max(v) for v in rels.values())
    routing = got[0]["probe"]["routing"]
    if rel > LOGIT_REL_TOL:
        fail(f"multi-rank moe cell: the exit logits differ normwise by "
             f"{rels} from the one-rank model's")
    if routing["n_faults"]:
        fail(f"multi-rank moe cell: a router choice parts from the "
             f"one-rank model's by more than {ROUTER_TIE_ULPS} bf16 ulps: "
             f"{routing['faults']}")
    for r, g in enumerate(got):
        if g["digest"] != one["digest"]:
            fail(f"multi-rank moe cell rank {r}: other weights drawn")
        if g["streams"] != got[0]["streams"]:
            fail(f"multi-rank moe cell: rank {r}'s streams differ from "
                 "rank 0's")
        check_launched(f"multi-rank moe cell rank {r}", g["launches"],
                       MULTIRANK)
        mk = g["megakernel_routes"]
        if mk["tc"] != mk["combine"] or mk["cuda_core"]:
            fail(f"multi-rank moe cell rank {r}: megakernel routes {mk}")
        if g["w_up"][-3:] != _expert_shard(cell, MR_MESH[1]):
            fail(f"multi-rank moe cell rank {r}: expert shard {g['w_up']}")
    n = same = 0
    for rid, (toks, _) in one["streams"].items():
        mine = got[0]["streams"][rid][0]
        n += len(toks)
        same += sum(a == b for a, b in zip(toks, mine))
    per = got[0]["collectives_per_step"]
    if per is None or not per["calls"]["model"]:
        fail(f"multi-rank moe cell: no collective counted on the captured "
             f"replays ({per})")
    cfg = _mr_config(cell)
    return {
        "parity": parity, "launches": got[0]["launches"],
        "cell": {
            "config": MR_MOE_ARCH, "n_layers": MR_MOE_LAYERS,
            "published_layers": 94, "dtype": "bfloat16",
            "d_model": cfg.d_model, "n_heads": cfg.n_heads,
            "n_kv_heads": cfg.n_kv_heads, "n_experts": cfg.n_experts,
            "top_k": cfg.top_k, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
            "mesh": dict(zip(("data", "model"), MR_MESH)),
            "w_up_shard": got[0]["w_up"], **MR_ENGINE, "requests": 8,
            "prompt_lens": [128, 256], "max_new_tokens": MR_NEW_TOKENS,
            "thresholds": list(cell["thresholds"]),
            "first_step_logits_rel_err": rel, "logits_rel_err": rels,
            "routing": routing, "token_agreement": same / n, "tokens": n,
            "decode_us_per_token":
                got[0]["stats"]["wallclock_us_per_token"],
            "one_rank_decode_us_per_token": one["wallclock_us_per_token"],
            "seconds": got[0]["seconds"], "one_rank_seconds": one["seconds"],
            "collectives_per_step": per,
            "dryrun_collectives_per_step": _dryrun_collectives(
                cell, MR_MESH, MR_ENGINE["lane_batch"]),
            "drops": got[0]["drops"], "op_calls": got[0]["op_calls"],
            "launches": got[0]["launches"],
            "one_rank_launches": one["launches"],
            "megakernel_routes": got[0]["megakernel_routes"],
            "stats": got[0]["stats"],
            "max_memory_allocated": [g["max_memory_allocated"]
                                     for g in got],
            "init_max_memory_allocated": [g["init_max_memory_allocated"]
                                          for g in got]},
        "laps": lap, "seconds": time.perf_counter() - t0}


def phase_multirank(dev, gen, smi, mixed, pool):
    """Slice 22: the dense cascade served over a ``(data, model)`` mesh of
    2 and 4 rank processes on the one card (``make_mesh``: gloo for the
    host, the IPC all-reduce kernel for every collective of the captured
    step).  (a) the transport; (b) the exit kernels' partial contract;
    (c) qwen2.5-3b's widths at 4 layers in f32 on MR_PARITY_MESHES:
    streams, segments_run and telemetry equal to the one-rank run's; (d)
    the main cell, qwen2.5-3b at MR_LAYERS in bf16 on 1 x 2 (2 cohorts,
    select, megakernel, cohort scatter, 8 requests x (128/256 + 16)): the
    first decode step's logits against the one-rank model's, the streams'
    agreement, µs per token, the collectives per step and the launches
    (every kernel of the path, the all-reduce included); (e) the moe
    family (:func:`_mr_moe`).  The rank processes are ``pool``'s (four).
    Returns {"transport", "exit", "launches", "cell", "moe"}."""
    import torch
    t_phase = time.perf_counter()
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    exit_cases = phase_multirank_exit(dev, gen)
    lap = {"exit": time.perf_counter() - t_phase}
    transport = phase_multirank_transport(pool)
    lap["transport"] = time.perf_counter() - t_phase - sum(lap.values())
    # (c): a threshold vector that splits the exits, from a one-rank
    # run at (0, 0, 0)
    parity = dict(layers=MR_PARITY_LAYERS, dtype="float32", seed=1,
                  new=MR_PARITY_NEW, engine=MR_ENGINE, autotune=True,
                  thresholds=(0.0, 0.0, 0.0))
    th = _median_threshold({rid: {"confs": c} for rid, c in
                            _one_rank(parity)["confs"].items()})
    parity["thresholds"] = (th, th, 0.0)
    want = _one_rank(parity)
    depths = {d for _, e in want["streams"].values() for d in e}
    if len(depths) < 2:
        fail(f"multi-rank parity: every token exits at {depths}")
    parity_out = {}
    for sizes in MR_PARITY_MESHES:
        got = pool.run(sizes, "_mr_serve", parity)
        tag = f"multi-rank parity {sizes[0]}x{sizes[1]}"
        _mr_agree(tag, got, want, floats=True)
        for r, g in enumerate(got):
            # with the lane's 2 cohorts split over 2 data ranks a rank
            # steps one whole cohort: nothing to scatter
            check_launched(f"{tag} rank {r}", g["launches"],
                           MULTIRANK - ({"cohort_scatter"}
                                        if sizes[0] > 1 else set()))
        parity_out[f"{sizes[0]}x{sizes[1]}"] = {
            "identical": True, "calls": got[0]["calls"],
            "bytes": got[0]["bytes"], "seconds": got[0]["seconds"],
            "local_batch": got[0]["local_batch"]}
    # the exit-update kernel's partial route on a served path: the
    # megakernel off on 1 x 2 (the exits' logits, then partial, gather
    # and combine); its streams the megakernel run's (kernel routes
    # agree on ints, as the route-parity phase holds)
    got = pool.run((1, 2), "_mr_serve", {**parity, "megakernel": False})
    for r, g in enumerate(got):
        tag = f"multi-rank parity 1x2 megakernel off rank {r}"
        if g["streams"] != want["streams"] or \
                g["carried"] != want["carried"]:
            fail(f"{tag}: streams or segments_run differ from the "
                 "one-rank megakernel run's")
        check_launched(tag, g["launches"],
                       MULTIRANK - {"megakernel"})
        eu = g["exit_update_routes"]
        if not (eu["partial"] and eu["partial"] == eu["combine"]):
            fail(f"{tag}: exit_update routes {eu}")
    parity_out["1x2_exit_update"] = {
        "identical": True, "exit_update_routes": got[0][
            "exit_update_routes"], "launches": got[0]["launches"]}
    lap["parity"] = time.perf_counter() - t_phase - sum(lap.values())
    # (d): the main cell
    cell = dict(layers=MR_LAYERS, dtype="bfloat16", seed=0,
                new=MR_NEW_TOKENS, engine=MR_ENGINE, probe=True,
                thresholds=(mixed, 0.9, 0.0))
    one = _one_rank(cell)
    got = pool.run(MR_MESH, "_mr_serve", cell)
    lap["cell"] = time.perf_counter() - t_phase - sum(lap.values())
    rels = {k: [float((a - b).norm() / b.norm())
                for a, b in zip(got[0]["probe"][k], one["probe"][k])]
            for k in ("prefill", "decode")}
    rel = max(max(v) for v in rels.values())
    if rel > LOGIT_REL_TOL:
        fail(f"multi-rank cell: the exit logits differ normwise by "
             f"{rels} from the one-rank model's")
    for r, g in enumerate(got):
        if g["digest"] != one["digest"]:
            fail(f"multi-rank cell rank {r}: other weights drawn")
        if g["streams"] != got[0]["streams"]:
            fail(f"multi-rank cell: rank {r}'s streams differ from rank 0's")
        check_launched(f"multi-rank cell rank {r}", g["launches"], MULTIRANK)
        mk = g["megakernel_routes"]
        if mk["tc"] != mk["combine"] or mk["cuda_core"]:
            fail(f"multi-rank cell rank {r}: megakernel routes {mk}")
    n = same = 0
    for rid, (toks, _) in one["streams"].items():
        mine = got[0]["streams"][rid][0]
        n += len(toks)
        same += sum(a == b for a, b in zip(toks, mine))
    per = got[0]["collectives_per_step"]
    if per is None or not per["calls"]["model"]:
        fail(f"multi-rank cell: no collective counted on the captured "
             f"replays ({per})")
    cell_out = {
        "config": "qwen2.5-3b", "n_layers": MR_LAYERS, "dtype": "bfloat16",
        "mesh": dict(zip(("data", "model"), MR_MESH)), **MR_ENGINE,
        "requests": 8, "prompt_lens": [128, 256],
        "max_new_tokens": MR_NEW_TOKENS,
        "thresholds": list(cell["thresholds"]),
        "first_step_logits_rel_err": rel, "logits_rel_err": rels,
        "token_agreement": same / n, "tokens": n,
        "decode_us_per_token": got[0]["stats"]["wallclock_us_per_token"],
        "one_rank_decode_us_per_token": one["wallclock_us_per_token"],
        "seconds": got[0]["seconds"], "one_rank_seconds": one["seconds"],
        "collectives_per_step": per,
        # the dry run's formula for the same mesh and step (ring wire
        # bytes a device; the measured bytes are each call's own part)
        "dryrun_collectives_per_step": _dryrun_collectives(
            cell, MR_MESH, MR_ENGINE["lane_batch"]),
        "allreduce_launches_per_step": None if per is None else
        sum(per["calls"].values()),
        "calls": got[0]["calls"], "bytes": got[0]["bytes"],
        "launches": got[0]["launches"],
        "one_rank_launches": one["launches"],
        "megakernel_routes": got[0]["megakernel_routes"],
        "exit_update_routes": got[0]["exit_update_routes"],
        "stats": got[0]["stats"],
        "max_memory_allocated": [g["max_memory_allocated"] for g in got]}
    moe = _mr_moe(pool)
    lap["moe"] = time.perf_counter() - t_phase - sum(lap.values())
    emit({"phase": "multirank", "compute_mode": mode, "nvidia_smi": smi,
          "transport": transport, "exit": exit_cases, "parity": parity_out,
          "parity_thresholds": list(parity["thresholds"]),
          "cell": cell_out, "moe": moe,
          "phase_seconds": time.perf_counter() - t_phase, "laps": lap})
    ar = next(c for c in transport[2][0] if c["shape"] == list(MR_SHAPES[0])
              and c["dtype"] == "bfloat16")
    return {"transport": transport, "exit": exit_cases,
            "launches": got[0]["launches"], "allreduce": ar,
            "moe_launches": moe["launches"],
            "exit_update_path": parity_out["1x2_exit_update"],
            "max_abs_err": max(c["max_abs_err"] for rs in transport.values()
                               for r in rs for c in r)}


# ---------------------------------------------------------------------------
# slice 23: multi-rank training, ranks sharing the card
# ---------------------------------------------------------------------------

# (a): the reduce-scatter on 2 and 4 ranks, at a whole input (R x n) of
# 16 KB and of 64 MB (past allreduce.CAP: split into rank-sliced chunks),
# its calls timed in runs; gloo's through the host, fewer
MRT_RS_BYTES = (16 << 10, 64 << 20)
MRT_RS_CALLS = {16 << 10: 40, 64 << 20: 10}
MRT_RS_LIB_CALLS = {16 << 10: 20, 64 << 20: 3}
# (b): qwen2.5-3b at its published widths cut to 6 of 36 layers in f32 (the
# trained phase's cut), train() for 8 steps of batch 4 x seq 64 on each
# mesh against the one-rank train()
MRT_LAYERS = 6
MRT_STEPS, MRT_BATCH, MRT_SEQ = 8, 4, 64
MRT_MESHES = ((1, 2), (2, 1))
# sound runs read 1.5e-7 - 2.3e-7 relative on an H100; a planted gradient
# fault (scripts/probe_multirank_train_faults.py: copy_to's backward
# without its all-reduce, an FSDP gradient sliced instead of
# reduce-scattered) 2.2e-3 - 3.2e-3 from the second step on
MRT_LOSS_RTOL = 1e-5
# a sign flip of a rounding-level gradient moves a weight at most 2 lr a
# step under AdamW (make_optimizer's lr 3e-4): the final params' bound
MRT_PARAM_ATOL = 2 * 3e-4 * MRT_STEPS
# ... and such flips are rare: at most this share of the params' elements
# ends more than 1e-5 from the one-rank run's (the CPU tests' FAR_SHARE);
# a wrong gradient of a leaf moves nearly all of its elements
MRT_FAR_SHARE = 1e-3
# kernels on the training path: the collectives (use_kernels is off: no
# kernel has a backward)
MULTIRANK_TRAIN = {"allreduce", "reduce_scatter"}
# (f): the moe family trained over the mesh, train() for MRT_STEPS steps
# of 4 x 64 against the one-rank train().  (f1) mixtral-8x7b at its
# published widths (d 4096, 32 / 8 heads, d_ff 14336, 8 experts top 2,
# vocab 32000) cut to 2 of 32 layers with 2 components (an exit after
# layer 1, the final one), in f32 (3.16 G params, 12.7 GB: the one-rank
# run ~64 GB with AdamW's moments, its gradients and updates), on 1 x 2
# only: 4 experts a rank, ~6.3 GB of shards, ~34 GB a rank with its
# state.  2 x 1 does not fit: the FSDP step gathers every leaf whole, so a
# rank would hold the 12.7-GB tree and its gradients besides its shards.
# (f2) phase "multirank"'s narrowed MoE model (MR_MOE_NARROW: capacity
# factor 0.5, pairs drop) at MR_MOE_LAYERS in f32 on 2 x 1 and 2 x 2 (8
# experts) and on 1 x 2 with 3 experts (the d_ff fallback)
MRT_MOE_ARCH = "mixtral-8x7b"
MRT_MOE_LAYERS = 2
MRT_MOE_MESH = (1, 2)
MRT_MOE_NARROW_MESHES = ((2, 1, 8), (2, 2, 8), (1, 2, 3))
# (f1) routes on the one-rank run's experts (_RouterProbe in f32 ulps, a
# flip a tie where both runs' margins lie within twice the row's logit
# difference): at these widths a near-tie of two router logits flips an
# expert between the two runs' roundings (on an H100 80GB HBM3: at step
# 4, and the losses then parted by 5.9e-4).  The router logits must agree
# with the one-rank run's, normwise, within MRT_ROUTER_RTOL at the first
# step (the same weights in both runs) and within MRT_ROUTER_STEP_RTOL at
# every step: later steps part by more, as AdamW turns a rounding-level
# gradient's sign into up to 2 lr of a weight — 1.58e-4 at most over the
# 8 steps in three runs on that card, of which this limit is ~3x
MRT_ROUTER_RTOL = 1e-5
MRT_ROUTER_STEP_RTOL = 5e-4


def _mrt_moe_specs():
    """(f)'s runs: (mesh, spec) each; a spec names the arch, its layers,
    its overrides and exits (:func:`_mrt_config`), and ``wide`` the
    full-width run (:func:`_mr_train`), last."""
    wide = dict(arch=MRT_MOE_ARCH, layers=MRT_MOE_LAYERS, exits=(1,),
                wide=True)
    return [((D, M), dict(arch=MR_MOE_ARCH, layers=MR_MOE_LAYERS,
                          over={**MR_MOE_NARROW, "n_experts": E}))
            for D, M, E in MRT_MOE_NARROW_MESHES] + [(MRT_MOE_MESH, wide)]


def _mrt_config(spec=None):
    """(b)'s config (``spec`` None): qwen2.5-3b at MRT_LAYERS in f32; else
    ``spec["arch"]`` at its published widths but for ``spec["over"]``, cut
    to ``spec["layers"]``, in f32, with exits after ``spec["exits"]``
    (the config's own cascade without them)."""
    from repro_torch.configs import get_config
    if spec is None:
        return get_config("qwen2.5-3b").replace(n_layers=MRT_LAYERS,
                                                dtype="float32")
    cfg = get_config(spec["arch"]).replace(
        n_layers=spec["layers"], dtype="float32", **spec.get("over", {}))
    if "exits" in spec:
        n = len(spec["exits"]) + 1
        cfg = cfg.with_cascade(n_components=n,
                               exit_boundaries=tuple(spec["exits"]),
                               thresholds=(0.9,) * (n - 1) + (0.0,))
    return cfg


def _mr_reduce_scatter(mesh, rank):
    """(a) on one rank of a (1, R) mesh: at each size and dtype the
    kernel's reduce-scatter over the world against ``ref_reduce_scatter``
    of every rank's input (drawn here on the card from each rank's seed),
    bit for bit; each call's time (CUDA events around runs of calls), the
    all-reduce kernel followed by a slice, and the library time: PyTorch's
    gloo all-reduce of the same CUDA tensor over the mesh's world group
    followed by a slice (gloo stages through the host; timed here, never
    called by the port)."""
    import torch
    import torch.distributed as dist
    from repro_torch import parallel
    from repro_torch.kernels import allreduce
    from repro_torch.kernels.ref import ref_reduce_scatter
    t = parallel.transport(mesh)
    R = t.size("world")
    out = []

    def timed(fn, calls, runs):
        per = []
        for _ in range(runs):
            e0, e1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            e0.record()
            for _ in range(calls):
                fn()
            e1.record()
            torch.cuda.synchronize()
            per.append(e0.elapsed_time(e1) / calls)
        return per

    for nbytes in MRT_RS_BYTES:
        for dt in (torch.bfloat16, torch.float32):
            n = nbytes // (R * torch.empty((), dtype=dt).element_size())
            parts = []
            for r in range(R):
                g = torch.Generator(device=DEV).manual_seed(2000 + 31 * r +
                                                            nbytes % 997)
                parts.append(torch.randn((R, n), generator=g, device=DEV)
                             .to(dt))
            x = parts[rank]
            name = str(dt).split(".")[-1]
            tag = f"reduce_scatter {R} ranks {nbytes} B {name}"
            launches = allreduce.reduce_scatter.launches
            got = t.reduce_scatter(x, "world")
            torch.cuda.synchronize()
            want = ref_reduce_scatter(parts, rank)
            check_equal(tag, got, want)
            calls = MRT_RS_CALLS[nbytes]
            per = timed(lambda: t.reduce_scatter(x, "world"), calls, 5)
            chunks = allreduce.reduce_scatter.launches - launches
            ar = timed(lambda: t.all_reduce(x, "world")[rank], calls, 5)
            lib = x.clone()
            dist.all_reduce(lib, group=t.groups["world"])
            lib_err = max_err(lib[rank], want)
            lib_per = timed(lambda: dist.all_reduce(
                x.clone(), group=t.groups["world"]),
                MRT_RS_LIB_CALLS[nbytes], 2)
            b, by = bound_ms((R + 1) * n * x.element_size(), (R - 1) * n,
                             name)
            out.append({
                "ranks": R, "bytes": nbytes, "shape": [R, n], "dtype": name,
                "exact": True, "max_abs_err": max_err(got, want),
                "launches_a_call": chunks // (1 + calls * 5),
                "ms": statistics.median(per), "ms_min": min(per),
                "ms_max": max(per),
                "allreduce_slice_ms": statistics.median(ar),
                "plain_ms": time_ms(lambda: ref_reduce_scatter(parts, rank),
                                    iters=10, warmup=2),
                "library_ms": statistics.median(lib_per),
                "library_ms_min": min(lib_per),
                "library_ms_max": max(lib_per),
                "library_backend": "torch.distributed.all_reduce, gloo, "
                                   "then the rank's slice",
                "library_max_abs_err": lib_err,
                "bound_ms": b, "bound_by": by})
            del parts, x, got, want, lib
    return out


def phase_multirank_reduce_scatter(pool=None):
    """(a): the reduce-scatter kernel on 2 and 4 rank processes sharing
    the card (:func:`_mr_reduce_scatter`); every rank's results."""
    own = pool is None
    pool = pool or _RankPool(max(MR_RANKS))
    try:
        return {R: pool.run((1, R), "_mr_reduce_scatter") for R in MR_RANKS}
    finally:
        if own:
            pool.close()


def _leaf_digest(x):
    """Two int64 checksums of a tensor's bits (its 32-bit words summed,
    and weighted by position mod a prime; int64 wraps alike on every
    rank): equal bits give equal digests."""
    import torch
    v = x.detach().contiguous().view(-1).view(torch.int32)
    a = b = 0
    step = 1 << 24
    for lo in range(0, v.numel(), step):
        c = v[lo:lo + step].long()
        w = torch.arange(lo, lo + c.numel(), device=c.device) % 1000003 + 1
        a += int(c.sum())
        b += int((c * w).sum())
    return (a, b % (1 << 63))


def _mr_train(mesh, rank, spec=None):
    """(b)-(d) and (f) on one rank: ``launch.train.train`` over ``mesh``
    at :func:`_mrt_config` of ``spec``; the losses, step ms, peak memory,
    the launches and the transport's calls and bytes a step, each leaf's
    digest of this rank's shard, and on rank 0 the one-rank ``train()``
    run first in this process (the other ranks wait at train()'s barrier)
    and the final params, gathered whole, against its params leaf by
    leaf.  With ``spec["wide"]`` (a full-width MoE run) the other ranks
    wait before they draw (the card holds one such run at a time), and
    the mesh run routes on the one-rank run's experts
    (:class:`_RouterProbe`, its record broadcast from rank 0) and reports
    its router's agreement."""
    import torch
    import torch.distributed as dist
    from repro_torch import kernels, parallel
    from repro_torch.launch.shard_rules import gather_placed, spec_leaves
    from repro_torch.launch.train import train
    from repro_torch.models import nn
    cfg = _mrt_config(spec)
    dev = torch.device(DEV)
    t = parallel.transport(mesh)
    wide = spec is not None and spec.get("wide", False)
    probe = _RouterProbe(mantissa=23, tie_ulps=None) if wide else None

    def routed(mode):
        if probe is None:
            return contextlib.nullcontext()
        probe.start(mode)
        return probe
    one = None
    laps, t0 = {}, time.perf_counter()
    if rank == 0:
        _free_card()
        torch.cuda.reset_peak_memory_stats()
        with routed("record"):
            p1, _, s1 = train(cfg, dev, MRT_STEPS, MRT_BATCH, MRT_SEQ,
                              log_every=MRT_STEPS)
        one = {"losses": s1["losses"], "step_ms": s1["step_ms"],
               "seconds": s1["seconds"],
               "max_memory_allocated": s1["max_memory_allocated"],
               "leaves": [x.detach().cpu() for x in nn.tree_leaves(p1)]}
        del p1
    _free_card()
    laps["one_rank"] = time.perf_counter() - t0
    if wide:
        # the other ranks block here until rank 0's one-rank run is done
        box = [probe.calls]
        dist.broadcast_object_list(box, src=0)
        probe.calls = box[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    calls0, bytes0, ops0 = dict(t.calls), dict(t.bytes), dict(t.op_calls)
    kernels.reset_launch_counts()
    with routed("replay"):
        params, spec, summary = train(cfg, dev, MRT_STEPS, MRT_BATCH,
                                      MRT_SEQ, mesh=mesh,
                                      log_every=MRT_STEPS)
    torch.cuda.synchronize()
    laps["mesh"] = time.perf_counter() - t0 - sum(laps.values())
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = {
        "calls": {a: (t.calls[a] - calls0[a]) / MRT_STEPS for a in t.calls},
        "bytes": {a: (t.bytes[a] - bytes0[a]) / MRT_STEPS for a in t.bytes},
        "ops": {k: (v - ops0.get(k, 0)) / MRT_STEPS
                for k, v in t.op_calls.items() if v - ops0.get(k, 0)}}
    out = {"coord": dict(t.coord), "losses": summary["losses"],
           "step_ms": summary["step_ms"], "max_memory_allocated": peak,
           "launches": launches, "per_step": per_step,
           "router": None if probe is None else probe.report(MRT_STEPS),
           "specs": [s for _, s in spec_leaves(spec)],
           "digests": [_leaf_digest(x) for x in nn.tree_leaves(params)]}
    laps["digests"] = time.perf_counter() - t0 - sum(laps.values())
    whole = [x.detach() for x in nn.tree_leaves(
        gather_placed(mesh, params, spec))]
    del params
    laps["gather"] = time.perf_counter() - t0 - sum(laps.values())
    if one is not None:
        errs = []
        for a, b in zip(whole, one.pop("leaves")):
            b = b.to(dev)
            d = (a - b).abs()
            errs.append({"max_abs": float(d.max()),
                         "normwise": float((a - b).norm() / b.norm()),
                         "beyond_1e-5": int((d > 1e-5).sum()),
                         "n": b.numel()})
            del b, d
        out["one_rank"] = one
        out["param_errs"] = errs
    del whole
    _free_card()
    laps["compare"] = time.perf_counter() - t0 - sum(laps.values())
    out["laps"] = laps
    return out


def _mr_train_refusals(mesh, rank):
    """A hybrid config asked of the trainer on a real two-rank mesh:
    refused by name."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import place_on_mesh
    try:
        place_on_mesh(mesh, get_config("zamba2-1.2b"), {})
    except NotImplementedError as err:
        return str(err)
    return None


def _dryrun_train_collectives(sizes, spec=None):
    """The dry run's per-device collective bytes and counts
    (``launch/dryrun.py`` ``collectives``) for :func:`_mrt_config`'s
    training step on a ``sizes`` mesh, the default (FSDP) layout:
    shape-only, on fake tensors (for the moe family its formula counts
    GSPMD's all-to-alls)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.shard_rules import param_spec
    from repro_torch.models.model import build_model
    cfg = _mrt_config(spec)
    mesh = AbstractMesh(tuple(sizes), ("data", "model"))
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = build_model(cfg, device="cpu").init(0)
        pairs = dryrun._pairs(params, param_spec(params, cfg, mesh))
    coll, counts = dryrun.collectives(cfg, pairs, mesh,
                                      MRT_BATCH * MRT_SEQ, MRT_BATCH, True,
                                      "default")
    return {"bytes": coll, "counts": counts}


def _by_kind(ops):
    """A transport's calls by "axis/op" summed by the dry run's kinds."""
    kind = {"sum": "all-reduce", "max": "all-reduce", "gather": "all-gather",
            "reduce_scatter": "reduce-scatter", "host": "host"}
    out = {}
    for k, v in ops.items():
        name = kind[k.split("/")[1]]
        out[name] = out.get(name, 0) + v
    return out


def _mrt_run(pool, sizes, spec=None):
    """One mesh of (b) or (f): :func:`_mr_train` on every rank of
    ``sizes``, held against rank 0's one-rank run (losses, final params,
    replicated leaves' bits, the loss's trend, the launches); its
    record."""
    import numpy as np
    got = pool.run(sizes, "_mr_train", spec)
    cfg = _mrt_config(spec)
    tag = (f"multi-rank train {cfg.name} {cfg.n_experts or ''}"
           f"{' experts ' if cfg.n_experts else ''}{sizes[0]}x{sizes[1]}")
    one = got[0]["one_rank"]
    for r, g in enumerate(got):
        losses = g["losses"]
        if not np.isfinite(losses).all():
            fail(f"{tag} rank {r}: losses {losses}")
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, one["losses"])]
        if max(rel) > MRT_LOSS_RTOL:
            fail(f"{tag} rank {r}: losses {losses} against the one-rank "
                 f"{one['losses']} (relative {max(rel)})")
        check_launched(f"{tag} rank {r}", g["launches"], MULTIRANK_TRAIN)
        rt = g["router"]
        if rt is not None and not (
                rt["calls"] and rt["replayed"] == rt["calls"]
                and rt["logits_rel_err_by_step"][0] <= MRT_ROUTER_RTOL
                and max(rt["logits_rel_err_by_step"])
                <= MRT_ROUTER_STEP_RTOL
                and not rt["n_faults"]):
            fail(f"{tag} rank {r}: the router against the one-rank run's "
                 f"(the first step's logits within {MRT_ROUTER_RTOL}, "
                 f"every step's within {MRT_ROUTER_STEP_RTOL}, flips ties "
                 f"only): {rt}")
    k = max(2, MRT_STEPS // 3)
    if spec is None and not np.mean(got[0]["losses"][-k:]) < np.mean(
            got[0]["losses"][:k]):
        # (b)'s trend (a MoE model at random weights need not trend in
        # 8 steps: (f) holds it to the one-rank run alone)
        fail(f"{tag}: the loss did not trend down {got[0]['losses']}")
    errs = got[0]["param_errs"]
    worst = max(e["max_abs"] for e in errs)
    far = sum(e["beyond_1e-5"] for e in errs) / sum(e["n"] for e in errs)
    if not (worst <= MRT_PARAM_ATOL and far <= MRT_FAR_SHARE):
        fail(f"{tag}: final params {worst} from the one-rank run's "
             f"(bound {MRT_PARAM_ATOL}), a share {far} of them past "
             f"1e-5 (bound {MRT_FAR_SHARE})")
    replicated = 0
    for i, leaf_spec in enumerate(got[0]["specs"]):
        placed = sorted({a for e in leaf_spec for a in (
            e if isinstance(e, tuple) else (e,)) if a})
        groups = {}
        for g in got:
            key = tuple(g["coord"][a] for a in placed)
            groups.setdefault(key, []).append(g["digests"][i])
        for members in groups.values():
            replicated += len(members) > 1
            if any(d != members[0] for d in members):
                fail(f"{tag}: leaf {i} ({leaf_spec}) differs across the "
                     "ranks it is replicated over")
    return {
        "config": cfg.name, "n_layers": cfg.n_layers, "dtype": "float32",
        "d_model": cfg.d_model, "n_experts": cfg.n_experts,
        "top_k": cfg.top_k, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
        "capacity_factor": cfg.capacity_factor if cfg.n_experts else None,
        "mesh": dict(zip(("data", "model"), sizes)),
        "losses": got[0]["losses"], "one_rank_losses": one["losses"],
        "loss_max_rel_err": max(
            abs(a - b) / abs(b) for g in got
            for a, b in zip(g["losses"], one["losses"])),
        "param_max_abs_err": worst, "param_atol": MRT_PARAM_ATOL,
        "param_max_normwise_err": max(e["normwise"] for e in errs),
        "param_share_beyond_1e-5": far, "param_far_share": MRT_FAR_SHARE,
        "replicated_leaf_groups_bit_equal": replicated,
        "step_ms": [g["step_ms"] for g in got],
        "step_ms_median": [statistics.median(g["step_ms"][1:])
                           for g in got],
        "one_rank_step_ms": one["step_ms"],
        "one_rank_step_ms_median": statistics.median(one["step_ms"][1:]),
        "one_rank_loop_seconds": one["seconds"],
        "max_memory_allocated": [g["max_memory_allocated"] for g in got],
        "one_rank_max_memory_allocated": one["max_memory_allocated"],
        "launches": got[0]["launches"], "router": got[0]["router"],
        "rank_laps": [g["laps"] for g in got],
        "collectives_per_step": got[0]["per_step"],
        "collectives_per_step_by_kind": _by_kind(got[0]["per_step"]["ops"]),
        "dryrun_collectives_per_step": _dryrun_train_collectives(sizes,
                                                                 spec)}


def phase_multirank_train(smi, pool):
    """Slices 23 and 25: the dense and moe families trained over a
    ``(data, model)`` mesh of rank processes sharing the card, through
    phase "multirank"'s pool.  (a) the reduce-scatter kernel on 2 and 4
    ranks, bf16 and f32, at 16 KB and 64 MB: bit for bit against
    ``ref_reduce_scatter``, timed beside the all-reduce kernel and a slice
    and beside gloo.  (b) ``train()`` of qwen2.5-3b at its published
    widths cut to :data:`MRT_LAYERS` layers in f32, :data:`MRT_STEPS`
    steps of batch 4 x seq 64, on 1 x 2 and 2 x 1 against the one-rank
    ``train()`` (run in rank 0's process): every rank's losses within
    :data:`MRT_LOSS_RTOL` relative at every step, the final params
    gathered whole within :data:`MRT_PARAM_ATOL` of the one-rank run's at
    every element (a flipped rounding-level gradient moves a weight at
    most 2 lr a step) and at most a share :data:`MRT_FAR_SHARE` of them
    more than 1e-5 away, every leaf replicated over an axis with the same
    bits on every rank of it, the loss trending down, and exactly
    :data:`MULTIRANK_TRAIN` launched (:func:`_mrt_run`).  (c) the
    collectives of one step per axis and op, counted by the transport,
    beside ``dryrun.collectives`` for the same mesh and shape.  (d) step
    ms and peak memory per rank (two processes time-sliced on one card:
    these times measure context switches, not multi-GPU speed).  (f) the
    moe family under the same gates (:func:`_mrt_moe_specs`): the narrowed
    MoE model on 2 x 1, 2 x 2 and 1 x 2 with 3 experts, then mixtral-8x7b
    at its published widths on 1 x 2, the pool shrunk to its two ranks
    first (the phase uses the pool last).  A hybrid config on a real 1 x 2 mesh is
    refused by name.  Returns {"reduce_scatter", "launches",
    "headline"}."""
    t_phase = time.perf_counter()
    lap = {}
    rs = phase_multirank_reduce_scatter(pool)
    lap["reduce_scatter"] = time.perf_counter() - t_phase
    refused = pool.run((1, 2), "_mr_train_refusals")
    for r, msg in enumerate(refused):
        if not msg or "hybrid" not in msg or "2 ranks" not in msg:
            fail(f"multi-rank train: rank {r}'s hybrid refusal {msg!r}")
    runs = {f"{D}x{M}": _mrt_run(pool, (D, M)) for D, M in MRT_MESHES}
    lap["train"] = time.perf_counter() - t_phase - sum(lap.values())
    moe = {}
    for sizes, spec in _mrt_moe_specs():
        if spec.get("wide"):
            # (f1)'s two ranks at their AdamW peak and the parent fill the
            # card within a few GB: the idle ranks' contexts go first
            pool.shrink(sizes[0] * sizes[1])
        t0 = time.perf_counter()
        cfg = _mrt_config(spec)
        key = f"{cfg.name}_{cfg.n_experts}experts_{sizes[0]}x{sizes[1]}"
        moe[key] = _mrt_run(pool, sizes, spec)
        moe[key]["seconds"] = time.perf_counter() - t0
    lap["moe"] = time.perf_counter() - t_phase - sum(lap.values())
    emit({"phase": "multirank_train", "nvidia_smi": smi,
          "config": "qwen2.5-3b", "n_layers": MRT_LAYERS, "dtype": "float32",
          "steps": MRT_STEPS, "batch": MRT_BATCH, "seq": MRT_SEQ,
          "loss_rtol": MRT_LOSS_RTOL, "reduce_scatter": rs, "runs": runs,
          "moe": moe, "hybrid_refusal": refused[0],
          "phase_seconds": time.perf_counter() - t_phase, "laps": lap})
    head = next(c for c in rs[2][0] if c["bytes"] == MRT_RS_BYTES[1]
                and c["dtype"] == "float32")
    return {"reduce_scatter": rs, "launches": runs["2x1"]["launches"],
            "headline": head,
            "max_abs_err": max(c["max_abs_err"] for rr in rs.values()
                               for r in rr for c in r)}


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
    # each phase group's seconds, printed before the kernels line
    laps, t_lap = {}, [t0]

    def lap(name):
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

    build_times = build.build_all(verbose=True)
    lap("build")
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
              "megakernel": phase_megakernel(dev, gen)
              + phase_megakernel_wide(dev, gen)
              + phase_megakernel_wide(dev, gen, VLM_ARCH),
              "cohort_scatter": phase_cohort_scatter(dev, gen),
              "paged_gather": phase_paged_gather(dev, gen)}
    # the same kernels at the dense family's other published widths:
    # yi-9b's (the escalate phase's second stage), deepseek-coder-33b's
    # and minitron-4b's; and the moe family's: mixtral-8x7b's (the window)
    # and qwen3-moe-235b-a22b's (group 16, vocab 151936)
    # and the hybrid family's: zamba2-1.2b's norms and exit heads, and the
    # cohort scatter's whole-cohort route over its state leaves
    # and the ssm family's: xlstm-350m's norms and exit heads (tc at d
    # 1024), and the whole-cohort route over its mLSTM and sLSTM stages
    # and the audio family's: whisper-tiny's head dim 64 (flash's CUDA-core
    # route in bf16, decode over the W 448 ring) and exit_update at V 51865
    # and the vlm family's: llama-3.2-vision-90b's d 8192 (rmsnorm's block
    # route, exit_update over 32 tiles, decode attention at 8 query heads
    # a KV head; its exit head above, in phase_megakernel_wide)
    for arch in (*DENSE_SHAPES, *MOE_SHAPES, *HYBRID_SHAPES, *XLSTM_SHAPES,
                 *WHISPER_SHAPES, *VISION_SHAPES):
        for name, cases in config_kernel_cases(dev, gen, arch).items():
            checks[name] += cases
    checks["cohort_scatter"].append(phase_state_scatter(dev, gen))
    for stage, leaves in XLSTM_STATE_LEAVES.items():
        checks["cohort_scatter"].append(phase_state_scatter(
            dev, gen, "xlstm-350m", leaves, stage))
    checks["cohort_scatter"].append(phase_ring_scatter(
        dev, gen, "whisper-tiny", *WHISPER_RING))
    checks["cohort_scatter"].append(phase_ring_scatter(
        dev, gen, VLM_ARCH, *VISION_RING))
    for name, cases in checks.items():
        emit({"phase": "kernel_check", "kernel": name, "cases": cases})
    emit({"phase": "paged_gather_unaligned",
          **paged_gather_refuses_unaligned(dev)})
    lap("kernel checks")
    phase_peaks(dev, gen, smi)
    lap("peaks")

    # each kernel's launches come from the path that runs it: slice 1's
    # one-cohort run, slice 2's cohort run at the mixed threshold vector,
    # Algorithm 1, slice 3's paged run at capacity, and the select-mode
    # cohort run of the parity phase
    slice1, slice1_routes = phase_full_width()
    lap("full width")
    (cohorts, cohort_routes), model, params, records = \
        phase_full_width_cohorts()
    lap("cohorts")
    algorithm1 = phase_algorithm1(model, params)
    lap("algorithm 1")
    paged_routes = phase_full_width_paged(params)
    lap("paged")
    gather_full_width = phase_paged_gather_full_width(params)
    lap("paged block 64")
    device_runtime = phase_device_runtime(records[2]["thresholds"][0])
    lap("device runtime")
    autotune = phase_autotune()
    lap("autotune")
    # slice 20: the serving path through a 1x1 device mesh
    mesh = phase_mesh(model, params, records[2]["thresholds"][0], smi)
    lap("mesh")
    del model, params
    torch.cuda.empty_cache()
    select, gathers = phase_route_parity()
    lap("route parity")
    phase_cli()
    lap("cli")
    paper = phase_paper()
    lap("paper")
    phase_train()
    lap("train")
    phase_mesh_train(smi)
    lap("mesh train")
    phase_dryrun()
    lap("dryrun")
    escalate = phase_escalate()
    lap("escalate")
    # slice 12: the dense family whole, each model alone on the card
    # slice 13: deepseek-coder-33b's exit heads on the tc route
    deepseek = phase_dense_full_width("deepseek-coder-33b", smi,
                                      megakernel=True)
    minitron = phase_dense_full_width("minitron-4b", smi, megakernel=True)
    lap("dense family")
    variants = phase_dense_variants()
    lap("dense variants")
    tuned = phase_kernel_tune()
    lap("kernel tune")
    # slice 14: the flight recorder and the fleet tier, the last phases
    # before the kernels line
    base, model, params = qwen_full_width()
    phase_obs(base, model, params)
    fleet = phase_fleet(base, model, params)
    del model, params
    torch.cuda.empty_cache()
    phase_fleet_cli()
    lap("obs and fleet")
    # slice 15: the moe family, each model alone on the card
    mixtral = phase_moe("mixtral-8x7b", smi, window_run=True)
    qwen3 = phase_moe("qwen3-moe-235b-a22b", smi)
    lap("moe")
    # slice 16: the hybrid family, alone on the card
    hybrid = phase_hybrid(smi)
    lap("hybrid")
    # slice 17: the ssm family, alone on the card
    ssm = phase_ssm(smi)
    lap("ssm")
    # slice 18: the audio family, alone on the card
    audio = phase_audio(smi)
    lap("audio")
    # slice 19: the vlm family at 15 of its 100 layers (30 until slice
    # 21, 20 until slice 24), alone on the card
    vlm = phase_vlm(smi)
    lap("vlm")
    # slice 21: the LLM cascade trained, calibrated and served, then the
    # four examples
    trained = phase_trained_cascade(smi)
    lap("trained cascade")
    phase_examples(dev, gen, smi)
    lap("examples")
    # slice 22: multi-rank serving, rank processes sharing the card; slice
    # 23: multi-rank training, on the same rank processes
    pool = _RankPool(4)
    try:
        multirank = phase_multirank(dev, gen, smi,
                                    records[2]["thresholds"][0], pool)
        lap("multi-rank")
        mr_train = phase_multirank_train(smi, pool)
        lap("multi-rank train")
    finally:
        pool.close()
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
    # paged_gather's the bf16 block-64 store of the full-width run whose
    # decode attentions it serves
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
                                                 list(GATHER_TABLE)]
        and c["dtype"] == "bfloat16",
    }
    # the launches on the path by route, for the kernels that have two
    paged_case = next(c for c in checks["decode_attention"]
                      if c["dtype"] == "bfloat16" and c["route"] == "paged")
    extra = {"confidence": {"launches_cnn": paper["confidence"],
                            "path_cnn": "paper: Algorithm 1 on CI-RESNET(18),"
                            f" {ALG1_BATCH} images, (B, 10) f32"},
             "flash_attention": {"routes": slice1_routes["flash_attention"]},
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
                     # launches on the escalation tier's path: the device
                     # runtime's middle-threshold run, both stages (a
                     # 12-layer draft and the 36-layer model, dense, one
                     # cohort)
                     "launches_escalate": escalate[name],
                     # launches on slice 12's paths, device runtime, 8
                     # requests x 16 tokens at (0.9, 0.9, 0.0): each
                     # full-width model with one cohort; minitron-4b with
                     # 2 cohorts and the megakernel at a mixed threshold;
                     # the 4-layer layernorm / learned-position / tied
                     # model with the megakernel on (it falls back); the
                     # full-width qwen2.5-3b model on the serving preset's
                     # tuned tiles at a split threshold, one cohort and two
                     # with the megakernel
                     "launches_deepseek_33b": deepseek["one_cohort"][name],
                     "launches_minitron_4b": minitron["one_cohort"][name],
                     "launches_minitron_4b_megakernel":
                         minitron["megakernel"][name],
                     # slice 13's paths, device runtime, 8 requests x 16
                     # tokens: deepseek-coder-33b with 2 cohorts and the
                     # megakernel (tc at d 7168) at a mixed threshold;
                     # qwen2.5-3b at full width with the paged cache at
                     # block size 64 (every decode attention over views
                     # paged_gather gathers), 2 cohorts, (0.9, 0.9, 0.0)
                     "launches_deepseek_33b_megakernel":
                         deepseek["megakernel"][name],
                     "launches_paged_block64": gather_full_width[name],
                     "launches_dense_variants": variants[name],
                     "launches_kernel_tune": {c: n[name]
                                              for c, n in tuned.items()},
                     # slice 14's fleet paths, two qwen2.5-3b members on
                     # the device runtime at (0.9, 0.9, 0.0): paged (block
                     # 16, 2 cohorts, megakernel, recorder on) with member
                     # 0 drained mid-decode, 8 requests x 32 tokens; and
                     # dense with one cohort, 16 requests x 32 tokens
                     "launches_fleet": fleet["paged_drain"][name],
                     "launches_fleet_dense": fleet["dense"][name],
                     # slice 15's paths, device runtime: mixtral-8x7b (8
                     # layers) and qwen3-moe-235b-a22b (4 layers), 8
                     # requests x 16 tokens at (0.9, 0.9, 0.0), one cohort
                     # and two with the megakernel at a mixed threshold;
                     # mixtral's window run (4 requests of 4224 prompt
                     # tokens + 32, ring 4096)
                     "launches_mixtral_8x7b": mixtral["one_cohort"][name],
                     "launches_mixtral_8x7b_megakernel":
                         mixtral["megakernel"][name],
                     "launches_mixtral_8x7b_window": mixtral["window"][name],
                     "launches_qwen3_moe": qwen3["one_cohort"][name],
                     "launches_qwen3_moe_megakernel":
                         qwen3["megakernel"][name],
                     # slice 16's paths, device runtime: zamba2-1.2b at
                     # full width cut to 19 layers, 13 requests x 16
                     # tokens — one cohort at
                     # (0.9, 0.9, 0.0); 2 cohorts with the megakernel at a
                     # mixed threshold; the same in select mode with the
                     # cohort scatter; the same with autotune's shadow
                     # step
                     "launches_hybrid": {p: n[name]
                                         for p, n in hybrid.items()},
                     # slice 17's paths, device runtime: xlstm-350m at
                     # full width, 13 requests x 16 tokens — the same four
                     # paths as the hybrid's
                     "launches_ssm": {p: n[name] for p, n in ssm.items()},
                     # slice 18's paths, device runtime: whisper-tiny at
                     # full width, cache_len 448, 13 requests x 16 tokens
                     # — the same four paths as the hybrid's
                     "launches_audio": {p: n[name]
                                        for p, n in audio.items()},
                     # slice 19's paths, device runtime:
                     # llama-3.2-vision-90b at full width cut to 15
                     # layers, 13 requests x 16 tokens — the same four
                     # paths as the hybrid's
                     "launches_vlm": {p: n[name] for p, n in vlm.items()},
                     # slice 20's path, device runtime through a 1x1
                     # device mesh: qwen2.5-3b at full width, 2 cohorts,
                     # select mode with the megakernel and the cohort
                     # scatter, 8 requests x 32 tokens at phase 4's mixed
                     # vector
                     "launches_mesh": mesh[name],
                     # slice 21's path, device runtime: qwen2.5-3b at its
                     # published widths cut to 6 layers, trained in f32 and
                     # served in bf16, 2 cohorts, select mode with the
                     # megakernel and the cohort scatter, 8 requests x 32
                     # tokens at the (final, 0.05) calibrated thresholds
                     "launches_trained": trained[name],
                     # slice 22's main cell: qwen2.5-3b at 12 layers in
                     # bf16 on a 1 x 2 mesh (rank 0's launches), 2
                     # cohorts, select, megakernel (its partial route and
                     # combine) and cohort scatter, 8 requests x 16 tokens
                     "launches_multirank": multirank["launches"][name],
                     # slice 24's: qwen3-moe-235b-a22b at its published
                     # widths cut to 4 layers, bf16, on the 1 x 2 mesh
                     # (rank 0's; 64 experts a rank), 2 cohorts, select,
                     # megakernel and cohort scatter, 8 requests x 16
                     "launches_multirank_moe": multirank["moe_launches"][
                         name],
                     **({"partial_route": multirank["exit"][name]}
                        if name in multirank["exit"] else {}),
                     # exit_update's partial route served: the 4-layer f32
                     # parity model on 1 x 2 with the megakernel off
                     **({"launches_multirank_megakernel_off": multirank[
                         "exit_update_path"]["exit_update_routes"]}
                        if name == "exit_update" else {}),
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
    ar = multirank["allreduce"]
    rows.append({
        "name": "allreduce", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/allreduce.cu",
        "replaces": "none: the reference's collectives are GSPMD's "
                    "(src/repro/serving/runtime.py:109)",
        "launches": multirank["launches"]["allreduce"],
        "path": f"multi-rank cell: qwen2.5-3b, {MR_LAYERS} layers, bf16, "
                "1 x 2 mesh, rank 0",
        "launches_multirank_moe": multirank["moe_launches"]["allreduce"],
        "path_multirank_moe": "multi-rank moe cell: qwen3-moe-235b-a22b, "
                              "4 layers, bf16, 1 x 2 mesh, rank 0",
        "max_abs_err": multirank["max_abs_err"],
        "ms": ar["ms"], "plain_ms": ar["plain_ms"],
        "bound_ms": ar["bound_ms"], "bound_by": ar["bound_by"],
        "library_ms": ar["library_ms"],
        "headline_case": {k: ar[k] for k in ("ranks", "shape", "dtype",
                                             "ms_min", "ms_max",
                                             "library_backend")},
        "note": "ranks are processes time-sliced on one card"})
    rs = mr_train["headline"]
    rows.append({
        "name": "reduce_scatter", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/allreduce.cu",
        "replaces": "none: the reference's training collectives are "
                    "GSPMD's (src/repro/launch/train.py:52)",
        "launches": mr_train["launches"]["reduce_scatter"],
        "path": f"multi-rank train: qwen2.5-3b, {MRT_LAYERS} layers, f32, "
                f"2 x 1 mesh, {MRT_STEPS} steps, rank 0",
        "max_abs_err": mr_train["max_abs_err"],
        "ms": rs["ms"], "plain_ms": rs["plain_ms"],
        "bound_ms": rs["bound_ms"], "bound_by": rs["bound_by"],
        "library_ms": rs["library_ms"],
        "headline_case": {k: rs[k] for k in (
            "ranks", "bytes", "shape", "dtype", "ms_min", "ms_max",
            "allreduce_slice_ms", "launches_a_call", "library_backend")},
        "note": "ranks are processes time-sliced on one card"})
    emit({"phase": "timings", "seconds": laps,
          "total_seconds": time.perf_counter() - t0})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
