#!/usr/bin/env python3
"""Probe two of the port's kernels from the inside, on one GPU.

``python3 scripts/probe_kernel_variants.py prologue [--ctas 126]``
builds a copy of ``csrc/megakernel.cu`` under ``build/probe/`` with
``%globaltimer`` stamps in the ``tc`` route (each CTA's start, the block
norm's rows landed, its sums done, the prologue's end, the CTA's end) and times deepseek-coder-33b's exit head (B, 7168) x (7168,
32256) at B = 1, 4, 8 and qwen2.5-3b's (4, 2048) x (2048, 151936) in
bf16: the kernel's CUDA-event time and each stamp's median over the CTAs,
in µs.  ``--ctas`` sets the persistent CTA count in place of one per SM.

``python3 scripts/probe_kernel_variants.py gather-boxes`` builds copies of
``csrc/paged_gather.cu`` with other box sizes and ring depths (16 KB x
8, the kernel's; 8 KB x 8 and 16; 4 KB x 16 and 32) and runs
``chip_smoke.phase_paged_gather`` on each, twice in turns: the CUDA-event
and profiler device times at its five shapes.

``python3 scripts/probe_kernel_variants.py megakernel [--src DIR]`` times
the exit-head megakernel at the dense family's B = 4 decode shapes
(qwen2.5-3b, minitron-4b, yi-9b, deepseek-coder-33b), three medians of
50 calls each, with the package from ``DIR`` (another checkout's
``src``, e.g. the parent's unpacked by ``git archive`` under ``build/``):
run it on two checkouts in turns to compare them in one call.

Prints the card line, then one JSON object a line.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "probe"

# the tc kernel's stamps: (anchor in csrc/megakernel.cu, the line put
# after it); row k - 1 of the (4, n_ctas) int64 result holds stamp k less
# stamp 0
_STAMPS = [
    ("  const int tid = threadIdx.x;\n",
     "  long long t_[5] = {0, 0, 0, 0, 0};\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_[0]));\n"),
    ("    mbar_arrive(ready);\n    consumers_sync();\n",
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_[1]));\n"),
    ("        if (lane == 0) part[N * 8 + r] = rsqrtf(s / (float)d + eps);\n"
     "      }\n    }\n    consumers_sync();\n",
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_[2]));\n"),
]


def _timed_megakernel(build) -> Path:
    """csrc/megakernel.cu with the stamps; the rows' copy for the checks
    (xn_out) becomes the stamps' store: the rows landed, the sums done,
    the prologue's end and the CTA's end, each from the CTA's start (-1
    where the warp route has no such stamp)."""
    src = (build.CSRC / "megakernel.cu").read_text()
    for anchor, line in _STAMPS:
        if src.count(anchor) != 1:
            raise SystemExit(f"probe: anchor not found once: {anchor!r}")
        src = src.replace(anchor, anchor + line)
    copy = "  if (xn_out != nullptr && cta == 0) {"
    end = "    pa[o] = a;\n  }\n}\n"
    if src.count(copy) != 1 or src.count(end) != 1:
        raise SystemExit("probe: the tc kernel's tail has moved")
    src = src.replace(copy, "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : "
                      "\"=l\"(t_[3]));\n  if (false) {")
    src = src.replace(end, (
        "    pa[o] = a;\n  }\n"
        "  if (xn_out != nullptr && tid == 0) {\n"
        "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_[4]));\n"
        "    long long* o = reinterpret_cast<long long*>(xn_out);\n"
        "    for (int k = 1; k < 5; ++k)\n"
        "      o[(k - 1) * gridDim.x + cta] = t_[k] ? t_[k] - t_[0] : -1;\n"
        "  }\n}\n"))
    return _compile(build, "megakernel_timed", src)


def _compile(build, name: str, src: str) -> Path:
    OUT.mkdir(parents=True, exist_ok=True)
    cu, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(src)
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                        str(build.CSRC), "-o", str(lib), str(cu)],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"probe: nvcc {cu.name}:\n{r.stdout}{r.stderr}")
    return lib


def _head(B, d, V, gen):
    import torch
    h = torch.randn(B, d, generator=gen, device="cuda").bfloat16()
    w = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    head = (0.02 * torch.randn(d, V, generator=gen, device="cuda")).bfloat16()
    return h, w, head


def prologue(args, build, cs):
    import torch
    from repro_torch.kernels import megakernel
    from repro_torch.kernels.megakernel import exit_head_update
    timed = ctypes.CDLL(str(_timed_megakernel(build)))
    real = build.load("megakernel")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_m = 3
    if args.ctas:
        megakernel._tc_ctas = lambda dev, V: args.ctas
    for B, d, V in ((1, 7168, 32256), (4, 7168, 32256), (8, 7168, 32256),
                    (4, 2048, 151936)):
        h, w, head = _head(B, d, V, gen)
        carry = cs._carries(B, n_m, "cuda")
        ths = torch.full((n_m,), 0.5, device="cuda")
        kw = dict(threshold=ths, m=0, n_components=n_m)
        ms = cs.time_ms(lambda: exit_head_update(h, w, head, *carry, **kw))
        build._libs["megakernel"] = timed
        buf = torch.zeros(B, d, dtype=h.dtype, device="cuda")
        for _ in range(3):
            exit_head_update(h, w, head, *carry, **kw, xn_out=buf)
        torch.cuda.synchronize()
        build._libs["megakernel"] = real
        n = megakernel._tc_ctas(h.device, V)
        st = buf.view(torch.int64).flatten()[:4 * n].view(4, n).cpu()

        def med(row):
            return None if row[0] < 0 else float(row.median()) / 1e3

        print(json.dumps({
            "shape": [B, d, V], "route": megakernel.route(h, head),
            "ctas": n, "ms": ms, "rows_landed_us": med(st[0]),
            "sums_done_us": med(st[1]), "prologue_us": med(st[2]),
            "cta_us": med(st[3]), "cta_us_max": float(st[3].max()) / 1e3}),
            flush=True)
        del head


def gather_boxes(args, build, cs):
    import torch
    src = (build.CSRC / "paged_gather.cu").read_text()
    stages, box = "constexpr int kStages = 8;", \
        "constexpr long long kBox = 16384;"
    if src.count(stages) != 1 or src.count(box) != 1:
        raise SystemExit("probe: the gather's ring constants have moved")
    libs = {}
    for b, s in ((16384, 8), (8192, 8), (8192, 16), (4096, 16), (4096, 32)):
        libs[(b, s)] = ctypes.CDLL(str(_compile(
            build, f"paged_gather_{b}_{s}",
            src.replace(stages, f"constexpr int kStages = {s};")
            .replace(box, f"constexpr long long kBox = {b};"))))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for rep in range(2):
        for (b, s), lib in libs.items():
            build._libs["paged_gather"] = lib
            cases = cs.phase_paged_gather(torch.device("cuda"), gen)
            print(json.dumps({
                "box": b, "stages": s, "rep": rep,
                "shapes": [c["shape"] + [c["dtype"]] for c in cases],
                "ms": [c["ms"] for c in cases],
                "device_ms": [c["device_ms_profiler"] for c in cases]}),
                flush=True)


def megakernel_times(args, build, cs):
    import torch
    from repro_torch.kernels.megakernel import exit_head_update
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_m = 3
    out = {"src": str(args.src)}
    for B, d, V in ((4, 2048, 151936), (4, 3072, 256000), (4, 4096, 64000),
                    (4, 7168, 32256)):
        h, w, head = _head(B, d, V, gen)
        carry = cs._carries(B, n_m, "cuda")
        ths = torch.full((n_m,), 0.5, device="cuda")

        def call():
            return exit_head_update(h, w, head, *carry, threshold=ths, m=0,
                                    n_components=n_m)

        _, route = cs.route_of(call, exit_head_update)
        out[f"{B}x{d}x{V}"] = {"route": route, "ms": [
            cs.time_ms(call, iters=50) for _ in range(3)]}
        del head
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("probe", choices=("prologue", "gather-boxes",
                                      "megakernel"))
    ap.add_argument("--ctas", type=int, default=0)
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(args.src.resolve())]
    os.chdir(ROOT)
    import chip_smoke as cs
    from repro_torch.kernels import build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    build.build_all(["megakernel", "exit_update", "paged_gather"])
    {"prologue": prologue, "gather-boxes": gather_boxes,
     "megakernel": megakernel_times}[args.probe](args, build, cs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
