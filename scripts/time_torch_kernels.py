#!/usr/bin/env python3
"""Time some of the port's kernels on one GPU with ``chip_smoke.py``'s own
phase-2 checks, from any checkout of the repository.

``python3 scripts/time_torch_kernels.py [--root DIR] [--phases
rmsnorm,megakernel]`` builds the kernels of the checkout at ``DIR`` (this
one by default) into its own ``build/`` and runs that checkout's
``chip_smoke.phase_<name>`` for each phase: every kernel against its plain
version, then CUDA-event times of the kernel, the plain version and the
library call.  Prints the card line, then one JSON line per phase.  Run it
on two checkouts in turns (parent, change, change, parent) to compare two
versions of a kernel on one card.  ``--src DIR`` takes the port's package
from another checkout's ``src`` while the phases stay ``--root``'s: the
newer checks and shapes timed on an older kernel (one whose wrapper keeps
the same signature).  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--phases", default="rmsnorm,megakernel")
    ap.add_argument("--src", default=None,
                    help="the src directory to import repro_torch from "
                    "(default: ROOT/src)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_torch_kernels: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    src = Path(args.src).resolve() if args.src else root / "src"
    sys.path[:0] = [str(root), str(src)]
    import chip_smoke
    from repro_torch.kernels import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name in args.phases.split(","):
        cases = getattr(chip_smoke, f"phase_{name}")(torch.device("cuda"),
                                                    gen)
        print(json.dumps({"root": str(root), "src": str(src), "card": smi,
                          "kernel": name, "cases": cases}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
