#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s "paper" phase (CI-RESNET(18) backtrack-trained,
the ε-sweep, the staged wall clock, Algorithm 1) under other training
recipes, on one GPU.

``python3 scripts/paper_recipes.py --recipe 3,0.1 --recipe 6,0.01`` runs
the phase once per ``n_epochs,base_lr`` pair (the rest of the recipe and
the data as ``chip_smoke.PAPER_TRAIN`` / ``PAPER_SPLITS`` give them) and
prints the card line, then per recipe the phase's JSON line, or the check
that failed.  It is how the phase's recipe was chosen: the training
recipe of a deep CI-ResNet decides whether the phase's own checks (a
finite, falling loss; a monotone sweep) can hold.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--recipe", action="append", required=True,
                    help="n_epochs,base_lr (repeatable)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("paper_recipes: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.utils import resolve_device
    resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    build.build_all()
    for spec in args.recipe:
        n_e, lr = spec.split(",")
        chip_smoke.PAPER_TRAIN = {**chip_smoke.PAPER_TRAIN,
                                  "n_epochs": int(n_e),
                                  "base_lr": float(lr)}
        try:
            chip_smoke.phase_paper()
        except SystemExit as e:
            print(json.dumps({"recipe": chip_smoke.PAPER_TRAIN,
                              "failed": str(e)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
