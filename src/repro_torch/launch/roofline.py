"""Roofline analysis over the port's dry-run records, for H100 GPUs.

Terms (per step, per device):

    compute    = flops_per_device / PEAK_FLOPS
    memory     = bytes_accessed_per_device / HBM_BW
    collective = collective_wire_bytes_per_device / NVLINK_BW

The counterpart of the JAX package's ``launch/roofline.py``, whose
constants are TPU v5e figures; these are NVIDIA's H100 SXM5 data sheet
figures (H100 80GB HBM3, 700 W), dense, without sparsity.  A card set
below 700 W runs slower under load.  The production mesh's 16-wide axes
span two 8-GPU nodes, so part of every collective crosses the network
between nodes, which is slower than NVLink: the collective term is a lower
bound.  The inputs (``launch/dryrun.py``) are traced FLOPs over the mesh
size, the arguments read once plus the state written, and collective
bytes worked out from the layout: the table is a prediction from the data
sheet, not a measurement.  MODEL_FLOPS = 6·N_active·D (train) or
2·N_active·D (inference); MODEL/traced flags redundant compute (and, at
decode, the attention and exit-head work that 6ND-style accounting leaves
out).

    PYTHONPATH=src python -m repro_torch.launch.roofline \\
        --dir results/torch_dryrun [--suffix sp_serve1d]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, Optional

# H100 80GB HBM3, 700 W (SXM5 data sheet)
PEAK_FLOPS = 989e12        # bf16 dense FLOP/s
HBM_BW = 3.35e12           # HBM3 bytes/s
NVLINK_BW = 450e9          # NVLink 4 bytes/s, one way (900 GB/s both)
# H100 80GB HBM3, 700 W: float32 outside the tensor cores
PEAK_FLOPS_F32 = 67e12


def load_records(d: str, suffix: str, ok_only: bool = False) -> Dict:
    out = {}
    for path in sorted(glob.glob(os.path.join(d, f"*__{suffix}.json"))):
        with open(path) as f:
            rec = json.load(f)
        if ok_only and not rec.get("ok"):
            continue
        out[(rec["arch"], rec["shape"])] = rec
    return out


def terms(rec: dict) -> Optional[dict]:
    if not rec.get("ok") or "flops" not in rec:
        return None
    compute = rec["flops"] / PEAK_FLOPS
    memory = rec["bytes_accessed"] / HBM_BW
    coll_bytes = sum(rec["collective_bytes"].values())
    collective = coll_bytes / NVLINK_BW
    dom = max(("compute", compute), ("memory", memory),
              ("collective", collective), key=lambda kv: kv[1])
    devices = 512 if rec.get("mesh") == "2x16x16" else 256
    useful = (rec["model_flops"] / (rec["flops"] * devices) if rec["flops"]
              else 0)
    return {
        "compute_s": compute, "memory_s": memory, "collective_s": collective,
        "bottleneck": dom[0], "step_s": dom[1],
        "model_flops": rec["model_flops"],
        "useful_ratio": useful,
        "coll_bytes": coll_bytes,
    }


def fmt(x: float) -> str:
    if x == 0:
        return "0"
    for unit, scale in (("s", 1), ("ms", 1e-3), ("us", 1e-6), ("ns", 1e-9)):
        if x >= scale:
            return f"{x / scale:.3g}{unit}"
    return f"{x:.2g}s"


def table(recs: Dict) -> str:
    lines = ["| arch | shape | compute | memory | collective | bottleneck "
             "| MODEL/traced | note |",
             "|---|---|---|---|---|---|---|---|"]
    for (arch, shape), rec in sorted(recs.items()):
        if rec.get("skipped"):
            lines.append(f"| {arch} | {shape} | — | — | — | — | — | "
                         f"skipped: {rec['skipped'][:60]}… |")
            continue
        t = terms(rec)
        if t is None:
            lines.append(f"| {arch} | {shape} | — | — | — | — | — | "
                         f"FAILED: {rec.get('error', '?')[:60]} |")
            continue
        lines.append(
            f"| {arch} | {shape} | {fmt(t['compute_s'])} | "
            f"{fmt(t['memory_s'])} | {fmt(t['collective_s'])} | "
            f"**{t['bottleneck']}** | {t['useful_ratio']:.2f} | "
            f"{rec.get('param_mode', 'default')} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.roofline")
    ap.add_argument("--dir", default="results/torch_dryrun")
    ap.add_argument("--suffix", default="sp",
                    help="record suffix: sp | mp | sp_serve1d | ...")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    out = table(load_records(args.dir, args.suffix))
    print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")


if __name__ == "__main__":
    main()
