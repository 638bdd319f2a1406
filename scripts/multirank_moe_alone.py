#!/usr/bin/env python3
"""``chip_smoke.py``'s phase "multirank" part (e) alone, on the card: the
kernels built, four rank processes spawned, then the moe family served
over the mesh (:func:`chip_smoke._mr_moe`: the narrowed f32 parity meshes
and qwen3-moe-235b-a22b at 4 layers in bf16 on 1 x 2).

``python3 scripts/multirank_moe_alone.py`` from the root of a checkout;
needs one card.  Writes the whole record to ``build/multirank_moe.json``
and prints the card's name and power limit, the cell's headline numbers,
each parity mesh's seconds and collectives, and the part's laps.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.build_all()
    pool = cs._RankPool(4)
    try:
        t1 = time.perf_counter()
        out = cs._mr_moe(pool)
        secs = time.perf_counter() - t1
    finally:
        pool.close()
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "multirank_moe.json").write_text(json.dumps(
        {"nvidia_smi": smi, "moe": out, "seconds": secs}, default=str))
    c = out["cell"]
    print(json.dumps({k: c[k] for k in (
        "first_step_logits_rel_err", "token_agreement",
        "decode_us_per_token", "one_rank_decode_us_per_token",
        "collectives_per_step", "dryrun_collectives_per_step",
        "max_memory_allocated", "init_max_memory_allocated", "w_up_shard",
        "routing")}, default=str))
    print(json.dumps({k: {kk: v[kk] for kk in (
        "seconds", "one_rank_seconds", "w_up", "op_calls")}
        for k, v in out["parity"].items()}))
    print(json.dumps({"laps": out["laps"], "seconds": secs,
                      "total": time.perf_counter() - t0}))
