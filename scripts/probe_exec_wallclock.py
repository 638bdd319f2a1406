#!/usr/bin/env python3
"""How often the reference's wall-clock test fails under CPU load.

``tests/test_exec.py::test_cond_batch_skips_wallclock_and_flops`` checks
``t_cb <= t_sel * 1.25`` for two ~2 ms decode steps (ROADMAP Queue 3, F1).

``python3 scripts/probe_exec_wallclock.py [--runs 6] [--busy FILE ...]``
runs ``tests/test_exec.py`` whole, as a test worker runs it, ``--runs``
times while each ``--busy`` test file loops under pytest in a process of
its own (none: alone), and prints one JSON line: the busy files, the
number of failed runs and each failing assertion.  ``--ratio N`` instead
repeats the test's own timing N times in one process and prints each
``t_cb / t_sel``.  Runs from the root of a checkout, on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
PYTEST = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider"]


def ratios(n: int):
    """The test's timing (best of 3 x 20 steps per mode), n times."""
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_config, reduced
    from repro.core.exec import StagedExecutor
    from repro.models.model import build_model
    base = reduced(get_config("qwen2.5-3b"), n_layers=8, d_model=512,
                   d_ff=2048, n_heads=8, n_kv_heads=2).replace(
        dtype="float32").with_cascade(thresholds=(0.0, 0.0))
    params = build_model(base).init(jax.random.PRNGKey(0))
    toks = jnp.asarray(np.random.default_rng(1).integers(
        0, base.vocab_size, (2, 8)), jnp.int32)

    def timed(mode):
        cfg = base.with_cascade(exit_mode=mode)
        ex = StagedExecutor(build_model(cfg), cfg)
        step = jax.jit(ex.decode_step, donate_argnums=(2, 3))
        d, cache, state = ex.prefill(params, toks, ex.model.init_cache(2, 64))
        d, cache, state = step(params, d.prediction[:, None], cache, state)
        jax.block_until_ready(d.prediction)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(20):
                d, cache, state = step(params, d.prediction[:, None], cache,
                                       state)
            jax.block_until_ready(d.prediction)
            best = min(best, (time.perf_counter() - t0) / 20)
        return best

    return [timed("cond_batch") / timed("select") for _ in range(n)]


def runs_beside(busy, n: int):
    """Run tests/test_exec.py n times beside the looping busy files."""
    loops = [subprocess.Popen(
        ["bash", "-c", f"while true; do {' '.join(PYTEST)} {f} "
                       f"> /dev/null 2>&1; done"],
        cwd=ROOT, env=ENV, start_new_session=True) for f in busy]
    failed = []
    try:
        time.sleep(20 if busy else 0)
        for _ in range(n):
            p = subprocess.run(PYTEST + ["tests/test_exec.py"], cwd=ROOT,
                               env=ENV, capture_output=True, text=True)
            if p.returncode:
                m = re.search(r"E +(assert [0-9.]+ <= .*)", p.stdout)
                failed.append(m.group(1) if m else p.stdout[-300:])
    finally:
        for loop in loops:
            os.killpg(loop.pid, 15)
            loop.wait()
    return failed


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--busy", nargs="*", default=[])
    ap.add_argument("--ratio", type=int, default=0)
    args = ap.parse_args()
    if args.ratio:
        r = ratios(args.ratio)
        print(json.dumps({"ratios": r,
                          "above_1.25": sum(x > 1.25 for x in r)}))
        return 0
    failed = runs_beside(args.busy, args.runs)
    print(json.dumps({"busy": args.busy, "runs": args.runs,
                      "failed": len(failed), "assertions": failed}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
