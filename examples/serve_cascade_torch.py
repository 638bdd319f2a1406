"""Serving scenario on the PyTorch port: batched requests through the
cascade engine with depth-compacted lanes, reporting the exit-depth
histogram and the analytic MAC speedup (the paper's metric) at several
threshold settings.  The port of ``serve_cascade.py``.

    PYTHONPATH=src python examples/serve_cascade_torch.py \
        [--arch xlstm-350m] [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given; without a card and
without ``--device cpu`` it fails.
"""
import argparse

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.models import build_model
from repro_torch.serving import CascadeServingEngine, Request
from repro_torch.utils import resolve_device

THRESHOLDS = (1.1, 0.9, 0.5, 0.1, 0.0)


def sweep(base, model, params, device, requests, max_new):
    """Serve ``requests`` prompts of 8 tokens (``np.random.default_rng(0)``,
    drawn on through the sweep) at each threshold of :data:`THRESHOLDS`;
    prints a row per threshold and returns each engine's ``stats()``."""
    rng = np.random.default_rng(0)
    rows = []
    print(f"{'threshold':>10} {'speedup':>8} {'mean_exit':>10} histogram")
    for th in THRESHOLDS:
        cfg = base.with_cascade(thresholds=(th, 0.0), exit_mode="select")
        eng = CascadeServingEngine(cfg, model, params, lane_batch=2,
                                   n_lanes=2, cache_len=48, device=device)
        for i in range(requests):
            eng.submit(Request(
                rid=i, prompt=rng.integers(0, cfg.vocab_size, 8).astype(
                    np.int32),
                max_new_tokens=max_new))
        eng.run(400)
        st = eng.stats()
        print(f"{th:>10.2f} {st['analytic_speedup']:>8.3f} "
              f"{st['mean_exit_depth']!s:>10} {st['exit_histogram']}")
        rows.append(st)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch path on the CPU)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"serve_cascade_torch: {err} (--device cpu)") \
            from err

    base = reduced(get_config(args.arch)).replace(dtype="float32")
    print(f"device={device} arch={base.name}")
    model = build_model(base, device=device)
    params = model.init(0)
    sweep(base, model, params, device, args.requests, args.max_new)


if __name__ == "__main__":
    main()
