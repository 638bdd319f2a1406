"""Quickstart on the PyTorch port: build a cascade model, run a forward
pass, decode with confidence-thresholded early exit, and change thresholds
on the fly (Goal 1.2 — no retraining).  The port of ``quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py [--arch qwen2.5-3b]
        [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given; without a card and
without ``--device cpu`` it fails.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import ExitDecider, StagedExecutor, softmax_outputs
from repro_torch.models import build_model
from repro_torch.models.model import extra_input_shapes
from repro_torch.utils import resolve_device


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def run(cfg, model, params, device):
    """The four parts of the quickstart on ``model`` / ``params``; prints
    as it goes and returns what it printed, as numpy arrays, by part."""
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)).to(device)
    extra = {k: torch.zeros(s, dtype=torch.float32, device=device)
             for k, s in extra_input_shapes(cfg, 2).items()} or None
    out = {}

    # 1) full-sequence forward: one logits tensor per cascade exit
    with torch.no_grad():
        logits, aux = model.forward_train(params, toks, extra)
    out["forward_conf"] = []
    for m, lg in enumerate(logits):
        _, conf = softmax_outputs(lg[:, -1])
        out["forward_conf"].append(_np(conf))
        print(f"exit {m}: logits {tuple(lg.shape)}, last-pos confidence "
              f"{np.round(_np(conf), 3)}")

    # 2) prefill + a decode step with early exit, all through the one
    #    ExitDecider resolved from the config's registry strings
    decider = ExitDecider.from_config(cfg)
    cache = model.init_cache(2, 32)
    exit_logits, cache = model.prefill(params, toks, cache, extra)
    t = toks.shape[1]
    out["prefill"] = []
    for thresholds in [(0.9, 0.0), (0.0, 0.0)]:   # on-the-fly change
        d = decider.decide(exit_logits, thresholds=thresholds)
        tok = d.prediction
        out["prefill"].append((_np(tok), _np(d.exit_index)))
        print(f"thresholds={thresholds}: next tokens {_np(tok)}, exits "
              f"{_np(d.exit_index)}")
    step_logits, cache = model.decode_step(params, tok[:, None], t, cache,
                                           extra)
    d2 = decider.decide(step_logits, thresholds=(0.5, 0.0))
    out["decode"] = (_np(d2.prediction), _np(d2.exit_index))
    print(f"decode step at t={t}: tokens {_np(d2.prediction)}, exits "
          f"{_np(d2.exit_index)}")

    # 3) STAGED decode with a carried DecodeState: under
    #    exit_mode="cond_batch" segments nobody needs are actually skipped
    #    (watch segments_run), with identical outputs to "select"
    staged_cfg = cfg.with_cascade(exit_mode="cond_batch",
                                  thresholds=(0.0, 0.0))
    ex = StagedExecutor(model, staged_cfg)
    cache2 = model.init_cache(2, 32)
    d, cache2, state = ex.prefill(params, toks, cache2, extra=extra)
    for _ in range(3):
        d, cache2, state = ex.decode_step(params, d.prediction[:, None],
                                          cache2, state)
    run_ = _np(state.segments_run)
    out["staged"] = (_np(d.prediction), _np(d.exit_index), run_)
    print(f"staged decode: exits {_np(d.exit_index)}, segments actually "
          f"run {run_} (deep segment skipped {3 - int(run_[1])}/3 steps)")

    # 4) swap the confidence measure without touching the model: any
    #    registered measure (entropy, margin, patience@k, your own) plugs in
    out["measures"] = {}
    for measure in ("entropy", "margin"):
        alt = ExitDecider(measure, thresholds=(0.5, 0.0))
        d3 = alt.decide(exit_logits)
        out["measures"][measure] = (_np(d3.prediction), _np(d3.exit_index),
                                    _np(d3.confidence))
        print(f"measure={measure}: exits {_np(d3.exit_index)}, confidence "
              f"{np.round(_np(d3.confidence), 3)}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch path on the CPU)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"quickstart_torch: {err} (--device cpu)") from err

    cfg = reduced(get_config(args.arch))          # smoke-scale variant
    print(f"device={device} arch={cfg.name} family={cfg.family} "
          f"layers={cfg.n_layers} segments={cfg.segments}")
    model = build_model(cfg, device=device)
    params = model.init(0)
    run(cfg, model, params, device)


if __name__ == "__main__":
    main()
