"""End-to-end LLM example on the PyTorch port: train a (reduced) cascade LLM
on the synthetic Markov stream for a few hundred steps with the joint
multi-exit loss, then calibrate confidence thresholds per §5 on held-out
tokens and report the exit distribution + analytic decode speedup at each
ε.  The port of ``train_llm_cascade.py``.

This is the paper's full method transplanted onto an autoregressive LM:
difficulty structure in the stream (Markov vs noise positions) is what the
cascade exploits.

    PYTHONPATH=src python examples/train_llm_cascade_torch.py \
        --arch xlstm-350m --steps 300 [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given; without a card and
without ``--device cpu`` it fails.  The steps are functions (:func:`train`,
:func:`held_out`, :func:`calibrate_sweep`) that take their model, config,
stream and device from the caller.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import cascade_evaluate, get_calibrator, softmax_outputs
from repro_torch.core.macs import segment_macs_per_token
from repro_torch.data.lm_pipeline import SyntheticLMStream
from repro_torch.launch.steps import make_optimizer, make_train_step
from repro_torch.models import build_model
from repro_torch.models.nn import tree_leaves
from repro_torch.utils import get_logger, resolve_device

log = get_logger("train_llm_cascade")

RULES = ("self", "final")       # §5 vs beyond-paper cascade-level
EPSILONS = (0.0, 0.01, 0.05, 0.1, 0.2)


def train(model, cfg, params, stream, steps, device, log_every=50):
    """``steps`` joint-loss AdamW steps (``make_optimizer``,
    ``make_train_step``) of ``params`` on ``stream``'s batches, in place.
    Returns (params, losses, step_ms): each step's loss and its host
    wall time in ms, synced by reading the loss."""
    opt = make_optimizer(cfg)
    opt_state = opt.init(params)
    step_fn = make_train_step(model, cfg, opt)
    losses, step_ms = [], []
    for step, (toks, labels) in zip(range(steps), stream):
        batch = {"tokens": torch.from_numpy(toks).to(device),
                 "labels": torch.from_numpy(labels).to(device)}
        t0 = time.perf_counter()
        params, opt_state, loss = step_fn(params, opt_state, step, batch)
        losses.append(float(loss))
        step_ms.append(1e3 * (time.perf_counter() - t0))
        if step % log_every == 0:
            log.info("step %d loss %.4f", step, losses[-1])
    for p in tree_leaves(params):       # the step marks them for autograd
        p.requires_grad_(False)
    return params, losses, step_ms


@torch.no_grad()
def held_out(model, params, stream, device, batches=4):
    """Each exit's δ and prediction over ``batches`` held-out batches of
    ``stream``, flattened: (confs, preds, labels) as numpy, confs and
    preds one array per exit."""
    n_ex = model.n_exits
    confs, preds, labels_all = [[] for _ in range(n_ex)], \
        [[] for _ in range(n_ex)], []
    for _ in range(batches):
        toks, labels = next(stream)
        logits, _ = model.forward_train(params,
                                        torch.from_numpy(toks).to(device))
        for m in range(n_ex):
            out, delta = softmax_outputs(logits[m])
            confs[m].append(delta.cpu().numpy().reshape(-1))
            preds[m].append(out.cpu().numpy().reshape(-1))
        labels_all.append(labels.reshape(-1))
    return ([np.concatenate(c) for c in confs],
            [np.concatenate(p) for p in preds], np.concatenate(labels_all))


def calibrate_sweep(cfg, confs, preds, y, seq, rules=RULES,
                    epsilons=EPSILONS):
    """Calibrate (§5) on the first half of the held-out tokens and evaluate
    on the second, for each rule and ε; prints the example's table and
    returns its rows (rule, eps, thresholds, accuracy, speedup,
    exit_fractions) beside the per-exit accuracy."""
    corrects = [(p == y).astype(float) for p in preds]
    n_cal = len(y) // 2
    mac_prefix = segment_macs_per_token(cfg, kv_len=seq)
    per_exit = [float(np.mean(c)) for c in corrects]
    print(f"\nper-exit accuracy: {per_exit}")
    print(f"{'rule':>6} {'eps':>6} {'acc':>8} {'speedup':>8} "
          f"{'thresholds':>22} exit%")
    rows = []
    for rule in rules:
        calibrator = get_calibrator(rule)
        for eps in epsilons:
            cal = calibrator.calibrate([c[:n_cal] for c in confs],
                                       [c[:n_cal] for c in corrects], eps)
            res = cascade_evaluate([c[n_cal:] for c in confs],
                                   [p[n_cal:] for p in preds], y[n_cal:],
                                   mac_prefix, cal.thresholds)
            print(f"{rule:>6} {eps:6.2f} {res.accuracy:8.4f} "
                  f"{res.speedup:8.3f} "
                  f"{np.round(cal.thresholds, 3)!s:>22} "
                  f"{np.round(res.exit_fractions, 3)}")
            rows.append({"rule": rule, "eps": eps,
                         "thresholds": [float(t) for t in cal.thresholds],
                         "accuracy": float(res.accuracy),
                         "speedup": float(res.speedup),
                         "exit_fractions": [float(f) for f in
                                            res.exit_fractions]})
    return per_exit, rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch path on the CPU)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"train_llm_cascade_torch: {err} (--device cpu)") \
            from err

    cfg = reduced(get_config(args.arch)).replace(
        dtype="float32", vocab_size=args.vocab)
    print(f"device={device} arch={cfg.name} layers={cfg.n_layers} "
          f"vocab={cfg.vocab_size}")
    model = build_model(cfg, device=device)
    params = model.init(0)
    stream = SyntheticLMStream(cfg.vocab_size, args.seq, args.batch,
                               easy_frac=0.7, seed=0)
    params, _, _ = train(model, cfg, params, stream, args.steps, device)
    # --- calibration (§5) on held-out tokens, per exit -------------------
    confs, preds, y = held_out(model, params, stream, device)
    calibrate_sweep(cfg, confs, preds, y, args.seq)


if __name__ == "__main__":
    main()
