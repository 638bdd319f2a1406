"""Faithful reproduction on the PyTorch port: BT-train CI-RESNET(n)
on the synthetic difficulty-structured dataset, calibrate thresholds per
§5, and print the Table-2 style accuracy/speedup sweep.  The port of
``paper_reproduction.py``.

Usage: PYTHONPATH=src python examples/paper_reproduction_torch.py
           [--n-blocks 3] [--epochs 8] [--classes 10]
           [--out results/repro_torch.json] [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given; without a card and
without ``--device cpu`` it fails.
"""
import argparse
import json
import os

import numpy as np

from repro_torch.core import accuracy_vs_confidence
from repro_torch.core.resnet_trainer import (collect_outputs,
                                             evaluate_tradeoff,
                                             train_backtrack)
from repro_torch.data.synth_images import make_image_splits
from repro_torch.models.resnet import CIResNet
from repro_torch.utils import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-blocks", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--train-size", type=int, default=8192)
    ap.add_argument("--out", default="results/repro_torch.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch path on the CPU)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"paper_reproduction_torch: {err} (--device cpu)") \
            from err
    print(f"device={device}")

    train, val, test = make_image_splits(n_classes=args.classes,
                                         n_train=args.train_size)
    model = CIResNet(n_blocks=args.n_blocks, n_classes=args.classes,
                     device=device)
    report = train_backtrack(model, train, n_epochs=args.epochs, test=test)

    epsilons = [0.0, 0.01, 0.02, 0.04, 0.20]
    sweep = evaluate_tradeoff(model, report.params, report.state, val, test,
                              epsilons, args.classes)
    rows = []
    print(f"\ncomponent accuracies (M0, M01, M012): {report.component_acc}")
    print(f"{'eps':>6} {'acc':>8} {'speedup':>8} {'exit%':>20} thresholds")
    for eps, res in sweep:
        print(f"{eps:6.2f} {res.accuracy:8.4f} {res.speedup:8.3f} "
              f"{np.round(res.exit_fractions, 3)!s:>20} "
              f"{np.round(res.thresholds, 3)}")
        rows.append(dict(eps=eps, accuracy=float(res.accuracy),
                         speedup=float(res.speedup),
                         exit_fractions=res.exit_fractions.tolist(),
                         thresholds=[float(t) for t in res.thresholds]))
    # Fig-4 linearity check: correlation of alpha_m(delta) with delta
    conf_t, pred_t, corr_t = collect_outputs(model, report.params,
                                             report.state, test)
    linearity = []
    for m in range(3):
        grid, alpha = accuracy_vs_confidence(conf_t[m], corr_t[m])
        if len(grid) > 10:
            r = float(np.corrcoef(grid, alpha)[0, 1])
        else:
            r = float("nan")
        linearity.append(r)
    print("alpha_m(delta) linearity (pearson r):", np.round(linearity, 4))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(component_acc=report.component_acc, sweep=rows,
                       linearity=linearity, n_blocks=args.n_blocks,
                       epochs=args.epochs, classes=args.classes), f, indent=2)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
