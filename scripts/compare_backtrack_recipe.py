#!/usr/bin/env python3
"""Run the reference's and the port's backtrack training (Algorithm 2) side
by side on the CPU at one recipe, and compare their phase losses step by
step.

``PYTHONPATH=src python scripts/compare_backtrack_recipe.py`` trains
CI-RESNET(18) (n = 18, enhance_dim 128, 10 classes) on the synthetic
images of ``chip_smoke.PAPER_SPLITS`` (4096 training images, seed 11) at
n_e = 3 and a base LR of 0.1, batch 128, no augmentation, seed 0: the
recipe whose accuracies stayed near chance on the card.  The JAX
package's ``train_backtrack`` draws the initial weights; the port's
starts from the same weights through ``bridge.resnet_params_from_jax``.
Each phase runs its first ``--steps`` steps (default 40 of the first
phase's 128 and each head phase's 96; the learning-rate schedule is the
full recipe's), both packages on the same batches (~10 minutes of CPU).

f32 noise is measured, not assumed: the port runs a second time from the
same weights with each one moved by one f32 ulp (a random sign a
weight), and that run's gap to the port's first is the noise floor a
step's gap to the reference is read against.  Prints one JSON line per
phase: the three loss curves, the relative gaps per step (reference
against port, port against its perturbed run), the first step whose gap
passes ``--part`` (1e-3 by default) in each, and the loss at the first
and last steps; then one summary line.  If the reference and the port
part no earlier and no further than the noise floor, and the loss does
not fall in either, the recipe is at fault and not the port.  ``--n``
and ``--n-train`` shrink the run for a quick look.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]
os.environ.setdefault("JAX_PLATFORMS", "cpu")


class FirstSteps:
    """A training split whose ``batches`` stop after ``steps`` batches of
    each call (each phase makes one call), while ``len`` stays the
    split's own, so each phase's learning-rate schedule is the full
    recipe's."""

    def __init__(self, data, steps: int):
        self.data, self.steps = data, steps

    def __len__(self):
        return len(self.data)

    def batches(self, *args, **kw):
        return itertools.islice(self.data.batches(*args, **kw), self.steps)


def nudged(tree, gen):
    """``tree`` (nested dicts and lists of f32 tensors) with each element
    moved by one ulp, up or down at random."""
    import torch
    if isinstance(tree, dict):
        return {k: nudged(v, gen) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(nudged(v, gen) for v in tree)
    if not tree.is_floating_point():
        return tree.clone()
    sign = torch.randint(0, 2, tree.shape, generator=gen) * 2 - 1
    return torch.where(sign > 0, torch.nextafter(tree, tree + 1),
                       torch.nextafter(tree, tree - 1))


def first_over(gap, part):
    over = [i for i, g in enumerate(gap) if g > part]
    return over[0] if over else None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=18)
    ap.add_argument("--n-epochs", type=int, default=3)
    ap.add_argument("--base-lr", type=float, default=0.1)
    ap.add_argument("--n-train", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=40,
                    help="steps of each phase to run")
    ap.add_argument("--part", type=float, default=1e-3,
                    help="relative loss gap counted as parting")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()

    import jax
    import numpy as np
    import torch

    torch.set_num_threads(args.threads)
    from repro.core import resnet_trainer as jtrainer
    from repro.data.synth_images import make_image_splits as jax_splits
    from repro.models.resnet import CIResNet as JaxResNet
    from repro_torch.bridge import resnet_params_from_jax
    from repro_torch.core import resnet_trainer as trainer
    from repro_torch.data.synth_images import make_image_splits
    from repro_torch.models.resnet import CIResNet

    splits = dict(n_classes=10, n_train=args.n_train, n_val=8, n_test=8,
                  seed=11)
    recipe = dict(n_epochs=args.n_epochs, batch_size=128, augment=False,
                  base_lr=args.base_lr, seed=0)
    jtrain = jax_splits(**splits)[0]
    ttrain = make_image_splits(**splits)[0]
    if not (np.array_equal(jtrain.images, ttrain.images)
            and np.array_equal(jtrain.labels, ttrain.labels)):
        print("the two packages' synthetic images differ", file=sys.stderr)
        return 1
    enh = 128
    jm = JaxResNet(args.n, 10, enh)
    t0 = time.perf_counter()
    want = jtrainer.train_backtrack(jm, FirstSteps(jtrain, args.steps),
                                    **recipe)
    jax_s = time.perf_counter() - t0
    jp, js = jm.init(jax.random.PRNGKey(recipe["seed"]))
    init = resnet_params_from_jax(
        *(jax.tree_util.tree_map(np.asarray, t) for t in (jp, js)),
        device="cpu")
    t0 = time.perf_counter()
    got = trainer.train_backtrack(CIResNet(args.n, 10, enh, device="cpu"),
                                  FirstSteps(ttrain, args.steps), init=init,
                                  **recipe)
    torch_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(1)
    noise = trainer.train_backtrack(
        CIResNet(args.n, 10, enh, device="cpu"),
        FirstSteps(ttrain, args.steps),
        init=tuple(nudged(t, gen) for t in init), **recipe)

    parted, floor = {}, {}
    for name, ref_losses in want.phase_losses.items():
        a, b, c = (np.asarray(x, np.float64) for x in (
            ref_losses, got.phase_losses[name], noise.phase_losses[name]))
        gap = (np.abs(a - b) / np.abs(a)).tolist()
        noise_gap = (np.abs(b - c) / np.abs(b)).tolist()
        parted[name] = first_over(gap, args.part)
        floor[name] = first_over(noise_gap, args.part)
        print(json.dumps({
            "phase": name, "steps": len(a), "first_part_step": parted[name],
            "noise_first_part_step": floor[name],
            "max_rel_gap": max(gap), "noise_max_rel_gap": max(noise_gap),
            "loss_first": [a[0], b[0]], "loss_last": [a[-1], b[-1]],
            "mean_last_10": [float(a[-10:].mean()), float(b[-10:].mean()),
                             float(c[-10:].mean())],
            "reference": a.tolist(), "port": b.tolist(),
            "port_nudged": c.tolist(), "rel_gap": gap,
            "noise_rel_gap": noise_gap}), flush=True)
    print(json.dumps({"recipe": recipe, "n": args.n, "splits": splits,
                      "steps_per_phase": args.steps, "part": args.part,
                      "first_part_step": parted,
                      "noise_first_part_step": floor,
                      "reference_seconds": jax_s,
                      "port_seconds": torch_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
