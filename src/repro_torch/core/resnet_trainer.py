"""End-to-end run of the paper's experiment: BT-train CI-RESNET(n)
(Algorithm 2), collect per-component confidences, calibrate thresholds
(§5), and evaluate the early-termination tradeoff (Algorithm 1 / Table 2 /
Fig. 3) — the counterpart of the JAX package's ``core/resnet_trainer.py``.

The paper's setup: SGD, cross-entropy + L2(1e-4), He init, [HZRS15a] LR
schedule, data augmentation for CIFAR; the dataset is the synthetic
difficulty-structured distribution of ``data/synth_images.py``.

Everything runs on the model's device (``CIResNet(..., device=...)``: CUDA
unless the caller asks for the CPU).  A backtrack phase computes gradients
only for the leaves it trains (the others' updates are masked to zero, as
in the reference, so skipping their backward changes no number).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cascade import CascadeEvalResult, sweep_epsilons
from repro_torch.core.macs import resnet_component_macs
from repro_torch.core.policy import get_measure
from repro_torch.core.training import (Phase, backtrack_training_plan,
                                       cross_entropy, l2_loss)
from repro_torch.data.synth_images import SynthImageDataset
from repro_torch.models.nn import tree_leaves, tree_map, tree_unflatten
from repro_torch.models.resnet import CIResNet
from repro_torch.optim import apply_updates, resnet_paper_schedule, \
    sgd_momentum
from repro_torch.utils import get_logger

log = get_logger("resnet_trainer")


@dataclasses.dataclass
class TrainReport:
    component_acc: List[float]          # test accuracy of each component
    phase_losses: Dict[str, List[float]]
    params: Dict
    state: Dict


def _mask_for_phase(params, phase: Phase):
    """CI-ResNet layout: backbone = stem + modules; heads = head0..head2
    (head2, the final classifier, trains with the backbone)."""
    def flag(name):
        if name.startswith("head"):
            idx = int(name[4:])
            if idx == 2:
                return phase.train_backbone
            return idx in phase.train_heads
        return phase.train_backbone
    return {name: tree_map(lambda _, f=flag(name): f, sub)
            for name, sub in params.items()}


def train_backtrack(model: CIResNet, train: SynthImageDataset,
                    n_epochs: int, batch_size: int = 128,
                    base_lr: float = 0.1, l2_coef: float = 1e-4,
                    augment: bool = True, seed: int = 0,
                    test: Optional[SynthImageDataset] = None,
                    init: Optional[Tuple[Dict, Dict]] = None) -> TrainReport:
    """Algorithm 2 BT(M, T, n_e).  ``init`` — a ``(params, state)`` pair,
    e.g. the reference's through ``bridge.resnet_params_from_jax`` — takes
    the place of ``model.init(seed)`` (it is copied, not written)."""
    dev = model.device
    if init is None:
        params, state = model.init(seed)
    else:
        params, state = (tree_map(lambda t: t.detach().clone().to(dev), t)
                         for t in init)
    plan = backtrack_training_plan(3)
    steps_per_epoch = len(train) // batch_size
    rng = np.random.default_rng(seed)
    phase_losses: Dict[str, List[float]] = {}
    leaves = list(tree_leaves(params))

    for phase in plan:
        epochs = max(1, int(round(phase.epochs * n_epochs)))
        total_steps = epochs * steps_per_epoch
        lr = resnet_paper_schedule(base_lr if phase.train_backbone
                                   else base_lr * 0.1, total_steps)
        opt = sgd_momentum(lr, momentum=0.9)
        opt_state = opt.init(params)
        mask = _mask_for_phase(params, phase)
        on = list(tree_leaves(mask))
        trained = [p for p, f in zip(leaves, on) if f]
        # the frozen leaves' gradients: zeros (their updates are masked)
        zeros = [None if f else torch.zeros_like(p)
                 for p, f in zip(leaves, on)]
        for p, f in zip(leaves, on):
            p.requires_grad_(f)
        head = phase.loss_head
        losses = []
        step = 0
        for x, y in train.batches(batch_size, rng, epochs=epochs,
                                  augment=augment):
            xt = torch.from_numpy(x).to(dev, non_blocking=True)
            yt = torch.from_numpy(y).to(dev, non_blocking=True)
            logits, state = model.apply(params, state, xt, train=True)
            loss = cross_entropy(logits[head], yt) + l2_loss(params, l2_coef)
            it = iter(torch.autograd.grad(loss, trained))
            grads = tree_unflatten(params, [next(it) if f else z
                                            for f, z in zip(on, zeros)])
            updates, opt_state = opt.update(grads, opt_state, params, step,
                                            mask=mask)
            apply_updates(params, updates)
            losses.append(loss.detach())
            step += 1
        losses = torch.stack(losses).tolist()
        phase_losses[phase.name] = losses
        log.info("phase %s: %d steps, loss %.4f -> %.4f", phase.name, step,
                 losses[0], np.mean(losses[-20:]))
    for p in leaves:
        p.requires_grad_(False)

    report = TrainReport([], phase_losses, params, state)
    if test is not None:
        conf, preds, _ = collect_outputs(model, params, state, test)
        report.component_acc = [float(np.mean(p == test.labels))
                                for p in preds]
        log.info("component accuracies: %s", report.component_acc)
    return report


@torch.no_grad()
def collect_logits(model: CIResNet, params, state,
                   data: SynthImageDataset,
                   batch_size: int = 256) -> List[np.ndarray]:
    """One forward pass over the dataset: per-component logits (N, C).

    Logits are measure-independent — collect them once, then score any
    number of confidence measures on them with :func:`score_logits`."""
    n_m = 3
    logits = [[] for _ in range(n_m)]
    for i in range(0, len(data), batch_size):
        x = torch.from_numpy(data.images[i:i + batch_size]).to(model.device)
        out, _ = model.apply(params, state, x, train=False)
        for m in range(n_m):
            logits[m].append(out[m])
    return [torch.cat(lg).cpu().numpy() for lg in logits]


@torch.no_grad()
def score_logits(logits: List[np.ndarray], labels: np.ndarray,
                 measure="softmax_max"):
    """(confidence, prediction, correct) per component from cached logits
    (host arrays, scored on the host).  ``measure`` is a confidence-measure
    registry spec (or instance)."""
    m_fn = get_measure(measure) if isinstance(measure, str) else measure
    confs, preds = [], []
    for lg in logits:
        out, delta = m_fn(torch.from_numpy(np.asarray(lg)))
        preds.append(out.numpy())
        confs.append(delta.numpy())
    corrects = [(p == labels).astype(np.float64) for p in preds]
    return confs, preds, corrects


def collect_outputs(model: CIResNet, params, state,
                    data: SynthImageDataset, batch_size: int = 256,
                    measure="softmax_max"):
    """Per-component (confidence, prediction, correct) over a dataset —
    one forward pass (:func:`collect_logits`) + one measure scoring
    (:func:`score_logits`)."""
    logits = collect_logits(model, params, state, data, batch_size)
    return score_logits(logits, data.labels, measure)


@torch.no_grad()
def evaluate_wallclock(model: CIResNet, params, state,
                       data: SynthImageDataset, thresholds,
                       measure="softmax_max", batch_size: int = 256,
                       repeats: int = 3):
    """MEASURED wall clock of staged cascade evaluation vs the dense
    cascade.

    Component m+1 runs only on the samples still undecided after component
    m (dynamic batching in fixed-shape chunks, padded to ``batch_size``),
    so the compute the thresholds save is real elapsed time, not analytic
    MACs.  The images and feature maps stay on the model's device; each
    component's confidences come to the host (the staged pass decides who
    stays there), which also makes the clock read after the device
    finished.  Both passes are warmed up before timing.

    Returns ``{"wallclock_speedup", "t_staged_s", "t_dense_s",
    "exit_fractions"}``.
    """
    m_fn = get_measure(measure) if isinstance(measure, str) else measure
    fns = model.component_fns(params, state)
    ths = tuple(float(t) for t in thresholds)
    images = torch.from_numpy(np.asarray(data.images)).to(model.device)

    def run_component(m, arr):
        """Apply component m chunkwise (padded to batch_size); returns
        (confidence (n,) on the host, features (n, ...) on the device)."""
        confs, feats = [], []
        for i in range(0, arr.shape[0], batch_size):
            chunk = arr[i:i + batch_size]
            real = chunk.shape[0]
            if real < batch_size:                 # pad to the fixed shape
                chunk = torch.cat([chunk, chunk[:1].expand(
                    (batch_size - real,) + chunk.shape[1:])])
            lg, feat = fns[m](chunk, chunk)
            confs.append(m_fn(lg)[1][:real])
            feats.append(feat[:real])
        return torch.cat(confs).cpu(), torch.cat(feats)

    def staged_pass():
        alive = images
        exited = []
        for m in range(3):
            if alive.shape[0] == 0:
                exited.append(0)
                continue
            conf, feat = run_component(m, alive)
            if m < 2:
                stay = conf < ths[m]
                exited.append(int(alive.shape[0] - stay.sum()))
                alive = feat[stay.to(feat.device)]
            else:
                exited.append(alive.shape[0])
        return exited

    def dense_pass():
        arr = images
        for m in range(3):
            _, arr = run_component(m, arr)

    staged_pass(), dense_pass()                  # warm-up
    t0 = time.perf_counter()
    for _ in range(repeats):
        exited = staged_pass()
    t_staged = (time.perf_counter() - t0) / repeats
    t0 = time.perf_counter()
    for _ in range(repeats):
        dense_pass()
    t_dense = (time.perf_counter() - t0) / repeats
    return {
        "wallclock_speedup": t_dense / t_staged if t_staged else 1.0,
        "t_staged_s": t_staged,
        "t_dense_s": t_dense,
        "exit_fractions": (np.asarray(exited, np.float64)
                           / max(1, len(data))).tolist(),
    }


def evaluate_tradeoff(model: CIResNet, params, state,
                      cal_data: SynthImageDataset,
                      test_data: SynthImageDataset,
                      epsilons, n_classes: int,
                      measure="softmax_max",
                      calibrator="self"
                      ) -> List[Tuple[float, CascadeEvalResult]]:
    """ε-sweep: calibrate on cal_data, evaluate on test_data (paper
    §5 / §6.2).  ``measure`` / ``calibrator`` are registry specs."""
    mac_prefix = resnet_component_macs(model.n, n_classes,
                                       enhance_dim=model.enhance_dim)
    conf_c, _, corr_c = collect_outputs(model, params, state, cal_data,
                                        measure=measure)
    conf_t, pred_t, _ = collect_outputs(model, params, state, test_data,
                                        measure=measure)
    sweep = sweep_epsilons(conf_c, corr_c, conf_t, pred_t, test_data.labels,
                           mac_prefix, epsilons, calibrator=calibrator)
    return [(eps, res) for eps, _cal, res in sweep]
