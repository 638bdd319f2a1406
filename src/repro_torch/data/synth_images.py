"""Synthetic image classification data with *controllable per-sample difficulty*.

CIFAR-10/100/SVHN are not available offline (the data gate anticipated by the
repro band).  The paper's claims are about the *relationship* between
per-sample difficulty, intermediate-classifier confidence, and early-exit
savings — so the synthetic distribution must contain that structure:

* each class c has a smooth random template ``T_c`` (low-frequency pattern);
* a sample is ``difficulty``-interpolated between its class template and a
  mixture of a distractor class template plus pixel noise;
* difficulty is drawn per-sample from a Beta distribution, so the dataset has
  a long easy tail (early exits fire) and a hard head (cascade escalates).

This reproduces the paper's qualitative setting: most inputs are easy, some
are intrinsically hard, and "the required computational effort for
classification is an intrinsic yet hidden property of the images" (§1).
Images are 32x32x3, per-pixel standardized like the paper's input.

A numpy copy of the JAX package's ``data/synth_images.py``: the same seed
gives the same arrays bit for bit, augmentation included.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def _smooth_templates(rng: np.random.Generator, n_classes: int,
                      size: int = 32, channels: int = 3) -> np.ndarray:
    """Low-frequency class templates via random Fourier features."""
    yy, xx = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size),
                         indexing="ij")
    n_waves = 6
    out = np.zeros((n_classes, size, size, channels), np.float32)
    for c in range(n_classes):
        for ch in range(channels):
            acc = np.zeros((size, size), np.float32)
            for _ in range(n_waves):
                fx, fy = rng.uniform(0.5, 4.0, 2)
                phase = rng.uniform(0, 2 * np.pi)
                amp = rng.uniform(0.5, 1.0)
                acc += amp * np.sin(2 * np.pi * (fx * xx + fy * yy) + phase)
            out[c, :, :, ch] = acc
    # unit-normalize each template
    out /= (np.sqrt((out ** 2).mean(axis=(1, 2, 3), keepdims=True)) + 1e-6)
    return out


@dataclasses.dataclass
class SynthImageDataset:
    images: np.ndarray   # (N, 32, 32, 3) float32, standardized
    labels: np.ndarray   # (N,) int32
    difficulty: np.ndarray  # (N,) float32 in [0,1] — hidden ground truth

    def __len__(self):
        return len(self.labels)

    def batches(self, batch_size: int, rng: np.random.Generator,
                epochs: int = 1, augment: bool = False):
        """Shuffled minibatch iterator; optional paper-style augmentation
        (pad-4 + random crop + horizontal flip, as in [HZRS15a])."""
        n = len(self)
        for _ in range(epochs):
            order = rng.permutation(n)
            for i in range(0, n - batch_size + 1, batch_size):
                idx = order[i:i + batch_size]
                x = self.images[idx]
                if augment:
                    x = _augment(x, rng)
                yield x, self.labels[idx]


def _augment(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    b, h, w, c = x.shape
    pad = np.pad(x, ((0, 0), (4, 4), (4, 4), (0, 0)), mode="reflect")
    out = np.empty_like(x)
    offs = rng.integers(0, 9, size=(b, 2))
    flips = rng.random(b) < 0.5
    for i in range(b):
        oy, ox = offs[i]
        img = pad[i, oy:oy + h, ox:ox + w]
        if flips[i]:
            img = img[:, ::-1]
        out[i] = img
    return out


def make_image_splits(n_classes: int = 10, n_train: int = 8192,
                      n_val: int = 2048, n_test: int = 2048,
                      noise: float = 0.9, hard_frac_beta=(1.2, 2.5),
                      seed: int = 0) -> Tuple[SynthImageDataset, ...]:
    """Build (train, val, test) with shared class templates.

    ``noise`` scales the additive pixel noise at difficulty=1; the Beta
    parameters control the easy/hard mix (defaults give ~60% easy samples).
    """
    rng = np.random.default_rng(seed)
    templates = _smooth_templates(rng, n_classes)

    def make(n, split_seed):
        r = np.random.default_rng(split_seed)
        labels = r.integers(0, n_classes, n).astype(np.int32)
        difficulty = r.beta(*hard_frac_beta, size=n).astype(np.float32)
        distract = (labels + r.integers(1, n_classes, n)) % n_classes
        base = templates[labels]
        mix = templates[distract]
        d = difficulty[:, None, None, None]
        sig = (1 - 0.75 * d) * base + (0.75 * d) * mix
        x = sig + noise * d * r.standard_normal(base.shape).astype(np.float32)
        # per-pixel standardization (paper: "per-pixel-standardized RGB image")
        x = (x - x.mean(axis=(1, 2, 3), keepdims=True)) / (
            x.std(axis=(1, 2, 3), keepdims=True) + 1e-6)
        return SynthImageDataset(x.astype(np.float32), labels, difficulty)

    return (make(n_train, seed + 1), make(n_val, seed + 2),
            make(n_test, seed + 3))
