"""Automatic confidence-threshold calibration — §5 of the paper.

Given per-sample confidences δ_m(x) and correctness indicators for component
m over a calibration set T:

    T_m(δ)  = {(x,y) : δ_m(x) ≥ δ}
    α_m(δ)  = accuracy of M_m on T_m(δ)          (0 if T_m(δ) empty)
    α*_m    = max_δ α_m(δ)
    δ_m(ε)  = min { δ : α_m(δ) ≥ α*_m − ε }

The paper remarks the last component's threshold is 0, and that a validation
set (not the training set) should ideally set the thresholds — both supported
here.  Thresholds can be recomputed for any ε *without retraining* (Goal 1.2).

Implementation: sort by confidence descending; suffix-mean of correctness at
each distinct confidence gives α_m(δ) exactly at all breakpoints in O(N log N).

A copy of the JAX package's ``core/calibration.py`` (numpy only), pinned
to it by ``tests/test_torch_calibration.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class CalibrationResult:
    thresholds: Tuple[float, ...]   # δ̂_m per component (last = 0)
    alpha_star: Tuple[float, ...]   # α*_m per component
    epsilon: float


def accuracy_vs_confidence(conf: np.ndarray, correct: np.ndarray):
    """Exact α_m(δ) curve.

    Returns (delta_grid, alpha) where delta_grid are the distinct confidence
    values in increasing order and alpha[i] = accuracy over samples with
    confidence >= delta_grid[i].
    """
    conf = np.asarray(conf, np.float64)
    correct = np.asarray(correct, np.float64)
    order = np.argsort(conf)                  # ascending
    c_sorted = conf[order]
    r_sorted = correct[order]
    # suffix sums: accuracy among samples with conf >= c_sorted[i]
    suffix_correct = np.cumsum(r_sorted[::-1])[::-1]
    n = len(conf)
    counts = n - np.arange(n)
    alpha_at_i = suffix_correct / counts
    # collapse to distinct confidence values (keep first occurrence = full set
    # of samples with that confidence or more)
    distinct_mask = np.ones(n, bool)
    distinct_mask[1:] = c_sorted[1:] != c_sorted[:-1]
    return c_sorted[distinct_mask], alpha_at_i[distinct_mask]


def threshold_for_epsilon(conf: np.ndarray, correct: np.ndarray,
                          epsilon: float,
                          target: float | None = None,
                          val_conf: np.ndarray | None = None,
                          val_correct: np.ndarray | None = None
                          ) -> Tuple[float, float]:
    """δ_m(ε) = min{δ : α_m(δ) ≥ target − ε} and α*_m, per §5.

    target defaults to the component's own α*_m (the paper's rule).  When
    the target is unreachable at any δ, returns threshold 1.1 (never exit).

    ``val_conf`` / ``val_correct`` realize the paper's remark that a
    validation set distinct from the statistics set should ideally pick
    the threshold: α*_m (and the default target) still come from
    ``(conf, correct)``, but the threshold is the smallest δ whose
    accuracy ON THE VALIDATION CURVE clears the goal — so the selection
    cannot overfit the same samples that set the bar."""
    grid, alpha = accuracy_vs_confidence(conf, correct)
    alpha_star = float(np.max(alpha))
    goal = (alpha_star if target is None else target) - epsilon
    if val_conf is not None:
        if val_correct is None:
            raise ValueError("val_conf given without val_correct")
        grid, alpha = accuracy_vs_confidence(val_conf, val_correct)
    ok = alpha >= goal
    if not ok.any():
        return 1.1, alpha_star
    idx = int(np.argmax(ok))                  # first (lowest δ) satisfying
    return float(grid[idx]), alpha_star


def calibrate_thresholds(confidences: Sequence[np.ndarray],
                         corrects: Sequence[np.ndarray],
                         epsilon: float,
                         relative_to: str = "self",
                         val_confidences: Sequence[np.ndarray] | None = None,
                         val_corrects: Sequence[np.ndarray] | None = None
                         ) -> CalibrationResult:
    """Per-component thresholds for accuracy budget ε.

    confidences[m], corrects[m]: arrays over the calibration set for component
    m.  The final component's threshold is forced to 0 (paper's remark (i)).

    ``relative_to`` is a calibrator registry spec (repro_torch.core.policy):
      "self"    — the paper's §5 rule (SelfCalibrator).
      "final"   — beyond-paper cascade-level rule (FinalCalibrator).
      "holdout" — §5 with the threshold *selected* on a validation split
                  distinct from the statistics that set α*_m (the paper's
                  validation-set remark); splits internally unless
                  ``val_confidences`` / ``val_corrects`` are given.
    New rules register via ``@register_calibrator`` and become available here
    without touching this function.  Explicit ``val_confidences`` /
    ``val_corrects`` (per-component arrays like the calibration set) are
    honored by every calibrator.
    """
    from repro_torch.core.policy import get_calibrator  # circular-import guard
    cal = get_calibrator(relative_to)
    if val_confidences is None and val_corrects is None:
        # registered third-party calibrators may predate the validation-
        # split kwargs; don't force the wider signature on them
        return cal.calibrate(confidences, corrects, epsilon)
    return cal.calibrate(confidences, corrects, epsilon,
                         val_confidences=val_confidences,
                         val_corrects=val_corrects)
