"""Cascaded Inference — Algorithm 1 of the paper, plus the evaluation
harness over precomputed confidences.

The counterpart of the JAX package's ``core/cascade.py``:

* :func:`cascade_infer_sequential` — Algorithm 1 CI(M, δ̂, x): run the
  components in order and answer at the first whose confidence clears its
  threshold, batch-uniformly (every sample of the batch must clear it).
  With a ``use_kernels`` decider each component's confidence comes from
  the fused confidence kernel.
* :func:`cascade_evaluate` — given per-component (confidence, prediction)
  arrays over a dataset and the per-component MAC prefix costs, the exit
  distribution, accuracy, average MACs and speedup for one threshold
  vector (the paper's analytic accounting, §6.2).

``sweep_epsilons`` (the Figure-3 sweep) needs the §5 calibrators and comes
with the calibration slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.policy import ExitDecider


@dataclasses.dataclass
class CascadeEvalResult:
    accuracy: float
    avg_macs: float
    speedup: float              # vs always running the full cascade
    exit_fractions: np.ndarray  # fraction of samples answered by component m
    thresholds: Tuple[float, ...]


def cascade_infer_sequential(component_fns: Sequence[Callable],
                             thresholds: Sequence[float], x,
                             decider: Optional[ExitDecider] = None):
    """Algorithm 1 CI(M, δ̂, x) for a single input (a batch is allowed; the
    stop condition then requires *all* sequences confident).

    ``component_fns[m](x, state) -> (logits, state)``: ``state`` carries
    the computation reused by the next component (the features so far),
    making the components nested prefixes.  The decision is the shared
    :class:`ExitDecider`'s (default: softmax_max under the threshold
    policy).  Returns (prediction, confidence)."""
    decider = decider or ExitDecider("softmax_max")
    logits_list = []
    state = None
    for fn in component_fns:
        logits, state = fn(x, state)
        logits_list.append(logits)
    decision = decider.decide(logits_list, thresholds=thresholds,
                              batch_uniform=True)
    return decision.prediction, decision.confidence


def cascade_evaluate(confidences: Sequence[np.ndarray],
                     predictions: Sequence[np.ndarray],
                     labels: np.ndarray,
                     mac_prefix: Sequence[float],
                     thresholds: Sequence[float],
                     decider: Optional[ExitDecider] = None
                     ) -> CascadeEvalResult:
    """Evaluate early termination for one threshold vector.

    confidences[m], predictions[m]: (N,) arrays for component m over the
    evaluation set; mac_prefix[m]: cumulative MACs of running components
    0..m.  The last threshold is forced to 0 (the final component always
    answers), whatever the caller passes."""
    n_m = len(confidences)
    N = len(labels)
    thresholds = tuple(float(t) for t in thresholds[:-1]) + (0.0,)
    decider = decider or ExitDecider("softmax_max")
    exit_idx = decider.exit_indices(confidences, thresholds)
    preds = np.stack(predictions, axis=0)[exit_idx, np.arange(N)]
    acc = float(np.mean(preds == labels))
    avg = float(np.mean(np.asarray(mac_prefix, np.float64)[exit_idx]))
    fractions = np.bincount(exit_idx, minlength=n_m) / N
    return CascadeEvalResult(
        accuracy=acc, avg_macs=avg,
        speedup=float(mac_prefix[-1] / avg),
        exit_fractions=fractions,
        thresholds=tuple(float(t) for t in thresholds))
