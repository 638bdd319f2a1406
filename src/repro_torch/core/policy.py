"""Exit-policy layer: confidence measures and exit policies behind
registries, plus the single exit-decision engine (:class:`ExitDecider`).

The counterpart of the JAX package's ``core/policy.py``: the
``softmax_max`` measure (Def. 3.3) and ``patience@k`` over it, the
``threshold`` policy (Algorithm 1) and the ``budget`` policy (thresholds
fitted to an average-MAC budget by the autotune solver), the §5
calibrators ``self``, ``final`` and ``holdout``, the decider's component
scan (from logits, or from the hidden state through the exit-head
megakernel) with the autotune telemetry rider, its cohort slicing, and the
precomputed-confidence exit selection of the evaluation harness.  Config
strings (``cascade.confidence`` / ``cascade.policy`` /
``cascade.calibrator``) resolve through the registries exactly as there.
The entropy and margin measures come in a later slice of the port.

A threshold vector is a tuple of floats or, on the autotune
live-threshold path and in the staged executor, an ``(n_components,)``
f32 device tensor that the exit kernels read from device memory (so a
push never re-captures a CUDA graph).  Both gate ``conf >= δ̂`` in f32.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.calibration import (CalibrationResult,
                                          threshold_for_epsilon)
from repro_torch.core.confidence import softmax_outputs

# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------

_MEASURES: Dict[str, Callable[[str], "ConfidenceMeasure"]] = {}
_POLICIES: Dict[str, Callable[[str], "ExitPolicy"]] = {}
_CALIBRATORS: Dict[str, Callable[[str], "Calibrator"]] = {}
# registered in the reference, not ported yet
_LATER = {"entropy", "margin"}


def _register(table, name):
    def deco(factory):
        table[name] = factory
        return factory
    return deco


def register_measure(name: str):
    """Class decorator: register a ConfidenceMeasure under ``name``; the
    class is constructed as ``cls(argspec)``, ``argspec`` being the text
    after ``@`` in the config string."""
    return _register(_MEASURES, name)


def register_policy(name: str):
    return _register(_POLICIES, name)


def register_calibrator(name: str):
    return _register(_CALIBRATORS, name)


def _resolve(table, spec: str, kind: str):
    name, _, arg = spec.partition("@")
    if name not in table:
        if name in _LATER:
            raise NotImplementedError(
                f"{kind} {name!r} is not ported yet (a later slice of the "
                f"port); ported: {sorted(table)}")
        raise KeyError(f"unknown {kind} {name!r}; registered: "
                       f"{sorted(table)}")
    return table[name](arg)


def get_measure(spec: str) -> "ConfidenceMeasure":
    """``softmax_max`` | ``patience@k[:base]``"""
    return _resolve(_MEASURES, spec, "confidence measure")


def get_policy(spec: str) -> "ExitPolicy":
    """``threshold`` | ``budget@<avg-mac-target>``"""
    return _resolve(_POLICIES, spec, "exit policy")


def get_calibrator(spec: str) -> "Calibrator":
    """``self`` | ``final`` | ``holdout[@frac[:target]]``"""
    return _resolve(_CALIBRATORS, spec, "calibrator")


def available_measures() -> List[str]:
    return sorted(_MEASURES)


def available_policies() -> List[str]:
    return sorted(_POLICIES)


def available_calibrators() -> List[str]:
    return sorted(_CALIBRATORS)


# ---------------------------------------------------------------------------
# confidence measures
# ---------------------------------------------------------------------------

class ConfidenceMeasure:
    """logits (..., C) → (prediction (...,), confidence (...,) in (0, 1]).

    ``stateful`` measures additionally thread per-sequence decode state
    (laid out ``(n_exits, batch)``) through the decider."""

    name = "base"
    stateful = False
    patience_k = 1

    def __call__(self, logits: torch.Tensor):
        raise NotImplementedError

    def fused_kernel(self, logits: torch.Tensor):
        """The fused-kernel path for 2-D (B, V) logits, or None (no
        kernel).  Consulted only when the caller opted in
        (``use_kernels``); it computes what ``__call__`` does."""
        return None

    def init_state(self, n_exits: int, batch: int, device=None):
        return None


@register_measure("softmax_max")
class SoftmaxMaxMeasure(ConfidenceMeasure):
    """δ = max softmax (Defs. 3.2–3.3) — the paper's measure."""

    name = "softmax_max"

    def __init__(self, arg: str = ""):
        del arg

    def __call__(self, logits):
        return softmax_outputs(logits)

    def fused_kernel(self, logits):
        if logits.dim() != 2:
            return None
        from repro_torch.kernels.ops import softmax_confidence_fused
        return softmax_confidence_fused(logits)


@register_measure("patience")
class PatienceMeasure(ConfidenceMeasure):
    """PABEE-style patience: a sequence may exit at component m only after
    its base confidence has cleared the gate on k *consecutive* decode steps
    (the current one included).  Spec ``patience@k`` or
    ``patience@k:base`` (default base ``softmax_max``, k=2)."""

    name = "patience"
    stateful = True

    def __init__(self, arg: str = ""):
        k, _, base = arg.partition(":")
        self.patience_k = int(k) if k else 2
        if self.patience_k < 1:
            raise ValueError("patience k must be >= 1")
        self.base = get_measure(base or "softmax_max")

    def __call__(self, logits):
        return self.base(logits)

    def fused_kernel(self, logits):
        return self.base.fused_kernel(logits)

    def init_state(self, n_exits: int, batch: int, device=None):
        return torch.zeros((n_exits, batch), dtype=torch.int32,
                           device=device)


# ---------------------------------------------------------------------------
# exit policies
# ---------------------------------------------------------------------------

class ExitPolicy:
    """Per-component confidences → boolean exit gates; the final
    component's gate is always open.  ``component_gate`` is the gate for
    ONE component, called segment by segment as the executor computes (or
    skips) them."""

    name = "base"

    def resolve_thresholds(self, thresholds, explicit: bool = False):
        del explicit
        return thresholds

    def gates(self, confs: torch.Tensor, thresholds) -> torch.Tensor:
        """Per-component confidences (n_m, ...) -> exit gates (n_m, ...),
        the last row all open."""
        raise NotImplementedError

    def component_gate(self, conf: torch.Tensor, thresholds, m: int,
                       n_components: int) -> torch.Tensor:
        raise NotImplementedError(
            f"policy {self.name!r} defines no per-component gate")


@register_policy("threshold")
class ThresholdPolicy(ExitPolicy):
    """Algorithm 1 verbatim: exit at the first component with δ_m ≥ δ̂_m;
    the final component always answers."""

    name = "threshold"

    def __init__(self, arg: str = ""):
        del arg

    def gates(self, confs, thresholds):
        ths = torch.as_tensor(thresholds, dtype=confs.dtype,
                              device=confs.device)
        if ths.shape[0] != confs.shape[0]:
            raise ValueError(
                f"{ths.shape[0]} thresholds for {confs.shape[0]} cascade "
                f"components")
        open_ = confs >= ths.reshape((-1,) + (1,) * (confs.dim() - 1))
        open_[-1] = True
        return open_

    def component_gate(self, conf, thresholds, m, n_components):
        if m >= n_components - 1:
            return torch.ones(conf.shape, dtype=torch.bool,
                              device=conf.device)
        # the threshold is compared at the confidence's precision (f32): a
        # device vector's element, or a float rounded to f32
        if isinstance(thresholds, torch.Tensor):
            return conf >= thresholds[m]
        return conf >= float(np.float32(thresholds[m]))


# one-time deprecation notice for the shared-quantile fit
_SHARED_QUANTILE_WARNED = False


@register_policy("budget")
class BudgetPolicy(ThresholdPolicy):
    """Pick thresholds hitting a target *average* MAC budget per sample.

    Spec ``budget@<avg_macs>``: :meth:`fit` builds the joint confidence
    histogram from calibration confidences + correctness and runs the
    autotune solver (:func:`repro_torch.autotune.solver.solve_budget`),
    seeded from the shared-quantile solution, so it fits no worse.
    ``budget@<avg_macs>:shared`` is the deprecated legacy alias: it warns
    once and fits like the default spelling; only a :meth:`fit` WITHOUT
    ``corrects`` still runs the legacy shared-quantile bisection.  Resolve
    it, call :meth:`fit`, then decide or serve with it.
    """

    name = "budget"

    def __init__(self, arg: str = ""):
        spec, _, mode = arg.partition(":")
        self.mac_budget = float(spec) if spec else None
        if mode not in ("", "shared", "solver"):
            raise ValueError(
                f"budget policy mode must be 'shared' or 'solver', "
                f"got {mode!r}")
        self.mode = mode or "solver"
        self.thresholds: Optional[Tuple[float, ...]] = None

    def resolve_thresholds(self, thresholds, explicit: bool = False):
        if explicit and thresholds is not None:
            if self.thresholds is not None:
                warnings.warn(
                    "BudgetPolicy has fitted thresholds AND explicit "
                    "thresholds were passed per call; honoring the per-call "
                    "override (drop one of the two to silence this)",
                    stacklevel=3)
            return thresholds
        if self.thresholds is None:
            raise RuntimeError(
                "BudgetPolicy has no fitted thresholds: call "
                "decider.policy.fit(calibration_confidences, mac_prefix) "
                "after construction (a budget@ config string alone cannot "
                "fit — fitting needs held-out confidences)")
        return self.thresholds

    @staticmethod
    def _warn_shared():
        global _SHARED_QUANTILE_WARNED
        if _SHARED_QUANTILE_WARNED:
            return
        _SHARED_QUANTILE_WARNED = True
        warnings.warn(
            "BudgetPolicy's shared-quantile fit is deprecated: the "
            "per-component solver (repro_torch.autotune.solver.solve_budget)"
            " dominates it at equal budget.  Pass corrects= to fit() to "
            "use it, or spell budget@<macs>:shared to keep the legacy "
            "ablation behavior explicitly.",
            DeprecationWarning, stacklevel=4)

    def _fit_shared(self, conf, macs, budget, iters):
        """Legacy shared-quantile bisection; the gates compare in f32."""
        confs = torch.as_tensor(conf.astype(np.float32))

        def avg_macs(q):
            ths = np.quantile(conf, q, axis=1)
            ths[-1] = 0.0
            idx = _first_open_gate(
                ThresholdPolicy().gates(confs, ths)).numpy()
            return float(macs[idx].mean()), tuple(float(t) for t in ths)

        lo, hi = 0.0, 1.0                      # q=0: all exit first; macs min
        best = avg_macs(0.0)
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            got, ths = avg_macs(mid)
            if abs(got - budget) < abs(best[0] - budget):
                best = (got, ths)
            if got > budget:                   # too much compute: exit more
                hi = mid
            else:
                lo = mid
        return best[1], best[0]

    def fit(self, confidences: Sequence[np.ndarray],
            mac_prefix: Sequence[float],
            mac_budget: Optional[float] = None,
            corrects: Optional[Sequence[np.ndarray]] = None,
            iters: int = 40, bins: int = 64) -> Tuple[float, ...]:
        """Calibrate thresholds so mean MACs <= mac_budget on
        ``confidences``; with ``corrects`` the per-component solver
        allocates the budget, without them the legacy shared quantile
        runs (deprecated)."""
        budget = self.mac_budget if mac_budget is None else mac_budget
        if budget is None:
            raise ValueError("no MAC budget given (budget@<float> or fit())")
        conf = np.stack([np.asarray(c, np.float64) for c in confidences])
        macs = np.asarray(mac_prefix, np.float64)
        budget = float(np.clip(budget, macs[0], macs[-1]))

        if corrects is None:
            self._warn_shared()
            self.thresholds, self.fitted_avg_macs = self._fit_shared(
                conf, macs, budget, iters)
            return self.thresholds
        if self.mode == "shared":
            self._warn_shared()

        from repro_torch.autotune.solver import (ExitHistogram,
                                                 edges_from_thresholds,
                                                 solve_budget)
        corr = np.stack([np.asarray(c, np.float64) for c in corrects])
        hist = ExitHistogram.from_samples(conf, corr, macs, bins)
        shared_ths, _ = self._fit_shared(conf, macs, budget, iters)
        res = solve_budget(hist, budget,
                           init_edges=edges_from_thresholds(shared_ths,
                                                            bins))
        self.thresholds = res.thresholds
        self.fitted_avg_macs = res.avg_macs
        return self.thresholds


# ---------------------------------------------------------------------------
# calibrators (§5)
# ---------------------------------------------------------------------------

class Calibrator:
    """Per-component confidences + correctness → δ̂(ε) thresholds.

    ``val_confidences`` / ``val_corrects`` (optional, per-component arrays
    like the calibration set) are the paper's validation-set remark: α*_m
    (and the target) still come from the calibration arrays, but each
    threshold is *selected* on the validation accuracy curve.
    """

    name = "base"

    def calibrate(self, confidences: Sequence[np.ndarray],
                  corrects: Sequence[np.ndarray],
                  epsilon: float,
                  val_confidences: Optional[Sequence[np.ndarray]] = None,
                  val_corrects: Optional[Sequence[np.ndarray]] = None
                  ) -> CalibrationResult:
        raise NotImplementedError

    def _run(self, confidences, corrects, epsilon, target,
             val_confidences=None, val_corrects=None):
        n_m = len(confidences)
        ths, stars = [], []
        for m in range(n_m):
            t, a = threshold_for_epsilon(
                confidences[m], corrects[m], epsilon, target=target,
                val_conf=(None if val_confidences is None
                          else val_confidences[m]),
                val_correct=(None if val_corrects is None
                             else val_corrects[m]))
            ths.append(0.0 if m == n_m - 1 else t)
            stars.append(a)
        return CalibrationResult(tuple(ths), tuple(stars), epsilon)


@register_calibrator("self")
class SelfCalibrator(Calibrator):
    """The paper's §5 rule: δ_m(ε) targets the component's OWN α*_m − ε."""

    name = "self"

    def __init__(self, arg: str = ""):
        del arg

    def calibrate(self, confidences, corrects, epsilon,
                  val_confidences=None, val_corrects=None):
        return self._run(confidences, corrects, epsilon, target=None,
                         val_confidences=val_confidences,
                         val_corrects=val_corrects)


@register_calibrator("final")
class FinalCalibrator(Calibrator):
    """Cascade-level rule: every component targets the FINAL component's
    realized accuracy − ε (its accuracy at threshold 0, not its α*)."""

    name = "final"

    def __init__(self, arg: str = ""):
        del arg

    def calibrate(self, confidences, corrects, epsilon,
                  val_confidences=None, val_corrects=None):
        alpha_final = float(np.mean(corrects[-1]))
        return self._run(confidences, corrects, epsilon, target=alpha_final,
                         val_confidences=val_confidences,
                         val_corrects=val_corrects)


@register_calibrator("holdout")
class HoldoutCalibrator(Calibrator):
    """§5 with a validation split: α*_m from a statistics split, the
    threshold the smallest δ whose accuracy on a DISJOINT validation split
    clears α*_m − ε.  Spec ``holdout`` (validation fraction 0.5),
    ``holdout@0.3``, ``holdout@0.3:final`` (the cascade-level target).
    The internal split is deterministic and interleaved; explicit
    ``val_confidences`` / ``val_corrects`` skip it."""

    name = "holdout"

    def __init__(self, arg: str = ""):
        frac, _, target = arg.partition(":")
        self.val_frac = float(frac) if frac else 0.5
        if not 0.0 < self.val_frac < 1.0:
            raise ValueError(
                f"holdout fraction must be in (0, 1), got {self.val_frac}")
        if target not in ("", "self", "final"):
            raise ValueError(f"holdout target must be 'self' or 'final', "
                             f"got {target!r}")
        self.target_mode = target or "self"

    def _split(self, arrays):
        stats, vals = [], []
        for a in arrays:
            a = np.asarray(a)
            n = len(a)
            n_val = max(1, min(n - 1, int(round(n * self.val_frac))))
            idx = np.zeros(n, bool)
            idx[np.round(np.linspace(0, n - 1, n_val)).astype(int)] = True
            stats.append(a[~idx])
            vals.append(a[idx])
        return stats, vals

    def calibrate(self, confidences, corrects, epsilon,
                  val_confidences=None, val_corrects=None):
        if val_confidences is None:
            confidences, val_confidences = self._split(confidences)
            corrects, val_corrects = self._split(corrects)
        target = (float(np.mean(corrects[-1]))
                  if self.target_mode == "final" else None)
        return self._run(confidences, corrects, epsilon, target=target,
                         val_confidences=val_confidences,
                         val_corrects=val_corrects)


# ---------------------------------------------------------------------------
# the one decision engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ExitDecision:
    prediction: torch.Tensor    # (...,) int32 argmax of the answering head
    exit_index: torch.Tensor    # (...,) int32 component that answered
    confidence: torch.Tensor    # (...,) f32 its confidence
    state: Optional[torch.Tensor] = None   # stateful-measure carry


def _where(cond, a, b):
    return None if a is None else torch.where(cond, a, b)


def _set_row(x: torch.Tensor, m: int, row: torch.Tensor) -> torch.Tensor:
    """A copy of the component-major ``x`` with row ``m`` set to ``row``."""
    out = x.clone()
    out[m] = row
    return out


def _first_open_gate(gates: torch.Tensor) -> torch.Tensor:
    """THE exit-selection scan on stacked gates (n_m, ...) whose last row
    is all open: the index of the first open gate per sample."""
    return torch.argmax(gates.to(torch.int8), dim=0).to(torch.int32)


class ExitDecider:
    """The single exit-decision implementation: a measure composed with a
    policy.  :meth:`decide` takes all components' logits at once; the
    component scan (:meth:`scan_logits` / :meth:`should_skip` /
    :meth:`finish_scan`) takes them one at a time, which is what lets the
    staged executor skip the compute of segments nobody needs.  ``decide``
    is implemented ON the scan, including its skip-masked state updates,
    so ``select`` and ``cond_batch`` execution decide identically."""

    def __init__(self, measure, policy="threshold",
                 thresholds: Optional[Sequence[float]] = None,
                 use_kernels: bool = False, telemetry_bins: int = 0):
        self.measure = (get_measure(measure) if isinstance(measure, str)
                        else measure)
        self.policy = (get_policy(policy) if isinstance(policy, str)
                       else policy)
        self.thresholds = tuple(thresholds) if thresholds is not None else None
        self.use_kernels = use_kernels
        # > 0 enables the autotune telemetry rider: every scan also records
        # each component's packed raw prediction / confidence bin in the
        # carry's "tcode" rows (repro_torch.autotune.telemetry reads them);
        # 0 keeps the carry as it was without autotune
        self.telemetry_bins = int(telemetry_bins)

    @classmethod
    def from_config(cls, cfg) -> "ExitDecider":
        """Resolve a ModelConfig's cascade strings through the registries."""
        cas = cfg.cascade
        return cls(measure=cas.confidence, policy=cas.policy,
                   thresholds=cas.thresholds, use_kernels=cfg.use_kernels,
                   telemetry_bins=(cfg.autotune.bins
                                   if cfg.autotune.enabled else 0))

    @property
    def fused_scan(self) -> bool:
        """Whether :meth:`scan_logits` takes the fused exit-update kernel:
        kernels are on, the measure bottoms out in softmax-max (itself or
        ``patience@k`` over it) and the policy is the threshold one."""
        if not self.use_kernels:
            return False
        base = getattr(self.measure, "base", self.measure)
        if getattr(base, "name", "") != "softmax_max":
            return False
        if self.measure.stateful and self.measure.name != "patience":
            return False
        return isinstance(self.policy, ThresholdPolicy)

    def init_state(self, batch: int, n_exits: Optional[int] = None,
                   device=None):
        if n_exits is None:
            if self.thresholds is None:
                raise ValueError("n_exits needed when no thresholds are set")
            n_exits = len(self.thresholds)
        return self.measure.init_state(n_exits, batch, device)

    def resolved_thresholds(self, n_components: int,
                            thresholds: Optional[Sequence[float]] = None):
        """The threshold vector the scan gates on: per-call ``thresholds``
        > the policy's own > the decider's configured vector.  A tuple of
        floats, or — the live-threshold path, an ``(n_components,)`` f32
        tensor the kernels read from device memory — the tensor itself
        after a length check."""
        explicit = thresholds is not None
        if explicit and not isinstance(thresholds, torch.Tensor):
            thresholds = tuple(thresholds)
        ths = self.policy.resolve_thresholds(
            self.thresholds if thresholds is None else thresholds,
            explicit=explicit)
        if ths is None:
            raise ValueError(
                "no thresholds: configure them on the decider/config or "
                "pass them per call")
        if isinstance(ths, torch.Tensor):
            if ths.shape != (n_components,):
                raise ValueError(f"{tuple(ths.shape)} thresholds for "
                                 f"{n_components} cascade components")
            return ths
        ths = tuple(float(t) for t in ths)
        if len(ths) != n_components:
            raise ValueError(f"{len(ths)} thresholds for {n_components} "
                             f"cascade components")
        return ths

    # -- logits path ------------------------------------------------------
    def measure_one(self, logits: torch.Tensor):
        """(prediction, confidence) of ONE component: the measure's fused
        kernel when ``use_kernels`` and it has one, else the measure."""
        if self.use_kernels:
            pair = self.measure.fused_kernel(logits)
            if pair is not None:
                return pair
        return self.measure(logits)

    # -- the component scan ----------------------------------------------
    def _init_carry(self, m: int, n_components: int, prediction, confidence,
                    state):
        """THE decision-scan carry layout, shared by the dense
        (:meth:`scan_component`) and fused (:meth:`scan_logits`) paths."""
        if m != 0:
            raise ValueError("a decision scan must start at component 0")
        streak = None
        if self.measure.stateful:
            streak = (state if state is not None else torch.zeros(
                (n_components,) + tuple(confidence.shape), dtype=torch.int32,
                device=confidence.device))
        return {
            "answered": torch.zeros(confidence.shape, dtype=torch.bool,
                                    device=confidence.device),
            "pred": torch.zeros_like(prediction),
            "exit": torch.zeros(confidence.shape, dtype=torch.int32,
                                device=confidence.device),
            "conf": torch.zeros_like(confidence),
            "streak": streak,
            "ema": None,
            "act": None,
            # the telemetry rider: one packed code row per component; rows
            # of segments that skipped unobserved stay 0 (the accumulator
            # masks them with the exit index).  Never read by the decision
            "tcode": (torch.zeros((n_components,) + tuple(confidence.shape),
                                  dtype=torch.int32, device=confidence.device)
                      if self.telemetry_bins else None),
        }

    def scan_component(self, m: int, n_components: int,
                       prediction: torch.Tensor, confidence: torch.Tensor,
                       thresholds: Tuple[float, ...], carry=None,
                       state=None, batch_uniform: bool = False):
        """Feed component ``m``'s measured (prediction, confidence) into
        the running decision scan; returns the updated carry.  The first
        open gate answers each sample."""
        gate = self.policy.component_gate(confidence, thresholds, m,
                                          n_components)
        if carry is None:
            carry = self._init_carry(m, n_components, prediction, confidence,
                                     state)
        streak = carry["streak"]
        if self.measure.stateful:
            row = torch.where(gate, streak[m] + 1, torch.zeros_like(streak[m]))
            streak = streak.clone()
            streak[m] = row
            gate = row >= self.measure.patience_k
            if m == n_components - 1:
                gate = torch.ones_like(gate)
        if batch_uniform:
            gate = torch.all(gate).expand(gate.shape)
            if m == n_components - 1:
                gate = torch.ones_like(gate)
        fresh = gate & ~carry["answered"]
        tcode = None
        if carry.get("tcode") is not None:
            from repro_torch.autotune.telemetry import pack_rider
            tcode = _set_row(carry["tcode"], m, pack_rider(
                prediction, confidence, self.telemetry_bins))
        return {
            "answered": carry["answered"] | gate,
            "pred": torch.where(fresh, prediction.to(carry["pred"].dtype),
                                carry["pred"]),
            "exit": torch.where(fresh, torch.full_like(carry["exit"], m),
                                carry["exit"]),
            "conf": torch.where(fresh, confidence, carry["conf"]),
            "streak": streak,
            "ema": carry.get("ema"),
            "act": carry.get("act"),
            "tcode": tcode,
        }

    def fold_ema(self, carry, decay: float):
        """Fold the final decision confidence into the carry's "ema" rider
        — a no-op when the caller didn't seed one."""
        if carry.get("ema") is None:
            return carry
        new = dict(carry)
        ema = decay * carry["ema"] + (1.0 - decay) * carry["conf"]
        new["ema"] = (torch.where(carry["act"], ema, carry["ema"])
                      if carry.get("act") is not None else ema)
        return new

    def scan_logits(self, m: int, n_components: int, logits: torch.Tensor,
                    thresholds: Tuple[float, ...], carry=None, state=None,
                    batch_uniform: bool = False, ema_decay: float = 0.0):
        """Measure component ``m``'s logits AND fold them into the scan in
        one call.  With :attr:`fused_scan` this is the fused exit-update
        kernel (one streaming pass over the (B, V) logits); otherwise
        :meth:`measure_one` + :meth:`scan_component` (+ :meth:`fold_ema`)
        — the same semantics either way."""
        fused = self.fused_scan and not batch_uniform and logits.dim() == 2
        if not fused:
            out, conf = self.measure_one(logits)
            carry = self.scan_component(m, n_components, out, conf,
                                        thresholds, carry, state=state,
                                        batch_uniform=batch_uniform)
            return self.fold_ema(carry, ema_decay) if ema_decay else carry
        from repro_torch.kernels.ops import exit_update_fused
        carry, srow, ema, act = self._fused_carry_in(
            m, n_components, logits.shape[0], logits.device, carry, state)
        outs = exit_update_fused(
            logits, carry["answered"], carry["pred"], carry["exit"],
            carry["conf"], srow, ema, act, **self._fused_kw(
                m, n_components, thresholds, carry, ema_decay))
        return self._fused_carry_out(m, carry, outs)

    def scan_hidden(self, m: int, n_components: int, h: torch.Tensor,
                    norm_w: torch.Tensor, head: torch.Tensor, thresholds,
                    carry=None, state=None, ema_decay: float = 0.0,
                    live=None, eps: float = 1e-5):
        """:meth:`scan_logits` from the segment's HIDDEN state ``h`` (B, d):
        the exit-head megakernel route (rmsnorm + head product + streaming
        confidence + exit-update merge; the (B, V) logits never stored).
        ``norm_w`` / ``head`` come from
        :meth:`~repro_torch.models.model.CascadeModel.exit_head_params`.
        ``live`` is the per-slot exit mask: dead rows pass every carry
        through unchanged.  Requires :attr:`fused_scan`."""
        if not self.fused_scan:
            raise ValueError("scan_hidden requires a fused-scan decider "
                             "(use exit_logits + scan_logits instead)")
        from repro_torch.kernels.ops import exit_head_fused
        carry, srow, ema, act = self._fused_carry_in(
            m, n_components, h.shape[0], h.device, carry, state)
        outs = exit_head_fused(
            h, norm_w, head, carry["answered"], carry["pred"], carry["exit"],
            carry["conf"], srow, ema, act, live=live, eps=eps,
            **self._fused_kw(m, n_components, thresholds, carry, ema_decay))
        return self._fused_carry_out(m, carry, outs)

    def _fused_carry_in(self, m, n_components, B, dev, carry, state):
        """The fused kernels' view of the scan carry: (carry, streak row m,
        EMA rider, active rider), zeros / ones where the carry has none."""
        if carry is None:
            carry = self._init_carry(
                m, n_components, torch.zeros(B, dtype=torch.int32, device=dev),
                torch.zeros(B, dtype=torch.float32, device=dev), state)
        streak = carry["streak"]
        srow = (streak[m] if streak is not None
                else torch.zeros(B, dtype=torch.int32, device=dev))
        ema = (carry["ema"] if carry.get("ema") is not None
               else torch.zeros(B, dtype=torch.float32, device=dev))
        act = (carry["act"] if carry.get("act") is not None
               else torch.ones(B, dtype=torch.bool, device=dev))
        return carry, srow, ema, act

    def _fused_kw(self, m, n_components, thresholds, carry, ema_decay):
        # a device vector goes to the kernel whole (it reads element m
        # from device memory); a float vector gives its element m
        return dict(threshold=(thresholds if isinstance(thresholds,
                                                        torch.Tensor)
                               else float(thresholds[m])),
                    m=m, n_components=n_components,
                    patience_k=(self.measure.patience_k
                                if self.measure.stateful else 0),
                    ema_decay=(float(ema_decay)
                               if carry.get("ema") is not None else 0.0),
                    tel_bins=(self.telemetry_bins
                              if carry.get("tcode") is not None else 0))

    @staticmethod
    def _fused_carry_out(m, carry, outs):
        ans, pred, exi, conf, srow_n, ema_n = outs[:6]
        streak = carry["streak"]
        if streak is not None:
            streak = _set_row(streak, m, srow_n)
        return {"answered": ans, "pred": pred, "exit": exi, "conf": conf,
                "streak": streak,
                "ema": ema_n if carry.get("ema") is not None else None,
                "act": carry.get("act"),
                "tcode": (None if carry.get("tcode") is None
                          else _set_row(carry["tcode"], m, outs[6]))}

    # carry keys laid out (n_components, batch): slice/concat axis 1
    _COMPONENT_MAJOR_KEYS = frozenset(("streak", "tcode"))
    # telemetry rows: they land whatever the skip predicate says
    _TELEMETRY_KEYS = frozenset(("tcode",))

    def slice_carry(self, carry, lo: int, hi: int):
        """Batch-slice a decision-scan carry (cohort-split execution):
        per-sample leaves are batch-leading; the stateful-measure
        ``streak`` is (n_exits, batch) and slices axis 1.  Views, no
        copies."""
        return {k: (v if v is None
                    else (v[:, lo:hi] if k in self._COMPONENT_MAJOR_KEYS
                          else v[lo:hi]))
                for k, v in carry.items()}

    def concat_carry(self, parts):
        """Inverse of :meth:`slice_carry`: rejoin per-cohort carries."""
        return {k: (None if parts[0][k] is None
                    else torch.cat([p[k] for p in parts],
                                   dim=1 if k in self._COMPONENT_MAJOR_KEYS
                                   else 0))
                for k in parts[0]}

    def should_skip(self, carry, active=None) -> torch.Tensor:
        """0-dim bool: every live sample has already exited — the staged
        executor's segment-skip predicate, and decide()'s masked-update
        predicate."""
        answered = carry["answered"]
        if active is not None:
            answered = answered | ~active
        return torch.all(answered)

    def finish_scan(self, carry) -> ExitDecision:
        return ExitDecision(carry["pred"], carry["exit"], carry["conf"],
                            carry["streak"])

    def decide_with_carry(self, logits_list: Sequence[torch.Tensor],
                          thresholds: Optional[Sequence[float]] = None,
                          state=None, batch_uniform: bool = False,
                          active=None):
        """:meth:`decide`, additionally returning the finished carry."""
        n_m = len(logits_list)
        ths = self.resolved_thresholds(n_m, thresholds)
        carry = None
        for m, lg in enumerate(logits_list):
            new = self.scan_logits(m, n_m, lg, ths, carry, state=state,
                                   batch_uniform=batch_uniform)
            if carry is None:
                carry = new
            else:
                # components a staged run would have skipped leave the
                # decision and its state untouched; the telemetry rider
                # rows always land (the logits were computed here anyway)
                skip = self.should_skip(carry, active)
                carry = {k: (v if k in self._TELEMETRY_KEYS
                             else _where(skip, carry[k], v))
                         for k, v in new.items()}
        return self.finish_scan(carry), carry

    def decide(self, logits_list: Sequence[torch.Tensor],
               thresholds: Optional[Sequence[float]] = None,
               state=None, batch_uniform: bool = False,
               active=None) -> ExitDecision:
        """Pick the answering component for each sample (see
        :meth:`decide_with_carry`)."""
        return self.decide_with_carry(logits_list, thresholds, state=state,
                                      batch_uniform=batch_uniform,
                                      active=active)[0]

    # -- precomputed-confidence path (evaluation sweep) ------------------
    def exit_indices(self, confidences, thresholds=None) -> np.ndarray:
        """Exit component per sample from precomputed confidences (n_m, N).
        The comparison is in float32, the precision the reference's
        ``jnp.asarray`` gives them.  Stateful measures (patience) depend on
        decode order and have no precomputed-confidence equivalent."""
        if self.measure.stateful:
            raise NotImplementedError(
                f"measure {self.measure.name!r} is stateful; exit_indices "
                "cannot reproduce its decode-time gating — drive decide() "
                "instead")
        confs = torch.as_tensor(np.stack([np.asarray(c, np.float32)
                                          for c in confidences]))
        ths = self.policy.resolve_thresholds(
            self.thresholds if thresholds is None else tuple(thresholds),
            explicit=thresholds is not None)
        return _first_open_gate(self.policy.gates(confs, ths)).numpy()
