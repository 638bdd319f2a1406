"""The per-stage answer-or-defer rule and its online agreement telemetry
(a copy of the JAX package's ``escalate/router.py``).

The defer decision is IDK-style (Wang et al., 2017): only the FINAL
component of a stage's intra-model cascade may abstain.  Tokens an
earlier component answered already beat their intra threshold — they
stand.  A token the final component answered is additionally gated by
the stage's escalation threshold: confidence below it defers the whole
request (from that token on) to the next stage.

The router also measures ``stage_agree`` — P(a rejected stage-s answer
equals the next stage's regeneration at the same context) — which is the
chaining factor :func:`repro_torch.autotune.solver.compose_escalation`
needs to express tier-level agreement through stage-0's self-agreement
proxy.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.configs.base import ModelConfig


class EscalationRouter:
    """Holds the live escalation thresholds (one per non-final stage) and
    the defer rule.  Thresholds are mutable data — the tier controller
    re-solves and pushes them the same way intra-model thresholds move."""

    def __init__(self, stage_cfgs: Sequence[ModelConfig]):
        if not stage_cfgs:
            raise ValueError("need at least one stage")
        self.stage_cfgs = list(stage_cfgs)
        for s, cfg in enumerate(self.stage_cfgs[:-1]):
            esc = cfg.escalation
            if esc.confidence and esc.confidence != cfg.cascade.confidence:
                # the defer decision reuses the confidence the decision
                # scan computed for the answering token; the engine does
                # not retain logits, so a different measure is unservable
                raise ValueError(
                    f"stage {s} escalation.confidence "
                    f"{esc.confidence!r} != its cascade.confidence "
                    f"{cfg.cascade.confidence!r}; the defer decision "
                    "reuses the decision-time confidence — leave it \"\" "
                    "to inherit")
        self.thresholds: List[float] = [
            float(cfg.escalation.threshold)
            for cfg in self.stage_cfgs[:-1]]
        # online stage-agreement telemetry: rejected stage-s token vs the
        # next stage's first regenerated token at the same context
        self._agree_n = 0
        self._agree_hits = 0

    # -- defer rule ------------------------------------------------------
    def set_threshold(self, stage: int, threshold: float):
        if not 0 <= stage < len(self.thresholds):
            raise IndexError(
                f"stage {stage} has no escalation threshold "
                f"({len(self.thresholds)} non-final stages)")
        self.thresholds[stage] = float(threshold)

    def should_defer(self, stage: int, exit_depth: int,
                     conf: float) -> bool:
        """Does this (answered) token abstain?  Only final-component
        answers may: 0.0 never defers (confidences are >= 0), the 1.1
        sentinel always defers final-component answers."""
        if stage >= len(self.thresholds):
            return False                   # last stage is the authority
        n_m = self.stage_cfgs[stage].cascade.n_components
        return (exit_depth == n_m - 1
                and float(conf) < self.thresholds[stage])

    def first_defer(self, stage: int, exit_depths: Sequence[int],
                    confs: Sequence[float], start: int = 0
                    ) -> Optional[int]:
        """Index of the first deferring token at/after ``start`` in a
        request's (exit_depth, conf) streams, or None."""
        for i in range(start, len(exit_depths)):
            if self.should_defer(stage, exit_depths[i], confs[i]):
                return i
        return None

    # -- stage-agreement telemetry ---------------------------------------
    def observe_regeneration(self, rejected_token: int,
                             regenerated_token: int):
        """One rejected token got re-answered by the next stage at the
        same context: record whether the draft had it right anyway."""
        self._agree_n += 1
        self._agree_hits += int(
            int(rejected_token) == int(regenerated_token))

    def stage_agree(self, prior: float = 1.0,
                    min_observations: int = 1) -> float:
        """Measured P(rejected draft answer == next stage's answer), or
        ``prior`` until ``min_observations`` rejections have been
        scored."""
        if self._agree_n < max(1, int(min_observations)):
            return float(prior)
        return self._agree_hits / self._agree_n

    def stats(self) -> dict:
        return {
            "thresholds": list(self.thresholds),
            "regenerations_scored": self._agree_n,
            "regenerations_agreed": self._agree_hits,
            "stage_agree": (self._agree_hits / self._agree_n
                            if self._agree_n else None),
        }
