"""The live re-tuning loop: telemetry in, thresholds out.

The counterpart of the JAX package's ``autotune/controller.py``.
:class:`ThresholdController` closes the loop: every
``autotune.resolve_every`` engine ticks it merges the lanes' device
telemetry (ONE device -> host copy for all lanes, at the resolve tick
only: telemetry never adds a per-chunk host sync), builds the joint
histogram, runs the coordinate-descent solver in the configured direction
(accuracy budget ε or average-MAC budget) and pushes the resolved
thresholds into the running engine.  A lane's thresholds are an f32 device
tensor the exit kernels read from device memory, so a push is a write into
it: no captured CUDA graph is re-captured and no kernel rebuilt.

Three guards keep a live fleet stable:

* **min-sample** — no resolve until ``min_shadow`` shadow observations
  have accumulated since the last one (thresholds from thin evidence
  oscillate);
* **hysteresis** — a solve whose thresholds moved less than
  ``hysteresis`` from the deployed vector is recorded but not pushed
  (churn costs scheduler warm-up, buys nothing);
* **drift** — the controller compares consecutive resolve windows'
  normalized shadow histograms; when the L1 distance exceeds
  ``drift_tol`` the traffic has shifted and the accumulated history no
  longer describes it, so the solve uses the fresh window only.

With ``artifact_dir`` set, each pushed resolution is persisted as a
config-hash-keyed artifact (:mod:`repro_torch.autotune.artifacts`) and the
constructor warm-starts from a matching artifact if one exists.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.autotune.artifacts import (CalibrationArtifact, config_key,
                                            load_artifact, save_artifact)
from repro_torch.autotune.solver import (ExitHistogram, solve_budget,
                                         solve_epsilon)
from repro_torch.autotune.telemetry import merge_telemetry
from repro_torch.utils import get_logger

log = get_logger("autotune")


class ThresholdController:
    """Periodic telemetry → solver → threshold-push loop for one engine.

    Built either directly or via ``CascadeServingEngine(autotune=True)``;
    defaults come from ``cfg.autotune``.  ``mac_budget > 0`` selects the
    budget direction, else the ε direction.  The engine calls
    :meth:`maybe_update` once per tick; everything else is internal.

    The "engine" the controller drives only needs the three-method surface
    ``lane_telemetry()`` / ``current_thresholds()`` / ``push_thresholds()``
    (``source`` marks the artifacts it writes).
    """

    # artifact provenance tag
    source = "engine"

    def __init__(self, cfg, mac_prefix, *, epsilon: Optional[float] = None,
                 mac_budget: Optional[float] = None,
                 resolve_every: Optional[int] = None,
                 min_shadow: Optional[int] = None,
                 hysteresis: Optional[float] = None,
                 drift_tol: Optional[float] = None,
                 artifact_dir: Optional[str] = None):
        at = cfg.autotune
        self.cfg = cfg
        self.mac_prefix = tuple(float(m) for m in mac_prefix)
        self.epsilon = at.epsilon if epsilon is None else float(epsilon)
        self.mac_budget = (at.mac_budget if mac_budget is None
                           else float(mac_budget))
        self.resolve_every = (at.resolve_every if resolve_every is None
                              else int(resolve_every))
        self.min_shadow = at.min_shadow if min_shadow is None else min_shadow
        self.hysteresis = (at.hysteresis if hysteresis is None
                           else float(hysteresis))
        self.drift_tol = at.drift_tol if drift_tol is None else drift_tol
        self.artifact_dir = artifact_dir
        self._tick = 0
        self._snapshot = None          # cumulative host telemetry @ last solve
        self._prev_window_conf = None  # normalized conf_hist of last window
        self._drift_base = None        # counters excluded from every solve
                                       # (cumulative @ the last drift reset)
        self.resolves = 0
        self.pushes = 0
        self.skipped_small = 0
        self.drift_resets = 0
        self.last_result = None
        self.last_shadow = 0.0         # shadow evidence behind the last push
        self.thresholds: Optional[Tuple[float, ...]] = None
        self.warm_artifact = None
        if artifact_dir:
            art = load_artifact(artifact_dir, cfg)
            if art is not None:
                self.warm_artifact = art
                self.thresholds = art.thresholds
                log.info("warm-started thresholds %s from artifact "
                         "(key %s...)", art.thresholds, art.config_key[:12])

    @property
    def direction(self) -> str:
        return "macs" if self.mac_budget else "epsilon"

    # ------------------------------------------------------------------
    def attach(self, engine) -> None:
        """Called once by the engine at construction: push the warm-start
        artifact's thresholds (if any) before the first request."""
        if self.thresholds is not None:
            engine.push_thresholds(self.thresholds)
            self.pushes += 1

    def maybe_update(self, engine):
        """One engine tick.  Returns the pushed thresholds, or None."""
        self._tick += 1
        if self._tick % self.resolve_every:
            return None
        return self.update(engine)

    # ------------------------------------------------------------------
    def _normalized_shadow(self, tel: dict) -> Optional[np.ndarray]:
        """Normalized joint shadow histogram of a window — the drift
        signal.  Shadow observations are full-depth and threshold-
        independent, so the controller's own threshold pushes (which
        reshape the live conf_hist populations) can never masquerade as
        traffic drift."""
        h = np.asarray(tel["shadow_count"], np.float64)
        tot = h.sum()
        if tot <= 0:
            return None
        return h / tot

    @staticmethod
    def _minus(cum: dict, base: Optional[dict]) -> dict:
        if base is None:
            return cum
        return {k: (cum[k] if k == "mac_weights" else cum[k] - base[k])
                for k in cum}

    def update(self, engine, force: bool = False):
        """Merge telemetry, solve, guard, push.  ``force`` bypasses the
        min-sample and hysteresis guards (the calibrate CLI's final
        resolve) — it cannot conjure evidence, so zero shadow samples
        still refuse."""
        tels = engine.lane_telemetry()
        if not tels:
            return None
        cum = merge_telemetry(tels)
        window = self._minus(cum, self._snapshot)
        fresh = float(window["shadow_steps"])
        if float(cum["shadow_steps"]) <= 0:
            return None                      # force cannot conjure evidence
        if not force and fresh < self.min_shadow:
            return None

        wconf = self._normalized_shadow(window)
        if (wconf is not None and self._prev_window_conf is not None
                and wconf.shape == self._prev_window_conf.shape):
            drift = float(np.abs(wconf - self._prev_window_conf).sum()
                          / 2.0)
            if drift > self.drift_tol:
                # the traffic shifted: everything accumulated BEFORE this
                # window no longer describes it.  Rebase the exclusion
                # baseline so the stale history stays out of this AND all
                # future solves (not just the one that noticed).
                self._drift_base = self._snapshot
                self.drift_resets += 1
                log.info("confidence drift %.3f > %.3f: discarding "
                         "pre-drift telemetry from this and future "
                         "resolves", drift, self.drift_tol)
        if wconf is not None:
            self._prev_window_conf = wconf
        self._snapshot = cum

        base = self._minus(cum, self._drift_base)
        hist = ExitHistogram.from_telemetry(base, mac_prefix=self.mac_prefix)
        if self.mac_budget:
            res = solve_budget(hist, self.mac_budget)
        else:
            res = solve_epsilon(hist, self.epsilon)
        self.resolves += 1
        self.last_result = res

        cur = engine.current_thresholds()
        if (not force and cur is not None
                and len(cur) == len(res.thresholds)):
            move = max(abs(a - b)
                       for a, b in zip(res.thresholds[:-1], cur[:-1]))
            if move < self.hysteresis:
                self.skipped_small += 1
                return None
        engine.push_thresholds(res.thresholds)
        self.pushes += 1
        self.thresholds = res.thresholds
        self.last_shadow = float(base["shadow_steps"])
        log.info("pushed thresholds %s (%s=%s, agreement %.4f, avg MACs "
                 "%.3g, %d shadow obs)", res.thresholds, self.direction,
                 self.mac_budget or self.epsilon, res.agreement,
                 res.avg_macs, int(float(base["shadow_steps"])))
        if self.artifact_dir:
            self.save_artifact(float(base["shadow_steps"]))
        return res.thresholds

    # ------------------------------------------------------------------
    def save_artifact(self, shadow_steps: float) -> Optional[str]:
        if self.last_result is None:
            return None
        res = self.last_result
        art = CalibrationArtifact(
            config_key=config_key(self.cfg),
            thresholds=tuple(res.thresholds),
            direction=self.direction,
            target=float(self.mac_budget or self.epsilon),
            bins=self.cfg.autotune.bins,
            mac_prefix=self.mac_prefix,
            agreement=float(res.agreement),
            avg_macs=float(res.avg_macs),
            shadow_steps=float(shadow_steps),
            edges=tuple(res.edges),
            source=self.source)
        return save_artifact(self.artifact_dir, art)

    def stats(self) -> dict:
        return {
            "direction": self.direction,
            "target": float(self.mac_budget or self.epsilon),
            "resolves": self.resolves,
            "pushes": self.pushes,
            "skipped_small": self.skipped_small,
            "drift_resets": self.drift_resets,
            "last_shadow_steps": float(self.last_shadow),
            "source": self.source,
            "thresholds": ([float(t) for t in self.thresholds]
                           if self.thresholds is not None else None),
            "agreement": (float(self.last_result.agreement)
                          if self.last_result else None),
            "avg_macs": (float(self.last_result.avg_macs)
                         if self.last_result else None),
        }
