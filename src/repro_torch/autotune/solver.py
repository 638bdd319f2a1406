"""Histogram-space threshold solver: coordinate descent over δ̂_m.

The §5 routine (`repro_torch.core.calibration`) tunes each component's
threshold against its OWN accuracy curve, independently — but the cascade
is a pipeline: raising δ̂_0 changes the sample population component 1 sees, so
the per-component optima do not compose into the cascade optimum (the
framing of Streeter, *Approximation Algorithms for Cascading Prediction
Models*, 2018, and the joint-beats-independent result of Enomoto & Eda,
*Learning to Cascade*, 2021).  This module solves the joint problem in
histogram space, in both directions the serving system needs:

* :func:`solve_epsilon` — target accuracy degradation ε → thresholds
  (generalizing §5: the constraint is the *cascade's* agreement with the
  full-depth model, not each component's self-accuracy);
* :func:`solve_budget` — target average-MAC budget → thresholds (the
  per-component search that dominates ``BudgetPolicy``'s shared exit
  quantile at equal budget: the shared-quantile solution is one of the
  solver's starting points, and coordinate moves only ever improve the
  objective, so the result is never worse).

Everything operates on an :class:`ExitHistogram` — the joint fixed-bin
histogram of the routing components' confidences with per-component
agreement counts, either accumulated live on device
(:class:`repro_torch.autotune.telemetry.ExitTelemetry`) or built from raw
samples (:meth:`ExitHistogram.from_samples`, the host-recompute
reference the device accumulation is tested against).  Thresholds live on
the bin grid: edge index e ∈ [0, bins] maps to δ = e/bins (e = bins means
"never exit", deployed as the repo's sentinel 1.1), and the binning rule
``bin = min(floor(c·bins), bins-1)`` makes the bin gate ``bin >= e``
*exactly* equivalent to the engine's ``conf >= δ`` gate.

A coordinate sweep marginalizes the joint histogram once (O(cells)) into
per-bin profiles — count, exit-here agreement, continue-downstream MACs and
agreement — after which every candidate edge is a prefix/suffix sum:
O(bins) per swept coordinate, no re-scan of the data.

A copy of the JAX package's ``autotune/solver.py`` (numpy only), pinned
to it by ``tests/test_torch_calibration.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

MAX_SWEEPS = 64
# feasibility slop for float comparisons on count sums
_EPS = 1e-9


def thresholds_from_edges(edges: Sequence[int], bins: int) -> Tuple[float, ...]:
    """Bin-edge indices (routing components) → deployable threshold vector
    (the final component's threshold is always 0; e == bins → never exit,
    deployed as the sentinel 1.1 like ``threshold_for_epsilon``)."""
    out = [1.1 if e >= bins else float(e) / bins for e in edges]
    return tuple(out) + (0.0,)


def edges_from_thresholds(thresholds: Sequence[float], bins: int
                          ) -> Tuple[int, ...]:
    """Quantize a deployed threshold vector (routing components; a trailing
    final-component 0 is ignored) onto the bin grid: the smallest edge whose
    gate ``bin >= e`` admits no sample the real gate ``conf >= δ`` rejects."""
    ths = list(thresholds)
    if len(ths) >= 2 and ths[-1] == 0.0:
        ths = ths[:-1]
    out = []
    for t in ths:
        if t > 1.0:
            out.append(bins)
        else:
            out.append(int(np.clip(np.ceil(t * bins - _EPS), 0, bins)))
    return tuple(out)


@dataclasses.dataclass
class SolveResult:
    thresholds: Tuple[float, ...]   # n_components, final forced to 0.0
    edges: Tuple[int, ...]          # routing-component bin edges
    avg_macs: float                 # expected MACs/sample on the histogram
    agreement: float                # expected agreement with the final comp
    sweeps: int                     # coordinate sweeps until convergence
    feasible: bool                  # constraint met (False = best effort)


@dataclasses.dataclass
class ExitHistogram:
    """Joint routing-confidence histogram + agreement counts (host numpy).

    counts      (bins,) * n_routing — joint cell counts (C-order,
                component 0 slowest-varying, matching the device layout).
    agree       (n_routing,) + counts.shape — per component, how many of
                the cell's samples had that component agreeing with final.
    mac_prefix  (n_routing + 1,) — analytic MACs of answering at each
                component (the paper's §6.2 currency).
    bins        histogram resolution.
    """

    counts: np.ndarray
    agree: np.ndarray
    mac_prefix: np.ndarray
    bins: int
    # per-cell correctness counts of the FINAL component.  None = the
    # agreement-with-final proxy, under which the final component is
    # correct by definition; set from real labels in offline fits
    # (BudgetPolicy.fit / the benchmarks) so the constraint targets true
    # cascade accuracy instead.
    final_agree: Optional[np.ndarray] = None

    def __post_init__(self):
        self.counts = np.asarray(self.counts, np.float64)
        self.agree = np.asarray(self.agree, np.float64)
        self.mac_prefix = np.asarray(self.mac_prefix, np.float64)
        r = self.counts.ndim
        if self.counts.shape != (self.bins,) * r:
            raise ValueError(f"counts shape {self.counts.shape} is not "
                             f"(bins,)*{r} with bins={self.bins}")
        if self.agree.shape != (r,) + self.counts.shape:
            raise ValueError(f"agree shape {self.agree.shape} != "
                             f"{(r,) + self.counts.shape}")
        if self.mac_prefix.shape != (r + 1,):
            raise ValueError(f"mac_prefix shape {self.mac_prefix.shape} != "
                             f"({r + 1},)")
        if self.final_agree is not None:
            self.final_agree = np.asarray(self.final_agree, np.float64)
            if self.final_agree.shape != self.counts.shape:
                raise ValueError(
                    f"final_agree shape {self.final_agree.shape} != "
                    f"{self.counts.shape}")

    # ------------------------------------------------------------------
    @property
    def n_routing(self) -> int:
        return self.counts.ndim

    @property
    def n_components(self) -> int:
        return self.counts.ndim + 1

    @property
    def total(self) -> float:
        return float(self.counts.sum())

    @property
    def final_accuracy(self) -> float:
        """Accuracy of always answering at the final component — 1.0 under
        the agreement proxy, the labeled rate when final_agree is set."""
        if self.final_agree is None:
            return 1.0
        tot = self.total
        return float(self.final_agree.sum()) / tot if tot else 1.0

    def _agree_ext(self) -> np.ndarray:
        """(n_components,) + cells: per-component correct-answer counts,
        with the final row the proxy (counts) or the labeled correctness."""
        final = (self.counts if self.final_agree is None
                 else self.final_agree)
        return np.concatenate([self.agree, final[None]], axis=0)

    # ------------------------------------------------------------------
    @classmethod
    def from_samples(cls, confidences, agrees, mac_prefix,
                     bins: int) -> "ExitHistogram":
        """Build from raw per-sample vectors — the host-recompute reference
        for the device accumulation (same binning, same C-order cells).

        confidences: (n_routing, N) or (n_components, N) — a final-
        component confidence row never routes and is dropped.  agrees:
        same leading dim; when an (n_components, N) correctness matrix is
        given, the final row becomes the labeled ``final_agree`` (true
        accuracy) instead of the agreement proxy.
        """
        conf = np.asarray(confidences, np.float64)
        agr = np.asarray(agrees, np.float64)
        n_m = len(mac_prefix)
        if conf.shape[0] == n_m:
            conf = conf[:-1]
        final_row = None
        if agr.shape[0] == n_m:
            final_row = agr[-1]
            agr = agr[:-1]
        r = n_m - 1
        if conf.shape[0] != r or agr.shape != conf.shape:
            raise ValueError(
                f"need ({r}, N) routing confidences/agreements for "
                f"{n_m} components; got {conf.shape} / {agr.shape}")
        # bin in f32 exactly like the device (telemetry.conf_to_bin /
        # the fused kernel): the f32-vs-f64 product can round across an
        # integer at bin edges for non-power-of-two bin counts, which
        # would break the bit-match contract with device accumulation
        b = np.clip((conf.astype(np.float32)
                     * np.float32(bins)).astype(np.int64), 0, bins - 1)
        flat = np.ravel_multi_index(tuple(b), (bins,) * r)
        cells = bins ** r
        counts = np.bincount(flat, minlength=cells).astype(np.float64)
        agree = np.stack([np.bincount(flat, weights=agr[m], minlength=cells)
                          for m in range(r)])
        final_agree = (None if final_row is None else np.bincount(
            flat, weights=final_row, minlength=cells).reshape((bins,) * r))
        return cls(counts=counts.reshape((bins,) * r),
                   agree=agree.reshape((r,) + (bins,) * r),
                   mac_prefix=np.asarray(mac_prefix, np.float64), bins=bins,
                   final_agree=final_agree)

    @classmethod
    def from_telemetry(cls, tel, mac_prefix=None,
                       bins: Optional[int] = None) -> "ExitHistogram":
        """Build from accumulated telemetry (an ExitTelemetry pytree or the
        host counter dict from ``telemetry_to_host``/``merge_telemetry``).
        ``mac_prefix`` defaults to the carried ``mac_weights``.

        The routing-axis count is the telemetry's ``shadow_agree`` row
        count: ``n_components - 1`` normally, ``n_components`` when the
        telemetry was accumulated under ``autotune.route_final`` (the
        final component's confidence is itself a routing axis — the
        escalation tier's defer decision).  Route-final telemetry needs an
        explicit ``mac_prefix`` of ``n_components + 1`` entries: the extra
        final entry prices *deferring past* the final component (next
        stage's cost), which no single engine can know."""
        if not isinstance(tel, dict):
            from repro_torch.autotune.telemetry import telemetry_to_host
            tel = telemetry_to_host(tel)
        n_m = tel["exit_counts"].shape[0]
        r = tel["shadow_agree"].shape[0]
        if mac_prefix is None:
            if r != n_m - 1:
                raise ValueError(
                    "route_final telemetry needs an explicit mac_prefix "
                    f"of {r + 1} entries (the final entry prices the "
                    "next escalation stage)")
            mac_prefix = tel["mac_weights"]
            if not np.any(np.asarray(mac_prefix)):
                raise ValueError(
                    "telemetry carries zero mac_weights; pass mac_prefix= "
                    "(repro_torch.core.macs.segment_macs_per_token)")
        cells = tel["shadow_count"].shape[0]
        if bins is None:
            bins = int(round(cells ** (1.0 / r))) if r else int(cells)
        if bins ** r != cells:
            raise ValueError(f"{cells} cells is not bins^{r} for any "
                             f"integer bins (got bins={bins})")
        return cls(
            counts=np.asarray(tel["shadow_count"],
                              np.float64).reshape((bins,) * r),
            agree=np.asarray(tel["shadow_agree"],
                             np.float64).reshape((r,) + (bins,) * r),
            mac_prefix=np.asarray(mac_prefix, np.float64), bins=bins)

    # ------------------------------------------------------------------
    def marginal(self, m: int) -> Tuple[np.ndarray, np.ndarray]:
        """(count_b, agree_b) of component m's confidence, marginalized
        over the other routing components — the §5-style view."""
        axes = tuple(a for a in range(self.n_routing) if a != m)
        return (self.counts.sum(axis=axes) if axes else self.counts.copy(),
                self.agree[m].sum(axis=axes) if axes
                else self.agree[m].copy())

    def _exit_map(self, edges: np.ndarray) -> np.ndarray:
        """Answering component per cell under bin-edge thresholds."""
        grids = np.indices(self.counts.shape)
        exceeds = grids >= edges.reshape((-1,) + (1,) * self.n_routing)
        first = np.argmax(exceeds, axis=0)
        return np.where(exceeds.any(axis=0), first, self.n_routing)

    def evaluate(self, edges: Sequence[int]) -> Tuple[float, float]:
        """(avg MACs per sample, agreement fraction) of the cascade under
        the given routing-edge thresholds."""
        edges = np.asarray(edges, np.int64)
        ex = self._exit_map(edges)
        total = self.total
        if total <= 0:
            return float(self.mac_prefix[-1]), 1.0
        macs = float((self.counts * self.mac_prefix[ex]).sum()) / total
        agr = float(np.take_along_axis(self._agree_ext(), ex[None],
                                       axis=0)[0].sum()) / total
        return macs, agr

    # ------------------------------------------------------------------
    def coordinate_profile(self, edges: Sequence[int], m: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Total (MAC, agreement) counts as a function of edge e_m, holding
        every other edge fixed: arrays of shape (bins + 1,) indexed by the
        candidate edge.  One O(cells) marginalization + O(bins) sums —
        the inner loop of every coordinate sweep.
        """
        edges = np.asarray(edges, np.int64)
        r = self.n_routing
        grids = np.indices(self.counts.shape)
        # reaches m: no earlier component exits
        reach = np.ones(self.counts.shape, bool)
        for j in range(m):
            reach &= grids[j] < edges[j]
        # if not exiting at m: first later exit, else final
        cont = np.full(self.counts.shape, r, np.int64)
        for j in range(r - 1, m, -1):
            cont = np.where(grids[j] >= edges[j], j, cont)
        agree_ext = self._agree_ext()
        # cells that never reach m keep their current-edge outcome
        ex = self._exit_map(edges)
        not_reach = ~reach
        macs_other = float((self.counts * self.mac_prefix[ex])[not_reach]
                           .sum())
        agree_other = float(np.take_along_axis(agree_ext, ex[None],
                                               axis=0)[0][not_reach].sum())
        # group reaching cells by b_m
        bsel = grids[m][reach]
        w = self.counts[reach]
        cnt = np.bincount(bsel, weights=w, minlength=self.bins)
        agr_exit = np.bincount(bsel, weights=self.agree[m][reach],
                               minlength=self.bins)
        cont_mac = np.bincount(bsel, weights=w * self.mac_prefix[cont[reach]],
                               minlength=self.bins)
        cont_agr = np.bincount(
            bsel, weights=np.take_along_axis(agree_ext, cont[None],
                                             axis=0)[0][reach],
            minlength=self.bins)
        # edge e: bins >= e exit here (suffix), bins < e continue (prefix)
        suf_cnt = np.concatenate([np.cumsum(cnt[::-1])[::-1], [0.0]])
        suf_agr = np.concatenate([np.cumsum(agr_exit[::-1])[::-1], [0.0]])
        pre_mac = np.concatenate([[0.0], np.cumsum(cont_mac)])
        pre_agr = np.concatenate([[0.0], np.cumsum(cont_agr)])
        macs_e = macs_other + self.mac_prefix[m] * suf_cnt + pre_mac
        agree_e = agree_other + suf_agr + pre_agr
        return macs_e, agree_e


# ---------------------------------------------------------------------------
# fleet: merging per-engine histograms
# ---------------------------------------------------------------------------

def merge_histograms(hists: Sequence[ExitHistogram]) -> ExitHistogram:
    """Merge per-engine histograms into one fleet histogram.

    Fixed-bin joint histograms over the SAME grid merge by elementwise
    addition — ``bincount(a ++ b) == bincount(a) + bincount(b)`` — so the
    merged histogram is *exactly* the histogram of the pooled samples, and
    a solve on it is exactly the pooled-sample solve (no approximation;
    `tests/test_fleet.py` and the fleet bench pin equality, not
    tolerance).  This is what makes one fleet-wide resolve K-fold faster
    to warm up than K per-engine resolves: the min_shadow evidence window
    fills from every engine's shadow sampler at once.

    Requires identical bins / routing-axis count / mac_prefix across
    members (homogeneous fleet — same model config, which the
    TelemetryAggregator enforces via ``config_key`` equality).
    ``final_agree`` must be set on all members or none; mixing a labeled
    member with proxy members would silently blend two different accuracy
    definitions.
    """
    if not hists:
        raise ValueError("merge_histograms needs at least one histogram")
    h0 = hists[0]
    for i, h in enumerate(hists[1:], start=1):
        if h.bins != h0.bins or h.n_routing != h0.n_routing:
            raise ValueError(
                f"histogram {i} has grid (bins={h.bins}, "
                f"n_routing={h.n_routing}) != member 0's (bins={h0.bins}, "
                f"n_routing={h0.n_routing}); fleet merge needs one grid")
        if not np.allclose(h.mac_prefix, h0.mac_prefix):
            raise ValueError(
                f"histogram {i} has mac_prefix {h.mac_prefix.tolist()} != "
                f"member 0's {h0.mac_prefix.tolist()}; a fleet merge is "
                "only meaningful across engines paying the same costs")
        if (h.final_agree is None) != (h0.final_agree is None):
            raise ValueError(
                "final_agree set on some members but not others — labeled "
                "and proxy accuracy definitions cannot merge")
    return ExitHistogram(
        counts=np.sum([h.counts for h in hists], axis=0),
        agree=np.sum([h.agree for h in hists], axis=0),
        mac_prefix=h0.mac_prefix.copy(),
        bins=h0.bins,
        final_agree=(None if h0.final_agree is None else
                     np.sum([h.final_agree for h in hists], axis=0)))


# ---------------------------------------------------------------------------
# cross-model escalation: heterogeneous (stage, component) composition
# ---------------------------------------------------------------------------

def compose_mac_prefix(stage_prefixes: Sequence[Sequence[float]],
                       replay_overheads: Optional[Sequence[float]] = None
                       ) -> Tuple[float, ...]:
    """MAC prefix of a multi-stage escalation tier, one entry per
    (stage, component) in stage-major order.

    ``stage_prefixes[s]`` is stage s's own per-component analytic prefix
    (``repro_torch.core.macs.segment_macs_per_token`` on *that stage's*
    config — the per-stage heterogeneous costs).  Answering at stage s component j
    costs everything spent getting there: the FULL depth of every earlier
    stage (a deferred token was answered at the earlier stage's final
    component before the tier rejected it) plus that stage's per-token
    replay overhead (the escalated prefix is re-prefilled into the next
    stage — ``replay_overheads[s]`` amortizes it per decoded token; 0
    when prefix replay is free or disabled), plus ``stage_prefixes[s][j]``.
    """
    if not stage_prefixes:
        raise ValueError("need at least one stage prefix")
    over = list(replay_overheads) if replay_overheads is not None else \
        [0.0] * (len(stage_prefixes) - 1)
    if len(over) != len(stage_prefixes) - 1:
        raise ValueError(
            f"need {len(stage_prefixes) - 1} replay overheads for "
            f"{len(stage_prefixes)} stages, got {len(over)}")
    out, cum = [], 0.0
    for s, prefix in enumerate(stage_prefixes):
        prefix = [float(p) for p in prefix]
        if not prefix:
            raise ValueError(f"stage {s} has an empty mac prefix")
        out.extend(cum + p for p in prefix)
        cum += prefix[-1] + (over[s] if s < len(over) else 0.0)
    return tuple(out)


def compose_escalation(h0: ExitHistogram, h1: ExitHistogram, *,
                       stage_agree: float = 1.0,
                       mac_prefix=None) -> ExitHistogram:
    """Compose a draft stage's route-final histogram with the next stage's
    histogram into one joint tier histogram the unchanged
    :func:`solve_epsilon` / :func:`solve_budget` can search.

    ``h0`` must carry the stage's FINAL confidence as its last routing
    axis (telemetry accumulated under ``autotune.route_final``): in the
    tier, answering at stage 0's final component is itself a routed
    decision, and the threshold the solver assigns to that axis IS the
    escalation threshold.  ``h1`` is the next stage's ordinary histogram
    (its final component is the tier's authority).

    Two measurable quantities bridge the stages:

    * stage independence — the joint cell distribution factorizes as
      ``counts = c0 ⊗ (c1 / Σc1)``: which stage-1 confidence cell a token
      lands in is taken as independent of its stage-0 cell.  When stage 1
      has no shadow evidence yet the stage-1 factor degrades to uniform
      with zero agreement mass, so the solver routes nothing into stage
      1's intra exits until evidence arrives (deferral itself — the
      stage-1 FINAL — stays the proxy-perfect authority).
    * ``stage_agree`` — P(stage-0's answer == tier final answer at the
      same context), measured online by the tier router from rejected
      tokens vs their stage-1 regenerations.  Every stage-0 agree row is
      chained through it (``P(m = tier) ≈ P(m = stage-0 final) ·
      stage_agree`` — conditional-independence lower bound); the route-
      final row is stage-0 final's self-agreement, so scaling it makes it
      exactly the escalation axis's answer-here agreement.

    ``mac_prefix`` (``h0.n_routing + h1.n_routing + 1`` entries — build it
    with :func:`compose_mac_prefix`) replaces both stages' own prefixes.
    """
    if h0.bins != h1.bins:
        raise ValueError(
            f"stage histograms disagree on bins: {h0.bins} vs {h1.bins}")
    if h0.final_agree is not None or h1.final_agree is not None:
        raise ValueError(
            "compose_escalation composes agreement-proxy histograms; "
            "labeled final_agree stages are not composable (the label "
            "would need the joint (stage0, stage1) sample)")
    bins = h0.bins
    r0, r1 = h0.n_routing, h1.n_routing
    r = r0 + r1
    from repro_torch.autotune.telemetry import MAX_CELLS
    if bins ** r > MAX_CELLS:
        raise ValueError(
            f"composed histogram would need {bins ** r} cells "
            f"(bins={bins}, {r} routing axes); lower autotune.bins "
            f"(cap {MAX_CELLS})")
    if mac_prefix is None:
        raise ValueError("compose_escalation needs the composed "
                         "mac_prefix (see compose_mac_prefix)")
    mac_prefix = np.asarray(mac_prefix, np.float64)
    if mac_prefix.shape != (r + 1,):
        raise ValueError(f"mac_prefix shape {mac_prefix.shape} != "
                         f"({r + 1},)")
    sa = float(stage_agree)
    if not 0.0 <= sa <= 1.0:
        raise ValueError(f"stage_agree must be in [0, 1], got {sa}")

    c0 = h0.counts.reshape(-1)
    c1 = h1.counts.reshape(-1)
    s1 = float(c1.sum())
    cells1 = c1.shape[0]
    if s1 > 0:
        p1 = c1 / s1
        a1 = h1.agree.reshape(r1, -1) / s1
    else:
        p1 = np.full(cells1, 1.0 / cells1)
        a1 = np.zeros((r1, cells1))

    counts = np.outer(c0, p1)
    agree = np.empty((r, c0.shape[0], cells1))
    a0 = h0.agree.reshape(r0, -1) * sa
    for m in range(r0):
        agree[m] = np.outer(a0[m], p1)
    for j in range(r1):
        agree[r0 + j] = np.outer(c0, a1[j])
    shape = (bins,) * r
    return ExitHistogram(counts=counts.reshape(shape),
                         agree=agree.reshape((r,) + shape),
                         mac_prefix=mac_prefix, bins=bins)


def split_tier_thresholds(thresholds: Sequence[float], n_components0: int
                          ) -> Tuple[Tuple[float, ...], float,
                                     Tuple[float, ...]]:
    """Split a composed-tier solve's threshold vector back into deployable
    pieces: (stage-0 intra thresholds, escalation threshold, stage-1
    thresholds).  The solved vector has one entry per (stage, component)
    routing axis plus the forced final 0.0; stage 0's final axis is the
    escalation threshold, and its intra vector gets its final 0.0 back
    (within stage 0 the final component always answers — whether that
    answer *stands* is the escalation decision)."""
    ths = tuple(float(t) for t in thresholds)
    k0 = int(n_components0)
    if len(ths) < k0 + 2:
        raise ValueError(
            f"composed threshold vector of {len(ths)} entries cannot "
            f"split at n_components0={k0}")
    return ths[:k0 - 1] + (0.0,), ths[k0 - 1], ths[k0:]


# ---------------------------------------------------------------------------
# coordinate descent
# ---------------------------------------------------------------------------

def _descend(hist: ExitHistogram, edges, *, minimize_macs: bool,
             constraint: float) -> Tuple[np.ndarray, int, bool]:
    """Coordinate descent from ``edges``.

    minimize_macs=True : minimize MACs subject to agreement >= constraint
                         (counts; the ε direction).
    minimize_macs=False: maximize agreement subject to MACs <= constraint
                         (counts; the budget direction).

    A feasible current edge is always among the sweep candidates, so the
    objective is monotone across sweeps — the returned point is never worse
    than the starting point.
    """
    edges = np.asarray(edges, np.int64).copy()
    r = hist.n_routing
    sweeps = 0
    for sweeps in range(1, MAX_SWEEPS + 1):
        changed = False
        for m in range(r):
            macs_e, agree_e = hist.coordinate_profile(edges, m)
            if minimize_macs:
                feas = agree_e >= constraint - _EPS
                primary, secondary = macs_e, -agree_e
            else:
                feas = macs_e <= constraint + _EPS
                primary, secondary = -agree_e, macs_e
            if feas.any():
                cand = np.where(feas, primary, np.inf)
                best_p = cand.min()
                tie = np.where(np.isclose(cand, best_p, rtol=0, atol=_EPS),
                               secondary, np.inf)
                best = int(np.argmin(tie))
                cur = int(edges[m])
                # keep the current edge on exact ties (no churn)
                if (feas[cur] and np.isclose(cand[cur], best_p, rtol=0,
                                             atol=_EPS)
                        and np.isclose(tie[cur], tie[best], rtol=0,
                                       atol=_EPS)):
                    best = cur
            else:
                # infeasible everywhere along this coordinate: move toward
                # feasibility (max agreement / min MACs respectively)
                best = int(np.argmax(agree_e) if minimize_macs
                           else np.argmin(macs_e))
            if best != edges[m]:
                edges[m] = best
                changed = True
        if not changed:
            break
    macs, agr = hist.evaluate(edges)
    total = max(hist.total, 1.0)
    # ``constraint`` is in counts (profiles sum counts); evaluate() returns
    # per-sample rates — normalize before the final feasibility verdict
    ok = (agr * total >= constraint - _EPS if minimize_macs
          else macs <= constraint / total + _EPS)
    return edges, sweeps, bool(ok)


def _result(hist: ExitHistogram, edges, sweeps: int,
            feasible: bool) -> SolveResult:
    macs, agr = hist.evaluate(edges)
    return SolveResult(
        thresholds=thresholds_from_edges(edges, hist.bins),
        edges=tuple(int(e) for e in edges),
        avg_macs=macs, agreement=agr, sweeps=sweeps, feasible=feasible)


def _corner_starts(hist: ExitHistogram):
    """Specialist starting points: route exits through ONE component
    (e_m = 0, everyone else never exits).  Coordinate descent can be
    locally optimal at allocation-tying points (the shared quantile is
    one); single-component corners are the classic escape hatches for
    cascade threshold allocation (cf. Streeter 2018's single-policy
    candidates)."""
    r = hist.n_routing
    starts = []
    for m in range(r):
        e = np.full(r, hist.bins, np.int64)
        e[m] = 0
        starts.append(e)
    return starts


def independent_epsilon_edges(hist: ExitHistogram,
                              epsilon: float) -> Tuple[int, ...]:
    """The §5 rule, per component on the marginal histograms: δ_m(ε) =
    min{δ : α_m(δ) >= α*_m − ε}, with α_m(δ) the agreement rate over
    samples with conf_m >= δ.  Exactly
    :func:`repro_torch.core.calibration.threshold_for_epsilon` evaluated on
    binned data (and therefore exact whenever the confidences are
    bin-edge-quantized)."""
    out = []
    for m in range(hist.n_routing):
        cnt, agr = hist.marginal(m)
        suf_c = np.concatenate([np.cumsum(cnt[::-1])[::-1], [0.0]])
        suf_a = np.concatenate([np.cumsum(agr[::-1])[::-1], [0.0]])
        with np.errstate(invalid="ignore", divide="ignore"):
            alpha = np.where(suf_c > 0, suf_a / np.maximum(suf_c, 1e-300),
                             0.0)
        alpha_star = alpha.max() if len(alpha) else 0.0
        ok = alpha[:hist.bins] >= alpha_star - epsilon - _EPS
        if not ok.any():
            out.append(hist.bins)
            continue
        e = int(np.argmax(ok))
        # §5 returns the minimum over OBSERVED confidences; edges below
        # the first populated bin admit the same set, and the lowest
        # observed value lives in that bin — snap up so bin-edge-
        # quantized data reproduces threshold_for_epsilon exactly
        if cnt.any():
            e = max(e, int(np.argmax(cnt > 0)))
        out.append(e)
    return tuple(out)


def solve_epsilon(hist: ExitHistogram, epsilon: float,
                  mode: str = "joint") -> SolveResult:
    """Target accuracy degradation ε → thresholds.

    ``mode="independent"`` is the paper's §5 per-component rule on the
    marginal histograms.  ``mode="joint"`` (default) minimizes average
    MACs subject to the CASCADE's accuracy being >= (final-component
    accuracy − ε) — the agreement proxy makes that 1 − ε — by coordinate
    descent seeded from the independent solution (when feasible) and from
    never-exit (always feasible), so the joint answer never spends more
    MACs than a feasible independent answer at the same ε.
    """
    if mode not in ("joint", "independent"):
        raise ValueError(f"mode must be 'joint' or 'independent', "
                         f"got {mode!r}")
    base = hist.final_accuracy
    ind = independent_epsilon_edges(hist, epsilon)
    if mode == "independent":
        macs, agr = hist.evaluate(ind)
        ok = agr >= base - epsilon - _EPS
        return _result(hist, np.asarray(ind), 0, ok)
    total = hist.total
    need = (base - epsilon) * total
    starts = [np.full(hist.n_routing, hist.bins, np.int64)]  # never exit
    starts += _corner_starts(hist)
    _, ind_agr = hist.evaluate(ind)
    if ind_agr * total >= need - _EPS:
        starts.insert(0, np.asarray(ind, np.int64))
    best = None
    for s in starts:
        edges, sweeps, ok = _descend(hist, s, minimize_macs=True,
                                     constraint=need)
        res = _result(hist, edges, sweeps, ok)
        if best is None or (res.feasible, -res.avg_macs) > (
                best.feasible, -best.avg_macs):
            best = res
    return best


def solve_budget(hist: ExitHistogram, mac_budget: float,
                 init_edges: Optional[Sequence[int]] = None) -> SolveResult:
    """Target average-MAC budget → thresholds: maximize agreement with the
    full-depth model subject to avg MACs <= budget, by coordinate descent.

    Starts from all-exit-at-0 (always budget-feasible when the budget is
    achievable at all) and, when given, from ``init_edges`` — pass the
    quantized shared-quantile solution here and the result provably spends
    <= its MACs at >= its agreement (coordinate moves only improve)."""
    budget = float(mac_budget)
    total = hist.total
    cap = budget * max(total, 1.0)
    starts = [np.zeros(hist.n_routing, np.int64)]
    starts += _corner_starts(hist)
    if init_edges is not None:
        init = np.asarray(init_edges, np.int64)
        macs, _ = hist.evaluate(init)
        if macs <= budget + _EPS:
            starts.insert(0, init)
    best = None
    for s in starts:
        edges, sweeps, ok = _descend(hist, s, minimize_macs=False,
                                     constraint=cap)
        res = _result(hist, edges, sweeps, ok)
        key = (res.feasible, res.agreement, -res.avg_macs)
        if best is None or key > (best.feasible, best.agreement,
                                  -best.avg_macs):
            best = res
    return best
