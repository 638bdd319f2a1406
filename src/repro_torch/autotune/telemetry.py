"""Device-resident exit telemetry: the raw material of threshold autotuning.

The counterpart of the JAX package's ``autotune/telemetry.py``.
:class:`ExitTelemetry` rides in :class:`repro_torch.core.exec.DecodeState`
and is accumulated inside the decode step, on the host runtime and inside
the device runtime's captured CUDA graph alike.  Its counters are f32
device tensors written IN PLACE (``index_add_`` of 0/1 values, exact up to
2^24 observations whatever the order of the adds), so they keep their
addresses for the lane's life: a captured graph adds into them at every
replay, and a lane's re-prefill carries them over.  Nothing here syncs to
the host on its own: the controller fetches the counters only at its
resolve ticks (:func:`merge_telemetry`, one copy for every lane).

Two families of counters:

* **live** — every decode step, from the components that computed: the
  per-component fixed-bin confidence histogram over the samples still
  undecided when the component ran (``conf_hist``), the answering
  component (``exit_counts``) and the observation count (``steps``);
  ``mac_spent`` is derived on the host from ``exit_counts`` and the
  constant ``mac_weights``.
* **shadow** — every ``autotune.shadow_every``-th decode step (by the
  position cursor, the same schedule on both runtimes) skipping is
  suspended for observation only: the joint binned routing-confidence
  vector goes into ``shadow_count`` and each routing component's agreement
  with the final component into ``shadow_agree``.  Each prefill decision
  is a free shadow observation (prefill computes every component).

Cells are the binned confidences of the routing components, flattened
C-order (component 0 the slowest axis), as ``np.ravel_multi_index`` does:
:meth:`repro_torch.autotune.solver.ExitHistogram.from_samples` recomputes
them on the host bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

# joint-histogram size guard: bins ** (n_components - 1) cells
MAX_CELLS = 1 << 20

_FIELDS = ("conf_hist", "exit_counts", "mac_weights", "steps",
           "shadow_count", "shadow_agree", "shadow_steps")


def conf_to_bin(conf: torch.Tensor, bins: int) -> torch.Tensor:
    """Fixed-bin index of a confidence in (0, 1]: ``min(floor(c·bins),
    bins-1)``.  A deployed threshold δ = e/bins then corresponds exactly to
    the bin gate ``bin >= e``.  The fused exit-update kernel computes the
    same formula in-register; keep the two in lockstep."""
    return torch.clamp((conf * bins).to(torch.int32), 0, bins - 1)


def pack_rider(pred: torch.Tensor, conf: torch.Tensor, bins: int
               ) -> torch.Tensor:
    """The decision scan's telemetry rider code: ``pred * bins + bin``
    packed into one int32."""
    return pred.to(torch.int32) * bins + conf_to_bin(conf, bins)


@dataclasses.dataclass
class ExitTelemetry:
    """Per-lane telemetry counters, f32 device tensors updated in place.

    conf_hist    (n_m, bins) — live confidence histogram per component,
                 over samples still undecided when the component computed.
    exit_counts  (n_m,)      — answering component per live (slot, step).
    mac_weights  (n_m,)      — per-exit analytic MAC cost (constant).
    steps        ()          — live decode (slot, step) observations.
    shadow_count (cells,)    — joint binned routing-confidence counts of
                 the shadow observations (cells = bins^r, r = n_m - 1, or
                 n_m under ``autotune.route_final``).
    shadow_agree (r, cells)  — of those, how many of component m's
                 predictions agreed with the final component's.
    shadow_steps ()          — shadow observations.
    """

    conf_hist: torch.Tensor
    exit_counts: torch.Tensor
    mac_weights: torch.Tensor
    steps: torch.Tensor
    shadow_count: torch.Tensor
    shadow_agree: torch.Tensor
    shadow_steps: torch.Tensor

    def tensors(self):
        return [getattr(self, f) for f in _FIELDS]

    def clone(self) -> "ExitTelemetry":
        return ExitTelemetry(*(x.clone() for x in self.tensors()))


def n_cells(n_components: int, bins: int, route_final: bool = False) -> int:
    cells = bins ** (n_components - 1 + bool(route_final))
    if cells > MAX_CELLS:
        raise ValueError(
            f"autotune joint histogram would need {cells} cells "
            f"(bins={bins}, n_components={n_components}, "
            f"route_final={route_final}); lower autotune.bins "
            f"(cap {MAX_CELLS})")
    return cells


def init_telemetry(n_components: int, bins: int, mac_weights=None,
                   route_final: bool = False, device=None) -> ExitTelemetry:
    """Zeroed telemetry for one lane on ``device``.  ``mac_weights`` is the
    per-exit analytic MAC prefix
    (:func:`repro_torch.core.macs.segment_macs_per_token`); zeros when the
    caller has none.  ``route_final`` widens the shadow histogram by the
    final component's confidence axis (the escalation tier's shape)."""
    r = n_components - 1 + bool(route_final)
    cells = n_cells(n_components, bins, route_final)
    f32 = dict(dtype=torch.float32, device=device)
    if mac_weights is None:
        mw = torch.zeros(n_components, **f32)
    else:
        mw_np = np.asarray(mac_weights, np.float32)
        if mw_np.shape != (n_components,):
            raise ValueError(f"mac_weights shape {mw_np.shape} != "
                             f"({n_components},)")
        mw = torch.as_tensor(mw_np).to(device)
    return ExitTelemetry(
        conf_hist=torch.zeros((n_components, bins), **f32),
        exit_counts=torch.zeros(n_components, **f32),
        mac_weights=mw,
        steps=torch.zeros((), **f32),
        shadow_count=torch.zeros(cells, **f32),
        shadow_agree=torch.zeros((r, cells), **f32),
        shadow_steps=torch.zeros((), **f32))


def telemetry_for(cfg, mac_weights=None, device=None
                  ) -> Optional[ExitTelemetry]:
    """Telemetry for a ModelConfig, or None when autotune is disabled."""
    if not cfg.autotune.enabled:
        return None
    return init_telemetry(cfg.cascade.n_components, cfg.autotune.bins,
                          mac_weights, route_final=cfg.autotune.route_final,
                          device=device)


def _fold_shadow(tel: ExitTelemetry, tbin, tpred, f_live) -> None:
    """THE shadow fold: one full-depth observation batch into
    (shadow_count, shadow_agree, shadow_steps), in place.  Shared by the
    decode step (under its shadow gate) and the prefill.  The routing-axis
    count is ``shadow_agree``'s row count."""
    r = tel.shadow_agree.shape[0]
    bins = tel.conf_hist.shape[1]
    cells = tel.shadow_count.shape[0]
    cell = torch.zeros_like(tbin[0])
    for m in range(r):
        cell = cell * bins + tbin[m]
    tel.shadow_count.index_add_(0, cell, f_live)
    agree = (tpred[:r] == tpred[-1][None, :]).float() * f_live[None, :]
    rows = torch.arange(r, dtype=cell.dtype, device=cell.device)[:, None]
    tel.shadow_agree.view(-1).index_add_(
        0, (rows * cells + cell[None, :]).reshape(-1), agree.reshape(-1))
    tel.shadow_steps.add_(f_live.sum())


def _unpack(tel: ExitTelemetry, tcode):
    bins = tel.conf_hist.shape[1]
    return tcode % bins, tcode // bins


def accumulate_decode(tel: ExitTelemetry, tcode, exit_index, active,
                      shadow, run_if=None) -> None:
    """Fold one staged decode step into the counters, in place.

    ``tcode`` is the finished decision carry's (n_m, B) rider (rows of
    segments that skipped unobserved hold 0 and are masked: "still
    undecided when component m ran" is ``m <= exit_index``).  ``shadow``
    is the step's shadow flag: a host bool, or a 0-d device bool that
    ``run_if(pred, fn)`` (the executor's branch, an IF node in a captured
    graph) gates the shadow fold on."""
    tbin, tpred = _unpack(tel, tcode)
    n_m, bins = tel.conf_hist.shape
    f_live = active.float()
    rows = torch.arange(n_m, dtype=tbin.dtype, device=tbin.device)[:, None]
    reach = (rows <= exit_index[None, :].to(tbin.dtype)) & active[None, :]
    tel.conf_hist.view(-1).index_add_(
        0, (rows * bins + tbin).reshape(-1), reach.float().reshape(-1))
    tel.exit_counts.index_add_(0, exit_index.long(), f_live)
    tel.steps.add_(f_live.sum())
    if isinstance(shadow, bool):
        if shadow:
            _fold_shadow(tel, tbin, tpred, f_live)
    else:
        run_if(shadow, lambda: _fold_shadow(tel, tbin, tpred, f_live))


def accumulate_prefill(tel: ExitTelemetry, tcode, active) -> None:
    """Fold one prefill decision into the SHADOW counters, in place:
    prefill computes every component, so each live slot is a free
    full-depth observation.  The live counters are untouched."""
    tbin, tpred = _unpack(tel, tcode)
    _fold_shadow(tel, tbin, tpred, active.float())


def _host(tels: Sequence[ExitTelemetry]) -> list:
    """Every counter of every lane in ONE device -> host copy."""
    flat = torch.cat([x.reshape(-1).float() for t in tels
                      for x in t.tensors()]).cpu().numpy()
    out, at = [], 0
    for t in tels:
        d = {}
        for f, x in zip(_FIELDS, t.tensors()):
            d[f] = flat[at:at + x.numel()].reshape(tuple(x.shape)).copy()
            at += x.numel()
        d["mac_spent"] = np.float32(np.dot(d["exit_counts"],
                                           d["mac_weights"]))
        out.append(d)
    return out


def telemetry_to_host(tel: ExitTelemetry) -> dict:
    """Every counter as a numpy dict (one copy).  ``mac_spent`` is derived
    here: ``exit_counts · mac_weights`` in f32."""
    return _host([tel])[0]


def merge_telemetry(tels: Sequence) -> dict:
    """Sum per-lane telemetry into one host counter dict, in lane order.
    Accepts ExitTelemetry objects (all fetched in one copy) or host dicts;
    ``mac_weights`` is carried, not summed."""
    if not tels:
        raise ValueError("no telemetry to merge")
    dev = [t for t in tels if not isinstance(t, dict)]
    fetched = iter(_host(dev) if dev else [])
    hosts = [t if isinstance(t, dict) else next(fetched) for t in tels]
    out = {k: hosts[0][k].copy() for k in hosts[0]}
    for h in hosts[1:]:
        for k in out:
            if k == "mac_weights":
                continue
            out[k] = out[k] + h[k]
    return out
