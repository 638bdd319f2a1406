"""Metrics registry + Prometheus text / JSON exposition.

The counterpart of the JAX package's ``obs/metrics.py``: the same metric
names, labels and help strings, so one dashboard reads either package.
Host-only (stdlib and the recorder's reservoirs): a scrape builds a fresh
:class:`MetricsRegistry` from an engine's ``stats()`` snapshot and its
flight recorder's reservoirs, renders it, and throws it away — there is
no background thread and no sampling loop, so metrics cost nothing
between scrapes.  ``engine_metrics_into`` is duck-typed over anything
with ``stats()`` / ``queued_count()`` / ``free_slot_count()`` (the
engine and the fleet members alike); the fleet's ``scrape()`` calls it
once per member with a ``member=`` label and once more with the merged
reservoirs.

``parse_prometheus`` round-trips the text format (used by the tests and
the serve CLI's scrape self-check).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.utils import quantiles

_QUANTILES = (0.5, 0.95, 0.99)


def _label_str(labels: Optional[dict]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in sorted(labels.items()))
    return "{%s}" % inner


class MetricsRegistry:
    """name → (type, help, samples).  Counters/gauges hold one value per
    label-set; summaries hold a raw value list per label-set and render
    quantiles + ``_sum``/``_count`` at exposition time."""

    def __init__(self):
        # name -> {"type", "help", "samples": {labelkey: (labels, value)}}
        self._m: Dict[str, dict] = {}

    def _slot(self, name: str, typ: str, help_: str) -> dict:
        m = self._m.setdefault(
            name, {"type": typ, "help": help_, "samples": {}})
        if m["type"] != typ:
            raise ValueError(
                f"metric {name} registered as {m['type']}, now {typ}")
        return m

    @staticmethod
    def _key(labels: Optional[dict]) -> Tuple:
        return tuple(sorted((labels or {}).items()))

    def counter(self, name: str, help_: str, value: float,
                labels: Optional[dict] = None):
        m = self._slot(name, "counter", help_)
        k = self._key(labels)
        prev = m["samples"].get(k, (labels, 0.0))[1]
        m["samples"][k] = (dict(labels or {}), prev + float(value))

    def gauge(self, name: str, help_: str, value: float,
              labels: Optional[dict] = None):
        m = self._slot(name, "gauge", help_)
        m["samples"][self._key(labels)] = (dict(labels or {}), float(value))

    def summary(self, name: str, help_: str, values,
                labels: Optional[dict] = None,
                count: Optional[int] = None, total: Optional[float] = None):
        """Register a raw sample list; quantiles are computed at render.
        ``count``/``total`` override the lifetime count/sum when the list
        is a bounded reservoir of a longer stream."""
        m = self._slot(name, "summary", help_)
        k = self._key(labels)
        if k in m["samples"]:
            old = m["samples"][k][1]
            old["values"] = list(old["values"]) + list(values)
            if count is not None:
                old["count"] = (old.get("count") or 0) + count
            if total is not None:
                old["total"] = (old.get("total") or 0.0) + total
        else:
            m["samples"][k] = (dict(labels or {}),
                               {"values": list(values), "count": count,
                                "total": total})

    # -- rendering --------------------------------------------------------
    def render_text(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: List[str] = []
        for name in sorted(self._m):
            m = self._m[name]
            lines.append(f"# HELP {name} {m['help']}")
            lines.append(f"# TYPE {name} {m['type']}")
            for _, (labels, val) in sorted(m["samples"].items()):
                if m["type"] == "summary":
                    vals = val["values"]
                    q = quantiles(vals, _QUANTILES) or {}
                    for qq in _QUANTILES:
                        v = q.get(f"p{int(qq * 100)}")
                        if v is None:
                            continue
                        lq = dict(labels)
                        lq["quantile"] = repr(qq) if qq != 0.5 else "0.5"
                        lines.append(
                            f"{name}{_label_str(lq)} {v:.9g}")
                    cnt = val["count"] if val["count"] is not None \
                        else len(vals)
                    tot = val["total"] if val["total"] is not None \
                        else float(sum(vals))
                    lines.append(
                        f"{name}_sum{_label_str(labels)} {tot:.9g}")
                    lines.append(
                        f"{name}_count{_label_str(labels)} {cnt}")
                else:
                    lines.append(
                        f"{name}{_label_str(labels)} {val:.9g}")
        return "\n".join(lines) + "\n"

    def render_json(self) -> dict:
        out = {}
        for name, m in self._m.items():
            samples = []
            for _, (labels, val) in sorted(m["samples"].items()):
                if m["type"] == "summary":
                    s = quantiles(val["values"], _QUANTILES) or {}
                    if val["count"] is not None:
                        s["count"] = val["count"]
                    if val["total"] is not None:
                        s["sum"] = val["total"]
                    samples.append({"labels": labels, "summary": s})
                else:
                    samples.append({"labels": labels, "value": val})
            out[name] = {"type": m["type"], "help": m["help"],
                         "samples": samples}
        return out


def parse_prometheus(text: str) -> List[dict]:
    """Parse the text exposition format back into samples —
    ``[{"name", "labels", "value"}, ...]``.  Raises ValueError on a
    malformed line, so the tests can assert the scrape parses."""
    samples = []
    for ln in text.splitlines():
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        # NAME{l="v",...} VALUE   |   NAME VALUE
        if "{" in ln:
            name, rest = ln.split("{", 1)
            if "}" not in rest:
                raise ValueError(f"unclosed label set: {ln!r}")
            labelstr, valstr = rest.rsplit("}", 1)
            labels = {}
            # labels never contain escaped quotes in our output; keep the
            # parser simple and strict
            for pair in filter(None, labelstr.split(",")):
                if "=" not in pair:
                    raise ValueError(f"bad label pair {pair!r} in {ln!r}")
                k, v = pair.split("=", 1)
                if not (v.startswith('"') and v.endswith('"')):
                    raise ValueError(f"unquoted label value in {ln!r}")
                labels[k.strip()] = v[1:-1]
        else:
            parts = ln.split(None, 1)
            if len(parts) != 2:
                raise ValueError(f"malformed sample line: {ln!r}")
            name, valstr = parts
            labels = {}
        name = name.strip()
        if not name.replace("_", "").replace(":", "").isalnum():
            raise ValueError(f"bad metric name {name!r}")
        samples.append({"name": name, "labels": labels,
                        "value": float(valstr)})
    return samples


def engine_metrics_into(reg: MetricsRegistry, engine,
                        labels: Optional[dict] = None) -> MetricsRegistry:
    """Map one engine's ``stats()`` snapshot + flight recorder onto the
    registry.  Works with the recorder disabled (counter/gauge metrics
    come straight from ``stats()``; recorder-fed summaries are skipped).
    """
    st = engine.stats()
    reg.counter("repro_requests_finished_total",
                "Requests finished (exit, budget, escalate or migrate).",
                st.get("requests_finished", 0), labels)
    if hasattr(engine, "queued_count"):
        reg.gauge("repro_queue_depth",
                  "Requests queued, not yet admitted.",
                  engine.queued_count(), labels)
    if hasattr(engine, "free_slot_count"):
        reg.gauge("repro_free_slots", "Free decode slots across lanes.",
                  engine.free_slot_count(), labels)
    if st.get("analytic_speedup") is not None:
        reg.gauge("repro_analytic_speedup",
                  "Analytic MAC speedup vs full-depth decode (§6.2).",
                  st["analytic_speedup"], labels)
    if st.get("cond_batch_skip_rate") is not None:
        reg.gauge("repro_cond_batch_skip_rate",
                  "Realized fraction of skippable segment-steps skipped.",
                  st["cond_batch_skip_rate"], labels)
    wc = st.get("wallclock_us_per_token")
    if wc is not None:
        reg.gauge("repro_wallclock_us_per_token",
                  "Measured decode wall-clock per token (us).", wc, labels)
    hist = st.get("exit_histogram")
    if hist:
        for comp, n in enumerate(hist):
            lc = dict(labels or {})
            lc["component"] = str(comp)
            reg.counter("repro_exit_component_total",
                        "Generated tokens by exit component.", n, lc)
    mem = st.get("memory") or {}
    for kind in ("exit", "retire"):
        v = mem.get(f"reclaimed_by_{kind}" if kind == "exit"
                    else "reclaimed_at_retire")
        if v is not None:
            lk = dict(labels or {})
            lk["kind"] = kind
            reg.counter("repro_blocks_reclaimed_total",
                        "KV cache blocks reclaimed (paged layout).", v, lk)
    esc = st.get("escalation") or {}
    for key, kind in (("escalated_requests_admitted", "admitted"),
                      ("cancelled_for_escalation", "cancelled")):
        lk = dict(labels or {})
        lk["kind"] = kind
        reg.counter("repro_escalations_total",
                    "Requests escalated through the model cascade tier.",
                    esc.get(key, 0), lk)
    waits = st.get("admission_wait_ticks") or []
    reg.summary("repro_admission_wait_ticks",
                "Engine ticks between submit and admission.",
                waits, labels)
    flight = getattr(engine, "flight", None)
    if flight is not None:
        reg.counter("repro_threshold_push_total",
                    "Live threshold vectors pushed into decode state.",
                    flight.events.counts.get("threshold_push", 0), labels)
        res = flight.reservoirs
        reg.summary("repro_request_latency_seconds",
                    "Submit-to-finalize latency per request.",
                    res["e2e_seconds"].values(), labels,
                    count=res["e2e_seconds"].count,
                    total=res["e2e_seconds"].total)
        reg.summary("repro_token_latency_seconds",
                    "Decode wall-clock attributed per generated token.",
                    res["per_token_seconds"].values(), labels,
                    count=res["per_token_seconds"].count,
                    total=res["per_token_seconds"].total)
        reg.summary("repro_macs_per_request",
                    "Analytic decode MACs spent per finished request.",
                    res["macs_per_request"].values(), labels,
                    count=res["macs_per_request"].count,
                    total=res["macs_per_request"].total)
    return reg
