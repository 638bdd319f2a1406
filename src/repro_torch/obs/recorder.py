"""Flight recorder: a per-request span tree assembled on the host.

The counterpart of the JAX package's ``obs/recorder.py``, with the same
names and the same records.  The serving engine already syncs with the
host at fixed points — admission, a lane (re)prefill, once a decode
dispatch (a host tick, or a device-runtime chunk), retire — and at each of
them the data a trace needs (tokens, exit components, confidences,
segment-execution deltas) is ALREADY on the host as numpy.  The recorder
stamps ``time.perf_counter`` around those boundaries and files that data
into per-request flights: it never reads a CUDA tensor, so recording adds
**zero host syncs and zero CUDA-graph captures**, and token streams are
identical recorder-on and recorder-off.

Structures:

* :class:`Span` — one named interval (or instant, ``t1 == t0``) with a
  flat attrs dict.  Span names: ``queue_wait``, ``admit``, ``prefill``,
  ``chunk``, and exactly one terminal per flight — ``exit`` (natural
  finish, including the cache-length budget), ``escalate`` (deferred to
  the next model tier), ``migrate`` (drained to a sibling fleet member) or
  ``cancelled``.
* :class:`Flight` — one request's spans + flight-level attrs (lane, slot,
  cohort, predicted depth, kernel backend, MACs, token count).
* :class:`EventLog` — bounded engine-level events (threshold pushes,
  drains, autotune resolves, per-lane chunk slices for the timeline).
* :class:`FlightRecorder` — live flights (bounded by slot capacity), a
  bounded ring of completed flights (oldest evicted), the event log and
  bounded latency reservoirs feeding p50/p95/p99 summaries.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

from repro_torch.utils import quantiles

TERMINAL_KINDS = ("exit", "escalate", "migrate", "cancelled")

__all__ = ["TERMINAL_KINDS", "EventLog", "Flight", "FlightRecorder", "Span",
           "quantiles"]


class _Reservoir:
    """Bounded newest-wins sample reservoir with lossless count/sum."""

    def __init__(self, maxlen: int):
        self._ring = collections.deque(maxlen=maxlen)
        self.count = 0
        self.total = 0.0

    def add(self, v: float):
        v = float(v)
        self._ring.append(v)
        self.count += 1
        self.total += v

    def values(self) -> List[float]:
        return list(self._ring)

    def summary(self) -> Optional[dict]:
        s = quantiles(self._ring)
        if s is None:
            return None
        # count/sum cover the full lifetime even after ring eviction;
        # quantiles describe the newest `maxlen` samples
        s["count"] = self.count
        s["sum"] = self.total
        return s


class EventLog:
    """Bounded engine-level event deque + lifetime per-name counters."""

    def __init__(self, maxlen: int = 1024, clock=time.perf_counter):
        self._ring = collections.deque(maxlen=maxlen)
        self.counts = collections.Counter()
        self.dropped = 0
        self._clock = clock

    def add(self, name: str, attrs: Optional[dict] = None,
            t: Optional[float] = None):
        if len(self._ring) == self._ring.maxlen:
            self.dropped += 1
        self.counts[name] += 1
        self._ring.append({"name": name,
                           "t": self._clock() if t is None else float(t),
                           "attrs": dict(attrs or {})})

    def snapshot(self) -> List[dict]:
        return [dict(e) for e in self._ring]

    def __len__(self):
        return len(self._ring)


@dataclasses.dataclass
class Span:
    name: str
    t0: float
    t1: float
    attrs: dict

    def to_dict(self) -> dict:
        return {"name": self.name, "t0": self.t0, "t1": self.t1,
                "attrs": dict(self.attrs)}


class Flight:
    """One request's span tree.  ``attrs`` is flight-level context that
    spans shouldn't repeat (lane, slot, cohort, kernel backend, ...)."""

    def __init__(self, rid: int, t_submit: float, submit_tick: int):
        self.rid = rid
        self.t_submit = t_submit
        self.submit_tick = submit_tick
        self.spans: List[Span] = []
        self.attrs: dict = {}
        self.terminal: Optional[str] = None
        self.t_final: Optional[float] = None

    def span(self, name: str, t0: float, t1: float,
             attrs: Optional[dict] = None) -> Span:
        s = Span(name, float(t0), float(t1), dict(attrs or {}))
        self.spans.append(s)
        return s

    def to_dict(self) -> dict:
        return {
            "rid": self.rid,
            "submit_tick": self.submit_tick,
            "t_submit": self.t_submit,
            "t_final": self.t_final,
            "terminal": self.terminal,
            "attrs": dict(self.attrs),
            "spans": [s.to_dict() for s in self.spans],
        }


class FlightRecorder:
    """Bounded per-request flight recording for one engine.

    ``live`` is bounded by the engine's slot + queue population; ``done``
    is a ring of the last ``max_flights`` completed flights (oldest
    evicted, ``evicted`` counts them); reservoirs are bounded
    newest-wins.  Every method is plain host bookkeeping — O(entries)
    dict/list work per existing sync point, no device interaction.  The
    clock is injectable (``clock=``) so that a scripted lifecycle gives
    the same records in both packages.
    """

    def __init__(self, max_flights: int = 64, max_events: int = 1024,
                 reservoir: int = 1024, name: str = "engine",
                 clock=time.perf_counter):
        self.name = name
        self._clock = clock
        self.max_flights = int(max_flights)
        self.live: Dict[int, Flight] = {}
        self.done: "collections.OrderedDict[int, Flight]" = \
            collections.OrderedDict()
        self.evicted = 0
        self.events = EventLog(max_events, clock=clock)
        self.reservoirs = {
            "admission_wait_ticks": _Reservoir(reservoir),
            "e2e_seconds": _Reservoir(reservoir),
            "per_token_seconds": _Reservoir(reservoir),
            "macs_per_request": _Reservoir(reservoir),
            "tokens_per_request": _Reservoir(reservoir),
        }

    @classmethod
    def from_config(cls, obs_cfg, name: str = "engine") -> "FlightRecorder":
        return cls(max_flights=obs_cfg.max_flights,
                   max_events=obs_cfg.max_events,
                   reservoir=obs_cfg.reservoir, name=name)

    # -- request lifecycle ------------------------------------------------
    def on_submit(self, rid: int, tick: int):
        t = self._clock()
        if rid in self.live:
            # a rid resubmitted before its previous flight finalized (should
            # not happen through the engine; be robust for direct callers)
            self._finalize(self.live[rid], "cancelled",
                           {"superseded": True}, t)
        f = Flight(rid, t, tick)
        self.live[rid] = f

    def on_admit(self, rid: int, *, lane: int, slot: Optional[int],
                 cohort: Optional[int], predicted_depth: Optional[float],
                 wait_ticks: int, tick: int,
                 attrs: Optional[dict] = None):
        f = self.live.get(rid)
        if f is None:              # admitted without a recorded submit
            f = Flight(rid, self._clock(), tick - wait_ticks)
            self.live[rid] = f
        t = self._clock()
        f.span("queue_wait", f.t_submit, t, {"wait_ticks": wait_ticks})
        a = {"lane": lane, "slot": slot, "cohort": cohort,
             "predicted_depth": predicted_depth, "tick": tick}
        if attrs:
            a.update(attrs)
        f.span("admit", t, t, a)
        f.attrs.update({k: v for k, v in a.items() if k != "tick"})
        self.reservoirs["admission_wait_ticks"].add(wait_ticks)

    def on_prefill(self, lane: int, t0: float, seconds: float,
                   rids: List[int], fresh: List[int], positions: int):
        """A lane (re)prefill dispatch: one span on every FRESH rid it
        admitted (in-flight co-residents re-prefill as a side effect and
        get a ``reprefill`` span instead), plus a lane-track slice."""
        fresh_set = set(fresh)
        for rid in rids:
            f = self.live.get(rid)
            if f is None:
                continue
            f.span("prefill" if rid in fresh_set else "reprefill",
                   t0, t0 + seconds,
                   {"lane": lane, "positions": positions,
                    "shared_rids": len(rids)})
        self.events.add("lane_prefill",
                        {"lane": lane, "seconds": seconds,
                         "positions": positions, "rids": len(rids)},
                        t=t0)
        # the event above is the slice START stamp; traceviz re-derives the
        # interval from attrs["seconds"]

    def on_chunk(self, lane: int, t0: float, seconds: float, steps: int,
                 entries, compiled: bool = False,
                 segments_run=None, backend: Optional[str] = None):
        """One decode dispatch (host tick: steps=1; device loop: one
        chunk).  ``entries`` is ``[(rid, tokens, exits, confs), ...]`` for
        every live slot, where tokens/exits/confs are that slot's NEW
        values this chunk (python lists the dispatch's one fetch already
        brought to the host); ``segments_run`` is a host array."""
        t1 = t0 + seconds
        for rid, toks, exits, confs in entries:
            f = self.live.get(rid)
            if f is None or not toks:
                continue
            f.span("chunk", t0, t1, {
                "lane": lane, "steps": steps, "tokens": len(toks),
                "exit_components": [int(e) for e in exits],
                "conf_at_exit": float(confs[-1]) if confs else None,
                "compiled": bool(compiled),
            })
            if not compiled and toks:
                per_tok = seconds / max(1, sum(
                    len(e[1]) for e in entries))
                for _ in toks:
                    self.reservoirs["per_token_seconds"].add(per_tok)
        ev = {"lane": lane, "seconds": seconds, "steps": steps,
              "tokens": sum(len(e[1]) for e in entries),
              "compiled": bool(compiled)}
        if segments_run is not None:
            ev["segments_run"] = [int(x) for x in segments_run]
        if backend is not None:
            ev["backend"] = backend
        self.events.add("lane_chunk", ev, t=t0)

    def annotate(self, rid: int, attrs: dict):
        """Merge attrs into a flight (live first, then the done ring) —
        the escalation tier / fleet use this to stamp stage + replay
        context that only they know."""
        f = self.live.get(rid) or self.done.get(rid)
        if f is not None:
            f.attrs.update(attrs)

    def on_finish(self, rid: int, kind: str, attrs: Optional[dict] = None):
        if kind not in TERMINAL_KINDS:
            raise ValueError(f"terminal kind {kind!r} not in "
                             f"{TERMINAL_KINDS}")
        f = self.live.pop(rid, None)
        if f is None:
            return
        self._finalize(f, kind, attrs, self._clock())

    def _finalize(self, f: Flight, kind: str, attrs: Optional[dict],
                  t: float):
        self.live.pop(f.rid, None)
        a = dict(attrs or {})
        f.span(kind, t, t, a)
        f.terminal = kind
        f.t_final = t
        f.attrs.update(a)
        self.reservoirs["e2e_seconds"].add(t - f.t_submit)
        if "n_tokens" in a:
            self.reservoirs["tokens_per_request"].add(a["n_tokens"])
        if "macs" in a:
            self.reservoirs["macs_per_request"].add(a["macs"])
        self.done.pop(f.rid, None)     # re-finished rid: newest wins
        self.done[f.rid] = f
        while len(self.done) > self.max_flights:
            self.done.popitem(last=False)
            self.evicted += 1

    # -- engine-level events ----------------------------------------------
    def on_event(self, name: str, attrs: Optional[dict] = None):
        self.events.add(name, attrs)

    # -- introspection ----------------------------------------------------
    def dump(self, rid: int) -> Optional[dict]:
        f = self.live.get(rid) or self.done.get(rid)
        return f.to_dict() if f is not None else None

    def flights(self, include_live: bool = False) -> List[dict]:
        out = [f.to_dict() for f in self.done.values()]
        if include_live:
            out += [f.to_dict() for f in self.live.values()]
        return out

    def latency(self) -> dict:
        """p50/p95/p99 summaries of every reservoir (None when empty)."""
        return {k: r.summary() for k, r in self.reservoirs.items()}

    def stats(self) -> dict:
        return {
            "name": self.name,
            "flights_live": len(self.live),
            "flights_done": len(self.done),
            "flights_evicted": self.evicted,
            "events": len(self.events),
            "events_dropped": self.events.dropped,
            "event_counts": dict(self.events.counts),
        }
