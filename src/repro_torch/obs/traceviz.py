"""Perfetto / Chrome trace-event JSON export for flight recordings.

The counterpart of the JAX package's ``obs/traceviz.py``.
``trace_events`` flattens one or more :class:`FlightRecorder`\\ s into
the Chrome trace-event format (the JSON Perfetto and ``chrome://tracing``
both load): one *process* per recorder (engine / fleet member), one
*thread* per lane plus a ``queue`` track, complete (``ph="X"``) slices
for prefills / decode chunks / per-request queue waits, and instant
(``ph="i"``) markers for threshold pushes, drains, migrations and
request terminals — so a fleet drain or an autotune push is visible on
the same timeline as the chunks it perturbed.

Timestamps: recorders stamp ``time.perf_counter`` seconds; the export
rebases everything to the earliest stamp and converts to integer-ish
microseconds (the unit the trace-event spec mandates).

``validate_trace_events`` is the schema check the tests and
``chip_smoke.py`` run on the export.
"""
from __future__ import annotations

import json
from typing import List, Optional, Tuple

_QUEUE_TID = 0          # per-process track for queue_wait spans
_EVENT_TID = 999        # per-process track for instant markers

_SLICE_SPANS = ("prefill", "reprefill", "chunk")
_TERMINALS = ("exit", "escalate", "migrate", "cancelled")


def _named(recorders) -> List[Tuple[str, object]]:
    out = []
    for i, r in enumerate(recorders):
        if isinstance(r, tuple):
            out.append((str(r[0]), r[1]))
        else:
            out.append((getattr(r, "name", None) or f"engine{i}", r))
    return out


def trace_events(recorders, extra_events=None) -> List[dict]:
    """Flatten recorders (or ``(name, recorder)`` pairs) into a trace
    event list.  ``extra_events`` is an optional iterable of
    fleet-level :class:`~repro_torch.obs.recorder.EventLog` snapshots to render
    as instants on a dedicated ``fleet`` process (pid 0); recorder
    processes start at pid 1."""
    named = _named(recorders)
    t_min = None
    for _, rec in named:
        for f in list(rec.done.values()) + list(rec.live.values()):
            if t_min is None or f.t_submit < t_min:
                t_min = f.t_submit
        for e in rec.events.snapshot():
            if t_min is None or e["t"] < t_min:
                t_min = e["t"]
    for e in (extra_events or []):
        if t_min is None or e["t"] < t_min:
            t_min = e["t"]
    if t_min is None:
        t_min = 0.0

    def us(t):
        return max(0.0, (t - t_min) * 1e6)

    evs: List[dict] = []

    def meta(pid, name):
        evs.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                    "args": {"name": name}})

    def thread_meta(pid, tid, tname):
        evs.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tid, "args": {"name": tname}})

    if extra_events:
        meta(0, "fleet")
        for e in extra_events:
            evs.append({"ph": "i", "s": "g", "name": e["name"],
                        "pid": 0, "tid": _EVENT_TID, "ts": us(e["t"]),
                        "args": dict(e.get("attrs") or {})})

    for pidx, (name, rec) in enumerate(named):
        pid = pidx + 1
        meta(pid, name)
        thread_meta(pid, _QUEUE_TID, "queue")
        thread_meta(pid, _EVENT_TID, "events")
        seen_lanes = set()

        def lane_tid(lane):
            tid = 1 + int(lane)
            if tid not in seen_lanes:
                seen_lanes.add(tid)
                thread_meta(pid, tid, f"lane{int(lane)}")
            return tid

        for f in list(rec.done.values()) + list(rec.live.values()):
            for s in f.spans:
                if s.name == "queue_wait":
                    evs.append({
                        "ph": "X", "name": f"queue_wait rid={f.rid}",
                        "cat": "queue", "pid": pid, "tid": _QUEUE_TID,
                        "ts": us(s.t0), "dur": max(0.0, us(s.t1) - us(s.t0)),
                        "args": {"rid": f.rid, **s.attrs}})
                elif s.name in _SLICE_SPANS:
                    evs.append({
                        "ph": "X",
                        "name": f"{s.name} rid={f.rid}",
                        "cat": "decode", "pid": pid,
                        "tid": lane_tid(s.attrs.get("lane", 0)),
                        "ts": us(s.t0), "dur": max(0.0, us(s.t1) - us(s.t0)),
                        "args": {"rid": f.rid, **s.attrs}})
                elif s.name in _TERMINALS:
                    evs.append({
                        "ph": "i", "s": "t",
                        "name": f"{s.name} rid={f.rid}",
                        "cat": "terminal", "pid": pid,
                        "tid": lane_tid(f.attrs.get("lane") or 0),
                        "ts": us(s.t0),
                        "args": {"rid": f.rid, **s.attrs}})
        # engine-level events: lane_chunk / lane_prefill become per-lane
        # slices (the lane track shows utilization even for slots whose
        # flights were ring-evicted); everything else becomes an instant
        for e in rec.events.snapshot():
            at = e.get("attrs") or {}
            if e["name"] in ("lane_chunk", "lane_prefill"):
                evs.append({
                    "ph": "X", "name": e["name"], "cat": "lane",
                    "pid": pid, "tid": lane_tid(at.get("lane", 0)),
                    "ts": us(e["t"]),
                    "dur": max(0.0, float(at.get("seconds", 0.0)) * 1e6),
                    "args": at})
            else:
                evs.append({
                    "ph": "i", "s": "p", "name": e["name"],
                    "cat": "event", "pid": pid, "tid": _EVENT_TID,
                    "ts": us(e["t"]), "args": at})
    return evs


def export_trace(path: str, recorders, extra_events=None) -> dict:
    """Write ``{"traceEvents": [...]}`` (validated) and return it."""
    evs = trace_events(recorders, extra_events=extra_events)
    validate_trace_events(evs)
    doc = {"traceEvents": evs, "displayTimeUnit": "ms"}
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return doc


def validate_trace_events(events, require_names=()) -> None:
    """Chrome trace-event schema check (raises ValueError).

    Enforced per event: required keys by phase (``X``: ts+dur+pid+tid,
    ``i``: ts+pid+tid+scope in g/p/t, ``M``: metadata name + args),
    numeric non-negative timestamps/durations, and JSON
    serializability of args.  ``require_names`` additionally asserts
    that each named event (e.g. ``drain``, ``threshold_push``) appears
    at least once — the tests use it to pin that a fleet trace shows
    its drain/migration."""
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    seen = set()
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            raise ValueError(f"event {i} is not an object")
        ph = e.get("ph")
        if ph not in ("X", "i", "M"):
            raise ValueError(f"event {i}: unsupported ph {ph!r}")
        if not isinstance(e.get("name"), str) or not e["name"]:
            raise ValueError(f"event {i}: missing name")
        seen.add(e["name"])
        if ph == "M":
            if e["name"] not in ("process_name", "thread_name"):
                raise ValueError(f"event {i}: unknown metadata "
                                 f"{e['name']!r}")
            if "name" not in (e.get("args") or {}):
                raise ValueError(f"event {i}: metadata without args.name")
            continue
        for key in ("pid", "tid"):
            if not isinstance(e.get(key), int):
                raise ValueError(f"event {i}: {key} must be an int")
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"event {i}: bad ts {ts!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i}: bad dur {dur!r}")
        if ph == "i" and e.get("s") not in ("g", "p", "t"):
            raise ValueError(f"event {i}: instant scope must be g/p/t")
        try:
            json.dumps(e.get("args", {}))
        except TypeError as err:
            raise ValueError(
                f"event {i}: args not JSON-serializable: {err}")
    missing = [n for n in require_names
               if not any(s == n or s.startswith(n + " ")
                          for s in seen)]
    if missing:
        raise ValueError(f"required trace events missing: {missing}")
