"""The port's observability (``repro_torch.obs``) and the engine's and
tier's recorder hooks, against the JAX package's on bridged weights.

Settings: the recorder classes run the same scripted lifecycle in both
packages with an injected clock, so every record, summary, scrape and trace
must be equal.  The engines take ``tests/test_torch_autotune.py``'s stack
— ``reduced(qwen2.5-3b, n_layers=3)`` in f32, 3 components, thresholds
(0.021, 0.021, 0.0) (exits at every component; the streams of that test's
host/device × dense/paged runs equal the reference's), 2 lanes of 2 slots,
cache_len 32, chunk 4, block size 8 — with six 6-token prompts for four
slots, so two requests queue and a dense lane re-prefills.  Flights must
hold the reference's span names per request, the same chunk token counts
and exit components, the same terminals, and the same scrape samples,
timing samples aside.
"""
import itertools
import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.escalate import ModelCascadeTier as JaxTier
from repro.models.model import build_model as jax_build_model
from repro.obs import FlightRecorder as JaxRecorder
from repro.obs import MetricsRegistry as JaxRegistry
from repro.obs import engine_metrics_into as jax_metrics_into
from repro.obs import parse_prometheus as jax_parse
from repro.obs import trace_events as jax_trace_events
from repro.obs import validate_trace_events as jax_validate
from repro.serving.engine import CascadeServingEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.escalate import ModelCascadeTier
from repro_torch.models.model import build_model
from repro_torch.obs import (EventLog, FlightRecorder, MetricsRegistry,
                             MetricsServer, engine_metrics_into,
                             export_trace, parse_prometheus, trace_events,
                             validate_trace_events)
from repro_torch.obs.recorder import TERMINAL_KINDS
from repro_torch.serving.engine import CascadeServingEngine, Request


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers
    on a few cores, where these small ops gain nothing from more threads
    and would slow the other workers' timed tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MIXED = (0.021, 0.021, 0.0)
ENGINE_KW = dict(lane_batch=2, n_lanes=2, cache_len=32, chunk=4)
N_REQ, MAX_NEW = 6, 6
COMBOS = [("host", "dense"), ("device", "dense"), ("host", "paged"),
          ("device", "paged")]


# ---------------------------------------------------------------------------
# the recorder, metrics and trace modules: one script, both packages
# ---------------------------------------------------------------------------

def _script(recorder_cls):
    """A lifecycle touching every recorder path: supersede, admits with
    and without attrs, a shared prefill, compiled and warm chunks, every
    terminal, annotate on a live and a done flight, engine events, ring
    eviction and reservoir overflow.  The clock ticks 0.25 s a read."""
    rec = recorder_cls(max_flights=3, max_events=5, reservoir=4,
                       name="engine7",
                       clock=itertools.count(0.0, 0.25).__next__)
    for rid in range(6):
        rec.on_submit(rid, tick=rid)
    rec.on_submit(2, tick=7)                     # supersedes a live flight
    for rid in range(6):
        rec.on_admit(rid, lane=rid % 2, slot=rid % 4, cohort=(rid % 4) // 2,
                     predicted_depth=0.5 * rid, wait_ticks=rid, tick=rid + 3,
                     attrs={"kernel_backend": "cuda"} if rid % 2 else None)
    rec.on_prefill(0, 10.0, 0.5, [0, 1, 2], [0, 1], 16)
    rec.on_chunk(0, 11.0, 0.125, 4,
                 [(0, [1, 2], [0, 1], [0.5, 0.25]), (1, [3], [2], [0.75]),
                  (2, [], [], [])],
                 compiled=True, segments_run=np.array([4, 3, 1]),
                 backend="cuda")
    rec.on_chunk(1, 12.0, 0.25, 1, [(3, [9], [1], [0.3]),
                                    (4, [8], [0], [0.9])],
                 segments_run=[2, 1, 0])
    rec.on_chunk(1, 12.5, 0.5, 2, [(3, [7, 6], [2, 2], [0.1, 0.2]),
                                   (5, [5, 4], [1, 0], [0.4, 0.6])])
    rec.annotate(3, {"escalated_to_stage": 1})
    rec.on_event("threshold_push", {"thresholds": [0.5, 0.5, 0.0]})
    rec.on_finish(0, "exit", {"n_tokens": 2, "macs": 10.0})
    rec.on_finish(1, "escalate", {"n_tokens": 1, "macs": 5.0})
    rec.on_finish(3, "migrate", {"n_tokens": 3})
    rec.on_finish(4, "cancelled", {"n_tokens": 1, "queued": False})
    rec.on_finish(99, "exit")                    # unknown rid: no-op
    rec.annotate(1, {"late": True})              # a done flight
    rec.on_finish(5, "exit", {"n_tokens": 2, "macs": 7.5})
    rec.on_event("drain", {"member": 0})
    return rec


class _StatsOnly:
    """The duck-typed surface ``engine_metrics_into`` reads."""

    def __init__(self, flight):
        self.flight = flight

    def stats(self):
        return {"requests_finished": 5, "analytic_speedup": 1.25,
                "cond_batch_skip_rate": 0.5, "wallclock_us_per_token": 12.5,
                "exit_histogram": [3, 1, 4],
                "memory": {"reclaimed_by_exit": 2, "reclaimed_at_retire": 6},
                "escalation": {"escalated_requests_admitted": 1,
                               "cancelled_for_escalation": 2},
                "admission_wait_ticks": [0, 1, 1, 3]}

    def queued_count(self):
        return 2

    def free_slot_count(self):
        return 3


def test_recorder_script_matches_reference():
    got, want = _script(FlightRecorder), _script(JaxRecorder)
    assert got.flights(include_live=True) == want.flights(include_live=True)
    for rid in range(7):
        assert got.dump(rid) == want.dump(rid), rid
    assert got.stats() == want.stats()
    assert got.latency() == want.latency()
    assert got.events.snapshot() == want.events.snapshot()
    assert got.evicted == want.evicted == 3
    for rec in (got, want):
        with pytest.raises(ValueError, match="terminal kind"):
            rec.on_finish(2, "vanished")
    reg = engine_metrics_into(MetricsRegistry(), _StatsOnly(got),
                              {"member": "0"})
    jreg = jax_metrics_into(JaxRegistry(), _StatsOnly(want),
                            {"member": "0"})
    assert reg.render_text() == jreg.render_text()
    assert reg.render_json() == jreg.render_json()
    evs = trace_events([got, ("named", got)],
                       extra_events=[{"name": "drain", "t": 0.1,
                                      "attrs": {"member": 1}}])
    assert evs == jax_trace_events(
        [want, ("named", want)],
        extra_events=[{"name": "drain", "t": 0.1, "attrs": {"member": 1}}])
    validate_trace_events(evs, require_names=("drain", "chunk", "migrate"))


def test_ring_and_reservoir_bounds():
    """10 flights through a ring of 4 and reservoirs of 4: the ring keeps
    the newest 4, eviction is counted, the reservoirs' lifetime count and
    sum survive it; the event log drops its oldest past maxlen."""
    rec = FlightRecorder(max_flights=4, max_events=8, reservoir=4)
    for rid in range(10):
        rec.on_submit(rid, tick=rid)
        rec.on_admit(rid, lane=0, slot=rid % 2, cohort=0,
                     predicted_depth=1.5, wait_ticks=rid, tick=rid + 2)
        rec.on_chunk(0, t0=float(rid), seconds=0.01, steps=1,
                     entries=[(rid, [7], [1], [0.5])])
        rec.on_finish(rid, "exit", {"n_tokens": 1, "macs": 100.0})
    st = rec.stats()
    assert (st["flights_live"], st["flights_done"],
            st["flights_evicted"]) == (0, 4, 6)
    assert rec.dump(5) is None and rec.dump(6)["terminal"] == "exit"
    lat = rec.latency()
    assert lat["admission_wait_ticks"]["count"] == 10
    assert lat["admission_wait_ticks"]["sum"] == 45.0
    assert lat["admission_wait_ticks"]["p50"] == 7.5    # newest 4: 6..9
    assert len(rec.reservoirs["e2e_seconds"].values()) == 4
    assert st["events"] == 8 and st["events_dropped"] == 2   # 10 chunks
    log = EventLog(maxlen=3)
    for i in range(5):
        log.add("tick", {"i": i})
    assert (len(log), log.dropped, log.counts["tick"]) == (3, 2, 5)


@pytest.mark.parametrize("text", [
    "repro_x_total 3\n",
    'repro_x_total{kind="a",member="0"} 5\n# HELP y z\nrepro_y 1.5e-3\n',
    'repro_lat{quantile="0.5"} 0.2\nrepro_lat_sum 20\nrepro_lat_count 100\n',
    "repro_bad{unclosed 1.0\n",
    'repro_bad{kind=a} 1\n',
    'repro_bad{kind} 1\n',
    "repro_bad\n",
    "repro-bad 1\n",
], ids=lambda t: t.split()[0][:24])
def test_parse_prometheus_matches_reference(text):
    try:
        want = jax_parse(text)
    except ValueError:
        with pytest.raises(ValueError):
            parse_prometheus(text)
        return
    assert parse_prometheus(text) == want


_OK = {"ph": "X", "name": "chunk", "pid": 1, "tid": 0, "ts": 0.0,
       "dur": 1.0, "args": {}}


@pytest.mark.parametrize("events,require", [
    ([_OK], ()),
    ([{**_OK, "ph": "B"}], ()),
    ([{**_OK, "ts": -1.0}], ()),
    ([{**_OK, "dur": -1.0}], ()),
    ([dict(_OK, ph="i")], ()),                   # instant without scope
    ([dict(_OK, ph="i", s="p")], ()),
    ([{**_OK, "pid": "1"}], ()),
    ([{**_OK, "name": ""}], ()),
    ([{**_OK, "args": {"bad": object()}}], ()),
    ([{"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
       "args": {"name": "x"}}], ()),
    ([{"ph": "M", "name": "bogus", "pid": 1, "tid": 0,
       "args": {"name": "x"}}], ()),
    ("not a list", ()),
    ([_OK], ("drain",)),
    ([dict(_OK, name="drain rid=3")], ("drain",)),
])
def test_validate_trace_events_matches_reference(events, require):
    try:
        jax_validate(events, require_names=require)
    except ValueError:
        with pytest.raises(ValueError):
            validate_trace_events(events, require_names=require)
        return
    validate_trace_events(events, require_names=require)


# ---------------------------------------------------------------------------
# the engine's hooks against the reference engine
# ---------------------------------------------------------------------------

def _cfg(pkg="torch", ths=MIXED, layout="dense", obs=True, autotune=None):
    get, red = ((jax_get_config, jax_reduced) if pkg == "jax"
                else (get_config, reduced))
    cfg = red(get("qwen2.5-3b"), n_layers=3).replace(dtype="float32")
    if pkg == "torch":
        cfg = cfg.replace(use_kernels=True)
    cfg = cfg.with_cascade(n_components=3, exit_boundaries=(1, 2),
                           thresholds=ths, exit_mode="cond_batch")
    if layout == "paged":
        cfg = cfg.with_paged_cache(layout="paged", block_size=8)
    if obs:
        cfg = cfg.with_obs()
    if autotune:
        cfg = cfg.with_autotune(enabled=True, **autotune)
    return cfg


@pytest.fixture(scope="module")
def weights():
    jparams = jax_build_model(_cfg("jax")).init(jax.random.PRNGKey(0))
    return jparams, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), _cfg(), device="cpu")


def _prompts(n=N_REQ, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, 6).astype(np.int32) for _ in range(n)]


def _engine(pkg, cfg, params, runtime="host", **kw):
    kw = {**ENGINE_KW, **kw}
    if pkg == "jax":
        return JaxEngine(cfg, jax_build_model(cfg), params, runtime=runtime,
                         **kw)
    return CascadeServingEngine(cfg, build_model(cfg, device="cpu"), params,
                                runtime=runtime, device="cpu", **kw)


def _serve(pkg, cfg, params, runtime="host", n=N_REQ, **kw):
    eng = _engine(pkg, cfg, params, runtime, **kw)
    make = JaxRequest if pkg == "jax" else Request
    for i, p in enumerate(_prompts(n)):
        eng.submit(make(rid=i, prompt=p, max_new_tokens=MAX_NEW))
    eng.run(300)
    return eng


def _terminals(flight):
    return [s for s in flight["spans"] if s["name"] in TERMINAL_KINDS]


def _flight_view(flight):
    """What must agree across packages: span names, each chunk's token
    count and exit components, the terminal and its counts, placement."""
    spans = []
    for s in flight["spans"]:
        a = s["attrs"]
        if s["name"] == "chunk":
            spans.append(("chunk", a["lane"], a["steps"], a["tokens"],
                          a["exit_components"]))
        elif s["name"] in ("prefill", "reprefill"):
            spans.append((s["name"], a["lane"], a["positions"],
                          a["shared_rids"]))
        elif s["name"] == "queue_wait":
            spans.append(("queue_wait", a["wait_ticks"]))
        elif s["name"] == "admit":
            spans.append(("admit", a["lane"], a["slot"], a["cohort"],
                          a["predicted_depth"], a["tick"]))
        else:
            spans.append((s["name"], a.get("n_tokens"),
                          a.get("exit_component_last"),
                          a.get("mean_exit_depth"), a.get("lane"),
                          a.get("slot")))
    return flight["terminal"], spans


def _samples(text):
    """Scrape samples keyed by (name, labels), timing samples dropped (a
    latency summary keeps its count)."""
    out = {}
    for s in parse_prometheus(text):
        timing = "seconds" in s["name"] or "wallclock" in s["name"]
        if timing and not s["name"].endswith("_count"):
            continue
        out[(s["name"], tuple(sorted(s["labels"].items())))] = s["value"]
    return out


@pytest.mark.parametrize("runtime,layout", COMBOS,
                         ids=[f"{r}-{lay}" for r, lay in COMBOS])
def test_engine_flights_match_reference(weights, runtime, layout):
    jparams, params = weights
    want = _serve("jax", _cfg("jax", layout=layout), jparams, runtime)
    got = _serve("torch", _cfg(layout=layout), params, runtime)
    assert {r: (f["tokens"], f["exit_depths"])
            for r, f in got.finished.items()} == {
        r: (f["tokens"], f["exit_depths"]) for r, f in want.finished.items()}
    depths = {d for f in got.finished.values() for d in f["exit_depths"]}
    assert depths == {0, 1, 2}
    assert got.flight.stats()["flights_live"] == 0
    assert len(got.flights()) == N_REQ
    waits = []
    for rid in range(N_REQ):
        g, w = got.dump_flight(rid), want.dump_flight(rid)
        assert _flight_view(g) == _flight_view(w), rid
        assert len(_terminals(g)) == 1 and g["terminal"] == "exit"
        assert g["attrs"]["kernel_backend"] == "torch-cpu"
        assert g["attrs"]["kernel_platform"] == "cpu"
        assert _terminals(g)[0]["attrs"]["macs"] == pytest.approx(
            _terminals(w)[0]["attrs"]["macs"], rel=1e-12)
        # the chunks' tokens and exits are the stream after the first
        # (prefill) token
        chunks = [s["attrs"] for s in g["spans"] if s["name"] == "chunk"]
        fin = got.finished[rid]
        assert sum(c["tokens"] for c in chunks) == len(fin["tokens"]) - 1
        assert [e for c in chunks for e in c["exit_components"]] == \
            fin["exit_depths"][1:]
        waits.append(g["spans"][0]["attrs"]["wait_ticks"])
    # two requests waited for a slot past the first admission tick
    assert sum(w > min(waits) for w in waits) == 2
    assert got.flight.events.counts == want.flight.events.counts
    assert _samples(got.scrape()) == _samples(want.scrape())
    assert got.scrape_json().keys() == want.scrape_json().keys()
    lat = got.latency_stats()
    assert lat["e2e_seconds"]["count"] == N_REQ
    assert lat["tokens_per_request"]["sum"] == N_REQ * MAX_NEW
    assert got.stats()["obs"] == want.stats()["obs"] | {
        "name": got.flight.name}


@pytest.mark.parametrize("runtime,layout", COMBOS,
                         ids=[f"{r}-{lay}" for r, lay in COMBOS])
def test_streams_equal_recorder_on_and_off(weights, runtime, layout):
    """The recorder reads only what each dispatch already fetched: the
    streams, confidences, carried segment counts, host syncs and captures
    are the same with it on and off."""
    _, params = weights
    runs = [_serve("torch", _cfg(layout=layout, obs=obs), params, runtime)
            for obs in (False, True)]
    off, on = runs
    assert off.flight is None and on.flight is not None
    assert on.finished == off.finished
    for key in ("host_syncs", "captures", "decode_dispatches",
                "segments_run", "cohort_dispatch", "decode_tokens"):
        assert on.stats()[key] == off.stats()[key], key
    assert off.stats()["obs"] is None and off.dump_flight(0) is None
    assert off.scrape_json()["repro_requests_finished_total"]["samples"][0][
        "value"] == N_REQ
    assert "repro_request_latency_seconds" not in off.scrape_json()


def test_threshold_push_and_autotune_resolve_events(weights):
    """A controller's resolves land on the engine's event log (pushed or
    held by hysteresis) and every push as ``threshold_push``, the counts
    the reference engine records on the same run."""
    jparams, params = weights
    at = dict(bins=16, shadow_every=2, min_shadow=4, resolve_every=3,
              hysteresis=0.0, epsilon=0.2)
    got = _serve("torch", _cfg(autotune=at), params, "device",
                 autotune=True)
    want = _serve("jax", _cfg("jax", autotune=at), jparams, "device",
                  autotune=True)
    counts = got.flight.events.counts
    assert counts["autotune_resolve"] >= 1
    assert counts["threshold_push"] == got.controller.pushes >= 1
    assert counts == want.flight.events.counts
    pushed = [e["attrs"] for e in got.flight.events.snapshot()
              if e["name"] == "autotune_resolve" and e["attrs"]["pushed"]]
    assert pushed[-1]["thresholds"] == list(got.current_thresholds())
    assert got.current_thresholds() == want.current_thresholds()
    samples = parse_prometheus(got.scrape())
    push = [s for s in samples if s["name"] == "repro_threshold_push_total"]
    assert push[0]["value"] == counts["threshold_push"]


def test_tier_flights_span_both_stages(weights):
    """Every request defers at its first token (escalation threshold 1.1
    over a draft that answers at its final component): a flight on each
    stage, ``escalate`` then ``exit``, annotated with the hop — the
    reference tier's records."""
    jparams, params = weights
    fins = {}
    for pkg, p in (("jax", jparams), ("torch", params)):
        cfg0 = _cfg(pkg, ths=(1.1, 1.1, 0.0)).with_escalation(
            enabled=True, threshold=1.1)
        cfg1 = _cfg(pkg, ths=(1.1, 1.1, 0.0))
        engines = [_engine(pkg, cfg0, p, lane_batch=4, n_lanes=1),
                   _engine(pkg, cfg1, p, lane_batch=4, n_lanes=1)]
        tier = (JaxTier if pkg == "jax" else ModelCascadeTier)(engines)
        make = JaxRequest if pkg == "jax" else Request
        for i, pr in enumerate(_prompts(3)):
            tier.submit(make(rid=i, prompt=pr, max_new_tokens=4))
        tier.run(200)
        fins[pkg] = tier
    got, want = fins["torch"], fins["jax"]
    assert got.stats()["escalations_total"] == 3
    for rid in range(3):
        g, w = got.dump_flight(rid), want.dump_flight(rid)
        assert [d["stage"] for d in g] == [0, 1]
        assert [d["terminal"] for d in g] == ["escalate", "exit"]
        assert [_flight_view(d) for d in g] == [_flight_view(d) for d in w]
        for d in g:
            assert len(_terminals(d)) == 1
        assert g[0]["attrs"]["escalated_to_stage"] == 1
        assert g[1]["attrs"]["escalated_from"] == rid
        for k in ("escalated_to_stage", "deferred_at", "replayed",
                  "committed"):
            assert g[0]["attrs"][k] == w[0]["attrs"][k], k
    assert got.dump_flight(99) is None
    ev = got.engines[0].flight.events
    assert ev.counts["escalate"] == want.engines[0].flight.events.counts[
        "escalate"] == 3


def test_metrics_server_round_trips_over_loopback(weights, tmp_path):
    _, params = weights
    eng = _serve("torch", _cfg(), params, "device", n=3)
    samples = parse_prometheus(eng.scrape())
    names = {s["name"] for s in samples}
    assert {"repro_requests_finished_total", "repro_exit_component_total",
            "repro_request_latency_seconds_count"} <= names
    assert sum(s["value"] for s in samples
               if s["name"] == "repro_exit_component_total") == 3 * MAX_NEW
    with MetricsServer(0, eng.scrape, scrape_json=eng.scrape_json,
                       flights=eng.flights, flight=eng.dump_flight,
                       trace=lambda: trace_events([eng.flight])) as srv:
        base = f"http://127.0.0.1:{srv.port}"

        def get(path):
            return urllib.request.urlopen(base + path, timeout=10).read()

        assert parse_prometheus(get("/metrics").decode()) == samples
        mj = json.loads(get("/metrics.json"))
        assert mj["repro_requests_finished_total"]["type"] == "counter"
        assert len(json.loads(get("/flights"))) == 3
        fl = json.loads(get("/flights/0"))
        assert fl["rid"] == 0 and fl["terminal"] == "exit"
        validate_trace_events(json.loads(get("/trace"))["traceEvents"])
        for path, code in (("/flights/999", 404), ("/flights/x", 400),
                           ("/nowhere", 404)):
            with pytest.raises(urllib.error.HTTPError) as ei:
                get(path)
            assert ei.value.code == code
    doc = export_trace(str(tmp_path / "trace.json"),
                       [("engine", eng.flight)])
    on_disk = json.loads((tmp_path / "trace.json").read_text())
    assert on_disk["traceEvents"] == doc["traceEvents"]
    names = {e["name"] for e in on_disk["traceEvents"]}
    assert any(n.startswith("chunk ") for n in names)
    assert any(n.startswith("exit ") for n in names)
