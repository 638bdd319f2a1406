"""The port's fleet tier (``repro_torch.fleet``) and the engine's and
tier's fleet-member surface, against the JAX package's.

Settings: the scheduler logic runs on the reference test's fake members
(``tests/test_fleet.py``: one token a step, no device work) under both
packages' schedulers, which must place, drain, rescue and finish alike.
The real fleets take that test's engines — ``reduced(qwen2.5-3b)`` in
f32, 2 components, one lane of 2 slots, cache_len 32, six 6-token prompts
— on bridged weights, at thresholds (0.5, 0.0): with random weights every
token answers at the final component, so no exit decision sits on a
rounding edge.  Placements (the member that finished each request),
streams, migrated sets, replay accounting and pushed thresholds must be
identical.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import FleetConfig as JaxFleetConfig
from repro.fleet import EngineHealth as JaxHealth
from repro.fleet import FleetScheduler as JaxFleet
from repro.fleet import TelemetryAggregator as JaxAggregator
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import CascadeServingEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.autotune import load_artifact
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import FleetConfig
from repro_torch.escalate import ModelCascadeTier
from repro_torch.fleet import EngineHealth, FleetScheduler, TelemetryAggregator
from repro_torch.launch import serve
from repro_torch.models.model import build_model
from repro_torch.obs import validate_trace_events
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


BINS = 16
ENGINE_KW = dict(lane_batch=2, n_lanes=1, cache_len=32)
PKGS = {"jax": (JaxFleet, JaxFleetConfig, JaxRequest),
        "torch": (FleetScheduler, FleetConfig, Request)}


# ---------------------------------------------------------------------------
# scheduler logic on the reference's fake members
# ---------------------------------------------------------------------------

class FakeMember:
    """The reference test's minimal member: one token a step, its cancel
    without the ``reason`` keyword (the scheduler's fallback)."""

    def __init__(self, cfg, capacity=4):
        self.cfg = cfg
        self.capacity = capacity
        self.admitting = True
        self.fail = False
        self.queue = []
        self.live = {}
        self.finished = {}

    def submit(self, req):
        self.queue.append(req)

    def step(self):
        if self.fail:
            raise RuntimeError("boom")
        while (self.admitting and self.queue
               and len(self.live) < self.capacity):
            r = self.queue.pop(0)
            self.live[r.rid] = (r, [])
        for rid, (r, toks) in list(self.live.items()):
            toks.append(1000 * rid + len(toks))
            if len(toks) >= r.max_new_tokens:
                self.finished[rid] = self._record(toks, escalated=False)
                del self.live[rid]

    @staticmethod
    def _record(toks, escalated):
        return {"tokens": list(toks), "exit_depths": [0] * len(toks),
                "confs": [1.0] * len(toks), "lane": 0,
                "escalated": escalated}

    def stats(self):
        if self.fail:
            raise RuntimeError("probe boom")
        return {"requests_finished": len(self.finished)}

    def free_slot_count(self):
        return self.capacity - len(self.live)

    def queued_count(self):
        return len(self.queue)

    def live_rids(self):
        return list(self.live)

    def take_queue(self):
        taken, self.queue = self.queue, []
        return taken

    def cancel(self, rid, keep=None):
        if rid in self.live:
            r, toks = self.live.pop(rid)
            toks = toks if keep is None else toks[:keep]
            self.finished[rid] = self._record(toks, escalated=True)
            return self.finished[rid]
        return None


def _fake_fleet(pkg, n=2, capacity=4, **fleet_kw):
    sched, fleet_cfg, _ = PKGS[pkg]
    cfg = (jax_reduced(jax_get_config("qwen2.5-3b")) if pkg == "jax"
           else reduced(get_config("qwen2.5-3b")))
    members = [FakeMember(cfg, capacity=capacity) for _ in range(n)]
    return sched(members, fleet=fleet_cfg(n_engines=n, **fleet_kw)), members


def _submit_fake(pkg, fleet, n, max_new, hints=None):
    make = PKGS[pkg][2]
    for i in range(n):
        extra = ({"predicted_depth": hints[i]} if hints is not None
                 else None)
        fleet.submit(make(rid=i, prompt=np.arange(4, dtype=np.int32),
                          max_new_tokens=max_new, extra=extra))


def _both(scenario):
    """Run ``scenario(pkg)`` under both schedulers; return (port, ref)."""
    return scenario("torch"), scenario("jax")


@pytest.mark.parametrize("signal", ["depth", "load", "depth-and-load"])
def test_placement_on_fakes_matches_reference(signal):
    weights = {"depth": dict(depth_weight=1.0, load_weight=0.0),
               "load": dict(depth_weight=0.0, load_weight=1.0),
               "depth-and-load": dict(depth_weight=1.0, load_weight=0.5)}
    hints = [1.0, 0.0, 1.0, 0.5, 0.0, 1.0, 0.2, 0.9]

    def scenario(pkg):
        fleet, members = _fake_fleet(pkg, capacity=4, block_weight=0.0,
                                     **weights[signal])
        fleet.compactor.lane_stats[0].depth_ema = 0.0
        fleet.compactor.lane_stats[1].depth_ema = 1.0
        _submit_fake(pkg, fleet, 8, 3,
                     hints=None if signal == "load" else hints)
        fleet.step()
        placed = [sorted(m.live) for m in members]
        fleet.run(50)
        return placed, fleet.finished, fleet.stats()["placements"]

    got, want = _both(scenario)
    assert got == want
    if signal == "depth":
        assert got[0] == [[1, 3, 4, 6], [0, 2, 5, 7]]
    if signal == "load":
        assert [len(p) for p in got[0]] == [4, 4]


@pytest.mark.parametrize("mode", ["finish", "migrate"])
def test_drain_on_fakes_matches_reference(mode):
    def scenario(pkg):
        fleet, members = _fake_fleet(pkg, capacity=2)
        _submit_fake(pkg, fleet, 5, 4)
        fleet.step()              # 4 live (2 a member), 1 in the fleet queue
        lived_on_0 = sorted(members[0].live)
        summary = fleet.drain(0, mode=mode)
        fleet.run(50)
        out = (lived_on_0, summary, fleet.finished, sorted(fleet.drained),
               fleet.stats()["events"], fleet.migrations)
        fleet.resume(0)
        return out + (members[0].admitting, sorted(fleet.drained))

    got, want = _both(scenario)
    assert got == want
    lived, summary, finished = got[:3]
    assert sorted(finished) == [0, 1, 2, 3, 4] and got[3] == [0]
    for rid in lived:
        rec = finished[rid]
        assert len(rec["tokens"]) == 4 and rec["tokens"][0] == 1000 * rid
        assert rec["migrations"] == (1 if mode == "migrate" else 0)
    assert summary["migrated"] == (lived if mode == "migrate" else [])
    assert got[-2:] == (True, [])


def test_health_rescue_on_fakes_matches_reference():
    def scenario(pkg):
        fleet, members = _fake_fleet(pkg, capacity=2, max_failures=2,
                                     heartbeat_every=1, backoff_base=2,
                                     backoff_cap=4, load_weight=1.0,
                                     depth_weight=0.0)
        _submit_fake(pkg, fleet, 4, 3)
        members[1].fail = True
        fleet.run(60)
        st = fleet.health.stats()
        rec = {"finished": fleet.finished, "health": st,
               "events": fleet.stats()["events"],
               "healthy": fleet.health.healthy(1)}
        members[1].fail = False
        tick = fleet._tick + st[1]["backoff"] + 1
        rec["recovered"] = fleet.health.beat(1, tick, members[1].stats)
        rec["after"] = fleet.health.summary(1)
        return rec

    got, want = _both(scenario)
    for rec in (got, want):
        for st in rec["health"]:
            st["last_error"] = (st["last_error"] or "")[:12]
        rec["after"]["last_error"] = (rec["after"]["last_error"] or "")[:12]
    assert got == want
    assert sorted(got["finished"]) == [0, 1, 2, 3]
    assert all(r["engine"] == 0 for r in got["finished"].values())
    assert not got["healthy"] and got["health"][1]["unhealthy_marks"] == 1
    assert got["recovered"] is True and got["after"]["healthy"]


def test_health_backoff_matches_reference():
    runs = []
    for health_cls in (EngineHealth, JaxHealth):
        h = health_cls(1, max_failures=3, backoff_base=2, backoff_cap=8)
        trace = [h.beat(0, 0, lambda: 1)]
        for tick in (10, 12, 16, 24):
            h.note_failure(0, tick)
            trace.append((h.states[0].backoff, h.states[0].next_probe_tick,
                          h.states[0].healthy, h.beat(0, tick + 1,
                                                      lambda: 1)))
        trace.append(h.beat(0, 40, lambda: 1))
        trace.append(h.summary(0))
        runs.append(trace)
    assert runs[0] == runs[1]
    assert runs[0][4][:3] == (8, 32, False)          # capped, unhealthy
    assert runs[0][-1]["healthy"] and runs[0][-1]["backoff"] == 0


@pytest.mark.parametrize("kw,match", [
    (dict(drain_mode="teleport"), "drain_mode"),
    (dict(n_engines=0), "n_engines"),
    (dict(depth_weight=-1.0), "depth_weight"),
    (dict(load_weight=-0.5), "load_weight"),
    (dict(heartbeat_every=0), "heartbeat_every"),
    (dict(max_failures=0), "max_failures"),
    (dict(backoff_base=0), "backoff_base"),
    (dict(backoff_cap=0), "backoff_cap"),
])
def test_fleet_config_validation_matches_reference(kw, match):
    for cls in (FleetConfig, JaxFleetConfig):
        with pytest.raises(ValueError, match=match):
            cls(**kw)
    cfg = reduced(get_config("qwen2.5-3b")).with_fleet(
        n_engines=4, drain_mode="migrate")
    assert dataclasses.asdict(cfg.fleet) == dataclasses.asdict(
        jax_reduced(jax_get_config("qwen2.5-3b")).with_fleet(
            n_engines=4, drain_mode="migrate").fleet)


# ---------------------------------------------------------------------------
# real engines: the port's fleet against the reference fleet
# ---------------------------------------------------------------------------

def _cfg(pkg="torch", autotune=False, obs=False, **cascade):
    get, red = ((jax_get_config, jax_reduced) if pkg == "jax"
                else (get_config, reduced))
    cfg = red(get("qwen2.5-3b")).replace(dtype="float32")
    if pkg == "torch":
        cfg = cfg.replace(use_kernels=True)
    cfg = cfg.with_cascade(**{"thresholds": (0.5, 0.0), **cascade})
    if autotune:
        cfg = cfg.with_autotune(enabled=True, bins=BINS, shadow_every=4,
                                min_shadow=8, resolve_every=8)
    if obs:
        cfg = cfg.with_obs()
    return cfg


@pytest.fixture(scope="module")
def weights():
    jparams = jax_build_model(_cfg("jax")).init(jax.random.PRNGKey(0))
    return jparams, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), _cfg(), device="cpu")


def _engine(pkg, cfg, params, **kw):
    kw = {**ENGINE_KW, **kw}
    if pkg == "jax":
        return JaxEngine(cfg, jax_build_model(cfg), params, **kw)
    return CascadeServingEngine(cfg, build_model(cfg, device="cpu"), params,
                                device="cpu", **kw)


def _fleet(pkg, cfg, params, n=2, aggregator=None, **kw):
    return PKGS[pkg][0]([_engine(pkg, cfg, params, **kw) for _ in range(n)],
                        aggregator=aggregator)


def _submit(pkg, fleet, n, max_new=6, seed=3):
    rng = np.random.default_rng(seed)
    make = PKGS[pkg][2]
    for i in range(n):
        fleet.submit(make(rid=i, prompt=rng.integers(0, 512, 6)
                          .astype(np.int32), max_new_tokens=max_new))


def _records(fleet):
    return {rid: (r["tokens"], r["exit_depths"], r["engine"],
                  r["migrations"], r["requeues"], r["discarded_tokens"],
                  r["spans"])
            for rid, r in sorted(fleet.finished.items())}


@pytest.mark.parametrize("runtime", ["host", "device"])
def test_fleet_on_engines_matches_reference(weights, runtime):
    jparams, params = weights
    fleets = {}
    for pkg, p in (("jax", jparams), ("torch", params)):
        fleet = _fleet(pkg, _cfg(pkg), p, runtime=runtime, chunk=4)
        _submit(pkg, fleet, 6, max_new=5)
        fleet.run(200)
        fleets[pkg] = fleet
    got, want = fleets["torch"], fleets["jax"]
    assert _records(got) == _records(want)
    assert sorted(got.finished) == list(range(6))
    assert {r["engine"] for r in got.finished.values()} == {0, 1}
    st, wst = got.stats(), want.stats()
    for k in ("placements", "migrations", "requeues", "discarded_tokens"):
        assert st[k] == wst[k], k
    assert st["placements"] == 6 and st["discarded_tokens"] == 0
    assert [m["depth_ema"] for m in st["members"]] == pytest.approx(
        [m["depth_ema"] for m in wst["members"]], rel=1e-12)


def test_lane_mates_change_a_stream_as_in_the_reference(weights):
    """Why a fleet's streams need not equal one engine's on the same
    requests: a dense lane's prefill left-pads every prompt to the lane's
    longest, and the pad tokens are attended over (the reference's
    semantics), so a request's tokens depend on which prompts share its
    lane.  The smallest case: one 6-token prompt served alone and beside
    a 12-token one — different streams, the same in both packages."""
    jparams, params = weights
    rng = np.random.default_rng(3)
    a, b = (rng.integers(0, 512, n).astype(np.int32) for n in (6, 12))
    streams = {}
    for pkg, p in (("jax", jparams), ("torch", params)):
        make = PKGS[pkg][2]
        for mates in ((), (b,)):
            eng = _engine(pkg, _cfg(pkg), p)
            eng.submit(make(rid=0, prompt=a, max_new_tokens=6))
            for i, m in enumerate(mates):
                eng.submit(make(rid=1 + i, prompt=m, max_new_tokens=6))
            eng.run(100)
            streams[pkg, len(mates)] = eng.finished[0]["tokens"]
    assert streams["torch", 0] == streams["jax", 0]
    assert streams["torch", 1] == streams["jax", 1]
    assert streams["torch", 0] != streams["torch", 1]


@pytest.mark.parametrize("runtime,layout", [("host", "dense"),
                                            ("device", "paged")])
def test_drain_mid_decode_matches_reference(weights, runtime, layout):
    """Drain member 0 three ticks in: the same requests migrate, their
    committed prefixes replay into the sibling (the escalation replay
    accounting), nothing is discarded, every budget is served, and each
    member flight has one terminal."""
    jparams, params = weights
    fleets, prefixes, summaries = {}, {}, {}
    for pkg, p in (("jax", jparams), ("torch", params)):
        cfg = _cfg(pkg, obs=True)
        if layout == "paged":
            cfg = cfg.with_paged_cache(layout="paged", block_size=8)
        fleet = _fleet(pkg, cfg, p, runtime=runtime, chunk=2)
        _submit(pkg, fleet, 6, max_new=8)
        for _ in range(3):
            fleet.step()
        prefixes[pkg] = {s.request.rid: list(s.generated)
                         for ln in fleet.members[0].lanes
                         for s in ln["slots"]
                         if not s.done and s.request is not None}
        summaries[pkg] = fleet.drain(0, mode="migrate")
        fleet.run(300)
        fleets[pkg] = fleet
    got, want = fleets["torch"], fleets["jax"]
    assert prefixes["torch"] == prefixes["jax"] and prefixes["torch"]
    assert summaries["torch"] == summaries["jax"]
    assert summaries["torch"]["migrated"]
    assert _records(got) == _records(want)
    for rid, prefix in prefixes["torch"].items():
        rec = got.finished[rid]
        assert rec["tokens"][:len(prefix)] == prefix
        assert len(rec["tokens"]) == 8 and rec["discarded_tokens"] == 0
    esc = got.members[1].stats()["escalation"]
    wesc = want.members[1].stats()["escalation"]
    assert esc["prefill_positions_replayed"] > 0
    for k in ("escalated_requests_admitted", "prefill_positions_fresh",
              "prefill_positions_replayed"):
        assert esc[k] == wesc[k], k
    assert 0 in got.drained and got.events.counts["drain"] == 1
    for rid in range(6):
        fl = got.dump_flight(rid)
        for m in fl["members"]:
            assert sum(s["name"] in ("exit", "escalate", "migrate",
                                     "cancelled")
                       for s in m["spans"]) == 1
        wfl = want.dump_flight(rid)
        assert [(m["member"], m["terminal"]) for m in fl["members"]] == \
            [(m["member"], m["terminal"]) for m in wfl["members"]]
    for rid in summaries["torch"]["migrated"]:
        fl = got.dump_flight(rid)
        assert sorted(m["terminal"] for m in fl["members"]) == [
            "exit", "migrate"]
    validate_trace_events(got.trace_events(), require_names=("drain",))
    if layout == "paged":
        for m in got.members:
            assert m.stats()["memory"]["blocks_used"] == 0


def test_aggregator_pushes_the_reference_thresholds(weights, tmp_path):
    """One merged solve over both members' telemetry pushes the reference
    aggregator's thresholds to every member (their lanes' device δ̂, no
    capture), its artifact carries fleet provenance, and a member added
    afterwards starts at the fleet's vector."""
    jparams, params = weights
    cas = dict(exit_mode="cond_batch")
    fleets = {}
    for pkg, p in (("jax", jparams), ("torch", params)):
        cfg = _cfg(pkg, autotune=True, **cas)
        agg_cls = JaxAggregator if pkg == "jax" else TelemetryAggregator
        members = [_engine(pkg, cfg, p, runtime="device", chunk=4)
                   for _ in range(2)]
        agg = agg_cls(cfg, members[0].mac_prefix, resolve_every=4,
                      min_shadow=4, hysteresis=0.0,
                      artifact_dir=str(tmp_path / pkg))
        fleet = PKGS[pkg][0](members, aggregator=agg)
        _submit(pkg, fleet, 6, max_new=8)
        fleet.run(300)
        fleets[pkg] = fleet
    got, want = fleets["torch"], fleets["jax"]
    agg = got.aggregator
    assert sorted(got.finished) == list(range(6))
    assert agg.resolves >= 1 and agg.pushes >= 1
    assert (agg.resolves, agg.pushes) == (want.aggregator.resolves,
                                          want.aggregator.pushes)
    ths = got.current_thresholds()
    assert ths == want.current_thresholds() and ths is not None
    assert _records(got) == _records(want)
    for m in got.members:
        assert m.current_thresholds() == ths
        assert m.lanes[0]["state"].thresholds.tolist() == [
            float(np.float32(t)) for t in ths]
        assert m.stats()["captures"] == 0       # a CPU lane captures none
    assert agg.merged_histogram(got).total == sum(
        agg.per_member_shadow(got))
    assert got.events.counts["threshold_push"] == agg.pushes
    assert got.events.counts["autotune_resolve"] == agg.resolves
    art = load_artifact(str(tmp_path / "torch"), _cfg(autotune=True, **cas))
    assert art is not None and art.source == "fleet"
    assert tuple(art.thresholds) == ths
    fresh = _engine("torch", _cfg(autotune=True, **cas), params)
    assert got.add_member(fresh) == 2 and fresh.current_thresholds() == ths
    samples = got.scrape()
    assert "repro_fleet_autotune_pushes_total" in samples


def test_aggregator_refuses_heterogeneous_or_controllered_members(weights):
    _, params = weights
    cfg = _cfg(autotune=True)
    members = [_engine("torch", cfg, params) for _ in range(2)]
    agg = TelemetryAggregator(cfg, members[0].mac_prefix)
    plain = _engine("torch", _cfg(), params)
    with pytest.raises(ValueError, match="autotune disabled"):
        FleetScheduler([members[0], plain], aggregator=agg)
    other = _engine("torch", _cfg(autotune=True, confidence="entropy"),
                    params)
    with pytest.raises(ValueError, match="config_key"):
        FleetScheduler([members[0], other], aggregator=agg)
    own = _engine("torch", cfg, params, autotune=True)
    with pytest.raises(ValueError, match="its own controller"):
        FleetScheduler([members[0], own], aggregator=agg)
    with pytest.raises(ValueError, match="at least one member"):
        FleetScheduler([])


# ---------------------------------------------------------------------------
# the engine's and the tier's member surface
# ---------------------------------------------------------------------------

def test_engine_admitting_gate_take_queue_and_queued_cancel(weights):
    """The reference tests' member hooks on both engines: with admission
    off nothing admits; take_queue hands back the queue in order and
    forgets it (its flights end ``cancelled``); a queued cancel returns an
    empty record; both engines then serve the same streams."""
    jparams, params = weights
    outs = {}
    for pkg, p in (("jax", jparams), ("torch", params)):
        eng = _engine(pkg, _cfg(pkg, obs=True), p)
        make = PKGS[pkg][2]
        for i in range(4):
            eng.submit(make(rid=i, prompt=np.arange(4, dtype=np.int32) + i,
                            max_new_tokens=4))
        eng.admitting = False
        eng.step()
        assert eng.queued_count() == 4 and not eng.live_rids()
        taken = eng.take_queue()
        assert [r.rid for r in taken] == [0, 1, 2, 3]
        assert eng.queued_count() == 0 and not eng._submit_tick
        assert eng.dump_flight(0)["terminal"] == "cancelled"
        eng.admitting = True
        for r in taken:
            eng.submit(r)
        eng.step()
        rec = eng.cancel(3, reason="migrate")
        assert rec == {"tokens": [], "exit_depths": [], "confs": [],
                       "lane": None, "escalated": True}
        assert eng.cancel(99) is None
        eng.run(100)
        outs[pkg] = ({r: f["tokens"] for r, f in eng.finished.items()},
                     eng.free_slot_count(), eng.dump_flight(3)["spans"][-1][
                         "attrs"], eng.flight.stats()["event_counts"])
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][2] == {"queued": True, "reason": "migrate",
                                "n_tokens": 0}


def test_tier_exposes_the_fleet_member_surface(weights):
    _, params = weights
    eng = _engine("torch", _cfg(autotune=True), params)
    tier = ModelCascadeTier([eng])
    assert tier.cfg is eng.cfg
    assert tier.free_slot_count() == 2 and tier.queued_count() == 0
    for i in range(3):
        tier.submit(Request(rid=i, prompt=np.arange(4, dtype=np.int32),
                            max_new_tokens=3))
    tier.admitting = False
    assert not eng.admitting and not tier.admitting
    tier.step()
    assert tier.queued_count() == 3 and tier.live_rids() == []
    taken = tier.take_queue()
    assert [r.rid for r in taken] == [0, 1, 2]
    assert not tier._tracked            # untracked for a fleet requeue
    tier.admitting = True
    for r in taken:
        tier.submit(r)
    tier.step()
    # two slots: rid 2 waits in the entry queue
    assert sorted(tier.live_rids()) == [0, 1] and tier.queued_count() == 1
    assert tier.lane_telemetry() == eng.lane_telemetry()
    tier.push_thresholds((0.25, 0.0))
    assert tier.current_thresholds() == eng.current_thresholds() == (
        0.25, 0.0)
    tier.run(100)
    assert sorted(tier.finished) == [0, 1, 2]
    # a tier is a fleet member: a drain of it degrades to "finish" mode
    fleet = FleetScheduler([tier, ModelCascadeTier(
        [_engine("torch", _cfg(autotune=True), params)])])
    for i in range(10, 14):                 # rids the first tier never saw
        fleet.submit(Request(rid=i, prompt=np.arange(6, dtype=np.int32) + i,
                             max_new_tokens=3))
    fleet.step()
    summary = fleet.drain(0, mode="migrate")
    assert summary["migrated"] == []
    fleet.run(100)
    assert sorted(fleet.finished) == [10, 11, 12, 13]


def test_serve_cli_fleet_drain_obs_trace(tmp_path, capsys):
    trace = tmp_path / "trace.json"
    stats = serve.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
                        "--fleet", "2", "--drain", "--obs", "--trace-out",
                        str(trace), "--flight-dump", "0", "--requests", "6",
                        "--lanes", "1", "--lane-batch", "2", "--max-new",
                        "8"])
    assert stats["requests_finished"] == 6 and stats["n_members"] == 2
    assert stats["discarded_tokens"] == 0 and stats["drained"] == [0]
    assert stats["migrations"] > 0 and stats["events"]["drain"] == 1
    doc = json.loads(trace.read_text())
    validate_trace_events(doc["traceEvents"], require_names=("drain",))
    assert {e["args"]["name"] for e in doc["traceEvents"]
            if e["name"] == "process_name"} == {"fleet", "member0",
                                                 "member1"}
