"""The port's cross-model escalation tier (``repro_torch.escalate``) and
the engine API it drives, against the JAX package's on bridged weights.

Settings: the reference test's stack (``tests/test_escalate.py``) —
``reduced(qwen2.5-3b)`` in f32, a 2-layer draft (seed 0) and a 4-layer
authority (seed 1), 2 components each, one lane of 4 slots, cache_len 32,
chunk 4; four 6-token prompts, 6 new tokens each.  With random weights the
draft answers every token at its final component, so every token passes
the escalation gate.

Token streams, exit streams, escalations, ``final_stage`` and ``spans``
must be identical; confidences agree to 1e-5 (f32 sums in other orders).
The middle escalation threshold lies midway between two neighbouring
sorted confidences of the reference draft's run that are at least 2e-3
apart, so no defer decision sits on a rounding edge.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.autotune.telemetry import init_telemetry as jax_init_telemetry
from repro.autotune.telemetry import merge_telemetry as jax_merge_telemetry
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.escalate import EscalationRouter as JaxRouter
from repro.escalate import ModelCascadeTier as JaxTier
from repro.escalate import TierThresholdController as JaxController
from repro.escalate import build_replay as jax_build_replay
from repro.escalate import prefix_compatible as jax_prefix_compatible
from repro.escalate import resolve_share_prefix as jax_resolve_share_prefix
from repro.models.model import build_model as jax_build_model
from repro.obs.recorder import quantiles as jax_quantiles
from repro.serving.engine import CascadeServingEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.autotune.telemetry import init_telemetry, merge_telemetry
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.escalate import (EscalationRouter, ModelCascadeTier,
                                  TierThresholdController, build_replay,
                                  prefix_compatible, resolve_share_prefix)
from repro_torch.launch import serve
from repro_torch.models.model import build_model
from repro_torch.serving.engine import CascadeServingEngine, Request
from repro_torch.utils import quantiles


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers
    on a few cores, where these small ops gain nothing from more threads
    and would slow the other workers' timed tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CONF_TOL = 1e-5
MARGIN = 1e-3
N_REQ, PROMPT_LEN, MAX_NEW = 4, 6, 6
ENGINE_KW = dict(lane_batch=4, n_lanes=1, cache_len=32, chunk=4)
COMBOS = [("host", "dense"), ("host", "paged"), ("device", "dense"),
          ("device", "paged")]
COMBO_IDS = [f"{r}-{lay}" for r, lay in COMBOS]


class _Side:
    """One framework's half of the stack: draft and authority configs and
    parameters, and how to build its engines (the port's on ``device``)
    and requests."""

    def __init__(self, jax_side, cfgs, params, device="cpu"):
        self.jax = jax_side
        self.cfgs = cfgs
        self.params = params
        self.device = device

    def cfg(self, stage, layout="dense", **autotune):
        cfg = self.cfgs[stage]
        if layout == "paged":
            cfg = cfg.with_paged_cache(layout="paged", block_size=8)
        if autotune:
            cfg = cfg.with_autotune(enabled=True, **autotune)
        return cfg

    def engine(self, cfg, stage, runtime="host", **kw):
        kw = {**ENGINE_KW, **kw}
        if self.jax:
            return JaxEngine(cfg, jax_build_model(cfg), self.params[stage],
                             runtime=runtime, **kw)
        return CascadeServingEngine(cfg, build_model(cfg, device=self.device),
                                    self.params[stage], runtime=runtime,
                                    device=self.device, **kw)

    def request(self, rid, prompt, max_new=MAX_NEW):
        make = JaxRequest if self.jax else Request
        return make(rid=rid, prompt=prompt.copy(), max_new_tokens=max_new)

    def tier(self, **kw):
        return (JaxTier if self.jax else ModelCascadeTier)(**kw)


@pytest.fixture(scope="module")
def stack():
    jcfgs = (jax_reduced(jax_get_config("qwen2.5-3b"))
             .replace(dtype="float32"),
             jax_reduced(jax_get_config("qwen2.5-3b"), n_layers=4)
             .replace(dtype="float32"))
    cfgs = (reduced(get_config("qwen2.5-3b")).replace(dtype="float32"),
            reduced(get_config("qwen2.5-3b"), n_layers=4)
            .replace(dtype="float32"))
    jparams = tuple(jax_build_model(c).init(jax.random.PRNGKey(s))
                    for s, c in enumerate(jcfgs))
    params = tuple(params_from_jax(jax.tree_util.tree_map(np.asarray, p), c,
                                   device="cpu")
                   for p, c in zip(jparams, cfgs))
    return {"jax": _Side(True, jcfgs, jparams),
            "port": _Side(False, cfgs, params)}


def _prompts(n=N_REQ, length=PROMPT_LEN, vocab=512, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, length).astype(np.int32)
            for _ in range(n)]


def _serve_alone(side, stage, runtime="host", layout="dense", cfg=None):
    cfg = cfg or side.cfg(stage, layout)
    eng = side.engine(cfg, stage, runtime)
    for i, p in enumerate(_prompts()):
        eng.submit(side.request(i, p))
    eng.run(200)
    return eng


def _build_tier(side, threshold, runtime="host", layout="dense",
                intra=None, controller=None, share_prefix=None, **autotune):
    cfg0 = side.cfg(0, layout, **autotune)
    if intra is not None:
        cfg0 = cfg0.with_cascade(thresholds=intra)
    cfg0 = cfg0.with_escalation(enabled=True, threshold=threshold,
                                share_prefix=share_prefix)
    if autotune:
        cfg0 = cfg0.with_autotune(route_final=True)
    cfg1 = side.cfg(1, layout, **autotune)
    return side.tier(engines=[side.engine(cfg0, 0, runtime),
                              side.engine(cfg1, 1, runtime)],
                     controller=controller)


def _run_tier(tier, side, prompts=None, max_new=MAX_NEW, ticks=200):
    for i, p in enumerate(prompts if prompts is not None else _prompts()):
        tier.submit(side.request(i, p, max_new))
    return tier.run(ticks)


def _middle_threshold(draft_fin):
    """The midpoint of the two neighbouring sorted draft confidences that
    are at least 2 MARGIN apart and nearest the median, among those at
    which a request defers at a token > 0."""
    c = np.sort([x for r in draft_fin.values() for x in r["confs"]])
    cands = []
    for i in range(1, len(c)):
        if c[i] - c[i - 1] < 2 * MARGIN:
            continue
        th = float((c[i] + c[i - 1]) / 2)
        if any(d is not None and d > 0
               for d in _defer_points(draft_fin, th).values()):
            cands.append((abs(i - len(c) / 2), th))
    assert cands, "no confidence gap of 2e-3 splits the draft's tokens"
    return min(cands)[1]


def _defer_points(draft_fin, th):
    return {rid: next((i for i, c in enumerate(r["confs"]) if c < th), None)
            for rid, r in draft_fin.items()}


def _assert_records_equal(got, want, keys=("tokens", "exit_depths")):
    assert sorted(got) == sorted(want)
    for rid in want:
        for k in keys:
            assert got[rid][k] == want[rid][k], (rid, k)
        np.testing.assert_allclose(got[rid]["confs"], want[rid]["confs"],
                                   atol=CONF_TOL, rtol=CONF_TOL)


def _assert_escalation_equal(got, want):
    for k in ("escalated_requests_admitted", "cancelled_for_escalation",
              "prefill_positions_fresh", "prefill_positions_replayed"):
        assert got[k] == want[k], k
    assert got["replay_prefill_macs"] == pytest.approx(
        want["replay_prefill_macs"], rel=1e-12)
    assert (got["replay_prefill_seconds"] > 0) == (
        want["replay_prefill_seconds"] > 0)


# ---------------------------------------------------------------------------
# the tier against the reference tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("corner,runtime,layout", [
    ("never", "host", "dense"), ("middle", "host", "dense"),
    ("always", "host", "dense"), ("middle", "device", "paged"),
    ("middle-restart", "host", "dense")])
def test_tier_matches_reference(stack, corner, runtime, layout):
    """``middle-restart`` runs the middle threshold with
    ``share_prefix=False``: a request that defers at token d > 0 restarts
    on the authority from its original prompt and budget, its d draft
    tokens discarded (span ``kept=False``)."""
    jside, pside = stack["jax"], stack["port"]
    draft = _serve_alone(jside, 0, runtime, layout).finished
    intra, share = None, None
    if corner == "never":
        th = 0.0
    elif corner == "always":
        th, intra = 1.1, (1.1, 0.0)
    else:
        th = _middle_threshold(draft)
        for r in draft.values():
            assert min(abs(c - th) for c in r["confs"]) >= MARGIN
        if corner == "middle-restart":
            share = False
    want_tier = _build_tier(jside, th, runtime, layout, intra,
                            share_prefix=share)
    want = _run_tier(want_tier, jside)
    got_tier = _build_tier(pside, th, runtime, layout, intra,
                           share_prefix=share)
    got = _run_tier(got_tier, pside)
    _assert_records_equal(got, want, keys=("tokens", "exit_depths",
                                           "escalations", "final_stage",
                                           "spans"))
    ws, gs = want_tier.stats(), got_tier.stats()
    for k in ("requests_finished", "requests_live", "escalations_total",
              "final_stage_histogram", "discarded_draft_tokens",
              "blocks_donated", "router"):
        assert gs[k] == ws[k], k
    for g, w in zip(gs["stages"], ws["stages"]):
        _assert_escalation_equal(g["escalation"], w["escalation"])
        assert g["latency"]["admission_wait_ticks"] == \
            w["latency"]["admission_wait_ticks"]
        assert g["exit_histogram"] == w["exit_histogram"]
    defers = _defer_points(draft, th)
    if corner == "middle":
        # committed prefix = the draft's stream up to the defer point
        assert any(d is not None and d > 0 for d in defers.values())
        for rid, d in defers.items():
            if d is not None:
                assert got[rid]["tokens"][:d] == draft[rid]["tokens"][:d]
                assert got[rid]["spans"][0] == {"stage": 0, "n_tokens": d,
                                                "kept": True}
        esc1 = gs["stages"][1]["escalation"]
        assert esc1["prefill_positions_replayed"] == sum(
            d for d in defers.values() if d is not None)
        assert esc1["escalated_requests_admitted"] == sum(
            d is not None for d in defers.values())
        assert gs["discarded_draft_tokens"] == 0
    elif corner == "middle-restart":
        # the draft's tokens before the defer point are discarded: the
        # authority answers the original prompt with the full budget
        assert any(d is not None and d > 0 for d in defers.values())
        for rid, d in defers.items():
            if d is None:
                assert got[rid]["tokens"] == draft[rid]["tokens"]
                continue
            assert got[rid]["spans"][0] == {"stage": 0, "n_tokens": d,
                                            "kept": False}
            assert got[rid]["final_stage"] == 1
            assert len(got[rid]["tokens"]) == MAX_NEW
        assert gs["discarded_draft_tokens"] == sum(
            d for d in defers.values() if d is not None)
        esc1 = gs["stages"][1]["escalation"]
        assert esc1["prefill_positions_replayed"] == 0
        assert esc1["escalated_requests_admitted"] == sum(
            d is not None for d in defers.values())
    else:
        assert gs["escalations_total"] == (0 if corner == "never"
                                           else N_REQ)


@pytest.mark.parametrize("runtime,layout", COMBOS, ids=COMBO_IDS)
def test_corners_are_the_single_engines(stack, runtime, layout):
    """Escalation threshold 0.0: the tier is the draft alone, bit for bit;
    1.1 with the draft's intra thresholds at 1.1: every request defers at
    its first token with nothing committed, and the tier is the authority
    alone, bit for bit, with nothing replayed."""
    side = stack["port"]
    for th, intra, stage in ((0.0, None, 0), (1.1, (1.1, 0.0), 1)):
        alone = _serve_alone(side, stage, runtime, layout).finished
        tier = _build_tier(side, th, runtime, layout, intra)
        fin = _run_tier(tier, side)
        assert sorted(fin) == sorted(alone) == list(range(N_REQ))
        for rid in alone:
            for k in ("tokens", "exit_depths", "confs"):
                assert fin[rid][k] == alone[rid][k], (th, rid, k)
            assert fin[rid]["final_stage"] == stage
            assert fin[rid]["escalations"] == stage
        st = tier.stats()
        assert st["escalations_total"] == stage * N_REQ
        esc1 = st["stages"][1]["escalation"]
        assert esc1["escalated_requests_admitted"] == stage * N_REQ
        assert esc1["prefill_positions_replayed"] == 0


@pytest.mark.parametrize("runtime,layout", COMBOS, ids=COMBO_IDS)
def test_defer_storm_leaks_no_blocks(stack, runtime, layout):
    """Twelve requests for four slots a stage at the middle threshold:
    cancels, escalated re-admissions and queueing on both stages.  The
    tier finishes everything with its full budget, and both pools (paged)
    end with every block free and no lane's promise outstanding."""
    side = stack["port"]
    th = _middle_threshold(_serve_alone(stack["jax"], 0).finished)
    tier = _build_tier(side, th, runtime, layout)
    fin = _run_tier(tier, side, prompts=_prompts(12, seed=3), ticks=400)
    assert sorted(fin) == list(range(12))
    assert all(len(r["tokens"]) == MAX_NEW for r in fin.values())
    st = tier.stats()
    assert st["escalations_total"] > 0
    assert st["stages"][0]["escalation"]["cancelled_for_escalation"] > 0
    for eng in tier.engines:
        assert not eng.live_rids() and not eng.queue
        if eng.paged:
            pool = eng.pcache.pool
            assert pool.used == 0
            assert pool.free_blocks == pool.num_blocks - 1
            assert eng._promised_blocks() == 0


# ---------------------------------------------------------------------------
# the engine's cancel and scheduler surface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("runtime,layout", COMBOS, ids=COMBO_IDS)
def test_cancel_matches_reference(stack, runtime, layout):
    """Five requests for four slots: after two ticks, cancel a live slot
    keeping one token, the queued request, and an unknown rid; the
    records, the engine surface, the rest of the run and the window
    counters equal the reference's."""
    engines, recs = {}, {}
    for name in ("jax", "port"):
        side = stack[name]
        eng = side.engine(side.cfg(0, layout), 0, runtime)
        for i, p in enumerate(_prompts(5)):
            eng.submit(side.request(i, p))
        eng.step()
        eng.step()
        surface = (eng.free_slot_count(), eng.queued_count(),
                   sorted(eng.live_rids()))
        live = eng.cancel(0, keep=1)
        queued = eng.cancel(4)
        unknown = eng.cancel(99)
        after = (eng.free_slot_count(), eng.queued_count(),
                 sorted(eng.live_rids()))
        eng.run(200)
        engines[name] = eng
        recs[name] = (surface, live, queued, unknown, after)
    (ws, wl, wq, wu, wa), (gs, gl, gq, gu, ga) = recs["jax"], recs["port"]
    assert gs == ws == (0, 1, [0, 1, 2, 3])
    assert ga == wa == (1, 0, [1, 2, 3])
    assert gu is None and wu is None
    assert gq == wq == {"tokens": [], "exit_depths": [], "confs": [],
                        "lane": None, "escalated": True}
    assert len(gl["tokens"]) == 1 and gl["escalated"] and wl["escalated"]
    _assert_records_equal({0: gl}, {0: wl}, keys=("tokens", "exit_depths",
                                                  "lane", "escalated"))
    want, got = engines["jax"], engines["port"]
    _assert_records_equal(got.finished, want.finished,
                          keys=("tokens", "exit_depths", "lane",
                                "escalated"))
    gst, wst = got.stats(), want.stats()
    _assert_escalation_equal(gst["escalation"], wst["escalation"])
    assert gst["escalation"]["cancelled_for_escalation"] == 1
    assert gst["latency"] == wst["latency"]
    assert gst["analytic_speedup"] == pytest.approx(
        wst["analytic_speedup"], rel=1e-12)
    if got.paged:
        assert got.pcache.pool.used == 0


def test_take_queue_matches_reference(stack):
    """Six requests for four slots: after one tick the two still queued
    are taken back; the rest of the run and the admission waits equal the
    reference's."""
    out = {}
    for name in ("jax", "port"):
        side = stack[name]
        eng = side.engine(side.cfg(0), 0)
        for i, p in enumerate(_prompts(6)):
            eng.submit(side.request(i, p))
        before = (eng.free_slot_count(), eng.queued_count())
        eng.step()
        gated = (eng.free_slot_count(), eng.queued_count())
        taken = [r.rid for r in eng.take_queue()]
        eng.run(200)
        out[name] = (before, gated, taken, eng.queued_count(),
                     sorted(eng.finished),
                     eng.stats()["latency"]["admission_wait_ticks"])
    assert out["port"] == out["jax"]
    assert out["port"][:3] == ((4, 6), (0, 2), [4, 5])


@pytest.mark.parametrize("values", [[], [3], [0, 1, 2, 3, 7], [5, 1, 1, 0.5]])
def test_quantiles_pinned_to_reference(values):
    assert quantiles(values) == jax_quantiles(values)


def test_reset_metrics_clears_the_escalation_window(stack):
    side = stack["port"]
    tier = _build_tier(side, 1.1, "host", "paged", (1.1, 0.0))
    _run_tier(tier, side)
    eng = tier.engines[1]
    peak = eng.pcache.pool.peak_used
    assert eng.stats()["escalation"]["escalated_requests_admitted"] == N_REQ
    eng.reset_metrics()
    esc = eng.stats()["escalation"]
    assert all(v == 0 for v in esc.values())
    assert eng.stats()["latency"]["admission_wait_ticks"] is None
    assert eng.pcache.pool.peak_used == peak


# ---------------------------------------------------------------------------
# replay and router copies, pinned to the originals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("committed,max_new,share", [
    ([7, 8], 6, True), ([7, 8], 6, False), ([], 6, True), ([1] * 5, 6, True),
    ([1] * 6, 6, True), ([3], 1, False)])
def test_build_replay_pinned_to_reference(committed, max_new, share):
    prompt = np.arange(5, dtype=np.int32)
    try:
        want = jax_build_replay(prompt, committed, max_new, share)
    except ValueError:
        with pytest.raises(ValueError):
            build_replay(prompt, committed, max_new, share)
        return
    got = build_replay(prompt, committed, max_new, share)
    assert got[0].tolist() == want[0].tolist()
    assert got[0].dtype == want[0].dtype
    assert got[1:] == want[1:]


@pytest.mark.parametrize("other,share", [
    ({}, None), ({"family": "moe"}, None), ({"vocab_size": 256}, None),
    ({}, False), ({}, True), ({"family": "moe"}, True),
    ({"family": "moe"}, False)])
def test_share_resolution_pinned_to_reference(stack, other, share):
    results = []
    for name in ("jax", "port"):
        cfg_a, cfg_b = stack[name].cfgs
        cfg_a = cfg_a.with_escalation(share_prefix=share)
        cfg_b = cfg_b.replace(**other)
        compat = (jax_prefix_compatible if name == "jax"
                  else prefix_compatible)(cfg_a, cfg_b)
        try:
            shared = (jax_resolve_share_prefix if name == "jax"
                      else resolve_share_prefix)(cfg_a, cfg_b)
        except ValueError:
            shared = "raises"
        results.append((compat, shared))
    assert results[0] == results[1]


@pytest.mark.parametrize("threshold", [0.0, 0.6, 1.1])
def test_router_pinned_to_reference(stack, threshold):
    routers = []
    for name, make in (("jax", JaxRouter), ("port", EscalationRouter)):
        cfg_s, cfg_b = stack[name].cfgs
        routers.append(make([cfg_s.with_escalation(enabled=True,
                                                   threshold=threshold),
                             cfg_b]))
    rng = np.random.default_rng(2)
    depths = rng.integers(0, 2, 40).tolist()
    confs = rng.random(40).tolist()
    for r in routers:
        r.observe_regeneration(5, 5)
        r.observe_regeneration(5, 6)
        r.observe_regeneration(1, 1)
    a, b = routers
    for i in range(40):
        assert b.should_defer(0, depths[i], confs[i]) == \
            a.should_defer(0, depths[i], confs[i])
        assert b.should_defer(1, depths[i], confs[i]) is False
        assert b.first_defer(0, depths, confs, start=i) == \
            a.first_defer(0, depths, confs, start=i)
    for kw in ({}, {"prior": 0.3, "min_observations": 4},
               {"min_observations": 3}):
        assert b.stage_agree(**kw) == a.stage_agree(**kw)
    b.set_threshold(0, 0.25)
    a.set_threshold(0, 0.25)
    assert b.stats() == a.stats()
    with pytest.raises(IndexError):
        b.set_threshold(1, 0.5)


def test_router_rejects_mismatched_measure(stack):
    cfg_s, cfg_b = stack["port"].cfgs
    with pytest.raises(ValueError, match="decision-time confidence"):
        EscalationRouter([cfg_s.with_escalation(enabled=True,
                                                confidence="entropy"),
                          cfg_b])


def test_tier_refuses_a_foreign_prompt_vocabulary(stack):
    """Every stage must take the original prompt: a stage with another
    vocabulary is refused, as the reference refuses it."""
    for name in ("jax", "port"):
        side = stack[name]
        cfg1 = side.cfgs[1].replace(vocab_size=256)
        params = (jax_build_model(cfg1).init(jax.random.PRNGKey(1))
                  if side.jax else build_model(cfg1, device="cpu").init(1))
        other = _Side(side.jax, (side.cfgs[0], cfg1),
                      (side.params[0], params))
        with pytest.raises(ValueError, match="vocab_size"):
            side.tier(engines=[side.engine(side.cfgs[0], 0),
                               other.engine(cfg1, 1)])


# ---------------------------------------------------------------------------
# route_final telemetry and the tier controller
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route_final", [False, True])
def test_route_final_telemetry_shapes(route_final):
    for n_m in (2, 3):
        got = init_telemetry(n_m, 8, [1.0] * n_m, route_final=route_final)
        want = jax_init_telemetry(n_m, 8, [1.0] * n_m,
                                  route_final=route_final)
        for f in ("conf_hist", "exit_counts", "mac_weights", "steps",
                  "shadow_count", "shadow_agree", "shadow_steps"):
            assert tuple(getattr(got, f).shape) == \
                tuple(getattr(want, f).shape), f
        r = n_m - 1 + route_final
        assert tuple(got.shadow_agree.shape) == (r, 8 ** r)


AUTOTUNE = dict(epsilon=0.2, bins=8, shadow_every=2)


@pytest.mark.parametrize("runtime", ["host", "device"])
def test_route_final_counts_match_reference(stack, runtime):
    """A draft engine with ``route_final`` telemetry: every counter equals
    the reference's (the final component's confidence is a shadow axis,
    its agree row all ones), and the streams equal those with it off."""
    tels, fins = {}, {}
    for name in ("jax", "port"):
        side = stack[name]
        for rf in (False, True):
            cfg = side.cfg(0, **AUTOTUNE).with_autotune(
                route_final=rf)
            eng = _serve_alone(side, 0, runtime, cfg=cfg)
            fins[name, rf] = eng.finished
            tels[name, rf] = (jax_merge_telemetry if side.jax
                              else merge_telemetry)(eng.lane_telemetry())
    for rf in (False, True):
        want, got = tels["jax", rf], tels["port", rf]
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
    _assert_records_equal(fins["port", True], fins["port", False])
    n_m = 2
    rf = tels["port", True]
    assert rf["shadow_agree"].shape == (n_m, AUTOTUNE["bins"] ** n_m)
    # the final axis agrees with itself on every shadow observation
    assert rf["shadow_agree"][-1].sum() == rf["shadow_steps"] > 0
    assert rf["shadow_count"].sum() == rf["shadow_steps"]


def _controller_tier(side, runtime):
    ctl = (JaxController if side.jax else TierThresholdController)(
        epsilon=0.2, interval=8, min_shadow=4.0, min_escalations=2)
    tier = _build_tier(side, 0.5, runtime, controller=ctl, **AUTOTUNE)
    _run_tier(tier, side, prompts=_prompts(6), max_new=10, ticks=400)
    return tier, ctl


def test_tier_controller_pushes_the_reference_thresholds(stack):
    (jt, jc), (pt, pc) = (_controller_tier(stack[n], "host")
                          for n in ("jax", "port"))
    assert pc.solves == jc.solves >= 1
    assert pc.last_thresholds == jc.last_thresholds
    ths0, esc, ths1 = pc.last_thresholds
    assert pt.engines[0].current_thresholds() == ths0
    assert pt.engines[1].current_thresholds() == ths1
    assert pt.router.thresholds[0] == esc
    assert pc.stats() == jc.stats()
    _assert_records_equal(pt.finished, jt.finished,
                          keys=("tokens", "exit_depths", "final_stage",
                                "spans"))


def test_tier_controller_pushes_into_device_runtime_lanes(stack):
    """On the device runtime the controller's pushes rewrite both engines'
    live δ̂ vectors in place (the card's captures across a push are
    checked by ``chip_smoke.py`` phase "escalate"); a stage 0 without
    route_final telemetry is refused."""
    tier, ctl = _controller_tier(stack["port"], "device")
    assert ctl.solves >= 1
    ths0, _, ths1 = ctl.last_thresholds
    for eng, ths in zip(tier.engines, (ths0, ths1)):
        assert eng.current_thresholds() == ths
        for lane in eng.lanes:
            np.testing.assert_array_equal(
                lane["state"].thresholds.numpy(),
                np.asarray(ths, np.float32))
    with pytest.raises(ValueError, match="route_final"):
        side = stack["port"]
        e0 = side.engine(side.cfg(0, **AUTOTUNE), 0)
        e1 = side.engine(side.cfg(1, **AUTOTUNE), 1)
        ModelCascadeTier([e0, e1],
                         controller=TierThresholdController(epsilon=0.2))


# ---------------------------------------------------------------------------
# soft-cap block donation
# ---------------------------------------------------------------------------

def _pool_states(tier):
    return [(e.pcache.pool.soft_cap, e.pcache.pool.used,
             e.pcache.pool.free_blocks) for e in tier.engines]


def test_donate_blocks_matches_reference(stack):
    out = {}
    for name in ("jax", "port"):
        side = stack[name]
        tier = side.tier(engines=[
            side.engine(side.cfg(0, layout="paged"), 0),
            side.engine(side.cfg(1, layout="paged"), 1)])
        with pytest.raises(ValueError, match="soft caps"):
            tier.donate_blocks(0, 1, 2)
        with pytest.raises(ValueError, match="src == dst"):
            tier.donate_blocks(1, 1, 2)
        tier.engines[0].pcache.pool.set_soft_cap(6)
        tier.engines[1].pcache.pool.set_soft_cap(6)
        steps = [tier.donate_blocks(0, 1, 4), tier.donate_blocks(1, 0, 3),
                 tier.donate_blocks(0, 1, 100)]
        out[name] = (steps, _pool_states(tier),
                     tier.stats()["blocks_donated"])
    assert out["port"] == out["jax"]


def _capped_tier(side, caps, **kw):
    """Stage 0 defers every request at its first token (intra and
    escalation thresholds at 1.1); both pools capped at ``caps``."""
    tier = side.tier(engines=[
        side.engine(side.cfg(0, layout="paged").with_escalation(
            enabled=True, threshold=1.1).with_cascade(
                thresholds=(1.1, 0.0)), 0),
        side.engine(side.cfg(1, layout="paged"), 1)], **kw)
    for eng, cap in zip(tier.engines, caps):
        eng.pcache.pool.set_soft_cap(cap)
    return tier


def test_auto_rebalance_lends_idle_headroom(stack):
    """The authority's cap admits one request; the tier lends the idle
    draft pool's headroom to it ``donate_quantum`` draft blocks a tick,
    priced in bytes (the tier's block budget never grows), until every
    request finishes with its full budget."""
    side = stack["port"]
    e0_blocks = side.engine(side.cfg(1, layout="paged"), 1).pcache \
        .blocks_needed(0, PROMPT_LEN + MAX_NEW)
    tier = _capped_tier(side, (12, e0_blocks), auto_rebalance=True,
                        donate_quantum=2)
    p0, p1 = (e.pcache.pool for e in tier.engines)
    budget = 12 * p0.block_bytes + e0_blocks * p1.block_bytes
    for i, p in enumerate(_prompts()):
        tier.submit(side.request(i, p))
    caps = [(p0.soft_cap, p1.soft_cap)]
    for _ in range(400):
        if not tier._tracked:
            break
        tier.step()
        caps.append((p0.soft_cap, p1.soft_cap))
        assert p0.soft_cap * p0.block_bytes + \
            p1.soft_cap * p1.block_bytes <= budget
        assert p1.used <= p1.soft_cap
    assert sorted(tier.finished) == list(range(N_REQ))
    assert all(len(r["tokens"]) == MAX_NEW for r in tier.finished.values())
    donated = tier.stats()["blocks_donated"]
    assert donated > 0 and caps[-1][1] == e0_blocks + donated
    assert [c[0] for c in caps] == sorted((c[0] for c in caps), reverse=True)
    assert [c[1] for c in caps] == sorted(c[1] for c in caps)
    assert p0.used == p1.used == 0


def test_soft_cap_bounds_the_whole_lane_plan(stack):
    """A repair: the reference checks a whole-lane re-prefill plan against
    the free list alone, so a soft cap (a tier's block budget) that binds
    fails the prefill's allocation; the port checks the plan under the
    cap, keeps the rest queued, and finishes everything."""
    jside, pside = stack["jax"], stack["port"]
    need = pside.engine(pside.cfg(1, layout="paged"), 1).pcache \
        .blocks_needed(0, PROMPT_LEN + MAX_NEW)
    want = _capped_tier(jside, (None, 2 * need))
    for i, p in enumerate(_prompts()):
        want.submit(jside.request(i, p))
    with pytest.raises(AssertionError, match="outgrew its admission plan"):
        want.run(200)
    got = _capped_tier(pside, (None, 2 * need))
    _run_tier(got, pside)
    assert sorted(got.finished) == list(range(N_REQ))
    assert all(len(r["tokens"]) == MAX_NEW for r in got.finished.values())
    assert got.engines[1].pcache.pool.peak_used == 2 * need


# ---------------------------------------------------------------------------
# the serve CLI's tier path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [
    ["--escalate-layers", "1"],
    ["--escalate-arch", "yi-9b", "--escalate-threshold", "0.0"],
    ["--escalate-layers", "4", "--autotune", "--runtime", "device",
     "--chunk", "4", "--cache-layout", "paged", "--max-new", "8"]])
def test_serve_cli_serves_a_tier(flags, capsys):
    stats = serve.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
                        "--requests", "4", *flags])
    assert stats["requests_finished"] == 4
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["final_stage_histogram"] == \
        stats["final_stage_histogram"]
    assert summary["escalations_total"] == stats["escalations_total"]
    if "yi-9b" in flags:
        # threshold 0: the draft answers everything
        assert stats["final_stage_histogram"] == [4, 0]
        assert summary["stages"][1]["arch"] == "yi-9b"
    else:
        assert stats["final_stage_histogram"] == [0, 4]
    if "--autotune" in flags:
        assert summary["controller"]["interval"] == 8


@pytest.mark.parametrize("flags", [["--fleet", "2"], ["--drain"], ["--obs"]])
def test_serve_cli_tier_refuses_later_slices(flags, capsys):
    """The fleet and observability flags beside a tier, as the reference
    takes them (slice 14 ported them): ``--fleet 2`` is refused with the
    reference's message, ``--drain`` serves the tier (a drain needs a
    fleet) and ``--obs`` records both stages' flights."""
    argv = ["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
            "--escalate-layers", "1", "--requests", "4", *flags]
    if "--fleet" in flags:
        with pytest.raises(SystemExit, match="combines with plain engines"):
            serve.main(argv)
        return
    if "--obs" in flags:
        argv += ["--flight-dump", "2"]
    stats = serve.main(argv)
    assert stats["requests_finished"] == 4
    assert stats["final_stage_histogram"] == [0, 4]
    obs = [st["obs"] for st in stats["stages"]]
    if "--obs" in flags:
        # every request escalated: one terminal flight on each stage
        assert [o["flights_done"] for o in obs] == [4, 4]
        assert [o["flights_live"] for o in obs] == [0, 0]
        assert obs[0]["event_counts"]["escalate"] == 4
    else:
        assert obs == [None, None]
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["final_stage_histogram"] == [0, 4]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels and captured graphs run "
                    "only there")
    from repro_torch.utils import resolve_device
    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("runtime,layout", COMBOS, ids=COMBO_IDS)
def test_tier_on_card_equals_the_cpu(stack, cuda_device, runtime, layout):
    """Two engines on one card: the tier at the middle threshold gives
    the CPU tier's token and exit streams and escalation records, and a
    device runtime captures once per lane and engine."""
    from repro_torch.models import nn
    side = stack["port"]
    th = _middle_threshold(_serve_alone(stack["jax"], 0).finished)
    want = _run_tier(_build_tier(side, th, runtime, layout), side)
    card = _Side(False, side.cfgs,
                 tuple(nn.tree_map(lambda x: x.to(cuda_device), p)
                       for p in side.params), device=cuda_device)
    tier = _build_tier(card, th, runtime, layout)
    got = _run_tier(tier, card)
    _assert_records_equal(got, want, keys=("tokens", "exit_depths",
                                           "escalations", "final_stage",
                                           "spans"))
    if runtime == "device":
        for eng in tier.engines:
            assert eng.stats()["captures"] == 1
