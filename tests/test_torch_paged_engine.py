"""The port's paged serving path as a whole: its CascadeServingEngine with
``cache_layout="paged"`` against the JAX package's, on bridged weights and
the same requests, and the port's serve CLI.

Settings: ``reduced(qwen2.5-3b)`` (2 layers, 2 components), f32, block
size 8, 2 lanes of 2 slots — the settings of the JAX package's
``tests/test_paged_cache.py``.  Token streams, exit streams,
``segments_run``, the pool's counters and the admission waits must be
identical; at thresholds (0.6, 0.0) every token answers at the final
component and at (0, 0) at component 0, so no exit decision sits on a
rounding edge.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models.model import build_model as jax_build_model
from repro.serving import CascadeServingEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
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


MEMORY_KEYS = ("num_blocks", "block_size", "block_bytes", "blocks_free",
               "blocks_used", "peak_blocks_used", "reclaimed_by_exit",
               "reclaimed_at_retire", "blocks_reclaimed_per_chunk",
               "peak_cache_bytes", "dense_slab_bytes", "cache_layout")


def _cfg(pkg, paged=True, num_blocks=0, **cascade):
    get, red = ((jax_get_config, jax_reduced) if pkg == "jax"
                else (get_config, reduced))
    cfg = red(get("qwen2.5-3b")).replace(dtype="float32").with_cascade(
        **cascade)
    if paged:
        cfg = cfg.with_paged_cache(layout="paged", block_size=8,
                                   num_blocks=num_blocks)
    return cfg


@pytest.fixture(scope="module")
def weights():
    jcfg = _cfg("jax", paged=False)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return jparams, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), _cfg("torch"),
        device="cpu")


def _requests(n, seed=0, max_new=4, plen=(2, 7)):
    """(rid, prompt, budget) triples; ``max_new`` may be a tuple of budgets
    taken in turn."""
    rng = np.random.default_rng(seed)
    news = max_new if isinstance(max_new, tuple) else (max_new,)
    return [(i, rng.integers(1, 50, size=rng.integers(*plen))
             .astype(np.int32), news[i % len(news)]) for i in range(n)]


def _serve(pkg, cfg, params, reqs, max_ticks=400, **kw):
    kw.setdefault("lane_batch", 2)
    kw.setdefault("n_lanes", 2)
    kw.setdefault("cache_len", 32)
    if pkg == "jax":
        eng = JaxEngine(cfg, jax_build_model(cfg), params, **kw)
        make = JaxRequest
    else:
        eng = CascadeServingEngine(cfg, build_model(cfg, device="cpu"),
                                   params, device="cpu", **kw)
        make = Request
    for rid, prompt, n in reqs:
        eng.submit(make(rid=rid, prompt=prompt.copy(), max_new_tokens=n))
    return eng.run(max_ticks=max_ticks), eng.stats()


def _streams(fin):
    return {rid: (r["tokens"], r["exit_depths"]) for rid, r in fin.items()}


def _assert_matches_reference(got, want):
    (gfin, gst), (wfin, wst) = got, want
    assert _streams(gfin) == _streams(wfin)
    assert gst["segments_run"] == wst["segments_run"]
    assert gst["admission_wait_ticks"] == wst["admission_wait_ticks"]
    assert gst["admission_wait_mean"] == wst["admission_wait_mean"]
    for key in MEMORY_KEYS:
        assert gst["memory"][key] == wst["memory"][key], key


@pytest.mark.parametrize("measure,exit_mode,kernels,ths", [
    ("softmax_max", "select", False, (0.6, 0.0)),
    ("softmax_max", "cond_batch", False, (0.6, 0.0)),
    ("patience@2", "select", False, (0.6, 0.0)),
    ("patience@2", "cond_batch", False, (0.6, 0.0)),
    ("softmax_max", "cond_batch", True, (0.6, 0.0)),
    ("patience@2", "select", True, (0.6, 0.0)),
    ("softmax_max", "cond_batch", False, (0.0, 0.0)),
    ("patience@2", "select", True, (0.0, 0.0)),
])
def test_paged_engine_matches_reference(weights, measure, exit_mode,
                                        kernels, ths):
    """At capacity (every request admitted by whole-lane prefill): the
    port's paged engine gives the JAX paged engine's streams, segment
    counters, pool counters and waits, and its own dense engine's
    streams."""
    jparams, params = weights
    cascade = dict(thresholds=ths, confidence=measure, exit_mode=exit_mode,
                   n_cohorts=2)
    reqs = _requests(4, seed=3)
    jcfg = _cfg("jax", **cascade).replace(use_kernels=kernels,
                                          kernel_interpret=True)
    cfg = _cfg("torch", **cascade).replace(use_kernels=kernels)
    want = _serve("jax", jcfg, jparams, reqs)
    got = _serve("torch", cfg, params, reqs)
    _assert_matches_reference(got, want)
    assert len(got[0]) == 4 and got[1]["memory"]["blocks_used"] == 0
    # a slot's deep blocks come back by exit only when none of its tokens
    # (the prefill's included) answered at the final component: softmax_max
    # at threshold 0; never under patience@2 (the prefill's streak is 1)
    assert (got[1]["memory"]["reclaimed_by_exit"] > 0) == (
        ths[0] == 0.0 and measure == "softmax_max")
    dense, dense_st = _serve("torch", _cfg("torch", paged=False, **cascade)
                             .replace(use_kernels=kernels), params, reqs)
    assert _streams(dense) == _streams(got[0])
    # one block id is priced across every segment's planes (as in the
    # reference), so the paged "dense-equivalent" slab is K = 2 dense slabs
    assert 2 * dense_st["memory"]["peak_cache_bytes"] == \
        got[1]["memory"]["dense_slab_bytes"]


def test_continuous_admission_matches_reference(weights):
    """Over-capacity traffic with unequal budgets: slots free while their
    lane still decodes, and queued requests join those live lanes by
    single-slot prefill.  Streams, waits and pool counters equal the JAX
    engine's."""
    jparams, params = weights
    cascade = dict(thresholds=(0.6, 0.0), exit_mode="cond_batch")
    reqs = _requests(10, seed=1, max_new=(3, 7), plen=(2, 4))
    want = _serve("jax", _cfg("jax", **cascade), jparams, reqs,
                  cache_len=64)
    got = _serve("torch", _cfg("torch", **cascade), params, reqs,
                 cache_len=64)
    _assert_matches_reference(got, want)
    fin, st = got
    assert len(fin) == 10
    assert all(len(fin[rid]["tokens"]) == n for rid, _, n in reqs)
    assert st["slot_prefills"] >= 1
    assert st["memory"]["blocks_used"] == 0


def test_continuous_admission_leaves_siblings_untouched(weights):
    """A late arrival admitted into a live lane's freed slot does not
    perturb the co-resident streams (no whole-lane re-prefill)."""
    _, params = weights
    cfg = _cfg("torch", thresholds=(0.6, 0.0), exit_mode="cond_batch")
    first = _requests(4, seed=9, max_new=(2, 8), plen=(2, 4))

    def run(late):
        eng = CascadeServingEngine(cfg, build_model(cfg, device="cpu"),
                                   params, lane_batch=2, n_lanes=2,
                                   cache_len=64, device="cpu")
        for rid, p, n in first:
            eng.submit(Request(rid=rid, prompt=p.copy(), max_new_tokens=n))
        eng.step()                     # admit + prefill the first wave
        eng.step()                     # budget-2 slots finish
        if late:
            eng.submit(Request(rid=99, prompt=np.array([7, 8, 9], np.int32),
                               max_new_tokens=3))
        eng.run(200)
        return eng.finished, eng.stats()

    alone, _ = run(False)
    mixed, st = run(True)
    assert st["slot_prefills"] == 1 and st["prefills"] == 2
    assert len(mixed[99]["tokens"]) == 3
    for rid, _, _ in first:
        assert alone[rid]["tokens"] == mixed[rid]["tokens"], rid
        assert alone[rid]["exit_depths"] == mixed[rid]["exit_depths"], rid


def test_pool_exhaustion_backpressures_like_reference(weights):
    """A pool for half the slots delays admission but every request
    finishes with its full budget, with the JAX engine's waits and
    counters, and the peak never passes the pool."""
    jparams, params = weights
    cascade = dict(thresholds=(0.6, 0.0), exit_mode="cond_batch")
    nb = 2 * 2 * 4 + 1
    reqs = _requests(8, seed=2, max_new=4)
    want = _serve("jax", _cfg("jax", num_blocks=nb, **cascade), jparams,
                  reqs)
    got = _serve("torch", _cfg("torch", num_blocks=nb, **cascade), params,
                 reqs)
    _assert_matches_reference(got, want)
    fin, st = got
    assert sorted(len(r["tokens"]) for r in fin.values()) == [4] * 8
    assert st["memory"]["blocks_used"] == 0
    assert max(st["admission_wait_ticks"]) > 0
    assert st["memory"]["peak_blocks_used"] <= nb - 1


def test_infeasible_request_raises(weights):
    _, params = weights
    cfg = _cfg("torch", num_blocks=5, thresholds=(0.6, 0.0))
    eng = CascadeServingEngine(cfg, build_model(cfg, device="cpu"), params,
                               lane_batch=2, n_lanes=2, cache_len=32,
                               device="cpu")
    # spans the whole 32-position ring: 4 blocks x 2 components = 8 > 4
    eng.submit(Request(rid=0, prompt=np.arange(1, 5, dtype=np.int32),
                       max_new_tokens=40))
    with pytest.raises(ValueError, match="never fit"):
        eng.run(10)


@pytest.mark.parametrize("exit_mode,layout,megakernel", [
    ("cond_batch", "major", True),
    ("cond_batch", "copy", False),
    ("select", "major", True),
    ("select", "copy", False),
])
def test_dense_equals_paged_in_port(weights, exit_mode, layout, megakernel):
    """Inside the port, with the kernel route, 2 cohorts and the megakernel
    (and cohort scatter) on or off: paged streams equal dense streams at
    both ends of the threshold range."""
    _, params = weights
    reqs = _requests(4, seed=5)
    for ths in ((0.6, 0.0), (0.0, 0.0)):
        fins = []
        for paged in (False, True):
            cfg = _cfg("torch", paged=paged, thresholds=ths,
                       exit_mode=exit_mode, n_cohorts=2,
                       cohort_layout=layout).replace(
                use_kernels=True).with_kernel_tune(
                megakernel=megakernel, cohort_scatter=megakernel)
            fins.append(_streams(_serve("torch", cfg, params, reqs)[0]))
        assert fins[0] == fins[1], ths


def test_serve_cli_paged_on_cpu():
    stats = serve.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
                        "--cache-layout", "paged", "--cohorts", "2",
                        "--exit-mode", "cond_batch", "--requests", "6",
                        "--max-new", "4"])
    assert stats["requests_finished"] == 6
    assert stats["cache_layout"] == "paged"
    assert stats["memory"]["blocks_used"] == 0
    assert stats["n_cohorts"] == 2 and stats["use_kernels"]
    dense = serve.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
                        "--requests", "2"])
    assert dense["cache_layout"] == "dense"


def test_serve_cli_device_runtime_on_cpu():
    stats = serve.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
                        "--runtime", "device", "--chunk", "4",
                        "--requests", "4", "--max-new", "6"])
    assert stats["requests_finished"] == 4
    assert stats["runtime"] == "device" and stats["chunk"] == 4


@pytest.mark.parametrize("flags", [["--drain"],
                                   ["--metrics-port", "0"],
                                   ["--fleet", "2"], ["--obs"],
                                   ["--trace-out", "x.json"]])
def test_serve_cli_refuses_later_slices(flags, tmp_path):
    """The fleet and observability flags on the paged layout, which
    slice 14 ported (they were refused before): ``--drain`` and
    ``--fleet 2`` serve a two-engine fleet, the others one engine with
    the flight recorder on (``--metrics-port 0`` round-trips a scrape on
    a free loopback port, ``--trace-out`` writes a valid trace)."""
    flags = [str(tmp_path / f) if f.endswith(".json") else f for f in flags]
    stats = serve.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
                        "--cache-layout", "paged", "--requests", "4",
                        *flags])
    assert stats["requests_finished"] == 4
    if "--drain" in flags or "--fleet" in flags:
        assert stats["n_members"] == 2 and stats["discarded_tokens"] == 0
        assert ("drain" in stats["events"]) == ("--drain" in flags)
        return
    assert stats["obs"]["flights_done"] == 4
    assert stats["cache_layout"] == "paged"
    if "--trace-out" in flags:
        doc = json.loads((tmp_path / "x.json").read_text())
        validate_trace_events(doc["traceEvents"])


def test_two_lane_plans_never_promise_the_same_blocks(weights):
    """Two lanes planned in one tick whose re-prefills together need more
    blocks than the pool holds.  The reference checks each plan against
    the free list alone, so both are admitted and the second prefill's
    allocation fails; the port books the first lane's promise, admits the
    rest later, and finishes everything with its full budget."""
    jparams, params = weights
    cascade = dict(thresholds=(0.6, 0.0), exit_mode="cond_batch")
    nb = 3 * 2 * 4 + 1                  # three slots' worth of 8 blocks
    reqs = _requests(4, seed=4, max_new=20, plen=(5, 7))
    with pytest.raises(AssertionError, match="outgrew"):
        _serve("jax", _cfg("jax", num_blocks=nb, **cascade), jparams, reqs)
    fin, st = _serve("torch", _cfg("torch", num_blocks=nb, **cascade),
                     params, reqs)
    assert sorted(len(r["tokens"]) for r in fin.values()) == [20] * 4
    assert max(st["admission_wait_ticks"]) > 0
    assert st["memory"]["peak_blocks_used"] <= nb - 1
    assert st["memory"]["blocks_used"] == 0
