"""Multi-rank MoE serving: the moe family's device decode loop over a
``(data, model)`` mesh of 2 and 4 ranks, against the JAX package.

Ranks are processes spawned here (the pool pattern of
``tests/test_torch_multirank.py``; what each runs is in
``tests/_multirank_ranks.py``, which imports no JAX).  The config is
``reduced(mixtral-8x7b)`` at 3 layers in f32 (d 256, 4 / 1 heads, d_ff
512, top 2) with 4 experts (expert parallel on a ``model`` axis of 2: 2
experts a rank) or 3 (the fallback: every expert's d_ff cut in two), at
capacity factor 0.5, so that prefill drops pairs; ``GROUP_TOKENS`` is 16
in both packages (set in the rank processes and here), so that routing
groups straddle the data ranks' rows.

* ``moe_apply`` alone: each rank's shards and data rows, the call routed
  as one over the data ranks, against the JAX package's ``moe_apply``
  within ``MOE_TOL`` (1e-5: f32 products summed in other orders — the
  partial combines summed over ``model``, the d_ff halves);
* the port's engine on the device runtime against the JAX engine on one
  device: tokens, exits, the carried ``segments_run`` and every telemetry
  counter exactly, confidences within ``CONF_TOL`` (1e-5), on ``1 x 2``
  (both expert layouts), ``2 x 1`` and ``2 x 2`` in select mode with 2
  cohorts, ``2 x 2`` in cond_batch with one cohort of a lane of 8 (split
  over the data ranks; decode routes 8 rows, where capacity binds), and
  ``4 x 1`` in cond_batch with 2 cohorts of a lane of 16 (each split over
  a block of 2 data ranks: the transport's ``data/2`` axis).

Every lane is full (as many requests as slots, one budget): capacity
couples the rows routed together, and a dead slot's decode attention is a
zero row with the kernels on (in both packages) but computed with them
off, so a lane with dead slots parts the port's kernel path from the
reference's plain one.
"""
import os

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.autotune import merge_telemetry as jax_merge
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import moe as jax_moe
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import CascadeServingEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.configs import get_config, reduced

import _multirank_ranks as ranks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers
    on a few cores, where these small ops gain nothing from more threads
    and would slow the other workers' timed tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MOE_TOL = 1e-5
CONF_TOL = 1e-5
GROUP = 16
CF = 0.5
# a component-0 / 1 threshold inside the decode confidences' spread at
# these weights (0.012 .. 0.048): exits at every component
TH = (0.023, 0.023, 0.0)
BUDGET = 8
RANK_TIMEOUT = 120
# name -> (experts, exit mode, cohorts, engine)
SERVES = {
    "select": (4, "select", 2, dict(lane_batch=4, n_lanes=2)),
    "fallback": (3, "select", 2, dict(lane_batch=4, n_lanes=2)),
    "lane8": (4, "cond_batch", 1, dict(lane_batch=8, n_lanes=1)),
    "lane16": (4, "cond_batch", 2, dict(lane_batch=16, n_lanes=1)),
}
ENGINE = dict(cache_len=32, chunk=4)


@pytest.fixture(scope="module")
def pool():
    """Four rank processes, spawned once for the module and fed one task a
    mesh."""
    ctx = mp.get_context("spawn")
    tasks = [ctx.Queue() for _ in range(4)]
    results = ctx.Queue()
    procs = [ctx.Process(target=ranks.serve_tasks, daemon=True,
                         args=(r, tasks[r], results)) for r in range(4)]
    for p in procs:
        p.start()
    yield tasks, results
    for q in tasks:
        q.put(None)
    for p in procs:
        p.join(timeout=10)
        if p.is_alive():
            p.kill()


def _spawn(pool, tmp_path, sizes, target, args):
    """``target`` on every rank of a ``sizes`` mesh; the ranks' results in
    rank order (an error or a rank past RANK_TIMEOUT fails the test)."""
    tasks, results = pool
    world = sizes[0] * sizes[1]
    init = os.path.join(str(tmp_path), f"store_{sizes[0]}x{sizes[1]}")
    for r in range(world):
        tasks[r].put((target, sizes, init, args))
    got = [results.get(timeout=RANK_TIMEOUT) for _ in range(world)]
    errors = [e for _, _, e in got if e is not None]
    assert not errors, errors[0]
    return [ranks.load(res) for _, res, _ in sorted(got, key=lambda g: g[0])]


def _cfg(pkg="torch", experts=4, mode="select", cohorts=2):
    get, red = ((jax_get_config, jax_reduced) if pkg == "jax"
                else (get_config, reduced))
    cfg = red(get("mixtral-8x7b"), n_layers=3).replace(
        dtype="float32", n_experts=experts, capacity_factor=CF)
    if pkg == "torch":
        cfg = cfg.replace(use_kernels=True)
    cfg = cfg.with_cascade(n_components=3, exit_boundaries=(1, 2),
                           thresholds=TH, cohort_layout="major",
                           exit_mode=mode, n_cohorts=cohorts)
    return cfg.with_autotune(enabled=True, bins=256, shadow_every=2,
                             min_shadow=8, resolve_every=4)


def _expert_shard(experts, M, d_ff=512):
    """A rank's (experts, d_ff columns) on a ``model`` axis of M: E/M
    experts where M divides E, else every expert's d_ff/M."""
    if M == 1:
        return experts, d_ff
    return (experts // M, d_ff) if experts % M == 0 else (experts, d_ff // M)


def _prompts(n):
    rng = np.random.default_rng(3)
    return [rng.integers(0, 512, 6).astype(np.int32) for _ in range(n)]


def _n_requests(kw):
    """A request a slot of every lane."""
    return kw["lane_batch"] * kw["n_lanes"]


@pytest.fixture(scope="module")
def group16():
    """The reference's routing groups at 16 tokens while the module runs
    (the ranks set the port's)."""
    mp_ = pytest.MonkeyPatch()
    mp_.setattr(jax_moe, "GROUP_TOKENS", GROUP)
    yield
    mp_.undo()


@pytest.fixture(scope="module")
def weights(group16):
    """The reference's seed-0 init for 4 and 3 experts, as numpy."""
    made = {}

    def get(experts):
        if experts not in made:
            jcfg = _cfg("jax", experts)
            made[experts] = jax.tree_util.tree_map(
                np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
        return made[experts]
    return get


@pytest.fixture(scope="module")
def reference(weights):
    """The JAX engine on the device runtime for each serve (made at first
    use) and its merged telemetry."""
    made = {}

    def get(name):
        if name not in made:
            experts, mode, cohorts, kw = SERVES[name]
            jcfg = _cfg("jax", experts, mode, cohorts)
            eng = JaxEngine(jcfg, jax_build_model(jcfg), weights(experts),
                            runtime="device", **kw, **ENGINE)
            for i, p in enumerate(_prompts(_n_requests(kw))):
                eng.submit(JaxRequest(rid=i, prompt=p, max_new_tokens=BUDGET))
            eng.run(max_ticks=200)
            made[name] = (eng, jax_merge(eng.lane_telemetry()))
        return made[name]
    return get


# ---------------------------------------------------------------------------
# moe_apply on the shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes,experts", [
    ((1, 2), 4), ((1, 2), 3), ((2, 1), 4), ((2, 2), 4)],
    ids=["1x2-expert-parallel", "1x2-fallback", "2x1", "2x2"])
def test_moe_apply_on_shards_matches_reference(pool, tmp_path, weights,
                                               sizes, experts):
    """3 rows of 10 tokens a data rank (groups of 16 straddle the ranks'
    rows; the last padded), at capacity factor 0.5 (pairs drop): every
    rank's rows equal the reference's ``moe_apply`` over the whole batch
    within MOE_TOL, and the model ranks of a data block agree bit for bit.
    A rank holds E/2 experts (expert parallel) or d_ff/2 columns (the
    fallback); a layer makes one all-reduce over ``model`` and, with its
    rows split over ``data``, one all-gather over it."""
    D, M = sizes
    jcfg = _cfg("jax", experts)
    layer = {k: v[0] for k, v in weights(experts)["segments"][0][0]["moe"]
             .items() if k != "norm"}
    x = np.random.default_rng(11).standard_normal(
        (3 * D, 10, jcfg.d_model)).astype(np.float32)
    want, _ = jax.jit(lambda p, x: jax_moe.moe_apply(p, jcfg, x))(layer, x)
    want = np.asarray(want)
    res = _spawn(pool, tmp_path, sizes, ranks.moe_apply_case,
                 (_cfg(experts=experts), layer, x, GROUP))
    for r, got in enumerate(res):
        di = r // M
        np.testing.assert_allclose(got["out"].numpy(),
                                   want[3 * di:3 * (di + 1)], rtol=MOE_TOL,
                                   atol=MOE_TOL)
        assert torch.equal(got["out"], res[di * M]["out"])
        E, ff = _expert_shard(experts, M, jcfg.d_ff)
        assert got["w_up"] == (E, jcfg.d_model, ff)
        assert got["w_down"] == (E, ff, jcfg.d_model)
        assert got["router"] == (jcfg.d_model, experts)       # replicated
        calls = got["op_calls"]
        assert calls.get("model/sum", 0) == (M > 1)
        assert calls.get("data/gather", 0) == (D > 1)
        assert not {k for k in calls if k not in ("model/sum",
                                                  "data/gather")}
        # the whole batch's 30·D tokens routed as one call, some pair
        # dropped
        (n, dropped), = got["drops"]
        assert n == 30 * D and dropped > 0


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes,name", [
    ((1, 2), "select"), ((1, 2), "fallback"), ((2, 1), "select"),
    ((2, 2), "select"), ((2, 2), "lane8"), ((4, 1), "lane16")],
    ids=["1x2", "1x2-fallback", "2x1", "2x2", "2x2-cond_batch-lane8",
         "4x1-cond_batch-lane16"])
def test_multirank_moe_engine_matches_reference_engine(pool, tmp_path,
                                                       reference, weights,
                                                       sizes, name):
    """Every rank's engine gives the JAX engine's streams, carried
    segments_run and telemetry; a rank holds its data rows and its expert
    shard; prefill dropped pairs (and decode, where a call routes 8 rows);
    the MoE layers made their all-reduces over ``model``, and routing
    gathers over ``data`` (or its blocks of 2) only where a call's rows
    are split over data ranks: one gather a layer per such call (grad
    mode is on, but serving's params need no gradient, so no aux
    gather)."""
    experts, mode, cohorts, kw = SERVES[name]
    jeng, jtel = reference(name)
    res = _spawn(pool, tmp_path, sizes, ranks.moe_serve_case, (
        _cfg(experts=experts, mode=mode, cohorts=cohorts), weights(experts),
        _prompts(_n_requests(kw)), BUDGET, {**kw, **ENGINE}, GROUP))
    want = jeng.finished
    jcarried = np.sum([np.asarray(ln["state"].segments_run)
                       for ln in jeng.lanes], axis=0).tolist()
    D, M = sizes
    for r in res:
        assert sorted(r["finished"]) == sorted(want) == list(
            range(_n_requests(kw)))
        for rid, (toks, exits, confs) in r["finished"].items():
            assert toks == want[rid]["tokens"], rid
            assert exits == want[rid]["exit_depths"], rid
            np.testing.assert_allclose(confs, want[rid]["confs"],
                                       atol=CONF_TOL, rtol=CONF_TOL)
        assert r["carried"] == jcarried
        assert jtel.keys() == r["telemetry"].keys()
        for k in jtel:
            np.testing.assert_array_equal(np.asarray(jtel[k]),
                                          r["telemetry"][k], err_msg=k)
        assert r["local_batch"] == kw["lane_batch"] // D
        E, ff = _expert_shard(experts, M)
        assert r["w_up"][-3:] == (E, 256, ff)      # (layers, E, d, ff)
        # the calls that routed more rows than a lane's: the prefills
        pre = [d for n, d in r["drops"] if n > kw["lane_batch"]]
        assert pre and any(pre), r["drops"]
        if kw["lane_batch"] == 8:
            assert any(d for n, d in r["drops"] if n == 8)
        calls = r["op_calls"]
        assert (calls.get("model/sum", 0) > 0) == (M > 1)
        assert not any("all_to_all" in k for k in calls)
        assert (calls.get("data/gather", 0) > 0) == (D > 1)
        assert (calls.get("data/2/gather", 0) > 0) == (D == 4)
        # a call split over data ranks makes one gather over them (its
        # chosen experts) and nothing else there: serving reads no aux
        assert bool(r["split"]) == (D > 1)
        assert all(s == {"gather": 1} for s in r["split"]), r["split"]
    depths = [e for _, e, _ in res[0]["finished"].values()]
    assert {0, 2} <= set(np.concatenate(depths).tolist())
