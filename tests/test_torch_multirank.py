"""Multi-rank serving: the dense cascade's device decode loop over a
``(data, model)`` mesh of 2 and 4 ranks, against the JAX package.

Ranks are processes spawned here, joined over gloo through a
``FileStore`` under ``tmp_path`` (``launch/mesh.py`` ``make_mesh``); what
each runs is in ``tests/_multirank_ranks.py`` (no JAX there).  On the CPU
every collective takes the gloo backend and the kernels their plain
versions: the transport's reductions (the same bits on every rank, equal
to the plain rank-ordered version), the exit kernels' partial contract
(the vocab split into slices, their triples merged in rank order) against
the unsharded plain version and the JAX package's ``exit_update``, and
``reduced(qwen2.5-3b)`` in f32 with weights bridged from the JAX params
served through the port's engine on the device runtime (CPU lanes) on
``1 x 2``, ``2 x 1`` and ``2 x 2`` against the JAX engine on the device
runtime: tokens, exits, the carried ``segments_run`` and every telemetry
counter exactly, confidences to 1e-5 (f32 sums in other orders: the
row-parallel products are sums of partial products).  The ``cuda`` case
runs the all-reduce kernel and the exit kernels' partial route on a card.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.autotune import merge_telemetry as jax_merge
from repro.kernels.exit_update import exit_update as jax_exit_update
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import CascadeServingEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import exit_update as eu
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels import ref

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


CONF_TOL = 1e-5
# test_torch_autotune.py's operating point: exits at every component
MIXED = (0.021, 0.021, 0.0)
ENGINE_KW = dict(lane_batch=4, n_lanes=2, cache_len=32, chunk=4)
BUDGET = 8
N_REQ = 6
RANK_TIMEOUT = 120


@pytest.fixture(scope="module")
def pool():
    """Four rank processes, spawned once for the module and fed one task a
    mesh (each imports torch and the port once)."""
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
    """``target`` on every rank of a ``sizes`` mesh (the pool's first
    ranks); the ranks' results in rank order (an error or a rank past
    RANK_TIMEOUT fails the test)."""
    tasks, results = pool
    world = sizes[0] * sizes[1]
    init = os.path.join(str(tmp_path), f"store_{sizes[0]}x{sizes[1]}")
    for r in range(world):
        tasks[r].put((target, sizes, init, args))
    got = [results.get(timeout=RANK_TIMEOUT) for _ in range(world)]
    errors = [e for _, _, e in got if e is not None]
    assert not errors, errors[0]
    return [ranks.load(res) for _, res, _ in sorted(got, key=lambda g: g[0])]


# ---------------------------------------------------------------------------
# the transport's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_transport_reduces_in_rank_order_to_the_same_bits(pool, tmp_path,
                                                          sizes):
    """Over each axis: every rank of a group ends with the same bits,
    those of the plain version (``ref_allreduce``) over the group's
    inputs in rank order; gathers stack them in rank order; a predicate
    true on one rank is agreed true on all; calls and bytes are counted
    per axis."""
    res = _spawn(pool, tmp_path, sizes, ranks.transport_case, (7,))
    for axis in ("data", "model", "world"):
        groups = {}
        for r in res:
            key = tuple(v for a, v in sorted(r["coord"].items())
                        if a != axis and a != "world") if axis != "world" \
                else ()
            groups.setdefault(key, []).append(r)
        for members in groups.values():
            members.sort(key=lambda r: r["coord"][axis])
            ins = [m[axis]["inputs"] for m in members]
            want = {
                "sum32": ref.ref_allreduce([i[0] for i in ins]),
                "sumbf": ref.ref_allreduce([i[1] for i in ins]),
                "max32": ref.ref_allreduce([i[0] for i in ins], "max"),
                "gather": torch.stack([i[1] for i in ins]),
                "maxi": ref.ref_allreduce([i[2] for i in ins], "max"),
            }
            for m in members:
                for k, w in want.items():
                    assert torch.equal(m[axis][k], w), (axis, k)
    assert all(r["agree"] for r in res)
    for r in res:
        for axis in ("data", "model", "world"):
            n = 5 if dict(zip(("data", "model"), sizes)).get(
                axis, sizes[0] * sizes[1]) > 1 else 0
            assert r["calls"][axis] == n + (axis == "world"), axis
        assert r["bytes"]["model"] == (
            0 if sizes[1] == 1 else 4 * 64 * (4 + 2 + 4 + 2) + 3 * 4)


# ---------------------------------------------------------------------------
# the exit kernels' partial contract, plain versions
# ---------------------------------------------------------------------------

def _carries(B, rng):
    return (torch.as_tensor(rng.random(B) < 0.3),
            torch.as_tensor(rng.integers(0, 50, B).astype(np.int32)),
            torch.as_tensor(rng.integers(0, 2, B).astype(np.int32)),
            torch.as_tensor(rng.random(B).astype(np.float32)),
            torch.as_tensor(rng.integers(0, 3, B).astype(np.int32)),
            torch.as_tensor(rng.random(B).astype(np.float32)),
            torch.as_tensor(rng.random(B) < 0.8))


@pytest.mark.parametrize("R", [2, 4])
@pytest.mark.parametrize("patience_k", [0, 2])
def test_exit_partials_merge_to_the_unsharded_exit_update(R, patience_k):
    """The vocab cut into R slices (ties planted across slices): each
    slice's triple (``exit_partial``), merged in rank order with the carry
    merge (``exit_combine``), gives the unsharded plain version's and the
    JAX package's ``exit_update``'s carries and telemetry codes exactly,
    δ to f32 tolerance; the megakernel's partial route
    (``exit_head_partial`` / ``exit_head_combine``) likewise gives the
    unsharded ``exit_head_update``'s."""
    rng = np.random.default_rng(R + 10 * patience_k)
    B, V, d = 6, 512, 64
    logits = rng.normal(size=(B, V)).astype(np.float32)
    # row 0: its maximum at two columns of two slices (the lower wins)
    logits[0, 3] = logits[0, V - 5] = logits[0].max() + 1.0
    kw = dict(threshold=0.004, m=1, n_components=3, patience_k=patience_k,
              ema_decay=0.8, tel_bins=16)
    carries = _carries(B, rng)
    lg = torch.as_tensor(logits)
    Vr = V // R
    parts = torch.stack([eu.exit_partial(lg[:, r * Vr:(r + 1) * Vr],
                                         vocab_offset=r * Vr)
                         for r in range(R)])
    got = eu.exit_combine(parts, *carries, **kw)
    want = eu.exit_update(lg, *carries, **kw)
    jwant = jax_exit_update(logits, *(np.asarray(c) for c in carries), **kw)
    for i, (g, w, j) in enumerate(zip(got, want, jwant)):
        if g.dtype == torch.float32:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(g, np.asarray(j), rtol=1e-6,
                                       atol=1e-7)
        else:
            assert torch.equal(g, w), i
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    assert int(ref.ref_merge_parts(parts)[0][0]) == 3     # the tie
    # the megakernel's partial route over a (d, V) head
    h = torch.as_tensor(rng.normal(size=(B, d)).astype(np.float32))
    w = torch.as_tensor(rng.uniform(0.5, 1.5, d).astype(np.float32))
    head = torch.as_tensor(rng.normal(size=(d, V)).astype(np.float32) * 0.3)
    live = torch.as_tensor(rng.random(B) < 0.7)
    hparts = torch.stack([mk.exit_head_partial(
        h, w, head[:, r * Vr:(r + 1) * Vr], vocab_offset=r * Vr, live=live)
        for r in range(R)])
    got = mk.exit_head_combine(hparts, *carries, live=live, **kw)
    want = mk.exit_head_update(h, w, head, *carries, live=live, **kw)
    for g, w_ in zip(got, want):
        if g.dtype == torch.float32:
            np.testing.assert_allclose(g, w_, rtol=1e-6, atol=1e-7)
        else:
            assert torch.equal(g, w_)


# ---------------------------------------------------------------------------
# the slice as a whole: multi-rank engines against the JAX engine
# ---------------------------------------------------------------------------

# the main path's mode (select, 2 cohorts); and cond_batch with one cohort,
# which a data axis of 2 splits into two fragments whose skip predicates
# (IF branches) must be agreed
MODES = {"select": dict(exit_mode="select", n_cohorts=2),
         "cond_batch": dict(exit_mode="cond_batch", n_cohorts=1)}


def _cfg(pkg="torch", mode="select", enhance=0):
    get, red = ((jax_get_config, jax_reduced) if pkg == "jax"
                else (get_config, reduced))
    cfg = red(get("qwen2.5-3b"), n_layers=3).replace(dtype="float32")
    if pkg == "torch":
        cfg = cfg.replace(use_kernels=True)
    cfg = cfg.with_cascade(n_components=3, exit_boundaries=(1, 2),
                           thresholds=MIXED, cohort_layout="major",
                           enhance_dim=enhance, **MODES[mode])
    return cfg.with_autotune(enabled=True, bins=256, shadow_every=2,
                             min_shadow=8, resolve_every=4)


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 512, 6).astype(np.int32) for _ in range(N_REQ)]


@pytest.fixture(scope="module")
def reference():
    """The JAX engine on the device runtime in each mode and enhancement
    width (made at first use), and its weights as numpy."""
    made = {}

    def get(mode, enhance=0):
        if (mode, enhance) not in made:
            jcfg = _cfg("jax", mode, enhance)
            jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
            if enhance:
                # enh_w2 starts at zero (the enhancement off until trained):
                # drawn here, so that the exits read it
                rng = np.random.default_rng(5)
                for e in jparams["exits"]:
                    e["enh_w2"] = jnp.asarray(0.05 * rng.standard_normal(
                        e["enh_w2"].shape), e["enh_w2"].dtype)
            eng = JaxEngine(jcfg, jax_build_model(jcfg), jparams,
                            runtime="device", **ENGINE_KW)
            for i, p in enumerate(_prompts()):
                eng.submit(JaxRequest(rid=i, prompt=p, max_new_tokens=BUDGET))
            eng.run(max_ticks=200)
            made[mode, enhance] = (
                jax.tree_util.tree_map(np.asarray, jparams), eng,
                jax_merge(eng.lane_telemetry()))
        return made[mode, enhance]
    return get


@pytest.mark.parametrize("sizes,fused,mode,enhance", [
    ((1, 2), False, "select", 0), ((1, 2), True, "select", 0),
    ((2, 1), False, "select", 0), ((2, 2), False, "select", 0),
    ((2, 1), False, "cond_batch", 0), ((1, 2), False, "select", 64)],
    ids=["1x2", "1x2-megakernel", "2x1", "2x2", "2x1-cond_batch",
         "1x2-enhanced"])
def test_multirank_engine_matches_reference_engine(pool, tmp_path,
                                                   reference, sizes, fused,
                                                   mode, enhance):
    """Every rank's engine gives the JAX engine's streams, carried
    segments_run and telemetry; a rank holds its data rows and its model
    shard; the model axis made collectives and the data axis gathered the
    chunks.  ``fused``: the main path's kernels — the exit-head
    megakernel's partial route and the cohort scatter — against the
    reference's plain route (kernels on and off agree on ints by
    contract).  ``cond_batch``: one cohort split over the data ranks, its
    skip branches agreed.  ``enhance``: the exits' classifier enhancement
    (enh_w1 sharded by column, enh_w2 by row over ``model``, completed by
    an all-reduce).  On the 1 x 2 mesh every refusal names what is
    missing."""
    np_params, jeng, jtel = reference(mode, enhance)
    refusals = sizes == (1, 2) and not fused and not enhance
    cfg = _cfg(mode=mode, enhance=enhance)
    if fused:
        cfg = cfg.with_kernel_tune(megakernel=True, cohort_scatter=True)
    res = _spawn(pool, tmp_path, sizes, ranks.serve_case, (
        cfg, np_params, _prompts(), BUDGET, ENGINE_KW, refusals))
    want = jeng.finished
    jcarried = np.sum([np.asarray(ln["state"].segments_run)
                       for ln in jeng.lanes], axis=0).tolist()
    D, M = sizes
    for r in res:
        assert sorted(r["finished"]) == sorted(want) == list(range(N_REQ))
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
        assert r["local_batch"] == ENGINE_KW["lane_batch"] // D
        assert r["wq_cols"] == 256 // M
        assert (r["calls"]["model"] > 0) == (M > 1)
        assert (r["calls"]["data"] > 0) == (D > 1)
    # the exits split: some tokens answered early, some at full depth
    depths = [e for _, e, _ in res[0]["finished"].values()]
    assert {0, 2} <= set(np.concatenate(depths).tolist())
    if refusals:
        got = res[0]["refused"]
        assert "NotImplementedError" in got["moe_paged"] and "paged" in \
            got["moe_paged"]
        assert "NotImplementedError" in got["paged"] and "paged" in \
            got["paged"]
        assert "NotImplementedError" in got["hybrid"] and "hybrid" in \
            got["hybrid"]
        assert "ValueError" in got["heads"] and "3 attention heads" in \
            got["heads"]
        assert "runtime='device'" in got["host"]


def test_collectives_counted_from_replayed_bodies():
    """A CUDA lane's replays run no Python: the device loop counts a
    transport's collectives as it counts kernel launches — each IF body's
    captured calls times the executions its device counter read, the
    calls outside every body times the replays — so a branch that did not
    run adds nothing.  The capture's own calls are put back."""
    from types import SimpleNamespace
    from repro_torch.kernels.cond_node import CapturedBranches
    from repro_torch.serving.runtime import DeviceDecodeLoop, _counts
    loop = object.__new__(DeviceDecodeLoop)
    loop.transport = SimpleNamespace(
        calls={"data": 0, "model": 2, "world": 0},
        bytes={"data": 0, "model": 64, "world": 0})
    loop.replayed_collectives = {"steps": 0, "calls": {}, "bytes": {}}
    branches = object.__new__(CapturedBranches)
    snap = _counts(loop.transport)

    def captured(axis, calls, nbytes):
        before = _counts(loop.transport)
        loop.transport.calls[axis] += calls
        loop.transport.bytes[axis] += nbytes
        return {k: v - before[k] for k, v in _counts(loop.transport).items()}

    branches.top_launches = captured("world", 1, 4)       # the guard's
    branches.body_launches = [captured("model", 5, 80),   # the step
                              captured("model", 3, 48)]   # a skip branch
    loop._set_counts(snap)
    assert loop.transport.calls["model"] == 2
    # a chunk of K = 4 replays: the step ran 3 times, the branch never
    loop._add_counts(branches.replayed_launches([3, 0], 4), 3)
    assert loop.transport.calls == {"data": 0, "model": 17, "world": 4}
    assert loop.transport.bytes == {"data": 0, "model": 304, "world": 16}
    assert loop.replayed_collectives == {
        "steps": 3, "calls": {"data": 0, "model": 15, "world": 4},
        "bytes": {"data": 0, "model": 240, "world": 16}}


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_allreduce_and_exit_partials_on_card():
    """``chip_smoke.py``'s multi-rank checks (a) and (b) at their shapes:
    the IPC all-reduce kernel on 2 and 4 ranks sharing the card, and the
    exit kernels' partial route at (4, 151936) bf16 in 2 and 4 slices."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.kernels import build
    build.build_all()
    dev = torch.device("cuda")
    chip_smoke.phase_multirank_transport()
    chip_smoke.phase_multirank_exit(dev, torch.Generator().manual_seed(0))
