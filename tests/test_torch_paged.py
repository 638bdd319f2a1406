"""The port's paged KV layout against the JAX package's, piece by piece:
the block pool, the paged cache's bookkeeping, the paged gather (plain
version vs the Pallas kernel in interpret mode), the three block helpers,
and the model's prefill + decode through block tables.

Config: ``reduced(qwen2.5-3b)`` (2 layers, 2 components), f32, block size
8.  Integers and gathers/copies compare exactly; stores written by both
packages compare exactly on every block but the trash block 0 (duplicate
scatters land there in no fixed order).  Model logits: within 1e-5 (f32
sums in other orders, two layers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels.paged_gather import paged_gather as jax_paged_gather
from repro.models import blocks as jax_blocks
from repro.models.model import build_model as jax_build_model
from repro.serving.paged import BlockPool as JaxBlockPool
from repro.serving.paged import PagedCascadeCache as JaxPagedCache
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.kernels import paged_gather as pg
from repro_torch.kernels.ref import ref_paged_gather
from repro_torch.models import blocks
from repro_torch.models.model import build_model
from repro_torch.serving.paged import TRASH_BLOCK, BlockPool, PagedCascadeCache


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers
    on a few cores, where these small ops gain nothing from more threads
    and would slow the other workers' timed tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LOGIT_TOL = 1e-5


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _cfgs(**kw):
    jcfg = jax_reduced(jax_get_config("qwen2.5-3b")).replace(
        dtype="float32", **kw).with_paged_cache(layout="paged", block_size=8)
    cfg = reduced(get_config("qwen2.5-3b")).replace(
        dtype="float32", **kw).with_paged_cache(layout="paged", block_size=8)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


# ---------------------------------------------------------------------------
# block pool and paged cache bookkeeping
# ---------------------------------------------------------------------------

def _pool_script(pool, rng):
    """One seeded alloc / free / soft-cap sequence; returns what it saw."""
    seen, held = [], []
    for step in range(60):
        op = rng.integers(0, 5)
        if op <= 1:
            ids = pool.alloc(int(rng.integers(0, 5)))
            seen.append(("alloc", ids))
            if ids:
                held.append(ids)
        elif op <= 3 and held:
            ids = held.pop(int(rng.integers(0, len(held))))
            pool.free(ids, by_exit=bool(rng.integers(0, 2)))
            seen.append(("free", ids))
        else:
            cap = [None, int(rng.integers(0, 20))][int(rng.integers(0, 2))]
            pool.set_soft_cap(cap)
            seen.append(("cap", cap, pool.can_alloc(3)))
        if step % 7 == 0:
            pool.begin_chunk()
        if step % 7 == 6:
            seen.append(("chunk", pool.end_chunk()))
        seen.append(("stats", pool.stats()))
    pool.reset_window()
    seen.append(("stats", pool.stats()))
    return seen


def test_block_pool_matches_reference():
    got = _pool_script(BlockPool(17, 8, block_bytes=100),
                       np.random.default_rng(0))
    want = _pool_script(JaxBlockPool(17, 8, block_bytes=100),
                        np.random.default_rng(0))
    assert got == want
    assert TRASH_BLOCK == 0
    for bad in (lambda p: p.free([TRASH_BLOCK]),
                lambda p: p.set_soft_cap(-1)):
        with pytest.raises(ValueError):
            bad(BlockPool(4, 8))
    with pytest.raises(ValueError):
        BlockPool(1, 8)


def _book(pc):
    """Drive one seeded slot lifecycle; returns tables and stats seen."""
    out = [pc.coverage(0, 5), pc.coverage(30, 70), pc.coverage(5, 5),
           pc.blocks_needed(3, 20), pc.fits_ever(0, 200),
           pc.can_admit(10)]
    for lane, slot, a, b in ((0, 0, 0, 12), (0, 1, 4, 30), (1, 1, 20, 50)):
        out.append(pc.alloc_slot(lane, slot, a, b))
    out.append(pc.slot_blocks(0, 1))
    pc.release_slot(0, 0, max_exit_depth=0)
    pc.release_slot(1, 1)
    pc.release_slot(1, 1)                      # a second release is a no-op
    out.append(pc.alloc_slot(1, 0, 0, 32))
    out.append(pc.alloc_slot(0, 0, 0, 1000))   # more than the pool holds
    out += [np.asarray(pc.device_tables(i)).tolist() for i in range(2)]
    out.append(_np(pc.fresh_kpos()).tolist())
    out.append(pc.stats())
    return out


def test_paged_cache_matches_reference():
    jcfg, cfg = _cfgs()
    kw = dict(lane_batch=2, n_lanes=2, cache_len=32)
    got = _book(PagedCascadeCache(build_model(cfg, device="cpu"), cfg, **kw))
    want = _book(JaxPagedCache(jax_build_model(jcfg), jcfg, **kw))
    assert got == want
    pc = PagedCascadeCache(build_model(cfg, device="cpu"), cfg, **kw)
    assert pc.segments[0][0]["k"].shape == (1, pc.pool.num_blocks, 8, 1, 64)
    # the cap-sized pool: as many blocks as the caller asks, trash included
    small = cfg.with_paged_cache(num_blocks=9)
    assert PagedCascadeCache(build_model(small, device="cpu"), small,
                             **kw).pool.num_blocks == 9


def test_paged_cache_validation():
    _, cfg = _cfgs()
    model = build_model(cfg, device="cpu")
    kw = dict(lane_batch=2, n_lanes=1, cache_len=32)
    bad = cfg.with_paged_cache(block_size=7)
    with pytest.raises(ValueError, match="divide"):
        PagedCascadeCache(build_model(bad, device="cpu"), bad, **kw)
    with pytest.raises(ValueError, match="MoE"):
        PagedCascadeCache(model, cfg.replace(n_experts=4, top_k=2), **kw)
    with pytest.raises(ValueError, match="num_blocks"):
        PagedCascadeCache(model, cfg.with_paged_cache(num_blocks=1), **kw)

    class _Recurrent:
        """A model whose cache has a non-attention stage."""
        device = torch.device("cpu")

        def cache_capacity(self, n):
            return n

        def init_cache(self, *a, **k):
            return {"segments": [[{"h": torch.zeros(1, 2, 4)}]]}

    with pytest.raises(ValueError, match="non-attention"):
        PagedCascadeCache(_Recurrent(), cfg, **kw)


# ---------------------------------------------------------------------------
# the paged gather: plain version and wrappers vs the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_gather_matches_pallas(dtype):
    """Trash ids and duplicate ids in the table; the kernel's result is a
    copy, so the port's plain version and its CPU wrappers must equal the
    Pallas kernel (interpret mode) bit for bit."""
    rng = np.random.default_rng(1)
    store = rng.standard_normal((9, 8, 2, 16)).astype(np.float32)
    table = np.array([[3, 0, 5, 5], [0, 0, 0, 0], [8, 1, 3, 0]], np.int32)
    jstore = jnp.asarray(store).astype(dtype)
    want = np.asarray(jax_paged_gather(jstore, jnp.asarray(table),
                                       interpret=True).astype(jnp.float32))
    tstore = torch.from_numpy(store).to(getattr(torch, dtype))
    ttable = torch.from_numpy(table)
    for got in (ref_paged_gather(tstore, ttable),
                pg.paged_gather(tstore, ttable),
                *pg.paged_gather_kv(tstore, tstore.clone(), ttable)):
        assert got.shape == (3, 32, 2, 16)
        np.testing.assert_array_equal(got.float().numpy(), want)
    # a layer slice of a stacked store, as the model hands it over
    stacked = torch.stack([tstore, tstore + 1])
    assert torch.equal(pg.paged_gather(stacked[1], ttable),
                       ref_paged_gather(tstore + 1, ttable))
    assert pg.paged_gather.launches == 0


# ---------------------------------------------------------------------------
# block helpers
# ---------------------------------------------------------------------------

def _store_pair(rng, NB=10, bs=8, kv=1, hd=64):
    k = rng.standard_normal((NB, bs, kv, hd)).astype(np.float32)
    v = rng.standard_normal((NB, bs, kv, hd)).astype(np.float32)
    return k, v


def _assert_stores_equal(got, want):
    for name in ("k", "v"):
        np.testing.assert_array_equal(_np(got[name])[1:],
                                      np.asarray(want[name])[1:])


TABLE = np.array([[4, 7, 0, 2], [0, 0, 0, 0], [9, 0, 3, 1]], np.int32)


def test_write_decode_paged_matches_reference():
    rng = np.random.default_rng(2)
    k0, v0 = _store_pair(rng)
    k = rng.standard_normal((3, 1, 1, 64)).astype(np.float32)
    v = rng.standard_normal((3, 1, 1, 64)).astype(np.float32)
    for slot in (0, 9, 17, 31):
        want = jax_blocks._write_decode_paged(
            {"k": jnp.asarray(k0), "v": jnp.asarray(v0)}, jnp.asarray(k),
            jnp.asarray(v), jnp.int32(slot), jnp.asarray(TABLE))
        cache = {"k": torch.from_numpy(k0.copy()),
                 "v": torch.from_numpy(v0.copy())}
        got = blocks._write_decode_paged(cache, torch.from_numpy(k),
                                         torch.from_numpy(v), slot,
                                         torch.from_numpy(TABLE))
        assert got is cache                    # written in place
        _assert_stores_equal(got, want)


@pytest.mark.parametrize("S", [5, 32, 45])
def test_write_full_paged_matches_reference(S):
    from repro.models.model import _prefill_kpos
    rng = np.random.default_rng(3)
    k0, v0 = _store_pair(rng)
    k = rng.standard_normal((3, S, 1, 64)).astype(np.float32)
    v = rng.standard_normal((3, S, 1, 64)).astype(np.float32)
    gather = _prefill_kpos(S, 32)
    want = jax_blocks._write_full_paged(
        {"k": jnp.asarray(k0), "v": jnp.asarray(v0)}, jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(gather), jnp.asarray(TABLE))
    got = blocks._write_full_paged(
        {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy())},
        torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(gather),
        torch.from_numpy(TABLE))
    _assert_stores_equal(got, want)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_paged_kv_view_matches_reference(use_kernels):
    jcfg, cfg = _cfgs(use_kernels=use_kernels, kernel_interpret=True)
    rng = np.random.default_rng(4)
    k0, v0 = _store_pair(rng)
    want = jax_blocks._paged_kv_view(
        jcfg, {"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
        jnp.asarray(TABLE))
    cache = {"k": torch.from_numpy(k0), "v": torch.from_numpy(v0)}
    # the kernel route gathers only stores decode attention's paged route
    # does not take, k and v in one launch
    got = (ops.paged_gather_kv(cache["k"], cache["v"], torch.from_numpy(TABLE))
           if use_kernels else
           blocks._paged_kv_view(cache, torch.from_numpy(TABLE)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


# ---------------------------------------------------------------------------
# the model through block tables
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = _cfgs()
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return jparams, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")


def _decode(model, params, token, t, cache, tables, live):
    """One full-depth decode step through the segment primitives."""
    h, ctx = model.begin_decode(params, token, t, cache)
    ctx = {**ctx, "block_tables": tables, "live": live}
    logits, segs = [], []
    for si in range(model.n_exits):
        h, nc, _ = model.run_segment(si, params, h, ctx,
                                     cache["segments"][si])
        segs.append(nc)
        logits.append(model.exit_logits(params, si, h)[:, 0, :])
    return logits, model.commit_decode(cache, segs, t)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_model_paged_prefill_and_decode_match_reference(weights,
                                                        use_kernels):
    """Prefill through block tables (slot 2 is dead: all its rows point at
    the trash block) and 4 decode steps: every exit's logits within 1e-5,
    the kpos rings and every store block but the trash block equal."""
    jparams, params = weights
    jcfg, cfg = _cfgs(use_kernels=use_kernels, kernel_interpret=True)
    jm, m = jax_build_model(jcfg), build_model(cfg, device="cpu")
    kw = dict(lane_batch=3, n_lanes=1, cache_len=32)
    jpc, pc = JaxPagedCache(jm, jcfg, **kw), PagedCascadeCache(m, cfg, **kw)
    S = 9
    for p in (jpc, pc):
        assert p.alloc_slot(0, 0, 0, S + 6) and p.alloc_slot(0, 1, 0, S + 6)
    jt, tt = jpc.device_tables(0), pc.device_tables(0)
    np.testing.assert_array_equal(_np(tt), np.asarray(jt))
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (3, S)).astype(np.int32)
    jl, jcache = jm.prefill(jparams, jnp.asarray(toks),
                            jpc.lane_cache(jpc.fresh_kpos()), block_tables=jt)
    tl, cache = m.prefill(params, torch.from_numpy(toks),
                          pc.lane_cache(pc.fresh_kpos()), block_tables=tt)
    assert cache["kpos"].shape == (3, 32)
    assert cache["kpos"].stride(0) == 32        # a copy per slot, no view
    live = np.array([True, True, False])
    for step in range(5):
        np.testing.assert_array_equal(_np(cache["kpos"]),
                                      np.asarray(jcache["kpos"]))
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(_np(a)[live], np.asarray(b)[live],
                                       atol=LOGIT_TOL, rtol=LOGIT_TOL)
        if step == 4:
            break
        nxt = np.asarray(jnp.argmax(jl[-1], -1), np.int32)[:, None]
        jl, jcache = _decode(jm, jparams, jnp.asarray(nxt), S + step,
                             jcache, jt, jnp.asarray(live))
        tl, cache = _decode(m, params, torch.from_numpy(nxt.copy()),
                            S + step, cache, tt, torch.from_numpy(live))
    for jseg, seg in zip(jcache["segments"], cache["segments"]):
        for jst, st in zip(jseg, seg):
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    _np(st[name])[:, 1:], np.asarray(jst[name])[:, 1:],
                    atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_prefill_into_writes_only_the_slots_blocks(weights):
    """Continuous admission's B = 1 prefill at offset positions: logits
    within 1e-5 of the JAX package's, the slot's blocks equal, and every
    other block of the shared stores untouched."""
    jparams, params = weights
    jcfg, cfg = _cfgs()
    jm, m = jax_build_model(jcfg), build_model(cfg, device="cpu")
    kw = dict(lane_batch=2, n_lanes=1, cache_len=32)
    jpc, pc = JaxPagedCache(jm, jcfg, **kw), PagedCascadeCache(m, cfg, **kw)
    rng = np.random.default_rng(6)
    for jseg, seg in zip(jpc.segments, pc.segments):       # busy stores
        for jst, st in zip(jseg, seg):
            for name in ("k", "v"):
                x = rng.standard_normal(st[name].shape).astype(np.float32)
                st[name].copy_(torch.from_numpy(x))
                jst[name] = jnp.asarray(x)
    before = [st[n].clone() for seg in pc.segments for st in seg
              for n in ("k", "v")]
    t0, P = 21, 8
    start = t0 - P
    for p in (jpc, pc):
        assert p.alloc_slot(0, 1, start, t0 + 5)
    rows = np.array(jpc.device_tables(0))[:, 1:2]
    write = np.full((32,), -1, np.int32)
    for q in range(start, t0):
        write[q % 32] = q - start
    toks = rng.integers(0, cfg.vocab_size, (1, P)).astype(np.int32)
    pos = (start + np.arange(P)).astype(np.int32)
    jl, jsegs = jm.prefill_into(jparams, jnp.asarray(toks),
                                {"segments": jpc.segments, "kpos": None},
                                jnp.asarray(pos), jnp.asarray(write),
                                jnp.asarray(rows))
    tl = m.prefill_into(params, torch.from_numpy(toks),
                        pc.lane_cache(None), torch.from_numpy(pos),
                        torch.from_numpy(write), torch.from_numpy(rows))
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
    owned = sorted(set(rows.ravel().tolist()) - {TRASH_BLOCK})
    assert owned
    others = [b for b in range(1, pc.pool.num_blocks) if b not in owned]
    after = [(st[n], jst[n]) for seg, jseg in zip(pc.segments, jsegs)
             for st, jst in zip(seg, jseg) for n in ("k", "v")]
    for old, (new, jnew) in zip(before, after):
        np.testing.assert_array_equal(_np(new)[:, others],
                                      _np(old)[:, others])
        np.testing.assert_allclose(_np(new)[:, owned],
                                   np.asarray(jnew)[:, owned],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_paged_gather_takes_plain_version_for_cpu_tensors_only(monkeypatch):
    """The wrapper rule: the plain version serves CPU tensors, and a
    tensor that reports a CUDA device goes to the kernel's device check
    (the first step of a launch), never to the plain version."""
    from repro_torch.kernels import build
    calls, reached = [], []

    class _Reached(Exception):
        pass

    def device_check(what, *tensors):
        reached.append(what)
        raise _Reached

    class _Dev:
        type = "cuda"

    class _T:
        device = _Dev()

    monkeypatch.setattr(pg, "ref_paged_gather",
                        lambda s, t: calls.append(1) or s)
    table = torch.zeros(1, 2, dtype=torch.int32)
    pg.paged_gather(torch.ones(3, 2, 1, 4), table)
    pg.paged_gather_kv(torch.ones(3, 2, 1, 4), torch.ones(3, 2, 1, 4), table)
    assert calls == [1, 1, 1] and reached == []
    monkeypatch.setattr(build, "require_cuda", device_check)
    for fake in (lambda: pg.paged_gather(_T(), _T()),
                 lambda: pg.paged_gather_kv(_T(), _T(), _T())):
        with pytest.raises(_Reached):
            fake()
    assert calls == [1, 1, 1] and reached == ["paged_gather"] * 2
    assert pg.paged_gather.launches == 0
