"""The hybrid family: Mamba2 SSD (``models/ssm.py``), the mamba and
attn_shared blocks (the shared attention + MLP block with per-invocation
LoRA deltas), recurrent-state caches through the staged executor's
snapshots and cohorts, zamba2-1.2b — the port against the JAX package on
bridged weights, plus the port's own contracts.

Config: ``reduced(zamba2-1.2b, n_layers=9, shared_attn_every=3)``, f32, 3
components with exits after layers 1 and 3: the kinds are [attn_shared,
mamba, mamba] three times, so segment 0 is one shared block (ring leaves
only), segment 1 a stage of 2 mamba layers (state leaves only) and
segment 2 both kinds, with two mamba stages of one length (state leaves
of one shape, as zamba2-1.2b's segments have).  d 256, 4 / 4 heads of 64,
d_inner 512 (16 heads of 32), state 16, conv 4, SSD chunk 32: a prompt of
45 tokens takes the padded SSD path (45 -> 64).

The JAX init leaves some leaves degenerate — the LoRA ``lora_*_b`` (zeros),
``D`` (ones), ``conv_b`` (zeros) and ``gate_norm_w`` (ones) — so before
bridging they are overwritten with random values (numpy seed 17): a
missing LoRA term, or LoRA leaking into the backfill, then shows.

Tolerances: the SSD scan, the conv, the SSM sublayer and the blocks
within 5e-5 (``SSM_TOL``: f32 sums over a chunk of up to 32 unit-scale
products, contracted in other orders — measured up to 1.2e-5); exit
logits 1e-4
(``LOGIT_TOL``, as ``tests/test_torch_moe.py``); train-step losses 1e-4;
decode streams: tokens, exit indices, ``segments_run`` and telemetry
counters exactly, confidences and EMAs 1e-5; within the port (host ≡
device runtime, major ≡ copy, select ≡ cond_batch) bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.autotune import merge_telemetry as jax_merge
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import macs as jax_macs
from repro.core.exec import StagedExecutor as JaxExecutor
from repro.launch import steps as jax_steps
from repro.models import blocks as jax_blocks
from repro.models import ssm as jax_ssm
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import CascadeServingEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro.serving.paged.cache import PagedCascadeCache as JaxPagedCache
from repro_torch.autotune import merge_telemetry
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_config, reduced
from repro_torch.core import macs
from repro_torch.core.exec import StagedExecutor
from repro_torch.kernels import ops
from repro_torch.launch import serve, steps
from repro_torch.models import blocks, nn, ssm
from repro_torch.models.model import build_model
from repro_torch.serving.engine import CascadeServingEngine, Request
from repro_torch.serving.paged.cache import PagedCascadeCache


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers
    on a few cores, where these small ops gain nothing from more threads
    and would slow the other workers' timed tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SSM_TOL = 5e-5
LOGIT_TOL = 1e-4
CONF_TOL = 1e-5
STEP_TOL = 1e-4
ARCH = "zamba2-1.2b"
DEGENERATE = ("D", "conv_b", "gate_norm_w")


def _cfgs(**kw):
    cas = dict(n_components=3, exit_boundaries=(1, 3))
    cas.update(kw.pop("cascade", {}))
    jcfg = jax_reduced(jax_get_config(ARCH), n_layers=9,
                       shared_attn_every=3).replace(
        dtype="float32", **kw).with_cascade(**cas)
    cfg = reduced(get_config(ARCH), n_layers=9, shared_attn_every=3).replace(
        dtype="float32", **kw).with_cascade(**cas)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _undegenerate(tree, rng):
    """The JAX init with its constant leaves (LoRA B, D, conv_b,
    gate_norm_w) replaced by random values of the same shape and dtype."""
    if isinstance(tree, dict):
        return {k: (jnp.asarray(0.5 * rng.standard_normal(v.shape)
                                + (1.0 if k in ("D", "gate_norm_w") else 0.0),
                                np.float32).astype(v.dtype)
                    if (k.startswith("lora_") and k.endswith("_b"))
                    or k in DEGENERATE else _undegenerate(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_undegenerate(v, rng) for v in tree]
    return tree


_WEIGHTS = {}


def _weights():
    """The reference's seed-0 init, its degenerate leaves randomised,
    bridged (once)."""
    if not _WEIGHTS:
        jcfg, cfg = _cfgs()
        jparams = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))
        jparams = _undegenerate(jparams, np.random.default_rng(17))
        _WEIGHTS["w"] = (jparams, params_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu"))
    return _WEIGHTS["w"]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, tol=SSM_TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

def test_config_copy_equals_reference_field_by_field():
    ours, ref = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.segments == ref.segments == ((0, 13), (13, 25), (25, 38))
    assert dataclasses.asdict(reduced(ours)) == dataclasses.asdict(
        jax_reduced(ref))


def test_full_width_config_builds():
    """zamba2-1.2b at its published widths (no weights drawn: the card's
    phase draws them): 31 mamba layers and 7 shared-block invocations
    (layers 0, 6, ..., 36); stages of 5, 1 and 5 mamba layers; a bf16
    cache's state leaves in f32 and its conv windows in bf16, on the meta
    device; the reference's parameter count."""
    cfg = get_config(ARCH)
    model = build_model(cfg, device="cpu")
    kinds = blocks.layer_kinds(cfg)
    assert kinds.count("mamba") == 31 and kinds.count("attn_shared") == 7
    assert [i for i, k in enumerate(kinds) if k == "attn_shared"] == \
        [0, 6, 12, 18, 24, 30, 36]
    assert blocks.layer_kinds(cfg) == jax_blocks.layer_kinds(
        jax_get_config(ARCH))
    runs = [n for seg in model.segment_runs for k, n in seg if k == "mamba"]
    assert sorted(set(runs)) == [1, 5]
    cache = model.init_cache(4, 512, dtype=torch.bfloat16, device="meta")
    seen = set()
    for si, seg in enumerate(cache["segments"]):
        mask = model.state_leaf_mask(si, seg)
        for leaf, is_state in zip(nn.tree_leaves(seg), mask):
            seen.add((tuple(leaf.shape), leaf.dtype, is_state))
    assert ((5, 4, 64, 64, 64), torch.float32, True) in seen
    assert ((5, 4, 3, 4224), torch.bfloat16, True) in seen
    assert ((1, 4, 512, 32, 64), torch.bfloat16, False) in seen
    assert macs.param_count(cfg) == jax_macs.param_count(jax_get_config(ARCH))
    assert 0.98e9 < macs.param_count(cfg) < 1.0e9


# ---------------------------------------------------------------------------
# the Mamba2 sublayer against the reference
# ---------------------------------------------------------------------------

def _layer(i=0):
    """Layer ``i`` of segment 1's mamba stage: (jax params, port params)."""
    jparams, params = _weights()
    return (jax.tree_util.tree_map(lambda a: a[i],
                                   jparams["segments"][1][0]["ssm"]),
            nn.tree_index(params["segments"][1][0]["ssm"], i))


@pytest.mark.parametrize("init_state", [False, True])
@pytest.mark.parametrize("S,chunk", [(32, 32), (96, 32), (64, 16)])
def test_ssd_chunked_equals_reference(S, chunk, init_state):
    B, h, p, n = 2, 4, 8, 16
    x, Bm, Cm = (_rand((B, S, h, p), 1), _rand((B, S, n), 2),
                 _rand((B, S, n), 3))
    dt = np.log1p(np.exp(_rand((B, S, h), 4))).astype(np.float32)
    A = -np.linspace(1.0, 16.0, h).astype(np.float32) / 8
    st = _rand((B, h, p, n), 5) if init_state else None
    want_y, want_s = jax.jit(jax_ssm.ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk,
        None if st is None else jnp.asarray(st))
    got_y, got_s = ssm.ssd_chunked(
        *map(torch.from_numpy, (x, dt, A, Bm, Cm)), chunk,
        None if st is None else torch.from_numpy(st))
    _close(got_y, want_y)
    _close(got_s, want_s)
    assert got_s.dtype == torch.float32


def test_ssd_chunked_gradients_are_finite():
    """The mask goes on before the exponent: the backward through the
    upper triangle's large positive exponents stays finite."""
    B, S, h, p, n = 1, 32, 2, 4, 8
    x = torch.from_numpy(_rand((B, S, h, p), 6)).requires_grad_()
    dt = torch.full((B, S, h), 2.0, requires_grad=True)
    A = torch.tensor([-8.0, -16.0])
    y, s = ssm.ssd_chunked(x, dt, A, torch.from_numpy(_rand((B, S, n), 7)),
                           torch.from_numpy(_rand((B, S, n), 8)), 32)
    (y.sum() + s.sum()).backward()
    assert torch.isfinite(x.grad).all() and torch.isfinite(dt.grad).all()


def _ssm_cache(cfg, B, seed):
    """A random conv window and state of a reduced mamba layer."""
    _, h, cc = ssm.dims(cfg)
    return {"conv": _rand((B, cfg.ssm_conv - 1, cc), seed, 0.5),
            "state": _rand((B, h, cfg.ssm_head_dim, cfg.ssm_state),
                           seed + 1, 0.5)}


def _to_torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def test_causal_conv_full_with_cache_equals_reference():
    jcfg, cfg = _cfgs()
    jp, tp = _layer()
    cc = ssm.dims(cfg)[2]
    x = _rand((2, 21, cc), 9)
    cache = _ssm_cache(cfg, 2, 10)["conv"]
    for c in (None, cache):
        want = jax.jit(jax_ssm._causal_conv_full)(
            jnp.asarray(x), jp["conv_w"], jp["conv_b"],
            None if c is None else jnp.asarray(c))
        got = ssm._causal_conv_full(
            torch.from_numpy(x), tp["conv_w"], tp["conv_b"],
            None if c is None else torch.from_numpy(c))
        for a, b in zip(got, want):
            _close(a, b)


@pytest.mark.parametrize("with_cache", [False, True])
@pytest.mark.parametrize("S", [45, 64])
def test_ssm_forward_full_equals_reference(S, with_cache):
    """S 45 takes the padded SSD path (45 -> 64 at chunk 32), S 64 two
    whole chunks; with a cache the conv and the scan start from its
    window and state, and the new ones are written in place."""
    jcfg, cfg = _cfgs()
    jp, tp = _layer(1)
    x = _rand((2, S, cfg.d_model), 11)
    cache = _ssm_cache(cfg, 2, 12) if with_cache else None
    want, wcache = jax.jit(lambda p, x, c: jax_ssm.ssm_forward_full(
        p, jcfg, x, c))(jp, jnp.asarray(x),
                        None if cache is None else
                        jax.tree_util.tree_map(jnp.asarray, cache))
    tcache = None if cache is None else _to_torch(cache)
    got, gcache = ssm.ssm_forward_full(tp, cfg, torch.from_numpy(x), tcache)
    _close(got, want)
    if with_cache:
        assert gcache is tcache
        for k in ("conv", "state"):
            _close(tcache[k], wcache[k])


def test_ssm_decode_steps_equal_reference():
    """Five single-token steps from a random window and state, each step's
    output and both rewritten leaves against the reference's."""
    jcfg, cfg = _cfgs()
    jp, tp = _layer()
    cache = _ssm_cache(cfg, 3, 13)
    jcache = jax.tree_util.tree_map(jnp.asarray, cache)
    tcache = _to_torch(cache)
    step = jax.jit(lambda p, x, c: jax_ssm.ssm_decode_step(p, jcfg, x, c))
    for i in range(5):
        x = _rand((3, 1, cfg.d_model), 20 + i)
        want, jcache = step(jp, jnp.asarray(x), jcache)
        got, _ = ssm.ssm_decode_step(tp, cfg, torch.from_numpy(x), tcache)
        _close(got, want)
        for k in ("conv", "state"):
            _close(tcache[k], jcache[k])


# ---------------------------------------------------------------------------
# the blocks against the reference, both modes
# ---------------------------------------------------------------------------

def _ctx_pair(mode, S, B, W=64, t=50):
    """A (jax ctx, port ctx) pair: full mode over S positions writing a
    ring of W, or a decode step at position t."""
    jparams, params = _weights()
    kpos = np.where(np.arange(W) < t, np.arange(W), -1).astype(np.int32)
    if mode == "full":
        pos = np.arange(S, dtype=np.int32)
        ws = np.where(np.arange(W) < S, np.arange(W), -1).astype(np.int32)
        jctx = {"mode": "full", "positions": jnp.asarray(pos),
                "write_slots": jnp.asarray(ws), "cross": None,
                "shared": jparams["shared"], "kpos": jnp.asarray(kpos)}
        ctx = {"mode": "full", "positions": torch.from_numpy(pos),
               "write_slots": torch.from_numpy(ws),
               "kpos": torch.from_numpy(kpos), "shared": params["shared"]}
        return jctx, ctx
    jctx = {"mode": "decode", "t": jnp.int32(t), "slot": jnp.int32(t % W),
            "kpos": jnp.asarray(kpos), "positions": None,
            "write_slots": None, "cross": None, "shared": jparams["shared"]}
    kpos_t = kpos.copy()
    kpos_t[t % W] = t
    ctx = {"mode": "decode", "t": torch.tensor(t, dtype=torch.int32),
           "slot": torch.tensor(t % W), "kpos": torch.from_numpy(kpos),
           "kpos_t": torch.from_numpy(kpos_t), "shared": params["shared"]}
    return jctx, ctx


def _attn_cache(cfg, B, W, seed):
    hd = cfg.resolved_head_dim
    return {"k": _rand((B, W, cfg.n_kv_heads, hd), seed, 0.5),
            "v": _rand((B, W, cfg.n_kv_heads, hd), seed + 1, 0.5)}


def _block_case(kind, mode, what):
    """Run block ``kind``'s ``what`` ("apply" or "backfill") in ``mode``
    on both packages from the same cache; compare h and every cache
    leaf.  Returns the port's cache."""
    jcfg, cfg = _cfgs()
    jparams, params = _weights()
    si, pi = (1, 0) if kind == "mamba" else (2, 0)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["segments"][si][pi])
    tp = nn.tree_index(params["segments"][si][pi], 0)
    B, S = 2, (40 if mode == "full" else 1)
    jctx, ctx = _ctx_pair(mode, S, B)
    cache = (_ssm_cache(cfg, B, 30) if kind == "mamba"
             else _attn_cache(cfg, B, 64, 30))
    h = _rand((B, S, cfg.d_model), 31)
    jb, tb = jax_blocks.BLOCKS[kind], blocks.BLOCKS[kind]
    tcache = _to_torch(cache)
    if what == "apply":
        want_h, wcache, _ = jax.jit(lambda p, h, c: jb.apply(
            jcfg, p, h, jctx, c))(jp, jnp.asarray(h),
                                  jax.tree_util.tree_map(jnp.asarray, cache))
        got_h, gcache, aux = tb.apply(cfg, tp, torch.from_numpy(h), ctx,
                                      tcache)
        _close(got_h, want_h)
        assert aux == 0.0
    else:
        wcache = jax.jit(lambda p, h, c: jb.backfill(jcfg, p, h, jctx, c))(
            jp, jnp.asarray(h), jax.tree_util.tree_map(jnp.asarray, cache))
        gcache = tb.backfill(cfg, tp, torch.from_numpy(h), ctx, tcache)
    assert gcache is tcache                        # written in place
    for k in cache:
        _close(tcache[k], wcache[k])
    return tcache


@pytest.mark.parametrize("mode", ["full", "decode"])
def test_mamba_apply_and_backfill_equal_reference(mode):
    applied = _block_case("mamba", mode, "apply")
    filled = _block_case("mamba", mode, "backfill")
    # the backfill's recurrence is the apply's
    for k in applied:
        torch.testing.assert_close(applied[k], filled[k], rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["full", "decode"])
def test_shared_attn_apply_equals_reference(mode):
    _block_case("attn_shared", mode, "apply")


@pytest.mark.parametrize("mode", ["full", "decode"])
def test_shared_attn_backfill_equals_reference_without_lora(mode):
    """The backfill projects K/V from the shared weights WITHOUT the LoRA
    deltas (the reference's own rule), so its k/v differ from the apply's
    (the LoRA B leaves are random here)."""
    filled = _block_case("attn_shared", mode, "backfill")
    applied = _block_case("attn_shared", mode, "apply")
    assert not torch.equal(filled["k"], applied["k"])
    assert not torch.equal(filled["v"], applied["v"])


# ---------------------------------------------------------------------------
# the model: prefill, dense decode steps, forward_train, training
# ---------------------------------------------------------------------------

S_PROMPT = 45


def test_prefill_and_decode_steps_match_reference():
    """Prefill logits of every exit (45 tokens: the padded SSD path) and
    4 dense decode steps, the reference's greedy tokens fed back; the
    port's kernels on (their plain versions here) and off; every cache
    leaf at the end."""
    jparams, params = _weights()
    jcfg, _ = _cfgs()
    jm = jax_build_model(jcfg)
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (2, S_PROMPT)).astype(np.int32)
    jl, jcache = prefill(jparams, jnp.asarray(toks), jm.init_cache(2, 64))
    want = [(toks, [np.asarray(x) for x in jl])]
    for step in range(4):
        nxt = np.array(jnp.argmax(jl[-1], -1), np.int32)[:, None]
        jl, jcache = decode(jparams, jnp.asarray(nxt),
                            jnp.int32(S_PROMPT + step), jcache)
        want.append((nxt, [np.asarray(x) for x in jl]))
    for use_kernels in (False, True):
        _, cfg = _cfgs(use_kernels=use_kernels)
        m = build_model(cfg, device="cpu")
        cache = m.init_cache(2, 64)
        for step, (tk, wl) in enumerate(want):
            if step == 0:
                tl, cache = m.prefill(params, torch.from_numpy(tk), cache)
            else:
                np.testing.assert_array_equal(
                    _np(torch.argmax(tl[-1], -1)), tk[:, 0])
                tl, cache = m.decode_step(params, torch.from_numpy(tk),
                                          S_PROMPT + step - 1, cache)
            for a, b in zip(tl, wl):
                np.testing.assert_allclose(_np(a), b, atol=LOGIT_TOL,
                                           rtol=LOGIT_TOL)
        for a, b in zip(nn.tree_leaves(cache["segments"]),
                        jax.tree_util.tree_leaves(jcache["segments"])):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(_np(a), np.asarray(b),
                                       atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_forward_train_logits_match_reference():
    jparams, params = _weights()
    jcfg, cfg = _cfgs()
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    jl, jaux = jax.jit(jax_build_model(jcfg).forward_train)(
        jparams, jnp.asarray(toks))
    tl, aux = build_model(cfg, device="cpu").forward_train(
        params, torch.from_numpy(toks))
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
    assert float(aux) == float(jaux) == 0.0


def test_train_steps_match_reference():
    """Three AdamW steps of ``make_train_step`` from the same weights
    (gradients through the SSD scan and the shared block): losses within
    1e-4, and every parameter finite after."""
    jparams, _ = _weights()
    jcfg, cfg = _cfgs()
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(13)
    batches = [rng.integers(0, cfg.vocab_size, (2, 41)).astype(np.int32)
               for _ in range(3)]
    jm = jax_build_model(jcfg)
    jo = jax_steps.make_optimizer(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    js = jo.init(jp)
    jstep = jax.jit(jax_steps.make_train_step(jm, jcfg, jo))
    m = build_model(cfg, device="cpu")
    o = steps.make_optimizer(cfg)
    params = params_from_jax(np_params, cfg, device="cpu")
    state = o.init(params)
    step = steps.make_train_step(m, cfg, o)
    jl, tl = [], []
    for i, b in enumerate(batches):
        jp, js, loss = jstep(jp, js, jnp.asarray(i),
                             {"tokens": jnp.asarray(b[:, :-1]),
                              "labels": jnp.asarray(b[:, 1:])})
        jl.append(float(loss))
        params, state, loss = step(params, state, i,
                                   {"tokens": torch.from_numpy(b[:, :-1]),
                                    "labels": torch.from_numpy(b[:, 1:])})
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=STEP_TOL)
    assert all(bool(torch.isfinite(x).all()) for x in nn.tree_leaves(params))


# ---------------------------------------------------------------------------
# the staged decode against the reference's executor
# ---------------------------------------------------------------------------

STEPS = 5
THRESHOLDS = {"all_exit": (0.0, 0.0, 0.0), "full_depth": (1.1, 1.1, 0.0),
              "mid": None}


def _tokens(vocab):
    return np.random.default_rng(3).integers(0, vocab, (4, 40)).astype(
        np.int32)


def _jax_trace(jcfg, jparams):
    jm = jax_build_model(jcfg)
    ex = JaxExecutor(jm, jcfg)
    step = jax.jit(ex.decode_step)
    d, cache, state = jax.jit(ex.prefill)(jparams, jnp.asarray(_tokens(
        jcfg.vocab_size)), jm.init_cache(4, 64))
    outs = []
    for _ in range(STEPS):
        d, cache, state = step(jparams, d.prediction[:, None], cache, state)
        outs.append([np.asarray(x) for x in (d.prediction, d.exit_index,
                                             d.confidence)])
    return {"outs": outs, "segments_run": np.asarray(state.segments_run),
            "ema": np.asarray(state.ema_conf),
            "cache": [np.asarray(x) for x in
                      jax.tree_util.tree_leaves(cache["segments"])]}


def _port_trace(cfg, params, spy=None):
    m = build_model(cfg, device="cpu")
    ex = StagedExecutor(m, cfg)
    d, cache, state = ex.prefill(params, torch.from_numpy(_tokens(
        cfg.vocab_size)), m.init_cache(4, 64))
    outs = []
    for _ in range(STEPS):
        d, cache, state = ex.decode_step(params, d.prediction[:, None],
                                         cache, state)
        outs.append([x.numpy().copy() for x in (d.prediction, d.exit_index,
                                                d.confidence)])
    return {"outs": outs, "segments_run": state.segments_run.copy(),
            "ema": state.ema_conf.numpy().copy(),
            "cache": [x.numpy().copy()
                      for x in nn.tree_leaves(cache["segments"])],
            "dispatch": dict(ex.dispatch)}


@pytest.fixture(scope="module")
def mid_threshold():
    """A component-0 threshold between the two decode confidences that
    straddle the median of a one-cohort run at (0, 0, 0), both at least
    1e-4 from it."""
    _, params = _weights()
    _, cfg = _cfgs(cascade=dict(thresholds=(0.0, 0.0, 0.0)))
    run = _port_trace(cfg, params)
    c = np.sort(np.concatenate([o[2] for o in run["outs"]]))
    i = len(c) // 2
    assert c[i] - c[i - 1] >= 2e-4
    return float((c[i - 1] + c[i]) / 2)


def _ths(case, mid):
    return (mid, 1.1, 0.0) if case == "mid" else THRESHOLDS[case]


@pytest.mark.parametrize("case", list(THRESHOLDS))
@pytest.mark.parametrize("mode", ["cond_batch", "select"])
@pytest.mark.parametrize("cohorts", [1, 2])
def test_decode_streams_match_reference(mid_threshold, cohorts, mode, case):
    """Tokens, exit indices and ``segments_run`` exactly, confidences,
    EMAs and every cache leaf (the recurrent states included) within
    tolerance, against the reference's executor; with 2 cohorts the major
    and copy layouts bit for bit alike, select mode with the cohort
    scatter (its slot and whole-cohort routes) too."""
    jparams, params = _weights()
    cas = dict(exit_mode=mode, thresholds=_ths(case, mid_threshold),
               n_cohorts=cohorts, cohort_layout="major")
    jcfg, cfg = _cfgs(use_kernels=True, cascade=cas)
    want = _jax_trace(jcfg.replace(use_kernels=False), jparams)
    runs = [_port_trace(cfg, params)]
    if cohorts == 2:
        runs.append(_port_trace(cfg.with_cascade(cohort_layout="copy"),
                                params))
        if mode == "select":
            runs.append(_port_trace(cfg.with_kernel_tune(
                cohort_scatter=True), params))
    for got in runs:
        for (gt, ge, gc), (wt, we, wc) in zip(got["outs"], want["outs"]):
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_array_equal(ge, we)
            np.testing.assert_allclose(gc, wc, rtol=CONF_TOL, atol=CONF_TOL)
        np.testing.assert_array_equal(got["segments_run"],
                                      want["segments_run"])
        np.testing.assert_allclose(got["ema"], want["ema"], rtol=CONF_TOL,
                                   atol=CONF_TOL)
        for a, b in zip(got["cache"], want["cache"]):
            np.testing.assert_allclose(a, b, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    for other in runs[1:]:
        for a, b in zip(runs[0]["outs"], other["outs"]):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)
        for u, v in zip(runs[0]["cache"], other["cache"]):
            np.testing.assert_array_equal(u, v)
    exits = np.stack([o[1] for o in runs[0]["outs"]])
    if case == "all_exit":
        assert not exits.any()
    elif case == "full_depth":
        assert (exits == 2).all()
    else:
        assert set(np.unique(exits)) >= {0, 2}


@pytest.mark.parametrize("case", ["all_exit", "mid"])
def test_select_equals_cond_batch_bit_for_bit(mid_threshold, case):
    """select (with the cohort scatter) and cond_batch: the same tokens,
    exits, confidences and cache bytes, one cohort and two."""
    _, params = _weights()
    for cohorts in (1, 2):
        runs = [_port_trace(_cfgs(use_kernels=True, cascade=dict(
            exit_mode=mode, thresholds=_ths(case, mid_threshold),
            n_cohorts=cohorts))[1].with_kernel_tune(cohort_scatter=True),
            params) for mode in ("select", "cond_batch")]
        for a, b in zip(runs[0]["outs"], runs[1]["outs"]):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)
        for u, v in zip(runs[0]["cache"], runs[1]["cache"]):
            np.testing.assert_array_equal(u, v)


def test_select_restores_the_entry_state_before_the_skip_path(monkeypatch):
    """A select step runs a deep segment, then takes the skip path (the
    backfill) from the step's ENTRY caches: every state leaf the backfill
    sees equals the leaf before the step, whole (a ring-slot snapshot
    would put back one index of the heads axis only, and the recurrence
    would advance twice).  At (0, 0, 0) every row skips, so the selected
    state is the backfill's: one recurrence step from the entry state,
    as cond_batch's."""
    _, params = _weights()
    _, cfg = _cfgs(cascade=dict(exit_mode="select",
                                thresholds=(0.0, 0.0, 0.0)))
    m = build_model(cfg, device="cpu")
    ex = StagedExecutor(m, cfg)
    d, cache, state = ex.prefill(params, torch.from_numpy(_tokens(
        cfg.vocab_size)), m.init_cache(4, 64))
    entry = [[x.clone() for x in nn.tree_leaves(seg)]
             for seg in cache["segments"]]
    seen = {}
    orig = m.backfill_segment

    def spy(si, params, h, ctx, seg_cache):
        seen[si] = [x.clone() for x in nn.tree_leaves(seg_cache)]
        return orig(si, params, h, ctx, seg_cache)

    monkeypatch.setattr(m, "backfill_segment", spy)
    tok = d.prediction[:, None]
    ex.decode_step(params, tok, cache, state)
    assert sorted(seen) == [1, 2]
    for si in (1, 2):
        mask = m.state_leaf_mask(si, cache["segments"][si])
        assert any(mask)
        for before, at_skip, is_state in zip(entry[si], seen[si], mask):
            if is_state:
                torch.testing.assert_close(at_skip, before, rtol=0, atol=0)
    # the selected caches are cond_batch's (the backfill from the entry)
    _, cfg_c = _cfgs(cascade=dict(exit_mode="cond_batch",
                                  thresholds=(0.0, 0.0, 0.0)))
    mc = build_model(cfg_c, device="cpu")
    exc = StagedExecutor(mc, cfg_c)
    _, cache_c, state_c = exc.prefill(params, torch.from_numpy(_tokens(
        cfg.vocab_size)), mc.init_cache(4, 64))
    exc.decode_step(params, tok, cache_c, state_c)
    for a, b in zip(nn.tree_leaves(cache["segments"]),
                    nn.tree_leaves(cache_c["segments"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cohort_scatter_lands_state_leaves_whole(mid_threshold,
                                                 monkeypatch):
    """select mode with 2 cohorts and the cohort scatter: a segment with
    both leaf kinds lands each cohort with two scatter calls (the slot
    route over its 4 ring leaves, the whole-cohort route over its 4 state
    leaves), a state-only segment with one (its 2 state leaves)."""
    _, params = _weights()
    calls = []
    orig = ops.cohort_scatter_tree

    def spy(dst, src, c, C, slot=None):
        calls.append((len(list(nn.tree_leaves(dst))), slot is not None,
                      tuple(next(nn.tree_leaves(src)).shape)))
        return orig(dst, src, c, C, slot=slot)

    monkeypatch.setattr(ops, "cohort_scatter_tree", spy)
    _, cfg = _cfgs(use_kernels=True, cascade=dict(
        exit_mode="select", thresholds=(mid_threshold, 1.1, 0.0),
        n_cohorts=2))
    _port_trace(cfg.with_kernel_tune(cohort_scatter=True), params)
    # a step: segment 1 (state only) 1 call a cohort, segment 2 (ring
    # and state) 2 calls a cohort
    assert len(calls) == STEPS * 2 * (1 + 2)
    assert {c[:2] for c in calls} == {(2, False), (4, False), (4, True)}
    assert (2, False, (2, 2, 3, 544)) in calls


# ---------------------------------------------------------------------------
# the serving engine against the JAX engine
# ---------------------------------------------------------------------------

MIXED_ENGINE = (0.021, 0.021, 0.0)
ENGINE_KW = dict(lane_batch=2, n_lanes=2, cache_len=128, chunk=4)
# six requests for four slots, budgets that end at different steps: a
# lane whose slot frees re-prefills with its resident's full context
# (prompt + generated, past 32: the padded SSD path) and the new prompt
PROMPTS = ((40, 7), (20, 3), (33, 6), (12, 4), (45, 5), (25, 6))


def _engine_cfg(pkg, mode="cond_batch", cohorts=1, autotune=True,
                layout="major", ths=MIXED_ENGINE):
    jcfg, cfg = _cfgs(cascade=dict(exit_mode=mode, thresholds=ths,
                                   n_cohorts=cohorts, cohort_layout=layout))
    cfg = jcfg if pkg == "jax" else cfg.replace(use_kernels=True)
    if autotune:
        cfg = cfg.with_autotune(enabled=True, bins=64, shadow_every=2,
                                min_shadow=8, resolve_every=4)
    return cfg


def _drive(pkg, cfg, params, runtime="host"):
    if pkg == "jax":
        eng = JaxEngine(cfg, jax_build_model(cfg), params, runtime=runtime,
                        **ENGINE_KW)
        make = JaxRequest
    else:
        eng = CascadeServingEngine(cfg, build_model(cfg, device="cpu"),
                                   params, runtime=runtime, device="cpu",
                                   **ENGINE_KW)
        make = Request
    rng = np.random.default_rng(5)
    for i, (n, new) in enumerate(PROMPTS):
        eng.submit(make(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                        .astype(np.int32), max_new_tokens=new))
    eng.run(200)
    return eng


def _streams(eng):
    return {r: (f["tokens"], f["exit_depths"])
            for r, f in sorted(eng.finished.items())}


def _carried(eng):
    return np.sum([np.asarray(ln["state"].segments_run)
                   for ln in eng.lanes], axis=0).tolist()


@pytest.mark.parametrize("cohorts", [1, 2])
@pytest.mark.parametrize("mode", ["cond_batch", "select"])
@pytest.mark.parametrize("runtime", ["host", "device"])
def test_engine_matches_reference_engine(runtime, mode, cohorts):
    """Streams, exits, the carried segments_run and every telemetry
    counter (a shadow step every 2 positions) equal the JAX engine's
    exactly, through lane re-prefills with residents; the exits are
    mixed."""
    jparams, params = _weights()
    want = _drive("jax", _engine_cfg("jax", mode, cohorts), jparams, runtime)
    got = _drive("torch", _engine_cfg("torch", mode, cohorts), params,
                 runtime)
    assert sorted(got.finished) == list(range(len(PROMPTS)))
    assert _streams(got) == _streams(want)
    assert _carried(got) == _carried(want)
    tw = jax_merge(want.lane_telemetry())
    tg = merge_telemetry(got.lane_telemetry())
    assert tw.keys() == tg.keys()
    for k in tw:
        np.testing.assert_array_equal(np.asarray(tw[k]), tg[k], err_msg=k)
    assert tg["shadow_steps"] > 0
    depths = {d for _, e in _streams(got).values() for d in e}
    assert depths == {0, 1, 2}
    assert got.stats()["prefills"] > ENGINE_KW["n_lanes"]


def test_engine_layouts_autotune_and_modes_agree_bit_for_bit():
    """Within the port: 2 cohorts in the copy layout serve what the major
    layout serves; autotune off serves what autotune on serves (the
    shadow step changes what executes, never what is produced); select
    with the cohort scatter serves what cond_batch serves.  (The host
    and device runtimes are each held to the JAX engine's own runtime
    above: a queued request joins the device runtime at a chunk boundary,
    the reference's sanctioned divergence, so their re-prefills pad
    differently.)"""
    _, params = _weights()
    base = _streams(_drive("torch", _engine_cfg("torch", cohorts=2),
                           params))
    for cfg in (_engine_cfg("torch", cohorts=2, layout="copy"),
                _engine_cfg("torch", cohorts=2, autotune=False),
                _engine_cfg("torch", "select", 2, autotune=False)
                .with_kernel_tune(cohort_scatter=True)):
        assert _streams(_drive("torch", cfg, params)) == base


def test_paged_hybrid_is_refused_with_reference_message():
    jcfg, cfg = _cfgs()
    jcfg = jcfg.with_paged_cache(layout="paged", block_size=8)
    cfg = cfg.with_paged_cache(layout="paged", block_size=8)
    with pytest.raises(ValueError) as jerr:
        JaxPagedCache(jax_build_model(jcfg), jcfg, lane_batch=2,
                      n_lanes=1, cache_len=32)
    with pytest.raises(ValueError) as err:
        PagedCascadeCache(build_model(cfg, device="cpu"), cfg,
                          lane_batch=2, n_lanes=1, cache_len=32)
    assert str(err.value) == str(jerr.value)
    assert "['conv', 'state']" in str(err.value)


# ---------------------------------------------------------------------------
# MACs, the CLI, the bridge
# ---------------------------------------------------------------------------

def test_macs_match_reference():
    full, jfull = get_config(ARCH), jax_get_config(ARCH)
    jcfg, cfg = _cfgs()
    for c, j in ((full, jfull), (cfg, jcfg)):
        for kv in (1, 100, 512, 4096):
            assert macs.segment_macs_per_token(c, kv) == \
                jax_macs.segment_macs_per_token(j, kv)
        assert macs.param_count(c) == jax_macs.param_count(j)
    for kind in ("mamba", "attn_shared"):
        assert macs._layer_macs_per_token(full, kind, 512) == \
            jax_macs._layer_macs_per_token(jfull, kind, 512)


def test_serve_cli_smoke():
    stats = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "4", "--max-new", "4", "--cohorts",
                        "2"])
    assert stats["requests_finished"] == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_with_shared_is_bit_exact(dtype):
    jcfg, cfg = _cfgs()
    jcfg, cfg = jcfg.replace(dtype=dtype), cfg.replace(dtype=dtype)
    jparams = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(5))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tp = params_from_jax(np_params, cfg, device="cpu")
    assert set(tp["shared"]) == {"attn", "mlp"}
    assert tp["shared"]["attn"]["wq"].dtype == getattr(torch, dtype)
    back = params_to_numpy(tp)
    flat_a, tree_a = jax.tree_util.tree_flatten(np_params)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    own = build_model(cfg, device="cpu").init(0)
    assert jax.tree_util.tree_map(lambda x: (tuple(x.shape), x.dtype),
                                  tp) == jax.tree_util.tree_map(
        lambda x: (tuple(x.shape), x.dtype), own)
    # the shared block is the hybrid's: without it the tree is refused
    del np_params["shared"]
    with pytest.raises(ValueError, match="shared"):
        params_from_jax(np_params, cfg, device="cpu")


# ---------------------------------------------------------------------------
# tests/test_archs_smoke.py's three per-arch tests, on the port
# ---------------------------------------------------------------------------

def test_forward_shapes_and_finite():
    cfg = reduced(get_config(ARCH))
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    logits, aux = model.forward_train(params, toks)
    assert len(logits) == cfg.cascade.n_components
    for lg in logits:
        assert lg.shape == (2, 16, cfg.vocab_size)
        assert bool(torch.isfinite(lg.float()).all())
    assert bool(torch.isfinite(torch.as_tensor(aux)))


def test_train_step_decreases_loss_direction():
    cfg = reduced(get_config(ARCH))
    model = build_model(cfg, device="cpu")
    params = model.init(1)
    opt = steps.make_optimizer(cfg)
    opt_state = opt.init(params)
    step_fn = steps.make_train_step(model, cfg, opt)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 17)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    losses = []
    for i in range(3):
        params, opt_state, loss = step_fn(params, opt_state, i, batch)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]        # same batch: loss must drop


def test_prefill_decode_matches_full_forward():
    cfg = reduced(get_config(ARCH)).replace(dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(2)
    S = 13
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, S + 1)).astype(np.int32))
    with torch.no_grad():
        logits_full, _ = model.forward_train(params, toks)
        cache = model.init_cache(2, S + 4)
        el, cache = model.prefill(params, toks[:, :S], cache)
        sl, cache = model.decode_step(params, toks[:, S:S + 1], S, cache)
    for a, b in zip(logits_full, sl):
        np.testing.assert_allclose(_np(a[:, S, :]), _np(b), rtol=2e-3,
                                   atol=2e-3)
    for a, b in zip(logits_full, el):
        np.testing.assert_allclose(_np(a[:, S - 1, :]), _np(b), rtol=2e-3,
                                   atol=2e-3)


def test_mamba_decode_runs_without_host_reads(monkeypatch):
    """No ``.item()``, ``nonzero`` or ``tolist`` in a mamba decode step or
    its backfill (a captured graph cannot read the device)."""
    def boom(*a, **kw):
        raise AssertionError("host read in a mamba step")

    _, cfg = _cfgs()
    _, tp = _layer()
    cache = _to_torch(_ssm_cache(cfg, 2, 40))
    x = torch.from_numpy(_rand((2, 1, cfg.d_model), 41))
    for name in ("item", "tolist", "nonzero", "__bool__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, boom)
    out, _ = ssm.ssm_decode_step(tp, cfg, x, cache)
    ssm.ssm_backfill_step(tp, cfg, x, cache)
    monkeypatch.undo()
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
