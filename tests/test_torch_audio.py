"""The audio family: the whisper encoder (the ``enc`` block), the encdec
block with cross-attention K/V cached at prefill, the read-only cache leaf
kind through the staged executor's snapshots and cohorts, the frame
inputs through the model, the executor, the steps and the serving engine,
whisper-tiny — the port against the JAX package on bridged weights, plus
the port's own contracts.

Config: ``reduced(whisper-tiny, n_layers=4)``, f32, 3 components with
exits after layers 1 and 3 (whisper-tiny's own segments (0, 1), (1, 3),
(3, 4)): one encdec stage a segment.  d 256, 4 / 4 heads of 64, d_ff 512,
layernorm, gelu, learned positions; the reduced encoder has 2 layers over
30 frames.  An encdec layer's cache is ``{"cross": {k, v}, "self": {k,
v}}``: the cross K/V (B, 30, 4, 64) are read-only leaves, the self K/V
ring leaves.

The JAX init leaves every layernorm degenerate (``w`` ones, ``b`` zeros),
so before bridging each norm leaf gets N(0, 0.5²) noise added (numpy seed
17): a norm read as the identity, or a missing bias, then shows.

Tolerances: the sublayers, the blocks and the encoder within 2e-5
(``TOL``: f32 attention and layernorm over 256-wide rows contracted in
other orders, measured up to ~3e-6); exit logits and cache leaves 1e-4
(``LOGIT_TOL``, as ``tests/test_torch_moe.py``); train-step losses 1e-4;
decode streams: tokens, exit indices, ``segments_run`` and telemetry
counters exactly, confidences and EMAs 1e-5; within the port (host ≡
device runtime, major ≡ copy, select ≡ cond_batch, autotune on ≡ off)
bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.autotune import merge_telemetry as jax_merge
from repro.configs import get_config as jax_get_config
from repro.configs import list_configs as jax_list_configs
from repro.configs import reduced as jax_reduced
from repro.core import macs as jax_macs
from repro.core.exec import StagedExecutor as JaxExecutor
from repro.launch import steps as jax_steps
from repro.models import blocks as jax_blocks
from repro.models.model import build_model as jax_build_model
from repro.models.model import extra_input_shapes as jax_extra_shapes
from repro.serving.engine import CascadeServingEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro.serving.paged.cache import PagedCascadeCache as JaxPagedCache
from repro_torch.autotune import merge_telemetry
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.core import exec as exec_mod
from repro_torch.core import macs
from repro_torch.core.exec import StagedExecutor
from repro_torch.kernels import ops
from repro_torch.launch import serve, steps
from repro_torch.models import blocks, nn
from repro_torch.models.model import build_model, extra_input_shapes
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


TOL = 2e-5
LOGIT_TOL = 1e-4
CONF_TOL = 1e-5
STEP_TOL = 1e-4
ARCH = "whisper-tiny"
W_CACHE = 64


def _cfgs(**kw):
    cas = dict(n_components=3, exit_boundaries=(1, 3),
               thresholds=(0.9, 0.9, 0.0))
    cas.update(kw.pop("cascade", {}))
    jcfg = jax_reduced(jax_get_config(ARCH), n_layers=4).replace(
        dtype="float32", **kw).with_cascade(**cas)
    cfg = reduced(get_config(ARCH), n_layers=4).replace(
        dtype="float32", **kw).with_cascade(**cas)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _undegenerate(tree, rng, norm=False):
    """The JAX init with every layernorm leaf (``w`` ones, ``b`` zeros)
    moved off its constant by N(0, 0.5²) noise."""
    if isinstance(tree, dict):
        return {k: _undegenerate(v, rng, norm or k in ("norm", "final_norm"))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_undegenerate(v, rng, norm) for v in tree]
    if not norm:
        return tree
    return jnp.asarray(np.asarray(tree, np.float32) + 0.5
                       * rng.standard_normal(tree.shape),
                       np.float32).astype(tree.dtype)


_WEIGHTS = {}


def _weights():
    """The reference's seed-0 init, its layernorms randomised, bridged
    (once)."""
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


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _tree_to_torch(tree):
    return nn.tree_map(lambda v: torch.from_numpy(np.array(v)), tree)


def _tree_to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _audio(B, cfg, seed):
    """Frame embeddings (B, n_audio_frames, d), numpy."""
    return _rand((B, cfg.n_audio_frames, cfg.d_model), seed)


def _extra_pair(audio):
    return ({"audio_embeds": jnp.asarray(audio)},
            {"audio_embeds": torch.from_numpy(audio)})


# ---------------------------------------------------------------------------
# the config, the leaf kinds
# ---------------------------------------------------------------------------

def test_config_copy_equals_reference_field_by_field():
    ours, ref = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.segments == ref.segments == ((0, 1), (1, 3), (3, 4))
    assert dataclasses.asdict(reduced(ours)) == dataclasses.asdict(
        jax_reduced(ref))
    assert reduced(ours).encoder_layers == 2
    assert reduced(ours).n_audio_frames == 30


def test_full_width_config_builds():
    """whisper-tiny at its published widths (no weights drawn: the card's
    phase draws them): 4 encdec layers, one stage a segment; a bf16 cache
    of 4 rows at cache_len 448 on the meta device — the cross K/V (1, 4,
    1500, 6, 64) read-only, the self K/V (1, 4, 448, 6, 64) ring leaves;
    the reference's parameter count, and the reference's init at 57.1 M
    parameters, 7.66 M of them the encoder's."""
    cfg = get_config(ARCH)
    model = build_model(cfg, device="cpu")
    assert blocks.layer_kinds(cfg) == jax_blocks.layer_kinds(
        jax_get_config(ARCH)) == ["encdec"] * 4
    assert model.segment_runs == [[("encdec", 1)], [("encdec", 2)],
                                  [("encdec", 1)]]
    cache = model.init_cache(4, 448, dtype=torch.bfloat16, device="meta")
    seg = cache["segments"][1]
    assert list(seg[0]) == ["cross", "self"]
    assert [(tuple(x.shape), x.dtype) for x in nn.tree_leaves(seg)] == [
        ((2, 4, 1500, 6, 64), torch.bfloat16)] * 2 + [
        ((2, 4, 448, 6, 64), torch.bfloat16)] * 2
    assert model.leaf_kinds(1, seg) == ["read", "read", "ring", "ring"]
    assert model.state_leaf_mask(1, seg) == [False] * 4
    assert macs.param_count(cfg) == jax_macs.param_count(jax_get_config(ARCH))
    shapes = jax.eval_shape(jax_build_model(jax_get_config(ARCH)).init,
                            jax.random.PRNGKey(0))
    count = lambda t: sum(int(np.prod(x.shape))
                          for x in jax.tree_util.tree_leaves(t))
    assert round(count(shapes) / 1e6, 1) == 57.1
    assert round(count(shapes["encoder"]) / 1e6, 2) == 7.66


def test_every_family_has_one_kind_per_cache_leaf():
    """``leaf_kinds`` has one entry per :func:`nn.tree_leaves` leaf of every
    segment's cache for every registered LLM architecture, ``read`` only
    for an encdec layer's cross K/V; ``_split_leaves`` leaves read-only
    leaves out of both lists and refuses a list of another length."""
    for name in list_configs():
        cfg = get_config(name)
        if cfg.family == "cnn":
            continue
        model = build_model(reduced(cfg), device="cpu")
        cache = model.init_cache(2, 16, device="meta")
        for si, seg in enumerate(cache["segments"]):
            kinds = model.leaf_kinds(si, seg)
            assert len(kinds) == len(list(nn.tree_leaves(seg))), (name, si)
            assert ("read" in kinds) == (cfg.family == "audio")
    _, cfg = _cfgs()
    model = build_model(cfg, device="cpu")
    seg = model.init_cache(2, 16, device="meta")["segments"][1]
    kinds = model.leaf_kinds(1, seg)
    assert kinds == ["read", "read", "ring", "ring"]
    ring, state = exec_mod._split_leaves(seg, kinds)
    assert [tuple(x.shape) for x in ring] == [(2, 2, 16, 4, 64)] * 2
    assert state == []
    with pytest.raises(ValueError, match="4 cache leaves"):
        exec_mod._split_leaves(seg, kinds[:2])


def test_extra_input_shapes_equal_reference():
    for name in jax_list_configs():
        if name == "ci-resnet18":
            continue
        want = jax_extra_shapes(jax_get_config(name), 3)
        if name in list_configs():
            assert extra_input_shapes(get_config(name), 3) == want
    assert extra_input_shapes(get_config(ARCH), 4) == {
        "audio_embeds": (4, 1500, 384)}
    assert extra_input_shapes(get_config("qwen2.5-3b"), 4) == {}


# ---------------------------------------------------------------------------
# the sublayers and blocks against the reference
# ---------------------------------------------------------------------------

def _layer(si=1, i=0):
    """Layer ``i`` of segment ``si``'s encdec stage: (jax, port) params."""
    jparams, params = _weights()
    return (jax.tree_util.tree_map(lambda a: a[i], jparams["segments"][si][0]),
            nn.tree_index(params["segments"][si][0], i))


def _ctx_pair(mode, S, mem=None, W=W_CACHE, t=50):
    """A (jax ctx, port ctx) pair: full mode over S positions with the
    memory ``mem`` (numpy, or None), or a decode step at position t (the
    memory too, when given: a cacheless decode projects it)."""
    kpos = np.where(np.arange(W) < t, np.arange(W), -1).astype(np.int32)
    jmem = None if mem is None else jnp.asarray(mem)
    tmem = None if mem is None else torch.from_numpy(mem)
    if mode == "full":
        pos = np.arange(S, dtype=np.int32)
        ws = np.where(np.arange(W) < S, np.arange(W), -1).astype(np.int32)
        jctx = {"mode": "full", "positions": jnp.asarray(pos),
                "write_slots": jnp.asarray(ws), "cross": jmem,
                "shared": None, "kpos": jnp.asarray(kpos)}
        ctx = {"mode": "full", "positions": torch.from_numpy(pos),
               "write_slots": torch.from_numpy(ws),
               "kpos": torch.from_numpy(kpos), "shared": None, "cross": tmem}
        return jctx, ctx
    jctx = {"mode": "decode", "t": jnp.int32(t), "slot": jnp.int32(t % W),
            "kpos": jnp.asarray(kpos), "positions": None,
            "write_slots": None, "cross": jmem, "shared": None}
    kpos_t = kpos.copy()
    kpos_t[t % W] = t
    ctx = {"mode": "decode", "t": torch.tensor(t, dtype=torch.int32),
           "slot": torch.tensor(t % W), "kpos": torch.from_numpy(kpos),
           "kpos_t": torch.from_numpy(kpos_t), "shared": None, "cross": tmem}
    return jctx, ctx


def _kv(cfg, B, T, seed):
    shape = (B, T, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": _rand(shape, seed), "v": _rand(shape, seed + 1)}


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("case", ["full", "full_cache", "decode_cache",
                                  "decode_memory"])
def test_cross_attention_equals_reference(case, gate):
    """``_cross_attention`` in full mode (no cache; a cache the memory's
    K/V are copied into, in place), in decode mode reading the cache (and
    writing nothing) or, without one, projecting the memory; with and
    without vlm's tanh ``gate``."""
    jcfg, cfg = _cfgs()
    jp, tp = _layer()
    jp, tp = jp["xattn"], dict(tp["xattn"])
    if gate:
        jp = {**jp, "gate": jnp.float32(0.7)}
        tp["gate"] = torch.tensor(0.7)
    B, T = 2, cfg.n_audio_frames
    mode = case.split("_")[0]
    S = 12 if mode == "full" else 1
    mem = _audio(B, cfg, 30)
    jctx, ctx = _ctx_pair(mode, S, mem=None if case == "decode_cache"
                          else mem)
    h = _rand((B, S, cfg.d_model), 31)
    cache = None
    if case.endswith("cache"):
        cache = (_kv(cfg, B, T, 32) if mode == "decode" else
                 nn.tree_map(np.zeros_like, _kv(cfg, B, T, 32)))
    jcache = None if cache is None else _tree_to_jax(cache)
    tcache = None if cache is None else _tree_to_torch(cache)
    want, wcache = jax.jit(lambda p, h, c: jax_blocks._cross_attention(
        jcfg, p, h, jctx, c))(jp, jnp.asarray(h), jcache)
    got, gcache = blocks._cross_attention(cfg, tp, torch.from_numpy(h), ctx,
                                          tcache)
    _close(got, want)
    assert gcache is tcache
    if cache is not None:
        for name in ("k", "v"):
            _close(tcache[name], wcache[name])
        if mode == "decode":                  # read, never written
            for name in ("k", "v"):
                np.testing.assert_array_equal(_np(tcache[name]), cache[name])
        else:
            assert bool(tcache["k"].abs().sum() > 0)
    if gate:                                  # the gate scales the output
        plain, _ = blocks._cross_attention(
            cfg, {k: v for k, v in tp.items() if k != "gate"},
            torch.from_numpy(h), ctx, None if cache is None
            else _tree_to_torch(cache))
        _close(got, plain * np.tanh(0.7))


def test_enc_apply_and_encode_audio_equal_reference():
    """One encoder layer (bidirectional plain attention, no cache), and
    the whole encoder (positions, layers, final norm) over frame
    embeddings."""
    jparams, params = _weights()
    jcfg, cfg = _cfgs()
    x = _audio(2, cfg, 40)
    jp = jax.tree_util.tree_map(lambda a: a[1],
                                jparams["encoder"]["stages"])
    tp = nn.tree_index(params["encoder"]["stages"], 1)
    jctx = {"mode": "full", "positions": None, "write_slots": None,
            "cross": None, "shared": None}
    want, _, _ = jax.jit(lambda p, h: jax_blocks.BLOCKS["enc"].apply(
        jcfg, p, h, jctx, None))(jp, jnp.asarray(x))
    got, cache, aux = blocks.BLOCKS["enc"].apply(cfg, tp, torch.from_numpy(x),
                                                 {"mode": "full"}, None)
    _close(got, want)
    assert cache is None and aux == 0.0
    jm, m = jax_build_model(jcfg), build_model(cfg, device="cpu")
    want = jax.jit(jm._encode_audio)(jparams, jnp.asarray(x))
    got = m._encode_audio(params, torch.from_numpy(x))
    _close(got, want)
    assert m._make_cross(params, {"audio_embeds": torch.from_numpy(x)},
                         "decode") is None
    assert blocks.BLOCKS["enc"].init_cache(cfg, 2, 8, torch.float32,
                                           "cpu") == {}


@pytest.mark.parametrize("mode", ["full", "decode"])
def test_encdec_apply_and_backfill_equal_reference(mode):
    """The encdec block's apply and backfill from the same caches in both
    modes: h, every cache leaf; written in place; the backfill leaves the
    cross K/V as they were (decode) and writes the self ring's slot."""
    jcfg, cfg = _cfgs()
    jp, tp = _layer()
    B, T = 2, cfg.n_audio_frames
    S = 20 if mode == "full" else 1
    jctx, ctx = _ctx_pair(mode, S, mem=_audio(B, cfg, 50)
                          if mode == "full" else None)
    cache = {"cross": _kv(cfg, B, T, 52), "self": _kv(cfg, B, W_CACHE, 54)}
    h = _rand((B, S, cfg.d_model), 56)
    jb, tb = jax_blocks.BLOCKS["encdec"], blocks.BLOCKS["encdec"]
    for what in ("apply", "backfill"):
        tcache = _tree_to_torch(cache)
        if what == "apply":
            want_h, wcache, _ = jax.jit(lambda p, h, c: jb.apply(
                jcfg, p, h, jctx, c))(jp, jnp.asarray(h), _tree_to_jax(cache))
            got_h, gcache, aux = tb.apply(cfg, tp, torch.from_numpy(h), ctx,
                                          tcache)
            _close(got_h, want_h)
            assert aux == 0.0
        else:
            wcache = jax.jit(lambda p, h, c: jb.backfill(
                jcfg, p, h, jctx, c))(jp, jnp.asarray(h), _tree_to_jax(cache))
            gcache = tb.backfill(cfg, tp, torch.from_numpy(h), ctx, tcache)
            for name in ("k", "v"):
                np.testing.assert_array_equal(_np(tcache["cross"][name]),
                                              cache["cross"][name])
        assert gcache is tcache
        for key in ("cross", "self"):
            for name in ("k", "v"):
                _close(tcache[key][name], wcache[key][name])


# ---------------------------------------------------------------------------
# the model: prefill, dense decode steps, forward_train, training
# ---------------------------------------------------------------------------

S_PROMPT = 45


def test_prefill_and_decode_steps_match_reference():
    """Prefill logits of every exit (the encoder over the frames, each
    layer's cross K/V cached) and 4 dense decode steps, the reference's
    greedy tokens fed back; the port's kernels on (their plain versions
    here) and off; every cache leaf at the end, the cross K/V as the
    prefill left them."""
    jparams, params = _weights()
    jcfg, _ = _cfgs()
    jm = jax_build_model(jcfg)
    audio = _audio(2, jcfg, 60)
    jex, tex = _extra_pair(audio)
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (2, S_PROMPT)).astype(np.int32)
    jl, jcache = prefill(jparams, jnp.asarray(toks), jm.init_cache(2, W_CACHE),
                         jex)
    want = [(toks, [np.asarray(x) for x in jl])]
    for step in range(4):
        nxt = np.array(jnp.argmax(jl[-1], -1), np.int32)[:, None]
        jl, jcache = decode(jparams, jnp.asarray(nxt),
                            jnp.int32(S_PROMPT + step), jcache)
        want.append((nxt, [np.asarray(x) for x in jl]))
    for use_kernels in (False, True):
        _, cfg = _cfgs(use_kernels=use_kernels)
        m = build_model(cfg, device="cpu")
        cache = m.init_cache(2, W_CACHE)
        for step, (tk, wl) in enumerate(want):
            if step == 0:
                tl, cache = m.prefill(params, torch.from_numpy(tk), cache,
                                      tex)
                cross = [x.clone() for si, seg in
                         enumerate(cache["segments"])
                         for x, k in zip(nn.tree_leaves(seg),
                                         m.leaf_kinds(si, seg))
                         if k == "read"]
            else:
                np.testing.assert_array_equal(
                    _np(torch.argmax(tl[-1], -1)), tk[:, 0])
                tl, cache = m.decode_step(params, torch.from_numpy(tk),
                                          S_PROMPT + step - 1, cache)
            for a, b in zip(tl, wl):
                np.testing.assert_allclose(_np(a), b, atol=LOGIT_TOL,
                                           rtol=LOGIT_TOL)
        for a, b in zip(nn.tree_leaves(cache["segments"]),
                        jax.tree_util.tree_leaves(jcache["segments"]),
                        strict=True):
            np.testing.assert_allclose(_np(a), np.asarray(b),
                                       atol=LOGIT_TOL, rtol=LOGIT_TOL)
        after = [x for si, seg in enumerate(cache["segments"])
                 for x, k in zip(nn.tree_leaves(seg), m.leaf_kinds(si, seg))
                 if k == "read"]
        assert len(after) == 2 * 3
        for a, b in zip(cross, after):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_forward_train_logits_match_reference():
    jparams, params = _weights()
    jcfg, cfg = _cfgs()
    audio = _audio(2, cfg, 61)
    jex, tex = _extra_pair(audio)
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    jl, jaux = jax.jit(jax_build_model(jcfg).forward_train)(
        jparams, jnp.asarray(toks), jex)
    tl, aux = build_model(cfg, device="cpu").forward_train(
        params, torch.from_numpy(toks), tex)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
    assert float(aux) == float(jaux) == 0.0


def test_train_steps_match_reference():
    """Three AdamW steps of ``make_train_step`` from the same weights with
    the frames in ``batch["extra"]`` (gradients through the encoder and
    the cross-attention): losses within 1e-4, every parameter finite
    after, the encoder's moved."""
    jparams, _ = _weights()
    jcfg, cfg = _cfgs()
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(13)
    batches = [rng.integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
               for _ in range(3)]
    audio = _audio(2, cfg, 62)
    jex, tex = _extra_pair(audio)
    jm = jax_build_model(jcfg)
    jo = jax_steps.make_optimizer(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    js = jo.init(jp)
    jstep = jax.jit(jax_steps.make_train_step(jm, jcfg, jo))
    m = build_model(cfg, device="cpu")
    o = steps.make_optimizer(cfg)
    params = params_from_jax(np_params, cfg, device="cpu")
    enc0 = params["encoder"]["stages"]["attn"]["wq"].clone()
    state = o.init(params)
    step = steps.make_train_step(m, cfg, o)
    jl, tl = [], []
    for i, b in enumerate(batches):
        jp, js, loss = jstep(jp, js, jnp.asarray(i),
                             {"tokens": jnp.asarray(b[:, :-1]),
                              "labels": jnp.asarray(b[:, 1:]),
                              "extra": jex})
        jl.append(float(loss))
        params, state, loss = step(params, state, i,
                                   {"tokens": torch.from_numpy(b[:, :-1]),
                                    "labels": torch.from_numpy(b[:, 1:]),
                                    "extra": tex})
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=STEP_TOL)
    assert all(bool(torch.isfinite(x).all()) for x in nn.tree_leaves(params))
    assert not torch.equal(params["encoder"]["stages"]["attn"]["wq"], enc0)


def test_extra_inputs_refused_where_a_family_takes_none():
    """The frames ride the audio family's prefill, train and serve steps
    (decode takes them and ignores them, as the reference does); a family
    without modality inputs refuses them."""
    _, cfg = _cfgs()
    dense = reduced(get_config("qwen2.5-3b"))
    dm = build_model(dense, device="cpu")
    dp = dm.init(0)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    junk = {"audio_embeds": torch.zeros(2, 30, dense.d_model)}
    with pytest.raises(NotImplementedError, match="takes none"):
        dm.prefill(dp, torch.zeros((2, 4), dtype=torch.int32),
                   dm.init_cache(2, 16), junk)
    with pytest.raises(NotImplementedError, match="takes none"):
        steps.make_serve_step(dm, dense)(dp, tok, dm.init_cache(2, 16),
                                         None, junk)
    m = build_model(cfg, device="cpu")
    _, params = _weights()
    tex = {"audio_embeds": torch.from_numpy(_audio(2, cfg, 63))}
    pre = steps.make_prefill_step(m, cfg)
    serve_step = steps.make_serve_step(m, cfg)
    tok, _, _, cache, state = pre(params, torch.zeros((2, 8),
                                                      dtype=torch.int32),
                                  m.init_cache(2, 16), tex)
    a = serve_step(params, tok[:, None], cache, state, tex)
    assert a[0].shape == (2,)


# ---------------------------------------------------------------------------
# the staged decode against the reference's executor
# ---------------------------------------------------------------------------

STEPS = 5


def _tokens(vocab):
    return np.random.default_rng(3).integers(0, vocab, (4, 40)).astype(
        np.int32)


def _lane_audio(cfg):
    return _audio(4, cfg, 70)


def _jax_trace(jcfg, jparams):
    jm = jax_build_model(jcfg)
    ex = JaxExecutor(jm, jcfg)
    step = jax.jit(ex.decode_step)
    d, cache, state = jax.jit(ex.prefill)(
        jparams, jnp.asarray(_tokens(jcfg.vocab_size)),
        jm.init_cache(4, W_CACHE), {"audio_embeds": jnp.asarray(
            _lane_audio(jcfg))})
    outs = []
    for _ in range(STEPS):
        d, cache, state = step(jparams, d.prediction[:, None], cache, state)
        outs.append([np.asarray(x) for x in (d.prediction, d.exit_index,
                                             d.confidence)])
    return {"outs": outs, "segments_run": np.asarray(state.segments_run),
            "ema": np.asarray(state.ema_conf),
            "cache": [np.asarray(x) for x in
                      jax.tree_util.tree_leaves(cache["segments"])]}


def _port_trace(cfg, params, hook=None):
    """The port's executor: a prefill over the lane's frames, then STEPS
    staged decode steps; ``hook(model, executor, cache)`` runs between
    the prefill and the decode steps."""
    m = build_model(cfg, device="cpu")
    ex = StagedExecutor(m, cfg)
    d, cache, state = ex.prefill(
        params, torch.from_numpy(_tokens(cfg.vocab_size)),
        m.init_cache(4, W_CACHE),
        extra={"audio_embeds": torch.from_numpy(_lane_audio(cfg))})
    if hook is not None:
        hook(m, ex, cache)
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


def _mid_cfgs(mid, **cas):
    return _cfgs(use_kernels=True,
                 cascade={"thresholds": (mid, 1.1, 0.0), **cas})


@pytest.fixture(scope="module")
def jax_trace(mid_threshold):
    """The reference executor's trace at (mid, 1.1, 0.0): cond_batch, 2
    cohorts (its modes, cohorts and layouts serve the same streams)."""
    jparams, _ = _weights()
    jcfg, _ = _mid_cfgs(mid_threshold, exit_mode="cond_batch", n_cohorts=2)
    return _jax_trace(jcfg.replace(use_kernels=False), jparams)


@pytest.mark.parametrize("mode", ["cond_batch", "select"])
@pytest.mark.parametrize("cohorts", [1, 2])
def test_decode_streams_match_reference(mid_threshold, jax_trace, cohorts,
                                        mode):
    """Tokens and exit indices exactly, confidences, EMAs and every cache
    leaf (the cross K/V included) within tolerance, against the reference
    executor's run; ``segments_run`` exactly where the run is the
    reference's own (cond_batch, 2 cohorts), C a segment a step in select
    mode; with 2 cohorts the major and copy layouts bit for bit alike,
    select mode with the cohort scatter (its slot route) too."""
    _, params = _weights()
    _, cfg = _mid_cfgs(mid_threshold, exit_mode=mode, n_cohorts=cohorts,
                       cohort_layout="major")
    want = jax_trace
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
        if mode == "select":
            assert got["segments_run"].tolist() == [STEPS * cohorts] * 3
        elif cohorts == 2:
            np.testing.assert_array_equal(got["segments_run"],
                                          want["segments_run"])
        np.testing.assert_allclose(got["ema"], want["ema"], rtol=CONF_TOL,
                                   atol=CONF_TOL)
        assert len(got["cache"]) == len(want["cache"])
        for a, b in zip(got["cache"], want["cache"]):
            np.testing.assert_allclose(a, b, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    for other in runs[1:]:
        for a, b in zip(runs[0]["outs"], other["outs"]):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)
        for u, v in zip(runs[0]["cache"], other["cache"]):
            np.testing.assert_array_equal(u, v)
    exits = np.stack([o[1] for o in runs[0]["outs"]])
    assert set(np.unique(exits)) >= {0, 2}


def _cross_storages(model, cache):
    return {x.untyped_storage().data_ptr(): x
            for si, seg in enumerate(cache["segments"])
            for x, k in zip(nn.tree_leaves(seg), model.leaf_kinds(si, seg))
            if k == "read"}


VARIANTS = {
    "cond_batch": dict(exit_mode="cond_batch", n_cohorts=1),
    "cond_batch_major": dict(exit_mode="cond_batch", n_cohorts=2),
    "cond_batch_copy": dict(exit_mode="cond_batch", n_cohorts=2,
                            cohort_layout="copy"),
    "select": dict(exit_mode="select", n_cohorts=1),
    "select_scatter": dict(exit_mode="select", n_cohorts=2),
    # every cell skips at (0, 0, 0), so every shadow step observes
    "shadow_cond_batch": dict(exit_mode="cond_batch", n_cohorts=2,
                              thresholds=(0.0, 0.0, 0.0)),
    "shadow_select": dict(exit_mode="select", n_cohorts=2),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_never_touches_cross_leaves(mid_threshold, variant,
                                           monkeypatch):
    """In every mode, the cross K/V leaves are bit for bit what the
    prefill left after decode steps, and no snapshot (select's, the
    shadow step's observation), selection or scatter reads or writes
    them: every leaf ``_SlotRows`` takes and every leaf the cohort scatter
    lands is a self ring leaf.  (As RING leaves — the two-kind mask —
    they would be snapshotted, selected and landed at ring slot t % W.)"""
    _, params = _weights()
    _, cfg = _mid_cfgs(mid_threshold, **VARIANTS[variant])
    if variant == "select_scatter":
        cfg = cfg.with_kernel_tune(cohort_scatter=True)
    if variant.startswith("shadow"):
        cfg = cfg.with_autotune(enabled=True, shadow_every=1, bins=16)
    seen = {"rows": [], "scatter": []}
    orig_rows = exec_mod._SlotRows.__init__

    def rows_spy(self, seg_cache, ctx, si, kinds, scratch):
        orig_rows(self, seg_cache, ctx, si, kinds, scratch)
        seen["rows"] += [x.untyped_storage().data_ptr()
                         for x in self.ring + self.state]

    def scatter_spy(dst, src, c, C, slot=None, _orig=ops.cohort_scatter_tree):
        seen["scatter"] += [x.untyped_storage().data_ptr()
                            for x in nn.tree_leaves(dst)]
        return _orig(dst, src, c, C, slot=slot)

    monkeypatch.setattr(exec_mod._SlotRows, "__init__", rows_spy)
    monkeypatch.setattr(ops, "cohort_scatter_tree", scatter_spy)
    before = {}

    def hook(m, ex, cache):
        before.update({p: (x, x.clone())
                       for p, x in _cross_storages(m, cache).items()})

    _port_trace(cfg, params, hook)
    assert len(before) == 2 * 3
    for x, x0 in before.values():
        torch.testing.assert_close(x, x0, rtol=0, atol=0)
    assert not set(seen["rows"]) & set(before)
    assert not set(seen["scatter"]) & set(before)
    if "select" in variant or "shadow" in variant:
        assert seen["rows"]                      # the spy saw snapshots
    if variant == "select_scatter":
        assert seen["scatter"]


# ---------------------------------------------------------------------------
# the serving engine against the JAX engine
# ---------------------------------------------------------------------------

ENGINE_KW = dict(lane_batch=2, n_lanes=2, cache_len=128, chunk=4)
# six requests for four slots, budgets that end at different steps: a
# lane whose slot frees re-prefills with its resident's full context and
# the new prompt, the encoder's memory recomputed
PROMPTS = ((40, 7), (20, 3), (33, 6), (12, 4), (45, 5), (25, 6))


@pytest.fixture(scope="module")
def engine_ths():
    """Engine thresholds (th0, th1, 0.0), each at the median of the decode
    confidences of its component in a port engine run that answers every
    token there ((0, 0, 0) and (1.1, 0, 0)): the exits are mixed."""
    _, params = _weights()
    ths = []
    for corner in ((0.0, 0.0, 0.0), (1.1, 0.0, 0.0)):
        eng = _drive("torch", _engine_cfg("torch", autotune=False,
                                          ths=corner), params)
        c = np.sort([x for f in eng.finished.values()
                     for x in f["confs"][1:]])
        i = len(c) // 2
        ths.append(float((c[i - 1] + c[i]) / 2))
    return (*ths, 0.0)


def _engine_cfg(pkg, mode="cond_batch", cohorts=2, autotune=True,
                layout="major", ths=(0.0, 0.0, 0.0)):
    jcfg, cfg = _cfgs(cascade=dict(exit_mode=mode, thresholds=ths,
                                   n_cohorts=cohorts, cohort_layout=layout))
    cfg = jcfg if pkg == "jax" else cfg.replace(use_kernels=True)
    if autotune:
        cfg = cfg.with_autotune(enabled=True, bins=64, shadow_every=2,
                                min_shadow=8, resolve_every=4)
    return cfg


def _drive(pkg, cfg, params, runtime="host", engine=None):
    if pkg == "jax":
        eng = JaxEngine(cfg, jax_build_model(cfg), params, runtime=runtime,
                        **ENGINE_KW)
        make = JaxRequest
    else:
        eng = engine or CascadeServingEngine(
            cfg, build_model(cfg, device="cpu"), params, runtime=runtime,
            device="cpu", **ENGINE_KW)
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


@pytest.fixture(scope="module")
def jax_engines(engine_ths):
    """The JAX engine on both runtimes: cond_batch, 2 cohorts (major),
    autotune's shadow step every 2 positions (the reference engine feeds
    every lane prefill zero frames)."""
    jparams, _ = _weights()
    cfg = _engine_cfg("jax", ths=engine_ths)
    return {rt: _drive("jax", cfg, jparams, rt) for rt in ("host", "device")}


@pytest.mark.parametrize("cohorts", [1, 2])
@pytest.mark.parametrize("mode", ["cond_batch", "select"])
@pytest.mark.parametrize("runtime", ["host", "device"])
def test_engine_matches_reference_engine(engine_ths, jax_engines, runtime,
                                         mode, cohorts):
    """Streams and exits equal the JAX engine's on the same runtime,
    through lane re-prefills with residents (the reference's modes and
    cohorts serve the same streams); where the engine is the reference's
    own (cond_batch, 2 cohorts) the carried segments_run and every
    telemetry counter too; the exits are mixed."""
    _, params = _weights()
    want = jax_engines[runtime]
    got = _drive("torch", _engine_cfg("torch", mode, cohorts,
                                      ths=engine_ths), params, runtime)
    assert sorted(got.finished) == list(range(len(PROMPTS)))
    assert _streams(got) == _streams(want)
    assert got.stats()["prefills"] > ENGINE_KW["n_lanes"]
    depths = {d for _, e in _streams(got).values() for d in e}
    assert depths == {0, 1, 2}
    if (mode, cohorts) != ("cond_batch", 2):
        return
    assert _carried(got) == _carried(want)
    tw = jax_merge(want.lane_telemetry())
    tg = merge_telemetry(got.lane_telemetry())
    assert tw.keys() == tg.keys()
    for k in tw:
        np.testing.assert_array_equal(np.asarray(tw[k]), tg[k], err_msg=k)
    assert tg["shadow_steps"] > 0


def test_engine_layouts_autotune_and_modes_agree_bit_for_bit(engine_ths):
    """Within the port: the copy layout serves what the major layout
    serves; autotune off what autotune on serves; select with the cohort
    scatter what cond_batch serves; the device runtime what the host
    runtime serves, here where both admit at the same points."""
    _, params = _weights()
    base = _streams(_drive("torch", _engine_cfg("torch", ths=engine_ths),
                           params))
    for cfg in (_engine_cfg("torch", layout="copy", ths=engine_ths),
                _engine_cfg("torch", autotune=False, ths=engine_ths),
                _engine_cfg("torch", "select", autotune=False,
                            ths=engine_ths)
                .with_kernel_tune(cohort_scatter=True)):
        assert _streams(_drive("torch", cfg, params)) == base


def test_lane_reprefill_writes_cross_leaves_in_place(engine_ths,
                                                     monkeypatch):
    """Every lane (re-)prefill gets the engine's zero frames (one tensor
    a shape, on the engine's device) and copies the encoder's K/V into
    the slab's cross leaves in place: their addresses never change, and
    after each prefill every row holds the K/V of the zero frames' memory
    (the same in every row, not the init zeros)."""
    _, params = _weights()
    cfg = _engine_cfg("torch", autotune=False, ths=engine_ths)
    model = build_model(cfg, device="cpu")
    eng = CascadeServingEngine(cfg, model, params, device="cpu", **ENGINE_KW)
    addrs = [[x.data_ptr() for x in nn.tree_leaves(ln["cache"])]
             for ln in eng.lanes]
    seen, frames = [], []
    orig = eng.executor.prefill

    def spy(params, toks, cache, state, extra=None):
        frames.append(extra["audio_embeds"])
        out = orig(params, toks, cache, state, extra=extra)
        seen.append([x.clone() for x in
                     _cross_storages(model, cache).values()])
        return out

    monkeypatch.setattr(eng.executor, "prefill", spy)
    _drive("torch", cfg, params, engine=eng)
    assert len(seen) > ENGINE_KW["n_lanes"]          # re-prefills happened
    assert all(f is frames[0] for f in frames)
    assert frames[0].shape == (2, 30, cfg.d_model)
    assert not bool(frames[0].any())
    for leaves in seen:
        for x in leaves:
            assert bool(x.abs().sum() > 0)
            torch.testing.assert_close(x, x[:, :1].expand_as(x), rtol=0,
                                       atol=0)
        for x, y in zip(leaves, seen[0]):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert addrs == [[x.data_ptr() for x in nn.tree_leaves(ln["cache"])]
                     for ln in eng.lanes]


def test_paged_audio_is_refused_with_reference_message():
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
    assert "(['cross', 'self'])" in str(err.value)


# ---------------------------------------------------------------------------
# MACs, the CLI, the bridge
# ---------------------------------------------------------------------------

def test_macs_match_reference():
    """The reference's arithmetic, copied: an encdec layer counts two
    attention blocks over the self KV length (the cross K/V projections
    counted at decode, the T memory keys not) and the MLP; the parameter
    count adds the encoder's layers."""
    full, jfull = get_config(ARCH), jax_get_config(ARCH)
    jcfg, cfg = _cfgs()
    for c, j in ((full, jfull), (cfg, jcfg)):
        for kv in (1, 100, 448, 4096):
            assert macs.segment_macs_per_token(c, kv) == \
                jax_macs.segment_macs_per_token(j, kv)
        assert macs.param_count(c) == jax_macs.param_count(j)
    assert macs._layer_macs_per_token(full, "encdec", 448) == \
        jax_macs._layer_macs_per_token(jfull, "encdec", 448)


def test_serve_cli_smoke():
    stats = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "4", "--max-new", "4", "--cohorts",
                        "2", "--runtime", "device", "--chunk", "4"])
    assert stats["requests_finished"] == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_bit_exact(dtype):
    """The reference's tree (``encoder`` with its stacked stages, f32
    final norm and frame positions) round-trips bit for bit, and has the
    structure, shapes and dtypes of the port's own init."""
    jcfg, cfg = _cfgs()
    jcfg, cfg = jcfg.replace(dtype=dtype), cfg.replace(dtype=dtype)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(5))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tp = params_from_jax(np_params, cfg, device="cpu")
    enc = tp["encoder"]
    assert enc["norm"]["w"].dtype == torch.float32
    assert enc["stages"]["attn"]["wq"].dtype == getattr(torch, dtype)
    assert enc["stages"]["mlp"]["norm"]["b"].shape == (2, cfg.d_model)
    assert enc["pos_embed"].shape == (30, cfg.d_model)
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
    with pytest.raises(ValueError, match="missing \\['encoder'\\]"):
        params_from_jax({k: v for k, v in np_params.items()
                         if k != "encoder"}, cfg, device="cpu")


# ---------------------------------------------------------------------------
# tests/test_archs_smoke.py's three per-arch tests, on the port
# ---------------------------------------------------------------------------

def _smoke_extra(cfg, batch, rng):
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in extra_input_shapes(cfg, batch).items()}


def test_forward_shapes_and_finite():
    cfg = reduced(get_config(ARCH))
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))
                            .astype(np.int32))
    logits, aux = model.forward_train(params, toks, _smoke_extra(cfg, 2, rng))
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
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 17))
                            .astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "extra": _smoke_extra(cfg, 2, rng)}
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
    rng = np.random.default_rng(2)
    S = 13
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S + 1))
                            .astype(np.int32))
    ex = _smoke_extra(cfg, 2, rng)
    with torch.no_grad():
        logits_full, _ = model.forward_train(params, toks, ex)
        cache = model.init_cache(2, S + 4)
        el, cache = model.prefill(params, toks[:, :S], cache, ex)
        sl, cache = model.decode_step(params, toks[:, S:S + 1], S, cache, ex)
    for a, b in zip(logits_full, sl):
        np.testing.assert_allclose(_np(a[:, S, :]), _np(b), rtol=2e-3,
                                   atol=2e-3)
    for a, b in zip(logits_full, el):
        np.testing.assert_allclose(_np(a[:, S - 1, :]), _np(b), rtol=2e-3,
                                   atol=2e-3)


def test_decode_runs_without_host_reads(monkeypatch):
    """No ``.item()``, ``nonzero`` or ``tolist`` in an encdec decode step
    (the block's apply and backfill, and a whole select-mode staged step
    over the lane's cache): a captured graph cannot read the device."""
    def boom(*a, **kw):
        raise AssertionError("host read in an encdec decode step")

    _, params = _weights()
    _, cfg = _cfgs(use_kernels=True, cascade=dict(
        exit_mode="select", thresholds=(0.5, 0.5, 0.0)))
    m = build_model(cfg, device="cpu")
    ex = StagedExecutor(m, cfg)
    d, cache, state = ex.prefill(
        params, torch.from_numpy(_tokens(cfg.vocab_size)),
        m.init_cache(4, W_CACHE),
        extra={"audio_embeds": torch.from_numpy(_lane_audio(cfg))})
    _, tp = _layer()
    jctx, ctx = _ctx_pair("decode", 1)
    c = _tree_to_torch({"cross": _kv(cfg, 2, 30, 80),
                        "self": _kv(cfg, 2, W_CACHE, 82)})
    x = torch.from_numpy(_rand((2, 1, cfg.d_model), 84))
    tok = d.prediction[:, None]
    for name in ("item", "tolist", "nonzero", "__bool__", "__int__",
                 "__float__"):
        monkeypatch.setattr(torch.Tensor, name, boom)
    out, _, _ = blocks.encdec_apply(cfg, tp, x, ctx, c)
    blocks.encdec_backfill(cfg, tp, x, ctx, c)
    d, cache, state = ex.decode_step(params, tok, cache, state)
    monkeypatch.undo()
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert d.prediction.shape == (4,)
