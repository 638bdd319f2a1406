"""The vlm family: the gated cross-attention block (``xattn``) over
image-token K/V cached at prefill, a cache segment with no ring and no
state leaf (an xattn stage's K/V are read-only), the image embeddings
through the model, the executor, the steps and the serving engine, the
paged layout's refusal (R4) and llama-3.2-vision-90b — the port against
the JAX package on bridged weights, plus the port's own contracts.

Config: ``reduced(llama-3.2-vision-90b, n_layers=4)``, f32, 3 components
with exits after layers 1 and 3.  d 256, 4 / 1 heads of 64, d_ff 512,
rmsnorm, swiglu, RoPE; 16 image tokens, every 2nd layer an xattn layer:
kinds dense / xattn / dense / xattn, segments ``[dense]``, ``[xattn,
dense]`` and ``[xattn]`` — segment 2 has no ring leaf at all.  An xattn
layer's cache is ``{"k", "v"}`` (B, 16, 1, 64), both read-only.

The JAX init leaves every gate at 0 (the sublayer's output then vanishes)
and every rmsnorm at ones, so before bridging each ``gate`` is drawn from
N(0, 1) and each norm weight gets N(0, 0.5²) noise added (numpy seed 17);
the image embeddings are N(0, 1) from numpy seeds.

Tolerances: the sublayers and blocks within 2e-5 (``TOL``); exit logits
and cache leaves 1e-4 (``LOGIT_TOL``); train-step losses 1e-4; decode
streams: tokens, exit indices, ``segments_run`` and telemetry counters
exactly, confidences and EMAs 1e-5; within the port (host ≡ device
runtime, major ≡ copy, select ≡ cond_batch, autotune on ≡ off) bit for
bit.
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
from repro.models import layers as jax_layers
from repro.models.model import build_model as jax_build_model
from repro.models.model import extra_input_shapes as jax_extra_shapes
from repro.serving.engine import CascadeServingEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro.serving.paged.cache import PagedCascadeCache as JaxPagedCache
from repro_torch.autotune import merge_telemetry
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_config, reduced
from repro_torch.core import exec as exec_mod
from repro_torch.core import macs
from repro_torch.core.exec import StagedExecutor
from repro_torch.kernels import ops
from repro_torch.launch import serve, steps
from repro_torch.models import blocks, layers, nn
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
ARCH = "llama-3.2-vision-90b"
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


def _randomise(tree, rng, norm=False):
    """The JAX init with every xattn ``gate`` drawn from N(0, 1) and every
    rmsnorm weight moved off ones by N(0, 0.5²) noise."""
    if isinstance(tree, dict):
        return {k: (jnp.asarray(rng.standard_normal(v.shape), np.float32)
                    .astype(v.dtype) if k == "gate" else
                    _randomise(v, rng, norm or k in ("norm", "final_norm")))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomise(v, rng, norm) for v in tree]
    if not norm:
        return tree
    return jnp.asarray(np.asarray(tree, np.float32) + 0.5
                       * rng.standard_normal(tree.shape),
                       np.float32).astype(tree.dtype)


_WEIGHTS = {}


def _weights():
    """The reference's seed-0 init, its gates and norms randomised,
    bridged (once)."""
    if not _WEIGHTS:
        jcfg, cfg = _cfgs()
        jparams = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))
        jparams = _randomise(jparams, np.random.default_rng(17))
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


def _images(B, cfg, seed):
    """Image embeddings (B, n_image_tokens, d), numpy."""
    return _rand((B, cfg.n_image_tokens, cfg.d_model), seed)


def _extra_pair(images):
    return ({"image_embeds": jnp.asarray(images)},
            {"image_embeds": torch.from_numpy(images)})


def _read_leaves(model, cache):
    """Every read-only (xattn K/V) leaf of a cache, in segment order."""
    return [x for si, seg in enumerate(cache["segments"])
            for x, k in zip(nn.tree_leaves(seg), model.leaf_kinds(si, seg))
            if k == "read"]


# ---------------------------------------------------------------------------
# the config, the layer kinds, the leaf kinds
# ---------------------------------------------------------------------------

def test_config_copy_equals_reference_field_by_field():
    ours, ref = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert dataclasses.asdict(reduced(ours)) == dataclasses.asdict(
        jax_reduced(ref))
    assert reduced(ours).n_image_tokens == 16
    assert reduced(ours).cross_attn_every == 2
    assert extra_input_shapes(ours, 4) == jax_extra_shapes(ref, 4) == {
        "image_embeds": (4, 1600, 8192)}


@pytest.mark.parametrize("n_layers", [4, 30, 100])
def test_layer_kinds_equal_reference(n_layers):
    """Every ``cross_attn_every``-th layer is an xattn one, as in the
    reference; the 30-layer cut keeps the 1:5 pattern with the default
    boundaries (10, 20): four stages a segment, each ending in xattn."""
    ours = get_config(ARCH).replace(n_layers=n_layers)
    ref = jax_get_config(ARCH).replace(n_layers=n_layers)
    kinds = blocks.layer_kinds(ours)
    assert kinds == jax_blocks.layer_kinds(ref)
    assert [i for i, k in enumerate(kinds) if k == "xattn"] == list(
        range(4, n_layers, 5))
    if n_layers == 30:
        model = build_model(ours, device="cpu")
        assert ours.segments == ((0, 10), (10, 20), (20, 30))
        assert model.segment_runs == [[("dense", 4), ("xattn", 1),
                                       ("dense", 4), ("xattn", 1)]] * 3


def test_full_width_config_builds():
    """llama-3.2-vision-90b at its published widths cut to 30 layers (no
    weights drawn: the card's phase draws them): a bf16 cache of 4 rows at
    cache_len 512 on the meta device — each xattn stage's K/V (1, 4, 1600,
    8, 128) read-only, each dense stage's (4, 4, 512, 8, 128) ring leaves;
    the reference's parameter count at 30 and 100 layers, and the
    reference's init at 100 layers at 87.7 B parameters (the exit heads
    share the unembedding)."""
    cfg = get_config(ARCH).replace(n_layers=30)
    model = build_model(cfg, device="cpu")
    cache = model.init_cache(4, 512, dtype=torch.bfloat16, device="meta")
    seg = cache["segments"][1]
    assert [list(st) for st in seg] == [["k", "v"]] * 4
    assert [(tuple(x.shape), x.dtype) for x in nn.tree_leaves(seg)] == [
        ((4, 4, 512, 8, 128), torch.bfloat16)] * 2 + [
        ((1, 4, 1600, 8, 128), torch.bfloat16)] * 2 + [
        ((4, 4, 512, 8, 128), torch.bfloat16)] * 2 + [
        ((1, 4, 1600, 8, 128), torch.bfloat16)] * 2
    assert model.leaf_kinds(1, seg) == ["ring", "ring", "read", "read"] * 2
    for n in (30, 100):
        assert macs.param_count(cfg.replace(n_layers=n)) == \
            jax_macs.param_count(jax_get_config(ARCH).replace(n_layers=n))
    shapes = jax.eval_shape(jax_build_model(jax_get_config(ARCH)).init,
                            jax.random.PRNGKey(0))
    count = sum(int(np.prod(x.shape))
                for x in jax.tree_util.tree_leaves(shapes))
    assert round(count / 1e9, 1) == 87.7


def test_segment_without_ring_leaf_splits_to_nothing():
    """Segment 2 of the test config is one xattn layer: two read-only
    leaves, so ``_split_leaves`` gives no ring and no state leaf and the
    slot rows of a step there are empty lists (nothing to snapshot)."""
    _, cfg = _cfgs()
    model = build_model(cfg, device="cpu")
    assert model.segment_runs == [[("dense", 1)], [("xattn", 1),
                                                   ("dense", 1)],
                                  [("xattn", 1)]]
    cache = model.init_cache(2, 16)
    kinds = [model.leaf_kinds(si, seg)
             for si, seg in enumerate(cache["segments"])]
    assert kinds == [["ring", "ring"], ["read", "read", "ring", "ring"],
                     ["read", "read"]]
    assert exec_mod._split_leaves(cache["segments"][2], kinds[2]) == ([], [])
    ctx = {"slot": torch.tensor(3)}
    rows = exec_mod._SlotRows(cache["segments"][2], ctx, 2, kinds[2],
                              lambda *a: pytest.fail("scratch asked for"))
    snap = rows.read("before")
    assert snap.ring == [] and snap.state == []
    rows.write(rows.select(torch.ones(2, 1, 1, 1, 1, dtype=torch.bool),
                           snap))
    with pytest.raises(ValueError, match="2 cache leaves"):
        exec_mod._split_leaves(cache["segments"][2], kinds[2][:1])


# ---------------------------------------------------------------------------
# the sublayer and the block against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_init_cross_tree_equals_reference(dtype):
    """``attn_init(cross=True)`` adds the scalar ``gate``, zero in f32, and
    the model's init casts it with the other float leaves: the stacked
    xattn stage's ``gate`` is (n,) in the model dtype, as the
    reference's."""
    jcfg, cfg = _cfgs()
    jcfg, cfg = jcfg.replace(dtype=dtype), cfg.replace(dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    shape = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: (tuple(x.shape), str(x.dtype).replace("torch.", "")), t)
    for cross in (False, True):
        want = jax.eval_shape(lambda k: jax_layers.attn_init(
            k, jcfg, cross=cross), jax.random.PRNGKey(0))
        got = layers.attn_init(gen, cfg, cross=cross)
        assert shape(got) == shape(want)
        assert ("gate" in got) == cross
    assert torch.equal(got["gate"], torch.zeros((), dtype=torch.float32))
    jp = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    tp = build_model(cfg, device="cpu").init(0)
    assert shape(tp) == shape(jp)
    gate = tp["segments"][1][0]["xattn"]["gate"]
    assert gate.shape == (1,) and gate.dtype == getattr(torch, dtype)
    assert not bool(gate.any())


def _layer(si=1, i=0):
    """Layer ``i`` of segment ``si``'s xattn stage: (jax, port) params."""
    jparams, params = _weights()
    return (jax.tree_util.tree_map(lambda a: a[i], jparams["segments"][si][0]),
            nn.tree_index(params["segments"][si][0], i))


def _ctx_pair(mode, mem=None):
    """A (jax ctx, port ctx) pair: full mode with the memory ``mem``
    (numpy), or a decode step (the reference's decode context carries the
    images too; the port's none)."""
    jmem = None if mem is None else jnp.asarray(mem)
    if mode == "full":
        return ({"mode": "full", "cross": jmem, "shared": None},
                {"mode": "full", "shared": None,
                 "cross": None if mem is None else torch.from_numpy(mem)})
    return ({"mode": "decode", "cross": jmem, "shared": None},
            {"mode": "decode", "shared": None, "cross": None})


def _kv(cfg, B, T, seed):
    shape = (B, T, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": _rand(shape, seed), "v": _rand(shape, seed + 1)}


@pytest.mark.parametrize("case", ["full", "full_cache", "decode_cache"])
def test_xattn_apply_and_backfill_equal_reference(case):
    """The xattn block: full mode without a cache (training) and with one
    (the image tokens' K/V copied into it in place), decode reading the
    cache and writing nothing; h within TOL, every cache leaf; the
    backfill returns the cache as it was, the same tensors."""
    jcfg, cfg = _cfgs()
    jp, tp = _layer()
    assert float(tp["xattn"]["gate"]) != 0.0
    B, T = 2, cfg.n_image_tokens
    mode = case.split("_")[0]
    S = 12 if mode == "full" else 1
    mem = _images(B, cfg, 30)
    jctx, ctx = _ctx_pair(mode, mem)
    h = _rand((B, S, cfg.d_model), 31)
    cache = None
    if case.endswith("cache"):
        cache = (_kv(cfg, B, T, 32) if mode == "decode" else
                 nn.tree_map(np.zeros_like, _kv(cfg, B, T, 32)))
    jcache = None if cache is None else _tree_to_jax(cache)
    tcache = None if cache is None else _tree_to_torch(cache)
    jb, tb = jax_blocks.BLOCKS["xattn"], blocks.BLOCKS["xattn"]
    want, wcache, _ = jax.jit(lambda p, h, c: jb.apply(
        jcfg, p, h, jctx, c))(jp, jnp.asarray(h), jcache)
    got, gcache, aux = tb.apply(cfg, tp, torch.from_numpy(h), ctx, tcache)
    _close(got, want)
    assert aux == 0.0 and gcache is tcache
    if cache is None:
        return
    for name in ("k", "v"):
        _close(tcache[name], wcache[name])
        if mode == "decode":                      # read, never written
            np.testing.assert_array_equal(_np(tcache[name]), cache[name])
        else:
            assert bool(tcache[name].abs().sum() > 0)
    before = {k: v.clone() for k, v in tcache.items()}
    wback = jax.jit(lambda p, h, c: jb.backfill(jcfg, p, h, jctx, c))(
        jp, jnp.asarray(h), _tree_to_jax(before))
    assert tb.backfill(cfg, tp, torch.from_numpy(h), ctx, tcache) is tcache
    for name in ("k", "v"):
        torch.testing.assert_close(tcache[name], before[name], rtol=0,
                                   atol=0)
        np.testing.assert_array_equal(_np(before[name]),
                                      np.asarray(wback[name]))
    assert blocks.BLOCKS["xattn"].read_keys == ("k", "v")
    assert blocks.BLOCKS["xattn"].state_keys == ()


def test_make_cross_takes_images_in_full_mode_only():
    """The memory in full mode is the image embeddings cast to the
    parameter dtype; at decode none (the layers read the cached K/V)."""
    _, cfg = _cfgs()
    img = torch.from_numpy(_images(2, cfg, 33))
    for dtype in ("float32", "bfloat16"):
        m = build_model(cfg.replace(dtype=dtype), device="cpu")
        mem = m._make_cross(None, {"image_embeds": img}, "full")
        assert mem.dtype == getattr(torch, dtype)
        torch.testing.assert_close(mem, img.to(mem.dtype), rtol=0, atol=0)
        assert m._make_cross(None, {"image_embeds": img}, "decode") is None


# ---------------------------------------------------------------------------
# the model: prefill, dense decode steps, forward_train, training
# ---------------------------------------------------------------------------

S_PROMPT = 45


def test_prefill_and_decode_steps_match_reference():
    """Prefill logits of every exit (each xattn layer's K/V cached from
    the images) and 4 dense decode steps, the reference's greedy tokens
    fed back; the port's kernels on (their plain versions here) and off;
    every cache leaf at the end, the xattn K/V as the prefill left
    them."""
    jparams, params = _weights()
    jcfg, _ = _cfgs()
    jm = jax_build_model(jcfg)
    jex, tex = _extra_pair(_images(2, jcfg, 60))
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (2, S_PROMPT)).astype(np.int32)
    jl, jcache = prefill(jparams, jnp.asarray(toks), jm.init_cache(2, W_CACHE),
                         jex)
    want = [(toks, [np.asarray(x) for x in jl])]
    for step in range(4):
        nxt = np.array(jnp.argmax(jl[-1], -1), np.int32)[:, None]
        jl, jcache = decode(jparams, jnp.asarray(nxt),
                            jnp.int32(S_PROMPT + step), jcache, jex)
        want.append((nxt, [np.asarray(x) for x in jl]))
    for use_kernels in (False, True):
        _, cfg = _cfgs(use_kernels=use_kernels)
        m = build_model(cfg, device="cpu")
        cache = m.init_cache(2, W_CACHE)
        for step, (tk, wl) in enumerate(want):
            if step == 0:
                tl, cache = m.prefill(params, torch.from_numpy(tk), cache,
                                      tex)
                cross = [x.clone() for x in _read_leaves(m, cache)]
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
        after = _read_leaves(m, cache)
        assert len(after) == 2 * 2
        for a, b in zip(cross, after):
            assert bool(a.abs().sum() > 0)
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_forward_train_logits_match_reference():
    jparams, params = _weights()
    jcfg, cfg = _cfgs()
    jex, tex = _extra_pair(_images(2, cfg, 61))
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
    the images in ``batch["extra"]`` (gradients through the cross
    attention and its gate): losses within 1e-4, every parameter finite
    after, the gates moved."""
    jparams, _ = _weights()
    jcfg, cfg = _cfgs()
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(13)
    batches = [rng.integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
               for _ in range(3)]
    jex, tex = _extra_pair(_images(2, cfg, 62))
    jm = jax_build_model(jcfg)
    jo = jax_steps.make_optimizer(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    js = jo.init(jp)
    jstep = jax.jit(jax_steps.make_train_step(jm, jcfg, jo))
    m = build_model(cfg, device="cpu")
    o = steps.make_optimizer(cfg)
    params = params_from_jax(np_params, cfg, device="cpu")
    gate0 = params["segments"][2][0]["xattn"]["gate"].clone()
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
    assert not torch.equal(params["segments"][2][0]["xattn"]["gate"], gate0)


def test_decode_ignores_the_images():
    """Decode takes the images and ignores them, as the reference does
    (its layers read the cached K/V): the serve step's logits with them
    and without them are the same, bit for bit."""
    _, params = _weights()
    _, cfg = _cfgs()
    m = build_model(cfg, device="cpu")
    tex = {"image_embeds": torch.from_numpy(_images(2, cfg, 63))}
    pre = steps.make_prefill_step(m, cfg)
    serve_step = steps.make_serve_step(m, cfg)
    outs = []
    for extra in (tex, None):
        tok, _, _, cache, state = pre(
            params, torch.zeros((2, 8), dtype=torch.int32),
            m.init_cache(2, 16), tex)
        outs.append(serve_step(params, tok[:, None], cache, state, extra))
    for a, b in zip(outs[0][:3], outs[1][:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert outs[0][0].shape == (2,)


# ---------------------------------------------------------------------------
# the staged decode against the reference's executor
# ---------------------------------------------------------------------------

STEPS = 5


def _tokens(vocab):
    return np.random.default_rng(3).integers(0, vocab, (4, 40)).astype(
        np.int32)


def _lane_images(cfg):
    return _images(4, cfg, 70)


def _jax_trace(jcfg, jparams):
    jm = jax_build_model(jcfg)
    ex = JaxExecutor(jm, jcfg)
    step = jax.jit(ex.decode_step)
    jex = {"image_embeds": jnp.asarray(_lane_images(jcfg))}
    d, cache, state = jax.jit(ex.prefill)(
        jparams, jnp.asarray(_tokens(jcfg.vocab_size)),
        jm.init_cache(4, W_CACHE), jex)
    outs = []
    for _ in range(STEPS):
        d, cache, state = step(jparams, d.prediction[:, None], cache, state,
                               jex)
        outs.append([np.asarray(x) for x in (d.prediction, d.exit_index,
                                             d.confidence)])
    return {"outs": outs, "segments_run": np.asarray(state.segments_run),
            "ema": np.asarray(state.ema_conf),
            "cache": [np.asarray(x) for x in
                      jax.tree_util.tree_leaves(cache["segments"])]}


def _port_trace(cfg, params, hook=None):
    """The port's executor: a prefill over the lane's images, then STEPS
    staged decode steps; ``hook(model, executor, cache)`` runs between
    the prefill and the decode steps."""
    m = build_model(cfg, device="cpu")
    ex = StagedExecutor(m, cfg)
    d, cache, state = ex.prefill(
        params, torch.from_numpy(_tokens(cfg.vocab_size)),
        m.init_cache(4, W_CACHE),
        extra={"image_embeds": torch.from_numpy(_lane_images(cfg))})
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
            "dispatch": dict(ex.dispatch), "scratch": dict(ex._scratch)}


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
def jax_traces(mid_threshold):
    """The reference executor's traces at (mid, 1.1, 0.0), cond_batch, by
    cohort count (its modes and layouts serve the same streams; the
    cohorts do not: a cohort whose rows all exited backfills the deep
    segments' caches where one cohort over the batch computes them)."""
    jparams, _ = _weights()
    return {c: _jax_trace(_mid_cfgs(mid_threshold, exit_mode="cond_batch",
                                    n_cohorts=c)[0]
                          .replace(use_kernels=False), jparams)
            for c in (1, 2)}


@pytest.mark.parametrize("mode", ["cond_batch", "select"])
@pytest.mark.parametrize("cohorts", [1, 2])
def test_decode_streams_match_reference(mid_threshold, jax_traces,
                                        cohorts, mode):
    """Tokens and exit indices exactly, confidences, EMAs and every cache
    leaf (the xattn K/V included) within tolerance, against the reference
    executor's run with as many cohorts; ``segments_run`` exactly under
    cond_batch, C a segment a step in select mode; with 2 cohorts the major and copy layouts bit for bit alike,
    select mode with the cohort scatter (its slot route) too.  The
    segment with no ring leaf allocates no snapshot scratch."""
    _, params = _weights()
    _, cfg = _mid_cfgs(mid_threshold, exit_mode=mode, n_cohorts=cohorts,
                       cohort_layout="major")
    want = jax_traces[cohorts]
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
        else:
            np.testing.assert_array_equal(got["segments_run"],
                                          want["segments_run"])
        np.testing.assert_allclose(got["ema"], want["ema"], rtol=CONF_TOL,
                                   atol=CONF_TOL)
        assert len(got["cache"]) == len(want["cache"])
        for a, b in zip(got["cache"], want["cache"]):
            np.testing.assert_allclose(a, b, rtol=LOGIT_TOL, atol=LOGIT_TOL)
        assert got["scratch"] == {}
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
            for x in _read_leaves(model, cache)}


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
def test_decode_never_writes_xattn_leaves(mid_threshold, variant,
                                          monkeypatch):
    """In every mode, the xattn K/V leaves are bit for bit what the
    prefill left after decode steps, and no snapshot (select's, the
    shadow step's observation), selection or scatter reads or writes
    them.  The segment whose only leaves are read-only (segment 2)
    snapshots nothing and launches no cohort scatter: its slot rows are
    empty lists and every scatter call holds ring leaves only."""
    _, params = _weights()
    _, cfg = _mid_cfgs(mid_threshold, **VARIANTS[variant])
    if variant == "select_scatter":
        cfg = cfg.with_kernel_tune(cohort_scatter=True)
    if variant.startswith("shadow"):
        cfg = cfg.with_autotune(enabled=True, shadow_every=1, bins=16)
    seen = {"rows": [], "empty_rows": 0, "scatter": []}
    orig_rows = exec_mod._SlotRows.__init__

    def rows_spy(self, seg_cache, ctx, si, kinds, scratch):
        orig_rows(self, seg_cache, ctx, si, kinds, scratch)
        seen["rows"] += [x.untyped_storage().data_ptr()
                         for x in self.ring + self.state]
        if si == 2:
            assert self.ring == [] and self.state == []
            seen["empty_rows"] += 1

    def scatter_spy(dst, src, c, C, slot=None, _orig=ops.cohort_scatter_tree):
        assert len(dst) > 0 and len(dst) == len(src)
        seen["scatter"] += [x.untyped_storage().data_ptr()
                            for x in nn.tree_leaves(dst)]
        return _orig(dst, src, c, C, slot=slot)

    monkeypatch.setattr(exec_mod._SlotRows, "__init__", rows_spy)
    monkeypatch.setattr(ops, "cohort_scatter_tree", scatter_spy)
    before = {}

    def hook(m, ex, cache):
        before.update({p: (x, x.clone())
                       for p, x in _cross_storages(m, cache).items()})

    run = _port_trace(cfg, params, hook)
    assert len(before) == 2 * 2
    for x, x0 in before.values():
        torch.testing.assert_close(x, x0, rtol=0, atol=0)
    assert not set(seen["rows"]) & set(before)
    assert not set(seen["scatter"]) & set(before)
    if "select" in variant or "shadow" in variant:
        assert seen["rows"] and seen["empty_rows"]
    if variant == "select_scatter":
        assert seen["scatter"]
    assert all(x.numel() > 0 for x in run["scratch"].values())


# ---------------------------------------------------------------------------
# the serving engine against the JAX engine
# ---------------------------------------------------------------------------

ENGINE_KW = dict(lane_batch=2, n_lanes=2, cache_len=128, chunk=4)
# six requests for four slots, budgets that end at different steps: a
# lane whose slot frees re-prefills with its resident's full context and
# the new prompt, the xattn K/V written again from the images
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
    every lane prefill zero images)."""
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


@pytest.mark.parametrize("runtime", ["host", "device"])
def test_engine_layouts_autotune_and_modes_agree_bit_for_bit(engine_ths,
                                                             runtime):
    """Within the port, on each runtime: the copy layout serves what the
    major layout serves; autotune off what autotune on serves; select with
    the cohort scatter what cond_batch serves."""
    _, params = _weights()
    base = _streams(_drive("torch", _engine_cfg("torch", ths=engine_ths),
                           params, runtime))
    for cfg in (_engine_cfg("torch", layout="copy", ths=engine_ths),
                _engine_cfg("torch", autotune=False, ths=engine_ths),
                _engine_cfg("torch", "select", autotune=False,
                            ths=engine_ths)
                .with_kernel_tune(cohort_scatter=True)):
        assert _streams(_drive("torch", cfg, params, runtime)) == base


@pytest.mark.parametrize("mode", ["cond_batch", "select"])
def test_host_and_device_runtimes_agree_bit_for_bit(engine_ths, mode):
    """The device runtime serves what the host runtime serves, bit for bit
    (tokens, exits, confidences, carried segments_run), where both admit
    at the same points: four requests for the four slots, budgets that
    are multiples of the chunk, so no lane re-prefills mid-chunk."""
    _, params = _weights()
    cfg = _engine_cfg("torch", mode, ths=engine_ths)
    out = []
    for runtime in ("host", "device"):
        eng = CascadeServingEngine(cfg, build_model(cfg, device="cpu"),
                                   params, runtime=runtime, device="cpu",
                                   **ENGINE_KW)
        rng = np.random.default_rng(8)
        for i, n in enumerate((40, 20, 33, 12)):
            eng.submit(Request(rid=i, prompt=rng.integers(
                0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=9))
        eng.run(200)
        out.append((_streams(eng), {r: f["confs"] for r, f in
                                    eng.finished.items()}, _carried(eng)))
    assert out[0] == out[1]
    assert {d for _, e in out[0][0].values() for d in e} == {0, 1, 2}


def test_lane_reprefill_writes_xattn_leaves_in_place(engine_ths,
                                                     monkeypatch):
    """Every lane (re-)prefill gets the engine's zero images (one tensor
    a shape, on the engine's device) and copies their K/V into the slab's
    xattn leaves in place: their addresses never change, and each prefill
    rewrites them whole — leaves filled with ones before it hold the zero
    images' K/V (zeros: llama's projections have no bias) after it."""
    _, params = _weights()
    cfg = _engine_cfg("torch", autotune=False, ths=engine_ths)
    model = build_model(cfg, device="cpu")
    eng = CascadeServingEngine(cfg, model, params, device="cpu", **ENGINE_KW)
    addrs = [[x.data_ptr() for x in nn.tree_leaves(ln["cache"])]
             for ln in eng.lanes]
    images, rewritten = [], []
    orig = eng.executor.prefill

    def spy(params, toks, cache, state, extra=None):
        images.append(extra["image_embeds"])
        leaves = _read_leaves(model, cache)
        for x in leaves:
            x.fill_(1.0)
        out = orig(params, toks, cache, state, extra=extra)
        rewritten.append(all(not bool(x.any()) for x in leaves))
        return out

    monkeypatch.setattr(eng.executor, "prefill", spy)
    _drive("torch", cfg, params, engine=eng)
    assert len(images) > ENGINE_KW["n_lanes"]          # re-prefills happened
    assert all(f is images[0] for f in images)
    assert images[0].shape == (2, 16, cfg.d_model)
    assert not bool(images[0].any())
    assert all(rewritten)
    assert addrs == [[x.data_ptr() for x in nn.tree_leaves(ln["cache"])]
                     for ln in eng.lanes]


def test_paged_vlm_is_refused_where_the_reference_pages_a_short_ring():
    """R4: the reference decides "attention ring" from the key names, so
    it pages an xattn stage's T-row cross K/V as a W-row ring — at 24
    image tokens, cache_len 16 and block size 8 its store for that stage
    holds 16 rows a slot (2 blocks of 8) for a 24-row memory.  The port
    decides ring stages from the model's leaf kinds and refuses the paged
    layout for a stage of read-only leaves, naming the family and the
    stage's keys; the audio family's refusal keeps its words (its own
    test pins them to the reference's)."""
    jcfg, cfg = _cfgs(n_image_tokens=24)
    jcfg = jcfg.with_paged_cache(layout="paged", block_size=8)
    cfg = cfg.with_paged_cache(layout="paged", block_size=8)
    jpc = JaxPagedCache(jax_build_model(jcfg), jcfg, lane_batch=2,
                        n_lanes=1, cache_len=16)
    store = jpc.segments[2][0]["k"]
    assert store.shape[2:] == (8, 1, 64)
    assert jpc.nblk * jpc.block_size == 16 < jcfg.n_image_tokens
    with pytest.raises(ValueError) as err:
        PagedCascadeCache(build_model(cfg, device="cpu"), cfg,
                          lane_batch=2, n_lanes=1, cache_len=16)
    msg = str(err.value)
    assert "read-only cache stage" in msg
    assert "family 'vlm'" in msg and "(['k', 'v'])" in msg
    assert "(24 rows, written at prefill" in msg and "16-row paged ring" in msg
    _, params = _weights()
    pcfg = _cfgs()[1].with_paged_cache(layout="paged", block_size=8)
    with pytest.raises(ValueError, match="read-only cache stage"):
        CascadeServingEngine(pcfg, build_model(pcfg, device="cpu"), params,
                             device="cpu", lane_batch=2, n_lanes=1,
                             cache_len=16)
    audio = reduced(get_config("whisper-tiny"), n_layers=2) \
        .with_paged_cache(layout="paged", block_size=8)
    with pytest.raises(ValueError) as err:
        PagedCascadeCache(build_model(audio, device="cpu"), audio,
                          lane_batch=2, n_lanes=1, cache_len=16)
    assert "non-attention cache stage (['cross', 'self'])" in str(err.value)


# ---------------------------------------------------------------------------
# MACs, the CLI, the bridge
# ---------------------------------------------------------------------------

def test_macs_match_reference():
    """The reference's arithmetic, copied: an xattn layer counts the q and
    o projections (the K/V are cached), the scores over the T image
    tokens and the MLP; its parameters an attention block and the MLP."""
    full, jfull = get_config(ARCH), jax_get_config(ARCH)
    jcfg, cfg = _cfgs()
    for c, j in ((full, jfull), (full.replace(n_layers=30),
                                 jfull.replace(n_layers=30)), (cfg, jcfg)):
        for kv in (1, 100, 512, 4096):
            assert macs.segment_macs_per_token(c, kv) == \
                jax_macs.segment_macs_per_token(j, kv)
        assert macs.param_count(c) == jax_macs.param_count(j)
    for kind in ("xattn", "dense"):
        assert macs._layer_macs_per_token(full, kind, 512) == \
            jax_macs._layer_macs_per_token(jfull, kind, 512)


@pytest.mark.parametrize("runtime", ["host", "device"])
def test_serve_cli_smoke(runtime):
    stats = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "4", "--max-new", "4", "--cohorts",
                        "2", "--runtime", runtime, "--chunk", "4"])
    assert stats["requests_finished"] == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_bit_exact(dtype):
    """The reference's tree (each xattn stage's ``xattn`` dict with its
    stacked ``gate``, its ``mlp`` dict) round-trips bit for bit, and has
    the structure, shapes and dtypes of the port's own init."""
    jcfg, cfg = _cfgs()
    jcfg, cfg = jcfg.replace(dtype=dtype), cfg.replace(dtype=dtype)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(5))
    jparams = _randomise(jparams, np.random.default_rng(6))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tp = params_from_jax(np_params, cfg, device="cpu")
    st = tp["segments"][2][0]
    assert sorted(st) == ["mlp", "xattn"]
    assert st["xattn"]["gate"].shape == (1,)
    assert st["xattn"]["gate"].dtype == getattr(torch, dtype)
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
    for st in params["segments"][1]:
        if "xattn" in st:
            st["xattn"]["gate"].fill_(0.8)
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
    """No ``.item()``, ``nonzero`` or ``tolist`` in an xattn decode step
    (the block's apply and backfill, and a whole select-mode staged step
    over the lane's cache, the segment without a ring leaf included): a
    captured graph cannot read the device."""
    def boom(*a, **kw):
        raise AssertionError("host read in an xattn decode step")

    _, params = _weights()
    _, cfg = _cfgs(use_kernels=True, cascade=dict(
        exit_mode="select", thresholds=(0.5, 0.5, 0.0), n_cohorts=2))
    m = build_model(cfg, device="cpu")
    ex = StagedExecutor(m, cfg.with_kernel_tune(cohort_scatter=True))
    d, cache, state = ex.prefill(
        params, torch.from_numpy(_tokens(cfg.vocab_size)),
        m.init_cache(4, W_CACHE),
        extra={"image_embeds": torch.from_numpy(_lane_images(cfg))})
    _, tp = _layer()
    _, ctx = _ctx_pair("decode")
    c = _tree_to_torch(_kv(cfg, 2, cfg.n_image_tokens, 80))
    x = torch.from_numpy(_rand((2, 1, cfg.d_model), 84))
    tok = d.prediction[:, None]
    for name in ("item", "tolist", "nonzero", "__bool__", "__int__",
                 "__float__"):
        monkeypatch.setattr(torch.Tensor, name, boom)
    out, _, _ = blocks.xattn_apply(cfg, tp, x, ctx, c)
    blocks.xattn_backfill(cfg, tp, x, ctx, c)
    d, cache, state = ex.decode_step(params, tok, cache, state)
    monkeypatch.undo()
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert d.prediction.shape == (4,)
