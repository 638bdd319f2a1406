"""The ssm family: chunkwise mLSTM and sequential sLSTM
(``models/xlstm.py``), the mlstm and slstm blocks, nested recurrent-state
caches through the staged executor's snapshots and cohorts, the lane
reset to the caches' init values, xlstm-350m — the port against the JAX
package on bridged weights, plus the port's own contracts.

Config: ``reduced(xlstm-350m, n_layers=9, slstm_every=3)``, f32, 3
components with exits after layers 3 and 5: the kinds are [mlstm, mlstm,
slstm] three times, so segment 0 is a stage of 2 mLSTM layers then one
sLSTM layer, segment 1 a stage of 2 mLSTM layers, and segment 2 an sLSTM
stage, 2 mLSTM layers and another sLSTM stage (two sLSTM stages of one
shape in one segment, as xlstm-350m's last segment has).  d 256, 4 heads:
mLSTM d_inner 512 (4 heads of 128), sLSTM heads of 64.  Every cache leaf
is a state leaf; an sLSTM layer's nest four under ``"state"``.

The JAX init leaves some leaves degenerate — ``conv_b``, ``b_i`` (zeros),
``b_f`` (3.0), ``out_norm_w`` (ones) and the sLSTM ``b`` (zeros and 3.0)
— so before bridging each gets N(0, 0.5²) noise added (numpy seed 17): a
missing bias or a norm weight read as ones then shows.

Tolerances: the chunkwise scan, the conv, the cells, the sublayers and
the blocks within 5e-5 (``XL_TOL``: f32 sums over a chunk of up to 256
unit-scale products in other orders, and stabilised exponents; measured
up to ~2e-5) — the sLSTM normaliser ``n`` and the chunkwise states
against the float64 sequential oracle within 1e-3 (the oracle's own
test's); exit logits and cache leaves 3e-4 (``LOGIT_TOL``: measured up
to 1.5e-4 after a few decode steps on these weights, where the port's and
the reference's f32 prefill logits stand 3.3e-5 and 3.6e-5 from a float64
run of the port — the model's conditioning, not a drift of one package;
the sLSTM gates and the mLSTM normaliser amplify f32 rounding);
train-step losses 1e-4; decode streams:
tokens, exit indices, ``segments_run`` and telemetry counters exactly,
confidences and EMAs 1e-5; within the port (host ≡ device runtime, major
≡ copy, select ≡ cond_batch, autotune on ≡ off) bit for bit.
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
from repro.models import xlstm as jax_xlstm
from repro.models.model import build_model as jax_build_model
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
from repro_torch.models import blocks, nn, xlstm
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


XL_TOL = 5e-5
ORACLE_TOL = 1e-3
LOGIT_TOL = 3e-4
CONF_TOL = 1e-5
STEP_TOL = 1e-4
ARCH = "xlstm-350m"
DEGENERATE = ("conv_b", "b_i", "b_f", "out_norm_w", "b")


def _cfgs(**kw):
    cas = dict(n_components=3, exit_boundaries=(3, 5))
    cas.update(kw.pop("cascade", {}))
    jcfg = jax_reduced(jax_get_config(ARCH), n_layers=9,
                       slstm_every=3).replace(
        dtype="float32", **kw).with_cascade(**cas)
    cfg = reduced(get_config(ARCH), n_layers=9, slstm_every=3).replace(
        dtype="float32", **kw).with_cascade(**cas)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _undegenerate(tree, rng):
    """The JAX init with its constant leaves (biases, the out norm's
    weight) moved off their constants by N(0, 0.5²) noise."""
    if isinstance(tree, dict):
        return {k: (jnp.asarray(np.asarray(v, np.float32) + 0.5
                                * rng.standard_normal(v.shape),
                                np.float32).astype(v.dtype)
                    if k in DEGENERATE else _undegenerate(v, rng))
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


def _close(got, want, tol=XL_TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _tree_to_torch(tree):
    return nn.tree_map(lambda v: torch.from_numpy(np.array(v)), tree)


def _tree_to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

def test_config_copy_equals_reference_field_by_field():
    ours, ref = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.segments == ref.segments == ((0, 8), (8, 16), (16, 24))
    assert dataclasses.asdict(reduced(ours)) == dataclasses.asdict(
        jax_reduced(ref))


def test_full_width_config_builds():
    """xlstm-350m at its published widths (no weights drawn: the card's
    phase draws them): 20 mLSTM and 4 sLSTM layers (5, 11, 17, 23); the
    segments' stages; a bf16 cache's states in f32, its conv windows in
    bf16, every leaf a state leaf, on the meta device; the reference's
    parameter count, and the reference's init at 513.3 M parameters."""
    cfg = get_config(ARCH)
    model = build_model(cfg, device="cpu")
    kinds = blocks.layer_kinds(cfg)
    assert kinds == jax_blocks.layer_kinds(jax_get_config(ARCH))
    assert [i for i, k in enumerate(kinds) if k == "slstm"] == [5, 11, 17,
                                                                23]
    assert model.segment_runs == [
        [("mlstm", 5), ("slstm", 1), ("mlstm", 2)],
        [("mlstm", 3), ("slstm", 1), ("mlstm", 4)],
        [("mlstm", 1), ("slstm", 1), ("mlstm", 5), ("slstm", 1)]]
    cache = model.init_cache(4, 512, dtype=torch.bfloat16, device="meta")
    seen = set()
    for si, seg in enumerate(cache["segments"]):
        mask = model.state_leaf_mask(si, seg)
        leaves = list(nn.tree_leaves(seg))
        assert len(mask) == len(leaves) and all(mask)
        for leaf in leaves:
            seen.add((tuple(leaf.shape), leaf.dtype))
    assert ((5, 4, 4, 512, 512), torch.float32) in seen
    assert ((5, 4, 4, 512), torch.float32) in seen
    assert ((5, 4, 4), torch.float32) in seen
    assert ((5, 4, 3, 2048), torch.bfloat16) in seen
    assert ((1, 4, 1024), torch.float32) in seen
    assert list(cache["segments"][0][1]) == ["state"]
    assert list(cache["segments"][0][1]["state"]) == ["c", "h", "m", "n"]
    assert macs.param_count(cfg) == jax_macs.param_count(jax_get_config(ARCH))
    shapes = jax.eval_shape(jax_build_model(jax_get_config(ARCH)).init,
                            jax.random.PRNGKey(0))
    n = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    assert round(n / 1e6, 1) == 513.3


def test_registered_families_have_one_mask_entry_per_cache_leaf():
    """``state_leaf_mask`` has one entry per :func:`nn.tree_leaves` leaf of
    every segment's cache, for every registered LLM architecture (an
    sLSTM stage's nested ``state`` dict is four leaves), and the executor
    refuses a mask of another length instead of zipping it short."""
    for name in list_configs():
        cfg = get_config(name)
        if cfg.family == "cnn":
            continue
        model = build_model(reduced(cfg), device="cpu")
        cache = model.init_cache(2, 16, device="meta")
        for si, seg in enumerate(cache["segments"]):
            assert len(model.state_leaf_mask(si, seg)) == len(
                list(nn.tree_leaves(seg))), (name, si)
    _, cfg = _cfgs()
    model = build_model(cfg, device="cpu")
    seg = model.init_cache(2, 16, device="meta")["segments"][2]
    mask = model.state_leaf_mask(2, seg)
    assert mask == [True] * 12          # 2 sLSTM stages x 4, an mLSTM's 4
    with pytest.raises(ValueError, match="12 cache leaves"):
        exec_mod._split_leaves(seg, mask[:9])


# ---------------------------------------------------------------------------
# the mLSTM sublayer against the reference
# ---------------------------------------------------------------------------

def _layer(kind="mlstm", si=0, pi=None, i=0):
    """Layer ``i`` of a stage of segment ``si``: (jax params, port
    params) of its ``kind`` dict."""
    jparams, params = _weights()
    if pi is None:
        pi = 0 if kind == "mlstm" else 1
    return (jax.tree_util.tree_map(lambda a: a[i],
                                   jparams["segments"][si][pi][kind]),
            nn.tree_index(params["segments"][si][pi][kind], i))


def _qkvif(B, S, h, p, seed):
    return (_rand((B, S, h, p), seed), _rand((B, S, h, p), seed + 1),
            _rand((B, S, h, p), seed + 2), _rand((B, S, h), seed + 3),
            _rand((B, S, h), seed + 4) + 2.0)


def _mlstm_state(B, h, p, seed):
    return (_rand((B, h, p, p), seed, 0.5), _rand((B, h, p), seed + 1, 0.5),
            _rand((B, h), seed + 2))


@pytest.mark.parametrize("init_state", [False, True])
@pytest.mark.parametrize("S,chunk", [(32, 32), (96, 32), (64, 16)])
def test_mlstm_chunked_equals_reference(S, chunk, init_state):
    B, h, p = 2, 4, 16
    args = _qkvif(B, S, h, p, 1)
    st = _mlstm_state(B, h, p, 6) if init_state else None
    want_h, want_s = jax.jit(jax_xlstm.mlstm_chunked, static_argnums=5)(
        *map(jnp.asarray, args), chunk,
        None if st is None else tuple(map(jnp.asarray, st)))
    got_h, got_s = xlstm.mlstm_chunked(
        *map(torch.from_numpy, args), chunk,
        None if st is None else tuple(map(torch.from_numpy, st)))
    _close(got_h, want_h)
    for a, b in zip(got_s, want_s):
        _close(a, b)
        assert a.dtype == torch.float32


def _seq_mlstm(q, k, v, i_pre, f_pre):
    """Sequential stabilised mLSTM oracle (float64), the JAX package's
    ``tests/test_models_math.py`` one."""
    B, S, h, p = q.shape
    scale = 1.0 / np.sqrt(p)
    q = np.asarray(q, np.float64) * scale
    k = np.asarray(k, np.float64)
    v = np.asarray(v, np.float64)
    logf = -np.log1p(np.exp(-np.asarray(f_pre, np.float64)))
    i = np.asarray(i_pre, np.float64)
    C = np.zeros((B, h, p, p))
    n = np.zeros((B, h, p))
    m = np.full((B, h), -1e30)
    out = np.zeros((B, S, h, p))
    for t in range(S):
        m_new = np.maximum(logf[:, t] + m, i[:, t])
        wf = np.exp(logf[:, t] + m - m_new)
        wi = np.exp(i[:, t] - m_new)
        C = wf[..., None, None] * C + wi[..., None, None] * np.einsum(
            "bhp,bhd->bhpd", k[:, t], v[:, t])
        n = wf[..., None] * n + wi[..., None] * k[:, t]
        num = np.einsum("bhp,bhpd->bhd", q[:, t], C)
        qn = np.einsum("bhp,bhp->bh", q[:, t], n)
        denom = np.maximum(np.abs(qn), np.exp(-m_new))
        out[:, t] = num / denom[..., None]
        m = m_new
    return out, (C, n, m)


@pytest.mark.parametrize("S,chunk", [(32, 8), (48, 16)])
def test_mlstm_chunked_matches_sequential_oracle(S, chunk):
    B, h, p = 2, 2, 8
    args = _qkvif(B, S, h, p, 11)
    hid, (C, n, m) = xlstm.mlstm_chunked(*map(torch.from_numpy, args), chunk)
    hid_ref, (C_ref, n_ref, m_ref) = _seq_mlstm(*args)
    _close(hid, hid_ref, ORACLE_TOL)
    _close(C, C_ref, ORACLE_TOL)
    _close(n, n_ref, ORACLE_TOL)
    _close(m, m_ref, 1e-4)


def test_mlstm_chunked_gradients_are_finite():
    """The mask goes on before the exponent: the backward through the
    upper triangle stays finite."""
    q, k, v, i_pre, f_pre = (torch.from_numpy(a).requires_grad_()
                             for a in _qkvif(1, 32, 2, 8, 21))
    hid, (C, n, _) = xlstm.mlstm_chunked(q, k, v, i_pre, f_pre, 16)
    (hid.sum() + C.sum() + n.sum()).backward()
    for x in (q, k, v, i_pre, f_pre):
        assert torch.isfinite(x.grad).all()


def _mlstm_cache(cfg, B, seed):
    """A random conv window and state of a reduced mLSTM layer (keys in
    the reference's leaf order)."""
    d_inner, h, p = xlstm.mlstm_dims(cfg)
    C, n, m = _mlstm_state(B, h, p, seed)
    return {"C": C, "conv": _rand((B, xlstm.CONV_W - 1, d_inner), seed + 3,
                                  0.5), "m": m, "n": n}


@pytest.mark.parametrize("with_cache", [False, True])
@pytest.mark.parametrize("S", [45, 300])
def test_mlstm_forward_full_equals_reference(S, with_cache):
    """S 45 is one chunk of 45; S 300 takes the padded path (chunk 256,
    padded to 512 with identity steps); with a cache the conv and the
    scan start from its window and state, and the new ones are written in
    place."""
    jcfg, cfg = _cfgs()
    jp, tp = _layer(i=1)
    x = _rand((2, S, cfg.d_model), 31)
    cache = _mlstm_cache(cfg, 2, 32) if with_cache else None
    want, wcache = jax.jit(lambda p, x, c: jax_xlstm.mlstm_forward_full(
        p, jcfg, x, c))(jp, jnp.asarray(x),
                        None if cache is None else _tree_to_jax(cache))
    tcache = None if cache is None else _tree_to_torch(cache)
    got, gcache = xlstm.mlstm_forward_full(tp, cfg, torch.from_numpy(x),
                                           tcache)
    _close(got, want)
    if with_cache:
        assert gcache is tcache
        for k in cache:
            _close(tcache[k], wcache[k])


def test_mlstm_decode_steps_equal_reference():
    """Five single-token steps, the first from the fresh cache (m at its
    sentinel), each step's output and every rewritten leaf against the
    reference's."""
    jcfg, cfg = _cfgs()
    jp, tp = _layer()
    jcache = jax_xlstm.mlstm_init_cache(jcfg, 3, jnp.float32)
    tcache = xlstm.mlstm_init_cache(cfg, 3, torch.float32, "cpu")
    assert float(tcache["m"][0, 0]) == float(np.float32(-1e30))
    step = jax.jit(lambda p, x, c: jax_xlstm.mlstm_decode_step(p, jcfg, x, c))
    for i in range(5):
        x = _rand((3, 1, cfg.d_model), 40 + i)
        want, jcache = step(jp, jnp.asarray(x), jcache)
        got, _ = xlstm.mlstm_decode_step(tp, cfg, torch.from_numpy(x), tcache)
        _close(got, want)
        for k in tcache:
            _close(tcache[k], jcache[k])


# ---------------------------------------------------------------------------
# the sLSTM sublayer against the reference
# ---------------------------------------------------------------------------

def _slstm_state(cfg, B, seed):
    d = cfg.d_model
    return {"c": _rand((B, d), seed), "h": _rand((B, d), seed + 1, 0.5),
            "m": _rand((B, d), seed + 2),
            "n": np.abs(_rand((B, d), seed + 3)) + 0.1}


def test_slstm_cell_equals_reference():
    """One cell step from a random state and from the zero state (m at
    -30: the first step's n can fall under the 1e-6 floor)."""
    jcfg, cfg = _cfgs()
    jp, tp = _layer("slstm")
    xt = _rand((3, 4 * cfg.d_model), 50)
    for st in (_slstm_state(cfg, 3, 51),
               {k: _np(v) for k, v in xlstm.slstm_zero_state(cfg, 3).items()}):
        want = jax.jit(lambda p, x, s: jax_xlstm._slstm_cell(p, jcfg, x, s))(
            jp, jnp.asarray(xt), _tree_to_jax(st))
        got = xlstm._slstm_cell(tp, cfg, torch.from_numpy(xt),
                                _tree_to_torch(st))
        assert list(got) == sorted(want)
        for k in got:
            _close(got[k], want[k])


@pytest.mark.parametrize("with_cache", [False, True])
def test_slstm_forward_full_equals_reference(with_cache):
    jcfg, cfg = _cfgs()
    jp, tp = _layer("slstm", si=2, pi=2)
    x = _rand((2, 37, cfg.d_model), 52)
    cache = {"state": _slstm_state(cfg, 2, 53)} if with_cache else None
    want, wcache = jax.jit(lambda p, x, c: jax_xlstm.slstm_forward_full(
        p, jcfg, x, c))(jp, jnp.asarray(x),
                        None if cache is None else _tree_to_jax(cache))
    tcache = None if cache is None else _tree_to_torch(cache)
    got, gcache = xlstm.slstm_forward_full(tp, cfg, torch.from_numpy(x),
                                           tcache)
    _close(got, want)
    if with_cache:
        assert gcache is tcache
        for k in cache["state"]:
            _close(tcache["state"][k], wcache["state"][k])


def test_slstm_decode_steps_equal_reference():
    jcfg, cfg = _cfgs()
    jp, tp = _layer("slstm")
    jcache = jax_xlstm.slstm_init_cache(jcfg, 3, jnp.float32)
    tcache = xlstm.slstm_init_cache(cfg, 3, torch.float32, "cpu")
    step = jax.jit(lambda p, x, c: jax_xlstm.slstm_decode_step(p, jcfg, x, c))
    for i in range(5):
        x = _rand((3, 1, cfg.d_model), 60 + i)
        want, jcache = step(jp, jnp.asarray(x), jcache)
        got, _ = xlstm.slstm_decode_step(tp, cfg, torch.from_numpy(x), tcache)
        _close(got, want)
        for k in tcache["state"]:
            _close(tcache["state"][k], jcache["state"][k])


# ---------------------------------------------------------------------------
# the blocks against the reference, both modes
# ---------------------------------------------------------------------------

def _ctx_pair(mode, S, W=64, t=50):
    """A (jax ctx, port ctx) pair: full mode over S positions, or a decode
    step at position t."""
    kpos = np.where(np.arange(W) < t, np.arange(W), -1).astype(np.int32)
    if mode == "full":
        pos = np.arange(S, dtype=np.int32)
        ws = np.where(np.arange(W) < S, np.arange(W), -1).astype(np.int32)
        jctx = {"mode": "full", "positions": jnp.asarray(pos),
                "write_slots": jnp.asarray(ws), "cross": None,
                "shared": None, "kpos": jnp.asarray(kpos)}
        ctx = {"mode": "full", "positions": torch.from_numpy(pos),
               "write_slots": torch.from_numpy(ws),
               "kpos": torch.from_numpy(kpos), "shared": None}
        return jctx, ctx
    jctx = {"mode": "decode", "t": jnp.int32(t), "slot": jnp.int32(t % W),
            "kpos": jnp.asarray(kpos), "positions": None,
            "write_slots": None, "cross": None, "shared": None}
    kpos_t = kpos.copy()
    kpos_t[t % W] = t
    ctx = {"mode": "decode", "t": torch.tensor(t, dtype=torch.int32),
           "slot": torch.tensor(t % W), "kpos": torch.from_numpy(kpos),
           "kpos_t": torch.from_numpy(kpos_t), "shared": None}
    return jctx, ctx


def _block_case(kind, mode, what):
    """Run block ``kind``'s ``what`` ("apply" or "backfill") in ``mode``
    on both packages from the same cache; compare h and every cache
    leaf.  Returns the port's cache."""
    jcfg, cfg = _cfgs()
    jparams, params = _weights()
    si, pi = (1, 0) if kind == "mlstm" else (2, 0)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["segments"][si][pi])
    tp = nn.tree_index(params["segments"][si][pi], 0)
    B, S = 2, (40 if mode == "full" else 1)
    jctx, ctx = _ctx_pair(mode, S)
    cache = (_mlstm_cache(cfg, B, 70) if kind == "mlstm"
             else {"state": _slstm_state(cfg, B, 70)})
    h = _rand((B, S, cfg.d_model), 71)
    jb, tb = jax_blocks.BLOCKS[kind], blocks.BLOCKS[kind]
    tcache = _tree_to_torch(cache)
    if what == "apply":
        want_h, wcache, _ = jax.jit(lambda p, h, c: jb.apply(
            jcfg, p, h, jctx, c))(jp, jnp.asarray(h), _tree_to_jax(cache))
        got_h, gcache, aux = tb.apply(cfg, tp, torch.from_numpy(h), ctx,
                                      tcache)
        _close(got_h, want_h)
        assert aux == 0.0
    else:
        wcache = jax.jit(lambda p, h, c: jb.backfill(jcfg, p, h, jctx, c))(
            jp, jnp.asarray(h), _tree_to_jax(cache))
        gcache = tb.backfill(cfg, tp, torch.from_numpy(h), ctx, tcache)
    assert gcache is tcache                        # written in place
    for a, b in zip(nn.tree_leaves(tcache),
                    jax.tree_util.tree_leaves(wcache), strict=True):
        _close(a, b)
    return tcache


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("mode", ["full", "decode"])
def test_apply_and_backfill_equal_reference(kind, mode):
    applied = _block_case(kind, mode, "apply")
    filled = _block_case(kind, mode, "backfill")
    # the backfill's recurrence is the apply's, bit for bit
    for a, b in zip(nn.tree_leaves(applied), nn.tree_leaves(filled)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the model: prefill, dense decode steps, forward_train, training
# ---------------------------------------------------------------------------

S_PROMPT = 45


def test_prefill_and_decode_steps_match_reference():
    """Prefill logits of every exit and 4 dense decode steps, the
    reference's greedy tokens fed back; the port's kernels on (their
    plain versions here) and off; every cache leaf at the end."""
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
                        jax.tree_util.tree_leaves(jcache["segments"]),
                        strict=True):
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
    (gradients through the chunkwise scan and the sLSTM scan): losses
    within 1e-4, and every parameter finite after."""
    jparams, _ = _weights()
    jcfg, cfg = _cfgs()
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(13)
    batches = [rng.integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
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


def _port_trace(cfg, params):
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
    EMAs and every cache leaf (every recurrent state) within tolerance,
    against the reference's executor; with 2 cohorts the major and copy
    layouts bit for bit alike, select mode with the cohort scatter (its
    whole-cohort route: the family has no ring leaf) too."""
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
    if case == "all_exit":
        assert not exits.any()
    elif case == "full_depth":
        assert (exits == 2).all()
    else:
        assert set(np.unique(exits)) >= {0, 2}


@pytest.mark.parametrize("case", ["all_exit", "full_depth"])
def test_cond_batch_steps_deep_segments_per_cohort(case, monkeypatch):
    """2 cohorts, the major layout, cond_batch: when every cohort skips
    (all_skip) or none does (all_run), each deep segment still runs or
    backfills one cohort's 2 rows at a time, as select mode does — never
    the batch's 4 — while the dispatch counters count the branch the exit
    state picked."""
    _, params = _weights()
    _, cfg = _cfgs(use_kernels=True, cascade=dict(
        exit_mode="cond_batch", thresholds=THRESHOLDS[case], n_cohorts=2))
    m = build_model(cfg, device="cpu")
    ex = StagedExecutor(m, cfg)
    d, cache, state = ex.prefill(params, torch.from_numpy(_tokens(
        cfg.vocab_size)), m.init_cache(4, 64))
    rows = []
    for name in ("run_segment", "backfill_segment"):
        orig = getattr(m, name)

        def spy(si, params, h, ctx, seg_cache, _orig=orig):
            rows.append((si, h.shape[0]))
            return _orig(si, params, h, ctx, seg_cache)

        monkeypatch.setattr(m, name, spy)
    for _ in range(2):
        d, cache, state = ex.decode_step(params, d.prediction[:, None],
                                         cache, state)
    assert {r for si, r in rows if si > 0} == {2}
    assert {r for si, r in rows if si == 0} == {4}
    branch = "all_skip" if case == "all_exit" else "all_run"
    assert ex.dispatch[branch] == 2 * 2 == sum(ex.dispatch.values())


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


def test_select_restores_all_four_slstm_state_leaves(monkeypatch):
    """A select step runs a deep segment, then takes the skip path (the
    backfill) from the step's ENTRY caches: every state leaf the backfill
    sees equals the leaf before the step — all four of each sLSTM layer's
    nested ``state`` (c, h, m, n), not only the first (a mask of one
    entry per stage key would zip the other three away, and their
    recurrence would advance twice).  At (0, 0, 0) every row skips, so the
    selected state is the backfill's, as cond_batch's."""
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
    slstm_leaves = 0
    for si in (1, 2):
        assert len(seen[si]) == len(entry[si])
        for before, at_skip in zip(entry[si], seen[si]):
            torch.testing.assert_close(at_skip, before, rtol=0, atol=0)
        for pi, (kind, _) in enumerate(m.segment_runs[si]):
            if kind == "slstm":
                assert list(cache["segments"][si][pi]["state"]) == [
                    "c", "h", "m", "n"]
                slstm_leaves += 4
    assert slstm_leaves == 8                   # segment 2's two sLSTM stages
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


def test_cohort_scatter_lands_every_leaf_whole(mid_threshold, monkeypatch):
    """select mode with 2 cohorts and the cohort scatter: the family has no
    ring leaf, so each segment lands each cohort with ONE scatter call,
    the whole-cohort route over all its leaves (12 in segment 2: two
    sLSTM stages' 4 nested leaves and an mLSTM stage's 4)."""
    _, params = _weights()
    calls = []
    orig = ops.cohort_scatter_tree

    def spy(dst, src, c, C, slot=None):
        calls.append((len(list(nn.tree_leaves(dst))), slot is not None))
        return orig(dst, src, c, C, slot=slot)

    monkeypatch.setattr(ops, "cohort_scatter_tree", spy)
    _, cfg = _cfgs(use_kernels=True, cascade=dict(
        exit_mode="select", thresholds=(mid_threshold, 1.1, 0.0),
        n_cohorts=2))
    _port_trace(cfg.with_kernel_tune(cohort_scatter=True), params)
    assert len(calls) == STEPS * 2 * 2
    assert set(calls) == {(4, False), (12, False)}


# ---------------------------------------------------------------------------
# the serving engine against the JAX engine
# ---------------------------------------------------------------------------

ENGINE_KW = dict(lane_batch=2, n_lanes=2, cache_len=128, chunk=4)
# six requests for four slots, budgets that end at different steps: a
# lane whose slot frees re-prefills with its resident's full context
# (prompt + generated) and the new prompt, from the caches' init values
PROMPTS = ((40, 7), (20, 3), (33, 6), (12, 4), (45, 5), (25, 6))


@pytest.fixture(scope="module")
def engine_ths():
    """Engine thresholds (th, th, 0.0) at the median of the decode
    confidences of a port engine run at (0, 0, 0): the exits are mixed."""
    _, params = _weights()
    eng = _drive("torch", _engine_cfg("torch", autotune=False,
                                      ths=(0.0, 0.0, 0.0)), params)
    c = np.sort([x for f in eng.finished.values() for x in f["confs"][1:]])
    i = len(c) // 2
    th = float((c[i - 1] + c[i]) / 2)
    return (th, th, 0.0)


def _engine_cfg(pkg, mode="cond_batch", cohorts=1, autotune=True,
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


@pytest.mark.parametrize("cohorts", [1, 2])
@pytest.mark.parametrize("mode", ["cond_batch", "select"])
@pytest.mark.parametrize("runtime", ["host", "device"])
def test_engine_matches_reference_engine(engine_ths, runtime, mode,
                                         cohorts):
    """Streams, exits, the carried segments_run and every telemetry
    counter (a shadow step every 2 positions) equal the JAX engine's
    exactly, through lane re-prefills with residents; the exits are
    mixed."""
    jparams, params = _weights()
    want = _drive("jax", _engine_cfg("jax", mode, cohorts, ths=engine_ths),
                  jparams, runtime)
    got = _drive("torch", _engine_cfg("torch", mode, cohorts,
                                      ths=engine_ths), params, runtime)
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


def test_engine_layouts_autotune_and_modes_agree_bit_for_bit(engine_ths):
    """Within the port: 2 cohorts in the copy layout serve what the major
    layout serves; autotune off serves what autotune on serves (the
    shadow step changes what executes, never what is produced); select
    with the cohort scatter serves what cond_batch serves."""
    _, params = _weights()
    base = _streams(_drive("torch", _engine_cfg("torch", cohorts=2,
                                                ths=engine_ths), params))
    for cfg in (_engine_cfg("torch", cohorts=2, layout="copy",
                            ths=engine_ths),
                _engine_cfg("torch", cohorts=2, autotune=False,
                            ths=engine_ths),
                _engine_cfg("torch", "select", 2, autotune=False,
                            ths=engine_ths)
                .with_kernel_tune(cohort_scatter=True)):
        assert _streams(_drive("torch", cfg, params)) == base


def test_lane_reprefill_restarts_every_state_at_its_init_value(
        engine_ths, monkeypatch):
    """Every lane (re-)prefill starts from the caches' init values: the
    mLSTM stabiliser ``m`` at -1e30 and the sLSTM one at -30.0 (not 0,
    which would decode other tokens than the reference's fresh cache),
    every other leaf 0 — and the slab keeps its address."""
    _, params = _weights()
    cfg = _engine_cfg("torch", autotune=False, ths=engine_ths)
    model = build_model(cfg, device="cpu")
    eng = CascadeServingEngine(cfg, model, params, device="cpu", **ENGINE_KW)
    addrs = [[x.data_ptr() for x in nn.tree_leaves(ln["cache"])]
             for ln in eng.lanes]
    seen = []
    orig = eng.executor.prefill

    def spy(params, toks, cache, state, extra=None):
        seen.append([x.clone() for x in nn.tree_leaves(cache["segments"])])
        return orig(params, toks, cache, state, extra=extra)

    monkeypatch.setattr(eng.executor, "prefill", spy)
    _drive("torch", cfg, params, engine=eng)
    assert len(seen) > ENGINE_KW["n_lanes"]          # re-prefills happened
    fresh = model.init_cache(ENGINE_KW["lane_batch"], ENGINE_KW["cache_len"])
    sentinels = set()
    for leaves in seen:
        for x, f in zip(leaves, nn.tree_leaves(fresh["segments"]),
                        strict=True):
            torch.testing.assert_close(x, f, rtol=0, atol=0)
            if x.dim() in (3, 4) and bool((x < 0).all()):
                sentinels.add(float(x.flatten()[0]))
    assert sentinels == {float(np.float32(-1e30)), -30.0}
    assert addrs == [[x.data_ptr() for x in nn.tree_leaves(ln["cache"])]
                     for ln in eng.lanes]


def test_paged_ssm_is_refused_with_reference_message():
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
    assert "['C', 'conv', 'm', 'n']" in str(err.value)
    # sLSTM layers only (slstm_every 1): the stage names ['state'], as the
    # reference's does
    msgs = []
    for pkg_cfg, build, cache_cls in (
            (jcfg.replace(slstm_every=1), jax_build_model, JaxPagedCache),
            (cfg.replace(slstm_every=1),
             lambda c: build_model(c, device="cpu"), PagedCascadeCache)):
        with pytest.raises(ValueError) as e:
            cache_cls(build(pkg_cfg), pkg_cfg, lane_batch=2, n_lanes=1,
                      cache_len=32)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "(['state'])" in msgs[1]


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
    for kind in ("mlstm", "slstm"):
        assert macs._layer_macs_per_token(full, kind, 512) == \
            jax_macs._layer_macs_per_token(jfull, kind, 512)
    # the reference's d * (4 * d) // 3 is floor(4 d^2 / 3)
    d = 1000
    assert macs._layer_macs_per_token(
        full.replace(d_model=d), "slstm", 1) == jax_macs._layer_macs_per_token(
        jfull.replace(d_model=d), "slstm", 1)


def test_serve_cli_smoke():
    stats = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "4", "--max-new", "4", "--cohorts",
                        "2"])
    assert stats["requests_finished"] == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_bit_exact(dtype):
    jcfg, cfg = _cfgs()
    jcfg, cfg = jcfg.replace(dtype=dtype), cfg.replace(dtype=dtype)
    jparams = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(5))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tp = params_from_jax(np_params, cfg, device="cpu")
    assert "shared" not in tp
    # every float leaf is in the model dtype, the sLSTM recurrent matrices
    # and the mLSTM gate projections too (the reference's init casts them)
    assert tp["segments"][0][1]["slstm"]["r"].dtype == getattr(torch, dtype)
    assert tp["segments"][0][0]["mlstm"]["w_i"].dtype == getattr(torch,
                                                                 dtype)
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


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_runs_without_host_reads(kind, monkeypatch):
    """No ``.item()``, ``nonzero`` or ``tolist`` in an xLSTM decode step
    or its backfill (a captured graph cannot read the device)."""
    def boom(*a, **kw):
        raise AssertionError(f"host read in an {kind} step")

    _, cfg = _cfgs()
    _, tp = _layer(kind)
    cache = _tree_to_torch(_mlstm_cache(cfg, 2, 80) if kind == "mlstm"
                           else {"state": _slstm_state(cfg, 2, 80)})
    x = torch.from_numpy(_rand((2, 1, cfg.d_model), 81))
    mod = xlstm
    step = getattr(mod, f"{kind}_decode_step")
    fill = getattr(mod, f"{kind}_backfill_step")
    for name in ("item", "tolist", "nonzero", "__bool__", "__int__",
                 "__float__"):
        monkeypatch.setattr(torch.Tensor, name, boom)
    out, _ = step(tp, cfg, x, cache)
    fill(tp, cfg, x, cache)
    monkeypatch.undo()
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
