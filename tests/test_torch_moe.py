"""The moe family: the top-k router with GShard capacity dispatch
(``models/moe.py``), the moe block, the executor's two-way cohort
dispatch, mixtral-8x7b and qwen3-moe-235b-a22b — the port against the JAX
package on bridged weights, plus the port's own contracts.

Configs: ``reduced(...)`` at 3 layers and 3 components (exits after layers
1 and 2), f32: 4 experts, top 2, d 256, 4 / 1 heads of 64; mixtral keeps
its window (128), qwen3 also runs with ``head_dim=128`` so that H·hd = 512
differs from d = 256.  ``reduced`` makes the two archs' shapes equal but
for the window.

Tolerances, section by section:
* the router: which experts each token picks, its queue positions, its
  drops and the dispatch tensor exactly; the gates (the combine tensor)
  and the aux loss within 2e-6 relative — XLA's f32 ``exp`` on the CPU
  and torch's differ in the last bit, so the softmax that both packages
  compute from the same logits can part by an ulp (measured: 1.2e-7 on
  gates of at most 1);
* ``moe_apply`` within 1e-5 (the expert matmuls summed in other orders);
* exit logits 1e-4 (``LOGIT_TOL``, three layers of f32 matmuls, as
  ``tests/test_torch_dense_family.py``), aux 1e-5, train-step losses 1e-4;
* decode streams: tokens, exit indices and ``segments_run`` exactly,
  confidences and EMAs 1e-5; within the port (host ≡ device runtime,
  major ≡ copy, select ≡ cond_batch on the cohort-split rows) bit for bit.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import macs as jax_macs
from repro.core.exec import StagedExecutor as JaxExecutor
from repro.launch import steps as jax_steps
from repro.models import blocks as jax_blocks
from repro.models import moe as jax_moe
from repro.models.model import build_model as jax_build_model
from repro.serving.paged.cache import PagedCascadeCache as JaxPagedCache
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_config, reduced
from repro_torch.core import macs
from repro_torch.core.exec import StagedExecutor
from repro_torch.launch import serve, steps
from repro_torch.models import blocks, moe, nn
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


ROUTE_TOL = 2e-6
MOE_TOL = 1e-5
LOGIT_TOL = 1e-4
AUX_TOL = 1e-5
CONF_TOL = 1e-5
STEP_TOL = 1e-4
ARCHS = ["mixtral-8x7b", "qwen3-moe-235b-a22b"]
# name -> (arch, overrides of the reduced config)
SHAPES = {
    "mixtral": ("mixtral-8x7b", {}),
    "qwen3": ("qwen3-moe-235b-a22b", {}),
    "qwen3-hd128": ("qwen3-moe-235b-a22b", {"head_dim": 128}),
}


def _cfgs(name, **kw):
    arch, over = SHAPES[name]
    cas = dict(n_components=3, exit_boundaries=(1, 2))
    cas.update(kw.pop("cascade", {}))
    jcfg = jax_reduced(jax_get_config(arch), n_layers=3).replace(
        dtype="float32", **over, **kw).with_cascade(**cas)
    cfg = reduced(get_config(arch), n_layers=3).replace(
        dtype="float32", **over, **kw).with_cascade(**cas)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


_WEIGHTS = {}


def _weights(name):
    """The reference's seed-0 init, bridged (once per config)."""
    if name not in _WEIGHTS:
        jcfg, cfg = _cfgs(name)
        jparams = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))
        _WEIGHTS[name] = (jparams, params_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu"))
    return _WEIGHTS[name]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------------------------------
# the configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_equals_reference_field_by_field(arch):
    ours, ref = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.segments == ref.segments
    assert dataclasses.asdict(reduced(ours)) == dataclasses.asdict(
        jax_reduced(ref))
    assert (ours.capacity_factor, ours.router_aux_coef) == (1.25, 0.01)


@pytest.mark.parametrize("arch,E,k,group,hd,window", [
    ("mixtral-8x7b", 8, 2, 4, 128, 4096),
    ("qwen3-moe-235b-a22b", 128, 8, 16, 128, 0)])
def test_full_width_configs_build(arch, E, k, group, hd, window):
    """The published widths build (no weights drawn: the card's phase
    draws them) and their caches have the published shapes, on the meta
    device; mixtral's ring holds its window."""
    cfg = get_config(arch)
    assert (cfg.n_experts, cfg.top_k, cfg.q_per_kv, cfg.resolved_head_dim,
            cfg.attn_window, cfg.d_model) == (E, k, group, hd, window, 4096)
    model = build_model(cfg, device="cpu")
    assert sum(n for runs in model.segment_runs for _, n in runs) \
        == cfg.n_layers
    assert all(kind == "moe" for runs in model.segment_runs
               for kind, _ in runs)
    cache = model.init_cache(4, 8192, device="meta")
    W = 4096 if window else 8192
    assert cache["kpos"].shape == (W,)
    leaves = list(nn.tree_leaves(cache["segments"]))
    assert all(x.shape[1:] == (4, W, cfg.n_kv_heads, hd) for x in leaves)


# ---------------------------------------------------------------------------
# capacity and route_topk: exact routing
# ---------------------------------------------------------------------------

def test_capacity_equals_reference():
    for n in (1, 2, 4, 7, 16, 40, 4096, 16896):
        for E, k in ((4, 2), (8, 2), (128, 8)):
            for cf in (0.25, 1.0, 1.25, 16.0):
                assert moe.capacity(n, E, k, cf) == \
                    jax_moe.capacity(n, E, k, cf), (n, E, k, cf)
    # the published serving shapes: a decode step of 4 rows gets the
    # floor of 4 slots an expert; mixtral's prefill groups 1280
    assert moe.capacity(4, 8, 2, 1.25) == moe.capacity(4, 128, 8, 1.25) == 4
    assert moe.capacity(4096, 8, 2, 1.25) == 1280


def _logits(kind, T, E, seed):
    rng = np.random.default_rng(seed)
    lg = rng.standard_normal((T, E)).astype(np.float32)
    if kind == "ties":
        # exact ties everywhere: the lower index must win
        lg = np.round(lg * 2) / 2
        lg[::3] = 0.0
    elif kind == "biased":
        # expert 1 wins every token: its queue fills and the rest drop,
        # in slot-major order
        lg[:, 1] += 6.0
    return lg


def _dispatch_combine(routing, T, E, cap):
    """The reference's dense (..., T, E, C) dispatch and combine tensors
    of the port's index-form ``routing`` (f32)."""
    *lead, _, k = routing.gates.shape
    flat = torch.zeros((*lead, T, E * cap), dtype=torch.float32,
                       device=routing.gates.device)
    kept = routing.kept
    disp = flat.clone()
    comb = flat.clone()
    for j in range(k):
        s = routing.choice_slot[..., j:j + 1]
        disp.scatter_add_(-1, s, kept[..., j:j + 1].float())
        comb.scatter_add_(-1, s, routing.gates[..., j:j + 1])
    return (disp.reshape(*lead, T, E, cap), comb.reshape(*lead, T, E, cap))


@pytest.mark.parametrize("kind", ["random", "ties", "biased"])
@pytest.mark.parametrize("T,E,k", [(16, 4, 2), (40, 4, 2), (40, 128, 8),
                                   (64, 128, 8)])
def test_route_topk_equals_reference(kind, T, E, k):
    lg = _logits(kind, T, E, seed=T + E + k)
    cap = moe.capacity(T, E, k, 1.25)
    d, c, a = jax.jit(jax_moe.route_topk, static_argnums=(1, 2))(
        jnp.asarray(lg), k, cap)
    r = moe.route_topk(torch.from_numpy(lg), k, cap)
    disp, comb = _dispatch_combine(r, T, E, cap)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(d))
    np.testing.assert_allclose(comb.numpy(), np.asarray(c), rtol=ROUTE_TOL,
                               atol=ROUTE_TOL)
    assert (comb.numpy() != 0).sum() == (np.asarray(c) != 0).sum()
    np.testing.assert_allclose(float(r.aux), float(a), rtol=ROUTE_TOL)
    # the index form: each kept choice's slot holds its token
    st = r.slot_token.numpy()
    for t in range(T):
        for j in range(k):
            if r.kept[t, j]:
                e, p = divmod(int(r.choice_slot[t, j]), cap)
                assert e == int(r.experts[t, j]) and st[e, p] == t
    assert (st <= T).all()
    if kind == "biased":
        dropped = ~r.kept.numpy()
        assert dropped.any()
        # expert 1 takes every token's first choice up to its capacity:
        # the first `cap` tokens keep it, the later ones drop
        assert (r.experts[:, 0] == 1).all()
        np.testing.assert_array_equal(r.kept[:, 0].numpy(),
                                      np.arange(T) < cap)
    if kind == "ties":
        zero = r.experts[::3].numpy()
        np.testing.assert_array_equal(zero, np.tile(np.arange(k),
                                                    (zero.shape[0], 1)))


def test_route_topk_groups_are_independent():
    """A leading group axis routes each group as its own call."""
    lg = np.stack([_logits(kind, 16, 4, seed=s)
                   for s, kind in enumerate(("random", "ties", "biased"))])
    cap = moe.capacity(16, 4, 2, 1.25)
    r = moe.route_topk(torch.from_numpy(lg), 2, cap)
    for g in range(3):
        one = moe.route_topk(torch.from_numpy(lg[g]), 2, cap)
        for a, b in zip(r, one):
            assert torch.equal(a[g], b)


# ---------------------------------------------------------------------------
# moe_apply across padded groups
# ---------------------------------------------------------------------------

def _moe_params(name, cf=None):
    jparams, params = _weights(name)
    jcfg, cfg = _cfgs(name)
    if cf is not None:
        jcfg, cfg = jcfg.replace(capacity_factor=cf), \
            cfg.replace(capacity_factor=cf)
    return (jparams["segments"][0][0], params["segments"][0][0], jcfg, cfg)


@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("B,S", [(2, 20), (1, 10)])
def test_moe_apply_equals_reference(monkeypatch, B, S, cf):
    """Groups of 16 tokens: T = 40 routes as three groups, the last
    padded with 8 zero rows (which pick experts 0 and 1 and queue before
    the real tokens' second choices); T = 10 as one group of 10.  At
    capacity factor 0.25 every expert has 4 slots and pairs drop."""
    monkeypatch.setattr(jax_moe, "GROUP_TOKENS", 16)
    monkeypatch.setattr(moe, "GROUP_TOKENS", 16)
    jstage, stage, jcfg, cfg = _moe_params("mixtral", cf)
    x = np.random.default_rng(B * S).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[0], jstage["moe"])
    tp = nn.tree_index(stage["moe"], 0)
    want, waux = jax.jit(lambda p, x: jax_moe.moe_apply(p, jcfg, x))(
        jp, jnp.asarray(x))
    got, aux = moe.moe_apply(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=MOE_TOL,
                               atol=MOE_TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=AUX_TOL)
    if cf < 1:
        # some pairs dropped: a token whose choices all dropped gets 0
        xg = torch.from_numpy(x).reshape(-1, cfg.d_model)
        T = xg.shape[0]
        Tg = min(16, T)
        xg = torch.cat([xg, xg.new_zeros((-T) % Tg, cfg.d_model)])
        r = moe.route_topk((xg @ tp["router"]).reshape(-1, Tg, 4), 2,
                           moe.capacity(Tg, 4, 2, cf))
        assert not r.kept.all()
        none = ~r.kept.any(-1).reshape(-1)[:T]
        if none.any():
            assert not got.reshape(T, -1)[none].any()


def test_moe_block_equals_reference():
    """The moe block (attention, then norm -> MoE -> residual) over a full
    sequence with no cache, and its aux."""
    jstage = _weights("qwen3-hd128")[0]["segments"][0][0]
    stage = _weights("qwen3-hd128")[1]["segments"][0][0]
    jcfg, cfg = _cfgs("qwen3-hd128")
    x = np.random.default_rng(4).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    pos = np.arange(12, dtype=np.int32)
    jctx = {"mode": "full", "positions": jnp.asarray(pos),
            "write_slots": None, "cross": None, "shared": None,
            "kpos": None}
    ctx = {"mode": "full", "positions": torch.from_numpy(pos),
           "write_slots": None, "kpos": None}
    jp = jax.tree_util.tree_map(lambda a: a[0], jstage)
    want, _, waux = jax.jit(lambda p, x: jax_blocks.BLOCKS["moe"].apply(
        jcfg, p, x, jctx, None))(jp, jnp.asarray(x))
    got, _, aux = blocks.BLOCKS["moe"].apply(cfg, nn.tree_index(stage, 0),
                                             torch.from_numpy(x), ctx, None)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=MOE_TOL,
                               atol=MOE_TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=AUX_TOL)


# ---------------------------------------------------------------------------
# the model: prefill, dense decode steps, forward_train
# ---------------------------------------------------------------------------

S_PROMPT = 20


@pytest.mark.parametrize("name", list(SHAPES))
def test_prefill_and_decode_steps_match_reference(name):
    """Prefill logits of every exit and 3 dense decode steps, the
    reference's greedy tokens fed back; the port kernels on (their plain
    versions here) and off."""
    jparams, params = _weights(name)
    jcfg, _ = _cfgs(name)
    jm = jax_build_model(jcfg)
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (2, S_PROMPT)).astype(np.int32)
    jl, jcache = prefill(jparams, jnp.asarray(toks), jm.init_cache(2, 48))
    want = [(toks, [np.asarray(x) for x in jl])]
    for step in range(3):
        nxt = np.array(jnp.argmax(jl[-1], -1), np.int32)[:, None]
        jl, jcache = decode(jparams, jnp.asarray(nxt),
                            jnp.int32(S_PROMPT + step), jcache)
        want.append((nxt, [np.asarray(x) for x in jl]))
    for use_kernels in (False, True):
        _, cfg = _cfgs(name, use_kernels=use_kernels)
        m = build_model(cfg, device="cpu")
        cache = m.init_cache(2, 48)
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
        np.testing.assert_array_equal(_np(cache["kpos"]),
                                      np.asarray(jcache["kpos"]))


@pytest.mark.parametrize("name", list(SHAPES))
def test_forward_train_logits_and_aux_match_reference(name):
    jparams, params = _weights(name)
    jcfg, cfg = _cfgs(name)
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jl, jaux = jax.jit(jax_build_model(jcfg).forward_train)(
        jparams, jnp.asarray(toks))
    tl, aux = build_model(cfg, device="cpu").forward_train(
        params, torch.from_numpy(toks))
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
    # three moe layers' aux summed (each E·Σ f p >= 1)
    assert float(aux) >= 3.0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_TOL)


def test_window_decode_past_the_ring_matches_reference():
    """Reduced mixtral keeps a window of 128: a 120-token prompt and 14
    decode steps run past t = 128, where the ring wraps."""
    jparams, params = _weights("mixtral")
    jcfg, cfg = _cfgs("mixtral")
    assert cfg.attn_window == 128
    jm, m = jax_build_model(jcfg), build_model(cfg, device="cpu")
    toks = np.random.default_rng(12).integers(
        0, cfg.vocab_size, (2, 120)).astype(np.int32)
    jcache, cache = jm.init_cache(2, 160), m.init_cache(2, 160)
    assert cache["kpos"].shape == (128,)
    decode = jax.jit(jm.decode_step)
    jl, jcache = jax.jit(jm.prefill)(jparams, jnp.asarray(toks), jcache)
    tl, cache = m.prefill(params, torch.from_numpy(toks), cache)
    for step in range(14):
        nxt = np.array(jnp.argmax(jl[-1], -1), np.int32)[:, None]
        np.testing.assert_array_equal(_np(torch.argmax(tl[-1], -1)),
                                      nxt[:, 0])
        jl, jcache = decode(jparams, jnp.asarray(nxt),
                            jnp.int32(120 + step), jcache)
        tl, cache = m.decode_step(params, torch.from_numpy(nxt),
                                  120 + step, cache)
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(_np(a), np.asarray(b),
                                       atol=LOGIT_TOL, rtol=LOGIT_TOL)
    np.testing.assert_array_equal(_np(cache["kpos"]),
                                  np.asarray(jcache["kpos"]))
    assert int(cache["kpos"].max()) == 133


# ---------------------------------------------------------------------------
# the staged decode: streams against the reference, the two-way dispatch
# ---------------------------------------------------------------------------

STEPS = 5
# the corners and a middle component-0 threshold (mid is filled in by the
# mid_threshold fixture)
THRESHOLDS = {"all_exit": (0.0, 0.0, 0.0), "full_depth": (1.1, 1.1, 0.0),
              "mid": None}


def _tokens(vocab):
    return np.random.default_rng(3).integers(0, vocab, (4, 6)).astype(
        np.int32)


def _jax_trace(jcfg, jparams):
    jm = jax_build_model(jcfg)
    ex = JaxExecutor(jm, jcfg)
    step = jax.jit(ex.decode_step)
    d, cache, state = jax.jit(ex.prefill)(jparams, jnp.asarray(_tokens(
        jcfg.vocab_size)), jm.init_cache(4, 32))
    outs = []
    for _ in range(STEPS):
        d, cache, state = step(jparams, d.prediction[:, None], cache, state)
        outs.append([np.asarray(x) for x in (d.prediction, d.exit_index,
                                             d.confidence)])
    return {"outs": outs, "segments_run": np.asarray(state.segments_run),
            "ema": np.asarray(state.ema_conf)}


def _port_trace(cfg, params):
    m = build_model(cfg, device="cpu")
    ex = StagedExecutor(m, cfg)
    d, cache, state = ex.prefill(params, torch.from_numpy(_tokens(
        cfg.vocab_size)), m.init_cache(4, 32))
    outs = []
    for _ in range(STEPS):
        d, cache, state = ex.decode_step(params, d.prediction[:, None],
                                         cache, state)
        outs.append([x.numpy().copy() for x in (d.prediction, d.exit_index,
                                                d.confidence)])
    return {"outs": outs, "segments_run": state.segments_run.copy(),
            "ema": state.ema_conf.numpy().copy(),
            "cache": [x.numpy().copy() for x in nn.tree_leaves(cache)],
            "dispatch": dict(ex.dispatch)}


@pytest.fixture(scope="module")
def mid_threshold():
    """A component-0 threshold between the two decode confidences that
    straddle the median of a one-cohort run at (0, 0, 0), both at least
    1e-4 from it."""
    _, params = _weights("mixtral")
    _, cfg = _cfgs("mixtral", cascade=dict(thresholds=(0.0, 0.0, 0.0)))
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
    """Tokens, exit indices and ``segments_run`` exactly against the
    reference's executor, for one cohort and for two in both layouts (the
    reference's major and copy layouts are identical by its own tests;
    its major trace is the one held here); the port's major and copy
    layouts bit for bit alike; no step of the port's major layout takes
    ``all_run``."""
    jparams, params = _weights("mixtral")
    cas = dict(exit_mode=mode, thresholds=_ths(case, mid_threshold),
               n_cohorts=cohorts, cohort_layout="major")
    jcfg, cfg = _cfgs("mixtral", use_kernels=True, cascade=cas)
    want = _jax_trace(jcfg.replace(use_kernels=False), jparams)
    runs = [_port_trace(cfg, params)]
    if cohorts == 2:
        runs.append(_port_trace(cfg.with_cascade(cohort_layout="copy"),
                                params))
    for got in runs:
        for (gt, ge, gc), (wt, we, wc) in zip(got["outs"], want["outs"]):
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_array_equal(ge, we)
            np.testing.assert_allclose(gc, wc, rtol=CONF_TOL, atol=CONF_TOL)
        np.testing.assert_array_equal(got["segments_run"],
                                      want["segments_run"])
        np.testing.assert_allclose(got["ema"], want["ema"], rtol=CONF_TOL,
                                   atol=CONF_TOL)
    if cohorts == 2:
        for a, b in zip(runs[0]["outs"], runs[1]["outs"]):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)
        for u, v in zip(runs[0]["cache"], runs[1]["cache"]):
            np.testing.assert_array_equal(u, v)
        d = runs[0]["dispatch"]
        assert d["all_run"] == 0 and sum(d.values()) == 2 * STEPS
        if mode == "select" or case != "all_exit":
            assert d["mixed"] > 0
        if mode == "cond_batch" and case == "all_exit":
            assert d["all_skip"] == 2 * STEPS
    exits = np.stack([o[1] for o in runs[0]["outs"]])
    if case == "all_exit":
        assert not exits.any()
    elif case == "full_depth":
        assert (exits == 2).all()
    else:
        assert set(np.unique(exits)) >= {0, 2}


@pytest.mark.parametrize("case", ["full_depth", "mid"])
def test_select_equals_cond_batch_with_cohorts(mid_threshold, case):
    """select and cond_batch route each cohort's rows as their own group:
    the same tokens, exits, confidences and cache bytes."""
    _, params = _weights("mixtral")
    runs = [_port_trace(_cfgs("mixtral", use_kernels=True, cascade=dict(
        exit_mode=mode, thresholds=_ths(case, mid_threshold),
        n_cohorts=2))[1], params) for mode in ("select", "cond_batch")]
    for a, b in zip(runs[0]["outs"], runs[1]["outs"]):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    for u, v in zip(runs[0]["cache"], runs[1]["cache"]):
        np.testing.assert_array_equal(u, v)


# ---------------------------------------------------------------------------
# runtimes, the paged layout, training, the CLI, MACs, the bridge
# ---------------------------------------------------------------------------

def _serve(cfg, params, runtime):
    eng = CascadeServingEngine(cfg, build_model(cfg, device="cpu"), params,
                               lane_batch=4, n_lanes=1, cache_len=32,
                               runtime=runtime, chunk=4, device="cpu")
    rng = np.random.default_rng(5)
    for i, n in enumerate((3, 5, 4, 6)):
        eng.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, 6).astype(np.int32), max_new_tokens=n))
    eng.run(100)
    return eng


@pytest.mark.parametrize("mode", ["cond_batch", "select"])
def test_device_runtime_matches_host_runtime(mid_threshold, mode):
    """The device runtime's decode loop (eager here; a captured graph
    with IF nodes on a card) serves what the host runtime serves, bit for
    bit, with 2 cohorts at the middle threshold; neither takes
    ``all_run``."""
    _, params = _weights("mixtral")
    _, cfg = _cfgs("mixtral", use_kernels=True, cascade=dict(
        exit_mode=mode, thresholds=(mid_threshold, 1.1, 0.0), n_cohorts=2))
    h, d = _serve(cfg, params, "host"), _serve(cfg, params, "device")
    assert h.finished.keys() == d.finished.keys() == set(range(4))
    for rid in h.finished:
        for key in ("tokens", "exit_depths", "confs"):
            assert h.finished[rid][key] == d.finished[rid][key], (rid, key)
    np.testing.assert_array_equal(
        sum(ln["state"].segments_run for ln in h.lanes),
        sum(ln["state"].segments_run for ln in d.lanes))
    for eng in (h, d):
        assert eng.stats()["cohort_dispatch"]["all_run"] == 0
        assert eng.stats()["cohort_dispatch"]["mixed"] > 0


def test_paged_moe_config_is_refused_with_reference_message():
    _, params = _weights("mixtral")
    jcfg, cfg = _cfgs("mixtral")
    jcfg = jcfg.with_paged_cache(layout="paged", block_size=8)
    cfg = cfg.with_paged_cache(layout="paged", block_size=8)
    with pytest.raises(ValueError) as jerr:
        JaxPagedCache(jax_build_model(jcfg), jcfg, lane_batch=2,
                      n_lanes=1, cache_len=32)
    with pytest.raises(ValueError) as err:
        PagedCascadeCache(build_model(cfg, device="cpu"), cfg,
                          lane_batch=2, n_lanes=1, cache_len=32)
    assert str(err.value) == str(jerr.value)
    assert "MoE" in str(err.value)
    with pytest.raises(ValueError, match="MoE"):
        CascadeServingEngine(cfg, build_model(cfg, device="cpu"), params,
                             lane_batch=2, n_lanes=1, cache_len=32,
                             device="cpu")


def test_train_steps_match_reference():
    """Three AdamW steps of ``make_train_step`` with the router's aux loss
    (``router_aux_coef`` 0.01) from the same weights: losses within 1e-4."""
    jparams, _ = _weights("qwen3")
    jcfg, cfg = _cfgs("qwen3")
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(13)
    batches = [rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_smoke(arch):
    stats = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--requests", "4", "--max-new", "4", "--cohorts",
                        "2"])
    assert stats["requests_finished"] == 4
    assert stats["cohort_dispatch"]["all_run"] == 0


@pytest.mark.parametrize("name", list(SHAPES))
def test_segment_macs_match_reference(name):
    jcfg, cfg = _cfgs(name)
    for kv in (1, 100, 300):
        assert macs.segment_macs_per_token(cfg, kv) == \
            jax_macs.segment_macs_per_token(jcfg, kv)
    full, jfull = get_config(SHAPES[name][0]), jax_get_config(
        SHAPES[name][0])
    assert macs.segment_macs_per_token(full, 4096) == \
        jax_macs.segment_macs_per_token(jfull, 4096)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_of_an_moe_tree_is_bit_exact(dtype):
    jcfg, cfg = _cfgs("qwen3-hd128")
    jcfg, cfg = jcfg.replace(dtype=dtype), cfg.replace(dtype=dtype)
    jparams = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(5))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tp = params_from_jax(np_params, cfg, device="cpu")
    leaf = tp["segments"][1][0]["moe"]
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    assert leaf["router"].shape == (1, d, E)
    assert leaf["w_gate"].shape == leaf["w_up"].shape == (1, E, d, ff)
    assert leaf["w_down"].shape == (1, E, ff, d)
    assert leaf["w_up"].dtype == getattr(torch, dtype)
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

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_shapes_and_finite(arch):
    cfg = reduced(get_config(arch))
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    logits, aux = model.forward_train(params, toks)
    assert len(logits) == cfg.cascade.n_components
    for lg in logits:
        assert lg.shape == (2, 16, cfg.vocab_size)
        assert bool(torch.isfinite(lg.float()).all())
    assert bool(torch.isfinite(aux)) and float(aux) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_decreases_loss_direction(arch):
    cfg = reduced(get_config(arch))
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


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_full_forward(arch):
    """At capacity factor 16 nothing drops, so a token's expert outputs do
    not depend on which tokens it is routed with."""
    cfg = reduced(get_config(arch)).replace(dtype="float32",
                                            capacity_factor=16.0)
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


def test_route_topk_runs_without_host_reads(monkeypatch):
    """No ``.item()``, ``nonzero`` or ``tolist`` in the MoE layer (a
    captured graph cannot read the device): each raises here while
    ``moe_apply`` runs."""
    def boom(*a, **kw):
        raise AssertionError("host read in moe_apply")

    for name in ("item", "tolist", "nonzero", "__bool__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, boom)
    _, stage, _, cfg = _moe_params("mixtral")
    tp = nn.tree_index(stage["moe"], 0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 1, cfg.d_model)).astype(np.float32))
    out, aux = moe.moe_apply(tp, cfg, x)
    monkeypatch.undo()
    assert out.shape == x.shape and math.isfinite(float(aux))
