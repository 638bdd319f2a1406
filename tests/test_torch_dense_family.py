"""The dense family whole: deepseek-coder-33b's and minitron-4b's shapes,
layernorm, learned absolute positions, tied embeddings and
``CascadeModel.decode`` — the port against the JAX package on bridged
weights, plus the port's own contracts (kernels on ≡ off on integers, the
megakernel left for heads it cannot read).

Configs: ``reduced(...)`` at 3 layers and 3 components (exits after layers
1 and 2), f32, with the heads put back to keep each model's GQA group:
deepseek-coder-33b's 7 (14 / 2 heads of 32), minitron-4b's 3 (6 / 2 of
32).  The variants are ``reduced(qwen2.5-3b)`` with ``norm="layernorm"``,
``rope_theta=0`` (learned positions) and ``tie_embeddings=True``, each
alone and all together.  The routes d 7168 takes on the card (rmsnorm's
``block`` route, the megakernel's ``tc`` route with its prologue in the
block route's order) exist only there: ``chip_smoke.py`` phase 2 holds
them against their plain versions.

Tolerances: exit logits 1e-4 absolute and relative (three layers of f32
matmuls summed in other orders, as ``tests/test_torch_model.py``);
confidences and EMAs 1e-5 (f32 softmax sums in other orders, as
``tests/test_torch_exec.py``); tokens, exit indices and ``segments_run``
exactly; within the port (kernels on against off, on the CPU the kernels'
plain versions) bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core.exec import StagedExecutor as JaxExecutor
from repro.models.model import build_model as jax_build_model
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_config, reduced
from repro_torch.core.exec import StagedExecutor
from repro_torch.kernels import ops
from repro_torch.models import nn
from repro_torch.models.model import build_model
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


LOGIT_TOL = 1e-4
CONF_TOL = 1e-5

# name -> (arch, overrides of the reduced config)
SHAPES = {
    "deepseek-gqa7": ("deepseek-coder-33b",
                      dict(n_heads=14, n_kv_heads=2, head_dim=32)),
    "minitron-gqa3": ("minitron-4b",
                      dict(n_heads=6, n_kv_heads=2, head_dim=32)),
    "layernorm": ("qwen2.5-3b", dict(norm="layernorm")),
    "learned-positions": ("qwen2.5-3b", dict(rope_theta=0.0)),
    "tied": ("qwen2.5-3b", dict(tie_embeddings=True)),
    "all-three": ("qwen2.5-3b", dict(norm="layernorm", rope_theta=0.0,
                                     tie_embeddings=True)),
}
VARIANTS = ("layernorm", "learned-positions", "tied", "all-three")


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
        jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
        _WEIGHTS[name] = (jparams, params_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu"))
    return _WEIGHTS[name]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------------------------------
# the configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-coder-33b", "minitron-4b"])
def test_config_copy_equals_reference_field_by_field(arch):
    ours, ref = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.segments == ref.segments
    assert dataclasses.asdict(reduced(ours)) == dataclasses.asdict(
        jax_reduced(ref))


@pytest.mark.parametrize("arch,group,d,vocab", [
    ("deepseek-coder-33b", 7, 7168, 32256),
    ("minitron-4b", 3, 3072, 256000)])
def test_full_width_configs_build(arch, group, d, vocab):
    """The published widths build (no weights drawn here: the card's
    phases draw them) and their caches have the published shapes: 254 KB
    of bf16 KV a position at deepseek-coder-33b's 62 layers."""
    cfg = get_config(arch)
    assert (cfg.q_per_kv, cfg.d_model, cfg.vocab_size) == (group, d, vocab)
    model = build_model(cfg, device="cpu")
    assert sum(n for runs in model.segment_runs for _, n in runs) \
        == cfg.n_layers
    cache = model.init_cache(4, 512, device="meta")
    leaves = list(nn.tree_leaves(cache["segments"]))
    per_pos = sum(x.numel() * x.element_size() for x in leaves) // (4 * 512)
    assert per_pos == cfg.n_layers * 2 * cfg.n_kv_heads \
        * cfg.resolved_head_dim * 2
    if arch == "deepseek-coder-33b":
        assert per_pos == 253952


# ---------------------------------------------------------------------------
# prefill and dense decode steps
# ---------------------------------------------------------------------------

_JAX_STEPS = {}
S_PROMPT = 20


def _jax_steps(name):
    """The reference's prefill logits and 4 dense decode steps' logits,
    its greedy tokens fed back (once per config): [(tokens fed, logits)]."""
    if name not in _JAX_STEPS:
        jparams, _ = _weights(name)
        jcfg, _ = _cfgs(name)
        jm = jax_build_model(jcfg)
        toks = np.random.default_rng(7).integers(
            0, jcfg.vocab_size, (2, S_PROMPT)).astype(np.int32)
        jl, jcache = jm.prefill(jparams, jnp.asarray(toks),
                                jm.init_cache(2, 48))
        out = [(toks, [np.asarray(x) for x in jl])]
        for step in range(4):
            nxt = np.array(jnp.argmax(jl[-1], -1), np.int32)[:, None]
            jl, jcache = jm.decode_step(jparams, jnp.asarray(nxt),
                                        S_PROMPT + step, jcache)
            out.append((nxt, [np.asarray(x) for x in jl]))
        _JAX_STEPS[name] = (out, np.asarray(jcache["kpos"]))
    return _JAX_STEPS[name]


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("name", list(SHAPES))
def test_prefill_and_decode_steps_match_reference(name, use_kernels):
    """Prefill logits of every exit and 4 dense decode steps past the
    prompt (the learned positions read rows S..S+3), the reference's greedy
    tokens fed back; the reference runs its plain path (its kernels'
    parity is its own tests'), the port kernels on and off."""
    _, params = _weights(name)
    _, cfg = _cfgs(name, use_kernels=use_kernels)
    m = build_model(cfg, device="cpu")
    steps, kpos = _jax_steps(name)
    cache = m.init_cache(2, 48)
    for step, (toks, want) in enumerate(steps):
        if step == 0:
            tl, cache = m.prefill(params, torch.from_numpy(toks), cache)
        else:
            # the port's greedy token is the reference's
            np.testing.assert_array_equal(_np(torch.argmax(tl[-1], -1)),
                                          toks[:, 0])
            tl, cache = m.decode_step(params, torch.from_numpy(toks),
                                      S_PROMPT + step - 1, cache)
        for a, b in zip(tl, want):
            np.testing.assert_allclose(_np(a), b, atol=LOGIT_TOL,
                                       rtol=LOGIT_TOL)
    np.testing.assert_array_equal(_np(cache["kpos"]), kpos)


def test_learned_positions_past_the_table_read_its_last_row():
    """A position past ``max_seq_len`` reads the table's last row, as the
    reference's clamped gather does."""
    jparams, params = _weights("learned-positions")
    jcfg, cfg = _cfgs("learned-positions")
    jm, m = jax_build_model(jcfg), build_model(cfg, device="cpu")
    L = cfg.max_seq_len
    pos = np.array([L - 2, L - 1, L, L + 7], np.int32)
    tok = np.array([[3, 4, 5, 6]], np.int32)
    want = jm._embed(jparams, jnp.asarray(tok), jnp.asarray(pos))
    got = m._embed(params, torch.from_numpy(tok), torch.from_numpy(pos))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# ---------------------------------------------------------------------------
# CascadeModel.decode, the staged step
# ---------------------------------------------------------------------------

def _drive(prefill, decode, params, toks, n_steps, cache):
    d, cache, state = prefill(params, toks, cache)
    out = {"tok": [_np(d.prediction)], "exit": [_np(d.exit_index)],
           "conf": [_np(d.confidence)]}
    for _ in range(n_steps):
        d, cache, state = decode(params, d.prediction[:, None], cache,
                                 state)
        out["tok"].append(_np(d.prediction))
        out["exit"].append(_np(d.exit_index))
        out["conf"].append(_np(d.confidence))
    out = {k: np.array(v) for k, v in out.items()}
    out["segments_run"] = _np(state.segments_run)
    out["ema"] = _np(state.ema_conf)
    return out


def _toks(cfg):
    return np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)


def _port_staged(name, mode, use_kernels, ths):
    _, params = _weights(name)
    _, cfg = _cfgs(name, use_kernels=use_kernels,
                   cascade=dict(exit_mode=mode, thresholds=ths))
    m = build_model(cfg, device="cpu")
    got = _drive(StagedExecutor(m, cfg).prefill, m.decode, params,
                 torch.from_numpy(_toks(cfg)), 4, m.init_cache(2, 32))
    return got, m


@pytest.mark.parametrize("mode,ths", [
    ("cond_batch", (0.0, 0.0, 0.0)), ("cond_batch", (1.1, 1.1, 0.0)),
    ("select", (0.0, 0.0, 0.0))])
@pytest.mark.parametrize("name", ["deepseek-gqa7", "minitron-gqa3",
                                  "all-three"])
def test_decode_matches_reference(name, mode, ths):
    """``CascadeModel.decode`` against the reference's ``decode`` (its
    cached executor) at the corners: every token exits at component 0
    (cond_batch skips the deep segments, select computes and masks them)
    or at the last."""
    jparams, _ = _weights(name)
    jcfg, _ = _cfgs(name, cascade=dict(exit_mode=mode, thresholds=ths))
    jm = jax_build_model(jcfg)
    want = _drive(JaxExecutor(jm, jcfg).prefill, jm.decode, jparams,
                  jnp.asarray(_toks(jcfg)), 4, jm.init_cache(2, 32))
    got, m = _port_staged(name, mode, False, ths)
    for key in ("tok", "exit", "segments_run"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("conf", "ema"):
        np.testing.assert_allclose(got[key], want[key], atol=CONF_TOL,
                                   rtol=CONF_TOL, err_msg=key)
    # the executor is built once and kept
    ex = m._staged_executor
    m.decode(_weights(name)[1], torch.zeros((2, 1), dtype=torch.int32),
             m.init_cache(2, 32), ex.init_state(2))
    assert m._staged_executor is ex
    if ths[0] == 0.0 and mode == "cond_batch":
        # the 4 decode steps ran segment 0 only
        assert got["segments_run"].tolist() == [4, 0, 0]


@pytest.mark.parametrize("name", VARIANTS)
def test_decode_kernels_on_equals_off(name):
    """Kernels on (the plain versions on the CPU) and off give the same
    streams and confidences bit for bit."""
    on, _ = _port_staged(name, "cond_batch", True, (0.0, 0.0, 0.0))
    off, _ = _port_staged(name, "cond_batch", False, (0.0, 0.0, 0.0))
    for key in on:
        np.testing.assert_array_equal(on[key], off[key], err_msg=key)


# ---------------------------------------------------------------------------
# the megakernel and heads it cannot read
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,fused", [
    ("deepseek-gqa7", (True, True, True)),
    ("layernorm", (False, False, False)),
    ("tied", (False, False, False)),
    ("learned-positions", (True, True, True))])
def test_exit_head_params_leave_bias_and_tied_heads(name, fused):
    """A layernorm bias or a tied head (``embed.T``, a transposed view the
    megakernel does not read) gives None: the executor falls back to
    ``exit_logits`` + the exit-update kernel; no head is copied."""
    _, params = _weights(name)
    _, cfg = _cfgs(name)
    m = build_model(cfg, device="cpu")
    got = tuple(m.exit_head_params(params, k) is not None for k in range(3))
    assert got == fused
    if cfg.tie_embeddings:
        assert "lm_head" not in params
        head = m._unembed(params)
        assert head.data_ptr() == params["embed"].data_ptr()


def _engine_run(name, megakernel, monkeypatch):
    _, params = _weights(name)
    _, cfg = _cfgs(name, use_kernels=True, cascade=dict(
        thresholds=(0.0, 0.0, 0.0), exit_mode="cond_batch", n_cohorts=2))
    if megakernel:
        cfg = cfg.with_kernel_tune(megakernel=True)
    calls = []
    real = ops.exit_head_fused
    monkeypatch.setattr(ops, "exit_head_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    eng = CascadeServingEngine(cfg, build_model(cfg, device="cpu"), params,
                               lane_batch=2, n_lanes=1, cache_len=48,
                               device="cpu")
    rng = np.random.default_rng(3)
    for i in range(4):
        eng.submit(Request(rid=i, prompt=rng.integers(
            1, 50, size=4 + i).astype(np.int32), max_new_tokens=4))
    out = eng.run(max_ticks=200)
    return out, len(calls)


@pytest.mark.parametrize("name", ["deepseek-gqa7", *VARIANTS])
def test_engine_megakernel_leaves_bias_and_tied_heads(name, monkeypatch):
    """Through the engine with 2 cohorts, kernels and the megakernel on:
    no megakernel call for a layernorm or tied head, and the streams equal
    the megakernel-off run's."""
    on, n_on = _engine_run(name, True, monkeypatch)
    off, n_off = _engine_run(name, False, monkeypatch)
    _, cfg = _cfgs(name)
    assert n_off == 0
    if cfg.norm == "layernorm" or cfg.tie_embeddings:
        assert n_on == 0
    else:
        assert n_on > 0
    assert set(on) == set(off) == {0, 1, 2, 3}
    for rid in on:
        assert on[rid]["tokens"] == off[rid]["tokens"], rid
        assert on[rid]["exit_depths"] == off[rid]["exit_depths"], rid


# ---------------------------------------------------------------------------
# initialisation and the bridge
# ---------------------------------------------------------------------------

def test_stack_init_values_unchanged_at_a_fixed_seed():
    """The stacked leaves filled layer by layer equal a stack of ``n``
    layer trees drawn in order from the same generator."""
    cfg = reduced(get_config("qwen2.5-3b"))
    from repro_torch.models.blocks import BLOCKS
    block = BLOCKS["dense"]

    def layer(g):
        return nn.tree_map(lambda x: x.to(torch.bfloat16),
                           block.init(g, cfg))

    got = nn.stack_init(layer, torch.Generator().manual_seed(5), 4)
    g = torch.Generator().manual_seed(5)
    trees = [layer(g) for _ in range(4)]

    def stack(ts):
        if isinstance(ts[0], dict):
            return {k: stack([t[k] for t in ts]) for k in ts[0]}
        return torch.stack(ts)
    want = stack(trees)
    leaves = list(nn.tree_leaves(got))
    assert leaves and all(x.dtype == torch.bfloat16 for x in leaves)
    for a, b in zip(leaves, nn.tree_leaves(want)):
        assert torch.equal(a, b)


def test_model_init_draws_are_unchanged():
    """The model's init at a fixed seed equals the same draws stacked in
    one piece (the former ``torch.stack`` of a list of layers)."""
    cfg = reduced(get_config("qwen2.5-3b"), n_layers=3).with_cascade(
        n_components=3, exit_boundaries=(1, 2))
    m = build_model(cfg, device="cpu")
    p1, p2 = m.init(11), m.init(11)
    for a, b in zip(nn.tree_leaves(p1), nn.tree_leaves(p2)):
        assert torch.equal(a, b)
    # one generator drawn in the same order, layer by layer
    g = torch.Generator().manual_seed(11)
    from repro_torch.models.blocks import BLOCKS
    embed = nn.embed_init(g, (cfg.vocab_size, cfg.d_model),
                          m.param_dtype)
    assert torch.equal(embed, p1["embed"])
    first = nn.tree_map(lambda x: x.to(m.param_dtype),
                        BLOCKS["dense"].init(g, cfg))
    for a, b in zip(nn.tree_leaves(first),
                    nn.tree_leaves(nn.tree_index(p1["segments"][0][0], 0))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", VARIANTS)
def test_bridge_round_trip_carries_the_variants(name):
    """``pos_embed``, the norms' ``"b"`` and a missing ``lm_head`` cross
    both ways bit for bit; the port's own init has the same tree."""
    jparams, params = _weights(name)
    back = params_to_numpy(params)
    want = jax.tree_util.tree_map(np.asarray, jparams)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    _, cfg = _cfgs(name)
    own = build_model(cfg, device="cpu").init(0)
    assert jax.tree_util.tree_structure(params_to_numpy(own)) == \
        jax.tree_util.tree_structure(want)
    assert ("pos_embed" in params) == (cfg.rope_theta <= 0)
    assert ("lm_head" in params) == (not cfg.tie_embeddings)
    assert ("b" in params["final_norm"]) == (cfg.norm == "layernorm")
