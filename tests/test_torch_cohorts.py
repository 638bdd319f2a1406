"""Cohort-split staged execution (``n_cohorts=2``) in the port against the
JAX package's, plus the port's own contracts: ``major`` ≡ ``copy``,
megakernel on ≡ off, ``select`` ≡ ``cond_batch`` — the spec is
``tests/test_exit_kernels.py:294-483``.

Config: ``reduced(qwen2.5-3b, n_layers=3)``, f32, 3 components split after
layers 1 and 2, a lane of 4 slots in 2 cohorts; weights bridged from the
JAX package.  Kernels are on (their plain versions on the CPU), with the
exit-head megakernel and the cohort scatter.  The three dispatch branches:
all cohorts skip at thresholds (0, 0, 0), all run at (1.1, 1.1, 0), and
mixed — through the even-argmax measure the reference test registers
(registered here in both packages' registries), and through softmax-max
at a threshold picked between observed component-0 confidences, which the
megakernel route takes.

Tolerances: confidences, EMAs and cache floats 1e-5 against the reference
(f32 sums in other orders); token, exit-index and ``segments_run`` streams
exactly.  Within the port, bit for bit on every live row (all rows are
live here).  The mixed softmax threshold lies at least 1e-4 away from
every component-0 confidence either run computes (asserted), so no exit
decision sits on a rounding edge.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import policy as jpolicy
from repro.core.exec import StagedExecutor as JaxExecutor
from repro.models.model import build_model as jax_build_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.core import policy
from repro_torch.core.exec import StagedExecutor
from repro_torch.kernels import ref
from repro_torch.models import nn
from repro_torch.models.model import build_model

TOL = 1e-5
MARGIN = 1e-4
STEPS = 6
PARITY = "torch_cohorts_parity"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers
    on a few cores, where these small ops gain nothing from more threads
    and would slow the other workers' timed tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@jpolicy.register_measure(PARITY)
class _JaxParity(jpolicy.ConfidenceMeasure):
    """Confident iff the argmax token is even (mixed-difficulty traffic)."""

    name = PARITY

    def __init__(self, arg: str = ""):
        del arg

    def __call__(self, logits):
        out = jnp.argmax(logits, axis=-1)
        return out, (out % 2 == 0).astype(jnp.float32)


@policy.register_measure(PARITY)
class _Parity(policy.ConfidenceMeasure):
    name = PARITY

    def __init__(self, arg: str = ""):
        del arg

    def __call__(self, logits):
        out = torch.argmax(logits, dim=-1).to(torch.int32)
        return out, (out % 2 == 0).float()


def _cfgs(**cascade):
    cas = dict(n_components=3, exit_boundaries=(1, 2), n_cohorts=2)
    cas.update(cascade)
    jcfg = jax_reduced(jax_get_config("qwen2.5-3b"), n_layers=3).replace(
        dtype="float32").with_cascade(**cas)
    cfg = reduced(get_config("qwen2.5-3b"), n_layers=3).replace(
        dtype="float32").with_cascade(**cas)
    return jcfg, cfg


def _on(cfg, megakernel=True, scatter=True):
    return cfg.replace(use_kernels=True).with_kernel_tune(
        megakernel=megakernel, cohort_scatter=scatter)


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = _cfgs()
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return jparams, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")


def _tokens(vocab):
    return np.random.default_rng(3).integers(0, vocab, (4, 6)).astype(
        np.int32)


def _jax_trace(jcfg, jparams):
    model = jax_build_model(jcfg)
    ex = JaxExecutor(model, jcfg)
    step = jax.jit(ex.decode_step)
    d, cache, state = ex.prefill(jparams, jnp.asarray(_tokens(
        jcfg.vocab_size)), model.init_cache(4, 32))
    outs = []
    for _ in range(STEPS):
        d, cache, state = step(jparams, d.prediction[:, None], cache, state)
        outs.append([np.asarray(x) for x in (d.prediction, d.exit_index,
                                             d.confidence)])
    return {"outs": outs, "segments_run": np.asarray(state.segments_run),
            "ema": np.asarray(state.ema_conf),
            "cache": [np.asarray(x) for x in jax.tree_util.tree_leaves(
                cache)]}


def _port_trace(cfg, params, spy=None):
    model = build_model(cfg, device="cpu")
    ex = StagedExecutor(model, cfg)
    d, cache, state = ex.prefill(params, torch.from_numpy(_tokens(
        cfg.vocab_size)), model.init_cache(4, 32))
    outs = []
    for _ in range(STEPS):
        d, cache, state = ex.decode_step(params, d.prediction[:, None],
                                         cache, state)
        outs.append([x.numpy().copy() for x in (d.prediction, d.exit_index,
                                                d.confidence)])
    return {"outs": outs, "segments_run": state.segments_run.copy(),
            "ema": state.ema_conf.numpy().copy(),
            "streak": (None if state.policy is None
                       else state.policy.numpy().copy()),
            "cache": [x.numpy().copy() for x in nn.tree_leaves(cache)],
            "dispatch": dict(ex.dispatch), "host_syncs": ex.host_syncs,
            "executor": ex}


def _seen_conf0(monkeypatch):
    """Record the component-0 confidences the port's unfused scan sees
    (the megakernel route's are the same bits on the CPU)."""
    seen = []
    scan = policy.ExitDecider.scan_logits

    def spy(self, m, n, logits, *a, **kw):
        if m == 0:
            seen.append(ref.ref_confidence(logits)[1].numpy().copy())
        return scan(self, m, n, logits, *a, **kw)

    monkeypatch.setattr(policy.ExitDecider, "scan_logits", spy)
    return seen


@pytest.fixture(scope="module")
def mixed_threshold(weights):
    """A component-0 softmax threshold at the median of the (0, 0, 0)
    run's decode confidences (every token answers at component 0 there):
    the midpoint of the two sorted values that straddle it."""
    _, params = weights
    _, cfg = _cfgs(thresholds=(0.0, 0.0, 0.0), exit_mode="cond_batch")
    run = _port_trace(cfg.replace(use_kernels=True), params)
    c = np.sort(np.concatenate([o[2] for o in run["outs"]]))
    return float((c[len(c) // 2 - 1] + c[len(c) // 2]) / 2)


CASES = {
    "all_skip": ("softmax_max", lambda th: (0.0, 0.0, 0.0)),
    "all_run": ("softmax_max", lambda th: (1.1, 1.1, 0.0)),
    "mixed_parity": (PARITY, lambda th: (0.5, 0.5, 0.0)),
    "mixed_softmax": ("softmax_max", lambda th: (th, 1.1, 0.0)),
}


def _case_cfgs(case, th, **cascade):
    measure, ths = CASES[case]
    return _cfgs(confidence=measure, thresholds=ths(th), **cascade)


def _assert_same(a, b, keys=("outs", "segments_run", "ema", "streak",
                             "cache")):
    for key in keys:
        if key == "outs":
            for x, y in zip(a["outs"], b["outs"]):
                for u, v in zip(x, y):
                    np.testing.assert_array_equal(u, v)
        elif a[key] is None:
            assert b[key] is None
        elif key == "cache":
            for u, v in zip(a["cache"], b["cache"]):
                np.testing.assert_array_equal(u, v)
        else:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", ["cond_batch", "select"])
@pytest.mark.parametrize("layout", ["major", "copy"])
def test_cohort_executor_matches_reference(weights, mixed_threshold,
                                           monkeypatch, layout, mode, case):
    jparams, params = weights
    jcfg, cfg = _case_cfgs(case, mixed_threshold, exit_mode=mode,
                           cohort_layout=layout)
    jcfg, cfg = _on(jcfg), _on(cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    want = _jax_trace(jcfg, jparams)
    got = _port_trace(cfg, params)
    assert got["executor"].use_megakernel == (case != "mixed_parity")
    for (gt, ge, gc), (wt, we, wc) in zip(got["outs"], want["outs"]):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(ge, we)
        np.testing.assert_allclose(gc, wc, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got["segments_run"], want["segments_run"])
    np.testing.assert_allclose(got["ema"], want["ema"], rtol=TOL, atol=TOL)
    assert len(got["cache"]) == len(want["cache"])
    for g, w in zip(got["cache"], want["cache"]):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    exits = np.stack([o[1] for o in got["outs"]])
    seg = list(got["segments_run"])
    full = [2 * STEPS] * 3
    if case == "all_skip":
        assert seg == ([2 * STEPS, 0, 0] if mode == "cond_batch" else full)
        assert not exits.any()
    elif case == "all_run":
        assert seg == full and (exits == 2).all()
    else:
        assert set(np.unique(exits)) >= {0, 2}
    if mode == "cond_batch":
        # one host read of the stacked skip predicates per deep segment
        assert got["host_syncs"] == 2 * STEPS
    if layout == "major":
        d = got["dispatch"]
        assert sum(d.values()) == 2 * STEPS
        if mode == "select":
            assert d["mixed"] == 2 * STEPS
        elif case == "all_skip":
            assert d["all_skip"] == 2 * STEPS
        elif case == "all_run":
            assert d["all_run"] == 2 * STEPS
        else:
            assert d["mixed"] > 0, d
    if case == "mixed_softmax":
        # no component-0 decision sat on a rounding edge in either package
        seen = _seen_conf0(monkeypatch)
        _port_trace(cfg.with_kernel_tune(megakernel=False), params)
        jseen = np.concatenate([o[2][o[1] == 0] for o in want["outs"]])
        for conf in seen + [jseen]:
            assert np.min(np.abs(conf - mixed_threshold)) >= MARGIN


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", ["cond_batch", "select"])
def test_major_matches_copy_bit_for_bit(weights, mixed_threshold, mode,
                                        case):
    """Tokens, exit indices, confidences, EMA, streaks and every cache byte
    are identical between the two layouts."""
    _, params = weights
    _, cfg = _case_cfgs(case, mixed_threshold, exit_mode=mode)
    runs = [_port_trace(_on(cfg.with_cascade(cohort_layout=lay)), params)
            for lay in ("major", "copy")]
    _assert_same(*runs)


@pytest.mark.parametrize("case", ["all_skip", "all_run", "mixed_softmax"])
@pytest.mark.parametrize("mode", ["cond_batch", "select"])
def test_megakernel_on_matches_off_bit_for_bit(weights, mixed_threshold,
                                               mode, case):
    _, params = weights
    _, cfg = _case_cfgs(case, mixed_threshold, exit_mode=mode)
    on = _port_trace(_on(cfg, megakernel=True), params)
    off = _port_trace(_on(cfg, megakernel=False), params)
    assert on["executor"].use_megakernel
    assert not off["executor"].use_megakernel
    _assert_same(on, off)


@pytest.mark.parametrize("case", ["mixed_parity", "mixed_softmax"])
def test_select_cohort_scatter_lands_rows_like_copy(weights, mixed_threshold,
                                                    monkeypatch, case):
    """In select mode the cohort scatter lands each cohort's selected cache
    rows (one call per cohort per deep segment); streams and cache bytes
    equal the per-leaf copy and cond_batch, which needs no re-join."""
    _, params = weights
    _, cfg = _case_cfgs(case, mixed_threshold)
    calls = []
    from repro_torch.kernels import ops
    scatter = ops.cohort_scatter_tree

    def spy(dst, src, c, C, slot=None):
        # select mode lands each cohort's ring-slot rows in the slab
        assert slot is not None and slot.dim() == 0
        assert all(d.shape[2] > 1 and s.shape[2] == 1
                   for d, s in zip(dst, src))
        calls.append((c, C, len(src)))
        return scatter(dst, src, c, C, slot=slot)

    monkeypatch.setattr(ops, "cohort_scatter_tree", spy)
    runs = {}
    for mode, on in (("select", True), ("select", False),
                     ("cond_batch", True)):
        calls.clear()
        runs[mode, on] = _port_trace(
            _on(cfg.with_cascade(exit_mode=mode), scatter=on), params)
        if mode == "select" and on:
            assert calls == [(c, 2, 2) for _ in range(2 * STEPS)
                             for c in range(2)]
        else:
            assert calls == []
    _assert_same(runs["select", True], runs["select", False])
    _assert_same(runs["select", True], runs["cond_batch", True],
                 keys=("outs", "ema", "streak", "cache"))
    assert runs["cond_batch", True]["dispatch"]["mixed"] > 0
