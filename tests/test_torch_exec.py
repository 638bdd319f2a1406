"""The port's staged executor against the JAX package's on bridged
weights, plus the port's own equivalence contracts (``select`` ≡
``cond_batch``, kernels on ≡ kernels off on integers) — the spec is
``tests/test_exec.py``.

Config: ``reduced(qwen2.5-3b, n_layers=3)`` with 3 components split after
layers 1 and 2, f32.  Tolerances: confidences and EMAs 1e-5 against the
reference (f32 sums in other orders); token, exit-index, streak and
``segments_run`` streams exactly; within the port, bit for bit.
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
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.core.exec import StagedExecutor
from repro_torch.models.model import build_model


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


def _cfgs(**kw):
    cas = dict(n_components=3, exit_boundaries=(1, 2))
    cas.update(kw.pop("cascade", {}))
    jcfg = jax_reduced(jax_get_config("qwen2.5-3b"), n_layers=3) \
        .with_cascade(**cas).replace(**kw)
    cfg = reduced(get_config("qwen2.5-3b"), n_layers=3) \
        .with_cascade(**cas).replace(**kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = _cfgs()
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return jparams, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _drive(executor, params, toks, n_steps, init_cache):
    d, cache, state = executor.prefill(params, toks, init_cache)
    out = {"tok": [_np(d.prediction)], "exit": [_np(d.exit_index)],
           "conf": [_np(d.confidence)]}
    for _ in range(n_steps):
        tok = d.prediction[:, None]
        d, cache, state = executor.decode_step(params, tok, cache, state)
        out["tok"].append(_np(d.prediction))
        out["exit"].append(_np(d.exit_index))
        out["conf"].append(_np(d.confidence))
    out = {k: np.array(v) for k, v in out.items()}
    out["segments_run"] = _np(state.segments_run)
    out["ema"] = _np(state.ema_conf)
    out["streak"] = None if state.policy is None else _np(state.policy)
    return out, cache


@pytest.mark.parametrize("use_kernels,measure,ths", [
    (False, "softmax_max", (0.0, 0.0, 0.0)),
    (False, "softmax_max", (1.1, 1.1, 0.0)),
    (False, "patience@2", (0.0, 0.0, 0.0)),
    (True, "patience@2", (0.0, 0.0, 0.0)),
])
def test_staged_executor_matches_reference(weights, use_kernels, measure,
                                           ths):
    jparams, params = weights
    jcfg, cfg = _cfgs(use_kernels=use_kernels, cascade=dict(
        exit_mode="cond_batch", thresholds=ths, confidence=measure))
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jm, m = jax_build_model(jcfg), build_model(cfg, device="cpu")
    want, _ = _drive(JaxExecutor(jm, jcfg), jparams, jnp.asarray(toks), 4,
                     jm.init_cache(2, 32))
    got, _ = _drive(StagedExecutor(m, cfg), params, torch.from_numpy(toks),
                    4, m.init_cache(2, 32))
    for key in ("tok", "exit", "segments_run", "streak"):
        if want[key] is None:
            assert got[key] is None
            continue
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("conf", "ema"):
        np.testing.assert_allclose(got[key], want[key], atol=CONF_TOL,
                                   rtol=CONF_TOL, err_msg=key)
    if ths[0] == 0.0 and measure == "softmax_max":
        assert list(got["segments_run"]) == [4, 0, 0]


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("measure", ["softmax_max", "patience@2"])
@pytest.mark.parametrize("ths", [(0.0, 0.0, 0.0), (1.1, 1.1, 0.0),
                                 (0.0035, 0.0, 0.0)])
def test_select_matches_cond_batch_bit_for_bit(weights, use_kernels,
                                               measure, ths):
    """``exit_mode`` picks an execution strategy, never a semantics: tokens,
    exits, confidences, the carried state and the caches are identical;
    cond_batch skips where select computes."""
    _, params = weights
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, 512, (3, 10)).astype(np.int32))
    runs = {}
    for mode in ("select", "cond_batch"):
        _, cfg = _cfgs(use_kernels=use_kernels, cascade=dict(
            exit_mode=mode, thresholds=ths, confidence=measure))
        m = build_model(cfg, device="cpu")
        runs[mode] = _drive(StagedExecutor(m, cfg), params, toks, 5,
                            m.init_cache(3, 32))
    (sel, sel_cache), (cb, cb_cache) = runs["select"], runs["cond_batch"]
    for key in ("tok", "exit", "conf", "ema", "streak"):
        if sel[key] is None:
            assert cb[key] is None
            continue
        np.testing.assert_array_equal(sel[key], cb[key], err_msg=key)
    for a, b in zip(jax.tree_util.tree_leaves(sel_cache),
                    jax.tree_util.tree_leaves(cb_cache)):
        assert torch.equal(a, b)
    assert list(sel["segments_run"]) == [5, 5, 5]
    assert all(cb["segments_run"] <= sel["segments_run"])
    if ths == (0.0, 0.0, 0.0) and measure == "softmax_max":
        assert list(cb["segments_run"]) == [5, 0, 0]


@pytest.mark.parametrize("ths", [(0.0, 0.0, 0.0), (1.1, 1.1, 0.0)])
def test_kernels_on_matches_off_on_integers(weights, ths):
    _, params = weights
    rng = np.random.default_rng(10)
    toks = torch.from_numpy(rng.integers(0, 512, (2, 128)).astype(np.int32))
    runs = {}
    for use_kernels in (True, False):
        _, cfg = _cfgs(use_kernels=use_kernels, cascade=dict(
            exit_mode="cond_batch", thresholds=ths))
        m = build_model(cfg, device="cpu")
        runs[use_kernels], _ = _drive(StagedExecutor(m, cfg), params, toks, 4,
                                      m.init_cache(2, 160))
    for key in ("tok", "exit", "segments_run"):
        np.testing.assert_array_equal(runs[True][key], runs[False][key])
