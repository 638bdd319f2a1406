"""The port's dense CascadeModel against the JAX package's on bridged
weights: prefill logits of every exit and dense decode steps.

Config: ``reduced(qwen2.5-3b, n_layers=3)`` with 3 components split after
layers 1 and 2, f32.  Tolerances: exit logits 1e-4 absolute and relative
(three layers of f32 matmuls summed in other orders); greedy tokens
exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models.model import build_model as jax_build_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
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


LOGIT_TOL = 1e-4


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


@pytest.mark.parametrize("S,use_kernels", [(128, True), (128, False),
                                           (37, False)])
def test_prefill_and_decode_steps_match_reference(weights, use_kernels, S):
    """Prefill logits of every exit (S = 128 takes the flash route with
    kernels on, S = 37 the plain attention) and 4 dense decode steps, whose
    ring writes and masks run past the prompt."""
    jparams, params = weights
    jcfg, cfg = _cfgs(use_kernels=use_kernels)
    jm, m = jax_build_model(jcfg), build_model(cfg, device="cpu")
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    jcache, cache = jm.init_cache(2, 160), m.init_cache(2, 160)
    jl, jcache = jm.prefill(jparams, jnp.asarray(toks), jcache)
    tl, cache = m.prefill(params, torch.from_numpy(toks), cache)
    np.testing.assert_array_equal(_np(cache["kpos"]), _np(jcache["kpos"]))
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(_np(a), _np(b), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
    for step in range(4):
        nxt = np.asarray(jnp.argmax(jl[-1], -1), np.int32)
        np.testing.assert_array_equal(_np(torch.argmax(tl[-1], -1)), nxt)
        t = S + step
        jl, jcache = jm.decode_step(jparams, jnp.asarray(nxt[:, None]), t,
                                    jcache)
        tl, cache = m.decode_step(
            params, torch.from_numpy(nxt[:, None].copy()), t, cache)
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(_np(a), _np(b), atol=LOGIT_TOL,
                                       rtol=LOGIT_TOL)
    np.testing.assert_array_equal(_np(cache["kpos"]), _np(jcache["kpos"]))
    for jseg, seg in zip(jcache["segments"], cache["segments"]):
        for jst, st in zip(jseg, seg):
            for name in ("k", "v"):
                np.testing.assert_allclose(_np(st[name]), _np(jst[name]),
                                           atol=LOGIT_TOL, rtol=LOGIT_TOL)
