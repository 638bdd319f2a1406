"""Names the JAX package exports and the port now has too: the package
inits of ``core``, ``serving`` and ``models``, ``softmax_confidence``,
``attend_chunked_2d`` with ``pick_attend``'s three-way choice, and the
tree, timer and size helpers of ``utils``.  Floats in f32 within
``ATTN_TOL`` (attention) and ``CONF_TOL`` (δ); everything else exact."""
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core
import repro.models
import repro.serving
import repro_torch.core
import repro_torch.models
import repro_torch.serving
from repro import utils as jutils
from repro.configs import get_config as jax_get_config
from repro.core.confidence import softmax_confidence as jax_softmax_confidence
from repro.models import layers as jlayers
from repro_torch import utils
from repro_torch.configs import get_config
from repro_torch.core.confidence import softmax_confidence, softmax_outputs
from repro_torch.models import layers

ATTN_TOL = 1e-5
CONF_TOL = 1e-5      # δ = exp(max - lse): the two packages' exp differ in ulps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers
    on a few cores, where these small ops gain nothing from more threads
    and would slow the other workers' timed tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the package inits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ref, port", [
    (repro.core, repro_torch.core), (repro.serving, repro_torch.serving),
    (repro.models, repro_torch.models)], ids=["core", "serving", "models"])
def test_package_exports_every_reference_name(ref, port):
    names = ref.__all__
    assert len(names) == {"repro.core": 33, "repro.serving": 5,
                          "repro.models": 2}[ref.__name__]
    missing = [n for n in names if getattr(port, n, None) is None]
    assert not missing, missing
    # the reference's names for a port function are the same objects the
    # port's modules define (the init re-exports, it does not wrap)
    for n in names:
        obj = getattr(port, n)
        if callable(obj) and hasattr(obj, "__module__"):
            assert obj.__module__.startswith(port.__name__), (n, obj)


# ---------------------------------------------------------------------------
# softmax_confidence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape, scale", [((4, 257), 3.0), ((2, 3, 33), 10.0),
                                          ((5,), 0.1)])
def test_softmax_confidence_matches_reference(shape, scale):
    x = (np.random.default_rng(0).standard_normal(shape) * scale).astype(
        np.float32)
    got = softmax_confidence(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:-1]
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_softmax_confidence(
                                   jnp.asarray(x))),
                               rtol=0, atol=CONF_TOL)
    assert torch.equal(got, softmax_outputs(torch.from_numpy(x))[1])


# ---------------------------------------------------------------------------
# attend_chunked_2d and pick_attend
# ---------------------------------------------------------------------------

def _qkv(Sq, Sk, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, Sq, 4, 16)).astype(np.float32),
            rng.standard_normal((2, Sk, 2, 16)).astype(np.float32),
            rng.standard_normal((2, Sk, 2, 16)).astype(np.float32))


# (Sq, Sk): 64 / 64 is whole chunks; Sk 50 pads the keys to a multiple of
# kchunk (kpos -1); Sq 56 is not a multiple of qchunk (the fallback)
@pytest.mark.parametrize("Sq, Sk", [(64, 64), (64, 50), (56, 56)],
                         ids=["whole", "pad", "fallback"])
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("causal_skip", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_attend_chunked_2d_matches_reference_and_full(Sq, Sk, window,
                                                      causal_skip, causal):
    q, k, v = _qkv(Sq, Sk)
    qpos, kpos = np.arange(Sq, dtype=np.int32), np.arange(Sk, dtype=np.int32)
    ref = np.asarray(jlayers.attend_chunked_2d(
        *map(jnp.asarray, (q, k, v, qpos, kpos)), window=window,
        causal=causal, qchunk=16, kchunk=32, causal_skip=causal_skip))
    t = [torch.from_numpy(a) for a in (q, k, v, qpos, kpos)]
    got = layers.attend_chunked_2d(*t, window=window, causal=causal,
                                   qchunk=16, kchunk=32,
                                   causal_skip=causal_skip)
    full = layers.attend_full(*t, window=window, causal=causal)
    assert got.shape == full.shape == (2, Sq, 4, 16)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATTN_TOL)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0,
                               atol=ATTN_TOL)


@pytest.mark.parametrize("window", [0, 24])
def test_attend_chunked_2d_bounds_equal_the_reference_formula(window):
    """At positions 0, 1, … the KV-chunk ranges read from qpos / kpos are
    the reference's formula's; the causal skip leaves out some chunks."""
    nq, qc, nk, kc = 4, 16, 2, 32
    pos = torch.arange(nq * qc, dtype=torch.int32)[None].expand(2, -1)
    read = layers._visible_chunks(pos, pos, nq, qc, nk, kc, window)
    want = [(max(j * qc - window + 1, 0) // kc if window else 0,
             ((j + 1) * qc - 1) // kc + 1) for j in range(nq)]
    assert read == want
    assert sum(hi - lo for lo, hi in read) < nq * nk


def test_attend_chunked_2d_at_offset_positions_matches_full():
    """Positions that do not start at 0 (a prefill at an offset): the
    chunk ranges come from the positions read once, and the result is the
    plain attention's."""
    q, k, v = _qkv(64, 64, seed=1)
    pos = torch.arange(100, 164, dtype=torch.int32)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    for window in (0, 24):
        full = layers.attend_full(*t, pos, pos, window=window)
        got = layers.attend_chunked_2d(*t, pos, pos, window=window,
                                       qchunk=16, kchunk=32)
        np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0,
                                   atol=ATTN_TOL)


@pytest.mark.parametrize("Sq, Sk", [(4096, 4096), (64, 2048), (64, 64)])
@pytest.mark.parametrize("differentiable", [False, True])
def test_pick_attend_makes_the_reference_choice(Sq, Sk, differentiable):
    cfg, jcfg = get_config("qwen2.5-3b"), jax_get_config("qwen2.5-3b")
    got = layers.pick_attend(cfg, Sq, Sk, differentiable=differentiable)
    want = jlayers.pick_attend(jcfg, Sq, Sk, differentiable=differentiable)

    def name(f):
        return (f.func if isinstance(f, functools.partial) else f).__name__

    def kw(f):
        return dict(f.keywords) if isinstance(f, functools.partial) else {}
    assert name(got) == name(want)
    assert kw(got) == kw(want)


# ---------------------------------------------------------------------------
# utils: tree sizes and casts, assert_finite, Timer, human sizes
# ---------------------------------------------------------------------------

def _trees():
    rng = np.random.default_rng(0)
    arrays = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "segs": [{"k": np.arange(6, dtype=np.int32),
                        "b": rng.standard_normal((2,)).astype(np.float16)}],
              "n": np.array(7, dtype=np.int32)}

    def conv(tree, fn):
        if isinstance(tree, dict):
            return {k: conv(v, fn) for k, v in tree.items()}
        if isinstance(tree, list):
            return [conv(v, fn) for v in tree]
        return fn(tree)
    return conv(arrays, torch.from_numpy), conv(arrays, jnp.asarray)


def test_tree_bytes_and_cast_match_reference():
    tree, jtree = _trees()
    assert utils.tree_bytes(tree) == jutils.tree_bytes(jtree) == 48 + 24 + 4 \
        + 4
    for name in ("bfloat16", "float32", "float16"):
        got = utils.tree_cast(tree, name)
        want = jutils.tree_cast(jtree, jutils.DTYPES[name])
        got_dt = {utils.path_str(p): str(x.dtype).replace("torch.", "")
                  for p, x in utils.tree_flatten_with_path(got)}
        want_dt = {jutils.path_str(p): str(x.dtype) for p, x in
                   jax.tree_util.tree_leaves_with_path(want)}
        assert got_dt == want_dt
        assert utils.tree_bytes(got) == jutils.tree_bytes(want)
    # a torch dtype is taken as well as a name; ints are never cast
    got = utils.tree_cast(tree, torch.bfloat16)
    assert got["segs"][0]["k"].dtype == torch.int32
    assert torch.equal(got["segs"][0]["k"], tree["segs"][0]["k"])


def test_assert_finite_names_the_leaf_as_the_reference_does():
    tree, jtree = _trees()
    utils.assert_finite(tree)
    jutils.assert_finite(jtree)
    tree["segs"][0]["b"][1] = float("nan")
    jtree["segs"][0]["b"] = jtree["segs"][0]["b"].at[1].set(jnp.nan)
    with pytest.raises(AssertionError) as got:
        utils.assert_finite(tree, "params")
    with pytest.raises(AssertionError) as want:
        jutils.assert_finite(jtree, "params")
    assert "non-finite values in params at" in str(got.value)
    assert "segs" in str(got.value) and "b" in str(got.value)
    assert str(want.value).startswith("non-finite values in params at")
    tree["segs"][0]["b"][1] = float("inf")
    with pytest.raises(AssertionError):
        utils.assert_finite(tree)


def test_timer_measures_the_block():
    with utils.Timer() as t, jutils.Timer() as jt:
        time.sleep(0.01)
    assert 0.01 <= t.elapsed < 5 and 0.01 <= jt.elapsed < 5
    assert utils.Timer().elapsed == jutils.Timer().elapsed == 0.0


@pytest.mark.parametrize("n", [0, 1, 999, 1000, 1023, 1024, 1536, 3.5e6,
                               2 ** 40, 7.1e15, 3e18, -2048])
def test_human_sizes_match_reference(n):
    assert utils.human_bytes(n) == jutils.human_bytes(n)
    assert utils.human_count(n) == jutils.human_count(n)
