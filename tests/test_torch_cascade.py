"""Algorithm 1 (``cascade_infer_sequential``), the evaluation harness
(``cascade_evaluate``) and the serving engine with the exit-head
megakernel and cohort scatter on — the port against the JAX package.

Specs: ``tests/test_cascade.py``, ``tests/test_policy.py:221-240`` and
``tests/test_exit_kernels.py:447-483``.  Inputs are made with numpy and
handed to both packages.  Predictions, exit fractions, token and exit
streams and ``segments_run`` exactly; confidences within 1e-5 relative (the
fused kernels and the plain measure sum in other orders); accuracy, MACs
and speedup to 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import cascade as jcascade
from repro.core.policy import ExitDecider as JaxDecider
from repro.models.model import build_model as jax_build_model
from repro.serving import CascadeServingEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.core import cascade
from repro_torch.core.confidence import softmax_outputs
from repro_torch.core.policy import ExitDecider
from repro_torch.kernels import ops
from repro_torch.models.model import build_model
from repro_torch.serving.engine import CascadeServingEngine, Request

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers
    on a few cores, where these small ops gain nothing from more threads
    and would slow the other workers' timed tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fns(outputs, framework):
    """Components returning fixed logits whatever the input."""
    conv = jnp.asarray if framework == "jax" else torch.as_tensor
    return [lambda x, state, _lg=conv(np.asarray(lg, np.float32)):
            (_lg, state) for lg in outputs]


def _both(outputs, ths, use_kernels):
    """(port, reference) results of Algorithm 1 on the same logits."""
    B = np.asarray(outputs[0]).shape[0]
    got = cascade.cascade_infer_sequential(
        _fns(outputs, "torch"), ths, torch.zeros(B, 4),
        ExitDecider("softmax_max", use_kernels=use_kernels))
    want = jcascade.cascade_infer_sequential(
        _fns(outputs, "jax"), ths, jnp.zeros((B, 4)),
        JaxDecider("softmax_max", use_kernels=use_kernels))
    return got, want


def _check(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=TOL, atol=1e-7)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_sequential_early_exit_takes_first_confident(use_kernels):
    got, want = _both([[[10.0, 0.0]], [[0.0, 10.0]], [[0.0, 10.0]]],
                      (0.9, 0.9, 0.0), use_kernels)
    _check(got, want)
    assert int(got[0][0]) == 0


@pytest.mark.parametrize("use_kernels", [False, True])
def test_sequential_falls_through_to_last(use_kernels):
    got, want = _both([[[0.1, 0.0]], [[0.0, 0.2]], [[0.0, 10.0]]],
                      (0.9, 0.9, 0.0), use_kernels)
    _check(got, want)
    assert int(got[0][0]) == 1


@pytest.mark.parametrize("use_kernels", [False, True])
def test_sequential_inference_is_batch_uniform(use_kernels):
    """A component answers only when ALL samples clear its threshold."""
    c0 = [[10.0, 0.0], [0.1, 0.0]]                 # sample 1 unsure
    c1 = [[0.0, 10.0], [0.0, 10.0]]                # all confident
    c2 = [[5.0, 0.0], [5.0, 0.0]]
    got, want = _both([c0, c1, c2], (0.9, 0.9, 0.0), use_kernels)
    _check(got, want)
    np.testing.assert_array_equal(got[0].numpy(), [1, 1])
    _, d1 = softmax_outputs(torch.tensor(c1))
    np.testing.assert_allclose(got[1].numpy(), d1.numpy(), rtol=1e-6)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("use_kernels", [False, True])
def test_sequential_matches_reference_on_random_logits(seed, use_kernels):
    rng = np.random.default_rng(seed)
    scale = (1.0, 3.0, 6.0)
    outputs = [rng.standard_normal((3, 700)) * s for s in scale]
    for ths in ((0.01, 0.02, 0.0), (0.5, 0.5, 0.0), (0.0, 0.9, 0.0)):
        _check(*_both(outputs, ths, use_kernels))


def test_sequential_with_kernels_routes_through_confidence_kernel(
        monkeypatch):
    """With ``use_kernels`` every component's measure is the fused
    confidence kernel's wrapper; without, it is never called."""
    calls = []
    fused = ops.softmax_confidence_fused

    def spy(logits):
        calls.append(tuple(logits.shape))
        return fused(logits)

    monkeypatch.setattr(ops, "softmax_confidence_fused", spy)
    rng = np.random.default_rng(5)
    outputs = [rng.standard_normal((2, 300)) for _ in range(3)]
    for use_kernels, want in ((True, [(2, 300)] * 3), (False, [])):
        calls.clear()
        cascade.cascade_infer_sequential(
            _fns(outputs, "torch"), (0.5, 0.5, 0.0), torch.zeros(2, 4),
            ExitDecider("softmax_max", use_kernels=use_kernels))
        assert calls == want


def test_patience_measure_takes_its_base_kernel(monkeypatch):
    dec = ExitDecider("patience@2", use_kernels=True)
    x = torch.randn(2, 50)
    got = dec.measure_one(x)
    want = softmax_outputs(x)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=TOL, atol=0)
    assert dec.measure.fused_kernel(x[None]) is None   # 2-D only


# ---------------------------------------------------------------------------
# the evaluation harness
# ---------------------------------------------------------------------------

def test_cascade_evaluate_exit_accounting():
    N = 6
    labels = np.array([0, 0, 0, 1, 1, 1])
    conf = [np.array([.95, .2, .2, .95, .2, .2]),
            np.array([.0, .9, .1, .0, .9, .1]),
            np.ones(N)]
    preds = [np.array([0, 1, 1, 1, 0, 0]),
             np.array([1, 0, 0, 0, 1, 1]),
             labels.copy()]
    res = cascade.cascade_evaluate(conf, preds, labels, [1.0, 2.0, 3.0],
                                   (0.9, 0.8, 0.0))
    np.testing.assert_allclose(res.exit_fractions, [2 / 6, 2 / 6, 2 / 6])
    assert res.accuracy == 1.0
    assert res.avg_macs == (2 * 1 + 2 * 2 + 2 * 3) / 6
    assert res.speedup == pytest.approx(3.0 / 2.0)
    assert res.thresholds == (0.9, 0.8, 0.0)


def test_cascade_evaluate_forces_last_threshold_zero():
    N = 4
    labels = np.zeros(N, np.int64)
    conf = [np.array([.95, .1, .1, .1]), np.array([.1, .95, .1, .1]),
            np.full(N, 0.5)]
    res = cascade.cascade_evaluate(conf, [labels.copy()] * 3, labels,
                                   [1.0, 2.0, 3.0], (0.9, 0.9, 0.9))
    np.testing.assert_allclose(res.exit_fractions, [1 / 4, 1 / 4, 2 / 4])


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("use_kernels", [False, True])
def test_cascade_evaluate_matches_reference(seed, use_kernels):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(30, 200))
    labels = rng.integers(0, 5, n)
    confs = [rng.random(n) for _ in range(3)]
    preds = [rng.integers(0, 5, n) for _ in range(2)] + [labels.copy()]
    macs = [1.0, 2.0, 3.0]
    for ths in ((0.9, 0.9, 0.0), (0.5, 0.3, 0.7), (0.0, 0.0, 0.0)):
        got = cascade.cascade_evaluate(
            confs, preds, labels, macs, ths,
            ExitDecider("softmax_max", use_kernels=use_kernels))
        want = jcascade.cascade_evaluate(confs, preds, labels, macs, ths)
        np.testing.assert_array_equal(got.exit_fractions,
                                      want.exit_fractions)
        for key in ("accuracy", "avg_macs", "speedup"):
            assert getattr(got, key) == pytest.approx(getattr(want, key),
                                                      rel=1e-12)
        assert got.thresholds == want.thresholds


def test_exit_indices_refuses_stateful_measures():
    with pytest.raises(NotImplementedError):
        ExitDecider("patience@2").exit_indices([np.ones(3)] * 2, (0.5, 0.0))


# ---------------------------------------------------------------------------
# the engine with the megakernel and cohort scatter on
# ---------------------------------------------------------------------------

CASCADE = dict(thresholds=(0.6, 0.0), confidence="patience@2",
               exit_mode="cond_batch", n_cohorts=2)
ENGINE_KW = dict(lane_batch=2, n_lanes=2, cache_len=32)


def _requests(make):
    rng = np.random.default_rng(3)
    return [make(i, rng.integers(1, 50, size=rng.integers(2, 7))
                 .astype(np.int32), 4) for i in range(4)]


@pytest.fixture(scope="module")
def eng_weights():
    jcfg = jax_reduced(jax_get_config("qwen2.5-3b")).replace(dtype="float32")
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = reduced(get_config("qwen2.5-3b")).replace(dtype="float32")
    return jparams, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")


def _port_engine(params, megakernel, layout="major", mode="cond_batch"):
    cfg = reduced(get_config("qwen2.5-3b")).replace(
        dtype="float32", use_kernels=True).with_cascade(
        **{**CASCADE, "cohort_layout": layout, "exit_mode": mode})
    if megakernel:
        cfg = cfg.with_kernel_tune(megakernel=True, cohort_scatter=True)
    eng = CascadeServingEngine(cfg, build_model(cfg, device="cpu"), params,
                               device="cpu", **ENGINE_KW)
    assert eng.executor.use_megakernel == megakernel
    for r in _requests(lambda i, p, n: Request(rid=i, prompt=p,
                                               max_new_tokens=n)):
        eng.submit(r)
    return eng.run(max_ticks=200), eng.stats()


@pytest.fixture(scope="module")
def jax_engine_run(eng_weights):
    jparams, _ = eng_weights
    cfg = jax_reduced(jax_get_config("qwen2.5-3b")).replace(
        dtype="float32", use_kernels=True,
        kernel_interpret=True).with_cascade(**CASCADE).with_kernel_tune(
        megakernel=True, cohort_scatter=True)
    eng = JaxEngine(cfg, jax_build_model(cfg), jparams, **ENGINE_KW)
    for r in _requests(lambda i, p, n: JaxRequest(rid=i, prompt=p,
                                                  max_new_tokens=n)):
        eng.submit(r)
    return eng.run(max_ticks=200), eng.stats()


@pytest.mark.parametrize("layout,mode", [("major", "cond_batch"),
                                         ("copy", "cond_batch"),
                                         ("major", "select")])
def test_megakernel_engine_streams_match_reference(eng_weights,
                                                   jax_engine_run, layout,
                                                   mode):
    _, params = eng_weights
    want, want_stats = jax_engine_run
    on, on_stats = _port_engine(params, True, layout, mode)
    off, _ = _port_engine(params, False, layout, mode)
    assert set(on) == set(off) == set(want) == {0, 1, 2, 3}
    for rid in want:
        assert on[rid]["tokens"] == want[rid]["tokens"], rid
        assert on[rid]["exit_depths"] == want[rid]["exit_depths"], rid
        np.testing.assert_allclose(on[rid]["confs"], want[rid]["confs"],
                                   rtol=TOL, atol=TOL)
        assert on[rid]["tokens"] == off[rid]["tokens"], rid
        assert on[rid]["exit_depths"] == off[rid]["exit_depths"], rid
    if mode == "cond_batch":
        assert on_stats["segments_run"] == want_stats["segments_run"]
    assert on_stats["n_cohorts"] == want_stats["n_cohorts"] == 2
    assert on_stats["cohort_layout"] == layout
    assert sum(on_stats["cohort_dispatch"].values()) > 0 or layout == "copy"
    kernels = on_stats["provenance"]["kernels"]
    assert {"confidence", "megakernel", "cohort_scatter"} <= set(kernels)
    assert kernels["megakernel"]["backend"] == "torch-cpu"
