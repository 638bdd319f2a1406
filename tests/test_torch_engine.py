"""The slice as a whole: the port's CascadeServingEngine against the JAX
package's, on bridged weights and the same requests.

Settings: ``reduced(qwen2.5-3b, n_layers=3)``, 3 components (boundaries
after layers 1 and 2), f32, kernels on, ``cond_batch``, 2 lanes of 2 slots,
cache_len 256.  Six requests for four slots: the first four prompts are
128 tokens long, so every lane's first prefill runs flash attention; the
last two (37 and 100 tokens) wait, and the lane that frees first
re-prefills at an S that takes the plain attention route.

Token streams, exit streams and ``segments_run`` must be identical;
confidences agree to 1e-5 (f32 sums in other orders).  The mixed threshold
vector lies at least 1e-3 away from every confidence either run computes,
so no exit decision sits on a rounding edge — asserted first.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import CascadeServingEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.core import policy
from repro_torch.kernels.ref import ref_confidence
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


CONF_TOL = 1e-5
MARGIN = 1e-3
PROMPT_LENS = (128, 128, 128, 128, 37, 100)
MIXED = (0.0365, 0.0375, 0.0)
ENGINE_KW = dict(lane_batch=2, n_lanes=2, cache_len=256)


def _cascade(ths, mode="cond_batch"):
    return dict(n_components=3, exit_boundaries=(1, 2), thresholds=ths,
                exit_mode=mode)


def _requests(make):
    rng = np.random.default_rng(11)
    return [make(i, rng.integers(0, 512, size=n).astype(np.int32), 6)
            for i, n in enumerate(PROMPT_LENS)]


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_reduced(jax_get_config("qwen2.5-3b"), n_layers=3) \
        .with_cascade(**_cascade((0.9, 0.9, 0.0)))
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = reduced(get_config("qwen2.5-3b"), n_layers=3).with_cascade(
        **_cascade((0.9, 0.9, 0.0)))
    return jparams, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")


def _run_port(params, ths, use_kernels=True, mode="cond_batch", spy=None):
    cfg = reduced(get_config("qwen2.5-3b"), n_layers=3).replace(
        use_kernels=use_kernels).with_cascade(**_cascade(ths, mode))
    eng = CascadeServingEngine(cfg, build_model(cfg, device="cpu"), params,
                               device="cpu", **ENGINE_KW)
    for r in _requests(lambda i, p, n: Request(rid=i, prompt=p,
                                               max_new_tokens=n)):
        eng.submit(r)
    return eng.run(max_ticks=500), eng.stats()


def _run_jax(jparams, ths):
    cfg = jax_reduced(jax_get_config("qwen2.5-3b"), n_layers=3).replace(
        use_kernels=True).with_cascade(**_cascade(ths))
    eng = JaxEngine(cfg, jax_build_model(cfg), jparams, **ENGINE_KW)
    for r in _requests(lambda i, p, n: JaxRequest(rid=i, prompt=p,
                                                  max_new_tokens=n)):
        eng.submit(r)
    return eng.run(max_ticks=500), eng.stats()


@pytest.mark.parametrize("ths", [(0.0, 0.0, 0.0), (1.1, 1.1, 0.0), MIXED],
                         ids=["all-exit-0", "full-depth", "mixed"])
def test_engine_streams_match_reference(weights, monkeypatch, ths):
    jparams, params = weights
    seen = []   # every component confidence the port's decision scan saw
    scan = policy.ExitDecider.scan_logits

    def spy(self, m, n, logits, *a, **kw):
        seen.append((m, ref_confidence(logits)[1].numpy().copy()))
        return scan(self, m, n, logits, *a, **kw)

    monkeypatch.setattr(policy.ExitDecider, "scan_logits", spy)
    want, want_stats = _run_jax(jparams, ths)
    got, got_stats = _run_port(params, ths)
    if ths == MIXED:
        for r in want.values():
            for m, c in zip(r["exit_depths"], r["confs"]):
                if m < 2:
                    assert abs(c - ths[m]) >= MARGIN, (m, c)
        for m, conf in seen:
            if m < 2:
                assert np.min(np.abs(conf - ths[m])) >= MARGIN, m
        depths = {d for r in want.values() for d in r["exit_depths"]}
        assert depths == {0, 1, 2}
    assert sorted(got) == sorted(want) == list(range(len(PROMPT_LENS)))
    for rid in want:
        assert got[rid]["tokens"] == want[rid]["tokens"], rid
        assert got[rid]["exit_depths"] == want[rid]["exit_depths"], rid
        assert got[rid]["lane"] == want[rid]["lane"], rid
        np.testing.assert_allclose(got[rid]["confs"], want[rid]["confs"],
                                   atol=CONF_TOL, rtol=CONF_TOL)
    assert got_stats["segments_run"] == want_stats["segments_run"]
    assert got_stats["exit_histogram"] == want_stats["exit_histogram"]
    assert got_stats["analytic_speedup"] == pytest.approx(
        want_stats["analytic_speedup"], rel=1e-12)
    if ths == (0.0, 0.0, 0.0):
        assert got_stats["segments_run"][1:] == [0, 0]
    # the flash route ran on the first prefills, the plain one after
    assert got_stats["prefills"] == 3


@pytest.mark.parametrize("ths", [(0.0, 0.0, 0.0), MIXED])
def test_engine_select_matches_cond_batch(weights, ths):
    _, params = weights
    sel, sel_stats = _run_port(params, ths, mode="select")
    cb, cb_stats = _run_port(params, ths, mode="cond_batch")
    assert sel == cb
    assert sel_stats["segments_run"] == [14, 14, 14]
    assert all(c <= s for c, s in zip(cb_stats["segments_run"],
                                      sel_stats["segments_run"]))
    assert cb_stats["host_syncs"] > sel_stats["host_syncs"]


@pytest.mark.parametrize("ths", [(0.0, 0.0, 0.0), MIXED])
def test_engine_kernels_on_matches_off_on_integers(weights, ths):
    _, params = weights
    on, on_stats = _run_port(params, ths, use_kernels=True)
    off, off_stats = _run_port(params, ths, use_kernels=False)
    for rid in on:
        assert on[rid]["tokens"] == off[rid]["tokens"]
        assert on[rid]["exit_depths"] == off[rid]["exit_depths"]
    assert on_stats["segments_run"] == off_stats["segments_run"]
    prov = on_stats["provenance"]
    assert prov["device"] == "cpu"
    assert {k["backend"] for k in prov["kernels"].values()} == {"torch-cpu"}
    assert off_stats["provenance"]["kernels"]["rmsnorm"]["backend"] == "off"
