"""The port's examples (``examples/*_torch.py``) against the JAX package's
(``examples/*.py``) at their reduced sizes, with the reference's weights
carried across by ``repro_torch.bridge``.

Tolerances: training losses within ``STEP_TOL`` (relative, as
``test_torch_training.py`` holds a train step); held-out δ within
``DELTA_TOL`` absolute after 20 steps; the quickstart's δ within
``CONF_TOL``; the port's calibration and evaluation fed the reference's
δ, predictions and labels give the reference's thresholds, accuracy,
speedup and exit fractions exactly; every int (tokens, exit indices,
segments_run, histograms) exactly.
"""
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core.cascade import cascade_evaluate as jax_cascade_evaluate
from repro.core.confidence import softmax_outputs as jax_softmax_outputs
from repro.core.exec import StagedExecutor as JaxStagedExecutor
from repro.core.macs import segment_macs_per_token as jax_macs
from repro.core.policy import ExitDecider as JaxExitDecider
from repro.core.policy import get_calibrator as jax_get_calibrator
from repro.data.lm_pipeline import SyntheticLMStream as JaxStream
from repro.launch import steps as jsteps
from repro.models.model import build_model as jax_build_model
from repro.serving import CascadeServingEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.data.lm_pipeline import SyntheticLMStream
from repro_torch.models import build_model

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
STEP_TOL = 1e-4
DELTA_TOL = 1e-4
CONF_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers
    on a few cores, where these small ops gain nothing from more threads
    and would slow the other workers' timed tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_example", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bridged(jcfg, cfg):
    """The reference's seed-0 weights, and the same weights in the port."""
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, params_from_jax(np_params, cfg, device="cpu")


# ---------------------------------------------------------------------------
# train_llm_cascade: train, held-out δ, calibrate and evaluate
# ---------------------------------------------------------------------------

TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 20, 4, 32


def _reference_train(jcfg, jparams):
    """The reference example's training loop and held-out collection."""
    model = jax_build_model(jcfg)
    opt = jsteps.make_optimizer(jcfg)
    opt_state = opt.init(jparams)
    step_fn = jax.jit(jsteps.make_train_step(model, jcfg, opt))
    stream = JaxStream(jcfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                       easy_frac=0.7, seed=0)
    losses = []
    for step, (toks, labels) in zip(range(TRAIN_STEPS), stream):
        batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
        jparams, opt_state, loss = step_fn(jparams, opt_state,
                                           jnp.asarray(step), batch)
        losses.append(float(loss))
    fwd = jax.jit(lambda p, t: model.forward_train(p, t)[0])
    n_ex = jcfg.cascade.n_components
    confs, preds, labels_all = [[] for _ in range(n_ex)], \
        [[] for _ in range(n_ex)], []
    for _ in range(4):
        toks, labels = next(stream)
        logits = fwd(jparams, jnp.asarray(toks))
        for m in range(n_ex):
            out, delta = jax_softmax_outputs(logits[m])
            confs[m].append(np.asarray(delta).reshape(-1))
            preds[m].append(np.asarray(out).reshape(-1))
        labels_all.append(labels.reshape(-1))
    return (losses, [np.concatenate(c) for c in confs],
            [np.concatenate(p) for p in preds], np.concatenate(labels_all))


@pytest.fixture(scope="module")
def trained():
    ex = _example("train_llm_cascade_torch")
    overrides = dict(dtype="float32", vocab_size=256)
    jcfg = jax_reduced(jax_get_config("qwen2.5-3b")).replace(**overrides)
    cfg = reduced(get_config("qwen2.5-3b")).replace(**overrides)
    jparams, params = _bridged(jcfg, cfg)
    ref = _reference_train(jcfg, jparams)
    model = build_model(cfg, device="cpu")
    stream = SyntheticLMStream(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                               easy_frac=0.7, seed=0)
    params, losses, _ = ex.train(model, cfg, params, stream, TRAIN_STEPS,
                                 "cpu")
    got = ex.held_out(model, params, stream, "cpu")
    return ex, jcfg, cfg, ref, (losses, *got)


def test_trained_example_losses_match_reference(trained):
    _, _, _, ref, got = trained
    np.testing.assert_allclose(got[0], ref[0], rtol=STEP_TOL)
    assert got[0][-1] < got[0][0]


def test_trained_example_held_out_delta_matches_reference(trained):
    _, _, _, (_, jconfs, _, jy), (_, confs, _, y) = trained
    np.testing.assert_array_equal(y, jy)
    assert len(confs) == len(jconfs) == 2
    for c, jc in zip(confs, jconfs):
        assert c.shape == jc.shape == (4 * TRAIN_BATCH * TRAIN_SEQ,)
        np.testing.assert_allclose(c, jc, rtol=0, atol=DELTA_TOL)


def _reference_sweep(jcfg, confs, preds, y):
    """The reference example's calibration loop on the same arrays."""
    corrects = [(p == y).astype(float) for p in preds]
    n_cal = len(y) // 2
    mac_prefix = jax_macs(jcfg, kv_len=TRAIN_SEQ)
    rows = []
    for rule in ("self", "final"):
        calibrator = jax_get_calibrator(rule)
        for eps in (0.0, 0.01, 0.05, 0.1, 0.2):
            cal = calibrator.calibrate([c[:n_cal] for c in confs],
                                       [c[:n_cal] for c in corrects], eps)
            res = jax_cascade_evaluate([c[n_cal:] for c in confs],
                                       [p[n_cal:] for p in preds], y[n_cal:],
                                       mac_prefix, cal.thresholds)
            rows.append({"rule": rule, "eps": eps,
                         "thresholds": [float(t) for t in cal.thresholds],
                         "accuracy": float(res.accuracy),
                         "speedup": float(res.speedup),
                         "exit_fractions": [float(f) for f in
                                            res.exit_fractions]})
    return [float(np.mean(c)) for c in corrects], rows


def test_trained_example_calibration_equals_reference_on_its_deltas(trained):
    ex, jcfg, cfg, (_, jconfs, jpreds, jy), _ = trained
    per_exit, rows = ex.calibrate_sweep(cfg, jconfs, jpreds, jy, TRAIN_SEQ)
    want_exit, want = _reference_sweep(jcfg, jconfs, jpreds, jy)
    assert per_exit == want_exit
    assert len(rows) == len(want) == 10
    assert rows == want


# ---------------------------------------------------------------------------
# serve_cascade: the threshold sweep through the engine
# ---------------------------------------------------------------------------

SERVE_REQUESTS, SERVE_NEW = 10, 8


def test_serve_example_matches_reference_at_every_threshold():
    ex = _example("serve_cascade_torch")
    jbase = jax_reduced(jax_get_config("qwen2.5-3b")).replace(
        dtype="float32")
    base = reduced(get_config("qwen2.5-3b")).replace(dtype="float32")
    jparams, params = _bridged(jbase, base)
    rows = ex.sweep(base, build_model(base, device="cpu"), params, "cpu",
                    SERVE_REQUESTS, SERVE_NEW)
    jmodel = jax_build_model(jbase)
    rng = np.random.default_rng(0)
    assert len(rows) == len(ex.THRESHOLDS) == 5
    for th, st in zip(ex.THRESHOLDS, rows):
        cfg = jbase.with_cascade(thresholds=(th, 0.0), exit_mode="select")
        eng = JaxEngine(cfg, jmodel, jparams, lane_batch=2, n_lanes=2,
                        cache_len=48)
        for i in range(SERVE_REQUESTS):
            eng.submit(JaxRequest(
                rid=i, prompt=rng.integers(0, cfg.vocab_size, 8).astype(
                    np.int32), max_new_tokens=SERVE_NEW))
        eng.run(400)
        want = eng.stats()
        assert list(st["exit_histogram"]) == list(want["exit_histogram"])
        assert sum(st["exit_histogram"]) == SERVE_REQUESTS * SERVE_NEW
        assert st["mean_exit_depth"] == pytest.approx(
            want["mean_exit_depth"], abs=1e-12)
        assert st["analytic_speedup"] == pytest.approx(
            want["analytic_speedup"], rel=1e-12)


# ---------------------------------------------------------------------------
# quickstart: forward δ, prefill + decode decisions, staged decode, measures
# ---------------------------------------------------------------------------

def _reference_quickstart(cfg, model, params):
    """Parts 1–4 of the reference example, returning what it prints."""
    rng = np.random.default_rng(0)
    toks = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 12)), jnp.int32)
    out = {}
    logits, _ = model.forward_train(params, toks, None)
    out["forward_conf"] = [np.asarray(jax_softmax_outputs(lg[:, -1])[1])
                           for lg in logits]
    decider = JaxExitDecider.from_config(cfg)
    cache = model.init_cache(2, 32)
    exit_logits, cache = model.prefill(params, toks, cache, None)
    out["prefill"] = []
    for thresholds in [(0.9, 0.0), (0.0, 0.0)]:
        d = decider.decide(exit_logits, thresholds=thresholds)
        tok = d.prediction
        out["prefill"].append((np.asarray(tok), np.asarray(d.exit_index)))
    step_logits, cache = model.decode_step(params, tok[:, None],
                                           toks.shape[1], cache, None)
    d2 = decider.decide(step_logits, thresholds=(0.5, 0.0))
    out["decode"] = (np.asarray(d2.prediction), np.asarray(d2.exit_index))
    ex = JaxStagedExecutor(model, cfg.with_cascade(exit_mode="cond_batch",
                                                   thresholds=(0.0, 0.0)))
    cache2 = model.init_cache(2, 32)
    d, cache2, state = ex.prefill(params, toks, cache2, None)
    for _ in range(3):
        d, cache2, state = ex.decode_step(params, d.prediction[:, None],
                                          cache2, state, None)
    out["staged"] = (np.asarray(d.prediction), np.asarray(d.exit_index),
                     np.asarray(state.segments_run))
    out["measures"] = {}
    for measure in ("entropy", "margin"):
        d3 = JaxExitDecider(measure, thresholds=(0.5, 0.0)).decide(
            exit_logits)
        out["measures"][measure] = (np.asarray(d3.prediction),
                                    np.asarray(d3.exit_index),
                                    np.asarray(d3.confidence))
    return out


def test_quickstart_example_matches_reference():
    ex = _example("quickstart_torch")
    jcfg = jax_reduced(jax_get_config("qwen2.5-3b"))
    cfg = reduced(get_config("qwen2.5-3b"))
    jparams, params = _bridged(jcfg, cfg)
    want = _reference_quickstart(jcfg, jax_build_model(jcfg), jparams)
    got = ex.run(cfg, build_model(cfg, device="cpu"), params, "cpu")
    for c, jc in zip(got["forward_conf"], want["forward_conf"]):
        np.testing.assert_allclose(c, jc, rtol=0, atol=CONF_TOL)
    for part in ("prefill", "decode", "staged"):
        flat = got[part] if part != "prefill" else sum(got[part], ())
        wflat = want[part] if part != "prefill" else sum(want[part], ())
        for a, b in zip(flat, wflat, strict=True):
            np.testing.assert_array_equal(a.astype(np.int64),
                                          b.astype(np.int64))
    for measure, (pred, idx, conf) in got["measures"].items():
        wpred, widx, wconf = want["measures"][measure]
        np.testing.assert_array_equal(pred.astype(np.int64),
                                      wpred.astype(np.int64))
        np.testing.assert_array_equal(idx.astype(np.int64),
                                      widx.astype(np.int64))
        np.testing.assert_allclose(conf, wconf, rtol=0, atol=CONF_TOL)


# ---------------------------------------------------------------------------
# paper_reproduction: end to end at the smallest size, the reference's JSON
# ---------------------------------------------------------------------------

def test_paper_reproduction_example_writes_the_reference_json(tmp_path):
    ex = _example("paper_reproduction_torch")
    out = tmp_path / "repro_torch.json"
    ex.main(["--n-blocks", "1", "--epochs", "1", "--train-size", "256",
             "--device", "cpu", "--out", str(out)])
    res = json.loads(out.read_text())
    # the keys of the reference example's json.dump, and their lengths
    assert set(res) == {"component_acc", "sweep", "linearity", "n_blocks",
                        "epochs", "classes"}
    assert (res["n_blocks"], res["epochs"], res["classes"]) == (1, 1, 10)
    assert len(res["component_acc"]) == len(res["linearity"]) == 3
    assert [r["eps"] for r in res["sweep"]] == [0.0, 0.01, 0.02, 0.04, 0.20]
    for row in res["sweep"]:
        assert set(row) == {"eps", "accuracy", "speedup", "exit_fractions",
                            "thresholds"}
        assert len(row["exit_fractions"]) == len(row["thresholds"]) == 3
        assert sum(row["exit_fractions"]) == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# no quiet CPU run: without a card each example fails unless --device cpu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["quickstart_torch", "serve_cascade_torch",
                                  "train_llm_cascade_torch",
                                  "paper_reproduction_torch"])
def test_example_without_a_card_fails_unless_cpu_is_asked(name,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        _example(name).main([])
