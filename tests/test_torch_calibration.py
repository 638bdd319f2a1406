"""The port's copies of the JAX package's numpy modules — the autotune
solver, §5 calibration, the calibrators, ``sweep_epsilons``,
``BudgetPolicy.fit`` and the calibration artifacts — pinned to the
originals: the same inputs (numpy-seeded and hypothesis-drawn) give equal
outputs, floats exactly (both are the same float64/float32 numpy
arithmetic).  An artifact written by either package loads in the other.
And the two CLIs of the slice, ``repro_torch.launch.calibrate`` and
``repro_torch.launch.serve --autotune``, run on the CPU in a subprocess.
"""
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.autotune.solver as jsolver
import repro.core.calibration as jcal
import repro.core.cascade as jcascade
import repro.core.policy as jpolicy
import repro_torch.autotune.solver as solver
import repro_torch.core.calibration as cal
import repro_torch.core.policy as policy
from repro.autotune import artifacts as jart
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro_torch.autotune import artifacts as art
from repro_torch.configs import get_config, reduced
from repro_torch.core import cascade

SRC = Path(__file__).resolve().parent.parent / "src"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers
    on a few cores, where these small ops gain nothing from more threads
    and would slow the other workers' timed tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _population(seed, n=4000, n_m=3):
    """Per-component confidences (the last all 1) and correctness with
    accuracy rising in confidence, plus labels/predictions for the
    evaluation harness."""
    rng = np.random.default_rng(seed)
    confs = [rng.random(n) for _ in range(n_m - 1)] + [np.ones(n)]
    corrects = [(rng.random(n) < 0.2 + 0.7 * c).astype(np.float64)
                for c in confs[:-1]]
    corrects.append((rng.random(n) < 0.8).astype(np.float64))
    labels = rng.integers(0, 10, n)
    preds = [np.where(c > 0, labels, (labels + 1) % 10) for c in corrects]
    return confs, corrects, preds, labels


def _same(a, b):
    """Deep equality of solver / calibration outputs (dataclasses, tuples,
    numpy arrays), floats exactly."""
    if hasattr(a, "__dataclass_fields__"):
        assert type(a).__name__ == type(b).__name__
        for f in a.__dataclass_fields__:
            _same(getattr(a, f), getattr(b, f))
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b, (a, b)


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------

def test_solver_copy_has_the_reference_api():
    names = {n for n in dir(jsolver) if not n.startswith("__")}
    assert names - {"jax", "jnp"} <= {n for n in dir(solver)}


@pytest.mark.parametrize("n_m,bins", [(2, 32), (3, 16), (3, 64)])
@pytest.mark.parametrize("seed", [0, 1])
def test_solver_outputs_equal_reference(seed, n_m, bins):
    confs, corrects, _, _ = _population(seed, n_m=n_m)
    macs = tuple(float(1 + 2 * m) for m in range(n_m))
    hists = [mod.ExitHistogram.from_samples(np.stack(confs),
                                            np.stack(corrects), macs, bins)
             for mod in (solver, jsolver)]
    _same(hists[0], hists[1])
    for eps in (0.0, 0.02, 0.1, 0.3):
        for mode in ("joint", "independent"):
            _same(solver.solve_epsilon(hists[0], eps, mode=mode),
                  jsolver.solve_epsilon(hists[1], eps, mode=mode))
        _same(solver.independent_epsilon_edges(hists[0], eps),
              jsolver.independent_epsilon_edges(hists[1], eps))
    for budget in (macs[0], 0.5 * (macs[0] + macs[-1]), macs[-1]):
        _same(solver.solve_budget(hists[0], budget),
              jsolver.solve_budget(hists[1], budget))
    merged = [mod.merge_histograms([h, h]) for mod, h in
              zip((solver, jsolver), hists)]
    _same(merged[0], merged[1])


@settings(max_examples=25, deadline=None)
@given(st.lists(st.floats(0.0, 1.0), min_size=1, max_size=4),
       st.integers(1, 128))
def test_edge_conversions_equal_reference(ths, bins):
    ths = tuple(ths) + (0.0,)
    _same(solver.edges_from_thresholds(ths, bins),
          jsolver.edges_from_thresholds(ths, bins))
    edges = jsolver.edges_from_thresholds(ths, bins)
    _same(solver.thresholds_from_edges(edges, bins),
          jsolver.thresholds_from_edges(edges, bins))


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(20, 400),
       st.sampled_from([4, 8, 32]), st.floats(0.0, 0.4))
def test_solver_equal_reference_on_drawn_histograms(seed, n, bins, eps):
    rng = np.random.default_rng(seed)
    confs = rng.random((2, n)).astype(np.float32)
    agrees = (rng.random((2, n)) < 0.5 + 0.5 * confs).astype(np.float64)
    macs = (1.0, 2.0, 4.0)
    hists = [mod.ExitHistogram.from_samples(confs, agrees, macs, bins)
             for mod in (solver, jsolver)]
    _same(hists[0], hists[1])
    _same(solver.solve_epsilon(hists[0], eps),
          jsolver.solve_epsilon(hists[1], eps))
    budget = 1.0 + 3.0 * eps
    _same(solver.solve_budget(hists[0], budget),
          jsolver.solve_budget(hists[1], budget))


def test_histogram_from_host_telemetry_equals_reference():
    """from_telemetry on a host counter dict (the controller's input)."""
    rng = np.random.default_rng(3)
    bins = 8
    tel = {"exit_counts": np.ones(3, np.float32),
           "shadow_count": rng.integers(0, 5, bins * bins).astype(
               np.float32),
           "mac_weights": np.array([1, 2, 3], np.float32)}
    tel["shadow_agree"] = np.stack([
        np.minimum(tel["shadow_count"], rng.integers(0, 5, bins * bins))
        for _ in range(2)]).astype(np.float32)
    tel["conf_hist"] = np.zeros((3, bins), np.float32)
    _same(solver.ExitHistogram.from_telemetry(tel),
          jsolver.ExitHistogram.from_telemetry(tel))


# ---------------------------------------------------------------------------
# §5 calibration, the calibrators, the sweep, the budget policy
# ---------------------------------------------------------------------------

@settings(max_examples=30, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(2, 300),
       st.floats(0.0, 0.5), st.booleans())
def test_threshold_for_epsilon_equals_reference(seed, n, eps, val):
    rng = np.random.default_rng(seed)
    conf = np.round(rng.random(n), 2)           # ties on purpose
    correct = (rng.random(n) < conf).astype(np.float64)
    kw = {}
    if val:
        kw = dict(val_conf=np.round(rng.random(n), 2),
                  val_correct=(rng.random(n) < 0.7).astype(np.float64))
    _same(cal.accuracy_vs_confidence(conf, correct),
          jcal.accuracy_vs_confidence(conf, correct))
    _same(cal.threshold_for_epsilon(conf, correct, eps, **kw),
          jcal.threshold_for_epsilon(conf, correct, eps, **kw))


@pytest.mark.parametrize("spec", ["self", "final", "holdout",
                                  "holdout@0.3", "holdout@0.3:final"])
@pytest.mark.parametrize("seed", [0, 1])
def test_calibrators_equal_reference(spec, seed):
    confs, corrects, _, _ = _population(seed)
    for eps in (0.0, 0.05, 0.2):
        _same(cal.calibrate_thresholds(confs, corrects, eps, relative_to=spec),
              jcal.calibrate_thresholds(confs, corrects, eps,
                                        relative_to=spec))
    vc, vk, _, _ = _population(seed + 10)
    _same(policy.get_calibrator(spec).calibrate(
              confs, corrects, 0.05, val_confidences=vc, val_corrects=vk),
          jpolicy.get_calibrator(spec).calibrate(
              confs, corrects, 0.05, val_confidences=vc, val_corrects=vk))


def test_registries_resolve_and_refuse_as_ported():
    # the reference's built-ins, entropy and margin among them since the
    # training slice (other test files register more names in both
    # packages' registries)
    ported = {"calibrators": {"self", "final", "holdout"},
              "policies": {"threshold", "budget"},
              "measures": {"softmax_max", "patience", "entropy", "margin"}}
    for kind, names in ported.items():
        assert names <= set(getattr(policy, f"available_{kind}")())
        assert names <= set(getattr(jpolicy, f"available_{kind}")())
    assert isinstance(policy.get_policy("budget@2.5"), policy.BudgetPolicy)
    for bad in ("holdout@1.5", "holdout@0.5:bogus"):
        with pytest.raises(ValueError):
            policy.get_calibrator(bad)
    with pytest.raises(ValueError):
        policy.get_policy("budget@1:bogus")
    for name in ("entropy", "margin"):
        assert policy.get_measure(name).name == name
        assert policy.get_measure(f"patience@2:{name}").base.name == name
    with pytest.raises(KeyError):
        policy.get_calibrator("nope")


@pytest.mark.parametrize("calibrator", ["self", "final", "holdout"])
def test_sweep_epsilons_equals_reference(calibrator):
    confs, corrects, preds, labels = _population(2)
    tc, tk, tp, tl = _population(3)
    macs = (1.0, 2.0, 3.0)
    eps = (0.0, 0.02, 0.1)
    got = cascade.sweep_epsilons(confs, corrects, tc, tp, tl, macs, eps,
                                 calibrator=calibrator)
    want = jcascade.sweep_epsilons(confs, corrects, tc, tp, tl, macs, eps,
                                   calibrator=calibrator)
    assert len(got) == len(want) == len(eps)
    for (e1, c1, r1), (e2, c2, r2) in zip(got, want):
        assert e1 == e2
        _same(c1, c2)
        _same(r1, r2)


def test_budget_policy_fit_equals_reference():
    """The solver fit (with corrects) and the deprecated shared-quantile
    fit (without) give the reference's thresholds and fitted MACs; the
    solver path does not warn, the shared path warns once."""
    confs, corrects, _, _ = _population(4, n=6000)
    macs = (1.0, 2.0, 3.0)
    for budget in (1.2, 2.0, 2.7):
        ours, theirs = (mod.get_policy(f"budget@{budget}")
                        for mod in (policy, jpolicy))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = ours.fit(confs, macs, corrects=corrects)
        assert got == theirs.fit(confs, macs, corrects=corrects)
        assert ours.fitted_avg_macs == theirs.fitted_avg_macs
    policy._SHARED_QUANTILE_WARNED = False
    ours = policy.get_policy("budget@2.0:shared")
    with pytest.warns(DeprecationWarning, match="shared-quantile"):
        got = ours.fit(confs, macs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = jpolicy.get_policy("budget@2.0:shared").fit(confs, macs)
    assert got == want
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        policy.get_policy("budget@2.0:shared").fit(confs, macs)
    with pytest.raises(RuntimeError, match="fitted"):
        policy.get_policy("budget@2.0").resolve_thresholds(None)


def test_fitted_budget_policy_decides_like_threshold_policy():
    """A fitted budget policy gates exactly as the threshold policy at
    its thresholds, through the fused exit-update kernel's plain
    version."""
    confs, corrects, _, _ = _population(5, n=2000)
    pol = policy.get_policy("budget@2.0")
    pol.fit(confs, (1.0, 2.0, 3.0), corrects=corrects)
    gen = torch.Generator().manual_seed(0)
    logits = [torch.randn(16, 40, generator=gen) * 3 for _ in range(3)]
    budget = policy.ExitDecider("softmax_max", pol, use_kernels=True)
    plain = policy.ExitDecider("softmax_max", "threshold",
                               thresholds=pol.thresholds, use_kernels=True)
    a, b = budget.decide(logits), plain.decide(logits)
    assert torch.equal(a.exit_index, b.exit_index)
    assert torch.equal(a.prediction, b.prediction)


# ---------------------------------------------------------------------------
# artifacts: the same key, readable both ways
# ---------------------------------------------------------------------------

def _cfgs(**autotune):
    jc = jax_reduced(jax_get_config("qwen2.5-3b"), n_layers=3)
    tc = reduced(get_config("qwen2.5-3b"), n_layers=3)
    out = []
    for c in (tc, jc):
        c = c.with_cascade(n_components=3, exit_boundaries=(1, 2))
        out.append(c.with_autotune(enabled=True, **autotune))
    return out


@pytest.mark.parametrize("variant", [{}, {"bins": 8}, {"full": True},
                                     {"confidence": "patience@2"}])
def test_config_key_equals_reference(variant):
    variant = dict(variant)
    full = variant.pop("full", False)
    conf = variant.pop("confidence", None)
    if full:
        cfgs = [get_config("qwen2.5-3b"), jax_get_config("qwen2.5-3b")]
    else:
        cfgs = _cfgs(**variant)
    if conf:
        cfgs = [c.with_cascade(confidence=conf) for c in cfgs]
    assert art.config_key(cfgs[0]) == jart.config_key(cfgs[1])


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_artifact_written_by_either_package_loads_in_the_other(tmp_path,
                                                               writer):
    tcfg, jcfg = _cfgs(bins=16)
    mod, cfg = (art, tcfg) if writer == "torch" else (jart, jcfg)
    a = mod.CalibrationArtifact(
        config_key=mod.config_key(cfg), thresholds=(0.25, 1.1, 0.0),
        direction="epsilon", target=0.05, bins=16,
        mac_prefix=(1.0, 2.0, 3.0), agreement=0.97, avg_macs=1.4,
        shadow_steps=128.0, edges=(4, 16))
    path = mod.save_artifact(str(tmp_path), a)
    assert os.path.exists(path)
    with open(path) as f:
        assert json.load(f)["version"] == 1
    other, ocfg = (jart, jcfg) if writer == "torch" else (art, tcfg)
    got = other.load_artifact(str(tmp_path), ocfg)
    assert got is not None
    assert {k: v for k, v in vars(got).items()} == vars(a)
    # a different calibration identity finds no artifact
    assert other.load_artifact(str(tmp_path), ocfg.with_autotune(
        bins=8)) is None


# ---------------------------------------------------------------------------
# the CLIs, on the CPU
# ---------------------------------------------------------------------------

def _cli(module, *args, tmp_path):
    env = {**os.environ, "PYTHONPATH": str(SRC), "HOME": str(tmp_path)}
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=str(tmp_path))


def test_calibrate_cli_on_cpu(tmp_path):
    """The calibrate CLI drives traffic on the device runtime (eager on
    the CPU), resolves, writes the artifact and prints one JSON summary
    whose thresholds the artifact holds; the JAX package loads it."""
    out = tmp_path / "artifacts"
    res = _cli("repro_torch.launch.calibrate", "--arch", "qwen2.5-3b",
               "--smoke", "--device", "cpu", "--epsilon", "0.05",
               "--requests", "4", "--max-new", "8", "--cache-len", "32",
               "--chunk", "4", "--out", str(out), tmp_path=tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    assert summary["requests_finished"] == 4
    assert summary["shadow_steps"] > 0
    assert summary["direction"] == "epsilon"
    cfg = reduced(get_config("qwen2.5-3b")).with_autotune(
        enabled=True, bins=32)
    loaded = art.load_artifact(str(out), cfg)
    assert loaded is not None
    assert list(loaded.thresholds) == summary["thresholds"]
    jcfg = jax_reduced(jax_get_config("qwen2.5-3b")).with_autotune(
        enabled=True, bins=32)
    assert jart.load_artifact(str(out), jcfg).thresholds == loaded.thresholds


def test_serve_cli_autotune_on_cpu(tmp_path):
    """serve --autotune on the CPU: the controller is attached and
    reported, every request finishes, and --artifacts warm-starts a second
    run from the first one's resolution."""
    out = tmp_path / "artifacts"
    args = ("--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
            "--requests", "4", "--max-new", "8", "--cache-len", "32",
            "--runtime", "device", "--chunk", "4", "--exit-mode",
            "cond_batch", "--autotune", "--budget-macs", "2e5",
            "--artifacts", str(out))
    res = _cli("repro_torch.launch.serve", *args, tmp_path=tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "autotune: live thresholds" in res.stderr
    assert "not ported" not in res.stderr
