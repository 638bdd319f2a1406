"""The port's ε knob: exit telemetry, the shadow pass, live thresholds read
from device memory and the threshold controller, against the JAX
package's ``repro.autotune`` on bridged weights.

Settings: ``reduced(qwen2.5-3b, n_layers=3)``, 3 components, f32, kernels
on in the port (their plain versions on the CPU) and the JAX engine's
plain route, 2 lanes of 2 slots, cache_len 32, chunk 4; four prompts of 6
tokens (numpy seed 3), 8 new tokens each, at (0.021, 0.021, 0.0) — the
mixed-exit operating point of the JAX package's
``tests/test_autotune.py`` on these weights — with 256 confidence bins
(the confidences here lie near 0.02–0.04, so 256 bins spread them over
several cells) and a shadow step every 2 positions.  Telemetry counters,
``segments_run``, token and exit streams must be EXACTLY equal to the JAX
engine's: the counters are integer counts in f32.  The ``cuda`` test
needs a card and skips here.
"""
import jax
import numpy as np
import pytest
import torch

from repro.autotune import ThresholdController as JaxController
from repro.autotune import merge_telemetry as jax_merge
from repro.autotune.solver import ExitHistogram as JaxHistogram
from repro.autotune.telemetry import accumulate_prefill as jax_acc_prefill
from repro.autotune.telemetry import init_telemetry as jax_init_telemetry
from repro.autotune.telemetry import pack_rider as jax_pack_rider
from repro.autotune.telemetry import telemetry_to_host as jax_to_host
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import CascadeServingEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.autotune import (ExitHistogram, ThresholdController,
                                  load_artifact, merge_telemetry)
from repro_torch.autotune.telemetry import (accumulate_decode,
                                            accumulate_prefill,
                                            init_telemetry, pack_rider,
                                            telemetry_to_host)
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ref
from repro_torch.kernels.exit_update import exit_update
from repro_torch.kernels.megakernel import exit_head_update
from repro_torch.models import nn
from repro_torch.models.model import build_model
from repro_torch.serving.engine import CascadeServingEngine, Request
from repro_torch.serving.runtime import _key_of, _state_tensors


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers
    on a few cores, where these small ops gain nothing from more threads
    and would slow the other workers' timed tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MIXED = (0.021, 0.021, 0.0)
BINS = 256
BUDGET = 8
ENGINE_KW = dict(lane_batch=2, n_lanes=2, cache_len=32, chunk=4)


def _cfg(pkg="torch", autotune=True, ths=MIXED, **cascade):
    get, red = ((jax_get_config, jax_reduced) if pkg == "jax"
                else (get_config, reduced))
    cfg = red(get("qwen2.5-3b"), n_layers=3).replace(dtype="float32")
    if pkg == "torch":
        cfg = cfg.replace(use_kernels=True)
    cfg = cfg.with_cascade(n_components=3, exit_boundaries=(1, 2),
                           thresholds=ths, **cascade)
    if autotune:
        cfg = cfg.with_autotune(enabled=True, bins=BINS, shadow_every=2,
                                min_shadow=8, resolve_every=4)
    return cfg


@pytest.fixture(scope="module")
def weights():
    jparams = jax_build_model(_cfg("jax")).init(jax.random.PRNGKey(0))
    return jparams, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), _cfg(), device="cpu")


def _prompts(n=4, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, 6).astype(np.int32) for _ in range(n)]


def _drive(pkg, cfg, params, runtime="host", push_at=None, push=None,
           autotune=None, n_req=4, budget=BUDGET):
    if pkg == "jax":
        eng = JaxEngine(cfg, jax_build_model(cfg), params, runtime=runtime,
                        autotune=autotune, **ENGINE_KW)
        make = JaxRequest
    else:
        eng = CascadeServingEngine(cfg, build_model(cfg, device="cpu"),
                                   params, runtime=runtime, device="cpu",
                                   autotune=autotune, **ENGINE_KW)
        make = Request
    for i, p in enumerate(_prompts(n_req)):
        eng.submit(make(rid=i, prompt=p, max_new_tokens=budget))
    for tick in range(200):
        if tick == push_at:
            eng.push_thresholds(push)
        if not eng.queue and all(s.done for ln in eng.lanes
                                 for s in ln["slots"]):
            break
        eng.step()
    return eng


def _streams(eng):
    return {r: (f["tokens"], f["exit_depths"])
            for r, f in sorted(eng.finished.items())}


def _carried(eng):
    return np.sum([np.asarray(ln["state"].segments_run) for ln in eng.lanes],
                  axis=0).tolist()


def _assert_same_telemetry(want: dict, got: dict):
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(want[k]), got[k], err_msg=k)


# ---------------------------------------------------------------------------
# the slice as a whole: the port's engine against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("cohorts", [1, 2])
@pytest.mark.parametrize("mode", ["cond_batch", "select"])
@pytest.mark.parametrize("runtime", ["host", "device"])
def test_telemetry_matches_reference_engine(weights, runtime, mode, cohorts,
                                            layout):
    """Every telemetry counter, the streams, the exits and the carried
    segments_run (which counts the shadow observations) equal the JAX
    engine's exactly; the operating point is mixed (exits at every
    component) and shadow steps ran."""
    jparams, params = weights
    cas = dict(exit_mode=mode, n_cohorts=cohorts, cohort_layout="major")
    jcfg, cfg = _cfg("jax", **cas), _cfg(**cas)
    if layout == "paged":
        jcfg = jcfg.with_paged_cache(layout="paged", block_size=8)
        cfg = cfg.with_paged_cache(layout="paged", block_size=8)
    want = _drive("jax", jcfg, jparams, runtime)
    got = _drive("torch", cfg, params, runtime)
    assert _streams(got) == _streams(want)
    assert _carried(got) == _carried(want)
    tw = jax_merge(want.lane_telemetry())
    tg = merge_telemetry(got.lane_telemetry())
    _assert_same_telemetry(tw, tg)
    assert tg["shadow_steps"] > 0 and np.all(tg["exit_counts"] > 0)
    assert len(np.unique(tg["conf_hist"].nonzero()[1])) > 2
    st = got.stats()["autotune"]
    assert st["shadow_steps"] == float(tg["shadow_steps"])
    assert st["thresholds"] == list(MIXED)


def test_copy_layout_matches_major_layout(weights):
    """The copy layout observes per cohort on every step: its telemetry
    and streams equal the major layout's."""
    _, params = weights
    major = _drive("torch", _cfg(exit_mode="cond_batch", n_cohorts=2),
                   params)
    copy = _drive("torch", _cfg(exit_mode="cond_batch", n_cohorts=2,
                                cohort_layout="copy"), params)
    assert _streams(copy) == _streams(major)
    assert _carried(copy) == _carried(major)
    _assert_same_telemetry(merge_telemetry(major.lane_telemetry()),
                           merge_telemetry(copy.lane_telemetry()))


@pytest.mark.parametrize("runtime", ["host", "device"])
def test_streams_identical_with_autotune_on_and_off(weights, runtime):
    """The shadow pass changes what executes, never what is produced."""
    _, params = weights
    cas = dict(exit_mode="cond_batch", n_cohorts=2)
    on = _drive("torch", _cfg(**cas), params, runtime)
    off = _drive("torch", _cfg(autotune=False, **cas), params, runtime)
    assert _streams(on) == _streams(off)
    # the observations are extra segment work: more segments_run
    assert _carried(on)[0] == _carried(off)[0]
    assert sum(_carried(on)[1:]) > sum(_carried(off)[1:])


@pytest.mark.parametrize("measure", ["softmax_max", "patience@2"])
def test_shadow_pass_commits_nothing_at_mixed_exits(weights, measure):
    """The port of the reference's sharp stream-invariance test: a mixed
    operating point with a shadow step every 3 positions and 20 tokens a
    request; a shadow pass that committed its KV writes or streak
    advances would diverge these streams within a few tokens."""
    _, params = weights
    kw = dict(exit_mode="cond_batch", confidence=measure)
    on_cfg = _cfg(autotune=False, **kw).with_autotune(
        enabled=True, bins=16, shadow_every=3)
    off = _drive("torch", _cfg(autotune=False, **kw), params, budget=20)
    on = _drive("torch", on_cfg, params, budget=20)
    tel = merge_telemetry(on.lane_telemetry())
    assert tel["exit_counts"][0] > 0 and tel["exit_counts"][1:].sum() > 0
    assert tel["shadow_steps"] > 0
    assert _streams(on) == _streams(off)


def test_counters_equal_host_recompute(weights):
    """The device-accumulated counters against a numpy recompute from the
    served streams: exit_counts is the bincount of every decode exit (the
    first token of a request is its prefill decision, a shadow
    observation only); mac_spent prices them with the engine's prefix;
    every live observation lands in the final component's histogram row
    at threshold 1.1; every shadow observation in one joint cell."""
    _, params = weights
    eng = _drive("torch", _cfg(exit_mode="cond_batch"), params, "device")
    tel = merge_telemetry(eng.lane_telemetry())
    exits = [e for r in eng.finished.values() for e in r["exit_depths"][1:]]
    np.testing.assert_array_equal(tel["exit_counts"],
                                  np.bincount(exits, minlength=3))
    assert tel["steps"] == len(exits)
    np.testing.assert_allclose(
        tel["mac_spent"], np.asarray(eng.mac_prefix)[exits].sum(),
        rtol=1e-6)
    assert tel["shadow_count"].sum() == tel["shadow_steps"]
    full = _drive("torch", _cfg(ths=(1.1, 1.1, 0.0), exit_mode="cond_batch"),
                  params)
    tf = merge_telemetry(full.lane_telemetry())
    for m in range(3):
        assert tf["conf_hist"][m].sum() == tf["steps"]


@pytest.mark.parametrize("n_m", [2, 3])
def test_joint_cells_match_exit_histogram_from_samples(n_m):
    """The device fold's C-order joint cells against the port's
    ExitHistogram.from_samples and the JAX package's accumulate_prefill,
    bit for bit; merge sums lanes and carries mac_weights."""
    rng = np.random.default_rng(n_m)
    bins, B = 8, 64
    conf = rng.random((n_m, B)).astype(np.float32)
    pred = rng.integers(0, 5, (n_m, B)).astype(np.int32)
    macs = tuple(float(m + 1) for m in range(n_m))
    tel = init_telemetry(n_m, bins, mac_weights=macs)
    accumulate_prefill(tel, pack_rider(torch.as_tensor(pred),
                                       torch.as_tensor(conf), bins),
                       torch.ones(B, dtype=torch.bool))
    host = telemetry_to_host(tel)
    agrees = (pred[:-1] == pred[-1]).astype(np.float64)
    want = ExitHistogram.from_samples(conf[:-1], agrees, macs, bins)
    jwant = JaxHistogram.from_samples(conf[:-1], agrees, macs, bins)
    np.testing.assert_array_equal(want.counts, jwant.counts)
    np.testing.assert_array_equal(
        host["shadow_count"].reshape(want.counts.shape), want.counts)
    np.testing.assert_array_equal(
        host["shadow_agree"].reshape(want.agree.shape), want.agree)
    jtel = jax_acc_prefill(jax_init_telemetry(n_m, bins, mac_weights=macs),
                           jax_pack_rider(pred, conf, bins),
                           np.ones(B, bool))
    _assert_same_telemetry(jax_to_host(jtel), host)
    merged = merge_telemetry([tel, tel])
    np.testing.assert_array_equal(merged["shadow_count"],
                                  2 * host["shadow_count"])
    np.testing.assert_array_equal(merged["mac_weights"], host["mac_weights"])


def test_live_fold_masks_unreached_rows_and_dead_slots():
    """accumulate_decode: component m's histogram row counts the live
    samples with exit_index >= m; dead slots count nowhere; the shadow
    fold runs only on a shadow step."""
    n_m, bins = 3, 4
    tel = init_telemetry(n_m, bins)
    tcode = torch.tensor([[1, 2, 3, 0], [5, 6, 7, 4], [9, 10, 11, 8]],
                         dtype=torch.int32)
    exit_index = torch.tensor([0, 1, 2, 2], dtype=torch.int32)
    active = torch.tensor([True, True, True, False])
    accumulate_decode(tel, tcode, exit_index, active, False)
    h = telemetry_to_host(tel)
    np.testing.assert_array_equal(h["conf_hist"], [[0, 1, 1, 1],
                                                   [0, 0, 1, 1],
                                                   [0, 0, 0, 1]])
    np.testing.assert_array_equal(h["exit_counts"], [1, 1, 1])
    assert h["steps"] == 3 and h["shadow_steps"] == 0
    accumulate_decode(tel, tcode, exit_index, active, True)
    assert telemetry_to_host(tel)["shadow_steps"] == 3


# ---------------------------------------------------------------------------
# live thresholds: a push is a write into device memory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("runtime", ["host", "device"])
def test_push_matches_reference_and_keeps_the_capture_key(weights, runtime):
    """A push mid-run: the streams equal the JAX engine's with the same
    push at the same tick; every lane keeps its threshold tensor (the
    address a captured graph reads) and the device runtime's capture key
    is the one it had before the push, so no capture follows;
    current_thresholds() returns the pushed floats exactly, 1.1 too."""
    jparams, params = weights
    push = (1.1, 0.0215, 0.0)
    cas = dict(exit_mode="cond_batch", n_cohorts=2)
    want = _drive("jax", _cfg("jax", **cas), jparams, runtime, push_at=3,
                  push=push)
    eng = _drive("torch", _cfg(**cas), params, runtime, push_at=None)
    before = [ln["state"].thresholds.data_ptr() for ln in eng.lanes]

    def key(lane):
        return _key_of(*nn.tree_leaves(eng.params),
                       *nn.tree_leaves(eng._lane_cache(lane)),
                       *_state_tensors(lane["state"]))
    keys = [key(ln) for ln in eng.lanes]
    eng.push_thresholds(push)
    assert [ln["state"].thresholds.data_ptr() for ln in eng.lanes] == before
    assert [key(ln) for ln in eng.lanes] == keys
    assert eng.current_thresholds() == push
    assert eng.stats()["autotune"]["thresholds"] == list(push)
    for ln in eng.lanes:
        assert ln["state"].thresholds.tolist() == [
            float(np.float32(t)) for t in push]
    got = _drive("torch", _cfg(**cas), params, runtime, push_at=3,
                 push=push)
    assert _streams(got) == _streams(want)
    _assert_same_telemetry(jax_merge(want.lane_telemetry()),
                           merge_telemetry(got.lane_telemetry()))
    if runtime == "device":
        assert got.stats()["captures"] == 0      # the CPU loop runs eagerly


def test_push_needs_autotune(weights):
    _, params = weights
    cfg = _cfg(autotune=False)
    model = build_model(cfg, device="cpu")
    eng = CascadeServingEngine(cfg, model, params, device="cpu",
                               **ENGINE_KW)
    with pytest.raises(ValueError, match="autotune"):
        eng.push_thresholds((0.5, 0.5, 0.0))
    with pytest.raises(ValueError, match="autotune"):
        CascadeServingEngine(cfg, model, params, device="cpu",
                             autotune=True, **ENGINE_KW)
    tuned = CascadeServingEngine(_cfg(), model, params, device="cpu",
                                 **ENGINE_KW)
    with pytest.raises(ValueError, match="shape"):
        tuned.push_thresholds((0.5, 0.0))


@pytest.mark.parametrize("ths", [0.0, 0.3, 1.1, "tie"])
@pytest.mark.parametrize("form", ["0-d", "vector"])
def test_plain_kernels_with_device_threshold_equal_float_form(ths, form):
    """The plain exit_update and megakernel given δ̂ as a tensor (0-d, or
    the (n_m,) vector and the component index) give the float form's
    outputs, bit for bit — at 0, 1.1 and at a threshold equal to a row's
    confidence (the gate is >=)."""
    gen = torch.Generator().manual_seed(5)
    B, V, d, n_m, m = 4, 64, 32, 3, 1
    logits = torch.randn(B, V, generator=gen)
    h = torch.randn(B, d, generator=gen)
    w = torch.rand(d, generator=gen) + 0.5
    head = torch.randn(d, V, generator=gen) / 4
    if ths == "tie":
        ths = float(ref.ref_confidence(logits)[1][2])
    value = float(np.float32(ths))
    vec = torch.tensor([0.7, value, 0.0])
    thr = vec if form == "vector" else vec[m].clone()
    ar = torch.arange(B)
    carry = (ar % 3 == 2, torch.full((B,), 7, dtype=torch.int32),
             ar.to(torch.int32) % n_m, 0.1 + 0.1 * ar.float(),
             ar.to(torch.int32) % 4, torch.full((B,), 0.5), ar % 4 != 2)
    kw = dict(m=m, n_components=n_m, patience_k=2, ema_decay=0.8,
              tel_bins=32)
    for fn, args in ((exit_update, (logits,)),
                     (exit_head_update, (h, w, head))):
        want = fn(*args, *carry, threshold=ths, **kw)
        got = fn(*args, *carry, threshold=thr, **kw)
        for a, b in zip(want, got):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

class _FakeEngine:
    """The controller's three-method engine surface over host telemetry."""

    def __init__(self, tel, current=(0.5, 0.5, 0.0)):
        self._tel = tel
        self._current = current
        self.pushed = []

    def lane_telemetry(self):
        return [self._tel]

    def current_thresholds(self):
        return self._current

    def push_thresholds(self, ths):
        self.pushed.append(tuple(ths))
        self._current = tuple(ths)


def _shadow_telemetry(seed, n=512, bins=16, agree_p=0.8):
    rng = np.random.default_rng(seed)
    conf = rng.random((3, n)).astype(np.float32)
    pred = np.where(rng.random((3, n)) < agree_p, 0,
                    rng.integers(1, 5, (3, n))).astype(np.int32)
    pred[-1] = 0
    tel = init_telemetry(3, bins, mac_weights=(1.0, 2.0, 3.0))
    accumulate_prefill(tel, pack_rider(torch.as_tensor(pred),
                                       torch.as_tensor(conf), bins),
                       torch.ones(n, dtype=torch.bool))
    return telemetry_to_host(tel)


@pytest.mark.parametrize("direction", [dict(epsilon=0.05),
                                       dict(epsilon=0.2),
                                       dict(mac_budget=2.0)])
def test_controller_resolves_as_reference_controller(direction):
    """The same telemetry windows into both controllers: the same pushed
    thresholds, resolves, pushes and guard counters at every tick."""
    cfg = _cfg(autotune=False).with_autotune(enabled=True, bins=16,
                                             min_shadow=8, hysteresis=0.01)
    jcfg = _cfg("jax", autotune=False).with_autotune(
        enabled=True, bins=16, min_shadow=8, hysteresis=0.01)
    ours = ThresholdController(cfg, (1.0, 2.0, 3.0), **direction)
    theirs = JaxController(jcfg, (1.0, 2.0, 3.0), **direction)
    cum = None
    fe_o, fe_t = _FakeEngine(None), _FakeEngine(None)
    for seed in range(4):
        win = _shadow_telemetry(seed, agree_p=0.6 + 0.1 * seed)
        cum = win if cum is None else merge_telemetry([cum, win])
        fe_o._tel = fe_t._tel = cum
        assert ours.update(fe_o) == theirs.update(fe_t)
        assert fe_o.pushed == fe_t.pushed
        assert ours.stats() == theirs.stats()
    assert ours.resolves >= 1


def test_controller_min_sample_and_hysteresis_guards():
    cfg = _cfg(autotune=False).with_autotune(enabled=True, bins=16)
    empty = telemetry_to_host(init_telemetry(3, 16, (1.0, 2.0, 3.0)))
    ctrl = ThresholdController(cfg, (1.0, 2.0, 3.0), min_shadow=10**6)
    assert ctrl.update(_FakeEngine(empty)) is None and ctrl.resolves == 0
    # force cannot conjure evidence
    assert ctrl.update(_FakeEngine(empty), force=True) is None
    host = _shadow_telemetry(0)
    ctrl = ThresholdController(cfg, (1.0, 2.0, 3.0), min_shadow=10**6)
    assert ctrl.update(_FakeEngine(host)) is None and ctrl.resolves == 0
    ctrl = ThresholdController(cfg, (1.0, 2.0, 3.0), min_shadow=1,
                               hysteresis=10.0)
    fe = _FakeEngine(host)
    assert ctrl.update(fe) is None
    assert ctrl.resolves == 1 and ctrl.skipped_small == 1 and not fe.pushed
    assert ctrl.update(fe, force=True) is not None and fe.pushed


def test_controller_end_to_end_with_engine(weights, tmp_path):
    """autotune= a controller on the device runtime: it resolves from the
    lanes' telemetry at its ticks (one fetch each), pushes without a new
    capture key, persists an artifact, and a fresh engine warm-starts from
    it; the JAX controller on the same fetched telemetry resolves the same
    thresholds."""
    _, params = weights
    cfg = _cfg(exit_mode="cond_batch").with_autotune(
        mac_budget=2.0, hysteresis=0.0, min_shadow=4, resolve_every=4)
    ctrl = ThresholdController(cfg, (1.0, 2.0, 3.0),
                               artifact_dir=str(tmp_path))
    fetches = []
    import repro_torch.autotune.telemetry as tmod
    real = tmod._host

    def spy(tels):
        fetches.append(len(tels))
        return real(tels)
    tmod._host = spy
    try:
        eng = _drive("torch", cfg, params, "device", autotune=ctrl,
                     n_req=6)
    finally:
        tmod._host = real
    assert ctrl.resolves >= 1 and ctrl.pushes >= 1
    # one fetch (of both lanes) per resolve tick, none per chunk
    assert fetches and set(fetches) == {2}
    assert len(fetches) <= eng._tick // ctrl.resolve_every
    st = eng.stats()["autotune"]
    assert st["controller"]["resolves"] == ctrl.resolves
    assert st["thresholds"] == list(eng.current_thresholds())
    art = load_artifact(str(tmp_path), cfg)
    assert art is not None and tuple(art.thresholds) == ctrl.thresholds
    warm = ThresholdController(cfg, (1.0, 2.0, 3.0),
                               artifact_dir=str(tmp_path))
    eng2 = CascadeServingEngine(cfg, build_model(cfg, device="cpu"), params,
                                device="cpu", autotune=warm, **ENGINE_KW)
    assert eng2.current_thresholds() == tuple(art.thresholds)
    assert eng2.lanes[0]["state"].thresholds.tolist() == [
        float(np.float32(t)) for t in art.thresholds]
    jcfg = _cfg("jax", exit_mode="cond_batch").with_autotune(
        mac_budget=2.0, hysteresis=0.0, min_shadow=4, resolve_every=4)
    fe = _FakeEngine(merge_telemetry(eng.lane_telemetry()))
    fj = _FakeEngine(merge_telemetry(eng.lane_telemetry()))
    assert (ThresholdController(cfg, (1.0, 2.0, 3.0)).update(fe, force=True)
            == JaxController(jcfg, (1.0, 2.0, 3.0)).update(fj, force=True))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_push_makes_no_capture_on_card(weights):
    """On the card: a push between two serves re-uses the lanes'
    captures (``captures`` unchanged), replays read the pushed δ̂ (the
    streams equal a fresh engine built at it: from (0.9, 0.9, 0.0), where
    nothing exits early, to (0, 0, 0), where everything does, so no
    stream depends on which lane a request took), the chunks keep one
    host sync each with every replay under sync debug mode "error", and
    the device runtime's telemetry at the mixed point equals the host
    runtime's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the captured decode graph runs only "
                    "there")
    from repro_torch.utils import resolve_device
    dev = resolve_device("cuda")
    _, params = weights
    params = nn.tree_map(lambda x: x.to(dev), params)

    def serve(eng):
        for i, p in enumerate(_prompts()):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=BUDGET))
        eng.run(200)
        out = dict(eng.finished)
        eng.finished.clear()
        return {r: (f["tokens"], f["exit_depths"])
                for r, f in sorted(out.items())}

    def engine(cfg, runtime="device"):
        eng = CascadeServingEngine(cfg, build_model(cfg, device=dev), params,
                                   device=dev, runtime=runtime, **ENGINE_KW)
        if eng.loop is not None:
            eng.loop.sync_check = True
        return eng

    cas = dict(exit_mode="cond_batch", n_cohorts=2)
    eng = engine(_cfg(ths=(0.9, 0.9, 0.0), **cas))
    serve(eng)
    captures = eng.stats()["captures"]
    assert captures == 2
    eng.push_thresholds((0.0, 0.0, 0.0))
    pushed = serve(eng)
    st = eng.stats()
    assert st["captures"] == captures
    assert st["host_syncs"] == st["decode_dispatches"]
    assert pushed == serve(engine(_cfg(ths=(0.0, 0.0, 0.0), **cas)))
    host, device = engine(_cfg(**cas), "host"), engine(_cfg(**cas))
    assert serve(host) == serve(device)
    _assert_same_telemetry(merge_telemetry(host.lane_telemetry()),
                           merge_telemetry(device.lane_telemetry()))
