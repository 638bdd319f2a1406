"""The paper's experiment in the port: CI-ResNet, the synthetic images,
the MAC accounting, backtrack training, the ε-sweep and Algorithm 1 on
CI-ResNet's components, against the JAX package on bridged weights.

Sizes: CI-RESNET(1) and (2) (n = 2 has a stride-1 block after each
stride-2 one), enhance_dim 32, 10 classes, batches of at most 16 images
for the forward checks; backtrack training on 64 images in batches of 32
for one epoch (2 + 2 + 2 steps).

Tolerances: logits and BN state 1e-5 absolute and relative (f32
convolutions summed in other orders), the feature maps between components
1e-4 (values up to ~3 after a module of convolutions); training losses
1e-4 relative and the trained params and state 1e-4 absolute (six SGD
steps carry the convolutions' f32 rounding forward); MACs, data arrays, exit fractions,
accuracies and predictions exact; calibrated thresholds (confidences the
two packages' exp and log round differently) 1e-6 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import resnet_trainer as jtrainer
from repro.core.cascade import cascade_infer_sequential as jax_infer
from repro.core.macs import resnet_component_macs as jax_macs
from repro.data.synth_images import make_image_splits as jax_splits
from repro.models.resnet import CIResNet as JaxResNet
from repro.models.resnet import conv2d as jax_conv2d
from repro_torch import kernels
from repro_torch.bridge import resnet_params_from_jax, resnet_params_to_numpy
from repro_torch.configs import get_config
from repro_torch.core import resnet_trainer as trainer
from repro_torch.core.cascade import cascade_infer_sequential
from repro_torch.core.macs import conv_macs, resnet_component_macs
from repro_torch.core.policy import ExitDecider
from repro_torch.data.synth_images import make_image_splits
from repro_torch.models.model import build_model
from repro_torch.models.resnet import CIResNet, conv2d


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers
    on a few cores, where these small ops gain nothing from more threads
    and would slow the other workers' timed tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-5
FEAT_TOL = 1e-4
THRESHOLD_RTOL = 1e-6
ENH = 32


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _flat(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _same_tree(got, want, atol, rtol=0.0):
    got, want = _flat(got), _flat(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=rtol,
                                   err_msg=jax.tree_util.keystr(path))


def _models(n):
    jm = JaxResNet(n, 10, ENH)
    jp, js = jm.init(jax.random.PRNGKey(n))
    np_p, np_s = (jax.tree_util.tree_map(np.asarray, t) for t in (jp, js))
    tp, ts = resnet_params_from_jax(np_p, np_s, device="cpu")
    return jm, jp, js, CIResNet(n, 10, ENH, device="cpu"), tp, ts


def _images(b, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, 32, 32, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# config, MACs, data
# ---------------------------------------------------------------------------

def test_config_equals_reference_and_build_model_refuses_cnn():
    cfg = get_config("ci-resnet18")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_get_config("ci-resnet18"))
    with pytest.raises(NotImplementedError, match="cnn"):
        build_model(cfg, device="cpu")


@pytest.mark.parametrize("n", [1, 3, 18])
@pytest.mark.parametrize("classes", [10, 100])
def test_component_macs_equal_reference(n, classes):
    got = resnet_component_macs(n, classes)
    assert got == jax_macs(n, classes)
    assert got == jax_macs(n, classes, enhance_dim=128)
    assert resnet_component_macs(n, classes, enhance_dim=0) == \
        jax_macs(n, classes, enhance_dim=0)
    if n == 18 and classes == 10:     # ResNet-110's canonical ~253 M MACs
        assert 2.5e8 < got[-1] < 2.56e8
    assert conv_macs(3, 16, 32, 16, 16) == 3 * 3 * 16 * 32 * 16 * 16


@pytest.mark.parametrize("augment", [False, True])
def test_synth_images_bit_for_bit(augment):
    kw = dict(n_classes=10, n_train=40, n_val=12, n_test=9, seed=5)
    got, want = make_image_splits(**kw), jax_splits(**kw)
    for g, w in zip(got, want):
        for f in ("images", "labels", "difficulty"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    pairs = zip(got[0].batches(16, r1, epochs=2, augment=augment),
                want[0].batches(16, r2, epochs=2, augment=augment))
    n = 0
    for (x1, y1), (x2, y2) in pairs:
        assert x1.tobytes() == x2.tobytes() and y1.tobytes() == y2.tobytes()
        n += 1
    assert n == 4                      # drop-last: 2 batches an epoch


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_conv2d_same_padding_at_stride_2():
    """XLA's SAME pads (0, 1) at stride 2 on an even size: a symmetric
    pad of 1 would shift every strided output by a pixel."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 32, 5)).astype(np.float32)
    for k in (3, 1):
        w = rng.standard_normal((k, k, 5, 7)).astype(np.float32)
        want = jax_conv2d(jnp.asarray(x), jnp.asarray(w), 2)
        got = conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                     torch.from_numpy(w).permute(3, 2, 0, 1), 2)
        assert got.shape == (2, 7, 16, 16)
        np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)), _np(want),
                                   atol=TOL, rtol=TOL)


def test_bridge_round_trip_bit_exact():
    jm = JaxResNet(2, 10, ENH)
    jp, js = jm.init(jax.random.PRNGKey(0))
    np_p, np_s = (jax.tree_util.tree_map(np.asarray, t) for t in (jp, js))
    tp, ts = resnet_params_from_jax(np_p, np_s, device="cpu")
    assert tuple(tp["module1"][0]["conv1"].shape) == (32, 16, 3, 3)
    assert tuple(tp["module1"][0]["proj"].shape) == (32, 16, 1, 1)
    assert tuple(tp["head0"]["w1"].shape) == (16, ENH)
    bp, bs = resnet_params_to_numpy(tp, ts)
    for a, b in ((np_p, bp), (np_s, bs)):
        fa, ta = jax.tree_util.tree_flatten(a)
        fb, tb = jax.tree_util.tree_flatten(b)
        assert ta == tb
        assert all(x.dtype == y.dtype and x.shape == y.shape
                   and x.tobytes() == y.tobytes() for x, y in zip(fa, fb))
    # the port's own init draws the same tree of shapes
    own_p, own_s = CIResNet(2, 10, ENH, device="cpu").init(0)
    shapes = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: tuple(x.shape), t)
    assert shapes(own_p) == shapes(tp) and shapes(own_s) == shapes(ts)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("train", [False, True])
def test_apply_matches_reference(n, train):
    jm, jp, js, tm, tp, ts = _models(n)
    x = _images(8, seed=n)
    jl, jst = jm.apply(jp, js, jnp.asarray(x), train=train)
    tl, tst = tm.apply(tp, ts, torch.from_numpy(x), train=train)
    assert len(tl) == 3
    for a, b in zip(tl, jl):
        assert a.shape == (8, 10)
        np.testing.assert_allclose(_np(a), _np(b), atol=TOL, rtol=TOL)
    _, back = resnet_params_to_numpy(tp, tst)
    _same_tree(back, jst, TOL, TOL)
    if not train:         # the running statistics, untouched
        assert all(a is b for a, b in zip(jax.tree_util.tree_leaves(tst),
                                          jax.tree_util.tree_leaves(ts)))
    else:          # the running statistics moved, outside autograd
        assert not tst["stem"]["mean"].requires_grad
        assert not torch.equal(tst["stem"]["var"], ts["stem"]["var"])


def test_component_fns_match_apply_and_reference():
    jm, jp, js, tm, tp, ts = _models(2)
    x = _images(6, seed=4)
    full, _ = tm.apply(tp, ts, torch.from_numpy(x))
    jfns = jm.component_fns(jp, js)
    carry, jcarry = None, None
    for m, fn in enumerate(tm.component_fns(tp, ts)):
        lg, carry = fn(torch.from_numpy(x), carry)
        jlg, jcarry = jfns[m](jnp.asarray(x), jcarry)
        assert torch.equal(lg, full[m])
        np.testing.assert_allclose(_np(lg), _np(jlg), atol=TOL, rtol=TOL)
        # the carry is the NCHW feature map of the reference's NHWC one
        np.testing.assert_allclose(_np(carry.permute(0, 2, 3, 1)),
                                   _np(jcarry), atol=FEAT_TOL,
                                   rtol=FEAT_TOL)


def test_algorithm1_on_ci_resnet_with_kernels_takes_plain_version():
    jm, jp, js, tm, tp, ts = _models(1)
    x = _images(4, seed=9)
    jfns = jm.component_fns(jp, js)
    fns = tm.component_fns(tp, ts)
    for ths in ((0.0, 0.0, 0.0), (0.5, 0.5, 0.0), (1.1, 1.1, 0.0)):
        kernels.reset_launch_counts()
        got = [cascade_infer_sequential(
            fns, ths, torch.from_numpy(x),
            ExitDecider("softmax_max", use_kernels=k)) for k in (True, False)]
        # CPU tensors take the confidence kernel's plain version
        assert kernels.launch_counts()["confidence"] == 0
        assert torch.equal(got[0][0], got[1][0])
        assert torch.equal(got[0][1], got[1][1])
        jpred, jconf = jax_infer(jfns, ths, jnp.asarray(x))
        np.testing.assert_array_equal(_np(got[0][0]), _np(jpred))
        np.testing.assert_allclose(_np(got[0][1]), _np(jconf), atol=TOL,
                                   rtol=TOL)


# ---------------------------------------------------------------------------
# backtrack training (Algorithm 2), end to end at a tiny size
# ---------------------------------------------------------------------------

TRAIN_KW = dict(n_epochs=1, batch_size=32, augment=True, seed=3)


@pytest.fixture(scope="module")
def trained():
    train, _, test = make_image_splits(n_classes=10, n_train=64, n_val=8,
                                       n_test=16, seed=2)
    jtrain, _, jtest = jax_splits(n_classes=10, n_train=64, n_val=8,
                                  n_test=16, seed=2)
    jm = JaxResNet(1, 10, ENH)
    want = jtrainer.train_backtrack(jm, jtrain, test=jtest, **TRAIN_KW)
    jp, js = jm.init(jax.random.PRNGKey(TRAIN_KW["seed"]))
    init = resnet_params_from_jax(
        *(jax.tree_util.tree_map(np.asarray, t) for t in (jp, js)),
        device="cpu")
    tm = CIResNet(1, 10, ENH, device="cpu")
    # a snapshot of the params at the start of each phase (the trainer
    # builds one optimizer a phase) and at the end
    snaps = []
    real = trainer.sgd_momentum

    def spy(*a, **kw):
        opt = real(*a, **kw)

        def init_(params):
            snaps.append(jax.tree_util.tree_map(torch.clone, params))
            return opt.init(params)
        return dataclasses.replace(opt, init=init_)

    trainer.sgd_momentum = spy
    try:
        got = trainer.train_backtrack(tm, train, test=test, init=init,
                                      **TRAIN_KW)
    finally:
        trainer.sgd_momentum = real
    snaps.append(got.params)
    return want, got, snaps, init


def test_backtrack_training_matches_reference(trained):
    want, got, _, _ = trained
    assert list(got.phase_losses) == list(want.phase_losses) == [
        "backbone+last", "head0", "head1"]
    for name, losses in want.phase_losses.items():
        assert len(got.phase_losses[name]) == len(losses) == 2
        np.testing.assert_allclose(got.phase_losses[name], losses, rtol=1e-4)
    bp, bs = resnet_params_to_numpy(got.params, got.state)
    _same_tree(bp, want.params, 1e-4)
    _same_tree(bs, want.state, 1e-4)
    assert got.component_acc == want.component_acc


def test_backtrack_frozen_leaves_bit_identical(trained):
    """Phase 0 trains the backbone and head2; phase head_m trains head m
    alone.  Every other leaf keeps its bits through the phase (the BN
    running state still moves: the forward is in train mode)."""
    _, got, snaps, init = trained
    assert len(snaps) == 4
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(snaps[0]),
        jax.tree_util.tree_leaves(init[0])))
    trains = [lambda k: not k.startswith(("head0", "head1")),
              lambda k: k.startswith("head0"),
              lambda k: k.startswith("head1")]
    for phase, trained_in in enumerate(trains):
        before = dict(_flat(snaps[phase]))
        after = dict(_flat(snaps[phase + 1]))
        for path, leaf in before.items():
            key = jax.tree_util.keystr(path).strip("[]'")
            same = torch.equal(leaf, after[path])
            assert same != trained_in(key), (phase, key)


def test_evaluate_tradeoff_on_the_same_logits(trained, monkeypatch):
    want, got, _, _ = trained
    _, val, test = make_image_splits(n_classes=10, n_train=8, n_val=64,
                                     n_test=48, seed=7)
    def logits(data):
        r = np.random.default_rng(len(data))
        return [(r.standard_normal((len(data), 10)) * s).astype(np.float32)
                for s in (1.0, 2.0, 4.0)]
    monkeypatch.setattr(trainer, "collect_logits",
                        lambda m, p, s, data, *a, **k: logits(data))
    monkeypatch.setattr(jtrainer, "collect_logits",
                        lambda m, p, s, data, *a, **k: logits(data))
    eps = (0.2, 0.05, 0.01, 0.0)
    for measure in ("softmax_max", "entropy", "margin"):
        a = trainer.evaluate_tradeoff(
            CIResNet(1, 10, ENH, device="cpu"), got.params, got.state, val,
            test, eps, 10, measure=measure)
        b = jtrainer.evaluate_tradeoff(JaxResNet(1, 10, ENH), want.params,
                                       want.state, val, test, eps, 10,
                                       measure=measure)
        for (e1, r1), (e2, r2) in zip(a, b):
            assert e1 == e2
            np.testing.assert_array_equal(r1.exit_fractions,
                                          r2.exit_fractions)
            assert r1.accuracy == r2.accuracy
            assert r1.avg_macs == r2.avg_macs and r1.speedup == r2.speedup
            np.testing.assert_allclose(r1.thresholds, r2.thresholds,
                                       rtol=THRESHOLD_RTOL, atol=0)


def test_evaluate_wallclock_exits_equal_the_analytic_ones(trained):
    _, got, _, _ = trained
    tm = CIResNet(1, 10, ENH, device="cpu")
    _, val, _ = make_image_splits(n_classes=10, n_train=8, n_val=40,
                                  n_test=8, seed=4)
    conf, _, _ = trainer.collect_outputs(tm, got.params, got.state, val,
                                         batch_size=16)
    ths = (float(np.median(conf[0])), float(np.median(conf[1])), 0.0)
    out = trainer.evaluate_wallclock(tm, got.params, got.state, val, ths,
                                     batch_size=16, repeats=1)
    stay0 = conf[0] < ths[0]
    exits = [int((~stay0).sum()), int((stay0 & (conf[1] >= ths[1])).sum())]
    exits.append(len(val) - sum(exits))
    assert out["exit_fractions"] == [e / len(val) for e in exits]
    assert out["t_staged_s"] > 0 and out["t_dense_s"] > 0
