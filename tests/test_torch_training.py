"""Training in the port, and the entropy and margin measures, against the
JAX package: the losses, the trainability mask, the schedules, the
optimizers, ``forward_train`` and ``make_train_step`` on bridged weights,
the checkpoint format (both ways, f32 and bf16), the token stream, the
train CLI, and the engine serving with ``confidence="entropy"`` and
``"margin"``.

Model: ``reduced(qwen2.5-3b, n_layers=4)``, 3 components (boundaries
after layers 1 and 3), f32.  Tolerances: losses and measure confidences
1e-6 relative (f32 rounding); optimizer updates and states 1e-6 relative
and 1e-8 absolute (an f32 ulp at the updates' scale) over 5 steps; exit
logits of ``forward_train`` 1e-4 (four layers of f32 matmuls summed in
other orders); three AdamW train steps: losses 1e-4 relative, params 1e-5 absolute but for at most one
weight in 10^4, every weight within 2 learning rates a step (AdamW's first
steps move every weight by about the learning rate, 3e-4, whatever the
gradient's size, so a weight whose gradient is at rounding level may land
a step apart); served tokens, exits and ``segments_run`` exact, and
masked leaves and moments, data arrays and checkpoint bits bit for bit.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import load_checkpoint as jax_load
from repro.ckpt import save_checkpoint as jax_save
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import policy as jpolicy
from repro.core import training as jtraining
from repro.data.lm_pipeline import SyntheticLMStream as JaxStream
from repro.launch import steps as jsteps
from repro.models.model import build_model as jax_build_model
from repro.optim import optimizer as jopt
from repro.optim import schedule as jsched
from repro.serving.engine import CascadeServingEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro.utils import path_str as jax_path_str
from repro_torch import utils
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.ckpt import (latest_step, load_checkpoint, save_checkpoint,
                              tree_digest)
from repro_torch.configs import get_config, reduced
from repro_torch.core import policy, training
from repro_torch.data.lm_pipeline import SyntheticLMStream, shard_batch
from repro_torch.launch import steps
from repro_torch.launch import train as train_cli
from repro_torch.models.model import build_model
from repro_torch.models.nn import tree_leaves
from repro_torch.optim import optimizer as opt
from repro_torch.optim import schedule as sched
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


SRC = Path(__file__).resolve().parents[1] / "src"
F32 = 1e-6
LOGIT_TOL = 1e-4
STEP_TOL = 1e-4
OPT_ATOL = 1e-8      # one f32 ulp at 0.1, the scale of the updates
# three AdamW steps at lr 3e-4: weights within PARAM_TOL but for at most
# FAR_SHARE of them, and every weight within FLIP_BOUND (2 lr a step)
PARAM_TOL = 1e-5
FAR_SHARE = 1e-4
FLIP_BOUND = 3 * 2 * 3e-4


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(**kw):
    cas = dict(n_components=3, exit_boundaries=(1, 3))
    cas.update(kw.pop("cascade", {}))
    jcfg = jax_reduced(jax_get_config("qwen2.5-3b"), n_layers=4) \
        .with_cascade(**cas).replace(**kw)
    cfg = reduced(get_config("qwen2.5-3b"), n_layers=4) \
        .with_cascade(**cas).replace(**kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = _cfgs()
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, np_params, cfg


def _port_params(np_params, cfg):
    return params_from_jax(np_params, cfg, device="cpu")


# ---------------------------------------------------------------------------
# the entropy and margin measures
# ---------------------------------------------------------------------------

def _logits(kind):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 7, 33)) * 3).astype(np.float32)
    if kind == "tied":
        x[..., 5] = x.max(-1)           # two equal maxima a row at least
        x[..., 9] = x[..., 5]
        x[0, 0] = 1.0                   # a constant row
    return x


@pytest.mark.parametrize("kind", ["random", "tied"])
@pytest.mark.parametrize("name", ["entropy", "margin", "softmax_max",
                                  "patience@2:margin"])
def test_measures_match_reference(name, kind):
    x = _logits(kind)
    out, conf = policy.get_measure(name)(_t(x))
    jout, jconf = jpolicy.get_measure(name)(jnp.asarray(x))
    np.testing.assert_array_equal(_np(out), _np(jout))
    np.testing.assert_allclose(_np(conf), _np(jconf), rtol=F32, atol=F32)
    if kind == "tied" and name == "margin":
        assert np.all(_np(conf) == 0)     # tied top two: no margin
    # measure_all stacks the per-component pairs
    outs, confs = policy.ExitDecider(name).measure_all([_t(r) for r in x])
    jouts, jconfs = jpolicy.ExitDecider(name).measure_all(
        [jnp.asarray(r) for r in x])
    assert outs.shape == confs.shape == (3, 7)
    np.testing.assert_array_equal(_np(outs), _np(jouts))
    np.testing.assert_allclose(_np(confs), _np(jconfs), rtol=F32, atol=F32)


@pytest.mark.parametrize("name", ["entropy", "margin"])
def test_measures_have_no_fused_route(name):
    d = policy.ExitDecider(name, use_kernels=True)
    assert d.measure.fused_kernel(torch.zeros(2, 8)) is None
    assert not d.fused_scan
    jd = jpolicy.ExitDecider(name, use_kernels=True)
    assert not jd.fused_scan


ENGINE_KW = dict(lane_batch=2, n_lanes=2, cache_len=64)
PROMPT_LENS = (16, 20, 9, 12, 7)
# thresholds where some tokens exit at each component, each at least
# EDGE away from every confidence the run computes (asserted)
SERVE_THS = {"entropy": (0.1495, 0.1480, 0.0),
             "margin": (0.0088, 0.0042, 0.0)}
EDGE = 1e-5


def _requests(make):
    rng = np.random.default_rng(11)
    return [make(i, rng.integers(0, 512, size=n).astype(np.int32), 6)
            for i, n in enumerate(PROMPT_LENS)]


@pytest.mark.parametrize("name", ["entropy", "margin"])
def test_engine_serves_entropy_and_margin_like_reference(weights, name,
                                                         monkeypatch):
    jparams, np_params, _ = weights
    ths = SERVE_THS[name]
    cas = dict(thresholds=ths, exit_mode="cond_batch", confidence=name)
    jcfg, cfg = _cfgs(use_kernels=True, cascade=cas)
    seen = []
    cls = type(policy.get_measure(name))
    call = cls.__call__

    def spy(self, logits):
        pair = call(self, logits)
        seen.append(_np(pair[1]).copy())
        return pair
    monkeypatch.setattr(cls, "__call__", spy)
    eng = CascadeServingEngine(cfg, build_model(cfg, device="cpu"),
                               _port_params(np_params, cfg), device="cpu",
                               **ENGINE_KW)
    jeng = JaxEngine(jcfg, jax_build_model(jcfg), jparams, **ENGINE_KW)
    for e, make in ((eng, Request), (jeng, JaxRequest)):
        for r in _requests(lambda i, p, n: make(rid=i, prompt=p,
                                                max_new_tokens=n)):
            e.submit(r)
    got, want = eng.run(max_ticks=500), jeng.run(max_ticks=500)
    confs = np.concatenate([c.ravel() for c in seen])
    assert min(np.min(np.abs(confs - t)) for t in ths[:2]) >= EDGE
    assert sorted(got) == sorted(want) == list(range(len(PROMPT_LENS)))
    depths = set()
    for rid in want:
        assert got[rid]["tokens"] == want[rid]["tokens"], rid
        assert got[rid]["exit_depths"] == want[rid]["exit_depths"], rid
        np.testing.assert_allclose(got[rid]["confs"], want[rid]["confs"],
                                   rtol=F32, atol=F32)
        depths |= set(want[rid]["exit_depths"])
    assert depths == {0, 1, 2}
    assert eng.stats()["segments_run"] == jeng.stats()["segments_run"]
    assert eng.stats()["exit_histogram"] == jeng.stats()["exit_histogram"]


# ---------------------------------------------------------------------------
# losses, mask, schedules
# ---------------------------------------------------------------------------

def test_losses_match_reference(weights):
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 50, (2, 8)).astype(np.int32)
    full = (rng.standard_normal((2, 8, 50)) * 2).astype(np.float32)
    strided = (rng.standard_normal((2, 4, 50)) * 2).astype(np.float32)
    exits = [strided, strided[:, ::-1].copy(), full]   # stride 2, 2, 1
    aux = np.float32(0.37)
    for mode, kw in (("single", {}), ("single", {"head": 0}),
                     ("joint", {}), ("joint", {"joint_weights": (1, 2, 3)}),
                     ("joint", {"aux_coef": 0.1})):
        got = training.cascade_loss([_t(e) for e in exits], _t(labels), mode,
                                    aux=torch.tensor(aux), **kw)
        want = jtraining.cascade_loss([jnp.asarray(e) for e in exits],
                                      jnp.asarray(labels), mode,
                                      aux=jnp.asarray(aux), **kw)
        np.testing.assert_allclose(_np(got), _np(want), rtol=F32)
    with pytest.raises(ValueError):
        training.cascade_loss([_t(full)], _t(labels), "bogus")
    np.testing.assert_allclose(
        _np(training.cross_entropy(_t(full), _t(labels))),
        _np(jtraining.cross_entropy(jnp.asarray(full), jnp.asarray(labels))),
        rtol=F32)
    jparams, np_params, cfg = weights
    params = _port_params(np_params, cfg)
    for coef in (1e-4, 0.0):
        np.testing.assert_allclose(
            _np(training.l2_loss(params, coef)),
            _np(jtraining.l2_loss(jparams, coef)), rtol=F32)


def test_trainability_mask_on_the_llm_tree(weights):
    jparams, np_params, cfg = weights
    params = _port_params(np_params, cfg)
    plan = training.backtrack_training_plan(3)
    assert plan == [training.Phase(**dataclasses.asdict(p))
                    for p in jtraining.backtrack_training_plan(3)]
    for phase in plan:
        got = {utils.path_str(p): m for p, m in
               utils.tree_flatten_with_path(
                   training.trainability_mask(params, phase))}
        want = {jax_path_str(p): bool(m) for p, m in
                jax.tree_util.tree_leaves_with_path(
                    jtraining.trainability_mask(jparams, phase))}
        assert got == want
        assert any(got.values())


def _schedules(mod):
    return [mod.constant_schedule(0.3),
            mod.resnet_paper_schedule(0.1, 40),
            mod.resnet_paper_schedule(0.1, 40, warmup_steps=5),
            mod.cosine_schedule(0.2, 30),
            mod.warmup_cosine(0.2, 6, 30, final_frac=0.05)]


def test_schedules_match_reference_at_every_step():
    for got, want in zip(_schedules(sched), _schedules(jsched)):
        for step in range(45):
            g = got(step)
            assert isinstance(g, float)
            np.testing.assert_allclose(g, float(want(step)), rtol=F32)
            assert got(torch.tensor(step)) == g


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _opt_tree(rng):
    return {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": [rng.standard_normal((5,)).astype(np.float32),
                  rng.standard_normal((2, 2, 3)).astype(np.float32)],
            "c": rng.standard_normal((3,)).astype(np.float32)}


MASK = {"a": True, "b": [False, True], "c": False}


def _jmask(mask):
    return jax.tree_util.tree_map(jnp.asarray, mask)


def _run_opt(make, jmake, use_mask, steps=5):
    rng = np.random.default_rng(4)
    p0 = _opt_tree(rng)
    grads = [_opt_tree(rng) for _ in range(steps)]
    params = jax.tree_util.tree_map(_t, p0)
    jparams = jax.tree_util.tree_map(jnp.asarray, p0)
    o, jo = make(), jmake()
    state, jstate = o.init(params), jo.init(jparams)
    mask = MASK if use_mask else None
    for step, g in enumerate(grads):
        before = jax.tree_util.tree_map(torch.clone, (params, state))
        upd, state = o.update(jax.tree_util.tree_map(_t, g), state, params,
                              step, mask=mask)
        jupd, jstate = jo.update(jax.tree_util.tree_map(jnp.asarray, g),
                                 jstate, jparams, jnp.asarray(step),
                                 mask=_jmask(mask) if use_mask else None)
        params = opt.apply_updates(params, upd)
        jparams = jopt.apply_updates(jparams, jupd)
        for a, b in ((upd, jupd), (params, jparams), (state, jstate)):
            for x, y in zip(jax.tree_util.tree_leaves(a),
                            jax.tree_util.tree_leaves(b)):
                np.testing.assert_allclose(_np(x), _np(y), rtol=F32,
                                           atol=OPT_ATOL)
        if use_mask:     # frozen leaves and their moments keep their bits
            frozen = [("c",), ("b", 0)]
            for path in frozen:
                def at(t, path=path):
                    for k in path:
                        t = t[k]
                    return t
                assert torch.equal(at(upd), torch.zeros_like(at(upd)))
                assert torch.equal(at(params), at(before[0]))
                for key, moment in state.items():
                    if key != "count":
                        assert torch.equal(at(moment), at(before[1][key]))
    return state


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("use_mask", [False, True])
def test_sgd_momentum_matches_reference(nesterov, wd, use_mask):
    lr = sched.cosine_schedule(0.1, 5)
    _run_opt(lambda: opt.sgd_momentum(lr, nesterov=nesterov,
                                      weight_decay=wd),
             lambda: jopt.sgd_momentum(jsched.cosine_schedule(0.1, 5),
                                       nesterov=nesterov, weight_decay=wd),
             use_mask)


@pytest.mark.parametrize("use_mask", [False, True])
def test_adamw_matches_reference(use_mask):
    state = _run_opt(lambda: opt.adamw(1e-2), lambda: jopt.adamw(1e-2),
                     use_mask)
    assert state["count"].dtype == torch.int32 and int(state["count"]) == 5


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(2)
    g = _opt_tree(rng)
    for max_norm in (0.5, 100.0):
        got, gn = opt.clip_by_global_norm(jax.tree_util.tree_map(_t, g),
                                          max_norm)
        want, jgn = jopt.clip_by_global_norm(
            jax.tree_util.tree_map(jnp.asarray, g), max_norm)
        np.testing.assert_allclose(_np(gn), _np(jgn), rtol=F32)
        for x, y in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(_np(x), _np(y), rtol=F32,
                                       atol=OPT_ATOL)


# ---------------------------------------------------------------------------
# forward_train and the train step
# ---------------------------------------------------------------------------

def _tokens(seed=5, B=2, S=16):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 512, (B, S + 1)).astype(np.int32)


@pytest.mark.parametrize("stride", [1, 2])
def test_forward_train_matches_reference(weights, stride):
    _, np_params, _ = weights
    jcfg, cfg = _cfgs(cascade={"exit_loss_stride": stride})
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    toks = _tokens()[:, :-1]
    jl, jaux = jax_build_model(jcfg).forward_train(jparams,
                                                   jnp.asarray(toks))
    model = build_model(cfg, device="cpu")
    params = _port_params(np_params, cfg)
    with torch.no_grad():
        tl, aux = model.forward_train(params, _t(toks))
    assert [tuple(x.shape) for x in tl] == [
        (2, 16 // stride, 512), (2, 16 // stride, 512), (2, 16, 512)]
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(_np(a), _np(b), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
    assert float(aux) == float(jaux) == 0.0
    # remat recomputes each block in the backward: the same numbers
    grads = []
    for remat in (False, True):
        m = build_model(cfg.replace(remat=remat), device="cpu")
        p = _port_params(np_params, cfg)
        leaves = list(tree_leaves(p))
        for x in leaves:
            x.requires_grad_(True)
        lg, _ = m.forward_train(p, _t(toks))
        grads.append(torch.autograd.grad(sum(x.sum() for x in lg), leaves))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.fixture(scope="module")
def train_runs(weights):
    """Three AdamW train steps of each package from the same weights."""
    _, np_params, _ = weights
    jcfg, cfg = _cfgs(cascade={"exit_loss_stride": 2})
    stream = JaxStream(512, 16, 2, seed=3)
    batches = [next(stream) for _ in range(3)]
    jm = jax_build_model(jcfg)
    jo = jsteps.make_optimizer(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jstate = jo.init(jparams)
    jstep = jax.jit(jsteps.make_train_step(jm, jcfg, jo))
    jl = []
    for i, (x, y) in enumerate(batches):
        jparams, jstate, loss = jstep(jparams, jstate, jnp.asarray(i),
                                      {"tokens": jnp.asarray(x),
                                       "labels": jnp.asarray(y)})
        jl.append(float(loss))
    m = build_model(cfg, device="cpu")
    o = steps.make_optimizer(cfg)
    params = _port_params(np_params, cfg)
    state = o.init(params)
    step = steps.make_train_step(m, cfg, o)
    tl = []
    for i, (x, y) in enumerate(batches):
        params, state, loss = step(params, state, i,
                                   {"tokens": _t(x), "labels": _t(y)})
        tl.append(float(loss))
    return (jl, jparams, jstate), (tl, params, state)


def test_train_step_matches_reference(train_runs):
    (jl, jparams, jstate), (tl, params, state) = train_runs
    np.testing.assert_allclose(tl, jl, rtol=STEP_TOL)
    back = params_to_numpy(params)
    n = far = 0
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jparams),
                            jax.tree_util.tree_leaves(back)):
        diff = np.abs(b - _np(a))
        # a sign flip of a rounding-level gradient: at most 2 lr a step
        assert diff.max() <= FLIP_BOUND, jax_path_str(path)
        n, far = n + diff.size, far + int((diff > PARAM_TOL).sum())
    assert far <= n * FAR_SHARE, (far, n)
    assert int(state["count"]) == int(jstate["count"]) == 3


def test_use_kernels_is_refused(weights):
    _, np_params, _ = weights
    _, cfg = _cfgs(use_kernels=True)
    m = build_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="backward"):
        steps.make_train_step(m, cfg, steps.make_optimizer(cfg))
    with pytest.raises(NotImplementedError, match="backward"):
        m.forward_train(_port_params(np_params, cfg),
                        _t(_tokens()[:, :-1]))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _ckpt_tree(dtype):
    rng = np.random.default_rng(8)
    t = {"w": torch.from_numpy(rng.standard_normal((3, 4)).astype(
             np.float32)).to(dtype),
         "segs": [{"k": torch.arange(6, dtype=torch.float32).to(dtype)}],
         "n": torch.tensor(7, dtype=torch.int32)}
    return t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_round_trip_and_reference_format(tmp_path, dtype):
    tree = _ckpt_tree(dtype)
    ours = save_checkpoint(str(tmp_path / "port"), 12, tree)
    assert os.path.basename(ours) == "step_00000012.npz"
    assert latest_step(str(tmp_path / "port")) == 12
    like = jax.tree_util.tree_map(torch.zeros_like, tree)
    back = load_checkpoint(str(tmp_path / "port"), like)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert tree_digest(back) == tree_digest(tree)
    # the reference writes the same file: keys, dtypes, bytes
    jtree = jax.tree_util.tree_map(
        lambda t: jnp.asarray(utils.tensor_to_numpy(t)), tree)
    theirs = jax_save(str(tmp_path / "ref"), 12, jtree)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files) == ["n", "segs/0/k", "w"]
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes(), k
    # the reference's file loads into the port's tree, bit for bit
    back = load_checkpoint(str(tmp_path / "ref"), like)
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)))
    if dtype == torch.float32:      # and the port's into the reference's
        jback = jax_load(str(tmp_path / "port"), jtree)
        for a, b in zip(jax.tree_util.tree_leaves(jback),
                        jax.tree_util.tree_leaves(jtree)):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    with pytest.raises(KeyError):
        load_checkpoint(str(tmp_path / "port"), {**like, "extra": like["w"]})
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path / "port"), {**like, "w": like["n"]})


def test_bf16_bits_without_ml_dtypes(tmp_path):
    """The bridge and the checkpoint turn bf16 bits into numpy without
    ml_dtypes (the card's machine has none): run with it hidden."""
    code = f"""
import sys
sys.modules["ml_dtypes"] = None          # any import of it now fails
import numpy as np, torch
from repro_torch import bridge
from repro_torch.ckpt import load_checkpoint, save_checkpoint
from repro_torch.utils import numpy_to_tensor, tensor_to_numpy
t = torch.tensor([1.5, -2.25, 3e38, 1e-40]).to(torch.bfloat16)
a = bridge.params_to_numpy({{"x": t}})["x"]
assert a.dtype == np.dtype("V2"), a.dtype
assert a.tobytes() == t.view(torch.int16).numpy().tobytes()
assert torch.equal(numpy_to_tensor(a), t)
assert torch.equal(numpy_to_tensor(tensor_to_numpy(t), "cpu"), t)
save_checkpoint(r"{tmp_path}", 1, {{"x": t}})
back = load_checkpoint(r"{tmp_path}", {{"x": torch.zeros_like(t)}})
assert torch.equal(back["x"], t) and back["x"].dtype == torch.bfloat16
assert "ml_dtypes" not in [m for m in sys.modules if sys.modules[m]]
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok"
    # with ml_dtypes loaded (as JAX loads it), bf16 comes as its dtype
    import ml_dtypes
    t = torch.tensor([1.5]).to(torch.bfloat16)
    assert utils.tensor_to_numpy(t).dtype == ml_dtypes.bfloat16


# ---------------------------------------------------------------------------
# data and the CLI
# ---------------------------------------------------------------------------

def test_lm_stream_bit_for_bit():
    got, want = SyntheticLMStream(97, 12, 3, seed=4), JaxStream(97, 12, 3,
                                                                seed=4)
    assert got.next_tok.tobytes() == want.next_tok.tobytes()
    for _ in range(3):
        (x1, y1), (x2, y2) = next(got), next(want)
        assert x1.dtype == x2.dtype == np.int32
        assert x1.tobytes() == x2.tobytes() and y1.tobytes() == y2.tobytes()
    # shard_batch (slice 20): each leaf's batch dim over the batch axes of
    # a 1x1 gloo mesh, the tokens' bits kept
    from torch.distributed.tensor import DTensor, Replicate, Shard
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    made = not dist.is_initialized()
    try:
        mesh = make_host_mesh("cpu")
        placed = shard_batch({"tokens": x1, "labels": torch.as_tensor(y1)},
                             mesh)
        for name, want in (("tokens", x1), ("labels", y1)):
            got = placed[name]
            assert isinstance(got, DTensor)
            assert got.placements == (Shard(0), Replicate())
            assert got.to_local().numpy().tobytes() == want.tobytes()
        both = shard_batch({"tokens": x1}, mesh, batch_axes=("data",
                                                             "model"))
        assert both["tokens"].placements == (Shard(0), Shard(0))
    finally:
        if made:
            dist.destroy_process_group()


def test_train_cli_smoke_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen2.5-3b", "--smoke", "--steps", "6", "--device", "cpu",
           "--ckpt-dir", str(tmp_path), "--log-every", "2"]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["steps"] == 6 and len(summary["losses"]) == 6
    assert len(summary["step_ms"]) == 6
    assert summary["max_memory_allocated"] is None
    assert summary["checkpoint"].endswith("step_00000006.npz")
    # the checkpoint holds the trained params, bit for bit
    cfg = reduced(get_config("qwen2.5-3b"))
    like = build_model(cfg, device="cpu").init(0)
    assert tree_digest(load_checkpoint(str(tmp_path), like)) == \
        summary["params_digest"]
    with pytest.raises(SystemExit, match="multi-pod"):
        train_cli.main(["--arch", "qwen2.5-3b", "--multi-pod", "--device",
                        "cpu"])
