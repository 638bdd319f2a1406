"""Multi-rank MoE training: the moe family's train step over a ``(data,
model)`` mesh of 2 and 4 ranks, against the JAX package on one device.

Ranks are processes spawned here (the pool pattern of
``tests/test_torch_multirank_train.py``; what each runs is in
``tests/_multirank_ranks.py``, which imports no JAX).  The model is
``reduced(mixtral-8x7b)`` at 3 layers in f32 (d 256, 4 / 1 heads, d_ff
512, top 2, vocab 512) with 4 experts (expert parallel on a ``model``
axis of 2: 2 experts a rank) or 3 (the fallback: every expert's d_ff cut
in two), at capacity factor 0.5 (4 slots an expert against 8 average
pairs: pairs drop), its weights bridged from the JAX params and placed by
the training layout (Megatron over ``model``, FSDP over ``data``).
``GROUP_TOKENS`` is 16 in both packages (set here and in the rank
processes) and a batch is 4 x 10 tokens, so that the routing groups
straddle the data ranks' rows and the last group holds pad rows.

The layer's backward on the shards: the expert path's inputs through
``copy_to``, its completion through ``reduce_from``, and, where the batch
is split over ``data``, the whole call's aux loss from every rank's
router probabilities (``gather_from``: its reduce-scatter backward gives
each rank's probabilities D times the upstream gradient, which the step's
mean over ``data`` divides back).  One case trains at
``router_aux_coef`` 1.0, where a wrong scale of the aux gradient shows
plainly; a batch of 3 does not divide ``data`` 2, so every rank holds the
whole batch and routes it alone.

Tolerances as in ``tests/test_torch_multirank_train.py``: first-step
gradients, gathered whole, within :data:`GRAD_TOL` normwise per leaf of
``jax.grad`` of the reference's loss; losses within :data:`LOSS_TOL`
relative of its ``make_train_step`` at each of three steps; the final
params within the flip bound; leaves replicated over an axis (the router
over ``model``) bit for bit across its ranks.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core.training import cascade_loss as jax_cascade_loss
from repro.data.lm_pipeline import SyntheticLMStream as JaxStream
from repro.launch import steps as jsteps
from repro.models import moe as jax_moe
from repro.models.model import build_model as jax_build_model
from repro.utils import path_str as jax_path_str
from repro_torch.configs import get_config, reduced
from repro_torch.launch.shard_rules import axes_of

import _multirank_ranks as ranks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers
    on a few cores, where these small ops gain nothing from more threads
    and would slow the other workers' timed tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GRAD_TOL = 1e-5
LOSS_TOL = 1e-5
PARAM_TOL = 1e-5
FAR_SHARE = 1e-3
FLIP_BOUND = 3 * 2 * 3e-4
GROUP = 16
CF = 0.5
S, STEPS = 10, 3
RANK_TIMEOUT = 180
# name -> (mesh, experts, batch, router_aux_coef)
SETUPS = {
    "1x2": ((1, 2), 4, 4, 0.01),
    "1x2-fallback": ((1, 2), 3, 4, 0.01),
    "2x1": ((2, 1), 4, 4, 0.01),
    "2x2": ((2, 2), 4, 4, 0.01),
    "2x1-batch3": ((2, 1), 4, 3, 0.01),
    "2x2-aux1": ((2, 2), 4, 4, 1.0),
}
CASES = [(n, remat) for n in SETUPS for remat in (True, False)
         if n != "2x2-aux1" or remat]
IDS = [f"{n}-{'remat' if r else 'noremat'}" for n, r in CASES]


@pytest.fixture(scope="module")
def pool():
    """Four rank processes, spawned once for the module and fed one task a
    mesh (each imports torch and the port once)."""
    ctx = mp.get_context("spawn")
    tasks = [ctx.Queue() for _ in range(4)]
    results = ctx.Queue()
    procs = [ctx.Process(target=ranks.serve_tasks, daemon=True,
                         args=(r, tasks[r], results)) for r in range(4)]
    for p in procs:
        p.start()
    yield tasks, results
    for q in tasks:
        q.put(None)
    for p in procs:
        p.join(timeout=10)
        if p.is_alive():
            p.kill()


def _spawn(pool, tmp_path, sizes, target, args):
    """``target`` on every rank of a ``sizes`` mesh (the pool's first
    ranks); the ranks' results in rank order (an error or a rank past
    RANK_TIMEOUT fails the test)."""
    tasks, results = pool
    world = sizes[0] * sizes[1]
    init = os.path.join(str(tmp_path), f"store_{sizes[0]}x{sizes[1]}")
    for r in range(world):
        tasks[r].put((target, sizes, init, args))
    got = [results.get(timeout=RANK_TIMEOUT) for _ in range(world)]
    errors = [e for _, _, e in got if e is not None]
    assert not errors, errors[0]
    return [ranks.load(res) for _, res, _ in sorted(got, key=lambda g: g[0])]


def _cfg(pkg="torch", experts=4, coef=0.01, remat=True):
    get, red = ((jax_get_config, jax_reduced) if pkg == "jax"
                else (get_config, reduced))
    return red(get("mixtral-8x7b"), n_layers=3).replace(
        dtype="float32", n_experts=experts, capacity_factor=CF,
        router_aux_coef=coef, remat=remat)


@pytest.fixture(scope="module")
def group16():
    """The reference's routing groups at 16 tokens while the module runs
    (the ranks set the port's)."""
    mp_ = pytest.MonkeyPatch()
    mp_.setattr(jax_moe, "GROUP_TOKENS", GROUP)
    yield
    mp_.undo()


@pytest.fixture(scope="module")
def reference(group16):
    """For each (experts, batch, router_aux_coef), made at first use: the
    reference's seed-0 weights (numpy), three batches, ``jax.grad`` of its
    cascade loss on the first, and three steps of its ``make_train_step``
    (losses, final params)."""
    made = {}

    def get(experts, batch, coef):
        key = experts, batch, coef
        if key in made:
            return made[key]
        jcfg = _cfg("jax", experts, coef)
        jm = jax_build_model(jcfg)
        jparams = jm.init(jax.random.PRNGKey(0))
        stream = JaxStream(512, S, batch, seed=3)
        batches = [tuple(np.asarray(a) for a in next(stream))
                   for _ in range(STEPS)]

        def loss_fn(p, x, y):
            lg, aux = jm.forward_train(p, x)
            return jax_cascade_loss(lg, y, jcfg.cascade.loss_mode or "joint",
                                    joint_weights=jcfg.cascade.joint_weights,
                                    aux=aux, aux_coef=jcfg.router_aux_coef)
        x0, y0 = (jnp.asarray(a) for a in batches[0])
        loss0, grads = jax.jit(jax.value_and_grad(loss_fn))(jparams, x0, y0)
        jo = jsteps.make_optimizer(jcfg)
        jstate = jo.init(jparams)
        jstep = jax.jit(jsteps.make_train_step(jm, jcfg, jo))
        p, losses = jparams, []
        for i, (x, y) in enumerate(batches):
            p, jstate, loss = jstep(p, jstate, jnp.asarray(i),
                                    {"tokens": jnp.asarray(x),
                                     "labels": jnp.asarray(y)})
            losses.append(float(loss))
        made[key] = {"np_params": jax.tree_util.tree_map(np.asarray,
                                                         jparams),
                     "batches": batches, "loss0": float(loss0),
                     "grads": grads, "losses": losses, "params": p}
        return made[key]
    return get


@pytest.fixture(scope="module")
def mesh_runs(pool, tmp_path_factory, reference):
    """Each (setup, remat) case's ranks' results, run at first use (the 1 x
    2 remat case also asks for the refusals)."""
    made = {}

    def get(name, remat):
        if (name, remat) not in made:
            sizes, experts, batch, coef = SETUPS[name]
            ref = reference(experts, batch, coef)
            made[name, remat] = _spawn(
                pool, tmp_path_factory.mktemp(f"{name}{remat}"), sizes,
                ranks.moe_train_case,
                (_cfg(experts=experts, coef=coef, remat=remat),
                 ref["np_params"], ref["batches"], GROUP,
                 name == "1x2" and remat))
        return made[name, remat]
    return get


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.mark.parametrize("name,remat", CASES, ids=IDS)
def test_first_step_gradients_match_jax_grad(mesh_runs, reference, name,
                                             remat):
    """Every rank's first-step gradients, gathered whole, within GRAD_TOL
    normwise per leaf of ``jax.grad`` of the reference's cascade loss
    (the router's, the experts' and every leaf below the MoE layers'); the
    loss within LOSS_TOL.  The MoE layers complete over ``model`` where it
    has more than one rank, and a batch split over ``data`` gathers its
    routing over it (each of the 3 layers its chosen experts and its
    probabilities, past FSDP's one gather a leaf); a batch held whole by
    every rank makes no routing gather."""
    res = mesh_runs(name, remat)
    (D, M), experts, batch, coef = SETUPS[name]
    ref = reference(experts, batch, coef)
    split = batch % D == 0 and D > 1
    for r in res:
        got = jax.tree_util.tree_leaves(r["grads"])
        want = _leaves(ref["grads"])
        assert len(got) == len(want)
        errs = {}
        for (path, w), g in zip(want, got):
            w = np.asarray(w)
            assert g.shape == w.shape, jax_path_str(path)
            errs[jax_path_str(path)] = float(
                np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
        worst = max(errs, key=errs.get)
        loss_err = abs(r["loss0"] - ref["loss0"]) / abs(ref["loss0"])
        # the largest readings, named in the failure's message
        assert errs[worst] <= GRAD_TOL and loss_err <= LOSS_TOL, {
            "grad_leaf": worst, "grad_err": errs[worst],
            "loss_err": loss_err}
        calls = r["step_calls"]
        assert (calls.get("model/sum", 0) > 0) == (M > 1)
        fsdp = sum("data" in {a for e in s for a in axes_of(e)}
                   for s in r["specs"]) if D > 1 else 0
        routing = calls.get("data/gather", 0) - fsdp
        assert routing >= 2 * 3 if split else routing == 0, (routing, fsdp)
        assert not any("all_to_all" in k for k in calls)


@pytest.mark.parametrize("name,remat", CASES, ids=IDS)
def test_three_steps_match_reference_train_step(mesh_runs, reference, name,
                                                remat):
    """Three AdamW steps: every rank's losses (the global mean) within
    LOSS_TOL of the reference's ``make_train_step``, its final params,
    gathered whole, within the flip bound (a sign flip of a
    rounding-level gradient moves a weight at most 2 lr a step) and at
    most FAR_SHARE of them past PARAM_TOL, and the step count 3."""
    res = mesh_runs(name, remat)
    _, experts, batch, coef = SETUPS[name]
    ref = reference(experts, batch, coef)
    for r in res:
        loss_err = max(abs(a - b) / abs(b)
                       for a, b in zip(r["losses"], ref["losses"]))
        n = far = 0
        worst = 0.0
        for (path, w), g in zip(_leaves(ref["params"]),
                                jax.tree_util.tree_leaves(r["whole"])):
            diff = np.abs(g - np.asarray(w))
            worst = max(worst, float(diff.max()))
            n, far = n + diff.size, far + int((diff > PARAM_TOL).sum())
        # the largest readings, named in the failure's message
        assert (loss_err <= LOSS_TOL and worst <= FLIP_BOUND
                and far <= n * FAR_SHARE), {
            "loss_err": loss_err, "param_err": worst,
            "param_far_share": far / n}
        assert r["count"] == STEPS


@pytest.mark.parametrize("name,remat", CASES, ids=IDS)
def test_replicated_leaves_have_the_same_bits_on_every_rank(mesh_runs, name,
                                                            remat):
    """After three steps, ranks whose coordinates agree on every axis a
    leaf is sharded over hold the same bits of it; the router, replicated
    over ``model``, among them where that axis has two ranks; an expert
    leaf holds E/M experts (or every expert's d_ff/M columns)."""
    res = mesh_runs(name, remat)
    (D, M), experts, _, _ = SETUPS[name]
    compared = set()
    for i, spec in enumerate(res[0]["specs"]):
        placed = {a for e in spec for a in axes_of(e)}
        groups = {}
        for r in res:
            key = tuple(r["coord"][a] for a in sorted(placed))
            groups.setdefault(key, []).append(r["local"][i])
        for members in groups.values():
            if len(members) > 1:
                compared.add(res[0]["paths"][i])
            for x in members[1:]:
                assert torch.equal(x, members[0]), (res[0]["paths"][i], spec)
    routers = {p for p in res[0]["paths"] if p.endswith("moe/router")}
    assert routers
    if M > 1:
        assert routers <= compared
    for p, x, spec in zip(res[0]["paths"], res[0]["local"],
                          res[0]["specs"]):
        if p.endswith("moe/w_up") and M > 1:
            # (layers, E, d, ff): E cut where M divides it, else ff
            on_model = [d for d, e in enumerate(spec)
                        if "model" in axes_of(e)]
            assert on_model == [1 if experts % M == 0 else 3], spec


def test_moe_refusals_name_what_is_missing(mesh_runs):
    """On a real 1 x 2 mesh a ``model`` axis that divides neither the
    experts nor d_ff is refused (ValueError), and training with
    ``use_kernels`` is (no kernel has a backward)."""
    got = mesh_runs("1x2", True)[0]["refused"]
    assert got["split"].startswith("ValueError") and \
        "3 experts nor their 511 MLP columns" in got["split"]
    assert got["kernels"].startswith("NotImplementedError") and \
        "use_kernels" in got["kernels"]
