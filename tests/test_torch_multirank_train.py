"""Multi-rank training: the dense cascade's train step over a ``(data,
model)`` mesh of 2 and 4 ranks, against the JAX package.

Ranks are processes spawned here (a module-scoped pool, as in
``tests/test_torch_multirank.py``), joined over gloo through a
``FileStore`` under ``tmp_path``; what each runs is in
``tests/_multirank_ranks.py`` (no JAX there).  On the CPU every
collective takes the gloo backend and its plain version.  The model is
``reduced(qwen2.5-3b)`` in f32 (2 layers, d 256, 4 heads over 1 KV head
of 64 columns, vocab 512), its weights bridged from the JAX params, placed
by the training layout (``param_spec``, default mode: Megatron over
``model``, FSDP over ``data``).  At ``model`` 2 the KV head's 64 columns
split inside the head, so the K/V gather's reduce-scatter backward
carries every rank's partial gradient.  The step calls ``autograd.grad``
outside the active transport, as CUDA runs a backward on autograd's
device thread, so a backward or a remat recompute that read the active
transport would fail here too.

Tolerances: the first step's gradients, gathered whole, within
:data:`GRAD_TOL` normwise per leaf of ``jax.grad`` of the reference's
loss (f32 sums in other orders: row-parallel partial sums, the vocab
split's Σ exp); losses within :data:`LOSS_TOL` relative of the reference's
``make_train_step`` at each of three steps; the params after three AdamW
steps as ``test_torch_training.py`` holds them (a sign flip of a
rounding-level gradient moves a weight at most 2 lr a step).  Leaves
replicated over an axis are held bit for bit across its ranks.
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
from repro.models.model import build_model as jax_build_model
from repro.utils import path_str as jax_path_str
from repro_torch.configs import get_config, reduced
from repro_torch.core.training import cascade_loss, cross_entropy
from repro_torch.kernels import ref
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.shard_rules import axes_of
from repro_torch.launch.train import place_on_mesh

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
CE_TOL = 1e-6
PARAM_TOL = 1e-5
FAR_SHARE = 1e-3
FLIP_BOUND = 3 * 2 * 3e-4
B, S, STEPS = 4, 16, 3
RANK_TIMEOUT = 180
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
CASES = [(m, remat) for m in MESHES for remat in (True, False)]
IDS = [f"{m}-{'remat' if r else 'noremat'}" for m, r in CASES]


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


def _cfg(pkg="torch", remat=True):
    get, red = ((jax_get_config, jax_reduced) if pkg == "jax"
                else (get_config, reduced))
    return red(get("qwen2.5-3b")).replace(remat=remat)


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_reduce_scatter_over_gloo_equals_plain_version(pool, tmp_path,
                                                       sizes):
    """``Transport.reduce_scatter`` over each axis: rank r of a group ends
    with the bits of ``ref_reduce_scatter`` over the group's inputs in rank
    order (the all-reduce's row r), in f32 and bf16."""
    res = _spawn(pool, tmp_path, sizes, ranks.reduce_scatter_case, (11,))
    for axis in ("data", "model", "world"):
        groups = {}
        for r in res:
            key = tuple(v for a, v in sorted(r["coord"].items())
                        if a not in (axis, "world")) if axis != "world" \
                else ()
            groups.setdefault(key, []).append(r)
        for members in groups.values():
            members.sort(key=lambda r: r["coord"][axis])
            for i in range(2):
                parts = [m[axis]["inputs"][i] for m in members]
                for m in members:
                    want = ref.ref_reduce_scatter(parts, m["coord"][axis])
                    assert torch.equal(m[axis]["got"][i], want), (axis, i)
                    assert torch.equal(want, ref.ref_allreduce(parts)[
                        m["coord"][axis]])
    for r in res:
        for axis in ("data", "model", "world"):
            n = 2 if dict(zip(("data", "model"), sizes)).get(
                axis, sizes[0] * sizes[1]) > 1 else 0
            assert r["op_calls"].get(f"{axis}/reduce_scatter", 0) == n


@pytest.mark.parametrize("M", [2, 4])
def test_vocab_parallel_cross_entropy_matches_whole(pool, tmp_path, M):
    """Each ``model`` rank's slice of (3, 5, 64) logits: the loss equals
    ``cross_entropy`` of the whole logits and the slices' gradients joined
    equal its gradient, within CE_TOL; two collectives (max, then Σ exp
    and the label's logit together)."""
    rng = np.random.default_rng(M)
    logits = (rng.standard_normal((3, 5, 64)) * 3).astype(np.float32)
    labels = rng.integers(0, 64, (3, 5)).astype(np.int64)
    res = _spawn(pool, tmp_path, (1, M), ranks.ce_case, (logits, labels))
    x = torch.from_numpy(logits).requires_grad_(True)
    want = cross_entropy(x, torch.from_numpy(labels))
    (gw,) = torch.autograd.grad(want, [x])
    for r in res:
        np.testing.assert_allclose(float(r["loss"]), want.item(),
                                   rtol=CE_TOL)
        assert r["calls"] == {"model/max": 1, "model/sum": 1}
    got = torch.cat([r["grad"] for r in res], dim=-1)
    np.testing.assert_allclose(got, gw, rtol=CE_TOL, atol=CE_TOL)
    # with no model axis the loss is cross_entropy itself
    lg = torch.from_numpy(logits)
    assert torch.equal(cascade_loss([lg], torch.from_numpy(labels), "single"),
                       cross_entropy(lg, torch.from_numpy(labels)))


# ---------------------------------------------------------------------------
# the train step against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference():
    """The reference's weights (numpy), three batches, ``jax.grad`` of its
    cascade loss on the first, and three steps of its ``make_train_step``
    (losses, final params)."""
    jcfg = _cfg("jax")
    jm = jax_build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    stream = JaxStream(512, S, B, seed=3)
    batches = [tuple(np.asarray(a) for a in next(stream))
               for _ in range(STEPS)]

    def loss_fn(p, x, y):
        lg, aux = jm.forward_train(p, x)
        return jax_cascade_loss(lg, y, jcfg.cascade.loss_mode or "joint",
                                joint_weights=jcfg.cascade.joint_weights,
                                aux=aux, aux_coef=jcfg.router_aux_coef)
    x0, y0 = (jnp.asarray(a) for a in batches[0])
    loss0, grads = jax.value_and_grad(loss_fn)(jparams, x0, y0)
    jo = jsteps.make_optimizer(jcfg)
    jstate = jo.init(jparams)
    jstep = jax.jit(jsteps.make_train_step(jm, jcfg, jo))
    p, losses = jparams, []
    for i, (x, y) in enumerate(batches):
        p, jstate, loss = jstep(p, jstate, jnp.asarray(i),
                                {"tokens": jnp.asarray(x),
                                 "labels": jnp.asarray(y)})
        losses.append(float(loss))
    return {"np_params": np_params, "batches": batches,
            "loss0": float(loss0), "grads": grads, "losses": losses,
            "params": p}


@pytest.fixture(scope="module")
def mesh_runs(pool, tmp_path_factory, reference):
    """Each (mesh, remat) case's ranks' results, run at first use (the 1 x
    2 remat case also asks for the refusals)."""
    made = {}

    def get(mesh, remat):
        if (mesh, remat) not in made:
            refusals = mesh == "1x2" and remat
            made[mesh, remat] = _spawn(
                pool, tmp_path_factory.mktemp(f"{mesh}{remat}"),
                MESHES[mesh], ranks.train_case,
                (_cfg(remat=remat), reference["np_params"],
                 reference["batches"], refusals))
        return made[mesh, remat]
    return get


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.mark.parametrize("mesh,remat", CASES, ids=IDS)
def test_first_step_gradients_match_jax_grad(mesh_runs, reference, mesh,
                                             remat):
    """Every rank's first-step gradients, gathered whole, within GRAD_TOL
    normwise per leaf of ``jax.grad`` of the reference's cascade loss;
    the loss within LOSS_TOL; the step made collectives on each axis of
    more than one rank (a reduce-scatter on each: the K/V gather's
    backward over ``model``, FSDP's over ``data``)."""
    res = mesh_runs(mesh, remat)
    D, M = MESHES[mesh]
    for r in res:
        np.testing.assert_allclose(r["loss0"], reference["loss0"],
                                   rtol=LOSS_TOL)
        got = jax.tree_util.tree_leaves(r["grads"])
        want = _leaves(reference["grads"])
        assert len(got) == len(want)
        for (path, w), g in zip(want, got):
            w = np.asarray(w)
            assert g.shape == w.shape, jax_path_str(path)
            err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            assert err <= GRAD_TOL, (jax_path_str(path), err)
        calls = r["step_calls"]
        assert (calls.get("model/reduce_scatter", 0) > 0) == (M > 1)
        assert (calls.get("data/reduce_scatter", 0) > 0) == (D > 1)
        assert (calls.get("model/gather", 0) > 0) == (M > 1)


@pytest.mark.parametrize("mesh,remat", CASES, ids=IDS)
def test_three_steps_match_reference_train_step(mesh_runs, reference, mesh,
                                                remat):
    """Three AdamW steps: every rank's losses (the global mean) within
    LOSS_TOL of the reference's ``make_train_step``, its final params,
    gathered whole, as ``test_torch_training.py`` holds the one-rank
    port's, and the optimizer's step count 3."""
    res = mesh_runs(mesh, remat)
    for r in res:
        np.testing.assert_allclose(r["losses"], reference["losses"],
                                   rtol=LOSS_TOL)
        n = far = 0
        for (path, w), g in zip(_leaves(reference["params"]),
                                jax.tree_util.tree_leaves(r["whole"])):
            diff = np.abs(g - np.asarray(w))
            assert diff.max() <= FLIP_BOUND, jax_path_str(path)
            n, far = n + diff.size, far + int((diff > PARAM_TOL).sum())
        assert far <= n * FAR_SHARE, (far, n)
        assert r["count"] == STEPS


@pytest.mark.parametrize("mesh,remat", CASES, ids=IDS)
def test_replicated_leaves_have_the_same_bits_on_every_rank(mesh_runs, mesh,
                                                            remat):
    """After three steps, ranks whose coordinates agree on every axis a
    leaf is sharded over hold the same bits of it (the rank-ordered
    reductions), and ranks that differ there hold other shards."""
    res = mesh_runs(mesh, remat)
    n_leaves = len(res[0]["local"])
    replicated = 0
    for i in range(n_leaves):
        spec = res[0]["specs"][i]
        placed = {a for e in spec for a in axes_of(e)}
        groups = {}
        for r in res:
            key = tuple(r["coord"][a] for a in sorted(placed))
            groups.setdefault(key, []).append(r["local"][i])
        for members in groups.values():
            replicated += len(members) > 1
            for x in members[1:]:
                assert torch.equal(x, members[0]), (i, spec)
    assert replicated > 0


def test_refusals_name_what_is_missing(mesh_runs):
    """On a real 1 x 2 mesh the ssm and hybrid families are refused by
    name, and heads that ``model`` does not divide; a shape-only mesh of
    two ranks is refused before anything is placed."""
    got = mesh_runs("1x2", True)[0]["refused"]
    assert "NotImplementedError" in got["ssm"] and "recurrent" in got["ssm"]
    assert "NotImplementedError" in got["hybrid"] and "hybrid" in \
        got["hybrid"]
    assert "ValueError" in got["heads"] and "3 attention heads" in \
        got["heads"]
    with pytest.raises(NotImplementedError, match="shape-only mesh of 2 "
                       "ranks: multi-rank training"):
        place_on_mesh(AbstractMesh((2, 1), ("data", "model")), _cfg(), {})


@pytest.mark.parametrize("sizes,batch,enhance", [((2, 2), 4, 64),
                                                 ((2, 1), 3, 0)],
                         ids=["2x2-batch4-enhanced", "2x1-batch3"])
def test_train_entry_point_matches_one_rank(pool, tmp_path, sizes, batch,
                                            enhance):
    """``launch.train.train`` on a mesh against the same call with no
    mesh: losses within LOSS_TOL, the final params within the flip bound,
    the mesh in the summary.  On 2 x 2 the exits carry the paper's
    classifier enhancement (``enhance_dim`` 64: its column / row shards
    completed over ``model``).  A batch of 3 does not divide ``data`` 2:
    every rank then takes all the rows, as the reference replicates."""
    from repro_torch.bridge import params_to_numpy
    from repro_torch.launch.train import train
    cfg = _cfg().with_cascade(enhance_dim=enhance)
    params, _, one = train(cfg, torch.device("cpu"), STEPS, batch, S,
                           log_every=STEPS)
    res = _spawn(pool, tmp_path, sizes, ranks.train_entry_case,
                 (cfg, STEPS, batch, S))
    want = jax.tree_util.tree_leaves(params_to_numpy(params))
    for r in res:
        s = r["summary"]
        assert s["mesh"] == {"data": sizes[0], "model": sizes[1]}
        np.testing.assert_allclose(s["losses"], one["losses"],
                                   rtol=LOSS_TOL)
        for g, w in zip(jax.tree_util.tree_leaves(r["whole"]), want):
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= FLIP_BOUND


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_reduce_scatter_kernel_on_card():
    """``chip_smoke.py``'s multi-rank training check (a): the reduce-
    scatter kernel on 2 and 4 rank processes sharing the card, bf16 and
    f32, at 16 KB and past the buffer (64 MB), bit for bit against
    ``ref_reduce_scatter``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.kernels import build
    build.build_all()
    chip_smoke.phase_multirank_reduce_scatter()
