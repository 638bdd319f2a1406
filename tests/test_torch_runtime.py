"""The port's device decode runtime: ``CascadeServingEngine(...,
runtime="device", chunk=K)`` and :class:`DeviceDecodeLoop` against the
port's host runtime and against the JAX package's device runtime, on
bridged weights.

Settings: ``reduced(qwen2.5-3b)`` (2 layers, 2 components), f32, kernels
on (their plain versions on the CPU), 2 lanes of 2 slots, cache_len 32,
chunk 4 — those of the JAX package's ``tests/test_runtime.py``; the
comparison with the JAX engine takes ``tests/test_torch_engine.py``'s
settings (3 layers, 3 components, six requests for four slots).  Token and
exit streams and the carried ``segments_run`` must be identical (ints
exactly); confidences agree to 1e-5 (f32 sums in other orders).  The
``cuda`` tests need a card and skip here: on the card the loop replays a
captured CUDA graph, with the cond_batch skips as conditional nodes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.launch.steps import make_serve_step as jax_serve_step
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import CascadeServingEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch import kernels
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import AbstractMesh, make_host_mesh
from repro_torch.launch.shard_rules import (cache_spec, decode_state_spec,
                                            param_spec, place, to_local)
from repro_torch.launch.steps import (make_decode_loop_step,
                                      make_decode_state, make_prefill_step,
                                      make_serve_step)
from repro_torch.models import nn
from repro_torch.models.model import build_model
from repro_torch.serving.engine import CascadeServingEngine, Request
from repro_torch.serving.runtime import (DecodeChunk, DeviceDecodeLoop,
                                         kernel_provenance)


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
BUDGETS = (3, 5, 4, 6)
# component 0's threshold near the median of its decode confidences on
# these weights: about half the tokens exit there, the rest run deeper
MID = (0.025, 0.0)
# tests/test_torch_engine.py's settings and its mixed threshold vector
ENGINE_LENS = (128, 128, 128, 128, 37, 100)
MIXED = (0.0365, 0.0375, 0.0)


def _tiny(pkg="torch", **cascade):
    get, red = ((jax_get_config, jax_reduced) if pkg == "jax"
                else (get_config, reduced))
    cfg = red(get("qwen2.5-3b")).replace(dtype="float32")
    if pkg == "torch":
        cfg = cfg.replace(use_kernels=True)
    return cfg.with_cascade(**cascade)


@pytest.fixture(scope="module")
def weights():
    jparams = jax_build_model(_tiny("jax")).init(jax.random.PRNGKey(0))
    return jparams, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), _tiny(), device="cpu")


def _prompts(vocab, n=4, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, 6).astype(np.int32) for _ in range(n)]


def _run(cfg, params, runtime, budgets=BUDGETS, chunk=4, **kw):
    kw = {"lane_batch": 2, "n_lanes": 2, "cache_len": 32, **kw}
    eng = CascadeServingEngine(cfg, build_model(cfg, device="cpu"), params,
                               runtime=runtime, chunk=chunk, device="cpu",
                               **kw)
    for i, p in enumerate(_prompts(cfg.vocab_size, len(budgets))):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=budgets[i]))
    eng.run(100)
    return eng


def _carried(eng):
    return np.sum([ln["state"].segments_run for ln in eng.lanes], axis=0)


def _assert_same_streams(h, d, budgets=BUDGETS):
    assert h.finished.keys() == d.finished.keys()
    for rid in h.finished:
        assert h.finished[rid]["tokens"] == d.finished[rid]["tokens"], rid
        assert (h.finished[rid]["exit_depths"]
                == d.finished[rid]["exit_depths"]), rid
        assert h.finished[rid]["confs"] == d.finished[rid]["confs"], rid
        assert len(d.finished[rid]["tokens"]) == budgets[rid]
    np.testing.assert_array_equal(_carried(h), _carried(d))


# ---------------------------------------------------------------------------
# host runtime == device runtime, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("measure", ["softmax_max", "patience@2"])
def test_device_runtime_matches_host_engine(weights, measure):
    """The port of the reference's acceptance test: cond_batch, 2 cohorts,
    chunk 4, budgets 3/5/4/6 — identical tokens and exit indices for every
    request, and identical real execution (the carried counters cover every
    step; each runtime's stats window leaves out its own warm-up
    dispatch)."""
    _, params = weights
    cfg = _tiny(thresholds=MID, exit_mode="cond_batch", n_cohorts=2,
                confidence=measure)
    h, d = _run(cfg, params, "host"), _run(cfg, params, "device")
    _assert_same_streams(h, d)
    st = d.stats()
    assert st["wallclock_us_per_token"] > 0
    assert st["runtime"] == "device" and st["chunk"] == 4
    assert h.stats()["chunk"] == 1


@pytest.mark.parametrize("mode", ["cond_batch", "select"])
@pytest.mark.parametrize("cohorts", [1, 2])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_device_runtime_matches_host_runtime(weights, layout, cohorts,
                                             mode):
    _, params = weights
    cfg = _tiny(thresholds=MID, exit_mode=mode, n_cohorts=cohorts)
    if layout == "paged":
        cfg = cfg.with_paged_cache(layout="paged", block_size=8)
    h, d = _run(cfg, params, "host"), _run(cfg, params, "device")
    _assert_same_streams(h, d)
    if layout == "paged":
        assert d.stats()["memory"]["blocks_used"] == 0
    # a CPU lane reads its branches for free: no host sync is counted
    assert d.stats()["host_syncs"] == 0
    if mode == "cond_batch":
        assert h.stats()["host_syncs"] > h.stats()["decode_dispatches"]


# ---------------------------------------------------------------------------
# the port's device runtime against the JAX package's
# ---------------------------------------------------------------------------

def _engine_cascade(ths):
    return dict(n_components=3, exit_boundaries=(1, 2), thresholds=ths,
                exit_mode="cond_batch")


@pytest.fixture(scope="module")
def engine_weights():
    jcfg = jax_reduced(jax_get_config("qwen2.5-3b"), n_layers=3) \
        .with_cascade(**_engine_cascade((0.9, 0.9, 0.0)))
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = reduced(get_config("qwen2.5-3b"), n_layers=3).with_cascade(
        **_engine_cascade((0.9, 0.9, 0.0)))
    return jparams, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")


def _engine_requests(make):
    rng = np.random.default_rng(11)
    return [make(i, rng.integers(0, 512, size=n).astype(np.int32), 6)
            for i, n in enumerate(ENGINE_LENS)]


@pytest.mark.parametrize("ths", [(0.0, 0.0, 0.0), (1.1, 1.1, 0.0), MIXED],
                         ids=["all-exit-0", "full-depth", "mixed"])
def test_device_runtime_matches_reference_device_runtime(engine_weights,
                                                         ths):
    """Both packages' ``runtime="device"`` engines, chunk 8, on six
    requests for four slots (the queued two admit at chunk boundaries in
    both).  The JAX engine runs its plain route (its Pallas kernels would
    run interpreted inside the while loop); kernels on and off agree on
    ints by contract, and the mixed vector lies 1e-3 from every confidence
    (tests/test_torch_engine.py)."""
    jparams, params = engine_weights
    kw = dict(lane_batch=2, n_lanes=2, cache_len=256, runtime="device",
              chunk=8)
    jcfg = jax_reduced(jax_get_config("qwen2.5-3b"), n_layers=3) \
        .with_cascade(**_engine_cascade(ths))
    jeng = JaxEngine(jcfg, jax_build_model(jcfg), jparams, **kw)
    for r in _engine_requests(lambda i, p, n: JaxRequest(
            rid=i, prompt=p, max_new_tokens=n)):
        jeng.submit(r)
    want, want_st = jeng.run(max_ticks=500), jeng.stats()
    cfg = reduced(get_config("qwen2.5-3b"), n_layers=3).replace(
        use_kernels=True).with_cascade(**_engine_cascade(ths))
    eng = CascadeServingEngine(cfg, build_model(cfg, device="cpu"), params,
                               device="cpu", **kw)
    for r in _engine_requests(lambda i, p, n: Request(
            rid=i, prompt=p, max_new_tokens=n)):
        eng.submit(r)
    got, got_st = eng.run(max_ticks=500), eng.stats()
    assert sorted(got) == sorted(want) == list(range(len(ENGINE_LENS)))
    for rid in want:
        assert got[rid]["tokens"] == want[rid]["tokens"], rid
        assert got[rid]["exit_depths"] == want[rid]["exit_depths"], rid
        assert got[rid]["lane"] == want[rid]["lane"], rid
        np.testing.assert_allclose(got[rid]["confs"], want[rid]["confs"],
                                   atol=CONF_TOL, rtol=CONF_TOL)
    for key in ("segments_run", "exit_histogram", "admission_wait_ticks",
                "chunk"):
        assert got_st[key] == want_st[key], key
    for jl, tl in zip(jeng.lanes, eng.lanes):
        np.testing.assert_array_equal(np.asarray(jl["state"].segments_run),
                                      tl["state"].segments_run)
        assert int(jl["state"].t) == int(tl["state"].t) == tl["t"]


# ---------------------------------------------------------------------------
# DeviceDecodeLoop.run_chunk and the step builders
# ---------------------------------------------------------------------------

def _prefilled(params, cfg, B=2, cache_len=32):
    model = build_model(cfg, device="cpu")
    prefill = make_prefill_step(model, cfg)
    toks = torch.as_tensor(np.stack(_prompts(cfg.vocab_size, B)))
    pred, _, _, cache, state = prefill(params, toks,
                                       model.init_cache(B, cache_len))
    return model, pred, cache, state


def test_run_chunk_trims_to_the_steps_that_ran(weights):
    _, params = weights
    cfg = _tiny(thresholds=(0.6, 0.0), exit_mode="cond_batch")
    model, pred, cache, state = _prefilled(params, cfg)
    # the same steps through the serve step, for the expected streams
    _, _, cache2, state2 = _prefilled(params, cfg)
    serve_step = make_serve_step(model, cfg)
    tok = pred[:, None]
    want = []
    for _ in range(6):
        p, e, c, cache2, state2 = serve_step(params, tok, cache2, state2)
        want.append((p.numpy().copy(), e.numpy().copy(), c.numpy().copy()))
        tok = p[:, None]
    loop = DeviceDecodeLoop(model, cfg, chunk=4, cache_len=32)
    # budgets 2 and 5: slot 0 drains after 2 steps, the chunk runs 4
    ch, cache, state = loop.run_chunk(params, pred.numpy()[:, None], cache,
                                      state, np.array([2, 5], np.int32))
    assert isinstance(ch, DecodeChunk) and ch.compiled
    assert ch.n_steps == 4
    for arr in (ch.tokens, ch.exits, ch.confs, ch.live):
        assert arr.shape == (4, 2)
    np.testing.assert_array_equal(ch.live, [[1, 1], [1, 1], [0, 1], [0, 1]])
    np.testing.assert_array_equal(ch.remaining, [0, 1])
    for i in range(4):
        np.testing.assert_array_equal(ch.tokens[i, 1], want[i][0][1])
        np.testing.assert_array_equal(ch.exits[i, 1], want[i][1][1])
        assert ch.confs[i, 1] == want[i][2][1]
    np.testing.assert_array_equal(ch.tokens[:2, 0], [w[0][0] for w in want[:2]])
    assert int(state.t) == ch.t == 6 + 4
    assert state.active.tolist() == [False, True]
    # the budget ends after one more step: n_steps < K
    ch2, _, state = loop.run_chunk(params, ch.tokens[-1][:, None], cache,
                                   state, ch.remaining)
    assert not ch2.compiled and ch2.n_steps == 1 < loop.chunk
    assert ch2.tokens.shape == (1, 2)
    np.testing.assert_array_equal(ch2.live, [[0, 1]])
    assert ch2.tokens[0, 1] == want[4][0][1]
    np.testing.assert_array_equal(ch2.remaining, [0, 0])
    assert not state.active.any()
    assert loop.captures == 0 and loop.host_syncs == 0


def test_decode_loop_refuses_bad_arguments(weights):
    _, params = weights
    cfg = _tiny(thresholds=(0.6, 0.0))
    model = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        DeviceDecodeLoop(model, cfg, chunk=0)
    # a shape-only mesh of more than one rank: multi-rank serving runs on
    # a DeviceMesh of that many processes (make_mesh), never on one
    with pytest.raises(NotImplementedError, match="2 ranks: multi-rank"):
        DeviceDecodeLoop(model, cfg, chunk=4,
                         mesh=AbstractMesh((2, 1), ("data", "model")))
    # autotune (slice 9): telemetry counters and a live f32 δ̂ vector
    tuned = make_decode_state(cfg.with_autotune(enabled=True, bins=8), 2,
                              device="cpu")
    assert tuned.tel.conf_hist.shape == (2, 8)
    assert tuned.thresholds.dtype == torch.float32
    assert tuned.thresholds.tolist() == [0.6000000238418579, 0.0]
    st = make_decode_state(cfg, 2, t=5, device="cpu")
    assert st.tel is None and st.thresholds is None
    assert st.t.dtype == torch.int32 and st.t.dim() == 0 and int(st.t) == 5
    assert kernel_provenance(cfg, "cpu") == {"kernel_backend": "torch-cpu",
                                            "kernel_platform": "cpu"}
    assert kernel_provenance(cfg.replace(use_kernels=False),
                             "cpu")["kernel_backend"] == "off"


# ---------------------------------------------------------------------------
# the carry through a 1x1 device mesh (the reference's tests of the loop
# and of the serve step under jit with mesh shardings)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_mesh():
    """The 1x1 gloo mesh; the process group is destroyed after the module
    if this fixture made it."""
    import torch.distributed as dist
    made = not dist.is_initialized()
    mesh = make_host_mesh("cpu")
    yield mesh
    if made:
        dist.destroy_process_group()


def test_decode_loop_state_survives_jit_and_mesh_sharding(weights,
                                                           host_mesh):
    """A patience@2 config through the device loop on the 1x1 mesh:
    streaks, cursor and cache ride the carry placed by the shard rules;
    per-slot budgets end the chunk early; the streams equal the loop's
    with no mesh, and placing copied nothing."""
    from torch.distributed.tensor import DTensor
    _, params = weights
    cfg = _tiny(confidence="patience@2", thresholds=(0.0, 0.0),
                exit_mode="cond_batch")
    out = {}
    for which, mesh in (("none", None), ("mesh", host_mesh)):
        model, pred, cache, state = _prefilled(params, cfg)
        loop = DeviceDecodeLoop(model, cfg, chunk=8, cache_len=32,
                                mesh=mesh)
        chunk, cache, state = loop.run_chunk(
            params, pred.numpy()[:, None], cache, state,
            remaining=np.array([3, 5], np.int32))
        assert chunk.compiled and loop.compile_seconds > 0
        assert chunk.n_steps == 5              # ended early: budgets spent
        assert chunk.live[:3, 0].all() and not chunk.live[3:, 0].any()
        assert chunk.live[:, 1].all()
        np.testing.assert_array_equal(chunk.remaining, [0, 0])
        # the patience streak seeded at prefill survived into the loop:
        # with threshold 0 and k = 2 every decode step exits at component
        # 0, reachable only if the carried streaks were not re-initialised
        assert (chunk.exits[chunk.live] == 0).all()
        assert int(state.t) == 6 + 5
        assert int(state.policy[0].min()) >= 2
        assert not state.active.any()
        # a drained lane no-ops (0 iterations) and places nothing again
        chunk2, cache, state = loop.run_chunk(
            params, chunk.tokens[-1:].T, cache, state, remaining=[0, 0])
        assert chunk2.n_steps == 0 and not chunk2.compiled
        assert chunk2.tokens.shape == (0, 2)
        out[which] = (chunk, loop)
    (a, _), (b, loop) = out["none"], out["mesh"]
    for name in ("tokens", "exits", "confs", "live"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert len(out["none"][1].placed) == 0 and len(loop.placed) == 1
    p_placed, c_placed, s_placed = next(iter(loop.placed.values()))
    assert isinstance(p_placed["embed"], DTensor)
    assert isinstance(s_placed.policy, DTensor)
    assert p_placed["embed"].to_local().data_ptr() == \
        params["embed"].data_ptr()


def test_patience_serve_step_state_survives_jit_and_sharding(weights,
                                                             host_mesh):
    """A patience@k config serves through the launch step with its
    params, cache and DecodeState placed on the 1x1 mesh by the shard
    rules, the step running on their local tensors: the streak reaches k
    at the first decode step and stays satisfied only because the carried
    state survived; the exits and tokens equal the unplaced run's."""
    _, params = weights
    cfg = _tiny(confidence="patience@2", thresholds=(0.0, 0.0))
    runs = {}
    for placed in (False, True):
        model = build_model(cfg, device="cpu")
        toks = torch.as_tensor(np.stack(_prompts(cfg.vocab_size, 2)))
        cache = model.init_cache(2, 32)
        _, exit0, _, cache, state = make_prefill_step(model, cfg)(
            params, toks, cache)
        assert int(exit0.max()) == 1      # streak 1 < k: the final answers
        p = params
        if placed:
            trees = (place(host_mesh, params,
                           param_spec(params, cfg, host_mesh)),
                     place(host_mesh, cache,
                           cache_spec(cache, cfg, host_mesh, 2)),
                     place(host_mesh, state,
                           decode_state_spec(state, cfg, host_mesh, 2)))
            own = state.policy
            p, cache, state = to_local(trees)
            assert state.policy.data_ptr() == own.data_ptr()
        serve = make_serve_step(model, cfg)
        token = torch.zeros((2, 1), dtype=torch.int32)
        got = []
        for _ in range(3):
            tok, exit_idx, _, cache, state = serve(p, token, cache, state)
            got.append((tok.tolist(), exit_idx.tolist()))
            token = tok[:, None]
        assert [max(e) for _, e in got] == [0, 0, 0]
        assert int(state.policy[0].min()) >= 2
        assert int(state.t) == toks.shape[1] + 3
        runs[placed] = got
    assert runs[True] == runs[False]


def test_device_runtime_on_a_mesh_matches_no_mesh(weights, host_mesh):
    """The engine's device runtime with ``mesh=`` the 1x1 mesh: every
    lane's carry placed once, the streams and carried segments_run equal
    the ``mesh=None`` engine's; the host runtime refuses a mesh with the
    reference's error."""
    _, params = weights
    cfg = _tiny(thresholds=MID, exit_mode="cond_batch", n_cohorts=2)
    plain = _run(cfg, params, "device")
    meshed = _run(cfg, params, "device", mesh=host_mesh)
    _assert_same_streams(plain, meshed)
    assert len(meshed.loop.placed) == 2 and not plain.loop.placed
    with pytest.raises(ValueError, match="runtime='device'"):
        _run(cfg, params, "host", mesh=host_mesh)


def test_loop_step_matches_serve_steps(weights):
    """make_decode_loop_step called directly (eagerly) gives the serve
    step's streams, its buffers (chunk, B) with the rows past n_steps
    zero."""
    _, params = weights
    cfg = _tiny(thresholds=(0.6, 0.0), exit_mode="cond_batch", n_cohorts=2)
    model, pred, cache, state = _prefilled(params, cfg, B=2)
    _, _, cache2, state2 = _prefilled(params, cfg, B=2)
    loop_step = make_decode_loop_step(model, cfg, chunk=5, cache_len=32)
    toks, exits, confs, live, n, cache, state, rem = loop_step(
        params, pred[:, None], cache, state, np.array([3, 3], np.int32))
    assert int(n) == 3 and toks.shape == (5, 2)
    assert not toks[3:].any() and not live[3:].any()
    serve_step = make_serve_step(model, cfg)
    tok = pred[:, None]
    for i in range(3):
        p, e, c, cache2, state2 = serve_step(params, tok, cache2, state2)
        assert torch.equal(toks[i], p) and torch.equal(exits[i], e)
        assert torch.equal(confs[i], c)
        tok = p[:, None]
    np.testing.assert_array_equal(state.segments_run, state2.segments_run)
    assert rem.tolist() == [0, 0]


def test_decode_step_with_device_position_matches_reference(weights):
    """The serve step carries t as a 0-d int32 tensor; its outputs and
    carried state equal the JAX serve step's."""
    jparams, params = weights
    kw = dict(thresholds=(0.6, 0.0), exit_mode="cond_batch",
              confidence="patience@2")
    cfg, jcfg = _tiny(**kw), _tiny("jax", **kw)
    model, jmodel = build_model(cfg, device="cpu"), jax_build_model(jcfg)
    toks = np.stack(_prompts(cfg.vocab_size, 2))
    pred, _, _, cache, state = make_prefill_step(model, cfg)(
        params, torch.as_tensor(toks), model.init_cache(2, 32))
    jpred, _, _, jcache, jstate = jax_prefill_step(jmodel, jcfg)(
        jparams, jnp.asarray(toks), jmodel.init_cache(2, 32), None)
    step, jstep = make_serve_step(model, cfg), jax.jit(
        jax_serve_step(jmodel, jcfg))
    tok, jtok = pred[:, None], jpred[:, None]
    for _ in range(5):
        assert isinstance(state.t, torch.Tensor) and state.t.dim() == 0
        assert state.t.dtype == torch.int32
        assert int(state.t) == int(jstate.t)
        p, e, c, cache, state = step(params, tok, cache, state)
        jp, je, jc, jcache, jstate = jstep(jparams, jtok, jcache, jstate,
                                           None)
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(e.numpy(), np.asarray(je))
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=CONF_TOL,
                                   rtol=CONF_TOL)
        tok, jtok = p[:, None], jp[:, None]
    np.testing.assert_array_equal(state.segments_run,
                                  np.asarray(jstate.segments_run))
    np.testing.assert_array_equal(state.policy.numpy(),
                                  np.asarray(jstate.policy))
    np.testing.assert_array_equal(cache["kpos"].numpy(),
                                  np.asarray(jcache["kpos"]))


def test_decode_attention_plain_versions_take_a_device_position():
    """The decode attention's plain version and its split-KV emulator
    take t as the carried 0-d int32 tensor, with the int's results."""
    from repro_torch.kernels.ref import (ref_decode_attention,
                                        ref_decode_attention_split)
    g = torch.Generator().manual_seed(0)
    B, H, KV, hd, W = 2, 4, 2, 32, 64
    q = torch.randn(B, H, hd, generator=g)
    k, v = (torch.randn(B, W, KV, hd, generator=g) for _ in range(2))
    kpos = torch.arange(W, dtype=torch.int32) - 10
    for t in (20, 50):
        t_dev = torch.full((), t, dtype=torch.int32)
        for fn in (ref_decode_attention, ref_decode_attention_split):
            assert torch.equal(fn(q, k, v, t_dev, kpos, window=16),
                               fn(q, k, v, t, kpos, window=16))


@pytest.mark.parametrize("runtime", ["host", "device"])
def test_compile_time_reported_separately(weights, runtime):
    """Each runtime's first decode dispatch (the device runtime's capture,
    on a card) lands in ``compile_seconds`` and outside every window
    metric, the per-dispatch spread included; reset_metrics keeps it."""
    _, params = weights
    cfg = _tiny(thresholds=(0.6, 0.0), exit_mode="cond_batch")
    eng = _run(cfg, params, runtime, budgets=(6, 6), n_lanes=1)
    st = eng.stats()
    assert st["compile_seconds"] > 0
    assert st["wallclock_us_per_token"] > 0
    # 5 decode steps a slot after the prefill's token: the warm-up dispatch
    # (1 step on the host runtime, a chunk of 4 on the device runtime) is
    # left out of the window
    first = 1 if runtime == "host" else 4
    assert st["decode_tokens"] == 2 * (5 - first)
    assert st["decode_dispatches"] == (4 if runtime == "host" else 1)
    # the window's dispatches, each timed: (min, median, max)
    spread = st["dispatch_spread"]
    assert spread["n"] == st["decode_dispatches"]
    for key in ("ms", "us_per_token"):
        lo, mid, hi = spread[key]
        assert 0 < lo <= mid <= hi
    eng.reset_metrics()
    assert eng.stats()["compile_seconds"] == st["compile_seconds"]
    assert eng.stats()["decode_tokens"] == 0
    assert eng.stats()["dispatch_spread"] is None


# ---------------------------------------------------------------------------
# on the card: the captured graph
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the captured decode graph runs only "
                    "there")
    from repro_torch.utils import resolve_device
    return resolve_device("cuda")


def _card_run(cfg, params, runtime, dev):
    eng = CascadeServingEngine(cfg, build_model(cfg, device=dev), params,
                               lane_batch=2, n_lanes=2, cache_len=32,
                               runtime=runtime, chunk=4, device=dev)
    for i, p in enumerate(_prompts(cfg.vocab_size)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=BUDGETS[i]))
    kernels.reset_launch_counts()
    eng.run(100)
    return eng, kernels.launch_snapshot()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cond_batch", "select"])
def test_graph_replays_match_eager_bits_on_card(weights, cuda_device, mode):
    """The device runtime's replays give the host runtime's (eager) bits:
    streams, confidences and carried counters, with one capture per lane
    and one host sync per lane chunk."""
    _, params = weights
    params = nn.tree_map(lambda x: x.to(cuda_device), params)
    cfg = _tiny(thresholds=MID, exit_mode=mode, n_cohorts=2)
    h, _ = _card_run(cfg, params, "host", cuda_device)
    d, _ = _card_run(cfg, params, "device", cuda_device)
    _assert_same_streams(h, d)
    st = d.stats()
    assert st["captures"] == 2
    assert st["host_syncs"] == st["decode_dispatches"]


@pytest.mark.cuda
def test_no_sync_during_replays_on_card(weights, cuda_device):
    """With ``sync_check`` every replay of a chunk runs under sync debug
    mode "error" (``run_chunk`` sets it around the replays and the result
    copy, then restores the caller's mode): a chunk that synced would
    raise.  Two chunks of one lane reuse its capture."""
    _, params = weights
    params = nn.tree_map(lambda x: x.to(cuda_device), params)
    cfg = _tiny(thresholds=MID, exit_mode="cond_batch", n_cohorts=2)
    model = build_model(cfg, device=cuda_device)
    prefill = make_prefill_step(model, cfg)
    toks = torch.as_tensor(np.stack(_prompts(cfg.vocab_size, 2)),
                           device=cuda_device)
    pred, _, _, cache, state = prefill(params, toks,
                                       model.init_cache(2, 32))
    loop = DeviceDecodeLoop(model, cfg, chunk=4, cache_len=32)
    loop.sync_check = True
    token = pred.cpu().numpy()[:, None]
    torch.cuda.set_sync_debug_mode("warn")
    try:
        ch, cache, state = loop.run_chunk(params, token, cache, state,
                                          np.array([6, 6]))
        assert torch.cuda.get_sync_debug_mode() == 1
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ch2, cache, state = loop.run_chunk(params, ch.tokens[-1][:, None], cache,
                                       state, ch.remaining)
    assert ch.compiled and not ch2.compiled
    assert ch.n_steps == 4 and ch2.n_steps == 2
    assert loop.captures == 1 and loop.host_syncs == 2


@pytest.mark.cuda
def test_replay_launch_counts_equal_host_runtime_on_card(weights,
                                                         cuda_device):
    """The launch counters under replay (each IF body's launches at
    capture times its executions) equal the host runtime's counts on the
    same requests, route by route."""
    _, params = weights
    params = nn.tree_map(lambda x: x.to(cuda_device), params)
    cfg = _tiny(thresholds=MID, exit_mode="cond_batch", n_cohorts=2)
    _, host = _card_run(cfg, params, "host", cuda_device)
    _, dev = _card_run(cfg, params, "device", cuda_device)
    assert host == dev
    assert host["decode_attention"] > 0
