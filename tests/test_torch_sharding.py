"""The port's launch layer: device meshes, the shard rules and placing
trees on a mesh, against the JAX package's ``launch/mesh.py`` and
``launch/shard_rules.py``.

The production meshes (16x16 and 2x16x16) are shape-only on both sides:
the reference's ``jax.sharding.AbstractMesh``, the port's own
:class:`~repro_torch.launch.mesh.AbstractMesh`.  Full-width params are
built with no storage: ``jax.eval_shape`` on the reference's side,
``FakeTensorMode`` on the port's.  Specs must agree leaf by leaf (entries
compared with 1-tuples canonicalised to the bare axis name).  The 1x1
device mesh is a gloo world of one rank from an in-process store, made by
a module fixture that destroys the group it made.
"""
import dataclasses

import jax
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import PartitionSpec as JaxP
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_get_config
from repro.configs import list_configs as jax_list_configs
from repro.configs import reduced as jax_reduced
from repro.core import macs as jax_macs
from repro.core.exec import StagedExecutor as JaxExecutor
from repro.launch import shard_rules as jsr
from repro.launch.steps import make_decode_state_struct as jax_state_struct
from repro.models.model import build_model as jax_build_model
from repro.serving.paged import PagedCascadeCache as JaxPaged
from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.core import macs
from repro_torch.core.exec import StagedExecutor
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import (AbstractMesh, batch_axes, axis_size,
                                     divisible, make_host_mesh,
                                     make_production_mesh,
                                     production_device_mesh)
from repro_torch.launch.shard_rules import (P, batch_spec, cache_spec,
                                            check_spec, decode_state_spec,
                                            local_shape, param_spec, place,
                                            spec_leaves, to_shardings)
from repro_torch.launch.steps import make_decode_state_struct
from repro_torch.models.model import build_model
from repro_torch.serving.paged import PagedCascadeCache


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers
    on a few cores, where these small ops gain nothing from more threads
    and would slow the other workers' timed tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


MESH = make_production_mesh()
MESH_MP = make_production_mesh(multi_pod=True)
JAX_MESH = {False: JaxAbstractMesh((16, 16), ("data", "model")),
            True: JaxAbstractMesh((2, 16, 16), ("pod", "data", "model"))}
ARCHS = [a for a in list_configs() if a != "ci-resnet18"]
MODES = ("default", "serve1d", "serve2d")


def _canon(e):
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def _jax_key(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise TypeError(k)


def jax_specs(spec_tree) -> dict:
    """The reference's spec tree as {path: entries}."""
    return {tuple(_jax_key(k) for k in path): tuple(_canon(e) for e in s)
            for path, s in jax.tree_util.tree_leaves_with_path(
                spec_tree, is_leaf=lambda x: isinstance(x, JaxP))}


def port_specs(spec_tree) -> dict:
    return {path: tuple(s) for path, s in spec_leaves(spec_tree)}


def fake_params(cfg):
    with FakeTensorMode(allow_non_fake_inputs=True):
        return build_model(cfg, device="cpu").init(0)


def jax_params(cfg):
    return jax.eval_shape(jax_build_model(cfg).init, jax.random.PRNGKey(0))


def _leaf(tree, *path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.fixture(scope="module")
def qwen_params():
    cfg = get_config("qwen2.5-3b")
    return cfg, fake_params(cfg)


# ---------------------------------------------------------------------------
# the reference's tests/test_sharding.py, ported
# ---------------------------------------------------------------------------

def test_default_layout_tp_plus_fsdp(qwen_params):
    cfg, params = qwen_params
    spec = param_spec(params, cfg, MESH)
    # embed (V, d): vocab over model (151936 % 16 == 0), fsdp on d
    assert spec["embed"] == P("model", "data")
    wq = _leaf(spec, "segments", 0, 0, "attn", "wq")
    assert wq[-1] == "model" and "data" in wq
    wo = _leaf(spec, "segments", 0, 0, "attn", "wo")
    assert wo[-2] == "model"
    assert spec["final_norm"]["w"] == P()


def test_serve1d_no_fsdp(qwen_params):
    cfg, params = qwen_params
    spec = param_spec(params, cfg, MESH, mode="serve1d")
    wq = _leaf(spec, "segments", 0, 0, "attn", "wq")
    assert wq[-1] == "model"
    assert "data" not in tuple(a for a in wq if a)


def test_serve2d_combined_axes(qwen_params):
    cfg, params = qwen_params
    spec = param_spec(params, cfg, MESH, mode="serve2d")
    wq = _leaf(spec, "segments", 0, 0, "attn", "wq")
    # 16 heads x 128 = 2048 divisible by 256 -> combined axes on output dim
    assert wq[-1] == ("model", "data")


def _find_moe(spec_tree):
    for seg in spec_tree["segments"]:
        for stage in seg:
            if "moe" in stage:
                return stage["moe"]
    raise AssertionError("no moe stage")


def test_moe_expert_parallel_and_fallback():
    # qwen3: 128 experts % 16 == 0 -> expert parallel (+ff over data in 2d)
    cfg = get_config("qwen3-moe-235b-a22b")
    moe = _find_moe(param_spec(fake_params(cfg), cfg, MESH, mode="serve2d"))
    assert moe["w_up"][-3] == "model" and moe["w_up"][-1] == "data"
    # mixtral: 8 experts not divisible by 16 -> tensor-parallel in experts
    cfg2 = get_config("mixtral-8x7b")
    moe2 = _find_moe(param_spec(fake_params(cfg2), cfg2, MESH))
    assert moe2["w_up"][-3] is None and moe2["w_up"][-1] == "model"


def test_cache_batch_vs_sequence_parallel():
    cfg = get_config("yi-9b")
    model = build_model(cfg, device="cpu")
    spec = cache_spec(model.init_cache(128, 1024, device="meta"), cfg, MESH,
                      batch=128)
    k = spec["segments"][0][0]["k"]
    assert k[1] == "data"                 # batch over data
    # batch=1 long-context: shard the KV slot dim instead
    spec1 = cache_spec(model.init_cache(1, 1024, device="meta"), cfg, MESH,
                       batch=1)
    k1 = spec1["segments"][0][0]["k"]
    assert k1[1] is None and k1[2] == "data"


def test_batch_spec_divisibility():
    cfg = get_config("yi-9b")
    assert batch_spec(cfg, MESH, 128, 2)[0] == "data"
    assert batch_spec(cfg, MESH, 1, 2) == P()
    assert batch_spec(cfg, MESH_MP, 128, 2)[0] == ("pod", "data")


def test_whisper_vocab_not_sharded():
    # 51865 does not divide 16 -> unembedding replicated on the vocab dim
    cfg = get_config("whisper-tiny")
    spec = param_spec(fake_params(cfg), cfg, MESH, fsdp=False)
    assert spec["lm_head"][-1] is None
    assert spec["embed"][0] is None


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_spec_structurally_valid(arch):
    """Every placed axis divides its dim (the invariant the dry run relies
    on) and the spec tree has the params' structure."""
    cfg = get_config(arch)
    params = fake_params(cfg)
    from repro_torch.utils import tree_flatten_with_path
    flat = list(tree_flatten_with_path(params))
    for mode in MODES:
        specs = list(spec_leaves(param_spec(params, cfg, MESH, mode=mode)))
        assert [p for p, _ in flat] == [p for p, _ in specs]
        for (path, leaf), (_, sp) in zip(flat, specs):
            check_spec(tuple(leaf.shape), sp, MESH, str(path))


# ---------------------------------------------------------------------------
# leaf-by-leaf parity with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_equals_reference(arch):
    """Every registered LM config x default / serve1d / serve2d x the
    16x16 and 2x16x16 meshes: the port's spec tree equals the reference's
    leaf by leaf."""
    assert arch in jax_list_configs()
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    params, jparams = fake_params(cfg), jax_params(jcfg)
    for mp in (False, True):
        mesh = make_production_mesh(multi_pod=mp)
        for mode in MODES:
            want = jax_specs(jsr.param_spec(jparams, jcfg, JAX_MESH[mp],
                                            mode=mode))
            got = port_specs(param_spec(params, cfg, mesh, mode=mode))
            assert got == want, (arch, mode, mp)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_equals_reference(arch):
    """The dense cache at batch 128 (batch-sharded) and 1 (sequence
    parallel), on both production meshes."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    model, jmodel = build_model(cfg, device="cpu"), jax_build_model(jcfg)
    for batch in (128, 1):
        cache = model.init_cache(batch, 1024, device="meta")
        jcache = jax.eval_shape(lambda: jmodel.init_cache(batch, 1024))
        for mp in (False, True):
            mesh = make_production_mesh(multi_pod=mp)
            want = jax_specs(jsr.cache_spec(jcache, jcfg, JAX_MESH[mp],
                                            batch))
            assert port_specs(cache_spec(cache, cfg, mesh, batch)) == want


def _paged_cfg(get, red, **cascade):
    cfg = red(get("qwen2.5-3b")).replace(dtype="float32")
    return cfg.with_cascade(**cascade).with_paged_cache(layout="paged",
                                                        block_size=8)


@pytest.mark.parametrize("batch", [128, 1])
def test_paged_cache_and_state_specs_equal_reference(batch):
    """The paged layout's shared block stores, its per-slot kpos ring and
    the block tables riding the DecodeState (the pattern of the
    reference's tests/test_paged_cache.py): specs equal the reference's on
    both production meshes and on the port's 1x1x1 mesh shape."""
    cfg = _paged_cfg(get_config, reduced)
    jcfg = _paged_cfg(jax_get_config, jax_reduced)
    model, jmodel = build_model(cfg, device="cpu"), jax_build_model(jcfg)
    pc = PagedCascadeCache(model, cfg, lane_batch=batch, n_lanes=1,
                           cache_len=32)
    jpc = JaxPaged(jmodel, jcfg, lane_batch=batch, n_lanes=1, cache_len=32)
    cache = pc.lane_cache(pc.fresh_kpos())
    jcache = jpc.lane_cache(jpc.fresh_kpos())
    state = StagedExecutor(model, cfg).init_state(
        batch, block_tables=pc.device_tables(0))
    jstate = JaxExecutor(jmodel, jcfg).init_state(
        batch, block_tables=jpc.device_tables(0))
    for mp in (False, True):
        mesh = make_production_mesh(multi_pod=mp)
        assert port_specs(cache_spec(cache, cfg, mesh, batch)) == jax_specs(
            jsr.cache_spec(jcache, jcfg, JAX_MESH[mp], batch))
        sspec = decode_state_spec(state, cfg, mesh, batch)
        assert isinstance(sspec.block_tables, P)
        assert port_specs(sspec) == jax_specs(jsr.decode_state_spec(
            jstate, jcfg, JAX_MESH[mp], batch))
    one = AbstractMesh((1, 1, 1), ("pod", "data", "model"))
    assert all(isinstance(s, P) for _, s in spec_leaves(
        cache_spec(cache, cfg, one, batch)))


@pytest.mark.parametrize("measure", ["softmax_max", "patience@3"])
@pytest.mark.parametrize("autotune", [False, True])
@pytest.mark.parametrize("batch", [128, 1])
def test_decode_state_spec_equals_reference(measure, autotune, batch):
    """The carried DecodeState (patience streaks, the autotune telemetry
    and live thresholds) on both production meshes, as
    tests/test_exec.py's structure test: every leaf covered, per-sequence
    leaves batch-sharded, an indivisible batch replicated."""
    cfg = get_config("qwen2.5-3b").with_cascade(confidence=measure)
    jcfg = jax_get_config("qwen2.5-3b").with_cascade(confidence=measure)
    if autotune:
        cfg, jcfg = (c.with_autotune(enabled=True) for c in (cfg, jcfg))
    struct = make_decode_state_struct(cfg, batch)
    for mp in (False, True):
        mesh = make_production_mesh(multi_pod=mp)
        spec = decode_state_spec(struct, cfg, mesh, batch)
        assert port_specs(spec) == jax_specs(jsr.decode_state_spec(
            jax_state_struct(jcfg, batch), jcfg, JAX_MESH[mp], batch))
        dp = "data" if not mp else ("pod", "data")
        want = dp if batch == 128 else None
        assert spec.active == P(want) and spec.ema_conf == P(want)
        assert spec.t == P() and spec.segments_run == P()
        if measure.startswith("patience"):
            assert spec.policy == P(None, want)
        if autotune:
            assert spec.thresholds == P()
            assert dataclasses.is_dataclass(spec.tel)


# ---------------------------------------------------------------------------
# meshes and placing
# ---------------------------------------------------------------------------

def test_production_meshes_are_shape_only():
    assert MESH.shape == {"data": 16, "model": 16}
    assert mesh_mod.mesh_size(MESH) == 256
    assert MESH_MP.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh_mod.mesh_size(MESH_MP) == 512
    assert batch_axes(MESH) == ("data",)
    assert batch_axes(MESH_MP) == ("pod", "data")
    assert axis_size(MESH_MP, ("model", "data")) == 256
    assert divisible(128, 16) and not divisible(1, 16)
    assert not divisible(4, 0)
    # a world of one rank cannot hold them
    with pytest.raises(RuntimeError, match="world of 256 ranks"):
        production_device_mesh("cpu")
    with pytest.raises(RuntimeError, match="world of 512 ranks"):
        production_device_mesh("cpu", multi_pod=True)


def test_host_mesh_is_one_rank(host_mesh, monkeypatch):
    import torch.distributed as dist
    assert host_mesh.mesh_dim_names == ("data", "model")
    assert mesh_mod.mesh_shape(host_mesh) == {"data": 1, "model": 1}
    assert batch_axes(host_mesh) == ("data",)
    assert dist.get_world_size() == 1
    # a second call reuses the group
    assert mesh_mod.mesh_shape(make_host_mesh("cpu")) == {"data": 1,
                                                          "model": 1}
    # a group of another size is refused, both sizes named
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 4)
    with pytest.raises(RuntimeError, match="world size 4.*world of 1"):
        make_host_mesh("cpu")


def test_host_mesh_on_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh("cuda")


def test_placements_and_shard_shapes(host_mesh):
    from torch.distributed.tensor import Replicate, Shard
    assert to_shardings(MESH, P(None, ("model", "data"))) == (Shard(1),
                                                              Shard(1))
    assert to_shardings(MESH, P("model", "data")) == (Shard(1), Shard(0))
    assert to_shardings(MESH_MP, P()) == (Replicate(),) * 3
    tree = to_shardings(host_mesh, {"a": [P("data"), None]})
    assert tree == {"a": [(Shard(0), Replicate()), None]}
    assert local_shape((128, 2048), P("data", ("model", "data")),
                       MESH) == (8, 8)
    with pytest.raises(ValueError, match="does not divide"):
        check_spec((3, 4), P("data"), MESH)
    with pytest.raises(ValueError, match="not an axis"):
        check_spec((16,), P("pod"), MESH)
    with pytest.raises(ValueError, match="placed twice"):
        check_spec((16, 16), P("data", "data"), MESH)


def test_place_copies_no_leaf(host_mesh):
    """Placing params, a cache and a DecodeState on the 1x1 mesh wraps
    every leaf: each DTensor's local tensor is the leaf's storage."""
    from torch.distributed.tensor import DTensor
    cfg = reduced(get_config("qwen2.5-3b")).with_cascade(
        confidence="patience@2").with_autotune(enabled=True)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    cache = model.init_cache(2, 16)
    state = StagedExecutor(model, cfg).init_state(2)
    for tree, spec in ((params, param_spec(params, cfg, host_mesh)),
                       (cache, cache_spec(cache, cfg, host_mesh, 2)),
                       (state, decode_state_spec(state, cfg, host_mesh,
                                                 2))):
        placed = place(host_mesh, tree, spec)
        got = port_specs(spec)
        if dataclasses.is_dataclass(tree):
            pairs = [(getattr(tree, f), getattr(placed, f))
                     for f in ("t", "active", "policy", "ema_conf",
                               "thresholds")]
            pairs += list(zip(tree.tel.tensors(), placed.tel.tensors()))
            assert placed.segments_run is tree.segments_run
        else:
            from repro_torch.models import nn
            pairs = list(zip(nn.tree_leaves(tree), nn.tree_leaves(placed)))
        assert pairs and got
        for own, d in pairs:
            assert isinstance(d, DTensor)
            assert d.to_local().data_ptr() == own.data_ptr()
            assert tuple(d.shape) == tuple(own.shape)
    # a spec the mesh cannot hold is refused before anything is placed
    with pytest.raises(ValueError, match="not an axis"):
        place(host_mesh, {"w": torch.zeros(4)}, {"w": P("pod")})


# ---------------------------------------------------------------------------
# MODEL_FLOPS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert macs.active_param_count(cfg) == jax_macs.active_param_count(jcfg)
    for tokens, training in ((1, False), (128, False), (4096 * 256, True)):
        assert macs.model_flops(cfg, tokens, training) == \
            jax_macs.model_flops(jcfg, tokens, training)
    r, jr = reduced(cfg), jax_reduced(jcfg)
    assert macs.model_flops(r, 64, True) == jax_macs.model_flops(jr, 64, True)
