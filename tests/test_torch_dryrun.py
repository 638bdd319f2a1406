"""The port's dry run and roofline (``launch/dryrun.py``,
``launch/roofline.py``) against the JAX package's.

The dry run traces each step on fake tensors over the shape-only
production mesh.  Here the configs are reduced and the input shapes small
(the module's ``INPUT_SHAPES`` patched): a record's per-device argument
bytes must equal the sum of the local shard sizes that the reference's own
specs give its own arguments (``jax.eval_shape`` trees), and its roofline
terms the reference's ``terms`` with the reference module's constants
patched to the H100's.  The CLI runs once at full width (qwen2.5-3b,
decode_32k, serve1d) in a subprocess, then the roofline CLI over its
record.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import PartitionSpec as JaxP

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import roofline as jax_roofline
from repro.launch import shard_rules as jsr
from repro.launch.dryrun import adjust_config as jax_adjust_config
from repro.launch.steps import make_batch_structs as jax_batch_structs
from repro.launch.steps import make_decode_state_struct as jax_state_struct
from repro.launch.steps import make_optimizer as jax_make_optimizer
from repro.models.model import build_model as jax_build_model
from repro.models.model import extra_input_shapes as jax_extra_shapes
from repro_torch.configs import InputShape, get_config, list_configs, reduced
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shard_rules import P, param_spec
from repro_torch.models.model import build_model

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = [a for a in list_configs() if a != "ci-resnet18"]
# small stand-ins for the four assigned shapes: a batch the 16-wide data
# axis divides, and the batch-1 long-context decode
SMALL = {"train_4k": InputShape("train_4k", 64, 32, "train"),
         "prefill_32k": InputShape("prefill_32k", 64, 32, "prefill"),
         "decode_32k": InputShape("decode_32k", 128, 32, "decode"),
         "long_500k": InputShape("long_500k", 256, 1, "decode")}
JAX_MESH = {False: JaxAbstractMesh((16, 16), ("data", "model")),
            True: JaxAbstractMesh((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers
    on a few cores, where these small ops gain nothing from more threads
    and would slow the other workers' timed tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_shapes(monkeypatch):
    for name, shape in SMALL.items():
        monkeypatch.setitem(dryrun.INPUT_SHAPES, name, shape)
    return SMALL


def _local_bytes(struct_tree, spec_tree, mesh) -> int:
    """Sum of each leaf's local shard bytes under the reference's specs."""
    sizes = dict(mesh.shape)
    leaves = jax.tree_util.tree_leaves(struct_tree)
    specs = jax.tree_util.tree_leaves(
        spec_tree, is_leaf=lambda x: isinstance(x, JaxP))
    assert len(leaves) == len(specs)
    total = 0
    for leaf, spec in zip(leaves, specs):
        shape = list(leaf.shape)
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            shape[d] //= math.prod(sizes[a] for a in axes)
        total += math.prod(shape) * np.dtype(leaf.dtype).itemsize
    return total


def reference_argument_bytes(jcfg, shape, mesh, param_mode) -> int:
    """Per-device argument bytes of the reference's step for ``shape``,
    from its own trees and specs (what its dry run shards)."""
    model = jax_build_model(jcfg)
    B, S = shape.global_batch, shape.seq_len
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    total = _local_bytes(params, jsr.param_spec(params, jcfg, mesh,
                                                mode=param_mode), mesh)
    extra = {k: jax.ShapeDtypeStruct(v, jnp.float32)
             for k, v in jax_extra_shapes(jcfg, B).items()}
    extra_spec = {k: jsr.batch_spec(jcfg, mesh, B, len(v.shape))
                  for k, v in extra.items()}
    if shape.kind == "train":
        opt = jax.eval_shape(jax_make_optimizer(jcfg).init, params)
        total += _local_bytes(opt, jsr.param_spec(opt, jcfg, mesh), mesh)
        batch = jax_batch_structs(jcfg, B, S)
        total += _local_bytes(batch, jax.tree_util.tree_map(
            lambda s: jsr.batch_spec(jcfg, mesh, B, len(s.shape)), batch),
            mesh)
        return total + 4                                  # the step
    cache = jax.eval_shape(lambda: model.init_cache(B, S))
    total += _local_bytes(cache, jsr.cache_spec(cache, jcfg, mesh, B), mesh)
    decode = shape.kind == "decode"
    tokens = jax.ShapeDtypeStruct((B, 1 if decode else S), jnp.int32)
    total += _local_bytes(tokens, jsr.batch_spec(jcfg, mesh, B, 2), mesh)
    total += _local_bytes(extra, extra_spec, mesh)
    if decode:
        state = jax_state_struct(jcfg, B)
        total += _local_bytes(state, jsr.decode_state_spec(state, jcfg, mesh,
                                                           B), mesh)
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_records_of_reduced_configs(arch, small_shapes):
    """Every shape of a reduced config traces on fake tensors over the
    production mesh; the per-device argument bytes equal the reference's
    sum of shard sizes; FLOPs, bytes and MODEL_FLOPS are positive; the
    collectives follow the layout (serve1d decode gathers no weight,
    FSDP training gathers and reduce-scatters)."""
    import torch.distributed as dist
    cases = [("train_4k", "default", False), ("prefill_32k", "serve1d", True),
             ("decode_32k", "serve1d", False),
             ("long_500k", "serve2d", False)]
    for shape_name, mode, mp in cases:
        if (arch, shape_name) in dryrun.SKIP:
            continue
        shape = SMALL[shape_name]
        cfg = dryrun.adjust_config(reduced(get_config(arch)), shape)
        jcfg = jax_adjust_config(jax_reduced(jax_get_config(arch)), shape)
        rec = dryrun.lower_combo(arch, shape_name, mp, cfg_override=cfg,
                                 param_mode=mode)
        assert rec["ok"] and rec["mesh"] == ("2x16x16" if mp else "16x16")
        assert rec["memory"]["argument_size_in_bytes"] == \
            reference_argument_bytes(jcfg, shape, JAX_MESH[mp], mode), \
            (arch, shape_name)
        assert rec["flops"] > 0 and rec["model_flops"] > 0
        assert rec["bytes_accessed"] > rec["memory"][
            "argument_size_in_bytes"]
        assert rec["n_tokens"] == shape.global_batch * (
            1 if shape.kind == "decode" else shape.seq_len)
        coll = rec["collective_bytes"]
        assert set(coll) == set(dryrun.COLLECTIVES)
        if mode != "default":
            assert coll["all-gather"] == 0 and coll["reduce-scatter"] == 0
        else:
            assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
        assert roofline.terms(rec)["step_s"] > 0
    # no process group was made for the 256 or 512 devices
    assert not dist.is_initialized() or dist.get_world_size() == 1


def test_skip_and_long_context_window():
    assert ("whisper-tiny", "long_500k") in dryrun.SKIP
    long = dryrun.INPUT_SHAPES["long_500k"]
    cfg = dryrun.adjust_config(get_config("qwen2.5-3b"), long)
    assert cfg.attn_window == dryrun.LONG_WINDOW == 8192
    assert cfg.cascade.exit_mode == "select"
    ssm = dryrun.adjust_config(get_config("xlstm-350m"), long)
    assert ssm.attn_window == get_config("xlstm-350m").attn_window
    assert dryrun.adjust_config(get_config("yi-9b"), long,
                                exit_mode="cond_batch").cascade.exit_mode \
        == "cond_batch"


def test_collective_formulas_by_hand():
    """A row-parallel product over model, an FSDP leaf and a vocab-sharded
    head, against the docstring's ring formulas worked by hand."""
    cfg = get_config("qwen2.5-3b")                     # bf16: 2 bytes
    mesh = make_production_mesh()
    wo = torch.empty((2, 64, 32), dtype=torch.bfloat16)
    head = torch.empty((32, 160), dtype=torch.bfloat16)
    pairs = [(("segments", 0, 0, "attn", "wo"), wo, P(None, "model", None)),
             (("exits", 0, "head"), head, P("data", "model"))]
    coll, counts = dryrun.collectives(cfg, pairs, mesh, n_tokens=128,
                                      batch=128, training=False)
    # wo: 8 tokens a device x 32 x 2 bytes, all-reduced over 16, 2 layers;
    # head: max and sum of 8 f32 over 16
    ar = 2 * 2 * 15 / 16 * (8 * 32 * 2) + 2 * 2 * 15 / 16 * (8 * 4)
    # head gathered over data: its (32, 160 / 16) bf16 columns
    ag = 15 / 16 * (32 * 10 * 2)
    assert coll["all-reduce"] == int(ar) and counts["all-reduce"] == 4
    assert coll["all-gather"] == int(ag) and counts["all-gather"] == 1
    train, tcounts = dryrun.collectives(cfg, pairs, mesh, n_tokens=128,
                                        batch=128, training=True)
    assert tcounts["all-gather"] == 2 and tcounts["reduce-scatter"] == 1
    # gradients: the FSDP head reduce-scattered, wo (replicated over data)
    # all-reduced over the batch axis
    assert train["reduce-scatter"] == int(15 / 16 * (32 * 10 * 2))
    assert train["all-reduce"] == int(2 * ar - 2 * 2 * 15 / 16 * (8 * 4)
                                      + 2 * 15 / 16 * (2 * 4 * 32 * 2))


def test_expert_parallel_all_to_all():
    """qwen3-moe's 128 experts shard over model: its layers dispatch and
    combine by all-to-all; mixtral's 8 do not divide 16 (tensor parallel
    inside the experts): none."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mesh = make_production_mesh()
    for arch, want in (("qwen3-moe-235b-a22b", True),
                       ("mixtral-8x7b", False)):
        cfg = get_config(arch)
        with FakeTensorMode(allow_non_fake_inputs=True):
            params = build_model(cfg, device="cpu").init(0)
        pairs = dryrun._pairs(params, param_spec(params, cfg, mesh,
                                                 mode="serve1d"))
        coll, counts = dryrun.collectives(cfg, pairs, mesh, 128, 128, False)
        assert (counts["all-to-all"] == 2 * cfg.n_layers) == want
        assert (coll["all-to-all"] > 0) == want


def test_terms_equal_reference_terms_at_h100_constants(monkeypatch,
                                                      small_shapes):
    """roofline.terms on a port record equals the reference's terms with
    its constants patched to the H100's (its ``hlo_bytes`` given the
    port's ``bytes_accessed``)."""
    monkeypatch.setattr(jax_roofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(jax_roofline, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(jax_roofline, "ICI_BW", roofline.NVLINK_BW)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NVLINK_BW) == (
        989e12, 3.35e12, 450e9)
    for shape, mp in (("decode_32k", False), ("train_4k", True)):
        cfg = dryrun.adjust_config(reduced(get_config("qwen2.5-3b")),
                                   SMALL[shape])
        rec = dryrun.lower_combo("qwen2.5-3b", shape, mp, cfg_override=cfg)
        want = jax_roofline.terms(dict(rec, hlo_bytes=rec["bytes_accessed"]))
        assert roofline.terms(rec) == want
    assert roofline.terms({"ok": False}) is None
    assert roofline.fmt(0.0123) == jax_roofline.fmt(0.0123) == "12.3ms"


def test_dryrun_and_roofline_cli_full_width(tmp_path):
    """The acceptance command at full width on this CPU: no GPU, no
    process group of 256 ranks; a record with ok true; the roofline CLI
    prints its row from the H100 constants."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("CUDA_VISIBLE_DEVICES", None)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2.5-3b", "--shape", "decode_32k", "--param-mode", "serve1d",
         "--out", str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    path = tmp_path / "qwen2.5-3b__decode_32k__sp_serve1d.json"
    rec = json.loads(path.read_text())
    assert rec["ok"] and rec["mesh"] == "16x16"
    assert rec["param_mode"] == "serve1d" and rec["n_tokens"] == 128
    # the bf16 KV cache (36 layers x 128 x 32768 x 2 KV heads x 128 x 2 x 2
    # bytes) over the 16-wide data axis, 9.66e9, plus the serve1d weights
    # over the 16 model shards, ~0.4e9
    assert 9.9e9 < rec["memory"]["argument_size_in_bytes"] < 10.3e9
    assert rec["collective_bytes"]["all-gather"] == 0
    table = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", "--dir",
         str(tmp_path), "--suffix", "sp_serve1d"], env=env,
        capture_output=True, text=True, timeout=120)
    assert table.returncode == 0, table.stderr[-2000:]
    row = table.stdout.strip().splitlines()[-1]
    t = roofline.terms(rec)
    assert row.startswith("| qwen2.5-3b | decode_32k | ")
    assert roofline.fmt(t["memory_s"]) in row and "serve1d" in row
