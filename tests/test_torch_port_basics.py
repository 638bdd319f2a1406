"""The PyTorch port (``repro_torch``): configs, weight bridge, package
isolation and the no-hidden-fallback rule, against the JAX package."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_configs as jax_list_configs
from repro.configs import reduced as jax_reduced
from repro.models.model import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.kernels import (cohort_cache, confidence, decode_attention,
                                 exit_update, flash_attention, megakernel,
                                 rmsnorm)
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models.model import build_model
from repro_torch.serving.engine import CascadeServingEngine


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


def _small(mod):
    return mod[1](mod[0]("qwen2.5-3b"), n_layers=3).with_cascade(
        n_components=3, exit_boundaries=(1, 2))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("overrides", [{}, {"n_layers": 3},
                                       {"dtype": "bfloat16"}])
def test_reduced_config_equals_reference_field_by_field(overrides):
    ours = reduced(get_config("qwen2.5-3b"), **overrides)
    ref = jax_reduced(jax_get_config("qwen2.5-3b"), **overrides)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.segments == ref.segments


def test_full_config_and_registry():
    ours = get_config("qwen2.5-3b")
    assert dataclasses.asdict(ours) == dataclasses.asdict(
        jax_get_config("qwen2.5-3b"))
    assert ours.segments == ((0, 12), (12, 24), (24, 36))
    # the paper's CNN joined the registry in the training slice, yi-9b
    # (the escalation tier's second published width) in slice 11,
    # deepseek-coder-33b and minitron-4b (the dense family whole) in
    # slice 12, mixtral-8x7b and qwen3-moe-235b-a22b (the moe family) in
    # slice 15, zamba2-1.2b (the hybrid family) in slice 16, xlstm-350m
    # (the ssm family) in slice 17, whisper-tiny (the audio family) in
    # slice 18, llama-3.2-vision-90b (the vlm family) in slice 19: the
    # whole of the reference's registry
    assert list_configs() == ["ci-resnet18", "deepseek-coder-33b",
                              "llama-3.2-vision-90b", "minitron-4b",
                              "mixtral-8x7b", "qwen2.5-3b",
                              "qwen3-moe-235b-a22b", "whisper-tiny",
                              "xlstm-350m", "yi-9b", "zamba2-1.2b"]
    assert list_configs() == jax_list_configs()
    yi = get_config("yi-9b")
    assert dataclasses.asdict(yi) == dataclasses.asdict(
        jax_get_config("yi-9b"))
    assert yi.segments == jax_get_config("yi-9b").segments == (
        (0, 16), (16, 32), (32, 48))
    # an unknown architecture is refused, as the reference refuses it
    with pytest.raises(KeyError) as jerr:
        jax_get_config("llama-3.2-vision-11b")
    with pytest.raises(KeyError) as err:
        get_config("llama-3.2-vision-11b")
    assert str(err.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# weight bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_bit_exact(dtype):
    jcfg = _small((jax_get_config, jax_reduced)).replace(dtype=dtype)
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(3))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    cfg = _small((get_config, reduced)).replace(dtype=dtype)
    tp = bridge.params_from_jax(np_params, cfg, device="cpu")
    assert tp["embed"].dtype == getattr(torch, dtype)
    assert tp["final_norm"]["w"].dtype == torch.float32   # kept as is
    back = bridge.params_to_numpy(tp)
    flat_a, tree_a = jax.tree_util.tree_flatten(np_params)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_bridge_tree_matches_port_init():
    cfg = _small((get_config, reduced))
    jparams = jax_build_model(_small((jax_get_config, jax_reduced))).init(
        jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                cfg, device="cpu")
    own = build_model(cfg, device="cpu").init(0)
    shapes = jax.tree_util.tree_map(lambda x: (tuple(x.shape), x.dtype), tp)
    assert shapes == jax.tree_util.tree_map(
        lambda x: (tuple(x.shape), x.dtype), own)


def test_bridge_rejects_other_trees():
    cfg = _small((get_config, reduced))
    with pytest.raises(ValueError):
        bridge.params_from_jax({"embed": np.zeros((3, 3))}, cfg, "cpu")


# ---------------------------------------------------------------------------
# isolation: the port imports neither jax nor the reference package
# ---------------------------------------------------------------------------

def _port_modules():
    return sorted(
        ".".join(p.relative_to(SRC).with_suffix("").parts)
        .replace(".__init__", "")
        for p in (SRC / "repro_torch").rglob("*.py"))


def _port_examples():
    """The port's examples: ``examples/*_torch.py``."""
    return sorted((SRC.parent / "examples").glob("*_torch.py"))


def test_importing_every_port_module_loads_no_jax_and_no_reference():
    mods = _port_modules()
    assert {"repro_torch.serving.engine", "repro_torch.core.cascade",
            "repro_torch.kernels.megakernel", "repro_torch.kernels.confidence",
            "repro_torch.kernels.cohort_cache",
            "repro_torch.autotune.telemetry", "repro_torch.autotune.solver",
            "repro_torch.autotune.controller",
            "repro_torch.autotune.artifacts",
            "repro_torch.core.calibration",
            "repro_torch.launch.calibrate",
            "repro_torch.models.resnet", "repro_torch.core.resnet_trainer",
            "repro_torch.core.training", "repro_torch.optim.optimizer",
            "repro_torch.ckpt.checkpoint", "repro_torch.data.synth_images",
            "repro_torch.data.lm_pipeline",
            "repro_torch.launch.train", "repro_torch.escalate",
            "repro_torch.escalate.tier", "repro_torch.escalate.router",
            "repro_torch.escalate.replay",
            "repro_torch.configs.yi_9b",
            "repro_torch.obs", "repro_torch.obs.recorder",
            "repro_torch.obs.metrics", "repro_torch.obs.traceviz",
            "repro_torch.obs.server", "repro_torch.fleet",
            "repro_torch.fleet.scheduler", "repro_torch.fleet.health",
            "repro_torch.fleet.aggregator"} <= set(mods)
    examples = [str(p) for p in _port_examples()]
    assert len(examples) == 4
    code = (
        "import importlib, importlib.util, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"for i, path in enumerate({examples!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'ex{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or m == 'repro' "
        "or m.startswith('repro.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_source_scan_finds_no_jax_or_reference_import():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax\b|import\s+jaxlib|"
                     r"from\s+jaxlib\b|import\s+repro(\.|\s|$)|"
                     r"from\s+repro(\.|\s))", re.M)
    hits = []
    files = list((SRC / "repro_torch").rglob("*.py"))
    files.append(SRC.parent / "chip_smoke.py")
    files += _port_examples()
    for path in files:
        for m in pat.finditer(path.read_text()):
            hits.append(f"{path}: {m.group(0).strip()}")
    assert len(files) > 20
    assert {"tier.py", "router.py", "replay.py"} <= {
        p.name for p in files if p.parent.name == "escalate"}
    assert {"recorder.py", "metrics.py", "traceviz.py", "server.py"} <= {
        p.name for p in files if p.parent.name == "obs"}
    assert {"scheduler.py", "health.py", "aggregator.py"} <= {
        p.name for p in files if p.parent.name == "fleet"}
    assert {"quickstart_torch.py", "serve_cascade_torch.py",
            "train_llm_cascade_torch.py", "paper_reproduction_torch.py"} <= {
        p.name for p in files if p.parent.name == "examples"}
    assert not hits, hits


# ---------------------------------------------------------------------------
# no hidden fallback: without a card nothing quietly runs on the CPU, and a
# non-CPU tensor never takes a kernel's plain version
# ---------------------------------------------------------------------------

def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    _no_cuda(monkeypatch)
    cfg = _small((get_config, reduced))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        CascadeServingEngine(cfg, model, params, lane_batch=2, n_lanes=1,
                             cache_len=32)
    eng = CascadeServingEngine(cfg, model, params, lane_batch=2, n_lanes=1,
                               cache_len=32, device="cpu")
    assert eng.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        bridge.params_from_jax({}, cfg)
    # the escalation tier's entry point: the serve CLI's tier path builds
    # its stages on CUDA unless --device cpu is given, and a tier runs on
    # its engines' devices
    from repro_torch.escalate import ModelCascadeTier
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "qwen2.5-3b", "--smoke",
                    "--escalate-layers", "1"])
    tier = ModelCascadeTier([eng, CascadeServingEngine(
        cfg, model, params, lane_batch=2, n_lanes=1, cache_len=32,
        device="cpu")])
    assert {e.device.type for e in tier.engines} == {"cpu"}


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("kernel", ["rmsnorm", "exit_update",
                                    "decode_attention", "flash_attention",
                                    "confidence", "megakernel",
                                    "cohort_scatter"])
def test_wrappers_raise_on_non_cpu_tensors(kernel):
    """A tensor on any device but the CPU must reach the kernel (which
    needs CUDA) and raise — never the plain version."""
    before = {"rmsnorm": rmsnorm.rmsnorm.launches}
    b = _meta(4, dtype=torch.bool)
    i = _meta(4, dtype=torch.int32)
    f = _meta(4)
    with pytest.raises(ValueError, match="CUDA"):
        if kernel == "rmsnorm":
            rmsnorm.rmsnorm(_meta(4, 64), _meta(64))
        elif kernel == "exit_update":
            exit_update.exit_update(_meta(4, 100), b, i, i, f, i, f, b,
                                    threshold=0.5, m=0, n_components=2)
        elif kernel == "decode_attention":
            decode_attention.decode_attention(
                _meta(2, 4, 64), _meta(2, 16, 1, 64), _meta(2, 16, 1, 64), 3,
                _meta(16, dtype=torch.int32))
        elif kernel == "flash_attention":
            flash_attention.flash_attention(
                _meta(1, 4, 64, 64), _meta(1, 1, 64, 64), _meta(1, 1, 64, 64))
        elif kernel == "confidence":
            confidence.confidence(_meta(4, 100))
        elif kernel == "megakernel":
            megakernel.exit_head_update(
                _meta(4, 64), _meta(64), _meta(64, 100), b, i, i, f, i, f, b,
                threshold=0.5, m=0, n_components=2, live=b)
        else:
            cohort_cache.cohort_scatter_tree(
                [_meta(2, 4, 8)], [_meta(2, 2, 8)], 1, 2)
    assert rmsnorm.rmsnorm.launches == before["rmsnorm"]
    assert confidence.confidence.launches == 0
    assert megakernel.exit_head_update.launches == 0
    assert cohort_cache.cohort_scatter_tree.launches == 0


def test_plain_version_taken_for_cpu_tensors_only(monkeypatch):
    """The CPU route is decided by the tensor's device alone: with the
    device check forced to see a non-CPU device, a CPU tensor raises."""
    calls = []
    monkeypatch.setattr(rmsnorm, "ref_rmsnorm",
                        lambda *a: calls.append(1) or a[0])
    x, w = torch.ones(2, 8), torch.ones(8)
    rmsnorm.rmsnorm(x, w)
    assert calls == [1]

    class _Dev:
        type = "cuda"

    class _T:
        device = _Dev()

    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm.rmsnorm(_T(), w)
    assert calls == [1]


@pytest.mark.parametrize("kernel", ["confidence", "megakernel",
                                    "cohort_scatter"])
def test_new_wrappers_take_plain_version_for_cpu_tensors_only(
        monkeypatch, kernel):
    """The same rule for the slice-2 wrappers: the plain version serves a
    CPU tensor, and a tensor that reports a CUDA device goes to the
    kernel's device check (the first step of a launch), never to the plain
    version."""
    from repro_torch.kernels import build
    calls, reached = [], []

    class _Reached(Exception):
        pass

    def device_check(what, *tensors):
        reached.append(what)
        raise _Reached

    class _Dev:
        type = "cuda"

    class _T:
        device = _Dev()

    c = [torch.zeros(2)] * 7
    if kernel == "confidence":
        monkeypatch.setattr(confidence, "ref_confidence",
                            lambda x: calls.append(1) or (x, x))
        confidence.confidence(torch.ones(2, 8))
        fake = lambda: confidence.confidence(_T())  # noqa: E731
    elif kernel == "megakernel":
        monkeypatch.setattr(megakernel, "ref_exit_head_update",
                            lambda *a, **k: calls.append(1))
        megakernel.exit_head_update(torch.ones(2, 8), torch.ones(8),
                                    torch.ones(8, 16), *c, threshold=0.5,
                                    m=0, n_components=2)
        fake = lambda: megakernel.exit_head_update(  # noqa: E731
            _T(), _T(), _T(), *c, threshold=0.5, m=0, n_components=2)
    else:
        monkeypatch.setattr(cohort_cache, "ref_cohort_scatter",
                            lambda *a: calls.append(1))
        cohort_cache.cohort_scatter_tree([torch.ones(2, 2, 2)],
                                         [torch.ones(2, 1, 2)], 0, 2)
        fake = lambda: cohort_cache.cohort_scatter_tree(  # noqa: E731
            [_T()], [_T()], 0, 2)
    assert calls == [1] and reached == []
    monkeypatch.setattr(build, "require_cuda", device_check)
    with pytest.raises(_Reached):
        fake()
    assert calls == [1] and len(reached) == 1


def test_unported_configurations_are_refused():
    cfg = _small((get_config, reduced))
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    kw = dict(lane_batch=2, n_lanes=1, cache_len=32, device="cpu")
    # mesh sharding is ported (slice 20): the host runtime refuses a mesh
    # with the reference's error; the device runtime takes a 1x1 device
    # mesh and refuses a shape-only one (of more than one rank: multi-rank
    # serving needs a DeviceMesh of that many processes)
    with pytest.raises(ValueError, match="runtime='device'"):
        CascadeServingEngine(cfg, model, params, mesh=object(), **kw)
    with pytest.raises(NotImplementedError, match="2 ranks: multi-rank"):
        CascadeServingEngine(cfg, model, params, runtime="device",
                             mesh=AbstractMesh((1, 2), ("data", "model")),
                             **kw)
    with pytest.raises(ValueError, match="DeviceMesh"):
        CascadeServingEngine(cfg, model, params, runtime="device",
                             mesh=AbstractMesh((1, 1), ("data", "model")),
                             **kw)
    # the flight recorder is ported (slice 14): the engine carries one
    eng = CascadeServingEngine(cfg.with_obs(), model, params, **kw)
    assert eng.flight is not None and eng.stats()["obs"]["flights_live"] == 0
    # kernel tile autotuning is ported (slice 12): the engine loads or
    # sweeps its tiles, and on the CPU, with no artifact, the sweep (CUDA
    # events over the CUDA kernels) refuses
    with pytest.raises(RuntimeError, match="CUDA device"):
        CascadeServingEngine(cfg.with_kernel_tune(enabled=True), model,
                             params, **kw)
    # cross-model escalation is ported (slice 11): an escalation stage's
    # engine constructs
    eng = CascadeServingEngine(cfg.with_escalation(enabled=True,
                                                   threshold=0.5),
                               model, params, **kw)
    assert eng.cfg.escalation.enabled
    assert eng.stats()["escalation"]["cancelled_for_escalation"] == 0
    # the entropy and margin measures are ported (the training slice): the
    # engine constructs with either
    for measure in ("entropy", "margin"):
        eng = CascadeServingEngine(cfg.with_cascade(confidence=measure),
                                   model, params, **kw)
        assert eng.executor.decider.measure.name == measure
    # autotune is ported (slice 9): it constructs with the config's
    # telemetry, and a controller without it is a caller error
    with pytest.raises(ValueError, match="autotune"):
        CascadeServingEngine(cfg, model, params, autotune=True, **kw)
    tuned = cfg.with_autotune(enabled=True)
    assert CascadeServingEngine(tuned, model, params, autotune=True,
                                **kw).controller is not None
    # every family the reference serves is ported (vlm in slice 19); an
    # unknown family is refused with the reference's error
    with pytest.raises(ValueError, match="unknown family") as jerr:
        jax_build_model(_small((jax_get_config, jax_reduced)).replace(
            family="vision"))
    with pytest.raises(ValueError, match="unknown family") as err:
        build_model(cfg.replace(family="vision"), device="cpu")
    assert str(err.value) == str(jerr.value)
    # the paged KV layout is ported (slice 3): it constructs
    paged = cfg.with_paged_cache(layout="paged", block_size=8)
    assert CascadeServingEngine(paged, model, params, **kw).paged
