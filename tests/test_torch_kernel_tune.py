"""The port's kernel tile autotuner (``repro_torch.kernels.autotune``):
the registry, the keyed artifact, the sweep's rows, the engine and decode
loop installing tiles before any capture — the spec is
``tests/test_kernel_tune.py``.

The load-bearing contracts, as the reference's:

* ``tuned_speedup >= 1.0`` on every row by construction (the default tiles
  are always a candidate and both times come from one sweep);
* installed tiles flow through the kernel wrappers at call time;
* artifacts round-trip through disk keyed by the tune key, and a key
  mismatch falls back to the default tiles with a warning.

And the port's own: the tiles are the CUDA kernels' launch parameters
(decode attention's split, flash attention's tile and paged_gather's
implementation each a one-candidate set), the sweep times one candidate
per distinct launch, a tuned exit split moves δ in its last bits and
never the argmax, and a CUDA graph captured before an install is captured
again.  On the CPU the wrappers take their plain
versions and the sweep refuses; the timer is monkeypatched to drive the
sweep's bookkeeping here, and the ``cuda`` tests time it on the card.
Tolerances: the exit update's δ under another vocab split 1e-6 relative
(an f32 sum of V exponentials in another order); everything else exact.
"""
import json

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jax_at
from repro_torch.configs import KernelTuneConfig, get_config, reduced
from repro_torch.kernels import autotune as at
from repro_torch.kernels import confidence, decode_attention, ref
from repro_torch.models.model import build_model
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


@pytest.fixture(autouse=True)
def _fresh_registry():
    at.reset_tiles()
    yield
    at.reset_tiles()


def _fake_sweep_device(monkeypatch, fastest):
    """Let the sweep run on the CPU with a timer that calls the wrapper
    once (the plain version) and gives ``fastest`` tiles 1 µs, others
    2 µs, the default 3 µs."""
    monkeypatch.setattr(at, "_require_cuda", lambda device: torch.device(
        "cpu"))

    def timer(fn, reps=5):
        fn()
        tuned = {k: dict(v) for k, v in at._TUNED.items()}
        for kernel, tiles in fastest.items():
            if tuned.get(kernel) == tiles:
                return 1.0
        for kernel, tiles in tuned.items():
            if tiles == at.DEFAULT_TILES[kernel]:
                return 3.0
        return 2.0
    monkeypatch.setattr(at, "_time_us", timer)


# ---------------------------------------------------------------------------
# the surface and the config
# ---------------------------------------------------------------------------

def test_public_surface_and_tiny_preset_match_reference():
    names = ("DEFAULT_TILES", "CANDIDATE_TILES", "SWEEP_SHAPES", "tile",
             "install_tiles", "reset_tiles", "current_tiles", "sweep",
             "tune_key", "TileArtifact", "save_tile_artifact",
             "load_tile_artifact", "ensure_tuned", "tile_artifact_path",
             "TILE_ARTIFACT_VERSION")
    for name in names:
        assert hasattr(jax_at, name) and hasattr(at, name), name
    assert set(at.DEFAULT_TILES) == set(jax_at.DEFAULT_TILES)
    assert set(at.SWEEP_SHAPES) == set(jax_at.SWEEP_SHAPES)
    # the CI-sized preset is the reference's, shape for shape
    assert at.SWEEP_SHAPES["tiny"] == jax_at.SWEEP_SHAPES["tiny"]
    for kernel, default in at.DEFAULT_TILES.items():
        assert default in at.CANDIDATE_TILES[kernel], kernel
        for preset in at.SWEEP_SHAPES.values():
            assert preset[kernel], kernel


def test_kernel_tune_config():
    cfg = reduced(get_config("qwen2.5-3b"))
    assert cfg.kernel_tune == KernelTuneConfig()
    assert not cfg.kernel_tune.enabled
    on = cfg.with_kernel_tune(enabled=True, megakernel=True,
                              cohort_scatter=True, shapes="serving")
    assert on.kernel_tune.enabled and on.kernel_tune.megakernel
    assert on.kernel_tune.cohort_scatter
    assert cfg.kernel_tune == KernelTuneConfig()  # frozen, not mutated
    with pytest.raises(ValueError):
        KernelTuneConfig(shapes="huge")


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_tile_registry_install_and_reset():
    g0 = at.generation()
    assert at.tile("rmsnorm", "rows") == 1
    at.install_tiles({"rmsnorm": {"rows": 4}})
    assert at.tile("rmsnorm", "rows") == 4
    assert at.generation() == g0 + 1
    # the same tiles again change nothing: no new generation
    at.install_tiles({"rmsnorm": {"rows": 4}})
    assert at.generation() == g0 + 1
    # untouched kernels keep their defaults
    assert at.tile("exit_update", "vt") == at.DEFAULT_TILES[
        "exit_update"]["vt"]
    assert at.current_tiles()["rmsnorm"] == {"rows": 4}
    at.reset_tiles()
    assert at.tile("rmsnorm", "rows") == 1
    assert at.current_tiles() == at.DEFAULT_TILES
    assert at.generation() == g0 + 2


def test_installed_tiles_reach_the_wrappers():
    """The wrappers read the registry at call time: the decode split (its
    one candidate) and the confidence cluster cap."""
    assert decode_attention.split_plan(512) == (32, 16)
    assert decode_attention.split_plan(1024) == (64, 16)
    assert confidence.plan(151936) == 16
    at.install_tiles({"decode_attention": {"max_splits": 16},
                      "confidence": {"max_cluster": 8}})
    assert decode_attention.split_plan(512) == (32, 16)
    assert confidence.plan(151936) == 8
    at.reset_tiles()
    assert confidence.plan(151936) == 16


def test_install_refuses_unknown_and_non_candidate_tiles():
    with pytest.raises(ValueError, match="unknown kernel"):
        at.install_tiles({"nope": {}})
    with pytest.raises(ValueError, match="unknown tile"):
        at.install_tiles({"rmsnorm": {"rt": 8}})
    # another decode split would merge the partials in another order, and
    # paged_gather launches its kernel on the card: one candidate each
    for bad in ({"exit_update": {"vt": 1000}},
                {"decode_attention": {"max_splits": 8}},
                {"paged_gather": {"impl": "take"}},
                {"flash_attention": {"tq": 128}}):
        with pytest.raises(ValueError, match="not a candidate"):
            at.install_tiles(bad)
    assert at.current_tiles() == at.DEFAULT_TILES
    # each kernel's tile installs on its own
    at.install_tiles({"exit_update": {"vt": 2048}})
    assert at.tile("exit_update", "vt") == 2048
    assert at.tile("megakernel", "tc_ctas") == 0
    at.install_tiles({"megakernel": {"tc_ctas": 66, "rows": 8}})
    assert at.tile("megakernel", "tc_ctas") == 66
    assert at.tile("exit_update", "vt") == 2048


# ---------------------------------------------------------------------------
# another exit split keeps the argmax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("V", [32256, 151936, 256000])
def test_every_exit_split_keeps_the_argmax(V):
    """Another exit-update vocab tile sums Σexp in another order: the
    argmax (first index of the maximum) is the same, δ within 1e-6."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy((3 * rng.standard_normal((4, V)))
                         .astype(np.float32))
    x[1, 17] = x[1, V - 3] = x[1].max() + 1.0   # a tie across tiles
    carry = (torch.zeros(4, dtype=torch.bool),
             torch.zeros(4, dtype=torch.int32),
             torch.zeros(4, dtype=torch.int32), torch.zeros(4),
             torch.zeros(4, dtype=torch.int32), torch.zeros(4),
             torch.ones(4, dtype=torch.bool))
    outs = [ref.ref_exit_update_split(x, *carry, threshold=torch.tensor(
        1e-4), m=0, n_components=2, tile=c["vt"])
        for c in at.CANDIDATE_TILES["exit_update"]]
    assert outs[0][1][1] == 17
    for o in outs[1:]:
        for k in (0, 1, 2, 4):
            assert torch.equal(o[k], outs[0][k])
        np.testing.assert_allclose(o[3].numpy(), outs[0][3].numpy(),
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# the sweep's bookkeeping (the timer monkeypatched on the CPU)
# ---------------------------------------------------------------------------

def test_sweep_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the sweep runs")
    with pytest.raises(RuntimeError, match="CUDA device"):
        at.sweep(["rmsnorm"])


def test_sweep_rows_speedup_and_provenance(monkeypatch):
    fastest = {"exit_update": {"vt": 8192}}
    _fake_sweep_device(monkeypatch, fastest)
    winners, rows = at.sweep(["rmsnorm", "paged_gather", "exit_update",
                              "megakernel"], reps=1)
    assert set(winners) == {"rmsnorm", "paged_gather", "exit_update",
                            "megakernel"}
    assert winners["exit_update"] == {"vt": 8192}
    # the tiny preset's norm takes the warp route, where no rows tile
    # reaches the launch: the default is the one candidate timed
    assert winners["rmsnorm"] == at.DEFAULT_TILES["rmsnorm"]
    assert winners["paged_gather"] == {"impl": "cuda"}
    # every other megakernel candidate took 2 µs: the first distinct
    # launch after the default's wins (B = 8 f32 is the cuda_core route:
    # tc_ctas does not reach it)
    assert winners["megakernel"] == {"tc_ctas": 0, "rows": 2}
    assert rows
    for r in rows:
        assert r["tuned_speedup"] >= 1.0, r
        assert r["backend"] == "cuda" and r["device"]
        assert r["default_us"] > 0 and r["tuned_us"] > 0
        assert r["tiles"] == winners[r["kernel"]]
        assert r["default_tiles"] == at.DEFAULT_TILES[r["kernel"]]
    n_shapes = {k: len(at.SWEEP_SHAPES["tiny"][k]) for k in winners}
    assert len(rows) == sum(n_shapes.values())
    # the sweep installs nothing itself
    assert at.current_tiles() == at.DEFAULT_TILES


@pytest.mark.parametrize("preset,timed", [
    ("tiny", {"decode_attention": 1, "flash_attention": 1, "rmsnorm": 1,
              "confidence": 1, "exit_update": 3, "megakernel": 3,
              "paged_gather": 1}),
    ("serving", {"decode_attention": 1, "flash_attention": 1, "rmsnorm": 4,
                 "confidence": 4, "exit_update": 3, "megakernel": 3,
                 "paged_gather": 1})])
def test_sweep_times_one_candidate_per_distinct_launch(monkeypatch, preset,
                                                       timed):
    """Candidates that make the same launch at every shape of the preset
    are timed once, the default first: at the serving preset's B = 4 both
    megakernel shapes (d 2048 and deepseek-coder-33b's 7168) take the tc
    route, which rows does not reach (3 launches of 9: one per tc_ctas);
    the tiny preset's norm (warp route) and confidence (C = 1 at V 2048)
    have one launch each."""
    monkeypatch.setattr(at, "_require_cuda", lambda device: torch.device(
        "cpu"))
    monkeypatch.setattr(at, "_sm_count", lambda device: 132)
    monkeypatch.setattr(at, "_make_call",
                        lambda kernel, shape, device: lambda: None)
    seen = {}

    def timer(fn, reps=5):
        for kernel, tiles in at._TUNED.items():
            seen.setdefault(kernel, [])
            if tiles not in seen[kernel]:
                seen[kernel].append(dict(tiles))
        return 1.0
    monkeypatch.setattr(at, "_time_us", timer)
    winners, rows = at.sweep(shapes=preset, reps=1)
    assert {k: len(v) for k, v in seen.items()} == timed
    for kernel, tried in seen.items():
        assert tried[0] == at.DEFAULT_TILES[kernel]
        # equal times: the default stays
        assert winners[kernel] == at.DEFAULT_TILES[kernel]
    assert all(r["tuned_speedup"] == 1.0 for r in rows)


def test_sweep_keeps_the_default_when_it_wins(monkeypatch):
    monkeypatch.setattr(at, "_require_cuda", lambda device: torch.device(
        "cpu"))

    def timer(fn, reps=5):
        fn()
        tiles = at._TUNED["confidence"]
        return 1.0 if tiles == at.DEFAULT_TILES["confidence"] else 5.0
    monkeypatch.setattr(at, "_time_us", timer)
    winners, rows = at.sweep(["confidence"], reps=1)
    assert winners["confidence"] == at.DEFAULT_TILES["confidence"]
    assert all(r["tuned_speedup"] == 1.0 for r in rows)


def test_sweep_never_installs_a_loss_on_any_shape(monkeypatch):
    """A candidate faster in total but slower than the default on one
    shape of the preset is not installed: every row keeps its speedup >=
    1.0 (the serving preset's exit_update has three shapes)."""
    monkeypatch.setattr(at, "_require_cuda", lambda device: torch.device(
        "cpu"))
    monkeypatch.setitem(at.SWEEP_SHAPES, "tiny", {
        **at.SWEEP_SHAPES["tiny"],
        "exit_update": [{"B": 2, "V": 300}, {"B": 2, "V": 500}]})
    # 2048 wins the total (1 + 9) but loses V = 500 (9 > 5); 8192 is no
    # slower anywhere
    table = {2048: {300: 1.0, 500: 9.0}, 4096: {300: 10.0, 500: 5.0},
             8192: {300: 8.0, 500: 5.0}}
    shape_of = {}
    real = at._make_call

    def make_call(kernel, shape, device):
        fn = real(kernel, shape, device)
        if kernel == "exit_update":
            shape_of[fn] = shape["V"]
        return fn

    def timer(fn, reps=5):
        fn()
        return table[at._TUNED["exit_update"]["vt"]][shape_of[fn]]
    monkeypatch.setattr(at, "_make_call", make_call)
    monkeypatch.setattr(at, "_time_us", timer)
    winners, rows = at.sweep(["exit_update"], reps=1)
    assert winners["exit_update"] == {"vt": 8192}
    assert all(r["tuned_speedup"] >= 1.0 for r in rows)


# ---------------------------------------------------------------------------
# the artifact
# ---------------------------------------------------------------------------

def _canned_sweep(calls):
    tiles = {"rmsnorm": {"rows": 2}, "exit_update": {"vt": 2048},
             "megakernel": {"tc_ctas": 96, "rows": 4}}
    rows = [{"kernel": "rmsnorm", "shape": "R=32;d=256", "tiles": {"rows": 2},
             "default_tiles": {"rows": 1}, "default_us": 3.0,
             "tuned_us": 2.0, "tuned_speedup": 1.5, "backend": "cuda",
             "device": "cpu"}]

    def sweep(kernels=None, shapes="tiny", reps=5, device=None):
        calls.append(shapes)
        return {k: dict(v) for k, v in tiles.items()}, rows
    return sweep


def test_artifact_roundtrip_and_load_skips_sweep(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(at, "sweep", _canned_sweep(calls))
    art = at.ensure_tuned(artifact_dir=str(tmp_path), device="cpu")
    assert calls == ["tiny"]
    path = at.tile_artifact_path(str(tmp_path), art.config_key)
    with open(path) as f:
        on_disk = at.TileArtifact.from_json(json.load(f))
    assert on_disk.tiles == art.tiles
    assert on_disk.config_key == art.config_key == at.tune_key(
        "tiny", "cpu")
    assert all(r["tuned_speedup"] >= 1.0 for r in on_disk.rows)
    assert at.tile("megakernel", "tc_ctas") == 96
    # the process's second call for the key installs what it has
    assert at.ensure_tuned(artifact_dir=str(tmp_path), device="cpu") is art
    # a fresh process (the registry reset) LOADS, and does not re-sweep
    at.reset_tiles()

    def boom(*a, **k):
        raise AssertionError("re-swept despite a matching artifact")
    monkeypatch.setattr(at, "sweep", boom)
    art2 = at.ensure_tuned(artifact_dir=str(tmp_path), device="cpu")
    assert art2.tiles == art.tiles
    want = at.current_tiles()
    for k, v in art.tiles.items():
        assert want[k] == {**at.DEFAULT_TILES[k], **v}
    # no temporary file is left beside the artifact
    assert [p.name for p in tmp_path.iterdir()] == [path.split("/")[-1]]


def test_tune_key_covers_device_preset_and_shapes(monkeypatch):
    keys = {at.tune_key("tiny", "cpu"), at.tune_key("serving", "cpu")}
    assert len(keys) == 2
    monkeypatch.setattr(at, "_device_name", lambda device: "NVIDIA H100")
    assert at.tune_key("tiny", "cuda") not in keys
    shapes = {k: [dict(s) for s in v]
              for k, v in at.SWEEP_SHAPES["tiny"].items()}
    shapes["rmsnorm"][0]["R"] += 1
    monkeypatch.setitem(at.SWEEP_SHAPES, "tiny", shapes)
    assert at.tune_key("tiny", "cpu") not in keys


def test_mismatched_key_warns_and_falls_back(tmp_path, caplog):
    key = at.tune_key("tiny", "cpu")
    stale = at.TileArtifact(
        config_key="0" * 64, device="another card", backend="cuda",
        shapes="tiny", tiles={"rmsnorm": {"rows": 8}}, rows=[])
    # place the stale artifact exactly where this process would look
    with open(at.tile_artifact_path(str(tmp_path), key), "w") as f:
        json.dump(stale.to_json(), f)
    with caplog.at_level("WARNING"):
        assert at.load_tile_artifact(str(tmp_path), "tiny", "cpu") is None
    assert any("falling back to default tiles" in r.getMessage()
               for r in caplog.records)
    # and nothing was installed
    assert at.tile("rmsnorm", "rows") == 1


def test_artifact_version_check():
    d = at.TileArtifact(config_key="x", device="cpu", backend="cuda",
                        shapes="tiny", tiles={}, rows=[]).to_json()
    d["version"] = at.TILE_ARTIFACT_VERSION + 1
    with pytest.raises(ValueError, match="version"):
        at.TileArtifact.from_json(d)


# ---------------------------------------------------------------------------
# the engine installs before anything runs
# ---------------------------------------------------------------------------

def _tiny_cfg(**kt):
    cfg = reduced(get_config("qwen2.5-3b")).replace(
        dtype="float32", use_kernels=True).with_cascade(
        thresholds=(0.0365, 0.0), exit_mode="cond_batch")
    return cfg.with_kernel_tune(**kt) if kt else cfg


def _serve(cfg, params, runtime):
    eng = CascadeServingEngine(cfg, build_model(cfg, device="cpu"), params,
                               lane_batch=2, n_lanes=2, cache_len=32,
                               runtime=runtime, chunk=4, device="cpu")
    rng = np.random.default_rng(3)
    for i in range(4):
        eng.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, 6).astype(np.int32), max_new_tokens=5))
    return eng.run(100)


@pytest.mark.parametrize("runtime", ["host", "device"])
def test_engine_installs_an_artifact_before_serving(tmp_path, monkeypatch,
                                                    runtime):
    """``kernel_tune.enabled`` loads this device's artifact (no sweep) in
    the engine's constructor, the decode loop's reuses it, and the streams
    equal the default tiles' (the plain versions on the CPU)."""
    key = at.tune_key("tiny", "cpu")
    at.save_tile_artifact(str(tmp_path), at.TileArtifact(
        config_key=key, device="cpu", backend="cuda", shapes="tiny",
        tiles={"confidence": {"max_cluster": 4},
               "exit_update": {"vt": 8192},
               "megakernel": {"tc_ctas": 0, "rows": 2}}, rows=[]))

    def boom(*a, **k):
        raise AssertionError("swept despite a matching artifact")
    monkeypatch.setattr(at, "sweep", boom)
    cfg = _tiny_cfg()
    params = build_model(cfg, device="cpu").init(0)
    want = _serve(cfg, params, runtime)
    tuned_cfg = _tiny_cfg(enabled=True, artifact_dir=str(tmp_path))
    got = _serve(tuned_cfg, params, runtime)
    assert at.tile("confidence", "max_cluster") == 4
    assert at.tile("exit_update", "vt") == 8192
    assert set(got) == set(want)
    for rid in want:
        assert got[rid]["tokens"] == want[rid]["tokens"], rid
        assert got[rid]["exit_depths"] == want[rid]["exit_depths"], rid


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sweep times the CUDA kernels")
    from repro_torch.utils import resolve_device
    return resolve_device("cuda")


@pytest.mark.cuda
def test_real_sweep_on_card(cuda_device, tmp_path):
    """The tiny preset swept on the card with CUDA events: every row at or
    above 1.0, the artifact written, loaded back with no sweep."""
    art = at.ensure_tuned(artifact_dir=str(tmp_path), shapes="tiny",
                          reps=3, device=cuda_device)
    assert set(art.tiles) == set(at.DEFAULT_TILES)
    assert art.device == torch.cuda.get_device_name(cuda_device)
    assert all(r["tuned_speedup"] >= 1.0 for r in art.rows)
    at.reset_tiles()
    again = at.load_tile_artifact(str(tmp_path), "tiny", cuda_device)
    assert again is not None and again.tiles == art.tiles


@pytest.mark.cuda
def test_install_after_capture_captures_again_on_card(cuda_device):
    """A captured decode graph holds its launch parameters: tiles
    installed after the capture make the next chunk capture again, and
    the streams stay the defaults'."""
    cfg = _tiny_cfg()
    model = build_model(cfg, device=cuda_device)
    params = model.init(0)

    def serve(install=None):
        eng = CascadeServingEngine(cfg, model, params, lane_batch=2,
                                   n_lanes=1, cache_len=32,
                                   runtime="device", chunk=2,
                                   device=cuda_device)
        rng = np.random.default_rng(3)
        for i in range(2):
            eng.submit(Request(rid=i, prompt=rng.integers(
                0, cfg.vocab_size, 6).astype(np.int32), max_new_tokens=6))
        for _ in range(10):     # until the lane's first chunk captured
            eng.step()
            if eng.stats()["captures"]:
                break
        before = eng.stats()["captures"]
        if install:
            at.install_tiles(install)
        out = eng.run(100)
        return out, before, eng.stats()["captures"]

    want, b0, c0 = serve()
    assert c0 == b0 == 1
    got, b1, c1 = serve({"exit_update": {"vt": 2048},
                         "megakernel": {"tc_ctas": 66, "rows": 2}})
    assert b1 == 1 and c1 == 2
    for rid in want:
        assert got[rid]["tokens"] == want[rid]["tokens"], rid
        assert got[rid]["exit_depths"] == want[rid]["exit_depths"], rid
