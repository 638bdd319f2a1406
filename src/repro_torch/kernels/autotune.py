"""Kernel tile autotuner: the launch parameters of the port's CUDA kernels.

The counterpart of the JAX package's ``kernels/autotune.py``, with the same
public surface (``DEFAULT_TILES``, ``CANDIDATE_TILES``, ``SWEEP_SHAPES``,
``tile``, ``install_tiles``, ``reset_tiles``, ``current_tiles``,
``sweep``, ``tune_key``, ``TileArtifact``, ``save_tile_artifact``,
``load_tile_artifact``, ``ensure_tuned``).  The tiles are not Pallas
BlockSpecs here but each hand-written kernel's own launch parameters,
which its wrapper reads from this registry at every call:

- ``decode_attention.max_splits`` — the cap on the blocks a (slot, KV
  head) row is split over (:func:`~repro_torch.kernels.decode_attention.
  split_plan`), a one-candidate set: the kernel merges a row's partials
  in split order, so another split would change its bits;
- ``flash_attention`` — its one compiled tile (64 query rows x 64 keys), a
  one-candidate set;
- ``rmsnorm.rows`` — rows a block of the ``block`` route (bits unchanged);
- ``confidence.max_cluster`` — the cap on the cluster size C of
  :func:`~repro_torch.kernels.confidence.plan`;
- ``exit_update.vt`` — the vocab columns a CTA reduces (the kernel's
  compile-time ``kTile``: 2048, 4096 or 8192);
- ``megakernel.tc_ctas`` — the ``tc`` route's persistent CTAs (0 = one
  per SM) over which :func:`~repro_torch.kernels.megakernel.plan` splits
  the vocab, and ``megakernel.rows`` — the cap on the ``cuda_core``
  route's rows a block (bits unchanged);
- ``paged_gather.impl`` — ``cuda``, the kernel, a one-candidate set (on
  the card every wrapper launches its kernel).

The vocab splits of ``exit_update`` and the megakernel change the order in
which a row's Σexp is summed: δ moves in its last bits, the argmax (the
first index of the maximum) never, so a tuned split changes an exit
decision only where a δ lies within rounding of its threshold.  The
fused and unfused heads sum in different orders at any pair of tiles
(64-column tiles over CTAs against ``vt`` columns a CTA), so each kernel's
tile installs on its own.

:func:`sweep` times the candidates on the card with CUDA events (the
median of repeated launches after a warm-up, queued behind a spin kernel
so that the host's launch overhead stays out), the default always among
them, so ``tuned_speedup >= 1.0`` holds by construction.  Candidates that
make the same launch at every shape of the preset (:func:`launch_of`) are
timed once, as the first of them (the default before any other).
:func:`ensure_tuned` sweeps or loads a keyed JSON artifact (the
``autotune/artifacts.py`` idiom: an atomic write, a key check on load, a
refusal on mismatch) and installs the winners.  A CUDA graph bakes its
launch arguments in: every install bumps :func:`generation`, and the
device decode loop re-captures a lane whose graph is older
(``serving/runtime.py``).  On the CPU the wrappers take their plain
versions, which have no tiles, and :func:`sweep` raises.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import tempfile
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

log = logging.getLogger("repro_torch.kernels.autotune")

TILE_ARTIFACT_VERSION = 1

# the hand-picked launch parameters: every kernel's no-registry value, and
# always a member of its candidate set (the >= 1.0 tuned-speedup
# invariant)
DEFAULT_TILES: Dict[str, Dict[str, Any]] = {
    "decode_attention": {"max_splits": 16},
    "flash_attention": {"tq": 64, "tk": 64},
    "rmsnorm": {"rows": 1},
    "confidence": {"max_cluster": 16},
    "exit_update": {"vt": 4096},
    "megakernel": {"tc_ctas": 0, "rows": 8},
    "paged_gather": {"impl": "cuda"},
}

CANDIDATE_TILES: Dict[str, List[Dict[str, Any]]] = {
    "decode_attention": [{"max_splits": 16}],
    "flash_attention": [{"tq": 64, "tk": 64}],
    "rmsnorm": [{"rows": r} for r in (1, 2, 4, 8)],
    "confidence": [{"max_cluster": c} for c in (2, 4, 8, 16)],
    "exit_update": [{"vt": v} for v in (2048, 4096, 8192)],
    "megakernel": [{"tc_ctas": c, "rows": r}
                   for c in (0, 66, 96) for r in (2, 4, 8)],
    "paged_gather": [{"impl": "cuda"}],
}

# sweep presets: kernel -> shape dicts.  "tiny" holds the JAX package's
# CI-sized shapes (f32); "serving" the dense family's decode shapes on the
# card (bf16, B = 4, cache 512): qwen2.5-3b, deepseek-coder-33b and
# minitron-4b's norms, heads and attention.
SWEEP_SHAPES: Dict[str, Dict[str, List[Dict[str, Any]]]] = {
    "tiny": {
        "decode_attention": [{"B": 4, "KV": 2, "qpk": 2, "hd": 64,
                              "W": 128}],
        "flash_attention": [{"B": 2, "H": 4, "KV": 2, "hd": 64, "S": 128}],
        "rmsnorm": [{"R": 32, "d": 256}],
        "confidence": [{"B": 8, "V": 2048}],
        "exit_update": [{"B": 8, "V": 2048}],
        "megakernel": [{"B": 8, "d": 256, "V": 2048}],
        "paged_gather": [{"NB": 32, "bs": 16, "kv": 2, "hd": 64, "B": 4,
                          "nblk": 8}],
    },
    "serving": {
        "decode_attention": [
            {"B": 4, "KV": 2, "qpk": 8, "hd": 128, "W": 512,
             "dtype": "bf16"},
            {"B": 4, "KV": 8, "qpk": 7, "hd": 128, "W": 512,
             "dtype": "bf16"},
            {"B": 4, "KV": 8, "qpk": 3, "hd": 128, "W": 512,
             "dtype": "bf16"}],
        "flash_attention": [{"B": 4, "H": 16, "KV": 2, "hd": 128, "S": 256,
                             "dtype": "bf16"}],
        "rmsnorm": [{"R": 4, "d": 7168, "dtype": "bf16"},
                    {"R": 1024, "d": 7168, "dtype": "bf16"}],
        "confidence": [{"B": 4, "V": 151936, "dtype": "bf16"},
                       {"B": 64, "V": 151936, "dtype": "bf16"},
                       {"B": 4, "V": 256000, "dtype": "bf16"}],
        "exit_update": [{"B": 4, "V": 151936, "dtype": "bf16"},
                        {"B": 4, "V": 32256, "dtype": "bf16"},
                        {"B": 4, "V": 256000, "dtype": "bf16"}],
        "megakernel": [{"B": 4, "d": 2048, "V": 151936, "dtype": "bf16"},
                       {"B": 4, "d": 7168, "V": 32256, "dtype": "bf16"}],
        "paged_gather": [{"NB": 193, "bs": 64, "kv": 2, "hd": 128, "B": 4,
                          "nblk": 8, "dtype": "bf16"}],
    },
}

# ---------------------------------------------------------------------------
# the tile registry the kernel wrappers read
# ---------------------------------------------------------------------------

_TUNED: Dict[str, Dict[str, Any]] = {}
_GENERATION = [0]
# tune key -> the artifact installed in this process (ensure_tuned's
# second call for one key, e.g. the engine's and its decode loop's, is a
# lookup)
_INSTALLED: Dict[str, "TileArtifact"] = {}


def tile(kernel: str, param: str):
    """The resolved value of one launch parameter: tuned if installed,
    else the hand-picked default.  Read by the kernel wrappers at every
    call."""
    tuned = _TUNED.get(kernel)
    if tuned is not None and param in tuned:
        return tuned[param]
    return DEFAULT_TILES[kernel][param]


def _check_tiles(kernel: str, params: Dict[str, Any]) -> None:
    if kernel not in DEFAULT_TILES:
        raise ValueError(f"unknown kernel {kernel!r}")
    unknown = set(params) - set(DEFAULT_TILES[kernel])
    if unknown:
        raise ValueError(f"{kernel}: unknown tile parameters "
                         f"{sorted(unknown)}")
    merged = {**DEFAULT_TILES[kernel], **params}
    if merged not in CANDIDATE_TILES[kernel] \
            and merged != DEFAULT_TILES[kernel]:
        raise ValueError(f"{kernel}: {merged} is not a candidate tile")


def install_tiles(tiles: Dict[str, Dict[str, Any]]) -> None:
    """Install tiles into the registry (merged per kernel); a tile that is
    not a candidate is refused.  An install that changes the effective
    table bumps :func:`generation`."""
    for kernel, params in tiles.items():
        _check_tiles(kernel, params)
    before = current_tiles()
    for kernel, params in tiles.items():
        _TUNED.setdefault(kernel, {}).update(params)
    if current_tiles() != before:
        _GENERATION[0] += 1


def reset_tiles() -> None:
    """Drop every installed tile (the defaults apply again)."""
    changed = current_tiles() != DEFAULT_TILES
    _TUNED.clear()
    _INSTALLED.clear()
    if changed:
        _GENERATION[0] += 1


def current_tiles() -> Dict[str, Dict[str, Any]]:
    """The effective tile table: defaults overlaid with installs."""
    out = {k: dict(v) for k, v in DEFAULT_TILES.items()}
    for k, v in _TUNED.items():
        out[k].update(v)
    return out


def generation() -> int:
    """A count of the installs that changed the effective tiles: a CUDA
    graph captured at another generation launches stale tiles."""
    return _GENERATION[0]


# ---------------------------------------------------------------------------
# timing (CUDA events)
# ---------------------------------------------------------------------------

def _time_us(fn: Callable[[], Any], reps: int = 30) -> float:
    """Median device time of one ``fn()`` in µs: warm-up calls (the first
    also builds and loads the kernel), then CUDA events around each of
    ``reps`` back-to-back calls.  A spin kernel queued first keeps the
    device busy while the host enqueues the calls, so the intervals hold
    the device's work and not the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(20_000_000)      # ~10 ms of spinning at ~2 GHz
    events[0].record()
    for e in events[1:]:
        fn()
        e.record()
    events[-1].synchronize()
    return 1e3 * float(np.median([a.elapsed_time(b)
                                  for a, b in zip(events, events[1:])]))


def _shape_tag(shape: Dict[str, Any]) -> str:
    return ";".join(f"{k}={v}" for k, v in sorted(shape.items()))


_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _make_call(kernel: str, shape: Dict[str, Any], device
               ) -> Callable[[], Any]:
    """A zero-arg call of ``kernel``'s wrapper on inputs of ``shape``
    (made once, from seed 0), reading the registry's tiles when it
    runs."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=device).manual_seed(0)
    dt = _DTYPES[shape.get("dtype", "f32")]

    def arr(*s, dtype=dt):
        return torch.randn(s, generator=g, device=device).to(dtype)

    if kernel == "decode_attention":
        B, KV, qpk, hd, W = (shape[k] for k in ("B", "KV", "qpk", "hd", "W"))
        q = arr(B, KV * qpk, hd)
        k, v = arr(B, W, KV, hd), arr(B, W, KV, hd)
        kpos = torch.arange(W, dtype=torch.int32, device=device)
        t = torch.full((), W - 1, dtype=torch.int32, device=device)
        return lambda: ops.decode_attention(q, k, v, t, kpos)
    if kernel == "flash_attention":
        B, H, KV, hd, S = (shape[k] for k in ("B", "H", "KV", "hd", "S"))
        q, k, v = arr(B, H, S, hd), arr(B, KV, S, hd), arr(B, KV, S, hd)
        return lambda: ops.flash_attention(q, k, v)
    if kernel == "rmsnorm":
        x = arr(shape["R"], shape["d"])
        w = torch.ones(shape["d"], device=device)
        return lambda: ops.rmsnorm(x, w)
    if kernel == "confidence":
        x = arr(shape["B"], shape["V"])
        return lambda: ops.confidence(x)
    B = shape.get("B", 0)
    zi = torch.zeros(B, dtype=torch.int32, device=device)
    zf = torch.zeros(B, dtype=torch.float32, device=device)
    zb = torch.zeros(B, dtype=torch.bool, device=device)
    ones = torch.ones(B, dtype=torch.bool, device=device)
    carry = (zb, zi, zi, zf, zi, zf, ones)
    kw = dict(threshold=0.5, m=0, n_components=2)
    if kernel == "exit_update":
        x = arr(B, shape["V"])
        return lambda: ops.exit_update(x, *carry, **kw)
    if kernel == "megakernel":
        h = arr(B, shape["d"])
        w = torch.ones(shape["d"], device=device)
        head = arr(shape["d"], shape["V"]) * shape["d"] ** -0.5
        return lambda: ops.exit_head_update(h, w, head, *carry, **kw)
    if kernel == "paged_gather":
        table = torch.randint(0, shape["NB"], (shape["B"], shape["nblk"]),
                              generator=g, device=device,
                              dtype=torch.int64).to(torch.int32)
        store = arr(shape["NB"], shape["bs"], shape["kv"], shape["hd"])
        return lambda: ops.paged_gather(store, table)
    raise ValueError(f"unknown kernel {kernel!r}")


def _require_cuda(device) -> torch.device:
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            "the kernel tile sweep times the CUDA kernels with CUDA events: "
            "it needs a CUDA device (on the CPU the wrappers take their "
            "plain versions, which have no tiles)")
    return device


def _device_name(device) -> str:
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(device)


def launch_of(kernel: str, params: Dict[str, Any], shape: Dict[str, Any],
              n_sm: int) -> tuple:
    """What ``kernel``'s wrapper launches on the sweep's inputs of
    ``shape`` under the tiles ``params`` on a card of ``n_sm`` SMs, as far
    as the tiles reach it: the route, and the grid or the compiled tile
    they set.  Two candidates with equal launches at every shape of a
    preset run the same work (the megakernel's ``rows`` 4 and 8 at B = 4,
    its ``tc_ctas`` on the ``cuda_core`` route, rmsnorm's ``rows`` on the
    ``warp`` route).  The ``cuda_core`` route's shared-memory cap on its
    rows is left out: it can only make more candidates equal."""
    from repro_torch.kernels import confidence, megakernel, rmsnorm
    esz = 2 if shape.get("dtype", "f32") == "bf16" else 4
    if kernel == "rmsnorm":
        d = shape["d"]
        if d * esz % 16 == 0 and d * esz // 16 <= rmsnorm.MAX_CHUNKS:
            return ("warp",)
        # grid ceil(R / rows): rows past R launch what R rows a block does
        return ("block", min(params["rows"], shape["R"]))
    if kernel == "confidence":
        return (confidence.plan(shape["V"], params["max_cluster"]),)
    if kernel == "exit_update":
        return (params["vt"],)     # a kernel instantiation each
    if kernel == "megakernel":
        B, d, V = shape["B"], shape["d"], shape["V"]
        if (esz == 2 and B <= megakernel._TC_MAX_B and d % 8 == 0
                and megakernel.tc_stages(B, d) and V % 8 == 0):
            n = params["tc_ctas"] or n_sm
            return ("tc", min(n, n_sm, -(-V // megakernel.TC_COLS)))
        rows = next(n for n in (1, 2, 4, 8) if n >= min(B, 8))
        return ("cuda_core", min(params["rows"], rows))
    return tuple(sorted(params.items()))


def _sm_count(device: torch.device) -> int:
    if device.type != "cuda":
        return 1 << 30      # no card: no cap from the SM count
    return torch.cuda.get_device_properties(device).multi_processor_count


def sweep(kernels: Optional[List[str]] = None, shapes: str = "tiny",
          reps: int = 30, device=None,
          ) -> Tuple[Dict[str, Dict[str, Any]], List[Dict[str, Any]]]:
    """Time every candidate tile for every kernel on the card; return
    ``(winners, rows)``.

    ``winners[kernel]`` is the candidate with the least total time over
    the preset's shapes among those no slower than the default on any of
    them.  Of the candidates with equal launches at every shape
    (:func:`launch_of`) only the first is timed, the default before any
    other, so no candidate wins on the noise of a launch it shares.
    ``rows`` holds one record per (kernel, shape): the default's and the
    winner's µs from the SAME sweep (so ``tuned_speedup >= 1.0`` holds on
    every row by construction), the device name and the backend."""
    device = _require_cuda(device)
    name = _device_name(device)
    n_sm = _sm_count(device)
    kernels = list(kernels or DEFAULT_TILES)
    preset = SWEEP_SHAPES[shapes]
    winners: Dict[str, Dict[str, Any]] = {}
    rows: List[Dict[str, Any]] = []
    saved = {k: dict(v) for k, v in _TUNED.items()}
    try:
        for kernel in kernels:
            default = DEFAULT_TILES[kernel]
            shape_list = preset[kernel]
            cands, seen = [], set()
            for c in [default] + CANDIDATE_TILES[kernel]:
                launch = tuple(launch_of(kernel, c, s, n_sm)
                               for s in shape_list)
                if launch not in seen:
                    seen.add(launch)
                    cands.append(c)
            calls = [_make_call(kernel, s, device) for s in shape_list]
            # times[c][s] = µs of candidate c on shape s
            times = []
            for c in cands:
                _TUNED[kernel] = dict(c)
                times.append([_time_us(fn, reps) for fn in calls])
            _TUNED.pop(kernel, None)
            if kernel in saved:
                _TUNED[kernel] = dict(saved[kernel])
            del calls
            # the least total time among the candidates no slower than the
            # default on any shape (the default is one): every row's
            # speedup is then >= 1.0
            di = 0      # the default: cands[0]
            totals = [sum(ts) if all(t <= d for t, d in zip(ts, times[di]))
                      else float("inf") for ts in times]
            best = int(np.argmin(totals))
            winners[kernel] = dict(cands[best])
            for si, s in enumerate(shape_list):
                rows.append({
                    "kernel": kernel,
                    "shape": _shape_tag(s),
                    "tiles": dict(cands[best]),
                    "default_tiles": dict(default),
                    "default_us": times[di][si],
                    "tuned_us": times[best][si],
                    # the installed (per-kernel) winner's speedup on this
                    # shape, not the per-shape best's
                    "tuned_speedup": times[di][si] / max(times[best][si],
                                                         1e-9),
                    "backend": "cuda",
                    "device": name,
                })
            log.info("kernel %s: tuned %s (default %s)", kernel,
                     winners[kernel], default)
    finally:
        _TUNED.clear()
        _TUNED.update(saved)
    return winners, rows


# ---------------------------------------------------------------------------
# the keyed tile artifact (the autotune/artifacts.py idiom)
# ---------------------------------------------------------------------------

def tune_key(shapes: str = "tiny", device=None) -> str:
    """Stable identity of a tile sweep: tiles transfer only between
    processes on the same device model and backend, with the same
    candidate grids, defaults, preset and preset shapes."""
    ident = {
        "version": TILE_ARTIFACT_VERSION,
        "device": _device_name(device),
        "backend": "cuda",
        "shapes": shapes,
        "shape_dicts": SWEEP_SHAPES[shapes],
        "candidates": CANDIDATE_TILES,
        "defaults": DEFAULT_TILES,
    }
    blob = json.dumps(ident, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


@dataclasses.dataclass
class TileArtifact:
    """One persisted tile sweep: the winners plus the timing evidence."""

    config_key: str
    device: str
    backend: str
    shapes: str
    tiles: Dict[str, Dict[str, Any]]
    rows: List[Dict[str, Any]]

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["version"] = TILE_ARTIFACT_VERSION
        return d

    @classmethod
    def from_json(cls, d: dict) -> "TileArtifact":
        d = dict(d)
        ver = d.pop("version", TILE_ARTIFACT_VERSION)
        if ver != TILE_ARTIFACT_VERSION:
            raise ValueError(
                f"tile artifact version {ver} != {TILE_ARTIFACT_VERSION}")
        return cls(**d)


def tile_artifact_path(artifact_dir: str, key: str) -> str:
    return os.path.join(artifact_dir, f"kernel_tiles_{key[:16]}.json")


def save_tile_artifact(artifact_dir: str, artifact: TileArtifact) -> str:
    """Atomically persist; returns the written path."""
    os.makedirs(artifact_dir, exist_ok=True)
    path = tile_artifact_path(artifact_dir, artifact.config_key)
    fd, tmp = tempfile.mkstemp(dir=artifact_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(artifact.to_json(), f, indent=2)
            f.write("\n")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_tile_artifact(artifact_dir: str, shapes: str = "tiny", device=None
                       ) -> Optional[TileArtifact]:
    """The artifact matching this process's tune key, or None.

    A key mismatch inside the file (a hand-copied artifact, another device
    model, candidate grid or preset) WARNS and returns None — the caller
    falls back to the default tiles and may re-sweep; stale tiles are
    never installed silently."""
    key = tune_key(shapes, device)
    path = tile_artifact_path(artifact_dir, key)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        art = TileArtifact.from_json(json.load(f))
    if art.config_key != key:
        log.warning(
            "tile artifact %s was swept under key %s..., not this device's "
            "%s... — falling back to default tiles", path,
            art.config_key[:16], key[:16])
        return None
    return art


def ensure_tuned(cfg=None, artifact_dir: Optional[str] = None,
                 shapes: Optional[str] = None, reps: int = 30,
                 force: bool = False, device=None) -> TileArtifact:
    """Load-or-sweep, then install: the one entry point engine builds use.

    Resolution order: the artifact this process already installed for the
    key > a matching artifact in ``artifact_dir`` (no sweep) > a fresh
    :func:`sweep` on ``device`` (persisted when ``artifact_dir`` is set).
    ``cfg`` supplies ``kernel_tune.artifact_dir`` / ``kernel_tune.shapes``
    defaults.  Returns the installed artifact.  Call it before any CUDA
    graph is captured: a later install makes the device decode loop
    capture again."""
    if cfg is not None:
        if artifact_dir is None:
            artifact_dir = cfg.kernel_tune.artifact_dir
        if shapes is None:
            shapes = cfg.kernel_tune.shapes
    shapes = shapes or "tiny"
    key = tune_key(shapes, device)
    art = None if force else _INSTALLED.get(key)
    if art is None and artifact_dir and not force:
        art = load_tile_artifact(artifact_dir, shapes, device)
    if art is None:
        tiles, rows = sweep(shapes=shapes, reps=reps, device=device)
        art = TileArtifact(config_key=key, device=_device_name(device),
                           backend="cuda", shapes=shapes, tiles=tiles,
                           rows=rows)
        if artifact_dir:
            save_tile_artifact(artifact_dir, art)
    install_tiles(art.tiles)
    _INSTALLED[key] = art
    return art
