"""Config-hash-keyed calibration artifacts: persist a resolved threshold
vector (plus the evidence behind it) so a serving fleet warm-starts from
the last calibration instead of re-learning thresholds from cold
telemetry.

An artifact is one JSON file named by the config key — a stable hash over
exactly the fields that make a calibration transferable (architecture
identity, cascade structure, confidence measure, histogram resolution).
Two configs with the same key may exchange thresholds; anything else
(different exit boundaries, different measure, different bin grid) may
not, and :func:`load_artifact` refuses rather than silently mis-warming.

Writes are atomic (write-to-temp + rename).

A copy of the JAX package's ``autotune/artifacts.py`` (numpy and the
standard library only): :func:`config_key` gives the same digest for the
same config in either package, so an artifact written by one loads in the
other (pinned by ``tests/test_torch_calibration.py``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Optional, Sequence, Tuple

ARTIFACT_VERSION = 1


def config_key(cfg) -> str:
    """Stable identity of a calibration: sha256 over the fields a threshold
    vector depends on.  Deliberately excludes serving-shape knobs (lane
    batch, chunk, runtime) — thresholds transfer across those."""
    ident = {
        "version": ARTIFACT_VERSION,
        "name": cfg.name,
        "n_layers": cfg.n_layers,
        "vocab_size": cfg.vocab_size,
        "segments": [list(s) for s in cfg.segments],
        "n_components": cfg.cascade.n_components,
        "confidence": cfg.cascade.confidence,
        "bins": cfg.autotune.bins,
    }
    blob = json.dumps(ident, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


@dataclasses.dataclass
class CalibrationArtifact:
    """One persisted calibration: the resolved thresholds plus enough
    provenance to audit (and re-seed) them."""

    config_key: str
    thresholds: Tuple[float, ...]
    direction: str                    # "epsilon" | "macs"
    target: float                     # the ε or the MAC budget
    bins: int
    mac_prefix: Tuple[float, ...]
    agreement: float                  # solver's expected agreement
    avg_macs: float                   # solver's expected avg MACs/sample
    shadow_steps: float               # evidence size behind the solve
    edges: Tuple[int, ...] = ()
    # provenance: "engine" = one engine's controller solved this;
    # "fleet" = a TelemetryAggregator solved it on merged fleet telemetry
    # (larger evidence window per wall-clock second — preferred seed for
    # fresh engines).  Absent in pre-fleet artifact files → "engine".
    source: str = "engine"

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["version"] = ARTIFACT_VERSION
        return d

    @classmethod
    def from_json(cls, d: dict) -> "CalibrationArtifact":
        d = dict(d)
        ver = d.pop("version", ARTIFACT_VERSION)
        if ver != ARTIFACT_VERSION:
            raise ValueError(f"artifact version {ver} != {ARTIFACT_VERSION}")
        d["thresholds"] = tuple(float(t) for t in d["thresholds"])
        d["mac_prefix"] = tuple(float(m) for m in d["mac_prefix"])
        d["edges"] = tuple(int(e) for e in d.get("edges", ()))
        return cls(**d)


def artifact_path(artifact_dir: str, key: str) -> str:
    return os.path.join(artifact_dir, f"autotune_{key[:16]}.json")


def save_artifact(artifact_dir: str, artifact: CalibrationArtifact) -> str:
    """Atomically persist; returns the written path."""
    os.makedirs(artifact_dir, exist_ok=True)
    path = artifact_path(artifact_dir, artifact.config_key)
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


def load_artifact(artifact_dir: str, cfg) -> Optional[CalibrationArtifact]:
    """The artifact matching this config's key, or None.  A key mismatch
    inside the file (hand-copied artifact) raises rather than mis-warms."""
    key = config_key(cfg)
    path = artifact_path(artifact_dir, key)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        art = CalibrationArtifact.from_json(json.load(f))
    if art.config_key != key:
        raise ValueError(
            f"artifact {path} was calibrated for config key "
            f"{art.config_key[:16]}..., not this config's {key[:16]}...")
    if len(art.thresholds) != cfg.cascade.n_components:
        raise ValueError(
            f"artifact {path} has {len(art.thresholds)} thresholds for "
            f"{cfg.cascade.n_components} components")
    return art
