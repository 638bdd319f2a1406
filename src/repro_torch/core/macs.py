"""Analytic MAC accounting for the cascade segments (dense family).

The counterpart of ``segment_macs_per_token`` in the JAX package's
``core/macs.py``: decode-time MACs of each cascade segment, the quantity
the early exit saves, which the serving engine's analytic speedup reads.
"""
from __future__ import annotations

from typing import List

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import layer_kinds


def _layer_macs_per_token(cfg: ModelConfig, kind: str, kv_len: int) -> float:
    """Decode-time MACs of one layer for one new token, KV length kv_len."""
    if kind != "dense":
        raise NotImplementedError(f"MACs of {kind!r} layers are not ported")
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    eff_kv = min(kv_len, cfg.attn_window) if cfg.attn_window else kv_len
    attn = d * (H * hd) + 2 * d * (KV * hd) + (H * hd) * d \
        + H * hd * eff_kv * 2                    # projections + qk + pv
    mlp = (3 if cfg.act == "swiglu" else 2) * d * cfg.d_ff
    return float(attn + mlp)


def exit_head_macs(cfg: ModelConfig) -> float:
    e = cfg.cascade.enhance_dim
    enh = 2 * cfg.d_model * e if e else 0
    return float(enh + cfg.d_model * cfg.vocab_size)


def segment_macs_per_token(cfg: ModelConfig, kv_len: int) -> List[float]:
    """Cumulative decode MACs after each cascade component (incl. its head)."""
    kinds = layer_kinds(cfg)
    prefix = []
    total = 0.0
    for start, end in cfg.segments:
        for i in range(start, end):
            total += _layer_macs_per_token(cfg, kinds[i], kv_len)
        prefix.append(total + exit_head_macs(cfg))
    return prefix
