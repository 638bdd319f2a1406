"""The telemetry rider code the fused exit-update kernel emits.

Copied from the JAX package's ``autotune/telemetry.py`` (``conf_to_bin``
and ``pack_rider``); the telemetry counters, shadow pass and threshold
controller come with the autotune slice of the port.
"""
from __future__ import annotations

import torch


def conf_to_bin(conf: torch.Tensor, bins: int) -> torch.Tensor:
    """Fixed-bin index of a confidence in (0, 1]: ``min(floor(c·bins),
    bins-1)``.  A deployed threshold δ = e/bins then corresponds exactly to
    the bin gate ``bin >= e``.  The fused exit-update kernel computes the
    same formula in-register; keep the two in lockstep."""
    return torch.clamp((conf * bins).to(torch.int32), 0, bins - 1)


def pack_rider(pred: torch.Tensor, conf: torch.Tensor, bins: int
               ) -> torch.Tensor:
    """The decision scan's telemetry rider code: ``pred * bins + bin``
    packed into one int32."""
    return pred.to(torch.int32) * bins + conf_to_bin(conf, bins)
