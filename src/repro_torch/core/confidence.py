"""Softmax confidence — Definitions 3.1–3.3 of the paper.

    out_m(x) = argmax_c softmax(z_m)[c]          (Def. 3.2)
    δ_m(x)   = max_c   softmax(z_m)[c]           (Def. 3.3)

Both are computed from logits without materializing the softmax vector:
δ = exp(max z − logsumexp z), as in the JAX package's
``core/confidence.py``.

``entropy_confidence`` is the BranchyNet [TMK16] baseline the paper
compares against (confidence = −entropy, higher = more confident).
"""
from __future__ import annotations

from typing import Tuple

import torch


def softmax_outputs(logits: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, δ) per Defs. 3.2–3.3.  logits: (..., n_classes).  ``out`` is
    int32 (the first index of the maximum), δ float32."""
    x = logits.float()
    out = torch.argmax(x, dim=-1).to(torch.int32)
    m = torch.amax(x, dim=-1)
    lse = m + torch.log(torch.sum(torch.exp(x - m[..., None]), dim=-1))
    return out, torch.exp(m - lse)


def softmax_confidence(logits: torch.Tensor) -> torch.Tensor:
    """δ only (Def. 3.3), float32."""
    return softmax_outputs(logits)[1]


def entropy_confidence(logits: torch.Tensor) -> torch.Tensor:
    """BranchyNet-style confidence: −entropy(softmax(z)), in (−inf, 0].
    Higher is more confident; its thresholds live on another scale than
    δ's, so calibration (§5) is rerun when this measure is selected."""
    p = torch.softmax(logits.float(), dim=-1)
    ent = -torch.sum(p * torch.log(torch.clamp(p, 1e-30, 1.0)), dim=-1)
    return -ent
