"""Cross-model escalation: a cascade OF cascades behind one ε-knob.

The counterpart of the JAX package's ``escalate`` package, with the same
names.  The paper's intra-model cascade answers a token at the shallowest
component whose softmax confidence clears its threshold.  This package
adds the next level up (Streeter's model-pool cascades; IDK answer-or-
defer): an ordered pool of serving engines where a stage's FINAL
component may abstain — confidence below the stage's escalation
threshold re-routes the request (committed prefix and all) to a bigger
model.  The same calibration machinery that solves intra-model
thresholds solves the escalation threshold too, over one composed joint
histogram with heterogeneous per-stage MAC costs.
"""
from repro_torch.escalate.replay import (build_replay, prefix_compatible,
                                         resolve_share_prefix)
from repro_torch.escalate.router import EscalationRouter
from repro_torch.escalate.tier import ModelCascadeTier, TierThresholdController

__all__ = [
    "build_replay", "prefix_compatible", "resolve_share_prefix",
    "EscalationRouter", "ModelCascadeTier", "TierThresholdController",
]
