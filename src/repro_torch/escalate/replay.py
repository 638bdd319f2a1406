"""Prefix replay for cross-model escalation (a numpy copy of the JAX
package's ``escalate/replay.py``).

When a stage defers a request, everything it already committed is real
output the tier keeps — the next stage must decode *from that context*,
not re-answer it.  Two stages can share the context only when the
committed token IDs are valid input to both: we auto-detect that as
equal ``vocab_size`` AND equal ``family`` (same tokenizer id space, same
architectural family — a draft and verifier trained as a pair).  When
they are compatible, the committed prefix rides into the next stage as
extra PROMPT positions (prefilled in one dispatch — the paged runtime's
``prefill_into`` path — instead of decoded one-by-one) and the request's
remaining budget shrinks by what already stands.  When they are not, the
committed tokens are meaningless to the next stage: it restarts from the
original prompt with the original budget, and the tier discards the
draft's output from the final record (Streeter-style model-pool
fallback: the escalated model re-answers from scratch).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig


def prefix_compatible(cfg_a: ModelConfig, cfg_b: ModelConfig) -> bool:
    """Can stage ``b`` consume tokens stage ``a`` committed?"""
    return (cfg_a.vocab_size == cfg_b.vocab_size
            and cfg_a.family == cfg_b.family)


def resolve_share_prefix(cfg_from: ModelConfig,
                         cfg_to: ModelConfig) -> bool:
    """Apply ``cfg_from.escalation.share_prefix``: explicit wins, ``None``
    auto-detects via :func:`prefix_compatible`.  Forcing ``True`` across
    incompatible configs is an error — the next stage would prefill token
    IDs from a different vocabulary."""
    share = cfg_from.escalation.share_prefix
    if share is None:
        return prefix_compatible(cfg_from, cfg_to)
    if share and not prefix_compatible(cfg_from, cfg_to):
        raise ValueError(
            "escalation.share_prefix=True across incompatible stages "
            f"(vocab {cfg_from.vocab_size} vs {cfg_to.vocab_size}, family "
            f"{cfg_from.family!r} vs {cfg_to.family!r}) — the committed "
            "tokens are not valid next-stage input")
    return bool(share)


def build_replay(prompt: np.ndarray, committed: List[int],
                 max_new_tokens: int, share_prefix: bool
                 ) -> Tuple[np.ndarray, int, int]:
    """The next stage's (prompt, max_new_tokens, replayed_len).

    ``committed`` is every token the tier has kept so far (all earlier
    stages' prefixes concatenated).  Shared prefix: the committed tokens
    append to the prompt, the budget shrinks by their count, and
    ``replayed_len`` tells the receiving engine how many trailing prompt
    positions are replay (for the escalation-accounting split in
    ``stats()``).  Unshared: the original prompt and full budget come
    back and the caller must discard ``committed``."""
    prompt = np.asarray(prompt, np.int32)
    if not share_prefix or not committed:
        return prompt, int(max_new_tokens), 0
    new_prompt = np.concatenate(
        [prompt, np.asarray(committed, np.int32)])
    remaining = int(max_new_tokens) - len(committed)
    if remaining <= 0:
        raise ValueError(
            f"nothing left to decode: {len(committed)} committed tokens "
            f">= budget {max_new_tokens} (a fully-committed request "
            "finishes, it does not escalate)")
    return new_prompt, remaining, len(committed)
