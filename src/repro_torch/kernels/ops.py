"""Public wrappers adapting the model's layouts to the kernels.

The counterparts of the JAX package's ``kernels/ops.py`` adapters
(``softmax_confidence_fused``, ``rmsnorm_fused``, ``flash_attention_bshd``,
``decode_attention_cache``, ``exit_update_fused``, ``exit_head_fused``,
``cohort_scatter_tree``, ``paged_gather``; ``paged_gather_kv`` gathers a
layer's k and v stores in one launch, for paged stores decode attention's
``paged`` route does not take).  Each kernel wrapper reads its launch
parameters from the tile registry (:mod:`repro_torch.kernels.autotune`)
at call time, so ``install_tiles`` / ``ensure_tuned`` move every kernel
onto the tuned parameters with no call-site change.  The kernels read
the model's (B, S, H, hd) and (B, W, KV, hd) layouts through strides, so
these adapters only reshape and take views — no transposed copies.
"""
from __future__ import annotations

from repro_torch.kernels.cohort_cache import (  # noqa: F401 (re-export)
    cohort_scatter, cohort_scatter_tree)
from repro_torch.kernels.confidence import confidence
from repro_torch.kernels.decode_attention import (
    decode_attention, route as decode_attention_route)
from repro_torch.kernels.exit_update import (  # noqa: F401 (re-export)
    exit_combine, exit_partial, exit_update)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.megakernel import (  # noqa: F401 (re-export)
    exit_head_combine, exit_head_partial, exit_head_update)
from repro_torch.kernels.paged_gather import (  # noqa: F401 (re-export)
    paged_gather, paged_gather_kv)
from repro_torch.kernels.rmsnorm import rmsnorm


def softmax_confidence_fused(logits):
    """(..., V) -> (argmax, δ) — Defs 3.2/3.3 via the fused kernel."""
    shape = logits.shape[:-1]
    idx, conf = confidence(logits.reshape(-1, logits.shape[-1]))
    return idx.reshape(shape), conf.reshape(shape)


def rmsnorm_fused(x, w, eps: float = 1e-5):
    shape = x.shape
    return rmsnorm(x.reshape(-1, shape[-1]), w, eps=eps).reshape(shape)


def flash_attention_bshd(q, k, v, *, causal=True, window=0):
    """Model layout (B, S, H, hd) + (B, S, KV, hd) -> (B, S, H, hd)."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, window=window)
    return out.transpose(1, 2)


def decode_attention_cache(q, k_cache, v_cache, t, kpos, *, window=0,
                           live=None, table=None):
    """Model layout: q (B, 1, H, hd); caches (B, W, KV, hd), or a layer's
    paged stores (NB, bs, KV, hd) with their block table ``table`` (B,
    nblk); ``t`` the position as the carried 0-d int32 device tensor,
    handed to the kernel as it is.  ``live`` is the per-slot exit mask ((B,) bool, None = all
    live): dead slots do no work and get zero rows.  Paged stores take
    decode attention's ``paged`` route where :func:`route
    <repro_torch.kernels.decode_attention.route>` allows it, else their
    gathered views take the dense route."""
    B, _, H, hd = q.shape
    if table is not None and \
            decode_attention_route(k_cache, v_cache, table) != "paged":
        k_cache, v_cache = paged_gather_kv(k_cache, v_cache, table)
        table = None
    out = decode_attention(q[:, 0], k_cache, v_cache, t, kpos, live,
                           window=window, table=table)
    return out.reshape(B, 1, H, hd)


def exit_update_fused(logits, answered, pred, exit_idx, conf, streak, ema,
                      active, *, threshold, m, n_components, patience_k=0,
                      ema_decay=0.0, tel_bins=0):
    """One fused component step of the exit-decision scan (see
    :mod:`repro_torch.kernels.exit_update`)."""
    return exit_update(logits, answered, pred, exit_idx, conf, streak, ema,
                       active, threshold=threshold, m=m,
                       n_components=n_components, patience_k=patience_k,
                       ema_decay=ema_decay, tel_bins=tel_bins)


def exit_head_fused(h, norm_w, head, answered, pred, exit_idx, conf, streak,
                    ema, active, *, threshold, m, n_components, patience_k=0,
                    ema_decay=0.0, tel_bins=0, live=None, eps=1e-5):
    """Per-segment exit-head megakernel (see
    :mod:`repro_torch.kernels.megakernel`): rmsnorm + the head product +
    the softmax confidence + the exit-update merge, the (B, V) logits never
    stored.  ``live`` is the per-slot exit mask: dead rows pass every carry
    through unchanged."""
    return exit_head_update(h, norm_w, head, answered, pred, exit_idx, conf,
                            streak, ema, active, threshold=threshold, m=m,
                            n_components=n_components, patience_k=patience_k,
                            ema_decay=ema_decay, tel_bins=tel_bins, live=live,
                            eps=eps)
