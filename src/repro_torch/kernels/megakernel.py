"""Fused exit-head megakernel and its plain version.

Replaces the TPU kernel ``_megakernel`` / ``exit_head_update`` of the JAX
package's ``kernels/megakernel.py`` (its ``pallas_call`` at line 231): one
component step of the exit-decision scan computed from the segment's
HIDDEN state — the exit head's rmsnorm, the ``(B, d) @ (d, V)`` product
with the (shared) unembedding, the softmax-max confidence and the
exit-update carry merge — without the (B, V) logits ever reaching device
memory.  Dead rows (``live`` False) pass every carry through unchanged.

Route: CUDA C++ (``csrc/megakernel.cu``), ctypes-bound.  The head product
is computed inside the kernel (no cuBLAS, no ``torch.matmul``).  Bound on
the H100: bytes — one read of the (d, V) head (622 MB in bf16 at
qwen2.5-3b); its 2·B·d·V flops are negligible at decode batch sizes.  The
vocab is split across ~600 blocks (256 columns each in bf16), each
recomputing the rows' norm, streaming its head columns with 16-byte loads
and writing a (max, Σexp, first-argmax) partial; a second launch merges
the partials and applies the carry merge shared with ``exit_update``
(``csrc/common.cuh``).  The threshold is a runtime argument.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_exit_head_update

_SIG = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_float] + [ctypes.c_void_p] * 15
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_MAX_SMEM = 227 * 1024      # dynamic shared memory a block may opt into


def _group_rows(B: int, d: int, dcode: int) -> int:
    """Rows per block (1, 2, 4 or 8): the smallest that covers B, capped by
    the block's shared memory (the normalised rows live there)."""
    smem = build.function("megakernel", "megakernel_smem_bytes",
                          [ctypes.c_int, ctypes.c_int, ctypes.c_int])
    smem.restype = ctypes.c_longlong
    nb = next(n for n in (1, 2, 4, 8) if n >= min(B, 8))
    while nb > 1 and smem(d, nb, dcode) > _MAX_SMEM:
        nb //= 2
    if smem(d, nb, dcode) > _MAX_SMEM:
        raise ValueError(f"exit_head_update: d={d} does not fit one block's "
                         "shared memory")
    return nb


def exit_head_update(h, norm_w, head, answered, pred, exit_idx, conf, streak,
                     ema, active, *, threshold: float, m: int,
                     n_components: int, patience_k: int = 0,
                     ema_decay: float = 0.0, tel_bins: int = 0, live=None,
                     eps: float = 1e-5):
    """One fused exit-head component step.

    h (B, d); norm_w (d,); head (d, V) in h's dtype; carries as
    :func:`repro_torch.kernels.exit_update.exit_update`; ``live`` the
    per-slot exit mask ((B,) bool, None = all live).  Live rows return
    exactly what ``exit_update(rmsnorm(h) @ head, ...)`` returns up to the
    product's summation order; dead rows pass every carry through.  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    kw = dict(threshold=float(np.float32(threshold)), m=int(m),
              n_components=int(n_components), patience_k=int(patience_k),
              ema_decay=float(ema_decay), tel_bins=int(tel_bins))
    if h.device.type == "cpu":
        return ref_exit_head_update(h, norm_w, head, answered, pred,
                                    exit_idx, conf, streak, ema, active,
                                    live=live, eps=eps, **kw)
    carries = (answered, pred, exit_idx, conf, streak, ema, active)
    build.require_cuda("exit_head_update", h, norm_w, head, *carries,
                       *(() if live is None else (live,)))
    if h.dim() != 2 or head.dim() != 2 or head.shape[0] != h.shape[1] \
            or norm_w.shape != (h.shape[1],):
        raise ValueError(f"exit_head_update: h (B, d), norm_w (d,), head "
                         f"(d, V); got {tuple(h.shape)}, "
                         f"{tuple(norm_w.shape)}, {tuple(head.shape)}")
    if head.dtype != h.dtype:
        raise TypeError(f"exit_head_update: head {head.dtype} must be in h's "
                        f"dtype {h.dtype}")
    if h.stride(1) != 1 or head.stride(1) != 1:
        raise ValueError("exit_head_update: h and head need a contiguous "
                         "last dim")
    B, d = h.shape
    V = head.shape[1]
    if any(c.shape != (B,) for c in carries) or (
            live is not None and live.shape != (B,)):
        raise ValueError("exit_head_update: every carry must be (B,)")
    i32, f32 = torch.int32, torch.float32
    dev = h.device
    dcode = build.dtype_code(h)
    w32 = norm_w.to(f32).contiguous()
    ans_in = answered.to(torch.bool).contiguous()
    act_in = active.to(torch.bool).contiguous()
    pred_in, exit_in, streak_in = (t.to(i32).contiguous()
                                   for t in (pred, exit_idx, streak))
    conf_in, ema_in = (t.to(f32).contiguous() for t in (conf, ema))
    live_in = None if live is None else live.to(torch.bool).contiguous()
    nb = _group_rows(B, d, dcode)
    tiles = build.function("megakernel", "megakernel_tiles",
                           [ctypes.c_int, ctypes.c_int])(V, dcode)
    workspace = torch.empty((3, B, tiles), dtype=f32, device=dev)
    outs = [torch.empty(B, dtype=torch.bool, device=dev),
            torch.empty(B, dtype=i32, device=dev),
            torch.empty(B, dtype=i32, device=dev),
            torch.empty(B, dtype=f32, device=dev),
            torch.empty(B, dtype=i32, device=dev),
            torch.empty(B, dtype=f32, device=dev)]
    if kw["tel_bins"]:
        outs.append(torch.empty(B, dtype=i32, device=dev))
    tcode = outs[6] if kw["tel_bins"] else None
    p = build.ptr
    fn = build.function("megakernel", "megakernel_launch", _SIG)
    build.check(fn(
        p(h), h.stride(0), p(w32), p(head), head.stride(0), B, d, V, dcode,
        nb, p(live_in), float(eps), p(workspace),
        p(ans_in), p(pred_in), p(exit_in), p(conf_in), p(streak_in),
        p(ema_in), p(act_in), *(p(o) for o in outs[:6]), p(tcode),
        kw["threshold"], kw["m"], kw["n_components"], kw["patience_k"],
        kw["ema_decay"], 1.0 - kw["ema_decay"], kw["tel_bins"],
        build.stream_of(h)), "exit_head_update")
    exit_head_update.launches += 1
    return tuple(outs)


exit_head_update.launches = 0


def reset_launches() -> None:
    exit_head_update.launches = 0
