"""Fused exit-head megakernel and its plain version.

Replaces the TPU kernel ``_megakernel`` / ``exit_head_update`` of the JAX
package's ``kernels/megakernel.py`` (its ``pallas_call`` at line 231): one
component step of the exit-decision scan computed from the segment's
HIDDEN state — the exit head's rmsnorm, the ``(B, d) @ (d, V)`` product
with the (shared) unembedding, the softmax-max confidence and the
exit-update carry merge — without the (B, V) logits ever reaching device
memory.  Dead rows (``live`` False) pass every carry through unchanged.

Route: CUDA C++ (``csrc/megakernel.cu``), ctypes-bound, with two device
routes that :func:`route` picks before the launch, on the dtype, the
shapes and the alignment alone (never on a failure):

- ``"tc"`` — bf16 / fp16, B ≤ 16, a head with ``V % 8 == 0``, rows TMA
  and 16-byte loads can address, and rows that leave shared memory room
  for a ring of at least 4 stages (:func:`tc_stages`; every exit head of
  the bf16 serving paths, deepseek-coder-33b's d 7168 at B ≤ 8
  included): a persistent grid of one CTA per SM, each owning the
  contiguous range of 64-column vocab tiles :func:`plan` gives it; a
  producer warp streams the head by TMA through an mbarrier ring (8
  stages where they fit beside the rows, 7 at d 7168) and a warpgroup
  computes logitsᵀ = headᵀ·xnᵀ on the tensor cores (wgmma, f32
  accumulation), the rows' norm computed once per CTA while the first
  stages load;
- ``"cuda_core"`` — f32 (the tensor cores would mean TF32, which the port
  keeps off), unaligned or ``V % 8 != 0`` heads, B > 16, and B > 8 at
  widths whose rows crowd the ring out (9–16 rows of d 7168 alone take
  224 KB of the 227): ~600 vocab blocks of f32 products on the CUDA
  cores.

Both write one (max, Σexp, first-argmax) partial per row per CTA / block,
merged in a fixed order by a second launch that applies the carry merge
shared with ``exit_update`` (``csrc/common.cuh``); the threshold is a
runtime argument the combine reads from device memory
(:func:`repro_torch.kernels.exit_update.threshold_operand`).  The norm
uses the arithmetic of the ``rmsnorm`` route the same rows would take, so
fused and unfused exit heads normalise a row bit for bit alike.
``exit_head_update.launches`` counts every call,
``exit_head_update.launches_by_route`` each route's.  Bound on the H100:
bytes — one read of the (d, V) head (622 MB in bf16 at qwen2.5-3b).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import autotune, build
from repro_torch.kernels.exit_update import _tensors, threshold_operand
from repro_torch.kernels.ref import ref_exit_head_update
from repro_torch.kernels.rmsnorm import warp_rows_ok

ROUTES = ("tc", "cuda_core")
TC_COLS = 64           # vocab columns per tile of the tc route
_TC_STAGE = 16384      # bytes of one ring stage
_TC_STAGES, _TC_MIN_STAGES = 8, 4   # the ring's depth where it fits; least
_TC_MAX_B = 16
_MAX_SMEM = 227 * 1024      # dynamic shared memory a block may opt into

_COMMON = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_float])
_TAIL = ([ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
          ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
          ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# + warp_norm, and on tc the checks' xn_out
_SIG = {"cuda_core": _COMMON + [ctypes.c_int] + _TAIL,
        "tc": _COMMON + [ctypes.c_int, ctypes.c_void_p] + _TAIL}
_SYMBOLS = {"tc": "megakernel_tc_launch", "cuda_core": "megakernel_launch"}
_sm_counts: Dict[int, int] = {}


def _tc_smem_bytes(B: int, d: int, stages: int = _TC_STAGES) -> int:
    """The tc kernel's shared memory (csrc/megakernel.cu:tc_smem_bytes):
    the ring of ``stages`` 16 KB stages, the normalised rows padded to
    whole 64-element chunks, the 17 barriers and the warps' triples."""
    n = 8 if B <= 8 else 16
    return (stages * _TC_STAGE + n * -(-d // 64) * 64 * 2 + 17 * 8
            + 4 * n * 3 * 4)


def tc_stages(B: int, d: int) -> int:
    """The tc route's ring depth for B rows of width d
    (csrc/megakernel.cu:megakernel_tc_stages): 8 stages where they fit
    beside the rows in shared memory (every d ≤ 4096 at B ≤ 8), else as
    many as fit, and 0 — the route refused — below 4 (7 at d 7168 and
    B ≤ 8; 0 there at B > 8, whose rows alone take 224 KB)."""
    fit = (_MAX_SMEM - _tc_smem_bytes(B, d, 0)) // _TC_STAGE
    fit = min(fit, _TC_STAGES)
    return fit if fit >= _TC_MIN_STAGES else 0


def _aligned_rows(x: torch.Tensor) -> bool:
    """A 16-byte aligned base and row stride (rows of a 2-D view)."""
    esz = x.element_size()
    return x.data_ptr() % 16 == 0 and (x.shape[0] <= 1
                                       or x.stride(0) * esz % 16 == 0)


def route(h: torch.Tensor, head: torch.Tensor) -> str:
    """The device route a launch on ``h`` (B, d) and ``head`` (d, V) takes:
    ``"tc"`` for bf16 / fp16 with B ≤ 16, d a multiple of 8 whose rows
    leave room for the ring (:func:`tc_stages`), ``V % 8 == 0`` and
    16-byte aligned bases and row strides of h and the head, else
    ``"cuda_core"``.  Both routes normalise with the arithmetic of the
    rmsnorm route the rows and the norm weights take (``warp`` or
    ``block``), so the weights do not pick the route."""
    B, d = h.shape
    if (h.dtype in (torch.bfloat16, torch.float16) and head.dtype == h.dtype
            and 0 < B <= _TC_MAX_B and d % 8 == 0 and tc_stages(B, d)
            and head.shape[1] % 8 == 0 and h.stride(1) == 1
            and head.stride(1) == 1 and _aligned_rows(h)
            and _aligned_rows(head)):
        return "tc"
    return "cuda_core"


def plan(V: int, n_ctas: int) -> List[Tuple[int, int]]:
    """The tc route's vocab split: the column range [start, stop) of each
    of ``n_ctas`` CTAs, in CTA order — contiguous, tile-aligned (64
    columns), disjoint, covering [0, V); the ``n_tiles % n_ctas`` first
    CTAs get one tile more, and a CTA beyond the tile count an empty
    range.  The kernel computes the same split from its block index."""
    n_tiles = -(-V // TC_COLS)
    per, rem = divmod(n_tiles, n_ctas)
    out = []
    for c in range(n_ctas):
        t0 = c * per + min(c, rem)
        t1 = t0 + per + (1 if c < rem else 0)
        out.append((min(t0 * TC_COLS, V), min(t1 * TC_COLS, V)))
    return out


def _tc_ctas(dev: torch.device, V: int) -> int:
    """The tile registry's ``megakernel.tc_ctas`` persistent CTAs (0, the
    default: one per SM, the SM count read once per device), at most one
    per vocab tile and at most one per SM."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    n = int(autotune.tile("megakernel", "tc_ctas")) or _sm_counts[idx]
    return min(n, _sm_counts[idx], -(-V // TC_COLS))


def _group_rows(B: int, d: int, dcode: int) -> int:
    """Rows per block of the cuda_core route (1, 2, 4 or 8): the smallest
    that covers B, at most the tile registry's ``megakernel.rows`` (8 by
    default), capped by the block's shared memory (the normalised rows
    live there)."""
    smem = build.function("megakernel", "megakernel_smem_bytes",
                          [ctypes.c_int, ctypes.c_int, ctypes.c_int])
    smem.restype = ctypes.c_longlong
    cap = int(autotune.tile("megakernel", "rows"))
    nb = min(cap, next(n for n in (1, 2, 4, 8) if n >= min(B, 8)))
    while nb > 1 and smem(d, nb, dcode) > _MAX_SMEM:
        nb //= 2
    if smem(d, nb, dcode) > _MAX_SMEM:
        raise ValueError(f"exit_head_update: d={d} does not fit one block's "
                         "shared memory")
    return nb


def exit_head_update(h, norm_w, head, answered, pred, exit_idx, conf, streak,
                     ema, active, *, threshold, m: int,
                     n_components: int, patience_k: int = 0,
                     ema_decay: float = 0.0, tel_bins: int = 0, live=None,
                     eps: float = 1e-5, xn_out=None):
    """One fused exit-head component step.

    h (B, d); norm_w (d,); head (d, V) in h's dtype; carries as
    :func:`repro_torch.kernels.exit_update.exit_update`; ``live`` the
    per-slot exit mask ((B,) bool, None = all live).  Live rows return
    exactly what ``exit_update(rmsnorm(h) @ head, ...)`` returns up to the
    product's summation order; dead rows pass every carry through.
    ``threshold`` is an f32 tensor on h's device or a float (see
    :func:`~repro_torch.kernels.exit_update.threshold_operand`).  CPU
    tensors take the plain version; CUDA tensors launch the kernel.
    ``xn_out``: None, or a contiguous (B, d) tensor in h's dtype into
    which a ``tc`` launch copies its normalised rows (the checks' view of
    its prologue; refused on the ``cuda_core`` route)."""
    kw = dict(m=int(m), n_components=int(n_components),
              patience_k=int(patience_k), ema_decay=float(ema_decay),
              tel_bins=int(tel_bins))
    if h.device.type == "cpu":
        return ref_exit_head_update(
            h, norm_w, head, answered, pred, exit_idx, conf, streak, ema,
            active, live=live, eps=eps,
            threshold=threshold_operand(threshold, m, "cpu"), **kw)
    carries = (answered, pred, exit_idx, conf, streak, ema, active)
    build.require_cuda("exit_head_update", h, norm_w, head, *carries,
                       *(() if live is None else (live,)),
                       *_tensors(threshold))
    thr = threshold_operand(threshold, m, h.device)
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
    r = route(h, head)
    # the norm takes the rmsnorm route the unfused head would take; its
    # f32 weights are read 16 bytes at a time
    warp_norm = warp_rows_ok(h, norm_w)
    if w32.data_ptr() % 16:
        w32 = w32.clone()
    if xn_out is not None and (r != "tc" or xn_out.shape != (B, d)
                               or xn_out.dtype != h.dtype
                               or not xn_out.is_contiguous()):
        raise ValueError("exit_head_update: xn_out takes the tc route's "
                         "normalised rows, a contiguous (B, d) tensor in "
                         "h's dtype")
    if r == "tc":
        parts = _tc_ctas(dev, V)
        size_arg = parts
    else:
        size_arg = _group_rows(B, d, dcode)
        parts = build.function("megakernel", "megakernel_tiles",
                               [ctypes.c_int, ctypes.c_int])(V, dcode)
    workspace = torch.empty((3, B, parts), dtype=f32, device=dev)
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
    carries = (ctypes.c_void_p * 14)(*(
        p(t) for t in (ans_in, pred_in, exit_in, conf_in, streak_in, ema_in,
                       act_in, *outs[:6], tcode)))
    fn = build.function("megakernel", _SYMBOLS[r], _SIG[r])
    args = [p(h), h.stride(0), p(w32), p(head), head.stride(0), B, d, V,
            dcode, size_arg, p(live_in), float(eps), int(warp_norm)]
    if r == "tc":
        args.append(p(xn_out))
    build.check(fn(
        *args, p(workspace), carries, p(thr), kw["m"],
        kw["n_components"], kw["patience_k"], kw["ema_decay"],
        1.0 - kw["ema_decay"], kw["tel_bins"], build.stream_of(h)),
        "exit_head_update")
    exit_head_update.launches += 1
    exit_head_update.launches_by_route[r] += 1
    return tuple(outs)


exit_head_update.launches = 0
exit_head_update.launches_by_route = dict.fromkeys(ROUTES, 0)


def reset_launches() -> None:
    exit_head_update.launches = 0
    exit_head_update.launches_by_route.update(dict.fromkeys(ROUTES, 0))
