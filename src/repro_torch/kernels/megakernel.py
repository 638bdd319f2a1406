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

The partial contract, for a head sharded by vocab over the mesh's
``model`` ranks: :func:`exit_head_partial` runs the same routes over the
rank's columns and ends in one (max, Σexp, global first-argmax) triple a
row instead of the carry merge; the ranks' triples, gathered in rank
order, go to :func:`exit_head_combine`, one launch that merges them rank
after rank and applies the carry merge (counted under the ``combine``
route).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import autotune, build
from repro_torch.kernels.exit_update import (_tensors, carry_buffers,
                                             threshold_operand)
from repro_torch.kernels.ref import (ref_exit_combine, ref_exit_head_partial,
                                     ref_exit_head_update)
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
          ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
          ctypes.c_void_p])
_COMBINE_SIG = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
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
    B = h.shape[0]
    if any(c.shape != (B,) for c in carries):
        raise ValueError("exit_head_update: every carry must be (B,)")
    ins, outs = carry_buffers(carries, kw["tel_bins"])
    _launch(h, norm_w, head, ins + outs, thr, kw, live, eps, xn_out, 0, None,
            "exit_head_update")
    return tuple(outs if kw["tel_bins"] else outs[:6])


def exit_head_partial(h, norm_w, head, *, vocab_offset: int = 0, live=None,
                      eps: float = 1e-5):
    """The partial contract's first half: ``head`` (d, V_r) holds columns
    [vocab_offset, vocab_offset + V_r) of the exit head; returns each
    row's (max, Σexp, first argmax + vocab_offset) triple over them as a
    (3, B) f32 tensor, the argmax row holding int32 bits.  The same
    routes (``tc`` / ``cuda_core``) and prologue as
    :func:`exit_head_update`; a dead row (``live`` False) gets the empty
    triple.  CPU tensors take the plain version."""
    if h.device.type == "cpu":
        return ref_exit_head_partial(h, norm_w, head, vocab_offset, eps=eps,
                                     live=live)
    build.require_cuda("exit_head_partial", h, norm_w, head,
                       *(() if live is None else (live,)))
    part = torch.empty((3, h.shape[0]), dtype=torch.float32, device=h.device)
    _launch(h, norm_w, head, [None] * 14, None, {}, live, eps, None,
            vocab_offset, part, "exit_head_partial")
    return part


def exit_head_combine(parts, answered, pred, exit_idx, conf, streak, ema,
                      active, *, threshold, m: int, n_components: int,
                      patience_k: int = 0, ema_decay: float = 0.0,
                      tel_bins: int = 0, live=None):
    """The partial contract's second half: the R ranks' triples ``parts``
    (R, 3, B) merged in rank order, then the carry merge, dead rows
    passing their carries through — what :func:`exit_head_update` returns
    for the unsharded head, up to the Σexp's summation order."""
    kw = dict(m=int(m), n_components=int(n_components),
              patience_k=int(patience_k), ema_decay=float(ema_decay),
              tel_bins=int(tel_bins))
    carries = (answered, pred, exit_idx, conf, streak, ema, active)
    if parts.device.type == "cpu":
        return ref_exit_combine(parts, *carries, live=live,
                                threshold=threshold_operand(threshold, m,
                                                            "cpu"), **kw)
    build.require_cuda("exit_head_combine", parts, *carries,
                       *(() if live is None else (live,)),
                       *_tensors(threshold))
    R, three, B = parts.shape
    if three != 3 or parts.dtype != torch.float32 or any(
            c.shape != (B,) for c in carries):
        raise ValueError(f"exit_head_combine: parts (R, 3, B) f32 and (B,) "
                         f"carries, got {tuple(parts.shape)} {parts.dtype}")
    thr = threshold_operand(threshold, m, parts.device)
    ins, outs = carry_buffers(carries, kw["tel_bins"])
    live_in = None if live is None else live.to(torch.bool).contiguous()
    p = build.ptr
    ptrs = (ctypes.c_void_p * 14)(*(p(t) for t in ins + outs))
    fn = build.function("megakernel", "megakernel_combine_launch",
                        _COMBINE_SIG)
    build.check(fn(p(parts.contiguous()), B, R, p(live_in), ptrs, p(thr),
                   kw["m"], kw["n_components"], kw["patience_k"],
                   kw["ema_decay"], 1.0 - kw["ema_decay"], kw["tel_bins"],
                   build.stream_of(parts)), "exit_head_combine")
    exit_head_update.launches += 1
    exit_head_update.launches_by_route["combine"] += 1
    return tuple(outs if kw["tel_bins"] else outs[:6])


def _launch(h, norm_w, head, carry_tensors, thr, kw, live, eps, xn_out,
            vocab_offset, part, what):
    """The head product's launch on the route :func:`route` picks, ending
    in the carry merge — or, with ``part``, in the rows' triples."""
    if h.dim() != 2 or head.dim() != 2 or head.shape[0] != h.shape[1] \
            or norm_w.shape != (h.shape[1],):
        raise ValueError(f"{what}: h (B, d), norm_w (d,), head "
                         f"(d, V); got {tuple(h.shape)}, "
                         f"{tuple(norm_w.shape)}, {tuple(head.shape)}")
    if head.dtype != h.dtype:
        raise TypeError(f"{what}: head {head.dtype} must be in h's "
                        f"dtype {h.dtype}")
    if h.stride(1) != 1 or head.stride(1) != 1:
        raise ValueError(f"{what}: h and head need a contiguous last dim")
    B, d = h.shape
    V = head.shape[1]
    if live is not None and live.shape != (B,):
        raise ValueError(f"{what}: live must be (B,)")
    dev = h.device
    dcode = build.dtype_code(h)
    w32 = norm_w.to(torch.float32).contiguous()
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
        raise ValueError(f"{what}: xn_out takes the tc route's "
                         "normalised rows, a contiguous (B, d) tensor in "
                         "h's dtype")
    if r == "tc":
        parts = _tc_ctas(dev, V)
        size_arg = parts
    else:
        size_arg = _group_rows(B, d, dcode)
        parts = build.function("megakernel", "megakernel_tiles",
                               [ctypes.c_int, ctypes.c_int])(V, dcode)
    workspace = torch.empty((3, B, parts), dtype=torch.float32, device=dev)
    p = build.ptr
    carries = (ctypes.c_void_p * 14)(*(p(t) for t in carry_tensors))
    fn = build.function("megakernel", _SYMBOLS[r], _SIG[r])
    args = [p(h), h.stride(0), p(w32), p(head), head.stride(0), B, d, V,
            dcode, size_arg, p(live_in), float(eps), int(warp_norm)]
    if r == "tc":
        args.append(p(xn_out))
    build.check(fn(
        *args, p(workspace), carries, p(thr), kw.get("m", 0),
        kw.get("n_components", 1), kw.get("patience_k", 0),
        kw.get("ema_decay", 0.0), 1.0 - kw.get("ema_decay", 0.0),
        kw.get("tel_bins", 0), int(vocab_offset), p(part),
        build.stream_of(h)), what)
    exit_head_update.launches += 1
    exit_head_update.launches_by_route[r] += 1


exit_head_update.launches = 0
# the head product's two routes, and the partial contract's combine launch
exit_head_update.launches_by_route = dict.fromkeys(ROUTES + ("combine",), 0)


def reset_launches() -> None:
    exit_head_update.launches = 0
    exit_head_update.launches_by_route.update(
        dict.fromkeys(ROUTES + ("combine",), 0))
