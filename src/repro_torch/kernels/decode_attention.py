"""Single-query (decode) attention kernel and its plain version.

Replaces the TPU kernel ``_decode_kernel`` / ``decode_attention`` of the
JAX package's ``kernels/decode_attention.py`` (its ``pallas_call`` at line
120): one new token per slot attends over a ring KV cache with GQA, masked
by each cache slot's absolute position (``kpos``, -1 = empty) against the
current position ``t`` and the sliding window; slots whose ``live`` flag
is off do no work and get zero rows.

Route: CUDA C++ (``csrc/decode_attention.cu``), ctypes-bound: split-KV
(flash-decoding).  Each chunk of :func:`split_plan`'s keys of one (slot,
KV head) is scored in its own block, which writes an f32 partial (m, l,
acc) to a scratch allocated here; a second launch merges a row's partials
in a fixed split order, so a run repeats its bits.  One call counts one
in ``decode_attention.launches``.  The cache is read in the model's (B, W,
KV, hd) layout through strides, so no transposed copy is made.  Bound on
the H100: bytes (one read of every live slot's K and V rows); see the
source's header for the design.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_decode_attention

TILE = 32         # the kernel's key tile
MAX_SPLITS = 16  # partials per row at most

_SIG = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
        + [ctypes.c_longlong] * 11
        + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p])


def split_plan(W: int):
    """(chunk, n_split) for a cache of W slots: the smallest multiple of
    the 32-key tile that splits W into at most 16 chunks.  A function of W
    alone, so dense and paged calls (same W) split alike.  W = 512 gives
    16 chunks of 32 keys: 128 blocks at the serving path's B = 4, KV = 2
    on the H100's 132 SMs."""
    chunk = TILE * max(1, -(-W // (TILE * MAX_SPLITS)))
    return chunk, -(-W // chunk)


def decode_attention(q, k_cache, v_cache, t: int, kpos, live=None, *,
                     window: int = 0):
    """q: (B, H, hd) (any strides, last dim contiguous); caches (B, W, KV,
    hd); ``t`` the current absolute position (int); kpos (W,) or per-slot
    (B, W) int32; live (B,) bool or None (all live) -> (B, H, hd) in q's
    dtype, dead slots' rows zero.  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    t = int(t)
    if q.device.type == "cpu":
        return ref_decode_attention(q, k_cache, v_cache, t, kpos,
                                    window=window, live=live)
    tensors = [q, k_cache, v_cache, kpos] + ([live] if live is not None
                                             else [])
    build.require_cuda("decode_attention", *tensors)
    B, H, hd = q.shape
    _, W, KV, _ = k_cache.shape
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != B
            or k_cache.shape[3] != hd or H % KV):
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not "
                         f"fit caches {tuple(k_cache.shape)}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError("decode_attention: q and the caches must share a "
                        f"dtype, got {q.dtype}, {k_cache.dtype}")
    qpk = H // KV
    if hd % 32 or hd > 256 or qpk > 32:
        raise ValueError(f"decode_attention: the kernel takes hd % 32 == 0, "
                         f"hd <= 256 and <= 32 query heads per KV head; got "
                         f"hd={hd}, qpk={qpk}")
    if any(x.stride(-1) != 1 for x in (q, k_cache, v_cache)):
        raise ValueError("decode_attention: last dims must be contiguous")
    kpos = kpos.to(torch.int32).contiguous()
    if kpos.shape not in ((W,), (B, W)):
        raise ValueError(f"decode_attention: kpos must be (W,) or (B, W), "
                         f"got {tuple(kpos.shape)}")
    live = None if live is None else live.to(torch.bool).contiguous()
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    chunk, n_split = split_plan(W)
    # one f32 scratch: acc (B, H, n_split, hd), then (m, l) (B, H,
    # n_split, 2); acc first keeps both 16-byte aligned
    rows = B * H * n_split
    scratch = torch.empty(rows * (hd + 2), dtype=torch.float32,
                          device=q.device)
    part_acc, part_ml = scratch[:rows * hd], scratch[rows * hd:]
    fn = build.function("decode_attention", "decode_attention_launch", _SIG)
    p = build.ptr
    build.check(fn(
        p(q), p(k_cache), p(v_cache), p(kpos), p(live), p(out), p(part_ml),
        p(part_acc), B, W, KV, qpk, hd, chunk,
        q.stride(0), q.stride(1),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        out.stride(0), out.stride(1), W if kpos.dim() == 2 else 0,
        t, int(window), 1.0 / math.sqrt(hd), build.dtype_code(q),
        build.stream_of(q)), "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def reset_launches() -> None:
    decode_attention.launches = 0
