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
in ``decode_attention.launches``.  Bound on the H100: bytes (one read of
every live slot's K and V rows); see the source's header for the design.

Two device routes, picked by :func:`route` before the launch from the
block table and the stores' shape and alignment (never on a failure);
``decode_attention.launches_by_route`` counts each:

- ``"dense"`` — caches in the model's (B, W, KV, hd) layout, read through
  their strides (no transposed copy);
- ``"paged"`` — a layer's paged stores (NB, bs, KV, hd) read through a
  (B, nblk) block table, W = nblk * bs, when bs is a power of two dividing
  the 32-key tile and the stores' blocks are 16-byte addressable: the
  same split, tiles and merge as the dense route over the gathered view
  (``paged_gather``), so the same bits, without the gather.  A paged
  caller whose stores the route does not take gathers first
  (``ops.decode_attention_cache``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import autotune, build
from repro_torch.kernels.ref import (ref_decode_attention,
                                    ref_paged_gather)

TILE = 32         # the kernel's key tile
# partials per row at most: the tile registry's one candidate (another
# split would merge in another order, so change the bits)
MAX_SPLITS = autotune.DEFAULT_TILES["decode_attention"]["max_splits"]
ROUTES = ("dense", "paged")

_SIG = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
        + [ctypes.c_longlong] * 14
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p])


def split_plan(W: int):
    """(chunk, n_split) for a cache of W slots: the smallest multiple of
    the 32-key tile that splits W into at most 16 chunks (the tile
    registry's ``decode_attention.max_splits``, read here).  A function of
    W alone, so dense and paged calls (same W) split alike.  W = 512 gives
    16 chunks of 32 keys: 128 blocks at the serving path's B = 4, KV = 2
    on the H100's 132 SMs."""
    max_splits = autotune.tile("decode_attention", "max_splits")
    chunk = TILE * max(1, -(-W // (TILE * max_splits)))
    return chunk, -(-W // chunk)


def _blocks_addressable(store: torch.Tensor) -> bool:
    """Every row of every block starts on 16 bytes and the head dim is
    whole 16-byte chunks (the last dim is contiguous)."""
    esz = store.element_size()
    return (store.data_ptr() % 16 == 0 and store.stride(-1) == 1
            and (store.shape[-1] * esz) % 16 == 0
            and all((st * esz) % 16 == 0 for st in store.stride()[:-1]))


def route(k_cache, v_cache, table=None) -> str:
    """The device route attention over these caches takes: ``"paged"``
    for paged stores (NB, bs, KV, hd) read through ``table`` when bs is a
    power of two dividing the 32-key tile and both stores' blocks are
    16-byte addressable; ``"dense"`` for (B, W, KV, hd) caches, and for
    any other paged stores once their views are gathered."""
    if table is not None and TILE % k_cache.shape[1] == 0 and all(
            _blocks_addressable(x) for x in (k_cache, v_cache)):
        return "paged"
    return "dense"


def decode_attention(q, k_cache, v_cache, t, kpos, live=None, *,
                     window: int = 0, table=None):
    """q: (B, H, hd) (any strides, last dim contiguous); caches (B, W, KV,
    hd), or with ``table`` ((B, nblk) int32) a layer's paged stores (NB,
    bs, KV, hd) and W = nblk * bs; ``t`` the current absolute position: a
    0-d int32 tensor on q's device, which the kernel reads from device
    memory (so a launch captured in a CUDA graph reads each replay's
    position), or an int; kpos (W,) or per-slot (B, W) int32; live (B,)
    bool or None (all live) -> (B, H, hd) in q's dtype, dead slots' rows
    zero.  CPU tensors take the plain version; CUDA tensors launch the
    kernel on :func:`route`'s route (paged stores the paged route does not
    take raise: gather them first)."""
    if q.device.type == "cpu":
        if table is not None:
            k_cache = ref_paged_gather(k_cache, table)
            v_cache = ref_paged_gather(v_cache, table)
        return ref_decode_attention(q, k_cache, v_cache, t, kpos,
                                    window=window, live=live)
    if not isinstance(t, torch.Tensor):
        t = torch.full((), int(t), dtype=torch.int32, device=q.device)
    if t.numel() != 1 or t.dtype != torch.int32:
        raise ValueError(f"decode_attention: t must be one int32, got "
                         f"{tuple(t.shape)} {t.dtype}")
    tensors = [q, k_cache, v_cache, kpos, t] + [
        x for x in (live, table) if x is not None]
    build.require_cuda("decode_attention", *tensors)
    B, H, hd = q.shape
    r = route(k_cache, v_cache, table)
    paged = r == "paged"
    if table is not None:
        if not paged:
            raise ValueError(
                f"decode_attention: the paged route takes blocks of a power "
                f"of two dividing {TILE} rows, 16-byte addressable; got "
                f"stores {tuple(k_cache.shape)} with strides "
                f"{k_cache.stride()} (gather them with paged_gather_kv for "
                f"the dense route)")
        if table.dim() != 2 or table.shape[0] != B:
            raise ValueError(f"decode_attention: table must be (B, nblk), "
                             f"got {tuple(table.shape)}")
        if table.dtype != torch.int32:
            raise TypeError(f"decode_attention: table must be int32, got "
                            f"{table.dtype}")
        table = table.contiguous()
        W, KV = table.shape[1] * k_cache.shape[1], k_cache.shape[2]
    else:
        W, KV = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape != v_cache.shape or k_cache.shape[3] != hd or H % KV
            or (not paged and k_cache.shape[0] != B)):
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
    # dense: (b, w, h) strides; paged: no slot stride, rows (w % bs, h)
    # within a block, the block stride apart
    ks, vs = k_cache.stride(), v_cache.stride()
    fn = build.function("decode_attention", "decode_attention_launch", _SIG)
    p = build.ptr
    build.check(fn(
        p(q), p(k_cache), p(v_cache), p(kpos), p(live), p(table), p(out),
        p(part_ml), p(part_acc), B, W, KV, qpk, hd, chunk,
        k_cache.shape[1] if paged else 0,
        q.stride(0), q.stride(1),
        0 if paged else ks[0], ks[1], ks[2],
        0 if paged else vs[0], vs[1], vs[2],
        out.stride(0), out.stride(1), W if kpos.dim() == 2 else 0,
        table.stride(0) if paged else 0, ks[0] if paged else 0,
        vs[0] if paged else 0,
        p(t), int(window), 1.0 / math.sqrt(hd), build.dtype_code(q),
        build.stream_of(q)), "decode_attention")
    decode_attention.launches += 1
    decode_attention.launches_by_route[r] += 1
    return out


decode_attention.launches = 0
decode_attention.launches_by_route = dict.fromkeys(ROUTES, 0)


def reset_launches() -> None:
    decode_attention.launches = 0
    decode_attention.launches_by_route.update(dict.fromkeys(ROUTES, 0))
