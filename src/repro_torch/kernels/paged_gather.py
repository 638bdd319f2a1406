"""Paged gather kernel and its plain version.

Replaces the TPU kernel ``_gather_kernel`` / ``paged_gather`` of the JAX
package's ``kernels/paged_gather.py`` (its ``pallas_call`` at line 61):
a paged store ``(num_blocks, bs, kv, hd)`` gathered through a block table
``(B, nblk)`` int32 into the slot-logical ring view ``(B, nblk * bs, kv,
hd)``, bit for bit (a copy; block 0, the trash block, is copied like any
other).  The dense decode attention then runs over that view unchanged,
which keeps paged streams identical to dense ones.  Serving stores need
no view: decode attention's ``paged`` route reads them through the table
(``decode_attention.route``); the gather serves the block sizes that
route does not take.

Route: CUDA C++ (``csrc/paged_gather.cu``), ctypes-bound.  A paged decode
gathers a layer's k and v stores in ONE launch (:func:`paged_gather_kv`)
where the TPU code makes two ``pallas_call`` s.  The copy engine moves
the blocks: a persistent grid of at most one CTA (one warp) per SM; the
(store, slot, ring block) units' blocks cut into boxes of at most 16 KB
(:func:`boxes`), each CTA walking the contiguous range of boxes
:func:`plan` gives it, one lane issuing a ``cp.async.bulk`` copy of each
box global → shared through an 8-stage mbarrier ring and shared →
global from the same stage.  The bulk copy moves 16-byte aligned bytes
only: a store whose base, block stride or block size is not a multiple
of 16 bytes is refused before the launch (:func:`aligned`), never copied
another way.
The store's block stride is passed to the kernel, so a layer slice of a
stacked store is read without a copy; the table is read on the device,
so a captured launch reads each replay's table.  Bound on the H100:
bytes (each gathered block read once, written once); at the serving
shape the launch itself dominates.
"""
from __future__ import annotations

import ctypes

import torch

from typing import Dict, List, Tuple

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_paged_gather

BOX = 16384     # bytes a bulk copy moves at most (one ring stage)

_SIG = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_void_p])
_sm_counts: Dict[int, int] = {}


def plan(n_items: int, n_ctas: int) -> List[Tuple[int, int]]:
    """The kernel's split of its items — box x of unit u = (store · B +
    slot) · nblk + ring block is item u · n_boxes + x — over ``n_ctas``
    CTAs: the range [start, stop) of each, in CTA order — contiguous,
    disjoint, covering [0, n_items), the first ``n_items % n_ctas`` CTAs
    one item more.  The kernel computes the same split from its block
    index."""
    per, rem = divmod(n_items, n_ctas)
    out = []
    for c in range(n_ctas):
        u0 = c * per + min(c, rem)
        out.append((u0, u0 + per + (1 if c < rem else 0)))
    return out


def boxes(block_bytes: int) -> List[Tuple[int, int]]:
    """The (offset, size) bulk copies a block of ``block_bytes`` moves in:
    whole boxes of :data:`BOX` bytes, then the rest."""
    return [(o, min(BOX, block_bytes - o))
            for o in range(0, block_bytes, BOX)]


def aligned(store: torch.Tensor) -> bool:
    """Whether the bulk copy can read ``store``'s blocks: a 16-byte
    aligned base, block stride and block size."""
    es = store.element_size()
    block = store[0].numel() * es if store.shape[0] else 0
    return (store.data_ptr() % 16 == 0 and store.stride(0) * es % 16 == 0
            and block % 16 == 0)


def _n_ctas(dev: torch.device) -> int:
    """One persistent CTA per SM (the SM count read once per device)."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def _gather(stores, table):
    """Launch the kernel over 1 or 2 stores of one shape and dtype."""
    build.require_cuda("paged_gather", table, *stores)
    s0 = stores[0]
    if s0.dim() != 4 or table.dim() != 2:
        raise ValueError(f"paged_gather: store (NB, bs, kv, hd) and table "
                         f"(B, nblk), got {tuple(s0.shape)} and "
                         f"{tuple(table.shape)}")
    NB, bs, kv, hd = s0.shape
    for s in stores:
        if s.shape != s0.shape or s.dtype != s0.dtype:
            raise ValueError("paged_gather: the stores must share shape and "
                             "dtype")
        if s.stride()[1:] != (kv * hd, hd, 1):
            raise ValueError("paged_gather: each block of a store must be "
                             "contiguous (dims 1-3)")
    if table.dtype != torch.int32:
        raise TypeError(f"paged_gather: table must be int32, got "
                        f"{table.dtype}")
    if not all(aligned(s) for s in stores):
        raise ValueError("paged_gather: the bulk copy needs 16-byte aligned "
                         "store bases, block strides and block sizes")
    B, nblk = table.shape
    es = s0.element_size()
    outs = [torch.empty((B, nblk * bs, kv, hd), dtype=s0.dtype,
                        device=s0.device) for _ in stores]
    if not outs[0].numel():
        return outs
    two = len(stores) == 2
    fn = build.function("paged_gather", "paged_gather_launch", _SIG)
    p = build.ptr
    build.check(fn(
        len(stores), p(stores[0]), p(stores[1] if two else None),
        stores[0].stride(0) * es, stores[1].stride(0) * es if two else 0,
        p(outs[0]), p(outs[1] if two else None), p(table),
        table.stride(0), table.stride(1), B, nblk, bs * kv * hd * es,
        _n_ctas(s0.device), build.stream_of(s0)), "paged_gather")
    paged_gather.launches += 1
    return outs


def paged_gather(store: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """store (NB, bs, kv, hd) gathered through table (B, nblk) int32 ->
    (B, nblk * bs, kv, hd).  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if store.device.type == "cpu":
        return ref_paged_gather(store, table)
    return _gather([store], table)[0]


def paged_gather_kv(k_store: torch.Tensor, v_store: torch.Tensor,
                    table: torch.Tensor):
    """A layer's k and v stores gathered through one table, in one
    launch: returns (k_view, v_view), each (B, nblk * bs, kv, hd)."""
    if k_store.device.type == "cpu":
        return (ref_paged_gather(k_store, table),
                ref_paged_gather(v_store, table))
    k, v = _gather([k_store, v_store], table)
    return k, v


paged_gather.launches = 0


def reset_launches() -> None:
    paged_gather.launches = 0
