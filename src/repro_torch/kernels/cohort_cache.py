"""Cohort scatter kernel and its plain version.

Replaces the TPU kernel ``_scatter_kernel`` / ``cohort_scatter`` of the JAX
package's ``kernels/cohort_cache.py`` (its ``pallas_call`` at line 53):
write cohort c's rows ``src`` (L, B/C, ...) into ``dst`` (L, B, ...) along
axis 1, the other cohorts' rows untouched — bit-identical to
``dst[:, c*Bc:(c+1)*Bc] = src`` (bool leaves copy as bytes).

Where the port needs it: the port writes caches in place, so a cohort's
segment step over a view of the slab leaves its rows in the slab and needs
no re-join.  Only ``select`` mode computes a cohort's cache rows out of
place (the skip-masked selection), and a decode step writes only ring slot
``t % W``: with ``kernel_tune.cohort_scatter`` the executor lands cohort
c's selected slot rows ``src`` (L, B/C, 1, ...) straight into the dense
slab ``dst`` (L, B, W, ...) through :func:`cohort_scatter_tree`'s slot
route, ``dst[:, c*Bc:(c+1)*Bc, slot] = src[:, :, 0]``, the slot read by
the kernel from device memory (what a captured decode step needs).

Route: CUDA C++ (``csrc/cohort_scatter.cu``), ctypes-bound.  One launch
covers every leaf of a cache tree (up to 16 leaves per launch): the leaves'
pointers, strides and sizes ride in the launch's parameter block, so no
descriptor array is copied to the card first.  Bound on the H100: bytes
(each source byte read once and written once), copied 16 bytes at a time.
``cohort_scatter_tree.launches`` counts every launch,
``cohort_scatter_tree.launches_by_route`` each route's: ``slot`` (ring
slot rows) and ``whole`` (whole-cohort rows: state leaves).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (ref_cohort_scatter,
                                     ref_cohort_scatter_slot)
from repro_torch.models import nn

ROUTES = ("slot", "whole")

_SIG = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]


def _rows_contiguous(t: torch.Tensor, first: int = 1) -> bool:
    """Whether every ``t[i_0, ..., i_{first-1}]`` is laid out contiguously
    (dims >= ``first`` have the strides of a contiguous tensor)."""
    expect = 1
    for size, stride in zip(reversed(t.shape[first:]),
                            reversed(t.stride()[first:])):
        if size != 1 and stride != expect:
            return False
        expect *= size
    return True


def _leaf_job(dst: torch.Tensor, src: torch.Tensor, c: int, C: int,
              slot: bool):
    """One leaf's run descriptor: (dst, src, (layer, layer, row, row, ring
    position) byte strides, run bytes, L, runs a layer)."""
    if dst.dim() < (3 if slot else 2) or dst.shape[1] % C:
        raise ValueError(f"cohort_scatter: dst {tuple(dst.shape)} has no "
                         f"batch axis 1 divisible by C={C}")
    Bc = dst.shape[1] // C
    want = ((dst.shape[0], Bc, 1) + dst.shape[3:] if slot
            else (dst.shape[0], Bc) + dst.shape[2:])
    if src.shape != want:
        raise ValueError(f"cohort_scatter: src {tuple(src.shape)} is not "
                         f"cohort {c} of dst {tuple(dst.shape)}"
                         + (" at one ring slot" if slot else ""))
    if src.dtype != dst.dtype:
        raise TypeError(f"cohort_scatter: src {src.dtype} vs dst {dst.dtype}")
    es = dst.element_size()
    base = dst.data_ptr() + c * Bc * dst.stride(1) * es
    if not slot:
        if not (_rows_contiguous(dst) and _rows_contiguous(src)):
            raise ValueError("cohort_scatter: each layer of dst and src "
                             "must be contiguous")
        return (base, src.data_ptr(),
                (dst.stride(0) * es, src.stride(0) * es, 0, 0, 0),
                src[0].numel() * es, dst.shape[0], 1)
    if not (_rows_contiguous(dst, 3) and _rows_contiguous(src, 2)):
        raise ValueError("cohort_scatter: each slot row of dst and src must "
                         "be contiguous")
    return (base, src.data_ptr(),
            (dst.stride(0) * es, src.stride(0) * es, dst.stride(1) * es,
             src.stride(1) * es, dst.stride(2) * es),
            src[0, 0].numel() * es, dst.shape[0], Bc)


def cohort_scatter_tree(dst_tree, src_tree, c: int, C: int, slot=None):
    """Write cohort ``c`` of ``C`` of every leaf in place: for each matching
    leaf pair ``dst[:, c*Bc:(c+1)*Bc] = src``, or with ``slot`` (a 0-d
    int64 tensor on the leaves' device, the ring slot) ``dst[:,
    c*Bc:(c+1)*Bc, slot] = src[:, :, 0]``.  Returns ``dst_tree``.  CPU
    tensors take the plain version; CUDA tensors launch the kernel (one
    launch per 16 leaves, the slot read on the device)."""
    dsts, srcs = list(nn.tree_leaves(dst_tree)), list(nn.tree_leaves(src_tree))
    if len(dsts) != len(srcs):
        raise ValueError(f"cohort_scatter: {len(dsts)} dst leaves, "
                         f"{len(srcs)} src leaves")
    if not dsts:
        return dst_tree
    if dsts[0].device.type == "cpu":
        for d, s in zip(dsts, srcs):
            if slot is None:
                ref_cohort_scatter(d, s, c, C)
            else:
                ref_cohort_scatter_slot(d, s, c, C, slot)
        return dst_tree
    extra = []
    if slot is not None:
        if slot.dtype != torch.int64 or slot.numel() != 1:
            raise TypeError("cohort_scatter: slot must be one int64 element, "
                            f"got {slot.dtype} {tuple(slot.shape)}")
        extra = [slot]
    build.require_cuda("cohort_scatter", *dsts, *srcs, *extra)
    jobs = [_leaf_job(d, s, int(c), int(C), slot is not None)
            for d, s in zip(dsts, srcs)]
    fn = build.function("cohort_scatter", "cohort_scatter_launch", _SIG)
    per = build.function("cohort_scatter", "cohort_scatter_max_leaves", [])()
    stream = build.stream_of(dsts[0])
    for i in range(0, len(jobs), per):
        part = jobs[i:i + per]
        n = len(part)
        cols = list(zip(*part))
        ptrs = (ctypes.c_void_p * n)(*cols[0])
        srcp = (ctypes.c_void_p * n)(*cols[1])
        strides = (ctypes.c_longlong * (5 * n))(
            *[x for st in cols[2] for x in st])
        chunk = (ctypes.c_longlong * n)(*cols[3])
        lays = (ctypes.c_int * n)(*cols[4])
        rows = (ctypes.c_int * n)(*cols[5])
        build.check(fn(n, ptrs, srcp, strides, chunk, lays, rows,
                       build.ptr(slot), stream), "cohort_scatter")
        cohort_scatter_tree.launches += 1
        cohort_scatter_tree.launches_by_route[
            "whole" if slot is None else "slot"] += 1
    return dst_tree


cohort_scatter_tree.launches = 0
cohort_scatter_tree.launches_by_route = dict.fromkeys(ROUTES, 0)


def cohort_scatter(dst, src, c: int, C: int):
    """One leaf: ``dst[:, c*Bc:(c+1)*Bc] = src`` in place; returns dst."""
    cohort_scatter_tree([dst], [src], c, C)
    return dst


def reset_launches() -> None:
    cohort_scatter_tree.launches = 0
    cohort_scatter_tree.launches_by_route.update(dict.fromkeys(ROUTES, 0))
