"""Cohort scatter kernel and its plain version.

Replaces the TPU kernel ``_scatter_kernel`` / ``cohort_scatter`` of the JAX
package's ``kernels/cohort_cache.py`` (its ``pallas_call`` at line 53):
write cohort c's rows ``src`` (L, B/C, ...) into ``dst`` (L, B, ...) along
axis 1, the other cohorts' rows untouched — bit-identical to
``dst[:, c*Bc:(c+1)*Bc] = src`` (bool leaves copy as bytes).

Where the port needs it: the port writes caches in place, so a cohort's
segment step over a view of the slab leaves its rows in the slab and needs
no re-join.  Only ``select`` mode computes a cohort's cache rows out of
place (the skip-masked selection); with ``kernel_tune.cohort_scatter`` the
executor lands them through :func:`cohort_scatter_tree`.

Route: CUDA C++ (``csrc/cohort_scatter.cu``), ctypes-bound.  One launch
covers every leaf of a cache tree (up to 16 leaves per launch): the leaves'
pointers, strides and sizes ride in the launch's parameter block, so no
descriptor array is copied to the card first.  Bound on the H100: bytes
(each source byte read once and written once), copied 16 bytes at a time.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_cohort_scatter
from repro_torch.models import nn

_SIG = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _rows_contiguous(t: torch.Tensor) -> bool:
    """Whether every layer ``t[l]`` is laid out contiguously (dims >= 1
    have the strides of a contiguous tensor)."""
    expect = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and stride != expect:
            return False
        expect *= size
    return True


def _leaf_job(dst: torch.Tensor, src: torch.Tensor, c: int, C: int):
    if dst.dim() < 2 or dst.shape[1] % C:
        raise ValueError(f"cohort_scatter: dst {tuple(dst.shape)} has no "
                         f"batch axis 1 divisible by C={C}")
    Bc = dst.shape[1] // C
    if src.shape != (dst.shape[0], Bc) + dst.shape[2:]:
        raise ValueError(f"cohort_scatter: src {tuple(src.shape)} is not "
                         f"cohort {c} of dst {tuple(dst.shape)}")
    if src.dtype != dst.dtype:
        raise TypeError(f"cohort_scatter: src {src.dtype} vs dst {dst.dtype}")
    if not (_rows_contiguous(dst) and _rows_contiguous(src)):
        raise ValueError("cohort_scatter: each layer of dst and src must be "
                         "contiguous")
    es = dst.element_size()
    return (dst.data_ptr() + c * Bc * dst.stride(1) * es, src.data_ptr(),
            dst.stride(0) * es, src.stride(0) * es,
            src[0].numel() * es, dst.shape[0])


def cohort_scatter_tree(dst_tree, src_tree, c: int, C: int):
    """Write cohort ``c`` of ``C`` of every leaf: for each matching leaf
    pair, ``dst[:, c*Bc:(c+1)*Bc] = src`` in place.  Returns ``dst_tree``.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (one launch per 16 leaves)."""
    dsts, srcs = list(nn.tree_leaves(dst_tree)), list(nn.tree_leaves(src_tree))
    if len(dsts) != len(srcs):
        raise ValueError(f"cohort_scatter: {len(dsts)} dst leaves, "
                         f"{len(srcs)} src leaves")
    if not dsts:
        return dst_tree
    if dsts[0].device.type == "cpu":
        for d, s in zip(dsts, srcs):
            ref_cohort_scatter(d, s, c, C)
        return dst_tree
    build.require_cuda("cohort_scatter", *dsts, *srcs)
    jobs = [_leaf_job(d, s, int(c), int(C)) for d, s in zip(dsts, srcs)]
    fn = build.function("cohort_scatter", "cohort_scatter_launch", _SIG)
    per = build.function("cohort_scatter", "cohort_scatter_max_leaves", [])()
    stream = build.stream_of(dsts[0])
    for i in range(0, len(jobs), per):
        part = jobs[i:i + per]
        n = len(part)
        cols = list(zip(*part))
        ptrs = (ctypes.c_void_p * n)(*cols[0])
        srcp = (ctypes.c_void_p * n)(*cols[1])
        i64 = [(ctypes.c_longlong * n)(*col) for col in cols[2:5]]
        lays = (ctypes.c_int * n)(*cols[5])
        build.check(fn(n, ptrs, srcp, *i64, lays, stream), "cohort_scatter")
        cohort_scatter_tree.launches += 1
    return dst_tree


cohort_scatter_tree.launches = 0


def cohort_scatter(dst, src, c: int, C: int):
    """One leaf: ``dst[:, c*Bc:(c+1)*Bc] = src`` in place; returns dst."""
    cohort_scatter_tree([dst], [src], c, C)
    return dst


def reset_launches() -> None:
    cohort_scatter_tree.launches = 0
