"""Causal flash-attention kernel (prefill forward) and its plain version.

Replaces the TPU kernel ``_flash_kernel`` / ``flash_attention`` of the JAX
package's ``kernels/flash_attention.py`` (its ``pallas_call`` at line 102):
causal (+ sliding-window) attention with GQA (query head h reads KV head
h // qpk) under an f32 online softmax, skipping key tiles wholly outside
the causal/window band.  hd is not padded.

Route: CUDA C++ (``csrc/flash_attention.cu``), ctypes-bound.  q, k and v
are read through their strides, so the (B, S, H, hd) model layout needs no
transposed copy.  Bound on the H100: operations (the visible query-key
pairs' dot products); the first kernel does its math in f32 on the CUDA
cores — see the source's header for what it leaves for later.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_flash_attention

TILE = 64  # the kernel's query and key tile: S must be a multiple

_SIG = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
           ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, H, S, hd); k, v: (B, KV, S, hd) (any strides, last dim
    contiguous) -> (B, H, S, hd) in q's dtype.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return ref_flash_attention(q, k, v, causal=causal, window=window)
    build.require_cuda("flash_attention", q, k, v)
    B, H, S, hd = q.shape
    KV = k.shape[1]
    if k.shape != (B, KV, S, hd) or v.shape != k.shape or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)}")
    if S % TILE or hd not in (64, 128):
        raise ValueError(f"flash_attention: the kernel takes S % {TILE} == 0 "
                         f"and hd in (64, 128); got S={S}, hd={hd}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention: q, k, v must share a dtype")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("flash_attention: last dims must be contiguous")
    # the output is laid out (B, S, H, hd) — the model's layout — and
    # returned as a (B, H, S, hd) view
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        q.stride(0), q.stride(2), q.stride(1),
        k.stride(0), k.stride(2), k.stride(1),
        v.stride(0), v.stride(2), v.stride(1),
        out.stride(0), out.stride(1), out.stride(2))
    fn = build.function("flash_attention", "flash_attention_launch", _SIG)
    p = build.ptr
    build.check(fn(p(q), p(k), p(v), p(out), B, S, H, KV, hd, strides,
                   int(bool(causal)), int(window), 1.0 / math.sqrt(hd),
                   build.dtype_code(q), build.stream_of(q)),
                "flash_attention")
    flash_attention.launches += 1
    return out.transpose(1, 2)


flash_attention.launches = 0


def reset_launches() -> None:
    flash_attention.launches = 0
