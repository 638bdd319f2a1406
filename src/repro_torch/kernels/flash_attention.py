"""Causal flash-attention kernel (prefill forward) and its plain version.

Replaces the TPU kernel ``_flash_kernel`` / ``flash_attention`` of the JAX
package's ``kernels/flash_attention.py`` (its ``pallas_call`` at line 102):
causal (+ sliding-window) attention with GQA (query head h reads KV head
h // qpk) under an f32 online softmax, skipping key tiles wholly outside
the causal/window band.  hd is not padded.

Route: CUDA C++ (``csrc/flash_attention.cu``), ctypes-bound, with two
device routes that :func:`route` picks before the launch, on the dtype and
the views' alignment alone (never on a failure):

- ``"wgmma"`` — causal attention at hd = 128 (the model's) over bf16 /
  fp16 views that TMA can address (16-byte aligned bases, strides in
  multiples of 16 bytes): TMA loads into a three-stage mbarrier ring,
  both products on the tensor cores (wgmma), P rounded to the input type
  before the second product;
- ``"cuda_core"`` — f32 (which needs IEEE f32, not the tensor cores'
  TF32), 16-bit views TMA cannot address, and hd = 64 or non-causal
  attention in any type: f32 math on the CUDA cores.

q, k and v are read through their strides, so the (B, S, H, hd) model
layout needs no transposed copy.  Both routes are compiled at one tile
(64 query rows x 64 keys): the tile registry's ``flash_attention`` entry
(:mod:`repro_torch.kernels.autotune`) holds it as its one candidate, read
at each call for the sequence check.  ``flash_attention.launches`` counts every
launch, ``flash_attention.launches_by_route`` each route's.  Bound on the
H100: bytes at the serving path's S, operations at long S; see the
source's header for both designs.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import autotune, build
from repro_torch.kernels.ref import ref_flash_attention

ROUTES = ("wgmma", "cuda_core")
_SYMBOLS = {"wgmma": "flash_attention_wgmma_launch",
            "cuda_core": "flash_attention_launch"}

_SIG = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
           ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _tma_addressable(x: torch.Tensor) -> bool:
    """A 16-byte aligned base and strides of 16-byte multiples on every
    dim longer than 1 (the last dim is contiguous)."""
    esz = x.element_size()
    return x.data_ptr() % 16 == 0 and all(
        (st * esz) % 16 == 0 for st, n in zip(x.stride()[:-1], x.shape[:-1])
        if n > 1)


def route(q, k, v, causal: bool = True) -> str:
    """The device route a launch on these views takes: ``"wgmma"`` for
    causal attention at hd = 128 over bf16 / fp16 views TMA can address,
    else ``"cuda_core"``."""
    if (causal and q.shape[-1] == 128
            and q.dtype in (torch.bfloat16, torch.float16)
            and all(_tma_addressable(x) for x in (q, k, v))):
        return "wgmma"
    return "cuda_core"


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
    tq, tk = (autotune.tile("flash_attention", p) for p in ("tq", "tk"))
    if S % tq or S % tk or hd not in (64, 128):
        raise ValueError(f"flash_attention: the kernel takes S % {tq} == 0 "
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
    r = route(q, k, v, causal)
    fn = build.function("flash_attention", _SYMBOLS[r], _SIG)
    p = build.ptr
    build.check(fn(p(q), p(k), p(v), p(out), B, S, H, KV, hd, strides,
                   int(bool(causal)), int(window), 1.0 / math.sqrt(hd),
                   build.dtype_code(q), build.stream_of(q)),
                "flash_attention")
    flash_attention.launches += 1
    flash_attention.launches_by_route[r] += 1
    return out.transpose(1, 2)


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)


def reset_launches() -> None:
    flash_attention.launches = 0
    flash_attention.launches_by_route.update(dict.fromkeys(ROUTES, 0))
