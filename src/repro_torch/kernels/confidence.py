"""Fused softmax-confidence kernel and its plain version.

Replaces the TPU kernel ``_conf_kernel`` / ``confidence`` of the JAX
package's ``kernels/confidence.py`` (its ``pallas_call`` at line 72): per
row of (B, V) logits, the argmax (first index of the maximum) and
δ = max softmax = 1/Σexp(x − max) (Defs. 3.2–3.3), the softmax never
materialised.  It is the measure Algorithm 1 (``cascade_infer_sequential``,
the batch-uniform decision) takes when ``use_kernels`` is set.

Route: CUDA C++ (``csrc/confidence.cu``), ctypes-bound, one build route
with the other kernels.  Bound on the H100: bytes (one read of the
logits).  One launch: each row is a thread-block cluster of ``plan(V)``
CTAs, CTA r reducing column range ``ranges(V, C)[r]`` to a (max, Σexp,
first-argmax) partial and storing it into rank 0's shared memory
(distributed shared memory); after one cluster barrier rank 0 merges the C
partials in a fixed order — no scratch, no state kept between calls (a
captured CUDA graph replays it), any B.  Rows of at most ``GROUP_COLS``
columns take a group of lanes each.  :func:`plan` alone picks C and
passes it to the kernel; :func:`ranges` mirrors the kernel's own cut
(C++ ``confidence_range``, read back by :func:`device_ranges`), for the
CPU emulator ``ref.ref_confidence_cluster``.
"""
from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from repro_torch.kernels import autotune, build
from repro_torch.kernels.ref import ref_confidence

UNIT = 8            # columns: the split's unit (16 bytes of bf16)
CTA_COLS = 8192     # C doubles while a CTA would hold more columns
# the cap on C by default (the tile registry's ``confidence.max_cluster``)
MAX_CLUSTER = autotune.DEFAULT_TILES["confidence"]["max_cluster"]
GROUP_COLS = 1024   # rows this short take a group of lanes each (C = 1)

_SIG = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]


def plan(V: int, max_cluster: int | None = None) -> int:
    """The cluster size C (CTAs per row) the kernel is launched with for
    rows of V columns: doubled from 1 while a CTA would hold more than
    ``CTA_COLS`` columns, at most ``max_cluster`` (the tile registry's,
    :data:`MAX_CLUSTER` = 16 by default).  (C = 1 at V at most
    ``GROUP_COLS`` is the kernel's lane-group route.)"""
    if max_cluster is None:
        max_cluster = autotune.tile("confidence", "max_cluster")
    C = 1
    while C < max_cluster and V > C * CTA_COLS:
        C *= 2
    return C


def ranges(V: int, C: int) -> List[Tuple[int, int]]:
    """CTA r's column range [start, stop) of a row of V columns cut over C
    CTAs, in rank order: contiguous, in ``UNIT``-column units (16-byte
    aligned), the first ``units % C`` ranges one unit longer, ranges past
    the last unit empty."""
    units = -(-V // UNIT)
    per, rem = divmod(units, C)
    out = []
    for r in range(C):
        u0 = r * per + min(r, rem)
        u1 = u0 + per + (1 if r < rem else 0)
        out.append((min(u0 * UNIT, V), min(u1 * UNIT, V)))
    return out


def confidence(logits: torch.Tensor):
    """logits (B, V) -> (argmax (B,) int32, δ (B,) f32).  CPU tensors take
    the plain version; CUDA tensors launch the kernel, one launch of
    :func:`plan`'s cluster size."""
    if logits.device.type == "cpu":
        return ref_confidence(logits)
    build.require_cuda("confidence", logits)
    if logits.dim() != 2 or logits.stride(1) != 1:
        raise ValueError("confidence: logits must be (B, V) with a "
                         f"contiguous last dim, got {tuple(logits.shape)}")
    B, V = logits.shape
    if V == 0:
        raise ValueError("confidence: rows of 0 columns have no maximum")
    dev = logits.device
    idx = torch.empty(B, dtype=torch.int32, device=dev)
    conf = torch.empty(B, dtype=torch.float32, device=dev)
    fn = build.function("confidence", "confidence_launch", _SIG)
    p = build.ptr
    build.check(fn(p(logits), logits.stride(0), B, V,
                   build.dtype_code(logits), plan(V), p(idx), p(conf),
                   build.stream_of(logits)), "confidence")
    confidence.launches += 1
    return idx, conf


def device_ranges(V: int, C: int) -> List[Tuple[int, int]]:
    """Every CTA's column range as the built kernel cuts a row of V columns
    over C CTAs (C++ ``confidence_range``) — to pin :func:`ranges` on the
    card."""
    ip = ctypes.POINTER(ctypes.c_int)
    cut = build.function("confidence", "confidence_range",
                         [ctypes.c_int] * 3 + [ip, ip])
    out = []
    for r in range(C):
        c0, c1 = ctypes.c_int(), ctypes.c_int()
        build.check(cut(V, C, r, ctypes.byref(c0), ctypes.byref(c1)),
                    "confidence_range")
        out.append((c0.value, c1.value))
    return out


confidence.launches = 0


def reset_launches() -> None:
    confidence.launches = 0
