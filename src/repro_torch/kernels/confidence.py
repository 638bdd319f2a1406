"""Fused softmax-confidence kernel and its plain version.

Replaces the TPU kernel ``_conf_kernel`` / ``confidence`` of the JAX
package's ``kernels/confidence.py`` (its ``pallas_call`` at line 72): per
row of (B, V) logits, the argmax (first index of the maximum) and
δ = max softmax = 1/Σexp(x − max) (Defs. 3.2–3.3), the softmax never
materialised.  It is the measure Algorithm 1 (``cascade_infer_sequential``,
the batch-uniform decision) takes when ``use_kernels`` is set.

Route: CUDA C++ (``csrc/confidence.cu``), ctypes-bound, one build route
with the other kernels.  Bound on the H100: bytes (one read of the
logits).  The vocab is split across blocks (4096 columns each) and a
second launch merges each row's partials — the same partial and combine
device code as the exit-head megakernel (``csrc/common.cuh``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_confidence

_SIG = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]


def confidence(logits: torch.Tensor):
    """logits (B, V) -> (argmax (B,) int32, δ (B,) f32).  CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if logits.device.type == "cpu":
        return ref_confidence(logits)
    build.require_cuda("confidence", logits)
    if logits.dim() != 2 or logits.stride(1) != 1:
        raise ValueError("confidence: logits must be (B, V) with a "
                         f"contiguous last dim, got {tuple(logits.shape)}")
    B, V = logits.shape
    dev = logits.device
    tiles = build.function("confidence", "confidence_tiles",
                           [ctypes.c_int])(V)
    workspace = torch.empty((3, B, tiles), dtype=torch.float32, device=dev)
    idx = torch.empty(B, dtype=torch.int32, device=dev)
    conf = torch.empty(B, dtype=torch.float32, device=dev)
    fn = build.function("confidence", "confidence_launch", _SIG)
    p = build.ptr
    build.check(fn(p(logits), logits.stride(0), B, V,
                   build.dtype_code(logits), p(workspace), p(idx), p(conf),
                   build.stream_of(logits)), "confidence")
    confidence.launches += 1
    return idx, conf


confidence.launches = 0


def reset_launches() -> None:
    confidence.launches = 0
