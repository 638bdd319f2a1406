"""RMSNorm kernel and its plain version.

Replaces the TPU kernel ``_rmsnorm_kernel`` / ``rmsnorm`` of the JAX
package's ``kernels/rmsnorm.py`` (its ``pallas_call`` at line 42).

Route: CUDA C++ (``csrc/rmsnorm.cu``), built with ``nvcc`` and bound with
ctypes, with two device routes that :func:`route` picks before the launch
on the shape, the dtypes and the alignment alone:

- ``"warp"`` — one warp a row, four rows a block: the row read once into
  registers with 16-byte loads, its sum of squares by a shuffle tree (no
  shared memory, no barrier), 16-byte stores.  Rows of at most 16
  16-byte chunks a lane (d ≤ 4096 in bf16 / fp16, ≤ 2048 in f32) with d a
  multiple of 16 bytes, 16-byte aligned bases and w in f32 or x's dtype:
  every norm of the serving paths.  The exit-head megakernel's prologue
  uses the same row arithmetic (``csrc/common.cuh``), so fused and unfused
  exit heads normalise a row bit for bit alike;
- ``"block"`` — a 256-thread block takes ``rows`` consecutive rows (the
  tile registry's ``rmsnorm.rows``, :mod:`repro_torch.kernels.autotune`;
  1 by default), for every other shape (d 7168 in bf16 among them).

``rmsnorm.launches`` counts every launch, ``rmsnorm.launches_by_route``
each route's.  Bound on the H100: bytes (one read and one write of x, one
read of w).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import autotune, build
from repro_torch.kernels.ref import ref_rmsnorm

ROUTES = ("warp", "block")
_SYMBOLS = {"warp": "rmsnorm_warp_launch", "block": "rmsnorm_launch"}
MAX_CHUNKS = 16 * 32   # 16-byte chunks a row may hold on the warp route

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
         ctypes.c_int]
# the block route takes its rows a block before the stream
_SIG = {"warp": _ARGS + [ctypes.c_void_p],
        "block": _ARGS + [ctypes.c_int, ctypes.c_void_p]}


def warp_rows_ok(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the rows of the 2-D view ``x`` (last dim contiguous) and the
    weights ``w`` fit the warp-per-row arithmetic: 16-bit or f32 x, d a
    whole number of 16-byte chunks and at most 16 of them a lane, x's base
    and row stride and w's base 16-byte aligned, w contiguous in f32 or
    x's dtype."""
    if x.dtype not in build.DTYPE_CODES or w.dtype not in (torch.float32,
                                                            x.dtype):
        return False
    esz = x.element_size()
    d = x.shape[-1]
    return (d % (16 // esz) == 0 and d * esz // 16 <= MAX_CHUNKS
            and x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and (x.shape[0] <= 1 or x.stride(0) * esz % 16 == 0)
            and w.is_contiguous() and w.data_ptr() % 16 == 0)


def route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The device route a launch on the (R, d) rows ``x`` (as the wrapper
    hands them to the kernel: contiguous) takes."""
    return "warp" if warp_rows_ok(x, w) else "block"


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """x: (R, d); w: (d,) -> (R, d) in x's dtype: ``(x * rsqrt(mean(x²) +
    eps)) * w`` in f32, then cast.  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return ref_rmsnorm(x, w, eps)
    build.require_cuda("rmsnorm", x, w)
    if x.dim() != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm: x (R, d) and w (d,), got {tuple(x.shape)}"
                         f" and {tuple(w.shape)}")
    x = x.contiguous()
    w = w.contiguous()
    out = torch.empty_like(x)
    r = route(x, w)
    fn = build.function("rmsnorm", _SYMBOLS[r], _SIG[r])
    args = [build.ptr(x), build.ptr(w), build.ptr(out), x.shape[0],
            x.shape[1], float(eps), build.dtype_code(x), build.dtype_code(w)]
    if r == "block":
        args.append(int(autotune.tile("rmsnorm", "rows")))
    build.check(fn(*args, build.stream_of(x)), "rmsnorm")
    rmsnorm.launches += 1
    rmsnorm.launches_by_route[r] += 1
    return out


rmsnorm.launches = 0
rmsnorm.launches_by_route = dict.fromkeys(ROUTES, 0)


def reset_launches() -> None:
    rmsnorm.launches = 0
    rmsnorm.launches_by_route.update(dict.fromkeys(ROUTES, 0))
