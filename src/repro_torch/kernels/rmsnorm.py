"""RMSNorm kernel and its plain version.

Replaces the TPU kernel ``_rmsnorm_kernel`` / ``rmsnorm`` of the JAX
package's ``kernels/rmsnorm.py`` (its ``pallas_call`` at line 42).

Route: CUDA C++ (``csrc/rmsnorm.cu``), built with ``nvcc`` and bound with
ctypes.  The norm is one row reduction with an elementwise epilogue, which
Triton would express as directly; CUDA C++ keeps all four kernels of the
port on one build route, and a ctypes launch costs a few microseconds of
host time where a Triton launch costs tens — at decode (R = 4 rows) the
launch is most of this kernel's time.

Bound on the H100: bytes (one read and one write of x, one read of w); see
the source's header for what the simple design leaves for later.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_rmsnorm

_SIG = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]


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
    fn = build.function("rmsnorm", "rmsnorm_launch", _SIG)
    build.check(fn(build.ptr(x), build.ptr(w), build.ptr(out), x.shape[0],
                   x.shape[1], float(eps), build.dtype_code(x),
                   build.dtype_code(w), build.stream_of(x)), "rmsnorm")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0


def reset_launches() -> None:
    rmsnorm.launches = 0
