"""Build and load the port's CUDA C++ kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with :mod:`ctypes` (no
PyTorch headers, so a build takes seconds, not minutes).  Libraries are
built at first use, from this package's sources only, into
``build/repro_torch_kernels/`` at the repository root (listed in
``.gitignore``), under a name keyed by a hash of the sources and flags: a
changed source rebuilds, an unchanged one loads what is there.
:func:`build_all` starts one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNELS = ("rmsnorm", "exit_update", "decode_attention", "flash_attention",
           "confidence", "megakernel", "cohort_scatter", "paged_gather",
           "cond_node", "allreduce")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernels take float32/bfloat16/float16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (on PATH, under CUDA_HOME or "
                           "/usr/local/cuda): the CUDA kernels cannot be built")
    return path


def lib_path(name: str) -> Path:
    """Where the library of kernel ``name`` lives for the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = KERNELS, verbose: bool = False
              ) -> Dict[str, float]:
    """Compile every kernel in ``names`` whose library is missing, one
    ``nvcc`` process per source, all started together.  Returns the
    build's wall time in seconds per name (0.0 for a library that was
    already built).  ``verbose`` adds ``-Xptxas -v`` (registers, shared
    memory and spills per kernel) and prints what the compiler said."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    times = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            times[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        if verbose and log:
            print(f"--- nvcc {name}.cu:\n{log}", flush=True)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build_all([name])
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


def function(name: str, symbol: str, argtypes: Sequence):
    """The C entry point ``symbol`` of kernel ``name``, typed: every pointer
    and the stream as ``c_void_p`` (never truncated to a 32-bit int) and an
    ``int`` (cudaError_t) result."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise on the cudaError_t an entry point returned (0 = success)."""
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {err}")


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor (None -> NULL)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """A kernel wrapper's device check: every tensor on one CUDA device.
    Anything else raises — there is no fallback off the CPU."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"{what}: the kernel runs on CUDA tensors of one device; "
                f"got {t.device} (the plain version serves CPU tensors only)")
