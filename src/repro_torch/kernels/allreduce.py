"""One-shot all-reduce / all-gather / reduce-scatter over CUDA IPC buffers,
and their plain versions.

Replaces no TPU kernel.  The JAX package's multi-device serving runs its
decode loop under GSPMD, whose partitioner inserts the collectives; the
port's decode loop captures a whole guarded iteration in a CUDA graph, so
each collective of a multi-rank step has to be a kernel launched on the
capturing stream.  gloo's CUDA collectives stage through the host (not
capturable) and NCCL refuses two ranks of one communicator on one device,
the layout of the one-card machine; this kernel works between processes
(or threads) on one device and between peer devices alike.

Route: CUDA C++ (``csrc/allreduce.cu``), ctypes-bound.  An
:class:`IpcGroup` is one rank's view of one mesh axis's ranks: a region of
its own device memory (a flags header and two data buffers, allocated by
the library with ``cudaMalloc``) whose IPC handle it publishes through a
``torch.distributed`` store, and every peer's region opened from theirs.
A launch copies the rank's part into its buffer, raises its flag to the
launch's generation, waits for every peer's flag, and reduces the R parts
in rank order in f32 (or stacks them: the all-gather) — the same bits on
every rank.  :func:`reduce_scatter` (training's K/V-gather backward and
FSDP's gradient reduction) publishes a rank's whole (R, *s) tensor and
leaves on rank r the rank-ordered sum of row r only (the bits of the
all-reduce's row r).  See the source's header for the protocol.

The wait is bounded (:data:`TIMEOUT_S` of the device's global timer):
past it the kernel records (rank, generation, peer) in a host-mapped word
and traps.  :func:`raise_if_timed_out` turns that word into an error
naming them, after the sync that reported the trap.

Bound on the H100: latency (a launch and a flag round trip; with two
processes time-sliced on one card, a context switch per wait), not the
bytes: (4, 2048) bf16 is 16 KB.
"""
from __future__ import annotations

import ctypes
from typing import List

import torch

from repro_torch.kernels import build

OPS = {"sum": 0, "max": 1, "gather": 2, "reduce_scatter": 3}
# dtype codes of csrc/allreduce.cu: build.DTYPE_CODES and int32
_CODES = {**build.DTYPE_CODES, torch.int32: 3}
# bytes of one of a region's two data buffers: a call larger than this is
# split into several launches
CAP = 32 << 20
# seconds a launch waits for a peer before it traps
TIMEOUT_S = 10.0
_HANDLE = 64                      # sizeof(cudaIpcMemHandle_t)
_LAUNCH_SIG = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
               ctypes.c_longlong,
               ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.POINTER(ctypes.c_void_p), ctypes.c_longlong,
               ctypes.c_void_p, ctypes.c_double, ctypes.c_void_p]


def _fn(symbol: str, argtypes):
    return build.function("allreduce", symbol, argtypes)


def _error_word():
    host = ctypes.c_void_p()
    build.check(_fn("allreduce_error_word", [ctypes.POINTER(
        ctypes.c_void_p)])(ctypes.byref(host)), "allreduce_error_word")
    return (ctypes.c_uint * 4).from_address(host.value)


def raise_if_timed_out() -> None:
    """Raise if a launch of this process trapped at its wait bound, naming
    the waiting rank, the generation it waited for and the peer."""
    if "allreduce" not in build._libs:
        return
    word = _error_word()
    if word[0]:
        raise RuntimeError(
            f"allreduce: rank {word[1]} waited more than {TIMEOUT_S} s for "
            f"peer {word[3]} to reach generation {word[2]}; the peer "
            "stopped or runs another sequence of collectives")


class IpcGroup:
    """One rank's IPC view of a group of ``size`` ranks on CUDA devices.

    ``store`` is a ``torch.distributed`` store every rank of the group
    reaches; ``key`` names the group there (unique per group); ``rank`` is
    this process's index in the group.  Every rank must construct its
    group before any rank launches on it."""

    def __init__(self, store, key: str, rank: int, size: int, device):
        if not 1 <= size <= 8:
            raise ValueError(f"IpcGroup: {size} ranks (1..8)")
        self.rank, self.size = int(rank), int(size)
        self.device = torch.device(device)
        _error_word()                      # the mapped word, before any use
        hdr = _fn("allreduce_header_bytes", [])
        hdr.restype = ctypes.c_longlong
        nbytes = int(hdr()) + 2 * CAP
        with torch.cuda.device(self.device):
            own = ctypes.c_void_p()
            handle = ctypes.create_string_buffer(_HANDLE)
            build.check(_fn("allreduce_alloc", [
                ctypes.c_longlong, ctypes.POINTER(ctypes.c_void_p),
                ctypes.c_void_p])(nbytes, ctypes.byref(own), handle),
                "allreduce_alloc")
            self._own = own.value
            store.set(f"{key}/{self.rank}", handle.raw)
            bases: List[int] = []
            self._opened: List[int] = []
            for p in range(self.size):
                if p == self.rank:
                    bases.append(self._own)
                    continue
                peer = store.get(f"{key}/{p}")
                ptr = ctypes.c_void_p()
                build.check(_fn("allreduce_open", [
                    ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)])(
                        peer, ctypes.byref(ptr)), f"allreduce_open({p})")
                bases.append(ptr.value)
                self._opened.append(ptr.value)
        self._bases = (ctypes.c_void_p * self.size)(*bases)
        ctas = _fn("allreduce_max_ctas", [])()
        # the per-CTA generation counters, in this rank's own memory
        self.gens = torch.zeros(ctas, dtype=torch.int32, device=self.device)

    def close(self) -> None:
        """Unmap the peers' regions and free this rank's.  Every rank of
        the group must be past its last launch (a barrier first)."""
        for ptr in self._opened:
            _fn("allreduce_close", [ctypes.c_void_p])(ptr)
        self._opened = []
        if self._own:
            _fn("allreduce_free", [ctypes.c_void_p])(self._own)
            self._own = 0


def allreduce(x: torch.Tensor, group: IpcGroup, op: str = "sum"
              ) -> torch.Tensor:
    """``op`` (``sum``, ``max`` or ``gather``) of ``x`` over the ranks of
    ``group``: x's shape for sum and max, (R, *x.shape) for gather — the
    same bits on every rank, reduced in rank order in f32.

    One launch per :data:`CAP` bytes of the call.  A CUDA tensor only: the
    plain version (``ref.ref_allreduce``) needs every rank's part, which a
    CPU transport gathers itself (``repro_torch/parallel.py``)."""
    if op not in ("sum", "max", "gather"):
        raise ValueError(f"allreduce: op {op!r} (sum, max or gather; "
                         "reduce_scatter has its own wrapper)")
    build.require_cuda("allreduce", x, group.gens)
    if x.dtype not in _CODES or (x.dtype == torch.int32 and op != "gather"):
        raise TypeError(f"allreduce: {x.dtype} (f32, bf16, f16; int32 for "
                        "gather)")
    x = x.contiguous()
    flat = x.reshape(-1)
    n = flat.numel()
    R = group.size
    out = torch.empty(((R,) if op == "gather" else ()) + tuple(x.shape),
                      dtype=x.dtype, device=x.device)
    oflat = out.reshape(R, -1) if op == "gather" else out.reshape(-1)
    step = max(1, CAP // x.element_size())
    fn = _fn("allreduce_launch", _LAUNCH_SIG)
    stream = build.stream_of(x)
    for lo in range(0, max(n, 1), step):
        hi = min(n, lo + step)
        piece = flat[lo:hi]
        dst = (torch.empty((R, hi - lo), dtype=x.dtype, device=x.device)
               if op == "gather" and (lo or hi < n) else
               (oflat if op == "gather" else oflat[lo:hi]))
        build.check(fn(build.ptr(piece), build.ptr(dst), hi - lo, 0,
                       _CODES[x.dtype], OPS[op], R, group.rank, group._bases,
                       CAP, build.ptr(group.gens), TIMEOUT_S, stream),
                    "allreduce")
        if dst is not oflat and op == "gather":
            oflat[:, lo:hi].copy_(dst)
        allreduce.launches += 1
    return out


allreduce.launches = 0


def reduce_scatter(x: torch.Tensor, group: IpcGroup) -> torch.Tensor:
    """``x`` (R, *s), R the group's ranks: on rank r the sum over the ranks
    of their row r, in rank order in f32, cast back — shape s, the bits of
    ``allreduce(x, group)[r]`` (plain version: ``ref.ref_reduce_scatter``).

    One launch per chunk of ``allreduce_rs_capacity`` elements of each row
    (the rows cut at the same places, so every chunk stays rank-sliced and
    fits a buffer).  A CUDA tensor only, f32 / bf16 / f16."""
    build.require_cuda("reduce_scatter", x, group.gens)
    R = group.size
    if x.dim() < 1 or x.shape[0] != R:
        raise ValueError(f"reduce_scatter: leading dim {tuple(x.shape)[:1]} "
                         f"for a group of {R} ranks")
    if x.dtype not in build.DTYPE_CODES:
        raise TypeError(f"reduce_scatter: {x.dtype} (f32, bf16, f16)")
    rows = x.contiguous().reshape(R, -1)
    n = rows.shape[1]
    out = torch.empty(tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    oflat = out.reshape(-1)
    cap_fn = _fn("allreduce_rs_capacity", [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_longlong])
    cap_fn.restype = ctypes.c_longlong
    step = int(cap_fn(_CODES[x.dtype], R, CAP))
    if step <= 0:
        raise ValueError(f"reduce_scatter: no capacity for {R} ranks")
    fn = _fn("allreduce_launch", _LAUNCH_SIG)
    stream = build.stream_of(x)
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        build.check(fn(build.ptr(rows[0, lo:]), build.ptr(oflat[lo:hi]),
                       hi - lo, n, _CODES[x.dtype], OPS["reduce_scatter"], R,
                       group.rank, group._bases, CAP, build.ptr(group.gens),
                       TIMEOUT_S, stream), "reduce_scatter")
        reduce_scatter.launches += 1
    return out


reduce_scatter.launches = 0


def reset_launches() -> None:
    allreduce.launches = 0
    reduce_scatter.launches = 0
