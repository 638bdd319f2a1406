"""The collectives of a multi-rank mesh, over one mesh axis at a time.

Has no counterpart in the JAX package: there GSPMD's partitioner inserts
the collectives of a sharded step.  The port writes them out where the
serve1d layout (``launch/shard_rules.py``) needs them — the row-parallel
all-reduce after ``wo`` and ``w_down``, the vocab-sharded embedding's
all-reduce, the K/V all-gather before RoPE, the exit heads' triples
gathered before the combine, the branch predicates reduced so that every
rank takes the same branch, and the chunk's rows gathered over ``data`` at
the host sync; for training (the ``default`` layout) also the backward's
collectives, the vocab-parallel loss's reductions and FSDP's gathers and
reduce-scatters.  This module sits below ``models``, ``core`` and
``serving``, which read it, and above the kernels; ``launch/mesh.py``
builds a mesh's transport here.

A :class:`Transport` is one rank's collectives of a mesh: per axis
(``data``, ``model``, ``world`` for the whole mesh, and ``data/p`` for
each block of p consecutive ``data`` ranks) the ranks, the
gloo process group and, on CUDA, an IPC group of the all-reduce kernel
(:mod:`repro_torch.kernels.allreduce`).  Each call takes one backend,
chosen by the tensor's device and never on a failure: ``gloo`` for CPU
tensors (an all-gather, then the plain version's rank-ordered reduction,
``ref_allreduce``), ``ipc`` for CUDA tensors (the kernel, which a CUDA
graph captures).  Every backend reduces in rank order, so all ranks hold
the same bits.  The transport counts calls and bytes (the rank's own
part) per axis.

Whether a step runs tensor-parallel is decided in one place: the active
transport (:func:`active`, thread-local).  The decode loop and the engine
— the only owners of a mesh — set it with :func:`activate` around their
work on a multi-rank mesh; the layers (:func:`tensor_parallel`), the
executor and the loop's guard (:func:`agree`) only read it.  With none
active, or an axis of one rank, no collective is made and every function
computes what it computes without a mesh.

The differentiable collectives (:func:`copy_to`, :func:`reduce_from`,
:func:`gather_from`) are Megatron's pairs over one axis: identity forward
and all-reduce backward; all-reduce forward and identity backward;
all-gather forward and reduce-scatter backward.  Each keeps the transport
it ran with on its autograd context: a backward never reads the active
transport, which on CUDA runs on autograd's device thread, where none is
active.  Under ``torch.no_grad`` (serving) or on a tensor that needs no
gradient they are the transport's plain calls.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import torch

_local = threading.local()


class Transport:
    """One rank's collectives over the axes of a ``(data, model)`` mesh."""

    def __init__(self, mesh, device):
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _get_default_store
        self.device = torch.device(device)
        names = tuple(mesh.mesh_dim_names)
        if names != ("data", "model"):
            raise ValueError(f"a transport needs a ('data', 'model') mesh, "
                             f"got {names}")
        grid = mesh.mesh.tolist()
        me = dist.get_rank()
        self.shape = {"data": len(grid), "model": len(grid[0])}
        self.shape["world"] = self.shape["data"] * self.shape["model"]
        di, mi = next((i, j) for i, row in enumerate(grid)
                      for j, r in enumerate(row) if r == me)
        self.coord = {"data": di, "model": mi,
                      "world": di * self.shape["model"] + mi}
        self.ranks = {"data": [row[mi] for row in grid], "model": grid[di],
                      "world": [r for row in grid for r in row]}
        self.groups = {"data": mesh.get_group("data"),
                       "model": mesh.get_group("model"),
                       "world": dist.group.WORLD}
        # the blocks of p consecutive ``data`` ranks (p a proper divisor of
        # the data size), axis "data/p": the ranks that hold one cohort
        # split over p of them (:meth:`data_block`).  Every rank makes
        # every block's group, in one order (new_group's contract)
        D = self.shape["data"]
        for p in range(2, D):
            if D % p:
                continue
            axis = f"data/{p}"
            for j in range(D // p):
                for col in range(self.shape["model"]):
                    ranks = [grid[j * p + q][col] for q in range(p)]
                    group = dist.new_group(ranks)
                    if me in ranks:
                        self.groups[axis], self.ranks[axis] = group, ranks
            self.shape[axis], self.coord[axis] = p, di % p
        self.calls: Dict[str, int] = dict.fromkeys(self.shape, 0)
        self.bytes: Dict[str, int] = dict.fromkeys(self.shape, 0)
        # calls by "axis/op" (op: sum, max, gather, reduce_scatter, host)
        self.op_calls: Dict[str, int] = {}
        self.ipc: Dict[str, object] = {}
        if self.device.type == "cuda":
            from repro_torch.kernels import allreduce as _ar
            store = _get_default_store()
            for axis in self.shape:
                if self.shape[axis] > 1:
                    self.ipc[axis] = _ar.IpcGroup(
                        store, f"repro_ipc/{axis}/{min(self.ranks[axis])}",
                        self.coord[axis], self.shape[axis], self.device)
            dist.barrier()

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def rank(self, axis: str) -> int:
        return self.coord[axis]

    def data_block(self, p: int) -> Optional[str]:
        """The axis of this rank's block of ``p`` consecutive ``data``
        ranks: None for one rank, ``"data"`` for the whole axis, else
        ``"data/p"``."""
        if p == 1:
            return None
        return "data" if p == self.shape["data"] else f"data/{p}"

    def _count(self, x: torch.Tensor, axis: str, op: str) -> None:
        self.calls[axis] += 1
        self.bytes[axis] += x.numel() * x.element_size()
        key = f"{axis}/{op}"
        self.op_calls[key] = self.op_calls.get(key, 0) + 1

    def _gloo_parts(self, x: torch.Tensor, axis: str):
        """The ranks' tensors of ``x``, in rank order, over gloo (as bytes,
        so any dtype travels)."""
        import torch.distributed as dist
        x = x.contiguous()
        raw = x.view(-1).view(torch.uint8)
        bufs = [torch.empty_like(raw) for _ in range(self.shape[axis])]
        dist.all_gather(bufs, raw, group=self.groups[axis])
        return [b.view(x.dtype).view(x.shape) for b in bufs]

    def all_reduce(self, x: torch.Tensor, axis: str, op: str = "sum"
                   ) -> torch.Tensor:
        """``op`` (sum or max) of ``x`` over ``axis``, in rank order: a new
        tensor (``x`` itself on an axis of one rank)."""
        if self.shape[axis] == 1:
            return x
        return self._reduce(x, axis, op)

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The ranks' ``x`` over ``axis`` stacked in rank order: (R,
        *x.shape)."""
        if self.shape[axis] == 1:
            return x[None]
        return self._reduce(x, axis, "gather")

    def reduce_scatter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x`` (R, *s), R the axis's ranks: the sum over ``axis`` of the
        ranks' row r, in rank order, on rank r — shape s, the bits of
        ``all_reduce(x)[r]`` (``x[0]`` on an axis of one rank)."""
        R = self.shape[axis]
        if x.shape[0] != R:
            raise ValueError(f"reduce_scatter over {axis!r} ({R} ranks): "
                             f"leading dim {x.shape[0]}")
        if R == 1:
            return x[0]
        return self._reduce(x, axis, "reduce_scatter")

    def _reduce(self, x: torch.Tensor, axis: str, op: str) -> torch.Tensor:
        """One counted call: the kernel over the axis's IPC group for a
        CUDA tensor, the plain version over the gloo-gathered parts for a
        CPU one."""
        self._count(x, axis, op)
        if x.device.type == "cuda":
            from repro_torch.kernels import allreduce as _ar
            if op == "reduce_scatter":
                return _ar.reduce_scatter(x, self.ipc[axis])
            return _ar.allreduce(x, self.ipc[axis], op)
        from repro_torch.kernels.ref import ref_allreduce, ref_reduce_scatter
        parts = self._gloo_parts(x, axis)
        if op == "reduce_scatter":
            return ref_reduce_scatter(parts, self.coord[axis])
        return ref_allreduce(parts, op)

    def host_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """A CPU tensor's ranks' copies over ``axis`` through gloo, stacked
        in rank order (the chunk's sync: no device work, nothing to
        capture)."""
        if self.shape[axis] == 1:
            return x[None]
        self._count(x, axis, "host")
        return torch.stack(self._gloo_parts(x.cpu(), axis))

    def gather_rows(self, *arrays):
        """The whole lane's host arrays from each ``data`` rank's rows:
        every array (..., B_local) of 4-byte items gathered in one host
        collective and joined along its last axis in rank order (as they
        are on a ``data`` axis of one rank)."""
        import numpy as np
        if self.shape["data"] == 1:
            return arrays
        arrays = [np.ascontiguousarray(a) for a in arrays]
        flat = np.concatenate([a.view(np.int32).ravel() for a in arrays])
        g = self.host_gather(torch.from_numpy(flat), "data").numpy()
        out, at = [], 0
        for a in arrays:
            parts = [g[r, at:at + a.size].view(a.dtype).reshape(a.shape)
                     for r in range(g.shape[0])]
            out.append(np.concatenate(parts, axis=-1))
            at += a.size
        return tuple(out)

    def close(self) -> None:
        """Free the IPC buffers (after a barrier: every rank is past its
        last launch)."""
        import torch.distributed as dist
        if self.ipc:
            torch.cuda.synchronize(self.device)
            dist.barrier()
            for g in self.ipc.values():
                g.close()
            self.ipc = {}


def transport(mesh, device=None) -> Transport:
    """The mesh's :class:`Transport`, made at its first request (every rank
    must make it together: the IPC handles are exchanged then)."""
    t = getattr(mesh, "_repro_transport", None)
    if t is None:
        if device is None:
            device = mesh.device_type
        t = Transport(mesh, device)
        mesh._repro_transport = t
    return t


def active() -> Optional[Transport]:
    """The transport of the step this thread runs, or None."""
    return getattr(_local, "transport", None)


def tensor_parallel() -> Optional[Transport]:
    """The active transport when its ``model`` axis has more than one
    rank: the layers' tensor-parallel route."""
    t = active()
    return t if t is not None and t.shape["model"] > 1 else None


def batch_rows() -> Optional[str]:
    """The axis over whose ranks a call on the whole batch has its rows
    split: the active transport's ``data`` axis when it has more than one
    rank, else None."""
    t = active()
    return None if t is None else t.data_block(t.size("data"))


@contextlib.contextmanager
def activate(t: Optional[Transport]):
    """Make ``t`` this thread's active transport inside the block."""
    prev = active()
    _local.transport = t
    try:
        yield t
    finally:
        _local.transport = prev


def tracks(x: torch.Tensor) -> bool:
    """Whether autograd records ``x``: grad mode on and ``x`` needing a
    gradient (training; serving's params need none)."""
    return torch.is_grad_enabled() and x.requires_grad


class _Copy(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the axis."""

    @staticmethod
    def forward(ctx, x, t, axis):
        ctx.t, ctx.axis = t, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.t.all_reduce(g.contiguous(), ctx.axis), None, None


class _Reduce(torch.autograd.Function):
    """All-reduce (sum) forward; the gradient passed through."""

    @staticmethod
    def forward(ctx, x, t, axis):
        return t.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    """All-gather forward, (R, *x.shape); the gradient reduce-scattered:
    rank r's input feeds row r on every rank, so its gradient is the sum
    over ranks of their row r."""

    @staticmethod
    def forward(ctx, x, t, axis):
        ctx.t, ctx.axis = t, axis
        return t.all_gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.t.reduce_scatter(g.contiguous(), ctx.axis), None, None


def copy_to(t: Optional[Transport], x: torch.Tensor, axis: str = "model"
            ) -> torch.Tensor:
    """``x`` as it is, its gradient all-reduced over ``axis``: what goes
    before a column-parallel product on a replicated input."""
    if t is None or t.shape[axis] == 1 or not tracks(x):
        return x
    return _Copy.apply(x, t, axis)


def reduce_from(t: Optional[Transport], x: torch.Tensor,
                axis: str = "model") -> torch.Tensor:
    """The sum of ``x`` over ``axis`` (rank order), its gradient passed to
    every rank's ``x`` as it is: a row-parallel product's completion."""
    if t is None:
        return x
    if not tracks(x):
        return t.all_reduce(x, axis)
    return _Reduce.apply(x, t, axis)


def gather_from(t: Transport, x: torch.Tensor, axis: str = "model"
                ) -> torch.Tensor:
    """The ranks' ``x`` over ``axis`` stacked in rank order, (R,
    *x.shape), its gradient reduce-scattered back."""
    if not tracks(x):
        return t.all_gather(x, axis)
    return _Gather.apply(x, t, axis)


def agree(pred: torch.Tensor) -> torch.Tensor:
    """A branch predicate (0-d or a vector of bools) made the same on
    every rank: OR-reduced (max) over the whole mesh when a multi-rank
    transport is active, as it is."""
    t = active()
    if t is None or t.shape["world"] == 1:
        return pred
    return t.all_reduce(pred.to(torch.int32).view(-1).float(),
                        "world", "max").view(pred.shape) > 0
