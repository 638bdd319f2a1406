"""Conditional (IF) nodes in a captured CUDA graph, and the branch runners
the staged executor takes its branches through.

The device runtime replays one captured decode iteration K times a chunk.
The reference's ``lax.cond`` (a cond_batch segment skip) and the guard of
its ``lax.while_loop`` become IF nodes: the graph reads each predicate
from device memory when it runs, and runs the node's body only when it is
true, so a skipped segment does no work at all (the branchless ``select``
form would compute it and throw it away).

The card's PyTorch has no public call that captures into an IF node, so
``csrc/cond_node.cu`` builds one (``cudaGraphConditionalHandleCreate``, an
IF node added to the capturing graph, a one-thread kernel that sets the
handle from the predicate) and starts capturing a second stream into the
node's body.  PyTorch ops inside the body run on that stream, which is
made the current one; every allocation of this thread during the capture
goes to the graph's private memory pool, whatever its stream.

Three runners, one interface (``run_if(pred, fn, negate=False)``, the
device counters ``segments`` and ``dispatch``, and ``device``):

* ``None`` in the executor — the host runtime: each predicate is read to
  the host and a Python ``if`` picks the branch (no runner object);
* :class:`WarmBranches` — every body runs eagerly, each branch forced, on
  scratch tensors, so that every kernel route and every library handle a
  capture will reach is built, loaded and configured before it;
* :class:`CapturedBranches` — the capture: each ``run_if`` is an IF node
  whose body counts its own executions on the device (``bodies``); the
  launch counters of the port's kernels are Python increments that run at
  capture only, so each body records the launches captured in it
  (:attr:`CapturedBranches.body_launches`) and the device runtime adds
  launches per capture × executions after every chunk.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, List

import torch

from repro_torch import kernels
from repro_torch.kernels import build

_SIG_BEGIN = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
              ctypes.POINTER(ctypes.c_int)]
_STAGES = {1: "reading the capture", 2: "creating the handle",
           3: "launching the set kernel", 4: "adding the IF node",
           5: "setting the dependencies", 6: "capturing the body"}
_SIG_END = [ctypes.c_void_p]
_STREAMS: Dict = {}


class WarmBranches:
    """Run every branch body eagerly, whatever its predicate: a warm pass
    over scratch tensors before a capture."""

    def __init__(self, n_components: int, device):
        self.device = torch.device(device)
        self.segments = torch.zeros(n_components, dtype=torch.int32,
                                    device=self.device)
        self.dispatch = torch.zeros(3, dtype=torch.int32, device=self.device)

    def run_if(self, pred, fn, negate: bool = False):
        del pred, negate
        fn()


class CapturedBranches:
    """IF nodes of one CUDA graph under capture.

    ``counters`` is a preallocated (n,) int32 device tensor the bodies
    count their executions in (body i adds 1 to ``counters[i]`` each time
    it runs); ``segments`` and ``dispatch`` are device counters the
    executor adds its per-step ``segments_run`` and cohort-dispatch
    numbers to.  :meth:`capture` wraps the whole capture."""

    def __init__(self, counters: torch.Tensor, segments: torch.Tensor,
                 dispatch: torch.Tensor):
        self.device = counters.device
        self.bodies = counters
        self.segments = segments
        self.dispatch = dispatch
        self.graph = torch.cuda.CUDAGraph()
        # launches captured in each body, its nested bodies' excluded; and
        # those outside every body
        self.body_launches: List[Dict] = []
        self.top_launches: Dict = {}
        self._open: List[List[Dict]] = []
        self._fn = None

    def _stream(self, role) -> torch.cuda.ExternalStream:
        """The stream a capture (``role`` "capture") or the bodies at
        nesting depth ``role`` are captured on: one per (device, role) for
        the process, created here rather than taken from PyTorch's stream
        pool, whose streams come round again (a body captured on the
        capture's own stream fails); bodies of every capture share them,
        and with them their library workspaces (cuBLAS keeps one per
        stream)."""
        key = (self.device, role)
        if key not in _STREAMS:
            handle = ctypes.c_void_p()
            with torch.cuda.device(self.device):
                build.check(build.function(
                    "cond_node", "cond_stream_create",
                    [ctypes.POINTER(ctypes.c_void_p)])(ctypes.byref(handle)),
                    "cond_stream_create")
            _STREAMS[key] = torch.cuda.ExternalStream(handle.value,
                                                      device=self.device)
        return _STREAMS[key]

    @contextlib.contextmanager
    def capture(self):
        """Capture the graph on a side stream; every allocation this thread
        makes meanwhile, on any stream, comes from the graph's pool."""
        self._fn = (build.function("cond_node", "cond_if_begin", _SIG_BEGIN),
                    build.function("cond_node", "cond_if_end", _SIG_END))
        dev = self.device.index if self.device.index is not None \
            else torch.cuda.current_device()
        side = self._stream("capture")
        # the guard, a dispatch branch, a cohort's cell and its shadow
        # branch: bodies nest this deep at most
        for depth in range(4):
            self._stream(depth)
        side.wait_stream(torch.cuda.current_stream(self.device))
        before = kernels.launch_snapshot()
        with torch.cuda.stream(side):
            pool = torch.cuda.graph_pool_handle()
            self.graph.capture_begin(pool=pool)
            # the capture routes the capture stream's allocations to the
            # pool; the IF bodies run on other streams: route every
            # allocation of this thread instead, for the whole capture
            torch._C._cuda_endAllocateToPool(dev, pool)
            torch._C._cuda_beginAllocateCurrentThreadToPool(dev, pool)
            try:
                yield self
            finally:
                torch._C._cuda_endAllocateToPool(dev, pool)
                # give capture_end the stream filter it ends, and drop the
                # pool reference that extra begin took
                torch._C._cuda_beginAllocateCurrentStreamToPool(dev, pool)
                torch._C._cuda_releasePool(dev, pool)
                torch._C._cuda_releasePool(dev, pool)
                self.graph.capture_end()
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.top_launches = kernels.launch_diff(kernels.launch_snapshot(),
                                                before)
        for own in self.body_launches:
            self.top_launches = kernels.launch_diff(self.top_launches, own)

    def run_if(self, pred, fn, negate: bool = False):
        """Capture ``fn()`` into an IF node that runs when the 0-d bool
        device tensor ``pred`` (negated with ``negate``) is true."""
        if pred.dtype != torch.bool or pred.numel() != 1:
            raise TypeError(f"run_if: the predicate must be one bool, got "
                            f"{pred.dtype} {tuple(pred.shape)}")
        idx = len(self.body_launches)
        if idx >= self.bodies.numel():
            raise RuntimeError(f"run_if: more than {self.bodies.numel()} "
                               f"IF bodies in one capture")
        self.body_launches.append({})
        begin, end = self._fn
        parent = torch.cuda.current_stream(self.device)
        child = self._stream(len(self._open))
        stage = ctypes.c_int(0)
        err = begin(parent.cuda_stream, child.cuda_stream, build.ptr(pred),
                    int(negate), ctypes.byref(stage))
        build.check(err, f"cond_if_begin ({_STAGES.get(stage.value)}, "
                         f"nesting depth {len(self._open)})")
        before = kernels.launch_snapshot()
        self._open.append([])
        try:
            with torch.cuda.stream(child):
                self.bodies[idx:idx + 1].add_(1)
                fn()
        finally:
            nested = self._open.pop()
            build.check(end(child.cuda_stream), "cond_if_end")
        delta = kernels.launch_diff(kernels.launch_snapshot(), before)
        own = delta
        for d in nested:
            own = kernels.launch_diff(own, d)
        self.body_launches[idx] = own
        if self._open:
            self._open[-1].append(delta)

    def replayed_launches(self, executions, replays: int) -> Dict:
        """Kernel launches the graph's replays ran: each body's own
        launches times its executions (``executions``, the fetched
        counters), plus those outside every body times ``replays``."""
        total = kernels.launch_scale(self.top_launches, replays)
        for own, n in zip(self.body_launches, executions):
            total = kernels.launch_sum(total, kernels.launch_scale(own,
                                                                   int(n)))
        return total
