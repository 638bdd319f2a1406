"""Device decode runtime: K tokens a dispatch, one host sync a chunk.

The counterpart of the JAX package's ``serving/runtime.py``.  The host
runtime (``serving/engine.py``) launches every op of one decode step from
Python and reads the result back every token; at serving batch sizes the
launches, not the card, set the pace.  :class:`DeviceDecodeLoop` decodes up
to K tokens per lane per dispatch: on a CUDA lane it captures ONE guarded
iteration of :func:`repro_torch.launch.steps.make_decode_loop_step` in a
CUDA graph and replays it K times.  The guard (``i < K and any(active)``,
the reference's ``lax.while_loop`` condition) and every cond_batch segment
skip (its ``lax.cond``) are IF nodes the device sets from the predicate
(:mod:`repro_torch.kernels.cond_node`), so an exited segment and a
finished chunk really skip their work; the major cohort layout's three
dispatch branches are IF nodes too, the mixed one holding each cohort's.
Tokens, exit indices, confidences and the live mask land in (K, B) device
buffers, and the chunk reaches the host in ONE copy into pinned memory and
one stream synchronize.

The graph reads fixed addresses, so a lane's cache, kpos ring and
DecodeState tensors — its telemetry counters and live threshold vector
included — are the captured ones for its whole life (the engine writes
them in place; a re-prefill refills them and carries the telemetry over);
the token and the budgets are the loop's own buffers, loaded at each
chunk.  One capture serves one set of lane buffers: :attr:`captures`
counts them.  The exit kernels read δ̂ from device memory (the lane's
live vector, or the executor's copy of the config's), so a threshold push
is a write into a captured tensor and costs no capture.  Before a
capture, one iteration runs eagerly over scratch copies with every branch
forced — the telemetry shadow pass's observe and skip branches and its
fold included — so that every kernel route is built, loaded and
configured and no capture meets a lazy set-up.  A failed capture raises;
there is no eager fallback on CUDA.

The port's kernel launch counters are Python increments, which a replay
does not run: after each chunk the loop adds each IF body's launches (as
captured) times its executions (counted on the device and fetched in the
chunk's copy), so the counters report the launches the replays ran.

On a CPU lane the same iteration runs eagerly, its guard and branches read
on the host (a device read there costs nothing and takes the same
branches).  As in the reference, requests still queued when a chunk
starts join at the next chunk boundary (the engine admits between
dispatches): the one sanctioned divergence from the host runtime.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core.exec import DISPATCH, DecodeState
from repro_torch.kernels.cond_node import CapturedBranches, WarmBranches
from repro_torch.launch.steps import LoopBuffers, make_decode_loop_step
from repro_torch.models import nn


def kernel_provenance(cfg, device) -> dict:
    """The kernel backend this config runs on ``device``: ``cuda`` (the
    hand-written kernels), ``torch-cpu`` (their plain versions) or ``off``
    (``use_kernels`` unset), and the device's name."""
    device = torch.device(device)
    on_gpu = device.type == "cuda"
    return {
        "kernel_backend": (("cuda" if on_gpu else "torch-cpu")
                           if cfg.use_kernels else "off"),
        "kernel_platform": (torch.cuda.get_device_name(device) if on_gpu
                            else "cpu"),
    }


@dataclasses.dataclass
class DecodeChunk:
    """Host view of one dispatch, trimmed to the steps that ran.

    ``tokens`` / ``exits`` / ``confs`` / ``live`` are (n_steps, B); row i
    of ``live`` marks the slots still generating when step i's token was
    produced.  ``remaining`` the budgets after the chunk; ``t`` the lane's
    position after it.  ``seconds`` is the host wall-clock of the dispatch
    including its one sync; ``t_host`` the ``perf_counter`` stamp at its
    start; ``compiled`` marks a dispatch that paid a capture (or, on a CPU
    lane, the loop's first): callers report its time as compile cost."""

    tokens: np.ndarray
    exits: np.ndarray
    confs: np.ndarray
    live: np.ndarray
    n_steps: int
    remaining: np.ndarray
    seconds: float
    compiled: bool
    t_host: float = 0.0
    t: int = -1


def _state_tensors(state: DecodeState):
    tel = [] if state.tel is None else state.tel.tensors()
    return [x for x in (state.t, state.active, state.policy, state.ema_conf,
                        state.block_tables, state.thresholds, *tel)
            if x is not None]


def _scratch_state(state: DecodeState) -> DecodeState:
    """A copy of ``state`` whose tensors (and telemetry) are clones."""
    fields = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.Tensor) or (f.name == "tel" and v is not None):
            v = v.clone()
        fields[f.name] = v
    return dataclasses.replace(state, **fields)


def _key_of(*tensors) -> tuple:
    return tuple((x.data_ptr(), tuple(x.shape), tuple(x.stride()), x.dtype)
                 for x in tensors)


@contextlib.contextmanager
def _syncs_raise(on: bool):
    """With ``on``, make any device sync inside the block raise; the
    caller's sync debug mode comes back after it."""
    if not on:
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


class _Capture:
    """One captured guarded iteration and the buffers it reads."""

    def __init__(self, branches: CapturedBranches, out: LoopBuffers,
                 token: torch.Tensor, staging: torch.Tensor):
        self.branches = branches
        self.out = out
        self.token = token
        self.staging = staging          # device side of the input upload


class DeviceDecodeLoop:
    """K-token decode dispatches over the staged executor.

    ``run_chunk`` is the public surface: feed it a lane's continuation
    token, cache, carried DecodeState and per-slot remaining budget; get
    back a :class:`DecodeChunk` and the cache and state, updated in place.
    """

    def __init__(self, model, cfg, chunk: int = 8, cache_len: int = 256,
                 mesh=None):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if mesh is not None:
            raise NotImplementedError(
                "mesh sharding of the decode loop comes with the multi-GPU "
                "slice of the port")
        self.cfg = cfg
        self.model = model
        self.chunk = int(chunk)
        self.cache_len = int(cache_len)
        self.step = make_decode_loop_step(model, cfg, self.chunk,
                                          self.cache_len)
        self.executor = self.step.executor
        self.compile_seconds = 0.0
        # graphs captured (one per lane buffers) and device -> host syncs
        # (one per CUDA chunk)
        self.captures = 0
        self.host_syncs = 0
        # a check for tests and the card smoke: run each chunk's replays
        # and result copy under sync debug mode "error", so that a sync
        # there raises
        self.sync_check = False
        self._graphs: Dict[tuple, _Capture] = {}
        self._pinned: Dict[tuple, torch.Tensor] = {}
        self._warm = False

    # ------------------------------------------------------------------
    def run_chunk(self, params, token, cache, state: DecodeState, remaining,
                  active=None):
        """Decode up to ``chunk`` tokens for one lane.

        token: (B, 1) int32 continuation token per slot; remaining: (B,)
        int32 tokens each slot may still generate (0 = finished slot);
        ``active`` (host (B,) bool, optional) is loaded into
        ``state.active`` with the chunk's inputs, else ``state.active``
        must already mask finished slots.  Returns ``(DecodeChunk, cache,
        state)``: the cache and state are the ones passed in, updated in
        place (``state.segments_run`` gains the chunk's counts)."""
        dev = state.active.device
        if dev.type == "cuda":
            return self._run_captured(params, token, cache, state, remaining,
                                      active)
        t0 = time.perf_counter()
        if active is not None:
            state.active.copy_(torch.as_tensor(np.asarray(active, bool)))
        token = torch.as_tensor(np.asarray(token, np.int32)).reshape(-1, 1)
        toks, exits, confs, live, n, cache, state, rem = self.step(
            params, token, cache, state, np.asarray(remaining, np.int32))
        n = int(n)
        compiled = not self._warm
        self._warm = True
        seconds = time.perf_counter() - t0
        if compiled:
            self.compile_seconds += seconds
        return (DecodeChunk(tokens=toks[:n].numpy(), exits=exits[:n].numpy(),
                            confs=confs[:n].numpy(), live=live[:n].numpy(),
                            n_steps=n, remaining=rem.numpy().copy(),
                            seconds=seconds, compiled=compiled, t_host=t0,
                            t=int(state.t)),
                cache, state)

    # ------------------------------------------------------------------
    def _capture(self, params, cache, state: DecodeState, B: int
                 ) -> _Capture:
        """Warm, then capture one guarded iteration over these buffers."""
        dev = state.active.device
        n_m = self.cfg.cascade.n_components
        step, executor = self.step, self.executor
        snap = kernels.launch_snapshot()
        # 1. every route and branch once, eagerly, on scratch copies
        scratch = (nn.tree_map(torch.clone, cache), _scratch_state(state),
                   LoopBuffers(self.chunk, B, n_m, dev))
        scratch[2].remaining.fill_(1)
        executor.branches = WarmBranches(n_m, dev)
        try:
            step.iteration(params, torch.zeros((B, 1), dtype=torch.int32,
                                               device=dev),
                           scratch[0], scratch[1], scratch[2])
        finally:
            executor.branches = None
        torch.cuda.synchronize(dev)
        del scratch
        # 2. the capture
        out = LoopBuffers(self.chunk, B, n_m, dev)
        token = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        branches = CapturedBranches(out.bodies, out.segments, out.dispatch)
        executor.branches = branches
        try:
            with branches.capture():
                branches.run_if(step.guard(out, state), lambda: step.iteration(
                    params, token, cache, state, out))
        finally:
            executor.branches = None
            kernels.set_launch_counts(snap)
        self.captures += 1
        return _Capture(branches, out, token,
                        torch.zeros(3 * B, dtype=torch.int32, device=dev))

    def _run_captured(self, params, token, cache, state: DecodeState,
                      remaining, active):
        dev = state.active.device
        B = state.active.shape[0]
        # the executor's static δ̂ vector: written in place (outside the
        # replays) if the config's resolution changed
        ths = self.executor.thresholds(state)
        key = _key_of(*nn.tree_leaves(params), *nn.tree_leaves(cache),
                      *_state_tensors(state), ths)
        t0 = time.perf_counter()
        cap = self._graphs.get(key)
        compiled = cap is None
        if compiled:
            cap = self._graphs[key] = self._capture(params, cache, state, B)
        out = cap.out
        # the chunk's inputs in one upload: token, budgets, live mask
        up = self._host_buffer(("in", B), 3 * B)
        up[:B] = torch.as_tensor(np.asarray(token, np.int32).reshape(-1))
        up[B:2 * B] = torch.as_tensor(np.asarray(remaining, np.int32))
        if active is not None:
            up[2 * B:] = torch.as_tensor(np.asarray(active, np.int32))
        cap.staging.copy_(up, non_blocking=True)
        out.flat.zero_()
        cap.token.copy_(cap.staging[:B].view(B, 1))
        out.remaining.copy_(cap.staging[B:2 * B])
        if active is not None:
            state.active.copy_(cap.staging[2 * B:].bool())
        out.t.copy_(state.t.view(1))
        host = self._host_buffer(("out", out.flat.numel()), out.flat.numel())
        with _syncs_raise(self.sync_check):
            for _ in range(self.chunk):
                cap.branches.graph.replay()
            host.copy_(out.flat, non_blocking=True)
        # the ONE device -> host sync of the chunk
        torch.cuda.current_stream(dev).synchronize()
        self.host_syncs += 1
        seconds = time.perf_counter() - t0
        if compiled:
            self.compile_seconds += seconds
        h = out.unpack(host.numpy())
        n = int(h["n"][0])
        K = self.chunk

        def rows(name, dtype=None):
            x = h[name].view(dtype) if dtype is not None else h[name]
            return x.reshape(K, B)[:n].copy()

        state.segments_run = state.segments_run + h["segments"].astype(
            np.int32)
        for k, c in zip(DISPATCH, h["dispatch"]):
            self.executor.dispatch[k] += int(c)
        kernels.add_launch_counts(cap.branches.replayed_launches(
            h["bodies"], K))
        return (DecodeChunk(tokens=rows("tokens"), exits=rows("exits"),
                            confs=rows("confs", np.float32),
                            live=rows("live").astype(bool), n_steps=n,
                            remaining=h["remaining"].copy(), seconds=seconds,
                            compiled=compiled, t_host=t0, t=int(h["t"][0])),
                cache, state)

    def _host_buffer(self, key, n: int) -> torch.Tensor:
        """A pinned int32 host buffer, one per (role, size), reused."""
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(n, dtype=torch.int32,
                                                  pin_memory=True)
        return buf
