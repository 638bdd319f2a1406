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

A captured launch keeps the kernel launch parameters it was captured with
(``kernels/autotune.py``): with ``kernel_tune.enabled`` the constructor
installs the tuned tiles before anything is captured, and a capture key
holds the tile registry's :func:`~repro_torch.kernels.autotune.generation`,
so tiles installed after a capture make the lane capture again (counted in
:attr:`captures`; the stale graphs are dropped) — a replay never launches
stale tiles.

With ``mesh=`` (a :class:`DeviceMesh`, ``launch/mesh.py``) a lane's
first chunk computes the carry's specs by the shard rules
(``decode_loop_in_specs``: serve1d weights, the cache, the DecodeState,
token and budgets batch-sharded), checks every placed axis against the
mesh and places the params, cache and state on it as DTensors
(:attr:`DeviceDecodeLoop.placed`).  With one rank (``make_host_mesh``)
each local shard is the whole tensor, so nothing is copied and the graphs
are captured over the local tensors: every replay is the ``mesh=None``
replay, and no collective is made.

On a ``(data, model)`` mesh of more than one rank (``make_mesh``, one
process a rank, the dense and moe families) every rank runs the same loop
(SPMD): :meth:`DeviceDecodeLoop.shard_params` cuts the rank's serve1d
shards from the whole params, a lane's cache and state hold the rank's
``data`` rows (made at that size), and the step runs over them with the
mesh's :mod:`~repro_torch.parallel` active — tensor-parallel blocks,
vocab-sharded embedding and exit heads (the exit kernels' partial
contract), branch predicates and the guard agreed over the mesh, all of it
captured (the IPC all-reduce kernel).  An MoE layer holds the rank's
experts (or every expert's ``d_ff`` slice) and ends in one all-reduce over
``model``; a call whose rows are split over ``data`` ranks (a prefill, a
decode step's segment 0, a cohort split over ranks) gathers its chosen
experts over them, so that capacity and queue positions are the one-rank
run's (``models/moe.py``).  At each chunk's sync the chunk's
(K, B_local) rows, the budgets and the ``segments_run`` counts are
gathered over ``data`` through gloo on the host, and the telemetry
counters summed over it, so every rank's engine holds the whole lane.
What is not ported on more than one rank is refused by name
(:data:`MULTI_RANK_MISSING`).

On a CPU lane the same iteration runs eagerly, its guard and branches read
on the host (a device read there costs nothing and takes the same
branches).  As in the reference, requests still queued when a chunk
starts join at the next chunk boundary (the engine admits between
dispatches): the one sanctioned divergence from the host runtime.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.autotune.telemetry import sync_telemetry
from repro_torch.core.exec import DISPATCH, DecodeState, mesh_cohorts
from repro_torch.kernels import allreduce
from repro_torch.kernels import autotune as kernel_autotune
from repro_torch import parallel
from repro_torch.kernels.cond_node import CapturedBranches, WarmBranches
from repro_torch.launch.mesh import AbstractMesh, mesh_shape, mesh_size
from repro_torch.launch.shard_rules import (check_spec, decode_loop_in_specs,
                                            param_spec, place, to_local)
from repro_torch.launch.steps import LoopBuffers, make_decode_loop_step
from repro_torch.models import nn


# what serving over a mesh of more than one rank does not have yet
# (ROADMAP.md Queue 1 item 5), by what asks for it
MULTI_RANK_MISSING = {
    "paged": "the paged KV layout's block dim sharded over 'data'",
    "family": "the hybrid, ssm, audio and vlm blocks over 'model' (their "
              "shared-attention, recurrent, encoder and cross-attention "
              "collectives)",
}


def multi_rank_refusal(cfg, n: int) -> Optional[str]:
    """Why ``cfg`` cannot be served on a mesh of ``n`` > 1 ranks, or None
    (the dense and moe families on the dense layout)."""
    if cfg.paged_cache.layout == "paged":
        why = MULTI_RANK_MISSING["paged"]
    elif cfg.family not in ("dense", "moe"):
        why = MULTI_RANK_MISSING["family"]
    else:
        return None
    return (f"serving {cfg.name} ({cfg.family}) on a mesh of {n} ranks: "
            f"multi-rank execution of it is not ported ({why}); the dense "
            "and moe families serve on one")


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


# the transport's counters a captured body records: per axis, and per
# "axis/op"
_COLLECTIVE_COUNTS = ("calls", "bytes", "op_calls")


def _counts(transport) -> dict:
    """The kernels' launch counters and, on a multi-rank mesh, the
    transport's calls and bytes per axis and calls per axis and op (keys
    ``("collective", kind, key)``) in one flat dict: what a captured body
    records."""
    snap = kernels.launch_snapshot()
    if transport is not None:
        for kind in _COLLECTIVE_COUNTS:
            for a, v in getattr(transport, kind, {}).items():
                snap["collective", kind, a] = v
    return snap


def _collective_items(counts: dict):
    return [(k[1], k[2], v) for k, v in counts.items()
            if isinstance(k, tuple) and k[0] == "collective"]


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
        n = 1 if mesh is None else mesh_size(mesh)
        if isinstance(mesh, AbstractMesh):
            if n > 1:
                raise NotImplementedError(
                    f"a shape-only mesh of {n} ranks: multi-rank serving "
                    "runs on a DeviceMesh over a world of that many "
                    "processes (launch.mesh.make_mesh), not on an "
                    "AbstractMesh, which has no devices")
            raise ValueError("the decode loop places its carry on devices: "
                             "pass a DeviceMesh (make_host_mesh), not a "
                             "shape-only AbstractMesh")
        self.transport = None
        if n > 1:
            why = multi_rank_refusal(cfg, n)
            if why is not None:
                raise NotImplementedError(why)
            model_n = mesh_shape(mesh)["model"]
            if cfg.n_heads % model_n:
                raise ValueError(f"a 'model' axis of {model_n} does not "
                                 f"divide the {cfg.n_heads} attention heads")
            self.transport = parallel.transport(mesh, model.device)
        self.mesh = mesh
        self.cfg = cfg
        self.model = model
        self.chunk = int(chunk)
        self.cache_len = int(cache_len)
        # tuned kernel tiles install before anything is captured
        if cfg.kernel_tune.enabled:
            kernel_autotune.ensure_tuned(cfg, device=model.device)
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
        # the tile generation the graphs were captured at
        self._tiles_gen = kernel_autotune.generation()
        self._pinned: Dict[tuple, torch.Tensor] = {}
        self._warm = False
        # with a mesh: each lane's carry as placed on it (DTensors over the
        # lane's own tensors), by lane buffers
        self.placed: Dict[tuple, tuple] = {}
        # multi-rank: the serve1d specs of the whole params (shard_params)
        self._param_spec = None
        # multi-rank on CUDA: the transport's calls and bytes per axis that
        # the captured replays ran (each body's captured collectives times
        # its executions, as launches are counted; calls also by axis and
        # op), and the decode steps they ran
        self.replayed_collectives = {"steps": 0, "calls": {}, "bytes": {},
                                     "op_calls": {}}

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
        if self.transport is not None:
            return self._run_ranks(params, token, cache, state, remaining,
                                   active)
        return self._run_local(params, token, cache, state, remaining,
                               active)

    def _run_local(self, params, token, cache, state, remaining, active):
        dev = state.active.device
        if self.mesh is not None:
            self._place(params, token, cache, state, remaining)
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
    def shard_params(self, params):
        """This rank's serve1d shards of the whole ``params`` (every rank
        holds them alike): the tree of local tensors the engine and the
        loop run on.  One rank: ``params`` as they are."""
        if self.transport is None:
            return params
        self._param_spec = param_spec(params, self.cfg, self.mesh,
                                      mode="serve1d")
        return to_local(place(self.mesh, params, self._param_spec))

    def rows(self, batch: int) -> slice:
        """This rank's rows of a lane of ``batch`` slots (its ``data``
        block)."""
        if self.transport is None:
            return slice(0, batch)
        D, di = self.transport.size("data"), self.transport.rank("data")
        return slice(di * batch // D, (di + 1) * batch // D)

    def _run_ranks(self, params, token, cache, state: DecodeState,
                   remaining, active):
        """One chunk on a multi-rank mesh: this rank's rows of the lane's
        inputs (the engine passes the whole lane's), the chunk under the
        mesh's collectives, then its rows gathered over ``data``."""
        B = state.active.shape[0] * self.transport.size("data")
        rows = self.rows(B)
        token = np.asarray(token, np.int32).reshape(-1, 1)[rows]
        remaining = np.asarray(remaining, np.int32)[rows]
        if active is not None:
            active = np.asarray(active, bool)[rows]
        before = state.segments_run.copy()
        with parallel.activate(self.transport):
            chunk, cache, state = self._run_local(params, token, cache, state,
                                                  remaining, active)
        return self._gather_chunk(chunk, state, before), cache, state

    def _gather_chunk(self, chunk: DecodeChunk, state: DecodeState, before
                      ) -> DecodeChunk:
        """The chunk's (n, B_local) rows and budgets gathered over ``data``
        — every rank ran the same n steps (the agreed guard) — its
        ``segments_run`` counts summed over ``data`` (a cohort split over
        ``ranks_per`` ranks counted once), and the telemetry counters
        summed over it; host (gloo) collectives at the sync."""
        t = self.transport
        if state.tel is not None:
            sync_telemetry(state.tel, t)
        if t.size("data") == 1:
            return chunk
        tokens, exits, confs, live, remaining = t.gather_rows(
            chunk.tokens.astype(np.int32), chunk.exits.astype(np.int32),
            chunk.confs.astype(np.float32), chunk.live.astype(np.int32),
            chunk.remaining.astype(np.int32))
        ran = t.host_gather(torch.from_numpy(
            (state.segments_run - before).astype(np.int32)), "data")
        mc = mesh_cohorts(self.cfg.cascade.n_cohorts,
                          chunk.remaining.shape[0], t)
        state.segments_run = before + (
            ran.sum(0).numpy() // mc.ranks_per).astype(np.int32)
        return dataclasses.replace(chunk, tokens=tokens, exits=exits,
                                   confs=confs, live=live.astype(bool),
                                   remaining=remaining)

    # ------------------------------------------------------------------
    def _place(self, params, token, cache, state: DecodeState, remaining):
        """At a lane's first chunk: its carry's specs
        (:func:`~repro_torch.launch.shard_rules.decode_loop_in_specs`),
        every placed axis checked against the mesh, and the params, cache
        and state placed on it.  The mesh has one rank, so every local
        shard is the whole tensor: the placed tensors' local views are the
        lane's own (checked), and the chunk runs — and a CUDA lane
        captures — over them as with no mesh."""
        key = _key_of(*nn.tree_leaves(params), *nn.tree_leaves(cache),
                      *_state_tensors(state))
        if key in self.placed:
            return
        local = self.transport is not None
        D = self.transport.size("data") if local else 1
        B = state.active.shape[0] * D
        p_spec, t_spec, c_spec, s_spec, r_spec, _ = decode_loop_in_specs(
            params, cache, state, self.cfg, self.mesh, B)
        if local:
            # the params are the rank's shards (shard_params): their specs
            # are the whole tree's
            p_spec = self._param_spec
            glob = lambda shape: (shape[0] * D,) + tuple(shape[1:])  # noqa
        else:
            glob = tuple
        check_spec(glob(np.shape(token)), t_spec, self.mesh, "token")
        check_spec(glob(np.shape(remaining)), r_spec, self.mesh,
                   "remaining")
        placed = (place(self.mesh, params, p_spec, local=local),
                  place(self.mesh, cache, c_spec, local=local),
                  place(self.mesh, state, s_spec, local=local))
        got = (*nn.tree_leaves(placed[0]), *nn.tree_leaves(placed[1]),
               *_state_tensors(placed[2]))
        if any(g.to_local().data_ptr() != k[0] for g, k in zip(got, key)):
            raise RuntimeError("placing the decode loop's carry on the mesh "
                               "copied a leaf")
        self.placed[key] = placed

    def _capture(self, params, cache, state: DecodeState, B: int
                 ) -> _Capture:
        """Warm, then capture one guarded iteration over these buffers."""
        dev = state.active.device
        n_m = self.cfg.cascade.n_components
        step, executor = self.step, self.executor
        snap = _counts(self.transport)
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
        # the counters' reader holds the transport, not the loop: a graph
        # in a reference cycle is freed by the cyclic collector at any
        # allocation, and a graph destroyed during another's capture
        # invalidates that capture
        branches = CapturedBranches(out.bodies, out.segments, out.dispatch,
                                    functools.partial(_counts,
                                                      self.transport))
        executor.branches = branches
        try:
            with branches.capture():
                branches.run_if(step.guard(out, state), lambda: step.iteration(
                    params, token, cache, state, out))
        finally:
            executor.branches = None
            self._set_counts(snap)
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
        gen = kernel_autotune.generation()
        if gen != self._tiles_gen:
            # tiles installed since these graphs were captured: their
            # launches hold the old ones, so every lane captures again
            self._graphs.clear()
            self._tiles_gen = gen
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
        try:
            torch.cuda.current_stream(dev).synchronize()
        except RuntimeError:
            # a collective that waited past its bound trapped: say which
            allreduce.raise_if_timed_out()
            raise
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
        self._add_counts(cap.branches.replayed_launches(h["bodies"], K), n)
        return (DecodeChunk(tokens=rows("tokens"), exits=rows("exits"),
                            confs=rows("confs", np.float32),
                            live=rows("live").astype(bool), n_steps=n,
                            remaining=h["remaining"].copy(), seconds=seconds,
                            compiled=compiled, t_host=t0, t=int(h["t"][0])),
                cache, state)

    def _set_counts(self, snap: dict) -> None:
        """Put every counter of :func:`_counts` back to ``snap`` (an op a
        capture first counted goes)."""
        kernels.set_launch_counts(snap)
        for kind in _COLLECTIVE_COUNTS:
            getattr(self.transport, kind, {}).clear()
        for kind, a, v in _collective_items(snap):
            getattr(self.transport, kind)[a] = v

    def _add_counts(self, delta: dict, steps: int) -> None:
        """Add what ``steps`` decode steps' replays ran (a :func:`_counts`-
        shaped dict) to the counters and :attr:`replayed_collectives`."""
        kernels.add_launch_counts(delta)
        rep = self.replayed_collectives
        rep["steps"] += steps
        for kind, a, v in _collective_items(delta):
            for counts in (getattr(self.transport, kind),
                           rep.setdefault(kind, {})):
                counts[a] = counts.get(a, 0) + v

    def _host_buffer(self, key, n: int) -> torch.Tensor:
        """A pinned int32 host buffer, one per (role, size), reused."""
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(n, dtype=torch.int32,
                                                  pin_memory=True)
        return buf
