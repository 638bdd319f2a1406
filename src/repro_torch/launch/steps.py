"""Step builders of the serving path, the counterparts of the JAX
package's ``launch/steps.py``.

``make_prefill_step`` / ``make_serve_step``: the staged executor's prefill
and ONE decode step against a KV cache.  ``make_decode_loop_step``: the
device runtime's multi-token step — up to K staged decode steps per call,
their tokens, exit indices, confidences and live masks written into
(K, B) device buffers (the body of
:class:`repro_torch.serving.runtime.DeviceDecodeLoop`, which captures one
guarded iteration in a CUDA graph and replays it K times).
``make_decode_state``: a fresh :class:`~repro_torch.core.exec.DecodeState`.

Serve-step signature::

    serve_step(params, token, cache, state, extra=None)
        -> (prediction, exit_index, confidence, cache, state)

The dense family takes no extra inputs: ``extra`` must be None.  The
training step (``make_train_step``) comes with the training slice of the
port, and the dry-run's ``make_decode_state_struct`` /
``make_batch_structs`` with the dry-run slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.exec import (DISPATCH, DecodeState, StagedExecutor,
                                   init_decode_state)
from repro_torch.core.policy import ExitDecider

# IF bodies one captured iteration may hold (counter slots): the guard,
# per deep segment at most 3 dispatch branches and 4 per cohort (skip,
# run, and the shadow pass's observe / skip inside the skip), and the
# telemetry's shadow fold
MAX_BODIES = 256


def _no_extra(extra) -> None:
    if extra is not None:
        raise NotImplementedError(
            "extra model inputs come with the families that take them (a "
            "later slice of the port); the dense family takes none")


def make_prefill_step(model, cfg: ModelConfig):
    """Prefill step: consumes the prompt, emits the first decision AND the
    initial :class:`DecodeState` (t past the prompt, streaks seeded by the
    prefill decision) that the serve step then carries."""
    executor = StagedExecutor(model, cfg)

    def prefill_step(params, tokens, cache, extra=None):
        _no_extra(extra)
        d, cache, state = executor.prefill(params, tokens, cache)
        return d.prediction, d.exit_index, d.confidence, cache, state
    return prefill_step


def make_serve_step(model, cfg: ModelConfig):
    """Staged decode step, for every registered measure (patience streaks
    ride in ``state.policy``).  ``cfg.cascade.exit_mode`` picks ``select``
    or ``cond_batch``; the outputs are identical either way."""
    executor = StagedExecutor(model, cfg)

    def serve_step(params, token, cache, state, extra=None):
        _no_extra(extra)
        d, cache, state = executor.decode_step(params, token, cache, state)
        return d.prediction, d.exit_index, d.confidence, cache, state
    return serve_step


class LoopBuffers:
    """The decode loop's outputs and counters: views of ONE flat int32
    device tensor, so that a chunk reaches the host in one copy.

    tokens / exits / live (K, B) int32 and confs (K, B) f32 (a bit view),
    row i written by iteration i; ``n`` the iterations that ran; ``t`` the
    position after the last; ``remaining`` (B,) the token budgets; then
    ``segments`` (n_components,) segments_run, ``dispatch`` (3,) the cohort
    dispatch branches (:data:`~repro_torch.core.exec.DISPATCH` order) and
    ``bodies`` (MAX_BODIES,) the executions of each captured IF body."""

    def __init__(self, K: int, B: int, n_components: int, device):
        sizes = {"tokens": K * B, "exits": K * B, "confs": K * B,
                 "live": K * B, "n": 1, "t": 1, "remaining": B,
                 "segments": n_components, "dispatch": len(DISPATCH),
                 "bodies": MAX_BODIES}
        self.flat = torch.zeros(sum(sizes.values()), dtype=torch.int32,
                                device=device)
        at = 0
        for name, n in sizes.items():
            view = self.flat[at:at + n]
            if name in ("tokens", "exits", "confs", "live"):
                view = view.view(K, B)
            setattr(self, name, view)
            at += n
        self.confs = self.confs.view(torch.float32)
        self.layout = sizes

    def unpack(self, host) -> dict:
        """The same views over a host copy of :attr:`flat` (numpy)."""
        out, at = {}, 0
        for name, n in self.layout.items():
            out[name] = host[at:at + n]
            at += n
        return out


def make_decode_loop_step(model, cfg: ModelConfig, chunk: int,
                          cache_len: int):
    """Device-runtime multi-token decode: up to ``chunk`` staged decode
    steps per call.

    Signature::

        loop_step(params, token, cache, state, remaining)
            -> (tokens, exits, confs, live, n_steps, cache, state, remaining)

    ``token`` is the (B, 1) continuation token, ``remaining`` the (B,)
    per-slot token budget (``max_new_tokens`` minus tokens already
    generated; 0 for finished slots); ``state.active`` masks finished
    slots.  Outputs land in (chunk, B) device buffers — tokens, exit
    indices, confidences and the per-step live mask.  ``n_steps`` is how
    many iterations ran: the loop ends early once every slot has spent its
    budget or reached the cache limit (``state.active`` all False), the
    host engine's finish rule (``len(generated) >= max_new_tokens or pos >=
    cache_len - 1``), which keeps host- and device-runtime streams equal.
    The cache and ``state`` are updated in place and returned (the
    reference donates them).

    Called directly, the loop runs eagerly, its guard read on the host.
    ``loop_step.iteration(params, token, cache, state, out)`` is ONE
    iteration, everything updated in place (``token``, ``state``,
    :class:`LoopBuffers` ``out``) — what the device runtime captures under
    the guard ``out.n < chunk and any(state.active)``; and
    ``loop_step.executor`` the :class:`StagedExecutor` it steps."""
    executor = StagedExecutor(model, cfg)
    K = int(chunk)
    limit = int(cache_len) - 1

    def iteration(params, token, cache, state: DecodeState, out: LoopBuffers):
        live = state.active
        i = out.n.long()
        d, cache, st = executor.decode_step(params, token, cache, state)
        out.tokens.index_copy_(0, i, d.prediction.to(torch.int32)[None])
        out.exits.index_copy_(0, i, d.exit_index.to(torch.int32)[None])
        out.confs.index_copy_(0, i, d.confidence.float()[None])
        out.live.index_copy_(0, i, live.to(torch.int32)[None])
        out.remaining.sub_(live.to(torch.int32))
        active = live & (out.remaining > 0) & (st.t < limit)
        state.t.copy_(st.t)
        state.ema_conf.copy_(st.ema_conf)
        if state.policy is not None:
            state.policy.copy_(st.policy)
        state.active.copy_(active)
        state.segments_run = st.segments_run
        token.copy_(d.prediction.to(torch.int32)[:, None])
        out.n.add_(1)
        out.t.copy_(state.t)

    def guard(out: LoopBuffers, state: DecodeState):
        return (out.n < K) & state.active.any()

    def loop_step(params, token, cache, state: DecodeState, remaining):
        B = token.shape[0]
        out = LoopBuffers(K, B, cfg.cascade.n_components, token.device)
        out.remaining.copy_(torch.as_tensor(remaining, dtype=torch.int32))
        token = token.to(torch.int32).clone()
        while bool(guard(out, state)):
            iteration(params, token, cache, state, out)
        return (out.tokens, out.exits, out.confs, out.live.bool(), out.n[0],
                cache, state, out.remaining)

    loop_step.iteration = iteration
    loop_step.guard = guard
    loop_step.executor = executor
    return loop_step


def make_decode_state(cfg: ModelConfig, batch: int, t: int = 0,
                      device=None, mac_weights=None) -> DecodeState:
    """A fresh DecodeState for ``batch`` slots of this config.  With
    ``cfg.autotune.enabled`` it carries zeroed exit-telemetry counters and
    the config's thresholds as a live (n_components,) f32 vector on
    ``device`` (see :mod:`repro_torch.autotune`)."""
    telemetry = thresholds = None
    if cfg.autotune.enabled:
        from repro_torch.autotune.telemetry import telemetry_for
        telemetry = telemetry_for(cfg, mac_weights, device=device)
        thresholds = cfg.cascade.thresholds
    return init_decode_state(ExitDecider.from_config(cfg), batch,
                             cfg.cascade.n_components, t=t, device=device,
                             telemetry=telemetry, thresholds=thresholds)
