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

``make_optimizer`` / ``make_train_step``: the joint-loss cascade training
step (forward, backward, AdamW), with the plain ops only: a
``use_kernels`` config is refused (no kernel has a backward).  On a mesh
of more than one rank the step runs SPMD on each rank's shards of the
``default`` layout (Megatron tensor parallelism over ``model``, FSDP over
``data``), the collectives written out where the reference's GSPMD
inserts them.

``extra`` holds the modality inputs of
:func:`~repro_torch.models.model.extra_input_shapes` (the vlm family's
``image_embeds``, the audio family's ``audio_embeds``): the train and prefill steps feed them to the model,
the decode steps take them and ignore them (decode reads the cross K/V
cached at prefill); a family without such inputs refuses them.
``make_decode_state_struct`` / ``make_batch_structs``: the fake-tensor
DecodeState and training batch the dry run traces (shapes and dtypes, no
storage).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.exec import (DISPATCH, DecodeState, StagedExecutor,
                                   init_decode_state)
from repro_torch.core.policy import ExitDecider
from repro_torch.core.training import cascade_loss
from repro_torch import parallel
from repro_torch.launch.mesh import mesh_size
from repro_torch.launch.shard_rules import (axes_of, batch_spec,
                                            gather_leaf, spec_leaves)
from repro_torch.models.model import _no_extra, extra_input_shapes
from repro_torch.models.nn import tree_leaves, tree_unflatten
from repro_torch.optim import adamw
from repro_torch.optim.optimizer import Optimizer, apply_updates

# IF bodies one captured iteration may hold (counter slots): the guard,
# per deep segment at most 3 dispatch branches and 4 per cohort (skip,
# run, and the shadow pass's observe / skip inside the skip), and the
# telemetry's shadow fold
MAX_BODIES = 256


def make_optimizer(cfg: ModelConfig) -> Optimizer:
    return adamw(lr=3e-4, weight_decay=0.1)


def make_train_step(model, cfg: ModelConfig, optimizer: Optimizer,
                    mesh=None, spec=None):
    """``train_step(params, opt_state, step, batch) -> (params, opt_state,
    loss)``: the cascade loss (``cfg.cascade.loss_mode``, joint by
    default) of ``model.forward_train`` on ``batch["tokens"]`` /
    ``batch["labels"]``, its gradients and one optimizer update, applied
    to the params in place.  ``loss`` is a 0-d tensor on the device.
    ``train_step.loss_and_grads(params, batch) -> (loss, grads)`` is the
    step without the update.

    With a ``mesh`` of more than one rank (a ``launch.mesh.make_mesh``
    DeviceMesh) ``params`` and ``opt_state`` are this rank's shards under
    ``spec`` (the ``param_spec`` tree, ``default`` mode, they were placed
    by) and the batch is the global one; see :class:`_MeshStep`."""
    if cfg.use_kernels:
        raise NotImplementedError(
            "make_train_step with use_kernels: no kernel of the port (nor "
            "of the reference) has a backward, and differentiating around "
            "one would be a silent fallback; train with use_kernels off")
    spmd = (_MeshStep(model, cfg, mesh, spec)
            if mesh is not None and mesh_size(mesh) > 1 else None)

    def loss_of(params, batch, route_rows=None):
        logits, aux = model.forward_train(params, batch["tokens"],
                                          batch.get("extra"), route_rows)
        return cascade_loss(logits, batch["labels"],
                            cfg.cascade.loss_mode or "joint",
                            joint_weights=cfg.cascade.joint_weights,
                            aux=aux, aux_coef=cfg.router_aux_coef)

    def loss_and_grads(params, batch):
        if spmd is not None:
            return spmd.loss_and_grads(loss_of, params, batch)
        leaves = list(tree_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_of(params, batch)
        grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
        return loss.detach(), grads

    def train_step(params, opt_state, step, batch):
        loss, grads = loss_and_grads(params, batch)
        updates, opt_state = optimizer.update(grads, opt_state, params, step)
        params = apply_updates(params, updates)
        return params, opt_state, loss
    train_step.loss_and_grads = loss_and_grads
    return train_step


class _MeshStep:
    """One rank's share of the train step on a ``(data, model)`` mesh.

    * the batch: this ``data`` rank's rows (``batch_spec``); where the
      batch does not divide ``data`` every rank takes all of them, as the
      reference replicates.  The MoE layers route what the rank holds:
      the whole batch as one call over ``data`` where it is split
      (``route_rows="data"``: the call's groups, capacity and aux loss),
      the rank's rows alone where it holds them all;
    * FSDP leaves (a ``data`` entry in their spec) are gathered whole over
      ``data``, one after another in tree order, before the forward; the
      forward and the backward run on the whole leaf (the ``model`` shard:
      for an MoE layer's experts E/M experts, or every expert's d_ff/M);
    * the forward and the backward run tensor-parallel (the transport
      active: the layers' differentiable collectives, the MoE layers'
      expert-parallel ones, the vocab-parallel loss);
    * after ``autograd.grad`` returns (not in hooks: the IPC kernel needs
      the same sequence of calls on every rank), in tree order: an FSDP
      leaf's gradient reduce-scattered over ``data`` and divided by D,
      every other leaf's all-reduced over ``data`` and divided by D (the
      mean of the ranks' gradients); the loss likewise: the global mean.

    Every reduction is rank-ordered, so a leaf replicated over an axis
    ends each step with the same bits on every rank of it.  The backward
    runs outside the active transport, as it does on CUDA (autograd's
    device thread): what it needs, its collectives keep on their autograd
    contexts and the remat recompute re-activates."""

    def __init__(self, model, cfg, mesh, spec):
        if spec is None:
            raise ValueError("make_train_step on a multi-rank mesh needs "
                             "the spec tree the params were placed by")
        self.t = parallel.transport(mesh, model.device)
        self.cfg, self.mesh = cfg, mesh
        self.plan = []          # each leaf's FSDP dim, None without one
        for _, s in spec_leaves(spec):
            dims = [d for d, e in enumerate(s) if "data" in axes_of(e)]
            self.plan.append(dims[0] if dims else None)

    def _split(self, x) -> bool:
        """Whether a global (B, ...) batch tensor is split over ``data``."""
        return bool(batch_spec(self.cfg, self.mesh, x.shape[0], x.dim()))

    def _rows(self, x):
        """This data rank's rows of a global (B, ...) batch tensor."""
        if not self._split(x):
            return x
        n, r = x.shape[0] // self.t.size("data"), self.t.rank("data")
        return x[r * n:(r + 1) * n]

    def _scatter(self, g, dim):
        """A whole leaf's gradient reduce-scattered along ``dim``: this
        rank's block of the rank-ordered sum."""
        D = self.t.size("data")
        rows = g.unflatten(dim, (D, g.shape[dim] // D)).movedim(dim, 0)
        return self.t.reduce_scatter(rows.contiguous(), "data")

    def loss_and_grads(self, loss_of, params, batch):
        t = self.t
        D = t.size("data")
        leaves = list(tree_leaves(params))
        if len(leaves) != len(self.plan):
            raise ValueError(f"{len(leaves)} param leaves for a spec of "
                             f"{len(self.plan)}")
        whole = []
        for x, dim in zip(leaves, self.plan):
            w = x if dim is None else gather_leaf(t, x, dim, "data")
            whole.append(w.requires_grad_(True))
        local = {k: self._rows(v) for k, v in batch.items() if k != "extra"}
        if "extra" in batch:
            local["extra"] = {k: self._rows(v)
                              for k, v in batch["extra"].items()}
        rows = "data" if self._split(batch["tokens"]) else None
        with parallel.activate(t):
            loss = loss_of(tree_unflatten(params, whole), local, rows)
        grads = torch.autograd.grad(loss, whole)
        del whole
        out = []
        for g, dim in zip(grads, self.plan):
            g = (t.all_reduce(g, "data") if dim is None
                 else self._scatter(g, dim))
            out.append(g / D)
        loss = t.all_reduce(loss.detach(), "data") / D
        return loss, tree_unflatten(params, out)


def make_prefill_step(model, cfg: ModelConfig):
    """Prefill step: consumes the prompt, emits the first decision AND the
    initial :class:`DecodeState` (t past the prompt, streaks seeded by the
    prefill decision) that the serve step then carries."""
    executor = StagedExecutor(model, cfg)

    def prefill_step(params, tokens, cache, extra=None):
        d, cache, state = executor.prefill(params, tokens, cache,
                                           extra=extra)
        return d.prediction, d.exit_index, d.confidence, cache, state
    return prefill_step


def make_serve_step(model, cfg: ModelConfig):
    """Staged decode step, for every registered measure (patience streaks
    ride in ``state.policy``).  ``cfg.cascade.exit_mode`` picks ``select``
    or ``cond_batch``; the outputs are identical either way."""
    executor = StagedExecutor(model, cfg)

    def serve_step(params, token, cache, state, extra=None):
        _no_extra(cfg, extra)
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
        # on a multi-rank mesh every rank loops while any rank's slot is
        # live (the reference's guard over the whole batch)
        return (out.n < K) & parallel.agree(state.active.any())

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


def fake_mode(mode=None):
    """``mode``, else the fake-tensor mode that is active, else a new one
    (tensors of one trace must share one mode)."""
    if mode is not None:
        return mode
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    return detect_fake_mode() or FakeTensorMode(allow_non_fake_inputs=True)


def make_decode_state_struct(cfg: ModelConfig, batch: int, mode=None
                             ) -> DecodeState:
    """The DecodeState the serve step carries, its tensors fake (CPU
    shapes and dtypes, no storage): what the dry run shards and traces."""
    with fake_mode(mode):
        return make_decode_state(cfg, batch, device="cpu")


def make_batch_structs(cfg: ModelConfig, batch: int, seq: int,
                       dtype=torch.float32, mode=None) -> dict:
    """Fake stand-ins for a training batch: (B, S) int32 ``tokens`` and
    ``labels``, and the family's ``extra`` inputs in ``dtype``."""
    with fake_mode(mode):
        d = {"tokens": torch.empty((batch, seq), dtype=torch.int32),
             "labels": torch.empty((batch, seq), dtype=torch.int32)}
        extra = {k: torch.empty(v, dtype=dtype)
                 for k, v in extra_input_shapes(cfg, batch).items()}
    if extra:
        d["extra"] = extra
    return d
