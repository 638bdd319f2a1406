"""Name-based sharding rules: parameter / optimizer / cache / batch /
decode-state trees -> partition-spec trees for a device mesh.

The counterpart of the JAX package's ``launch/shard_rules.py``, rule for
rule.  Tensor-parallel layout (megatron-style): column-parallel
projections shard their output dim over ``model``; row-parallel ones shard
their input dim (the product then needs an all-reduce of its output).  MoE
experts shard the expert dim when divisible (expert parallelism), else fall
back to tensor parallelism inside each expert.  Vocab-sharded embedding and
unembedding when the vocab divides the axis.  The batch dim shards over
(pod, data); the batch-1 long-context shape shards the KV-cache *sequence*
dim over data instead (sequence-parallel decode).  Every divisibility
decision funnels through ``_axis_if``, so a config change can never give an
invalid sharding: it degrades to replication.

A spec is a :class:`P`: one entry per tensor dim, each None, an axis name
or a tuple of names (1-tuples canonicalised to the bare name, as
``_spec`` does in the reference).  The rules read leaves' shapes only, so
they take trees of real tensors, fake tensors (the dry run) or numpy
arrays, keyed by :func:`repro_torch.utils.tree_flatten_with_path` paths
(dict keys and list indices); the spec tree has the tree's structure.
:func:`to_shardings` turns a spec into DTensor placements, one per mesh
dim; :func:`place` puts a tree on a :class:`DeviceMesh` and
:func:`gather_placed` brings a placed tree back to whole tensors.

Combined axes.  ``serve2d`` shards one dim over ``("model", "data")``,
which the reference lays out model-major (the block a device holds is
indexed by its model coordinate first).  DTensor shards a tensor dim held
by two mesh dims in mesh-dim order, ``data`` first: data-major.  The local
shapes agree either way (so the dry run's bytes and FLOPs do), and at
world size 1 nothing differs; which rank holds which block does.
Multi-rank execution has to settle that order (see ROADMAP.md); the mesh
is not reordered here to hide it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.launch.mesh import (axis_size, batch_axes, divisible,
                                     mesh_shape, mesh_size)
from repro_torch.utils import path_str

COLUMN = {"wq", "wk", "wv", "w_up", "w_gate", "up_proj", "w_in", "in_proj",
          "head", "lm_head", "enh_w1"}
ROW = {"wo", "w_down", "down_proj", "out_proj", "w_dn", "enh_w2"}


class P(tuple):
    """A partition spec: ``P("model", None)`` shards dim 0 over ``model``
    and replicates dim 1; ``P()`` replicates every dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def __reduce__(self):
        # entries as arguments: tuple's own pickling would pass them as one
        return (P, tuple(self))


def _shape(leaf):
    return tuple(int(s) for s in getattr(leaf, "shape", np.shape(leaf)))


def leaf_name(path) -> Optional[str]:
    """The last string key of a path (the leaf's name)."""
    for part in reversed(path):
        if isinstance(part, str):
            return part
    return None


def _is_spec(x) -> bool:
    return isinstance(x, P)


def map_with_path(fn, tree, is_leaf=None, path=()):
    """``fn(path, leaf)`` over nested dicts, lists, tuples and dataclasses
    (a DecodeState's fields by name), structure kept; None stays None.
    ``is_leaf`` stops the descent (a spec tree's :class:`P`)."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: map_with_path(fn, getattr(tree, f.name), is_leaf,
                                  path + (f.name,))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, is_leaf, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, is_leaf, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def leaves_with_path(tree, is_leaf=None, path=()):
    """``(path, leaf)`` of every leaf :func:`map_with_path` visits, in
    order."""
    out = []
    map_with_path(lambda p, x: out.append((p, x)), tree, is_leaf, path)
    return out


def _axis_if(dim: int, mesh, axis: str) -> Optional[str]:
    return axis if divisible(dim, axis_size(mesh, axis)) else None


def _spec(ndim: int, **placed) -> P:
    """A spec placing axes at (possibly negative) dims."""
    entries = [None] * ndim
    for pos, ax in placed.items():
        if ax is not None:
            if isinstance(ax, tuple) and len(ax) == 1:
                ax = ax[0]
            entries[int(pos)] = ax
    return P(*entries)


def _add_fsdp(spec: P, shape, mesh) -> P:
    """ZeRO/FSDP: additionally shard the first free divisible dim over
    'data' (optimizer state takes the same spec, so it stays fully
    sharded)."""
    dsz = axis_size(mesh, "data")
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, (dim, cur) in enumerate(zip(shape, entries)):
        if cur is None and divisible(dim, dsz):
            entries[i] = "data"
            return P(*entries)
    return spec


def param_spec(params, cfg, mesh, fsdp: bool = True, mode: str = "default"):
    """Spec tree matching a CascadeModel (or optimizer) tree.

    mode="default": megatron TP over 'model' + ZeRO/FSDP 'data' placement
    on the first free divisible dim (the training layout).

    mode="serve2d": decode layout — weights shard over the COMBINED
    ('model', 'data') axes on their TP dim, so no weight is ever gathered;
    the row-parallel all-reduce moves to the (one-token) activations.

    mode="serve1d": prefill layout — megatron TP over 'model', weights
    replicated over 'data' (no FSDP: inference has no optimizer state).
    """
    combined = ("model", "data")
    comb_sz = axis_size(mesh, combined)

    def rule(path, leaf):
        shape = _shape(leaf)
        ndim = len(shape)
        name = leaf_name(path)
        if name is None or ndim == 0:
            return P()
        p = path_str(path)
        if name == "embed":
            spec = _spec(ndim, **{str(ndim - 2): _axis_if(shape[-2], mesh,
                                                          "model")})
        elif name == "pos_embed":
            spec = P()
        elif "moe" in p and name in ("w_up", "w_gate", "w_down"):
            E = shape[-3]
            ff_dim = ndim - 1 if name != "w_down" else ndim - 2
            if divisible(E, axis_size(mesh, "model")):
                if (mode == "serve2d"
                        and divisible(shape[ff_dim], axis_size(mesh, "data"))):
                    # expert-parallel over model + intra-expert ff over
                    # data: fully sharded, no weight gathers
                    return _spec(ndim, **{str(ndim - 3): "model",
                                          str(ff_dim): "data"})
                spec = _spec(ndim, **{str(ndim - 3): "model"})
            else:
                if mode == "serve2d" and divisible(shape[ff_dim], comb_sz):
                    return _spec(ndim, **{str(ff_dim): combined})
                spec = _spec(ndim, **{str(ff_dim): _axis_if(
                    shape[ff_dim], mesh, "model")})
        elif name in COLUMN and ndim >= 2:
            if mode == "serve2d" and divisible(shape[-1], comb_sz):
                return _spec(ndim, **{str(ndim - 1): combined})
            spec = _spec(ndim, **{str(ndim - 1): _axis_if(shape[-1], mesh,
                                                          "model")})
        elif name in ROW and ndim >= 2:
            if mode == "serve2d" and divisible(shape[-2], comb_sz):
                return _spec(ndim, **{str(ndim - 2): combined})
            spec = _spec(ndim, **{str(ndim - 2): _axis_if(shape[-2], mesh,
                                                          "model")})
        else:
            spec = P()
        # serve modes never place 'data' on a dim they cannot fully own
        if fsdp and mode not in ("serve2d", "serve1d") and ndim >= 2:
            spec = _add_fsdp(spec, shape, mesh)
        return spec
    return map_with_path(rule, params)


def cache_spec(cache, cfg, mesh, batch: int):
    """KV / state cache sharding.  batch > 1: shard batch over (pod,
    data); batch == 1 (long context): shard the KV sequence dim over (pod,
    data), sequence-parallel decode, and replicate recurrent states.

    Paged layout (detected from the per-slot ``(B, W)`` kpos ring): the
    shared k/v block stores ``(L, num_blocks, bs, kv, hd)`` have no batch
    dim, so the physical block dim shards over (pod, data) instead, and the
    kpos ring batch-shards like any per-slot leaf."""
    dp = batch_axes(mesh)
    dp_sz = axis_size(mesh, dp)
    batch_ok = divisible(batch, dp_sz)
    dp_ax = dp if batch_ok else None
    paged = (isinstance(cache, dict) and cache.get("kpos") is not None
             and len(_shape(cache["kpos"])) == 2)

    def rule(path, leaf):
        shape = _shape(leaf)
        ndim = len(shape)
        name = leaf_name(path)
        if name == "kpos":
            if paged and ndim == 2:                # per-slot (B, W) ring
                return _spec(ndim, **{"0": dp_ax})
            return P()
        if ndim <= 1:
            return P()
        if name in ("k", "v") and ndim == 5:
            if paged:                              # (L, NB, bs, kv, hd)
                return _spec(ndim, **{"1": dp if divisible(shape[1], dp_sz)
                                      else None})
            if batch_ok:                           # (L, B, W, kv, hd)
                return _spec(ndim, **{"1": dp_ax})
            # sequence-parallel: shard the slot dim
            return _spec(ndim, **{"2": dp if divisible(shape[2], dp_sz)
                                  else None})
        if name == "conv" and ndim == 4:           # (L, B, W-1, ch)
            return _spec(ndim, **{"1": dp_ax})
        if name == "state" and ndim == 5:          # ssm (L, B, h, p, n)
            return _spec(ndim, **{"1": dp_ax})
        if name == "C" and ndim == 5:              # mlstm (L, B, h, p, p)
            return _spec(ndim, **{"1": dp_ax})
        if name == "n" and ndim == 4:              # mlstm (L, B, h, p)
            return _spec(ndim, **{"1": dp_ax})
        if name == "m" and ndim == 3:              # mlstm (L, B, h)
            return _spec(ndim, **{"1": dp_ax})
        if name in ("c", "n", "m", "h") and ndim == 3:  # slstm (L, B, d)
            return _spec(ndim, **{"1": dp_ax})
        return P()
    return map_with_path(rule, cache)


def decode_state_spec(state, cfg, mesh, batch: int):
    """Specs of the serve step's carried DecodeState: a DecodeState (its
    ``tel`` an ExitTelemetry) whose fields are specs, None where the
    state's field is None.

    Per-sequence leaves (``active``, ``ema_conf``: (B,); the stateful
    measure carry ``policy`` and the paged ``block_tables``: (n_components,
    B, ...)) shard their batch dim over (pod, data); the cursor ``t``, the
    host-side ``segments_run``, the live ``thresholds`` and every telemetry
    counter replicate (global accumulators).  Divisibility degrades to
    replication."""
    dp = batch_axes(mesh)
    dp_ax = dp if divisible(batch, axis_size(mesh, dp)) else None

    def rule(path, leaf):
        ndim = len(_shape(leaf))
        name = path[-1]
        if ndim == 0 or name in ("t", "segments_run"):
            return P()
        if name in ("active", "ema_conf"):
            return _spec(ndim, **{"0": dp_ax})
        if name in ("policy", "block_tables"):
            return _spec(ndim, **{"1": dp_ax})
        return P()
    return map_with_path(rule, state)


def decode_loop_in_specs(params, cache, state, cfg, mesh, batch: int):
    """Specs of ``launch.steps.make_decode_loop_step``'s ``(params, token,
    cache, state, remaining, extra)``: weights by :func:`param_spec`
    (serve1d), the cache by :func:`cache_spec`, the DecodeState by
    :func:`decode_state_spec`, and the (B, 1) token / (B,) remaining
    budgets batch-sharded like any token batch; ``extra`` None."""
    return (param_spec(params, cfg, mesh, mode="serve1d"),
            batch_spec(cfg, mesh, batch, 2),
            cache_spec(cache, cfg, mesh, batch),
            decode_state_spec(state, cfg, mesh, batch),
            batch_spec(cfg, mesh, batch, 1),
            None)


def batch_spec(cfg, mesh, batch: int, ndim: int) -> P:
    dp = batch_axes(mesh)
    if divisible(batch, axis_size(mesh, dp)):
        return _spec(ndim, **{"0": dp})
    return P()


def spec_leaves(spec_tree):
    """``(path, spec)`` of every spec of a spec tree, in order."""
    return leaves_with_path(spec_tree, _is_spec)


def axes_of(entry):
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def local_shape(shape, spec: P, mesh):
    """The shape one device holds of a ``shape`` leaf under ``spec``."""
    out = list(shape)
    for d, entry in enumerate(spec):
        out[d] //= axis_size(mesh, axes_of(entry))
    return tuple(out)


def check_spec(shape, spec: P, mesh, where: str = "") -> None:
    """Every placed axis is an axis of ``mesh``, placed once, and divides
    its dim; the spec has at most one entry per dim."""
    names = mesh_shape(mesh)
    if len(spec) > len(shape):
        raise ValueError(f"{where}: spec {spec} for a rank-{len(shape)} "
                         f"leaf")
    seen = set()
    for dim, entry in zip(shape, spec):
        for ax in axes_of(entry):
            if ax not in names:
                raise ValueError(f"{where}: axis {ax!r} of {spec} is not an "
                                 f"axis of the mesh {names}")
            if ax in seen:
                raise ValueError(f"{where}: axis {ax!r} placed twice in "
                                 f"{spec}")
            seen.add(ax)
        if not divisible(dim, axis_size(mesh, axes_of(entry))):
            raise ValueError(f"{where}: {entry!r} does not divide dim {dim} "
                             f"of shape {shape} ({spec})")


def placements(mesh, spec: P):
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` if tensor dim d holds its axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh_shape(mesh):
        dims = [d for d, e in enumerate(spec) if name in axes_of(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def to_shardings(mesh, spec_tree):
    """The placements of every spec of ``spec_tree``, structure kept."""
    return map_with_path(lambda _, s: placements(mesh, s), spec_tree,
                         _is_spec)


def local_slices(mesh, spec: P, shape):
    """The index of this rank's shard of a ``shape`` leaf under ``spec``:
    one slice per dim, each placed dim cut into equal blocks by the
    rank's coordinate on the placed axes (the first axis of a combined
    entry the slowest, as :func:`placements` orders them)."""
    import torch.distributed as dist
    names = list(mesh_shape(mesh))
    coord = dict(zip(names, mesh.get_coordinate())) if dist.is_initialized() \
        else dict.fromkeys(names, 0)
    out = []
    for d, dim in enumerate(shape):
        axes = [a for a in names if d < len(spec) and a in axes_of(spec[d])]
        if not axes:
            out.append(slice(None))
            continue
        idx, n = 0, 1
        for a in axes:
            idx = idx * axis_size(mesh, a) + coord[a]
            n *= axis_size(mesh, a)
        blk = dim // n
        out.append(slice(idx * blk, (idx + 1) * blk))
    return tuple(out)


def place(mesh, tree, spec_tree, local: bool = False):
    """``tree``'s tensors as DTensors on ``mesh`` under ``spec_tree`` (same
    structure; other leaves, such as a DecodeState's host-side numpy
    ``segments_run``, kept as they are).  Each spec is checked against the
    mesh first.  On a mesh of one device every local shard is the whole
    tensor and the DTensor wraps the leaf itself: nothing is copied.

    On a larger mesh each rank cuts its own shard from the whole tensor,
    which every rank holds alike (drawn from one seed, or bridged from one
    numpy tree), and wraps it with ``DTensor.from_local``: no collective
    (``distribute_tensor`` would scatter over a CUDA process group, which
    ranks sharing one card cannot have).  With ``local`` the tree already
    holds this rank's shards (a lane's caches and state, made at their
    local size): they are wrapped as they are, the spec checked against
    the global shape they stand for."""
    import torch
    from torch.distributed.tensor import DTensor
    one = mesh_size(mesh) == 1
    specs = dict(spec_leaves(spec_tree))

    def leaf(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        spec = specs[path]
        shape = tuple(x.shape)
        if local and not one:
            shape = tuple(
                n * (axis_size(mesh, axes_of(spec[d])) if d < len(spec)
                     else 1) for d, n in enumerate(shape))
        check_spec(shape, spec, mesh, path_str(path))
        pl = placements(mesh, spec)
        if not (one or local):
            x = x[local_slices(mesh, spec, shape)].contiguous()
        return DTensor.from_local(x, mesh, pl, run_check=False)
    return map_with_path(leaf, tree)


def to_local(tree):
    """``tree`` with each DTensor replaced by its local tensor (the
    device's shard), structure kept; other leaves as they are."""
    from torch.distributed.tensor import DTensor
    return map_with_path(
        lambda _, x: x.to_local() if isinstance(x, DTensor) else x, tree)


def gather_placed(mesh, tree, spec_tree):
    """``tree``'s shards under ``spec_tree`` (DTensors, or this rank's local
    tensors) gathered back to whole tensors over the mesh's transport
    (:mod:`repro_torch.parallel`), leaf after leaf in tree order: the
    counterpart of ``np.asarray`` on a sharded ``jax.Array``.  Every rank
    of the mesh must call it together; each ends with the whole tree.  On
    a mesh of one rank the local tensors are returned as they are."""
    import torch
    from repro_torch.parallel import transport
    tree = to_local(tree)
    if mesh_size(mesh) == 1:
        return tree
    t = transport(mesh)
    specs = dict(spec_leaves(spec_tree))

    def leaf(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        for d, entry in enumerate(specs[path]):
            axes = axes_of(entry)
            if len(axes) > 1:
                raise NotImplementedError(
                    f"gather_placed: {path_str(path)} is sharded over the "
                    f"combined axes {axes} (serve2d), whose order across "
                    "ranks is not settled (ROADMAP.md)")
            if axes:
                x = gather_leaf(t, x, d, axes[0])
        return x
    return map_with_path(leaf, tree)


def gather_leaf(t, x, dim: int, axis: str):
    """One leaf's shards over ``axis`` gathered whole along ``dim`` in rank
    order through the transport ``t``."""
    g = t.all_gather(x.contiguous(), axis)               # (R, *x.shape)
    return g.movedim(0, dim).flatten(dim, dim + 1)
