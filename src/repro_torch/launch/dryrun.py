"""Dry run: trace every (architecture x input shape x mesh) step under the
production sharding, shape-only, and record the roofline's inputs.

The counterpart of the JAX package's ``launch/dryrun.py``.  The reference
lowers and compiles each step for 512 forced host devices; here the
production mesh is an :class:`~repro_torch.launch.mesh.AbstractMesh` (no
devices, no process group) and the step — ``make_train_step``,
``make_prefill_step`` or ``make_serve_step`` — runs once on fake tensors
(``FakeTensorMode``: shapes and dtypes, no storage) under
``FlopCounterMode``.  Nothing is allocated, so every full-width config
traces on a host CPU.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
        --shape decode_32k --param-mode serve1d

A record (one JSON file per combination under ``--out``) keeps the
reference's keys where their meaning holds:

* ``arch``, ``shape``, ``param_mode``, ``mesh`` (``16x16`` or
  ``2x16x16``), ``ok``, ``model_flops`` and ``n_tokens`` as the
  reference's;
* ``t_lower_s``: the time to build the fake trees and trace the step;
* ``memory.argument_size_in_bytes``: per device, the sum over the step's
  arguments (params, optimizer state, step, batch; or params, tokens,
  cache, decode state) of each leaf's local shape under its spec;
* ``flops``: per device, the traced FLOP count over the mesh size — it
  assumes the work divides evenly over the devices, which undercounts a
  device's share of replicated compute (serve2d's activations replicated
  over ``data``, a batch that does not divide the batch axes).

and renames what does not: there is no HLO, so no ``hlo_bytes``.
``bytes_accessed`` is, per device, the arguments read once plus the state
the step writes back (the cache at prefill and decode; the params and the
optimizer state in training).  ``collective_bytes`` / ``collective_counts``
(per device, by collective) are worked out from the layout, with ring
algorithms over a group of n devices (an all-reduce of S bytes moves
2(n-1)/n·S, an all-gather or reduce-scatter whose gathered buffer is S
moves (n-1)/n·S):

* all-reduce, row-parallel: each product whose contraction dim is sharded
  (ROW names, the moe ``w_down``, a vocab-sharded ``embed`` lookup)
  all-reduces its output, tokens x out x activation bytes (x top_k in a
  moe layer), over that dim's axes, once a layer; the tokens are the
  device's batch share, or all of them where the dim is sharded over
  ``data`` (serve2d).  In training each has a backward twin (megatron's
  f/g pair).
* all-reduce, vocab softmax: each exit head and ``lm_head`` whose vocab is
  sharded reduces a max and a sum of exponentials, tokens x 4 bytes each
  (the paper's δ needs both).
* all-gather, FSDP (``default`` only, whose ``data`` axis shards no
  product): each leaf with ``data`` in its spec is gathered over ``data``
  before use, once a layer (twice in training: the forward and the
  backward).
* reduce-scatter (training): the gradient of each leaf with ``data`` in
  its spec, over ``data``; the gradients of the others all-reduce over the
  batch axes, and those of FSDP leaves over ``pod`` too on the multi-pod
  mesh.
* all-to-all, expert parallel: a moe layer whose experts shard over
  ``model`` dispatches and combines tokens x top_k x d, twice a layer (four
  times in training).

Not counted: the merge of sequence-parallel attention partials (the
batch-1 long-context shape), halo exchanges of recurrent states, and any
all-gather of activations that a real partitioner would insert between
mismatched layouts.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import numpy as np
import torch

from repro_torch.configs import INPUT_SHAPES, get_config, list_configs
from repro_torch.core.macs import model_flops
from repro_torch.launch.mesh import (axis_size, batch_axes, divisible,
                                     make_production_mesh, mesh_shape,
                                     mesh_size)
from repro_torch.launch.shard_rules import (ROW, P, axes_of, leaf_name,
                                            batch_spec, cache_spec,
                                            decode_state_spec,
                                            leaves_with_path, local_shape,
                                            map_with_path, param_spec,
                                            spec_leaves)
from repro_torch.launch.steps import (make_batch_structs,
                                      make_decode_state_struct,
                                      make_optimizer, make_prefill_step,
                                      make_serve_step, make_train_step)
from repro_torch.models.model import build_model, extra_input_shapes

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# long-context window for full-attention archs (the spec's sliding-window
# carve-out); SSM archs keep their recurrent state instead.
LONG_WINDOW = 8192
SKIP = {("whisper-tiny", "long_500k"):
        "enc-dec target positions are bounded (<=448); 500k decode is "
        "architecturally meaningless for an ASR decoder (DESIGN.md)"}
HEADS = {"head", "lm_head"}


def adjust_config(cfg, shape, unroll: bool = False, exit_mode: str = "select"):
    if shape.name == "long_500k" and cfg.family not in ("ssm",):
        if cfg.attn_window == 0 or cfg.attn_window > LONG_WINDOW:
            cfg = cfg.replace(attn_window=min(cfg.attn_window or LONG_WINDOW,
                                              LONG_WINDOW))
    if shape.kind == "decode":
        # "select" is the fixed-graph roofline shape; "cond_batch" costs the
        # segment-skipping program (both carry the same DecodeState)
        cfg = cfg.with_cascade(exit_mode=exit_mode)
    if unroll:
        cfg = cfg.replace(scan_unroll=True)
    return cfg


def _pairs(tree, spec_tree):
    """(path, leaf, spec) of every tensor or array leaf of ``tree``."""
    specs = dict(spec_leaves(spec_tree))
    return [(path, x, specs[path]) for path, x in leaves_with_path(tree)]


def _nbytes(shape, dtype) -> int:
    size = (torch.empty((), dtype=dtype).element_size()
            if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize)
    return int(np.prod(shape, dtype=np.int64)) * size


def local_bytes(pairs, mesh) -> int:
    """Per-device bytes of (path, leaf, spec) triples."""
    return sum(_nbytes(local_shape(tuple(x.shape), s, mesh), x.dtype)
               for _, x, s in pairs)


def _ring(n: int, nbytes: float, all_reduce: bool) -> float:
    return (2.0 if all_reduce else 1.0) * (n - 1) / n * nbytes if n > 1 \
        else 0.0


def collectives(cfg, param_pairs, mesh, n_tokens: int, batch: int,
                training: bool, param_mode: str = "default"):
    """Per-device wire bytes and op counts of each collective the layout
    implies (the formulas of the module docstring).  In the ``default``
    layout a leaf's ``data`` axis is FSDP's: gathered before use, so it
    shards no product."""
    out = {op: 0.0 for op in COLLECTIVES}
    counts = {op: 0 for op in COLLECTIVES}
    dp = batch_axes(mesh)
    dp_sz = axis_size(mesh, dp)
    tok_dev = n_tokens // dp_sz if divisible(batch, dp_sz) else n_tokens
    act = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    data_sz = axis_size(mesh, "data")
    pod_sz = axis_size(mesh, "pod") if "pod" in mesh_shape(mesh) else 1
    passes = 2 if training else 1
    fsdp_layout = param_mode == "default"

    def add(op, n, nbytes, times):
        if n > 1 and times:
            out[op] += times * _ring(n, nbytes, op == "all-reduce")
            counts[op] += times

    def product_axes(entry):
        axes = axes_of(entry)
        return tuple(a for a in axes if a != "data") if fsdp_layout \
            else axes

    for path, x, spec in param_pairs:
        shape = tuple(x.shape)
        if len(shape) < 2:
            continue
        name = leaf_name(path)
        moe = "moe" in "/".join(map(str, path)) and name in (
            "w_up", "w_gate", "w_down")
        lead = int(np.prod(shape[:-3] if moe else shape[:-2]))
        entries = list(spec) + [None] * (len(shape) - len(spec))
        # row-parallel products: the contraction dim sharded
        axes = product_axes(entries[-2])
        if (name in ROW or name == "embed") and axes:
            toks = n_tokens if "data" in axes else tok_dev
            if moe:
                toks *= cfg.top_k
            add("all-reduce", axis_size(mesh, axes),
                toks * shape[-1] * act, passes * lead)
        # the softmax-max and sum over a sharded vocab
        axes = product_axes(entries[-1])
        if name in HEADS and axes:
            toks = n_tokens if "data" in axes else tok_dev
            add("all-reduce", axis_size(mesh, axes), toks * 4, 2 * lead)
        if moe and name == "w_down" and "model" in axes_of(entries[-3]):
            add("all-to-all", axis_size(mesh, "model"),
                tok_dev * cfg.top_k * shape[-1] * act, 2 * passes * lead)
        local = _nbytes(local_shape(shape, spec, mesh), x.dtype)
        fsdp = fsdp_layout and any("data" in axes_of(e) for e in entries)
        if fsdp:
            add("all-gather", data_sz, local * data_sz / lead, passes * lead)
        if training:
            if fsdp:
                add("reduce-scatter", data_sz, local * data_sz, 1)
                add("all-reduce", pod_sz, local, 1)
            else:
                add("all-reduce", dp_sz, local, 1)
    return ({k: int(v) for k, v in out.items()}, counts)


def lower_combo(arch: str, shape_name: str, multi_pod: bool,
                unroll: bool = False, cfg_override=None,
                param_mode: str = "default", kv_dtype=None,
                exit_mode: str = "select"):
    """Build the fake trees, trace one step, return the roofline record."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    shape = INPUT_SHAPES[shape_name]
    cfg = cfg_override or adjust_config(get_config(arch), shape, unroll,
                                        exit_mode)
    mesh = make_production_mesh(multi_pod=multi_pod)
    B, S = shape.global_batch, shape.seq_len
    rec = {"arch": arch, "shape": shape_name, "param_mode": param_mode,
           "mesh": "2x16x16" if multi_pod else "16x16", "ok": False}
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        model = build_model(cfg, device="cpu")
        params = model.init(0)
        p_pairs = _pairs(params, param_spec(params, cfg, mesh,
                                            mode=param_mode))
        args = list(p_pairs)
        flops = FlopCounterMode(display=False)
        if shape.kind == "train":
            opt = make_optimizer(cfg)
            opt_state = opt.init(params)
            o_pairs = _pairs(opt_state, param_spec(opt_state, cfg, mesh))
            batch = make_batch_structs(cfg, B, S, mode=mode)
            b_spec = map_with_path(
                lambda _, x: batch_spec(cfg, mesh, B, x.dim()), batch)
            args += o_pairs + _pairs(batch, b_spec)
            args.append(((), np.zeros((), np.int32), P()))     # step
            written = p_pairs + o_pairs
            step = make_train_step(model, cfg, opt)
            with flops:
                step(params, opt_state, 0, batch)
            n_tokens, training = B * S, True
        else:
            decode = shape.kind == "decode"
            cache = model.init_cache(B, S, dtype=kv_dtype)
            c_pairs = _pairs(cache, cache_spec(cache, cfg, mesh, B))
            tokens = torch.empty((B, 1 if decode else S), dtype=torch.int32)
            extra = {k: torch.empty(v, dtype=torch.float32)
                     for k, v in extra_input_shapes(cfg, B).items()} or None
            args += c_pairs + [((), tokens, batch_spec(cfg, mesh, B, 2))]
            if extra:
                args += _pairs(extra, map_with_path(
                    lambda _, x: batch_spec(cfg, mesh, B, x.dim()), extra))
            written = c_pairs
            if decode:
                state = make_decode_state_struct(cfg, B, mode=mode)
                args += _pairs(state, decode_state_spec(state, cfg, mesh, B))
                step = make_serve_step(model, cfg)
                with flops:
                    step(params, tokens, cache, state)
                n_tokens = B
            else:
                step = make_prefill_step(model, cfg)
                with flops:
                    step(params, tokens, cache, extra)
                n_tokens = B * S
            training = False
    rec["t_lower_s"] = round(time.perf_counter() - t0, 1)
    arg_bytes = local_bytes(args, mesh)
    rec["memory"] = {"argument_size_in_bytes": arg_bytes}
    rec["flops"] = float(flops.get_total_flops()) / mesh_size(mesh)
    rec["bytes_accessed"] = float(arg_bytes + local_bytes(written, mesh))
    coll, counts = collectives(cfg, p_pairs, mesh, n_tokens, B, training,
                               param_mode)
    rec["collective_bytes"] = coll
    rec["collective_counts"] = counts
    rec["model_flops"] = model_flops(cfg, n_tokens, training)
    rec["n_tokens"] = n_tokens
    rec["ok"] = True
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--unroll", action="store_true",
                    help="the reference's flag, kept for its record names "
                         "(the port's layers run one by one either way)")
    ap.add_argument("--param-mode", default="default",
                    choices=["default", "serve1d", "serve2d"],
                    help="parameter sharding layout (see shard_rules.py)")
    ap.add_argument("--exit-mode", default="select",
                    choices=["select", "cond_batch"],
                    help="decode execution mode: the fixed roofline graph, "
                         "or segment skipping (which reads its predicates "
                         "on the host, so it cannot trace on fake tensors "
                         "and records the error)")
    ap.add_argument("--out", default="results/torch_dryrun")
    args = ap.parse_args(argv)
    archs = ([a for a in list_configs() if a != "ci-resnet18"]
             if args.arch == "all" else [args.arch])
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    os.makedirs(args.out, exist_ok=True)
    for arch in archs:
        for shape in shapes:
            tag = (f"{arch}__{shape}__{'mp' if args.multi_pod else 'sp'}"
                   + ("_unroll" if args.unroll else "")
                   + (f"_{args.param_mode}" if args.param_mode != "default"
                      else "")
                   + (f"_{args.exit_mode}" if args.exit_mode != "select"
                      else ""))
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print("skip (exists)", tag)
                continue
            if (arch, shape) in SKIP:
                rec = {"arch": arch, "shape": shape, "ok": True,
                       "skipped": SKIP[(arch, shape)]}
            else:
                try:
                    rec = lower_combo(arch, shape, args.multi_pod,
                                      unroll=args.unroll,
                                      param_mode=args.param_mode,
                                      exit_mode=args.exit_mode)
                except Exception as e:  # a record of the failure, per combo
                    rec = {"arch": arch, "shape": shape, "ok": False,
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
            with open(path, "w") as f:
                json.dump(rec, f, indent=2)
            status = "OK" if rec.get("ok") else "FAIL"
            print(f"{status} {tag} flops={rec.get('flops', 0):.3g} "
                  f"trace={rec.get('t_lower_s', 0)}s", flush=True)


if __name__ == "__main__":
    main()
