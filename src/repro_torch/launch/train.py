"""Training launcher: the cascade's joint-loss training on the synthetic
token stream, on one card or over a ``(data, model)`` mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --smoke --steps 50 --batch 4 --seq 64 [--device cpu]

The counterpart of the JAX package's ``launch/train.py``, with its flags.
``--smoke`` trains the reduced config; without it the full config trains on
one card.  Either way the params are placed by ``param_spec`` (the default
layout) on ``make_host_mesh(device)``, a 1x1 mesh: every local shard is the
whole tensor, nothing is copied, and the step runs on the local tensors.
``--multi-pod`` asks for the reference's production mesh (2 x 16 x 16),
which needs a world of 512 ranks: without one it is refused with that size
named; with one, its ``pod`` axis is refused by name (the port's meshes
are ``(data, model)``).  Runs on CUDA unless ``--device cpu``.  Weights are
drawn from ``model.init(0)``; batches come from ``SyntheticLMStream`` (seed
0); the step is ``make_train_step`` with ``make_optimizer``'s AdamW.
``--ckpt-dir`` saves the final params as ``step_<steps>.npz`` (on a mesh of
more than one rank gathered whole and written by rank 0).  The last line
of standard output is one JSON object: the losses, each step's wall time
in ms (synced by reading its loss), the peak device memory, the params
count, and — with a checkpoint — its path and the params'
``tree_digest``.  As the reference does, it fails on a non-finite loss
and, at 6 steps or more, on a loss that does not trend down.

:func:`train` also takes a multi-rank mesh (``launch.mesh.make_mesh``):
each rank process calls it with the same arguments, every rank draws the
same whole params, cuts its shards (Megatron over ``model`` — for the moe
family E/M experts a rank, or every expert's d_ff/M where ``model`` does
not divide E —, FSDP over ``data``), frees the whole tensors and builds
the AdamW state of its shards; the step runs SPMD (``launch/steps.py``).
The dense and moe families (:data:`MULTI_RANK_TRAIN_MISSING`).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.ckpt import save_checkpoint, tree_digest
from repro_torch.configs import get_config, reduced
from repro_torch.data.lm_pipeline import SyntheticLMStream
from repro_torch.launch.mesh import (HOST_AXES, AbstractMesh, make_host_mesh,
                                     mesh_shape, mesh_size,
                                     production_device_mesh)
from repro_torch.launch.shard_rules import (gather_placed, param_spec, place,
                                            to_local)
from repro_torch.launch.steps import make_optimizer, make_train_step
from repro_torch.models.model import build_model
from repro_torch.utils import get_logger, resolve_device, tree_size

log = get_logger("train")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="Train the cascade (joint exit loss, AdamW) on the "
                    "synthetic token stream.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (2 layers, d_model 256, f32)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the "
                         "CPU)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--multi-pod", action="store_true",
                    help="the production mesh (2 x 16 x 16): needs a world "
                         "of 512 ranks")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--log-every", type=int, default=5)
    return ap


# what training over a mesh of more than one rank does not have yet
# (ROADMAP.md Queue 1 item 5), by what asks for it
MULTI_RANK_TRAIN_MISSING = {
    "family": "the hybrid, ssm, audio and vlm blocks over 'model' (their "
              "shared-attention, recurrent, encoder and cross-attention "
              "collectives and their backward)",
}


def check_train_mesh(cfg, mesh) -> None:
    """Raise unless ``cfg`` can train on ``mesh``: on a mesh of more than
    one rank NotImplementedError names what is not ported (a shape-only
    mesh, a mesh with other axes than ``(data, model)``, a family other
    than dense and moe) and ValueError a ``model`` axis that does not
    divide the tensor-parallel dims (the shard rules would replicate such
    a dim, and the layers' partial sums would then count it M times).  An
    MoE layer's cut dim is E where ``model`` divides it, else d_ff (the
    shard rules' fallback)."""
    n = mesh_size(mesh)
    if n == 1:
        return
    if isinstance(mesh, AbstractMesh):
        raise NotImplementedError(
            f"a shape-only mesh of {n} ranks: multi-rank training runs on a "
            "DeviceMesh over a world of that many processes (launch.mesh."
            "make_mesh), not on an AbstractMesh, which has no devices")
    names = tuple(mesh_shape(mesh))
    if names != HOST_AXES:
        raise NotImplementedError(
            f"a mesh with axes {names} of {n} ranks: multi-rank training "
            f"runs on a {HOST_AXES} mesh (launch.mesh.make_mesh)")
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"training {cfg.name} ({cfg.family}) on a mesh of {n} ranks: "
            "multi-rank execution of it is not ported "
            f"({MULTI_RANK_TRAIN_MISSING['family']}); the dense and moe "
            "families train on one")
    M = mesh_shape(mesh)["model"]
    dims = {"attention heads": cfg.n_heads,
            "K/V columns": cfg.n_kv_heads * cfg.resolved_head_dim,
            "vocabulary entries": cfg.vocab_size}
    bad = [f"{v} {k}" for k, v in dims.items() if v % M]
    if not cfg.n_experts:
        bad += [f"{cfg.d_ff} MLP columns"] if cfg.d_ff % M else []
    elif cfg.n_experts % M and cfg.d_ff % M:
        bad.append(f"{cfg.n_experts} experts nor their {cfg.d_ff} MLP "
                   "columns")
    if bad:
        raise ValueError(f"a 'model' axis of {M} does not divide the "
                         f"{', '.join(bad)} of {cfg.name}")


def place_on_mesh(mesh, cfg, params):
    """``(spec, local)``: the ``param_spec`` tree of ``params`` (the
    default layout) and this rank's shards of them under it (placed by
    :func:`~repro_torch.launch.shard_rules.place`, as local tensors),
    which the step runs on (the optimizer state is built from them).
    What :func:`check_train_mesh` refuses is refused."""
    check_train_mesh(cfg, mesh)
    spec = param_spec(params, cfg, mesh)
    return spec, to_local(place(mesh, params, spec))


def train(cfg, device, steps: int, batch: int, seq: int, mesh=None,
          log_every: int = 5):
    """``steps`` joint-loss AdamW steps of a seed-0 model of ``cfg`` on
    ``SyntheticLMStream`` (seed 0), its params placed on ``mesh`` when one
    is given and the AdamW state built from the placed shards.  On a mesh
    of more than one rank every rank calls this alike: the batch is the
    global one, the losses are the global mean, and the params returned
    are this rank's shards (``gather_placed`` with the spec tree they were
    placed by brings them back whole).  Returns (params, spec, summary):
    the spec None without a mesh."""
    model = build_model(cfg, device=device)
    if mesh is not None:
        check_train_mesh(cfg, mesh)           # before the draw
    params = model.init(0)
    n_params = tree_size(params)
    log.info("arch=%s params=%s device=%s mesh=%s", cfg.name,
             f"{n_params:,}", device, mesh)
    spec = None
    if mesh is not None:
        # the whole tensors go with this rebinding (the shards are copies
        # on a mesh of more than one rank)
        spec, params = place_on_mesh(mesh, cfg, params)
    opt = make_optimizer(cfg)
    opt_state = opt.init(params)
    step_fn = make_train_step(model, cfg, opt, mesh=mesh, spec=spec)
    if mesh is not None and mesh_size(mesh) > 1:
        # every rank is at its first step before any launches a collective
        # (the kernel's wait bound then covers step work only)
        dist.barrier()

    stream = SyntheticLMStream(cfg.vocab_size, seq, batch)
    losses, step_ms = [], []
    t0 = time.perf_counter()
    for step, (toks, labels) in zip(range(steps), stream):
        data = {"tokens": torch.from_numpy(toks).to(device),
                "labels": torch.from_numpy(labels).to(device)}
        ts = time.perf_counter()
        params, opt_state, loss = step_fn(params, opt_state, step, data)
        losses.append(float(loss))
        step_ms.append(1e3 * (time.perf_counter() - ts))
        if step % log_every == 0:
            log.info("step %d loss %.4f (%.1f ms)", step, losses[-1],
                     step_ms[-1])
    dt = time.perf_counter() - t0
    log.info("done: %d steps in %.1fs; loss %.4f -> %.4f", steps, dt,
             losses[0], losses[-1])
    return params, spec, {
        "arch": cfg.name, "device": str(device), "params": n_params,
        "steps": steps, "batch": batch, "seq": seq, "seconds": dt,
        "losses": losses, "step_ms": step_ms,
        "mesh": None if mesh is None else mesh_shape(mesh),
        "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None)}


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.multi_pod:
        try:
            mesh = production_device_mesh(device, multi_pod=True)
        except RuntimeError as err:
            raise SystemExit(f"--multi-pod: {err}") from err
    made = not dist.is_initialized()
    if not args.multi_pod:
        mesh = make_host_mesh(device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    try:
        params, spec, summary = train(cfg, device, args.steps, args.batch,
                                      args.seq, mesh=mesh,
                                      log_every=args.log_every)
        if args.ckpt_dir and mesh_size(mesh) > 1:
            params = gather_placed(mesh, params, spec)
        writer = not dist.is_initialized() or dist.get_rank() == 0
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()
    summary["smoke"] = args.smoke
    losses = summary["losses"]
    if args.ckpt_dir and writer:
        summary["checkpoint"] = save_checkpoint(args.ckpt_dir, args.steps,
                                                params)
        summary["params_digest"] = tree_digest(params)
        log.info("checkpoint: %s", summary["checkpoint"])
    print(json.dumps(summary), flush=True)
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite loss")
    if args.steps >= 6:  # trend check (per-batch noise dominates tiny runs)
        k = max(2, args.steps // 3)
        if not np.mean(losses[-k:]) < np.mean(losses[:k]):
            raise AssertionError("loss did not trend down")


if __name__ == "__main__":
    main()
