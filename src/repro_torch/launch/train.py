"""Training launcher: the cascade's joint-loss training on the synthetic
token stream, on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --smoke --steps 50 --batch 4 --seq 64 [--device cpu]

The counterpart of the JAX package's ``launch/train.py``, with its flags.
``--smoke`` trains the reduced config; without it the full config trains on
one card.  Either way the params and the AdamW state are placed by
``param_spec`` (the default layout) on ``make_host_mesh(device)``, a 1x1
mesh: every local shard is the whole tensor, nothing is copied, and the
step runs on the local tensors.  ``--multi-pod`` asks for the reference's
production mesh (2 x 16 x 16), which needs a world of 512 ranks: without
one it is refused with that size named; with one, multi-rank execution is
not ported and is refused too (ROADMAP.md).  Runs on CUDA unless
``--device cpu``.  Weights are drawn from ``model.init(0)``; batches come
from ``SyntheticLMStream`` (seed 0); the step is ``make_train_step`` with
``make_optimizer``'s AdamW.  ``--ckpt-dir`` saves the final params as
``step_<steps>.npz``.  The last line of standard output is one JSON
object: the losses, each step's wall time in ms (synced by reading its
loss), the peak device memory, the params count, and — with a checkpoint —
its path and the params' ``tree_digest``.  As the reference does, it fails
on a non-finite loss and, at 6 steps or more, on a loss that does not
trend down.
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
from repro_torch.launch.mesh import (make_host_mesh, mesh_shape, mesh_size,
                                     production_device_mesh)
from repro_torch.launch.shard_rules import param_spec, place, to_local
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


def place_on_mesh(mesh, cfg, params, opt_state):
    """Params and optimizer state placed by ``param_spec`` on ``mesh``
    (DTensors; see :func:`~repro_torch.launch.shard_rules.place`) and the
    trees of their local tensors, which the step runs on.  A mesh of more
    than one rank is refused: the step would need its collectives."""
    if mesh_size(mesh) > 1:
        raise NotImplementedError(
            f"training on a mesh of {mesh_size(mesh)} ranks: multi-rank "
            "execution of the train step is not ported (the row-parallel "
            "backward, the gradients' reduce-scatter or all-reduce); "
            "serving runs on one (launch.mesh.make_mesh)")
    placed = (place(mesh, params, param_spec(params, cfg, mesh)),
              place(mesh, opt_state, param_spec(opt_state, cfg, mesh)))
    return placed, to_local(placed)


def train(cfg, device, steps: int, batch: int, seq: int, mesh=None,
          log_every: int = 5):
    """``steps`` joint-loss AdamW steps of a seed-0 model of ``cfg`` on
    ``SyntheticLMStream`` (seed 0), its params and optimizer state placed
    on ``mesh`` when one is given.  Returns (params, summary)."""
    model = build_model(cfg, device=device)
    params = model.init(0)
    n_params = tree_size(params)
    log.info("arch=%s params=%s device=%s mesh=%s", cfg.name,
             f"{n_params:,}", device, mesh)
    opt = make_optimizer(cfg)
    opt_state = opt.init(params)
    if mesh is not None:
        _, (params, opt_state) = place_on_mesh(mesh, cfg, params, opt_state)
    step_fn = make_train_step(model, cfg, opt)

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
    return params, {
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
        params, summary = train(cfg, device, args.steps, args.batch,
                                args.seq, mesh=mesh,
                                log_every=args.log_every)
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()
    summary["smoke"] = args.smoke
    losses = summary["losses"]
    if args.ckpt_dir:
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
