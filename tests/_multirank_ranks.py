"""What each rank of the multi-rank test files
(``tests/test_torch_multirank*.py``) runs, in its own process (spawned
by the test, so this module imports no JAX): it joins a world of gloo
ranks through a ``FileStore``, builds the port's mesh and serves or
trains, and puts a picklable result on a queue."""
from __future__ import annotations

import io
import traceback

import numpy as np
import torch


def _join(rank, world, sizes, init_file):
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    return make_mesh(sizes, "cpu", rank=rank, world_size=world,
                     init_file=init_file)


def run(target, rank, world, sizes, init_file, args, q):
    """``target(mesh, rank, *args)`` on a fresh mesh; its result (or the
    error) goes to ``q`` as ``(rank, result, error)``."""
    import torch.distributed as dist
    try:
        mesh = _join(rank, world, sizes, init_file)
        q.put((rank, _bytes(target(mesh, rank, *args)), None))
    except BaseException:  # noqa: BLE001 (reported to the test)
        q.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def serve_tasks(rank, tasks, results):
    """A pooled rank: runs each ``(target, sizes, store file, args)`` task
    of its queue (:func:`run`, a fresh world each) until None; imports
    torch and the port once for every mesh the tests ask for."""
    while True:
        task = tasks.get()
        if task is None:
            return
        target, sizes, init, args = task
        run(target, rank, sizes[0] * sizes[1], sizes, init, args, results)


def _bytes(result) -> bytes:
    """``result`` serialised whole (tensors included): a tensor put on a
    queue as it is would be shared through a descriptor that dies with
    this process."""
    buf = io.BytesIO()
    torch.save(result, buf)
    return buf.getvalue()


def load(raw: bytes):
    return torch.load(io.BytesIO(raw), weights_only=False)


def transport_case(mesh, rank, seed):
    """Every collective of the transport on each axis: sums and maxima of
    f32, bf16 and int32 tensors (one per rank, from ``seed``), all-gathers,
    and the predicate agreement."""
    from repro_torch import parallel
    t = parallel.transport(mesh)
    g = torch.Generator().manual_seed(seed + 100 * rank)
    out = {"coord": dict(t.coord)}
    for axis in ("data", "model", "world"):
        x32 = torch.randn(4, 64, generator=g)
        xbf = torch.randn(4, 64, generator=g).to(torch.bfloat16)
        xi = torch.randint(0, 9, (3,), generator=g, dtype=torch.int32)
        out[axis] = {
            "inputs": [x32, xbf, xi],
            "sum32": t.all_reduce(x32, axis), "sumbf": t.all_reduce(xbf, axis),
            "max32": t.all_reduce(x32, axis, "max"),
            "gather": t.all_gather(xbf, axis),
            "maxi": t.all_reduce(xi, axis, "max"),
        }
    with parallel.activate(t):
        out["agree"] = parallel.agree(torch.tensor(rank == 1)).item()
    out["calls"], out["bytes"] = dict(t.calls), dict(t.bytes)
    return out


def serve_case(mesh, rank, cfg, np_params, prompts, budget, engine_kw,
               refusals):
    """The port's engine on the device runtime over ``mesh`` (CPU lanes),
    from the reference's weights bridged here: its streams, the lanes'
    carried ``segments_run``, the merged telemetry and the transport's
    counts; with ``refusals`` also the errors of what the mesh refuses."""
    from repro_torch.autotune.telemetry import merge_telemetry
    from repro_torch.bridge import params_from_jax
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import CascadeServingEngine, Request
    params = params_from_jax(np_params, cfg, device="cpu")
    model = build_model(cfg, device="cpu")
    eng = CascadeServingEngine(cfg, model, params, runtime="device",
                               device="cpu", mesh=mesh, **engine_kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=budget))
    for _ in range(200):
        if not eng.queue and all(s.done for ln in eng.lanes
                                 for s in ln["slots"]):
            break
        eng.step()
    out = {
        "finished": {r: (f["tokens"], f["exit_depths"], f["confs"])
                     for r, f in sorted(eng.finished.items())},
        "carried": np.sum([ln["state"].segments_run for ln in eng.lanes],
                          axis=0).tolist(),
        "telemetry": (merge_telemetry(eng.lane_telemetry())
                      if cfg.autotune.enabled else None),
        "calls": dict(eng.transport.calls),
        "bytes": dict(eng.transport.bytes),
        "local_batch": int(eng.lanes[0]["state"].active.shape[0]),
        "wq_cols": int(eng.params["segments"][0][0]["attn"]["wq"].shape[-1]),
        "op_calls": dict(eng.transport.op_calls),
    }
    if cfg.n_experts:
        out["w_up"] = tuple(eng.params["segments"][0][0]["moe"]["w_up"].shape)
    if refusals:
        out["refused"] = _refusals(mesh, cfg, model, params, engine_kw)
    return out


def _refusals(mesh, cfg, model, params, engine_kw):
    """The error each unported multi-rank request raises, by name."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.serving.engine import CascadeServingEngine
    from repro_torch.serving.runtime import DeviceDecodeLoop
    out = {}
    asks = {
        "moe_paged": (reduced(get_config("mixtral-8x7b")).with_paged_cache(
            layout="paged", block_size=8), model),
        "paged": (cfg.with_paged_cache(layout="paged", block_size=8), model),
        "hybrid": (reduced(get_config("zamba2-1.2b")), model),
        "heads": (cfg.replace(n_heads=3), model),
    }
    for name, (c, m) in asks.items():
        try:
            DeviceDecodeLoop(m, c, chunk=4, mesh=mesh)
            out[name] = None
        except (NotImplementedError, ValueError) as err:
            out[name] = f"{type(err).__name__}: {err}"
    try:
        CascadeServingEngine(cfg, model, params, runtime="host",
                             device="cpu", mesh=mesh, **engine_kw)
        out["host"] = None
    except ValueError as err:
        out["host"] = f"ValueError: {err}"
    return out


# ---------------------------------------------------------------------------
# multi-rank MoE serving
# ---------------------------------------------------------------------------

class DropProbe:
    """Counts the routed pairs that capacity drops, per MoE call, inside a
    ``with`` block: wraps ``blocks.moe_apply`` (the call's real tokens:
    the rank's rows times the ranks they are split over) and
    ``moe._queue`` (its kept mask, the pad rows after the real ones left
    out).  ``calls``: (tokens, dropped) a call; ``split``: for each call
    whose rows are split over more than one rank, the transport's calls
    over that axis it made, by op."""

    def __init__(self):
        from repro_torch.models import blocks, moe
        self.blocks, self.moe = blocks, moe
        self.calls, self.split, self._tokens = [], [], None

    def __enter__(self):
        from repro_torch import parallel
        apply, queue = self.blocks.moe_apply, self.moe._queue
        self._orig = apply, queue

        def moe_apply(params, cfg, x, rows=None):
            t = parallel.active()
            R = 1 if rows is None else t.size(rows)
            self._tokens = R * x.shape[0] * x.shape[1]
            if R == 1:
                return apply(params, cfg, x, rows=rows)
            before = dict(t.op_calls)
            out = apply(params, cfg, x, rows=rows)
            self.split.append({
                k[len(rows) + 1:]: v - before.get(k, 0)
                for k, v in t.op_calls.items()
                if k.rsplit("/", 1)[0] == rows and v > before.get(k, 0)})
            return out

        def _queue(gate_idx, E, cap):
            out = queue(gate_idx, E, cap)
            kept = out[2].reshape(-1, gate_idx.shape[-1])[:self._tokens]
            self.calls.append((self._tokens, int((~kept).sum())))
            return out

        self.blocks.moe_apply, self.moe._queue = moe_apply, _queue
        return self

    def __exit__(self, *exc):
        self.blocks.moe_apply, self.moe._queue = self._orig


def moe_apply_case(mesh, rank, cfg, layer, x, group_tokens):
    """One MoE layer (``layer``: its numpy leaves) on this rank's serve1d
    shards and its ``data`` block of ``x`` (B, S, d), routed as one call
    over the data ranks, with ``GROUP_TOKENS`` at ``group_tokens``: the
    rank's output rows, its expert shard's shape and the transport's
    calls by axis and op."""
    from repro_torch import parallel
    from repro_torch.launch.shard_rules import param_spec, place, to_local
    from repro_torch.models import moe
    moe.GROUP_TOKENS = group_tokens
    t = parallel.transport(mesh)
    tree = {"moe": {k: torch.from_numpy(v) for k, v in layer.items()}}
    local = to_local(place(mesh, tree, param_spec(tree, cfg, mesh,
                                                  mode="serve1d")))["moe"]
    D, di = t.size("data"), t.rank("data")
    B = x.shape[0] // D
    xl = torch.from_numpy(x[di * B:(di + 1) * B])
    with torch.no_grad(), parallel.activate(t), DropProbe() as probe:
        out, _ = probe.blocks.moe_apply(local, cfg, xl,
                                        rows=parallel.batch_rows())
    return {"out": out, "w_up": tuple(local["w_up"].shape),
            "w_down": tuple(local["w_down"].shape),
            "router": tuple(local["router"].shape),
            "op_calls": dict(t.op_calls), "drops": probe.calls}


def moe_serve_case(mesh, rank, cfg, np_params, prompts, budget, engine_kw,
                   group_tokens):
    """:func:`serve_case` for an MoE config with ``GROUP_TOKENS`` at
    ``group_tokens``, and the pairs each MoE call dropped
    (:class:`DropProbe`), the rank's expert shard's shape and the
    transport's calls by axis and op."""
    from repro_torch.models import moe
    moe.GROUP_TOKENS = group_tokens
    with DropProbe() as probe:
        out = serve_case(mesh, rank, cfg, np_params, prompts, budget,
                         engine_kw, False)
    out["drops"], out["split"] = probe.calls, probe.split
    return out


# ---------------------------------------------------------------------------
# multi-rank training
# ---------------------------------------------------------------------------

def reduce_scatter_case(mesh, rank, seed):
    """The transport's reduce-scatter over each axis of f32 and bf16 (R,
    5, 7) tensors (one per rank, from ``seed``): inputs and results."""
    from repro_torch import parallel
    t = parallel.transport(mesh)
    g = torch.Generator().manual_seed(seed + 100 * rank)
    out = {"coord": dict(t.coord)}
    for axis in ("data", "model", "world"):
        R = t.size(axis)
        xs = [torch.randn(R, 5, 7, generator=g),
              torch.randn(R, 5, 7, generator=g).to(torch.bfloat16)]
        out[axis] = {"inputs": xs,
                     "got": [t.reduce_scatter(x, axis) for x in xs]}
    out["op_calls"] = dict(t.op_calls)
    return out


def ce_case(mesh, rank, logits, labels):
    """The vocab-parallel cross-entropy of this ``model`` rank's slice of
    ``logits`` (numpy, the whole vocab): the loss and its gradient."""
    from repro_torch import parallel
    from repro_torch.core.training import vocab_parallel_cross_entropy
    t = parallel.transport(mesh)
    M, r = t.size("model"), t.rank("model")
    V = logits.shape[-1] // M
    x = torch.from_numpy(logits[..., r * V:(r + 1) * V].copy())
    x.requires_grad_(True)
    loss = vocab_parallel_cross_entropy(x, torch.from_numpy(labels), t)
    (grad,) = torch.autograd.grad(loss, [x])
    return {"loss": loss.detach(), "grad": grad, "calls": dict(t.op_calls)}


def train_case(mesh, rank, cfg, np_params, batches, refusals=False):
    """The port's train step over ``mesh`` from the reference's weights
    bridged here (placed by ``place_on_mesh``, the AdamW state built from
    the shards): the first batch's gradients gathered whole, then one
    step per batch — the losses, the final params gathered whole, and
    this rank's final shards (for the bit-equality of replicated leaves);
    with ``refusals`` also what the mesh refuses, by name."""
    from repro_torch import parallel
    from repro_torch.bridge import params_from_jax, params_to_numpy
    from repro_torch.launch.shard_rules import gather_placed, spec_leaves
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.launch.train import place_on_mesh
    from repro_torch.models.model import build_model
    from repro_torch.models.nn import tree_leaves
    model = build_model(cfg, device="cpu")
    spec, params = place_on_mesh(
        mesh, cfg, params_from_jax(np_params, cfg, device="cpu"))
    opt = make_optimizer(cfg)
    state = opt.init(params)
    step = make_train_step(model, cfg, opt, mesh=mesh, spec=spec)
    t = parallel.transport(mesh)

    def data(i):
        x, y = batches[i]
        return {"tokens": torch.from_numpy(x), "labels": torch.from_numpy(y)}
    calls0 = dict(t.op_calls)
    loss0, grads = step.loss_and_grads(params, data(0))
    calls = {k: v - calls0.get(k, 0) for k, v in t.op_calls.items()}
    grads = params_to_numpy(gather_placed(mesh, grads, spec))
    losses = []
    for i in range(len(batches)):
        params, state, loss = step(params, state, i, data(i))
        losses.append(float(loss))
    out = {"coord": dict(t.coord), "loss0": float(loss0), "grads": grads,
           "losses": losses, "step_calls": calls,
           "whole": params_to_numpy(gather_placed(mesh, params, spec)),
           "local": [x.detach().clone() for x in tree_leaves(params)],
           "specs": [s for _, s in spec_leaves(spec)],
           "paths": ["/".join(map(str, p)) for p, _ in spec_leaves(spec)],
           "count": int(state["count"])}
    if refusals:
        out["refused"] = _train_refusals(mesh, cfg)
    return out


def _train_refusals(mesh, cfg):
    """The error each unported multi-rank training request raises."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.train import place_on_mesh
    out = {}
    for name, c in {"ssm": reduced(get_config("xlstm-350m")),
                    "hybrid": reduced(get_config("zamba2-1.2b")),
                    "heads": cfg.replace(n_heads=3)}.items():
        try:
            place_on_mesh(mesh, c, {})
            out[name] = None
        except (NotImplementedError, ValueError) as err:
            out[name] = f"{type(err).__name__}: {err}"
    return out


def moe_train_case(mesh, rank, cfg, np_params, batches, group_tokens,
                   refusals=False):
    """:func:`train_case` for an MoE config with ``GROUP_TOKENS`` at
    ``group_tokens``; with ``refusals`` also what the mesh refuses of the
    moe family (:func:`_moe_train_refusals`)."""
    from repro_torch.models import moe
    moe.GROUP_TOKENS = group_tokens
    out = train_case(mesh, rank, cfg, np_params, batches)
    if refusals:
        out["refused"] = _moe_train_refusals(mesh, cfg)
    return out


def _moe_train_refusals(mesh, cfg):
    """The errors of MoE training asks the mesh refuses: a ``model`` axis
    dividing neither the experts nor d_ff, and ``use_kernels``."""
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.launch.train import place_on_mesh
    from repro_torch.models.model import build_model
    out = {}
    asks = {
        "split": lambda: place_on_mesh(mesh, cfg.replace(n_experts=3,
                                                         d_ff=511), {}),
        "kernels": lambda: make_train_step(
            build_model(cfg, device="cpu"), cfg.replace(use_kernels=True),
            make_optimizer(cfg), mesh=mesh, spec={}),
    }
    for name, ask in asks.items():
        try:
            ask()
            out[name] = None
        except (NotImplementedError, ValueError) as err:
            out[name] = f"{type(err).__name__}: {err}"
    return out


def train_entry_case(mesh, rank, cfg, steps, batch, seq):
    """``launch.train.train`` over ``mesh`` (the model drawn from seed 0 on
    every rank): its summary and the final params gathered whole."""
    from repro_torch.bridge import params_to_numpy
    from repro_torch.launch.shard_rules import gather_placed
    from repro_torch.launch.train import train
    params, spec, summary = train(cfg, torch.device("cpu"), steps, batch,
                                  seq, mesh=mesh, log_every=steps)
    whole = params_to_numpy(gather_placed(mesh, params, spec))
    return {"summary": summary, "whole": whole}
