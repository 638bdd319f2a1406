"""Fused exit-update kernel and its plain version.

Replaces the TPU kernel ``_exit_update_kernel`` / ``exit_update`` of the
JAX package's ``kernels/exit_update.py`` (its ``pallas_call`` at line 206):
softmax-max confidence + threshold gate + patience rewrite + first-open-gate
carry merge (+ optional EMA fold and telemetry code) in one pass over the
(B, V) exit logits, the softmax never materialised.

Route: CUDA C++ (``csrc/exit_update.cu``), not Triton.  The argmax has to
return the first index of the row maximum exactly as the reference does;
in CUDA the (max, sum-exp, first-index) merge is written out, so the tie
rule is explicit rather than a property of a library reduction.  It also
keeps the port on one build route, and a ctypes launch is cheaper on the
host than a Triton launch on this per-token, per-component path.

Bound on the H100: bytes (one read of the logits).  The vocab is split
over the SMs: a grid of (V / vt tiles, B) CTAs — vt the tile registry's
``exit_update.vt`` (:mod:`repro_torch.kernels.autotune`: 2048, 4096 by
default, or 8192, each an instantiation of the kernel) —, 16-byte loads, one
(max, Σexp, first-argmax) partial per CTA; the last CTA of each row merges
the row's partials in tile order and applies the carry merge, all in ONE
launch (a per-row ticket, put back to 0 by that CTA, in a per-device
buffer this module keeps).  See the source's header for the design.

The kernel reads the threshold δ̂ from device memory (the reference's
``dynamic`` route): the wrapper takes an f32 tensor — 0-d, or the
``(n_components,)`` vector whose element ``m`` gates — or a float, which
it makes into a 0-d tensor on the device (:func:`threshold_operand`).  A
captured CUDA graph replays at whatever the tensor holds when it replays,
so a threshold push is a write into the tensor: no rebuild, no new
capture.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import autotune, build
from repro_torch.kernels.ref import (ref_exit_combine, ref_exit_partial,
                                     ref_exit_update)

# vocab columns per CTA by default: kTile of csrc/exit_update.cu's default
# instantiation
TILE = autotune.DEFAULT_TILES["exit_update"]["vt"]

_SIG = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        + [ctypes.c_void_p] * 15
        + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
           ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p, ctypes.c_void_p])
_COMBINE_SIG = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                + [ctypes.c_void_p] * 15
                + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# "whole": the single-rank launch; "partial" / "combine": the two halves of
# the partial contract (a vocab sharded over the mesh's model ranks)
ROUTES = ("whole", "partial", "combine")


def threshold_operand(threshold, m: int, device) -> torch.Tensor:
    """The gate's δ̂ for component ``m`` as a 0-d f32 tensor: element ``m``
    of an ``(n_components,)`` vector (a view: the kernel reads it from
    device memory at launch or replay time), a 0-d tensor as given, or a
    float rounded to f32 (the gate compares at the confidence's precision)
    and filled into a new tensor on ``device`` (a fill launch, no copy
    from the host)."""
    if isinstance(threshold, torch.Tensor):
        if threshold.dtype != torch.float32 or threshold.dim() > 1:
            raise TypeError(f"threshold tensor must be 0-d or (n_components,)"
                            f" f32, got {threshold.dtype} "
                            f"{tuple(threshold.shape)}")
        return threshold if threshold.dim() == 0 else threshold[m]
    return torch.full((), float(np.float32(threshold)), dtype=torch.float32,
                      device=device)


def _tensors(threshold):
    """``threshold`` for a device check: () unless it is a tensor."""
    return (threshold,) if isinstance(threshold, torch.Tensor) else ()


def exit_update(logits, answered, pred, exit_idx, conf, streak, ema, active,
                *, threshold, m: int, n_components: int,
                patience_k: int = 0, ema_decay: float = 0.0,
                tel_bins: int = 0):
    """One fused component step of the exit-decision scan.

    logits (B, V); answered/active (B,) bool; pred/exit_idx/streak (B,)
    int32; conf/ema (B,) f32; ``threshold`` an f32 tensor on the logits'
    device or a float (see :func:`threshold_operand`).  Returns
    (answered', pred', exit', conf', streak', ema') — bool, int32, int32,
    f32, int32, f32 — plus the (B,) int32 telemetry code ``raw_pred *
    tel_bins + conf_bin`` when ``tel_bins > 0``.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    kw = dict(m=int(m), n_components=int(n_components),
              patience_k=int(patience_k), ema_decay=float(ema_decay),
              tel_bins=int(tel_bins))
    if logits.device.type == "cpu":
        return ref_exit_update(logits, answered, pred, exit_idx, conf, streak,
                               ema, active, threshold=threshold_operand(
                                   threshold, m, "cpu"), **kw)
    carries = (answered, pred, exit_idx, conf, streak, ema, active)
    build.require_cuda("exit_update", logits, *carries,
                       *_tensors(threshold))
    thr = threshold_operand(threshold, m, logits.device)
    _check_logits(logits, "exit_update")
    B = logits.shape[0]
    if any(c.shape != (B,) for c in carries):
        raise ValueError("exit_update: every carry must be (B,)")
    ins, outs = carry_buffers(carries, kw["tel_bins"])
    p = build.ptr
    build.check(_launch_tiles(logits, [p(t) for t in ins + outs], p(thr), kw,
                              0, None), "exit_update")
    exit_update.launches += 1
    exit_update.launches_by_route["whole"] += 1
    return tuple(outs if kw["tel_bins"] else outs[:6])


def carry_buffers(carries, tel_bins: int):
    """The seven carries (answered, pred, exit, conf, streak, ema, active)
    in the kernels' dtypes, contiguous, and the seven outputs (the first
    six and the telemetry code, None unless ``tel_bins``)."""
    i32, f32 = torch.int32, torch.float32
    ans, pred, exi, conf, streak, ema, act = carries
    B, dev = ans.shape[0], ans.device
    ins = [ans.to(torch.bool).contiguous(), pred.to(i32).contiguous(),
           exi.to(i32).contiguous(), conf.to(f32).contiguous(),
           streak.to(i32).contiguous(), ema.to(f32).contiguous(),
           act.to(torch.bool).contiguous()]
    outs = [torch.empty(B, dtype=torch.bool, device=dev),
            torch.empty(B, dtype=i32, device=dev),
            torch.empty(B, dtype=i32, device=dev),
            torch.empty(B, dtype=f32, device=dev),
            torch.empty(B, dtype=i32, device=dev),
            torch.empty(B, dtype=f32, device=dev),
            torch.empty(B, dtype=i32, device=dev) if tel_bins else None]
    return ins, outs


def _launch_tiles(logits, carry_ptrs, thr_ptr, kw, vocab_offset, part):
    """One launch of the tile kernel: the carry merge, or with ``part`` a
    (3, B) f32 tensor the row triples of the partial contract."""
    B, V = logits.shape
    dev = logits.device
    vt = int(autotune.tile("exit_update", "vt"))
    workspace = torch.empty((3, B, -(-V // vt)), dtype=torch.float32,
                            device=dev)
    p = build.ptr
    fn = build.function("exit_update", "exit_update_launch", _SIG)
    return fn(
        p(logits), logits.stride(0), B, V, build.dtype_code(logits),
        p(workspace), p(_tickets(dev, B)), *carry_ptrs, thr_ptr,
        kw.get("m", 0), kw.get("n_components", 1), kw.get("patience_k", 0),
        kw.get("ema_decay", 0.0), 1.0 - kw.get("ema_decay", 0.0),
        kw.get("tel_bins", 0), vt, int(vocab_offset), p(part),
        build.stream_of(logits))


def _check_logits(logits, what):
    if logits.dim() != 2 or logits.stride(1) != 1:
        raise ValueError(f"{what}: logits must be (B, V) with a contiguous "
                         f"last dim, got {tuple(logits.shape)}")


def exit_partial(logits, *, vocab_offset: int = 0):
    """The partial contract's first half: ``logits`` (B, V_r) are columns
    [vocab_offset, vocab_offset + V_r) of the exit logits; returns the
    rows' (max, Σexp, first argmax + vocab_offset) triples as a (3, B) f32
    tensor, the argmax row holding int32 bits (``[2].view(torch.int32)``).
    CPU tensors take the plain version; CUDA tensors launch the tile
    kernel in its partial mode."""
    if logits.device.type == "cpu":
        return ref_exit_partial(logits, vocab_offset)
    build.require_cuda("exit_partial", logits)
    _check_logits(logits, "exit_partial")
    part = torch.empty((3, logits.shape[0]), dtype=torch.float32,
                       device=logits.device)
    null = [None] * 14
    build.check(_launch_tiles(logits, [build.ptr(t) for t in null],
                              build.ptr(None), {}, vocab_offset, part),
                "exit_partial")
    exit_update.launches += 1
    exit_update.launches_by_route["partial"] += 1
    return part


def exit_combine(parts, answered, pred, exit_idx, conf, streak, ema, active,
                 *, threshold, m: int, n_components: int,
                 patience_k: int = 0, ema_decay: float = 0.0,
                 tel_bins: int = 0):
    """The partial contract's second half: ``parts`` (R, 3, B), the R vocab
    slices' triples in rank order (:func:`exit_partial`, gathered over the
    model axis), merged rank after rank — ties to the lowest global index
    — then the carry merge of :func:`exit_update`; same results."""
    kw = dict(m=int(m), n_components=int(n_components),
              patience_k=int(patience_k), ema_decay=float(ema_decay),
              tel_bins=int(tel_bins))
    carries = (answered, pred, exit_idx, conf, streak, ema, active)
    if parts.device.type == "cpu":
        return ref_exit_combine(parts, *carries, threshold=threshold_operand(
            threshold, m, "cpu"), **kw)
    build.require_cuda("exit_combine", parts, *carries, *_tensors(threshold))
    R, three, B = parts.shape
    if three != 3 or parts.dtype != torch.float32 or any(
            c.shape != (B,) for c in carries):
        raise ValueError(f"exit_combine: parts (R, 3, B) f32 and (B,) "
                         f"carries, got {tuple(parts.shape)} {parts.dtype}")
    thr = threshold_operand(threshold, m, parts.device)
    ins, outs = carry_buffers(carries, kw["tel_bins"])
    p = build.ptr
    fn = build.function("exit_update", "exit_update_combine_launch",
                        _COMBINE_SIG)
    build.check(fn(p(parts.contiguous()), B, R, *(p(t) for t in ins + outs),
                   p(thr), kw["m"], kw["n_components"], kw["patience_k"],
                   kw["ema_decay"], 1.0 - kw["ema_decay"], kw["tel_bins"],
                   build.stream_of(parts)), "exit_combine")
    exit_update.launches += 1
    exit_update.launches_by_route["combine"] += 1
    return tuple(outs if kw["tel_bins"] else outs[:6])


exit_update.launches = 0
exit_update.launches_by_route = dict.fromkeys(ROUTES, 0)

# device -> int32 tickets, one per row, zeroed once: each call's last CTA
# of a row puts the row's ticket back to 0 (so calls sharing the buffer
# must be ordered on one stream, as the port's are)
_TICKETS = {}


def _tickets(dev, B: int) -> torch.Tensor:
    t = _TICKETS.get(dev)
    if t is None or t.numel() < B:
        t = _TICKETS[dev] = torch.zeros(max(B, 64), dtype=torch.int32,
                                        device=dev)
    return t


def reset_launches() -> None:
    exit_update.launches = 0
    exit_update.launches_by_route.update(dict.fromkeys(ROUTES, 0))
