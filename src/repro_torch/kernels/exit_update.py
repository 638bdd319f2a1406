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
over the SMs: a grid of (V / 4096 tiles, B) CTAs, 16-byte loads, one
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

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_exit_update

TILE = 4096  # vocab columns per CTA: kTile in csrc/exit_update.cu

_SIG = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        + [ctypes.c_void_p] * 15
        + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
           ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


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
    if logits.dim() != 2 or logits.stride(1) != 1:
        raise ValueError("exit_update: logits must be (B, V) with a "
                         f"contiguous last dim, got {tuple(logits.shape)}")
    B, V = logits.shape
    if any(c.shape != (B,) for c in carries):
        raise ValueError("exit_update: every carry must be (B,)")
    i32, f32 = torch.int32, torch.float32
    ans_in = answered.to(torch.bool).contiguous()
    act_in = active.to(torch.bool).contiguous()
    pred_in, exit_in, streak_in = (t.to(i32).contiguous()
                                   for t in (pred, exit_idx, streak))
    conf_in, ema_in = (t.to(f32).contiguous() for t in (conf, ema))
    dev = logits.device
    outs = [torch.empty(B, dtype=torch.bool, device=dev),
            torch.empty(B, dtype=i32, device=dev),
            torch.empty(B, dtype=i32, device=dev),
            torch.empty(B, dtype=f32, device=dev),
            torch.empty(B, dtype=i32, device=dev),
            torch.empty(B, dtype=f32, device=dev)]
    if kw["tel_bins"]:
        outs.append(torch.empty(B, dtype=i32, device=dev))
    tcode = outs[6] if kw["tel_bins"] else None
    workspace = torch.empty((3, B, -(-V // TILE)), dtype=f32, device=dev)
    p = build.ptr
    fn = build.function("exit_update", "exit_update_launch", _SIG)
    build.check(fn(
        p(logits), logits.stride(0), B, V, build.dtype_code(logits),
        p(workspace), p(_tickets(dev, B)),
        p(ans_in), p(pred_in), p(exit_in), p(conf_in), p(streak_in),
        p(ema_in), p(act_in), *(p(o) for o in outs[:6]), p(tcode), p(thr),
        kw["m"], kw["n_components"], kw["patience_k"],
        kw["ema_decay"], 1.0 - kw["ema_decay"], kw["tel_bins"],
        build.stream_of(logits)), "exit_update")
    exit_update.launches += 1
    return tuple(outs)


exit_update.launches = 0

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
