"""The port's hand-written Hopper kernels, their plain versions and their
launch counters."""
from __future__ import annotations

from repro_torch.kernels import (allreduce, cohort_cache, confidence,
                                 decode_attention, exit_update,
                                 flash_attention, megakernel, paged_gather,
                                 rmsnorm)

# kernel name -> (module, its wrapper), in the order of the csrc sources
_KERNELS = {
    "rmsnorm": (rmsnorm, rmsnorm.rmsnorm),
    "exit_update": (exit_update, exit_update.exit_update),
    "decode_attention": (decode_attention, decode_attention.decode_attention),
    "flash_attention": (flash_attention, flash_attention.flash_attention),
    "confidence": (confidence, confidence.confidence),
    "megakernel": (megakernel, megakernel.exit_head_update),
    "cohort_scatter": (cohort_cache, cohort_cache.cohort_scatter_tree),
    "paged_gather": (paged_gather, paged_gather.paged_gather),
    "allreduce": (allreduce, allreduce.allreduce),
    "reduce_scatter": (allreduce, allreduce.reduce_scatter),
}


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {name: fn.launches for name, (_, fn) in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, _ in _KERNELS.values():
        mod.reset_launches()


# Launch snapshots: {kernel name: launches} and {(kernel name, route):
# launches} for the kernels with routes, in one flat dict.  A CUDA graph's
# replays run no Python, so the device runtime restores the counters after
# a capture and adds each body's captured launches times its executions.

def launch_snapshot() -> dict:
    """Every launch counter, by kernel name and by (name, route)."""
    out = {}
    for name, (_, fn) in _KERNELS.items():
        out[name] = fn.launches
        for r, n in getattr(fn, "launches_by_route", {}).items():
            out[name, r] = n
    return out


def launch_diff(a: dict, b: dict) -> dict:
    return {k: a[k] - b.get(k, 0) for k in a}


def launch_sum(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def launch_scale(a: dict, n: int) -> dict:
    return {k: v * n for k, v in a.items()}


def set_launch_counts(snap: dict) -> None:
    """Put every launch counter back to a :func:`launch_snapshot`."""
    for name, (_, fn) in _KERNELS.items():
        fn.launches = snap[name]
        for r in getattr(fn, "launches_by_route", {}):
            fn.launches_by_route[r] = snap[name, r]


def add_launch_counts(delta: dict) -> None:
    """Add launches (a :func:`launch_snapshot`-shaped dict) that ran
    without a Python call, e.g. in a CUDA graph's replays."""
    snap = launch_snapshot()
    set_launch_counts(launch_sum(snap, {k: v for k, v in delta.items()
                                        if k in snap}))
