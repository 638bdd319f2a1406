"""The port's hand-written Hopper kernels, their plain versions and their
launch counters."""
from __future__ import annotations

from repro_torch.kernels import (cohort_cache, confidence, decode_attention,
                                 exit_update, flash_attention, megakernel,
                                 paged_gather, rmsnorm)

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
}


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {name: fn.launches for name, (_, fn) in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, _ in _KERNELS.values():
        mod.reset_launches()
