"""The port's hand-written Hopper kernels, their plain versions and their
launch counters."""
from __future__ import annotations

from repro_torch.kernels import (decode_attention, exit_update,
                                 flash_attention, rmsnorm)

_MODULES = {"rmsnorm": rmsnorm, "exit_update": exit_update,
            "decode_attention": decode_attention,
            "flash_attention": flash_attention}


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {name: getattr(mod, name).launches
            for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.reset_launches()
