"""Small shared helpers: dtype mapping, logging, device resolution."""
from __future__ import annotations

import logging
import sys

import torch


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s: %(message)s", "%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


_cuda_ready = False


def _setup_cuda() -> None:
    """One-time CUDA numerics setup.  TF32 keeps ~3 decimal digits, so a
    float32 matmul or convolution routed through it would no longer agree
    with the float32 reference; both switches are turned off here, once,
    for the whole process."""
    global _cuda_ready
    if _cuda_ready:
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _cuda_ready = True


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  With no CUDA device and no explicit device this raises —
    the port never quietly carries on on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is "
                               "not available")
        _setup_cuda()
    return dev
