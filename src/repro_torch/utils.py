"""Small shared helpers: dtype mapping, logging, device resolution, tree
paths, sizes and casts, a wall-clock timer, human-readable sizes and the
numpy form of a tensor's bits."""
from __future__ import annotations

import logging
import sys
import time
from typing import Any, Iterator, Tuple

import numpy as np
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


# ---------------------------------------------------------------------------
# trees: nested dicts and lists of tensors
# ---------------------------------------------------------------------------

def tree_flatten_with_path(tree, prefix: Tuple = ()
                           ) -> Iterator[Tuple[Tuple, Any]]:
    """``(path, leaf)`` for every leaf of nested dicts / lists / tuples,
    in order (None skipped); a path is the tuple of dict keys and list
    indices leading to the leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_flatten_with_path(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_flatten_with_path(v, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


def path_str(path) -> str:
    """Render a tree path as 'a/b/0/c' — the JAX package's key for the
    same leaf (its dict keys and sequence indices, slash-joined)."""
    return "/".join(str(p) for p in path)


def tree_size(tree) -> int:
    """Total number of elements in a tree of tensors."""
    return sum(int(np.prod(tuple(x.shape)))
               for _, x in tree_flatten_with_path(tree))


def tree_bytes(tree) -> int:
    """Total bytes of the leaves of a tree of tensors (elements times the
    dtype's size; views count their own shape, not their storage)."""
    return sum(int(np.prod(tuple(x.shape))) * x.element_size()
               for _, x in tree_flatten_with_path(tree))


def tree_cast(tree, dtype):
    """The tree with its floating-point leaves cast to ``dtype`` (a
    torch.dtype or a name of :data:`DTYPES`); integer and bool leaves are
    kept as they are."""
    from repro_torch.models.nn import tree_map
    dt = DTYPES[dtype] if isinstance(dtype, str) else dtype
    return tree_map(lambda x: x.to(dt) if x.is_floating_point() else x,
                    tree)


def assert_finite(tree, name: str = "tree") -> None:
    """Raise AssertionError naming the first floating-point leaf (by its
    :func:`path_str`) that holds a NaN or an infinity."""
    for path, leaf in tree_flatten_with_path(tree):
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            raise AssertionError(
                f"non-finite values in {name} at {path_str(path)}")


class Timer:
    """Wall-clock context timer on the host's clock: ``elapsed`` seconds
    between ``__enter__`` and ``__exit__``.  It does not wait for the
    device: synchronise inside the block to time CUDA work."""

    def __init__(self):
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024:
            return f"{n:.2f}{unit}"
        n /= 1024
    return f"{n:.2f}PiB"


def human_count(n: float) -> str:
    for unit in ("", "K", "M", "G", "T", "P"):
        if abs(n) < 1000:
            return f"{n:.3g}{unit}"
        n /= 1000
    return f"{n:.3g}E"


# ---------------------------------------------------------------------------
# a tensor's bits as numpy, and back (no ml_dtypes: numpy has no bfloat16)
# ---------------------------------------------------------------------------

def bf16_numpy_dtype() -> np.dtype:
    """The numpy dtype a bfloat16 tensor's bits are given as: the
    ``bfloat16`` type when a module of the process registered it with
    numpy (ml_dtypes, which JAX loads), else two raw bytes (``|V2``, what
    ``np.savez`` writes for a bfloat16 array).  Never imports ml_dtypes."""
    try:
        return np.dtype("bfloat16")
    except TypeError:
        return np.dtype("V2")


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array with the same bits; bfloat16 comes
    back as :func:`bf16_numpy_dtype`."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(bf16_numpy_dtype())
    return t.numpy()


def numpy_to_tensor(a, device="cpu") -> torch.Tensor:
    """A numpy array (or array-like) as a tensor on ``device`` with the
    same bits; any 2-byte void or ``bfloat16`` array is read as
    bfloat16."""
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def quantiles(values, qs=(0.5, 0.95, 0.99)):
    """p-quantile summary of a value list (None when empty): count, sum and
    ``p50``/``p95``/``p99`` by linear interpolation on the sorted sample
    (numpy's default), as the reference's flight recorder reports them."""
    if not values:
        return None
    xs = sorted(float(v) for v in values)
    n = len(xs)
    out = {"count": n, "sum": float(sum(xs))}
    for q in qs:
        pos = q * (n - 1)
        lo = int(pos)
        hi = min(lo + 1, n - 1)
        out[f"p{int(q * 100)}"] = xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
    return out
