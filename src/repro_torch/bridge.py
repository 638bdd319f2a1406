"""Weight bridge between the JAX package's parameter pytree and the port's.

``params_from_jax`` takes the pytree of the reference's
``CascadeModel.init`` (``models/model.py:73-121``) with every leaf turned
into a numpy array — ``embed``, ``segments[si][pi]`` (stage dicts whose
leaves are stacked on a leading layer axis), ``exits[m]``, ``final_norm``
and ``lm_head`` — and returns the same structure of torch tensors on
``device``, dtypes kept.  ``params_to_numpy`` is the inverse, so a round
trip is bit-exact.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.nn import tree_map
from repro_torch.utils import resolve_device

_KEYS = ("embed", "segments", "exits", "final_norm", "lm_head")


def _to_torch(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # the bfloat16 numpy dtype the reference uses
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(np_params: Any, cfg: ModelConfig, device=None):
    """The reference's parameter pytree (numpy leaves) -> the port's."""
    device = resolve_device(device)
    missing = [k for k in _KEYS if k not in np_params]
    extra = sorted(set(np_params) - set(_KEYS))
    if missing or extra:
        raise ValueError(f"parameter tree keys: missing {missing}, "
                         f"unsupported {extra} (dense family only)")
    if len(np_params["segments"]) != cfg.cascade.n_components:
        raise ValueError(f"{len(np_params['segments'])} segments for "
                         f"{cfg.cascade.n_components} cascade components")
    shape = tuple(np.shape(np_params["embed"]))
    if shape != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed {shape} does not match the config")
    return tree_map(lambda x: _to_torch(x, device), np_params)


def params_to_numpy(params: Any):
    """The port's parameters -> the same tree with numpy leaves."""
    return tree_map(_to_numpy, params)
