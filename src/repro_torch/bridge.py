"""Weight bridge between the JAX package's parameter pytree and the port's.

``params_from_jax`` takes the pytree of the reference's
``CascadeModel.init`` (``models/model.py:73-121``) with every leaf turned
into a numpy array — ``embed``, ``pos_embed`` (learned positions, when
``rope_theta <= 0``), ``segments[si][pi]`` (stage dicts whose leaves are
stacked on a leading layer axis), ``exits[m]``, ``final_norm`` and
``lm_head`` (absent with tied embeddings) and, for the hybrid family,
``shared`` (the shared block's ``attn`` and ``mlp`` dicts), for the audio
family ``encoder`` (its stacked ``enc`` layers' ``stages``, its ``norm``
and its frame ``pos_embed``); a layernorm's
``"b"`` rides in its norm dict, an moe block's ``moe`` dict (``router``
(d, E), ``w_gate`` / ``w_up`` (E, d, ff), ``w_down`` (E, ff, d),
``norm``) in its stage, a mamba block's ``ssm`` dict, an attn_shared
block's ``lora_*`` leaves, an mlstm or slstm block's ``mlstm`` /
``slstm`` dict, an xattn block's ``xattn`` (with its 0-d tanh ``gate``,
stacked to (n,)) and ``mlp`` dicts and an encdec block's ``attn``,
``xattn`` and ``mlp`` dicts in theirs — and returns the same structure of torch tensors on
``device``, dtypes kept.  ``params_to_numpy`` is the inverse, so a round
trip is bit-exact.

``resnet_params_from_jax`` does the same for CI-ResNet's ``(params,
state)`` (``models/resnet.py``): convolution weights go from the
reference's HWIO to the OIHW of ``F.conv2d``, fully connected weights stay
``(in, out)``; ``resnet_params_to_numpy`` is its inverse, bit-exact.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.models.nn import tree_map
from repro_torch.utils import (numpy_to_tensor, resolve_device,
                               tensor_to_numpy)

def _keys(cfg: ModelConfig):
    """The top-level parameter keys of a model of ``cfg`` (dense, moe,
    hybrid, ssm, vlm or audio: the moe, mamba, mLSTM, sLSTM, xattn and
    encdec leaves and the LoRA deltas ride inside ``segments``; the hybrid's shared
    block is ``shared``, the audio encoder ``encoder``)."""
    keys = ["embed", "segments", "exits", "final_norm"]
    if cfg.family == "hybrid":
        keys.append("shared")
    if cfg.family == "audio":
        keys.append("encoder")
    if cfg.family == "audio" or cfg.rope_theta <= 0:
        keys.append("pos_embed")
    if not cfg.tie_embeddings:
        keys.append("lm_head")
    return keys


def params_from_jax(np_params: Any, cfg: ModelConfig, device=None):
    """The reference's parameter pytree (numpy leaves) -> the port's."""
    device = resolve_device(device)
    keys = _keys(cfg)
    missing = [k for k in keys if k not in np_params]
    extra = sorted(set(np_params) - set(keys))
    if missing or extra:
        raise ValueError(f"parameter tree keys: missing {missing}, "
                         f"unsupported {extra} (the dense, moe, hybrid, ssm, "
                         f"vlm and audio families only)")
    if len(np_params["segments"]) != cfg.cascade.n_components:
        raise ValueError(f"{len(np_params['segments'])} segments for "
                         f"{cfg.cascade.n_components} cascade components")
    shape = tuple(np.shape(np_params["embed"]))
    if shape != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed {shape} does not match the config")
    return tree_map(lambda x: numpy_to_tensor(x, device), np_params)


def params_to_numpy(params: Any):
    """The port's parameters -> the same tree with numpy leaves."""
    return tree_map(tensor_to_numpy, params)


def _conv_to_oihw(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(a, (3, 2, 0, 1)))


def resnet_params_from_jax(np_params: Any, np_state: Any, device=None):
    """The reference CIResNet's ``(params, state)`` (numpy leaves) -> the
    port's: 4-D (convolution) leaves HWIO -> OIHW, the rest as they are."""
    device = resolve_device(device)

    def one(x):
        a = np.asarray(x)
        return numpy_to_tensor(_conv_to_oihw(a) if a.ndim == 4 else a,
                               device)
    return tree_map(one, np_params), tree_map(one, np_state)


def resnet_params_to_numpy(params: Any, state: Any):
    """The port's CIResNet ``(params, state)`` -> numpy leaves in the
    reference's layout (OIHW -> HWIO)."""
    def one(t):
        a = tensor_to_numpy(t)
        return (np.ascontiguousarray(np.transpose(a, (2, 3, 1, 0)))
                if a.ndim == 4 else a)
    return tree_map(one, params), tree_map(one, state)
