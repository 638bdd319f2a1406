"""CI-RESNET(n) — the paper's experimental architecture (Fig. 2): the
counterpart of the JAX package's ``models/resnet.py``.

RESNET(n) = 3x3 stem conv + 3 ResNet modules of n blocks (the first block
of modules 1, 2 subsamples with stride 2) + GAP + FC + softmax, module
widths (16, 32, 64) (the reference's module docstring says why).
CI-RESNET(n) adds classifier branches after modules 0 and 1 with the
paper's *classifier enhancement*: GAP → FC(width → enhance_dim) → ReLU →
FC(enhance_dim → n_c).

The API is the reference's: ``init`` → ``(params, state)``, ``apply(params,
state, x, train)`` → ``([logits_m] * 3, new_state)``, and
``component_fns`` — component m consumes the feature map of component
m−1 (nested prefixes, the cascade reuse property) for Algorithm 1.  Inputs
are NHWC, as the datasets are.  Inside, feature maps are NCHW (the carry
between components too) and convolution weights OIHW, for
``F.conv2d``; ``bridge.resnet_params_from_jax`` turns the reference's HWIO
weights into these.  Fully connected weights stay ``(in, out)``.

Two details keep the numbers the reference's:
* ``conv2d`` pads "SAME" as XLA does: at stride 2 on an even size the one
  pixel of padding goes to the bottom / right only (a symmetric
  ``padding=1`` would shift every strided output by a pixel);
* ``batchnorm`` in training normalizes with the biased batch variance and
  moves the running statistics by ``0.9 · old + 0.1 · batch`` with that
  same biased variance (``F.batch_norm`` would use the unbiased one), with
  the state update kept out of autograd.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.utils import resolve_device

WIDTHS = (16, 32, 64)
BN_MOMENTUM = 0.9


def _normal(gen, shape, std):
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device) * std


def _conv_init(gen, k, c_in, c_out):
    return _normal(gen, (c_out, c_in, k, k), math.sqrt(2.0 / (k * k * c_in)))


def _fc_init(gen, c_in, c_out):
    return _normal(gen, (c_in, c_out), math.sqrt(2.0 / c_in))


def _bn_init(c, dev):
    return {"scale": torch.ones(c, device=dev),
            "bias": torch.zeros(c, device=dev)}


def _bn_state(c, dev):
    return {"mean": torch.zeros(c, device=dev),
            "var": torch.ones(c, device=dev)}


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x, w, stride: int = 1):
    """x (N, C, H, W), w (O, I, k, k), "SAME" padding."""
    k = w.shape[-1]
    ph = _same_pad(x.shape[2], k, stride)
    pw = _same_pad(x.shape[3], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride)


def batchnorm(x, params, state, train: bool, eps: float = 1e-5):
    """x (N, C, H, W).  Returns (y, new_state)."""
    if train:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        with torch.no_grad():
            new_state = {
                "mean": BN_MOMENTUM * state["mean"]
                + (1 - BN_MOMENTUM) * mean.detach(),
                "var": BN_MOMENTUM * state["var"]
                + (1 - BN_MOMENTUM) * var.detach(),
            }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    a = (torch.rsqrt(var + eps) * params["scale"])[:, None, None]
    y = torch.addcmul(params["bias"][:, None, None], x - mean[:, None, None],
                      a)
    return y, new_state


class CIResNet:
    def __init__(self, n_blocks: int, n_classes: int, enhance_dim: int = 128,
                 device=None):
        self.n = n_blocks
        self.n_classes = n_classes
        self.enhance_dim = enhance_dim
        self.device = resolve_device(device)

    # ------------------------------------------------------------------
    def init(self, generator) -> Tuple[Dict, Dict]:
        """Random (params, state) drawn from ``generator`` (a
        torch.Generator on this model's device, or an int seed for one):
        He init N(0, sqrt(2 / fan_in)), as the paper specifies."""
        gen = generator
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=self.device).manual_seed(int(gen))
        dev = self.device
        params: Dict[str, Any] = {"stem": {"w": _conv_init(gen, 3, 3,
                                                           WIDTHS[0]),
                                           "bn": _bn_init(WIDTHS[0], dev)}}
        state: Dict[str, Any] = {"stem": _bn_state(WIDTHS[0], dev)}
        for mod in range(3):
            c_in = WIDTHS[mod - 1] if mod else WIDTHS[0]
            c_out = WIDTHS[mod]
            blocks_p, blocks_s = [], []
            for b in range(self.n):
                ci = c_in if b == 0 else c_out
                stride = 2 if (b == 0 and mod > 0) else 1
                bp = {"conv1": _conv_init(gen, 3, ci, c_out),
                      "bn1": _bn_init(c_out, dev),
                      "conv2": _conv_init(gen, 3, c_out, c_out),
                      "bn2": _bn_init(c_out, dev)}
                if stride == 2 or ci != c_out:
                    bp["proj"] = _conv_init(gen, 1, ci, c_out)
                blocks_p.append(bp)
                blocks_s.append({"bn1": _bn_state(c_out, dev),
                                 "bn2": _bn_state(c_out, dev)})
            params[f"module{mod}"] = blocks_p
            state[f"module{mod}"] = blocks_s
        # classifiers: enhanced heads 0, 1; plain head 2
        for m in range(2):
            params[f"head{m}"] = {
                "w1": _fc_init(gen, WIDTHS[m], self.enhance_dim),
                "b1": torch.zeros(self.enhance_dim, device=dev),
                "w2": _fc_init(gen, self.enhance_dim, self.n_classes),
                "b2": torch.zeros(self.n_classes, device=dev),
            }
        params["head2"] = {"w": _fc_init(gen, WIDTHS[2], self.n_classes),
                           "b": torch.zeros(self.n_classes, device=dev)}
        return params, state

    # ------------------------------------------------------------------
    def _block(self, bp, bs, x, stride, train):
        y, s1 = batchnorm(conv2d(x, bp["conv1"], stride), bp["bn1"],
                          bs["bn1"], train)
        y = torch.relu(y)
        y, s2 = batchnorm(conv2d(y, bp["conv2"]), bp["bn2"], bs["bn2"], train)
        if "proj" in bp:
            x = conv2d(x, bp["proj"], stride)
        return torch.relu(x + y), {"bn1": s1, "bn2": s2}

    def _module(self, params, state, x, mod, train):
        new_states = []
        for b, (bp, bs) in enumerate(zip(params[f"module{mod}"],
                                         state[f"module{mod}"])):
            stride = 2 if (b == 0 and mod > 0) else 1
            x, ns = self._block(bp, bs, x, stride, train)
            new_states.append(ns)
        return x, new_states

    def _head(self, params, m, x):
        feat = torch.mean(x, dim=(2, 3))                # GAP
        if m < 2:
            h = params[f"head{m}"]
            z = torch.relu(feat @ h["w1"] + h["b1"])
            return z @ h["w2"] + h["b2"]
        h = params["head2"]
        return feat @ h["w"] + h["b"]

    def _stem(self, params, state, x, train):
        x = x.permute(0, 3, 1, 2).contiguous()         # NHWC -> NCHW
        y, s = batchnorm(conv2d(x, params["stem"]["w"]), params["stem"]["bn"],
                         state["stem"], train)
        return torch.relu(y), s

    # ------------------------------------------------------------------
    def apply(self, params, state, x, train: bool = False):
        """x: (B, 32, 32, 3) NHWC.  Returns ([logits_m] * 3, new_state)."""
        new_state: Dict[str, Any] = {}
        y, new_state["stem"] = self._stem(params, state, x, train)
        logits: List[torch.Tensor] = []
        for mod in range(3):
            y, new_state[f"module{mod}"] = self._module(params, state, y,
                                                        mod, train)
            logits.append(self._head(params, mod, y))
        return logits, new_state

    # ------------------------------------------------------------------
    def component_fns(self, params, state):
        """Per-component functions for Algorithm 1: ``fn(x, carry) ->
        (logits, features)``; component m consumes the feature map
        (NCHW) produced by component m−1 (nested-prefix reuse)."""
        def make(m):
            def fn(x, carry):
                if m == 0:
                    y, _ = self._stem(params, state, x, False)
                else:
                    y = carry
                y, _ = self._module(params, state, y, m, False)
                return self._head(params, m, y), y
            return fn
        return [make(m) for m in range(3)]
