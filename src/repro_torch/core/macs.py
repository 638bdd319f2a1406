"""Analytic MAC and parameter accounting: CI-ResNet components and the
cascade segments (dense, moe, hybrid, ssm, vlm and audio families).

The counterpart of the JAX package's ``core/macs.py``.  The paper counts
MACs "analytically by summing up the linear operations in the
convolutional layers and the fully connected layers, excluding
activations and batch normalization" (§6.2); ``resnet_component_macs``
follows that scope.  ``segment_macs_per_token`` gives decode-time MACs of
each cascade segment, the quantity the early exit saves, which the
serving engine's analytic speedup reads; ``model_flops`` gives the
roofline's MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE), which the
dry run records.
"""
from __future__ import annotations

from typing import List

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import layer_kinds
from repro_torch.models.ssm import dims as ssm_dims
from repro_torch.models.xlstm import mlstm_dims


# ---------------------------------------------------------------------------
# CI-ResNet (paper scope: conv + fc only)
# ---------------------------------------------------------------------------

def conv_macs(k: int, c_in: int, c_out: int, h_out: int, w_out: int) -> int:
    return k * k * c_in * c_out * h_out * w_out


def resnet_component_macs(n_blocks: int, n_classes: int,
                          widths=(16, 32, 64), image_hw: int = 32,
                          enhance_dim: int = 128) -> List[float]:
    """Cumulative MACs after components 0, 1, 2 of CI-RESNET(n) (per
    image): component m = stem + modules 0..m + its classifier, as
    ``models/resnet.py`` computes it."""
    macs_prefix = []
    total = conv_macs(3, 3, widths[0], image_hw, image_hw)      # stem
    hw = image_hw
    for mod in range(3):
        c_in = widths[mod - 1] if mod else widths[0]
        c_out = widths[mod]
        stride = 1 if mod == 0 else 2
        if stride == 2:
            hw //= 2
        # first block (possibly strided, with a projection shortcut)
        total += conv_macs(3, c_in, c_out, hw, hw)
        total += conv_macs(3, c_out, c_out, hw, hw)
        if stride == 2 or c_in != c_out:
            total += conv_macs(1, c_in, c_out, hw, hw)
        for _ in range(n_blocks - 1):
            total += 2 * conv_macs(3, c_out, c_out, hw, hw)
        if mod < 2 and enhance_dim:                 # enhanced classifier
            head = c_out * enhance_dim + enhance_dim * n_classes
        else:
            head = c_out * n_classes
        macs_prefix.append(total + head)
    return [float(m) for m in macs_prefix]


# ---------------------------------------------------------------------------
# LLM cascade segments
# ---------------------------------------------------------------------------

def _layer_macs_per_token(cfg: ModelConfig, kind: str, kv_len: int) -> float:
    """Decode-time MACs of one layer for one new token, KV length kv_len."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    eff_kv = min(kv_len, cfg.attn_window) if cfg.attn_window else kv_len

    def attn():
        proj = d * (H * hd) + 2 * d * (KV * hd) + (H * hd) * d
        scores = H * hd * eff_kv * 2             # qk + pv
        return proj + scores

    def mlp():
        return (3 if cfg.act == "swiglu" else 2) * d * cfg.d_ff

    def mamba():
        d_inner, n_heads, conv_ch = ssm_dims(cfg)
        in_p = d * (2 * d_inner + 2 * cfg.ssm_state + n_heads)
        conv = cfg.ssm_conv * conv_ch
        state = 2 * d_inner * cfg.ssm_state      # state update + C readout
        out_p = d_inner * d
        return in_p + conv + state + out_p

    def mlstm():
        d_inner, h, p = mlstm_dims(cfg)
        up = d * 2 * d_inner
        qkv = 3 * d_inner * d_inner
        cell = 3 * h * p * p                     # C update + readout
        down = d_inner * d
        return up + qkv + cell + down

    def slstm():
        p = d // cfg.n_heads
        rec = 4 * cfg.n_heads * p * p
        return d * 4 * d + rec + d * (4 * d) // 3 + ((4 * d) // 3) * d

    def xattn():
        # q and o only at decode (the cross K/V are cached), scores over
        # the T memory rows
        T = cfg.n_image_tokens or cfg.n_audio_frames
        return d * (H * hd) + (H * hd) * d + H * hd * T * 2 + mlp()

    table = {
        "dense": lambda: attn() + mlp(),
        "moe": lambda: attn() + d * cfg.n_experts + cfg.top_k * mlp(),
        "mamba": mamba,
        "attn_shared": lambda: attn() + mlp(),
        "mlstm": mlstm,
        "slstm": slstm,
        "xattn": xattn,
        # the reference's count: self and cross attention alike over the
        # self KV length (the cross K/V projections counted, the T memory
        # keys not)
        "encdec": lambda: 2 * attn() + mlp(),
    }
    if kind not in table:
        raise NotImplementedError(f"MACs of {kind!r} layers are not ported")
    return float(table[kind]())


def exit_head_macs(cfg: ModelConfig) -> float:
    e = cfg.cascade.enhance_dim
    enh = 2 * cfg.d_model * e if e else 0
    return float(enh + cfg.d_model * cfg.vocab_size)


def segment_macs_per_token(cfg: ModelConfig, kv_len: int) -> List[float]:
    """Cumulative decode MACs after each cascade component (incl. its head)."""
    kinds = layer_kinds(cfg)
    prefix = []
    total = 0.0
    for start, end in cfg.segments:
        for i in range(start, end):
            total += _layer_macs_per_token(cfg, kinds[i], kv_len)
        prefix.append(total + exit_head_macs(cfg))
    return prefix


def param_count(cfg: ModelConfig) -> float:
    """Approximate parameter count N (for 6·N·D roofline accounting): the
    embedding and an untied head, every layer's weights (an attn_shared
    invocation its LoRA deltas only), the hybrid's shared block once and
    the audio encoder's layers."""
    kinds = layer_kinds(cfg)
    total = cfg.vocab_size * cfg.d_model        # embed
    total += cfg.vocab_size * cfg.d_model       # untied lm head
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads

    def attn_p():
        return d * H * hd + 2 * d * KV * hd + H * hd * d

    def mlp_p():
        return (3 if cfg.act == "swiglu" else 2) * d * cfg.d_ff

    def mamba_p():
        di, nh, cc = ssm_dims(cfg)
        return d * (2 * di + 2 * cfg.ssm_state + nh) + cfg.ssm_conv * cc \
            + di * d

    per = {
        "dense": lambda: attn_p() + mlp_p(),
        "moe": lambda: attn_p() + d * cfg.n_experts
        + cfg.n_experts * mlp_p(),
        "mamba": mamba_p,
        "attn_shared": lambda: 6 * 16 * d,       # LoRA only; shared block once
        "mlstm": lambda: (lambda di, h, p: d * 2 * di + 3 * di * di
                          + 2 * di * cfg.n_heads + di * d)(*mlstm_dims(cfg)),
        "slstm": lambda: d * 4 * d + 4 * d * (d // cfg.n_heads)
        + d * (4 * d) // 3 + ((4 * d) // 3) * d,
        "xattn": lambda: attn_p() + mlp_p(),
        "encdec": lambda: 2 * attn_p() + mlp_p(),
    }
    for k in kinds:
        total += per[k]()
    if cfg.family == "hybrid":
        total += attn_p() + mlp_p()              # the shared block itself
    if cfg.family == "audio":
        total += cfg.encoder_layers * (attn_p() + mlp_p())
    return float(total)



def active_param_count(cfg: ModelConfig) -> float:
    """Active parameters per token (MoE: top_k of n_experts)."""
    if not cfg.n_experts:
        return param_count(cfg)
    d = cfg.d_model
    expert_p = (3 if cfg.act == "swiglu" else 2) * d * cfg.d_ff
    inactive = (cfg.n_experts - cfg.top_k) * expert_p * cfg.n_layers
    return param_count(cfg) - inactive


def model_flops(cfg: ModelConfig, n_tokens: int, training: bool) -> float:
    """MODEL_FLOPS = (6 if training else 2) · N_active · tokens (the
    roofline's useful-work count)."""
    mult = 6.0 if training else 2.0
    return mult * active_param_count(cfg) * n_tokens
