"""mixtral-8x7b — 8 experts top-2, sliding-window attention [arXiv:2401.04088]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    top_k=2,
    attn_window=4096,          # SWA per the Mixtral paper
    rope_theta=1e6,
    source="arXiv:2401.04088",
))
