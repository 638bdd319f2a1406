"""zamba2-1.2b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    shared_attn_every=6,       # one shared full-attention block every 6 Mamba2 layers
    source="arXiv:2411.15242",
))
