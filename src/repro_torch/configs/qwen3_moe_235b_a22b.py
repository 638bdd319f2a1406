"""qwen3-moe-235b-a22b — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,                 # per-expert intermediate size
    vocab_size=151936,
    head_dim=128,
    n_experts=128,
    top_k=8,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-30B-A3B",
))
