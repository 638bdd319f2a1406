"""minitron-4b — width/depth-pruned Nemotron [arXiv:2407.14679]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    head_dim=128,
    act="swiglu",
    source="arXiv:2407.14679",
))
