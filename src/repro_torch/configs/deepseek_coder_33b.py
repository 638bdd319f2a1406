"""deepseek-coder-33b — llama-arch dense GQA [arXiv:2401.14196]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    rope_theta=1e5,
    source="arXiv:2401.14196",
))
