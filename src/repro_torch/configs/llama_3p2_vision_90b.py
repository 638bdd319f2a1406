"""llama-3.2-vision-90b — cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision].

The ViT vision encoder + projector is a STUB, as in the reference: the
model takes precomputed image patch embeddings of shape (batch,
n_image_tokens, d_model) (``models/model.py:extra_input_shapes``).  Every
5th decoder layer carries gated cross-attention to the image tokens (20
cross-attn layers out of 100, mirroring the 11B card's 1:5 ratio).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_every=5,
    n_image_tokens=1600,       # 1 tile x (40x40) patches, projector output
    rope_theta=5e5,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
))
