"""whisper-tiny — encoder-decoder transformer backbone [arXiv:2212.04356].

The mel-spectrogram + conv frontend is a STUB, as in the reference: the
encoder consumes precomputed frame embeddings of shape (batch,
n_audio_frames, d_model) (``models/model.py:extra_input_shapes``).  The
cascade runs on the decoder.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,                # decoder layers
    encoder_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    n_audio_frames=1500,
    norm="layernorm",
    act="gelu",
    rope_theta=0.0,            # learned absolute positions, no RoPE
    max_seq_len=448,
    source="arXiv:2212.04356",
))
