"""Whisper-large-v3 backbone: an encoder/decoder whose conv frontend is a
stub (the reference's values, copied).  The encoder takes precomputed frame
embeddings (batch, frames, d_model) with sinusoidal positions; the decoder
has no position table and its tokens take sinusoidal positions too.  It
runs through ``prefill(..., frames=)`` and ``decode_step``, not the serving
engine."""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,            # decoder layers
    n_encoder_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51_866,
    cross_attn_decoder=True,
    frontend="audio_stub",
    n_frontend_tokens=1500,   # encoder length for decode-time cross caches
    use_rope=False,
    max_abs_positions=65_536,   # the reference's value; audio builds no table
    norm="layernorm",
    act="gelu",
    glu=False,
    qkv_bias=True,
    mlp_bias=True,
    tie_embeddings=True,
    source="arXiv:2212.04356",
    notes="enc-dec; long_500k skipped (decoder ctx 448 undefined at 524k)",
))
