"""Llama-3.2-Vision-90B backbone: every fifth layer a gated cross-attention
layer over image patch embeddings (the reference's values, copied).  The
vision tower is a stub: ``prefill(..., image_embeds=)`` takes precomputed
patch embeddings (batch, n_frontend_tokens, d_model), whose keys and values
stay fixed in the cache while ``decode_step`` runs; not the serving
engine."""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    vocab_size=128_256,
    pattern=("global", "global", "global", "global", "cross"),
    frontend="vision_stub",
    n_frontend_tokens=1024,
    rope_theta=500_000.0,
    act="silu",
    glu=True,
    source="hf:meta-llama/Llama-3.2-11B-Vision (scaled per assignment)",
    notes="gated cross-attn layers (tanh gates); image KV static at decode",
))
