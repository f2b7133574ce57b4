"""Gemma-2-9B — alternating local/global attention + logit softcaps.
[arXiv:2408.00118; hf]"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14_336,
    vocab_size=256_000,
    pattern=("local", "global"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norm=True,
    rope_theta=10_000.0,
    act="gelu",
    glu=True,
    embed_scale=True,
    tie_embeddings=True,
    source="arXiv:2408.00118",
))
