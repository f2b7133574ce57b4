"""Gemma-3-27B — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-*; unverified]"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21_504,
    vocab_size=262_144,
    pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    qk_norm=True,
    post_norm=True,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    act="gelu",
    glu=True,
    embed_scale=True,
    tie_embeddings=True,
    source="hf:google/gemma-3-27b-pt",
    notes="long_500k runs: local layers bounded-window KV; 1-in-6 global "
          "layers hold full 524k KV (seq-sharded), O(N) per decoded token",
))
