"""Qwen2.5-3B — dense GQA with QKV bias. [hf:Qwen/Qwen2.5-*; hf]"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=11_008,
    vocab_size=151_936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    act="silu",
    glu=True,
    tie_embeddings=True,
    source="hf:Qwen/Qwen2.5-3B",
))
