"""RecurrentGemma-9B (Griffin) — RG-LRU + local attention, 2:1.
[arXiv:2402.19427; unverified]"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,          # MQA on the local-attention layers
    head_dim=256,
    d_ff=12_288,
    vocab_size=256_000,
    pattern=("recurrent", "recurrent", "local"),
    window=2048,
    lru_width=4096,
    conv_width=4,
    rope_theta=10_000.0,
    act="gelu",
    glu=True,
    embed_scale=True,
    tie_embeddings=True,
    source="arXiv:2402.19427",
    notes="38 = 12x(rec,rec,local) + 2 remainder recurrent layers",
))
