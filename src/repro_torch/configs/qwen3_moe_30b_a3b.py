"""Qwen3-30B-A3B — MoE, 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,            # the per-expert intermediate size
    d_ff_expert=768,
    vocab_size=151_936,
    n_experts=128,
    top_k=8,
    n_shared_experts=0,
    qk_norm=True,
    rope_theta=1_000_000.0,
    act="silu",
    glu=True,
    source="hf:Qwen/Qwen3-30B-A3B",
    notes="all layers MoE; per-head RMS q/k norm; GQA kv=4",
))
