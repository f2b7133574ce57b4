"""DeepSeek-V2 236B — MLA (kv_lora=512) + MoE 160 routed top-6, 2 shared.
[arXiv:2405.04434; hf]"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,       # MLA: latent cache replaces per-head KV
    head_dim=128,         # per-head no-rope q/k dim
    d_ff=12_288,          # dense FFN used by the first_k_dense layer
    d_ff_expert=1536,
    vocab_size=102_400,
    n_experts=160,
    top_k=6,
    n_shared_experts=2,
    first_k_dense=1,
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    v_head_dim=128,
    rope_theta=10_000.0,
    act="silu",
    glu=True,
    source="arXiv:2405.04434",
    notes="MLA latent-KV cache (absorbed decode path); 2 shared experts",
))
