"""Mamba2-130M — attention-free SSD (state-space duality).
[arXiv:2405.21060; unverified]"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,                 # attention-free; the mamba block is the layer
    vocab_size=50_280,
    pattern=("ssm",),
    ssm_state=128,
    ssm_expand=2,           # d_inner = 1536
    ssm_head_dim=64,        # 24 SSD heads
    ssm_groups=1,
    conv_width=4,
    ssm_chunk=256,
    use_rope=False,
    tie_embeddings=True,
    source="arXiv:2405.21060",
    notes="long_500k runs (O(1) state per token); attention plane "
          "inapplicable — see DESIGN.md §Arch-applicability",
))
