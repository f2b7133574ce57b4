"""Minitron-8B — width-pruned Nemotron-4 (squared-ReLU MLP, no GLU).
[arXiv:2407.14679; hf]"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    vocab_size=256_000,
    rope_theta=10_000.0,
    act="relu2",
    glu=False,
    source="arXiv:2407.14679",
))
