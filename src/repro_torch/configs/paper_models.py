"""The paper's own workload table (Table 3) as runnable configs of the port.

bert-base/large, gpt-j and llama2-7b are served by the engine;
bart-base/large (encoder/decoder, read by Plane B in ``repro_torch.core``)
run through ``prefill(..., encoder_tokens=)`` and ``decode_step``, as in
the reference.
"""
from repro_torch.config import ModelConfig, register

BERT_BASE = register(ModelConfig(
    name="bert-base", family="encoder",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab_size=30_522, norm="layernorm", act="gelu", glu=False,
    qkv_bias=True, mlp_bias=True, use_rope=False, max_abs_positions=8192,
    tie_embeddings=True, source="Table 3 / arXiv:1810.04805",
))

BERT_LARGE = register(ModelConfig(
    name="bert-large", family="encoder",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab_size=30_522, norm="layernorm", act="gelu", glu=False,
    qkv_bias=True, mlp_bias=True, use_rope=False, max_abs_positions=8192,
    tie_embeddings=True, source="Table 3 / arXiv:1810.04805",
))

BART_BASE = register(ModelConfig(
    name="bart-base", family="encdec",
    n_layers=6, n_encoder_layers=6, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=50_265, norm="layernorm", act="gelu", glu=False,
    qkv_bias=True, mlp_bias=True, use_rope=False, max_abs_positions=8192,
    cross_attn_decoder=True, tie_embeddings=True,
    source="Table 3 / arXiv:1910.13461",
))

BART_LARGE = register(ModelConfig(
    name="bart-large", family="encdec",
    n_layers=12, n_encoder_layers=12, d_model=1024, n_heads=16,
    n_kv_heads=16, d_ff=4096, vocab_size=50_265, norm="layernorm",
    act="gelu", glu=False, qkv_bias=True, mlp_bias=True, use_rope=False,
    max_abs_positions=8192, cross_attn_decoder=True, tie_embeddings=True,
    source="Table 3 / arXiv:1910.13461",
))

GPT_J = register(ModelConfig(
    name="gpt-j", family="dense",
    n_layers=28, d_model=4096, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=16_384, vocab_size=50_400, act="gelu", glu=False,
    parallel_block=True, rope_theta=10_000.0,
    source="Table 3 / EleutherAI GPT-J-6B",
    notes="parallel MHA+FF formulation (paper eq. 9)",
))

LLAMA2_7B = register(ModelConfig(
    name="llama2-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=11_008,
    vocab_size=32_000, act="silu", glu=True, rope_theta=10_000.0,
    source="Table 3 / arXiv:2307.09288",
    notes="paper's Table-3 row; the paper describes it as MQA — the public "
          "7B checkpoint is MHA; the Plane-B simulator models the paper's "
          "MQA variant via its own workload descriptor",
))
