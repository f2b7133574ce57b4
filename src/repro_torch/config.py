"""Model configuration for the PyTorch port (counterpart of ``repro.config``).

A :class:`ModelConfig` describes one transformer whose layers are global
or local (sliding-window) attention blocks, each followed by a dense MLP
(with or without biases, sequential or GPT-J's parallel block) or, where
:meth:`ModelConfig.moe_layer_mask` says so, a mixture-of-experts FFN,
under RMSNorm or LayerNorm, with RoPE or a learned absolute-position
table, its attention standard (MHA/GQA/MQA) or, with ``kv_lora_rank``,
DeepSeek's multi-head latent attention (:attr:`ModelConfig.is_mla`); or a
recurrent layer: a Mamba-2 SSD block (``"ssm"``) or an RG-LRU
block followed by its MLP (``"recurrent"``); or a gated cross-attention
layer (``"cross"``, the vision stack's) that attends to a source held
fixed for the request.  The encoder family (bert) is served through the
same causal serving paths.  An encoder/decoder stack (whisper, bart:
``n_encoder_layers`` and ``cross_attn_decoder``) and a stack with cross
layers run through ``prefill``/``decode_step`` with their source, not
through the serving engine, as in the reference.  The registry and
:func:`reduce_config` follow the reference, so ``get_config(name)`` gives
the same published numbers in both packages.
"""
from __future__ import annotations

import dataclasses

# Layer kinds the port's model library can run
LAYER_KINDS = ("global", "local", "recurrent", "ssm", "cross")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned (input-shape) cell: seq_len x global_batch x step kind."""

    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def is_serving(self) -> bool:
        return self.kind in ("prefill", "decode")


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # -- identity ---------------------------------------------------------
    name: str
    family: str
    # -- core dims --------------------------------------------------------
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # -- layer pattern ----------------------------------------------------
    pattern: tuple[str, ...] = ("global",)
    window: int = 0  # local-attention window (tokens)
    # -- attention flavour -------------------------------------------------
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    qk_norm: bool = False           # per-head RMS norm of q and k (gemma3)
    qkv_bias: bool = False
    mlp_bias: bool = False          # bert/bart: biases on the MLP
    rope_theta: float = 10_000.0
    rope_theta_local: float = 0.0
    use_rope: bool = True           # bert/bart: learned absolute positions
    max_abs_positions: int = 0      # the position table's size (no rope)
    # -- MLP --------------------------------------------------------------
    act: str = "silu"               # silu | gelu | relu2
    glu: bool = True                # gated (w_gate, w_up) MLP vs plain
    parallel_block: bool = False    # GPT-J: attention and MLP in parallel
    post_norm: bool = False         # gemma2/3: norms after each sublayer
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    tie_embeddings: bool = False
    embed_scale: bool = False       # gemma: embeddings scaled by sqrt(d_model)
    v_head_dim: int = 0  # 0 -> head_dim
    # -- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    first_k_dense: int = 0          # the first k layers keep the dense MLP
    capacity_factor: float = 1.25   # the capacity-sort dispatch of training (moe.py)
    # -- MLA (deepseek) ---------------------------------------------------
    kv_lora_rank: int = 0           # the latent KV cache's width; 0 -> no MLA
    q_lora_rank: int = 0            # the query's low rank (0: full rank, no port)
    rope_head_dim: int = 0          # decoupled RoPE dims a head
    # -- SSM (mamba2) -------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    conv_width: int = 4
    ssm_chunk: int = 256
    # -- recurrent (RG-LRU / griffin) --------------------------------------
    lru_width: int = 0
    # -- encoder/decoder and cross-attention sources -----------------------
    n_encoder_layers: int = 0       # 0 -> decoder-only
    encoder_pattern: tuple[str, ...] = ("global",)
    cross_attn_decoder: bool = False  # enc-dec: each decoder block has cross
    frontend: str = "none"          # none | audio_stub | vision_stub
    n_frontend_tokens: int = 1024   # the cross source's length (cross caches)
    # -- provenance ---------------------------------------------------------
    source: str = ""
    notes: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.v_head_dim == 0:
            object.__setattr__(self, "v_head_dim", self.head_dim)
        for k in self.pattern + self.encoder_pattern:
            if k not in LAYER_KINDS:
                raise ValueError(f"unknown layer kind {k!r}")

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        """Per-layer kind for the decoder stack, pattern cycled."""
        p = self.pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    @property
    def encoder_layer_kinds(self) -> tuple[str, ...]:
        """Per-layer kind for the encoder stack, pattern cycled."""
        p = self.encoder_pattern
        return tuple(p[i % len(p)] for i in range(self.n_encoder_layers))

    @property
    def attn_free(self) -> bool:
        """No attention layer of any kind (global, local or cross)."""
        kinds = set(self.layer_kinds)
        return not (kinds & {"global", "local", "cross"})

    @property
    def subquadratic(self) -> bool:
        """True iff every layer's per-token cost is bounded in context length
        (SSM / recurrent / windowed-local states).  Archs with *any* global
        full-attention layer are still run for long_500k when the rest of the
        stack bounds memory (gemma2/3 hybrid-window) — see ``supports``."""
        return not any(k == "global" for k in self.layer_kinds)

    @property
    def has_bounded_state_layers(self) -> bool:
        kinds = set(self.layer_kinds)
        return bool(kinds & {"local", "recurrent", "ssm"})

    def moe_layer_mask(self) -> tuple[bool, ...]:
        """Which layers run the MoE FFN in place of the dense MLP."""
        if not self.is_moe:
            return tuple(False for _ in range(self.n_layers))
        return tuple(i >= self.first_k_dense for i in range(self.n_layers))

    # -- parameter counting (the dry run's MODEL_FLOPS, the serving plans) -----
    def param_count(self) -> int:
        """Every element of the parameter tree ``init_params`` builds."""
        from repro_torch.models.transformer import count_params  # lazy: no torch.nn here
        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.transformer import count_params
        return count_params(self, active_only=True)

    # -- shape applicability ------------------------------------------------
    def supports(self, shape: ShapeSpec) -> tuple[bool, str]:
        """(runnable, reason-if-not) for an assigned shape cell."""
        if shape.kind == "decode" and self.family == "encoder":
            return False, "encoder-only architecture has no decode step"
        if shape.name == "long_500k":
            if self.family == "audio":
                return False, ("whisper decoder max context is 448 tokens; "
                               "524k decode is architecturally undefined")
            if not (self.subquadratic or self.has_bounded_state_layers):
                return False, ("pure full-attention stack: long_500k requires "
                               "sub-quadratic attention (per assignment)")
        if shape.kind == "train" and shape.global_batch % 8:
            return False, "global batch must divide the data axes"
        return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate config {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (registers every config)
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_REGISTRY)}") from None


def list_archs(assigned_only: bool = False) -> list[str]:
    import repro_torch.configs  # noqa: F401
    names = sorted(_REGISTRY)
    if assigned_only:
        names = [n for n in names if n in ASSIGNED_ARCHS]
    return names


ASSIGNED_ARCHS = (
    "qwen3-moe-30b-a3b",
    "deepseek-v2-236b",
    "recurrentgemma-9b",
    "whisper-large-v3",
    "qwen2.5-3b",
    "gemma3-27b",
    "gemma2-9b",
    "minitron-8b",
    "mamba2-130m",
    "llama-3.2-vision-90b",
)

PAPER_ARCHS = (
    "bert-base", "bert-large", "bart-base", "bart-large", "gpt-j", "llama2-7b",
)


def reduce_config(cfg: ModelConfig, *, seq_len: int = 32) -> ModelConfig:
    """Shrink a config to smoke-test size with the reference's rules: same
    pattern kinds and attention flavour, tiny dims, one full pattern period
    (at least two layers, plus a remainder layer when the full model has
    one); a position table of ``max(2 * seq_len, 64)`` rows where the model
    has one, two encoder layers where it has an encoder, and the SSM's,
    RG-LRU's and MLA's widths cut as the reference cuts them (state 16, SSD
    head dim 16, chunk 8, LRU width 64; latent 32, query rank 48, RoPE dims
    8), and a cross source of 16 entries.  A stack without attention keeps no KV
    heads, and one without an MLP no ``d_ff``."""
    n_layers = max(len(cfg.pattern), 2)
    if cfg.n_layers % len(cfg.pattern):
        n_layers += 1
    n_heads = 4
    n_kv = min(cfg.n_kv_heads, n_heads) if cfg.n_kv_heads else 0
    if n_kv and n_heads % n_kv:
        n_kv = 2 if n_heads % 2 == 0 else 1
    return dataclasses.replace(
        cfg,
        n_layers=n_layers,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=96 if cfg.d_ff else 0,
        vocab_size=256,
        window=min(cfg.window, 16) if cfg.window else 0,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        d_ff_expert=32 if cfg.d_ff_expert else 0,
        kv_lora_rank=32 if cfg.kv_lora_rank else 0,
        q_lora_rank=48 if cfg.q_lora_rank else 0,
        rope_head_dim=8 if cfg.rope_head_dim else 0,
        v_head_dim=16,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=8,
        lru_width=64 if cfg.lru_width else 0,
        n_encoder_layers=2 if cfg.n_encoder_layers else 0,
        max_abs_positions=max(seq_len * 2, 64) if cfg.max_abs_positions else 0,
        n_frontend_tokens=16,
        first_k_dense=min(cfg.first_k_dense, 1),
    )


def flops_per_token(cfg: ModelConfig) -> float:
    """~6*N_active for training, per token (used for MODEL_FLOPS)."""
    return 6.0 * cfg.active_param_count()
