"""Model configuration for the PyTorch port (counterpart of ``repro.config``).

A :class:`ModelConfig` describes one decoder-only transformer whose layers
are global or local (sliding-window) attention blocks.  Only the fields
those stacks read are kept; the architecture zoo's other families (MoE,
MLA, SSM, recurrent, encoder/decoder) have no port yet.  The registry and
:func:`reduce_config` follow the reference, so ``get_config(name)`` gives
the same published numbers in both packages.
"""
from __future__ import annotations

import dataclasses

# Layer kinds the port's model library can run
LAYER_KINDS = ("global", "local")


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
    rope_theta: float = 10_000.0
    rope_theta_local: float = 0.0
    # -- MLP --------------------------------------------------------------
    act: str = "silu"               # silu | gelu | relu2
    glu: bool = True                # gated (w_gate, w_up) MLP vs plain
    post_norm: bool = False         # gemma2/3: norms after each sublayer
    tie_embeddings: bool = False
    embed_scale: bool = False       # gemma: embeddings scaled by sqrt(d_model)
    v_head_dim: int = 0  # 0 -> head_dim
    # -- provenance ---------------------------------------------------------
    source: str = ""
    notes: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.v_head_dim == 0:
            object.__setattr__(self, "v_head_dim", self.head_dim)
        for k in self.pattern:
            if k not in LAYER_KINDS:
                raise ValueError(f"unknown layer kind {k!r}")

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        """Per-layer kind for the decoder stack, pattern cycled."""
        p = self.pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))


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


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Shrink a config to smoke-test size with the reference's rules: same
    pattern kinds and attention flavour, tiny dims, one full pattern period
    (at least two layers, plus a remainder layer when the full model has
    one)."""
    n_layers = max(len(cfg.pattern), 2)
    if cfg.n_layers % len(cfg.pattern):
        n_layers += 1
    n_heads = 4
    n_kv = min(cfg.n_kv_heads, n_heads)
    if n_heads % n_kv:
        n_kv = 2
    return dataclasses.replace(
        cfg,
        n_layers=n_layers,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        window=min(cfg.window, 16) if cfg.window else 0,
        v_head_dim=16,
    )
