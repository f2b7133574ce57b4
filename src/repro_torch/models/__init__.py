from repro_torch.models.transformer import (  # noqa: F401
    Transformer,
    chunk_prefill_step,
    decode_step,
    init_cache,
    init_params,
    prefill_packed,
)
