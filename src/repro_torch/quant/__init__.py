"""Quantisation plane of the port: int8 / packed-int4 weights, quantised
KV caches and the fused dequant-matmul (see ``quant/core.py``)."""
from repro_torch.quant.core import (  # noqa: F401
    KV_BITS, QMAX, QUANT_PARAM_KEYS, WEIGHT_BITS, XBAR, QuantTensor,
    dequantize, dequantize_kv, fake_quantize_params, kv_cache_bits,
    pack_int4, quantize, quantize_kv, quantize_kv_cache, quantize_params,
    quantize_weights, unpack_int4)
from repro_torch.quant.ops import qdense, quant_matmul  # noqa: F401
