"""Shared constants for the flash-attention kernel family.

The reference's block helpers (``block_size``/``blocks_aligned``) are not
carried over: the port's kernels mask the ragged edge themselves, so no
caller needs exact tiling.
"""
from __future__ import annotations

import torch

# Large-but-finite mask value: -inf would poison the online-softmax
# rescaling (exp(-inf - -inf) = NaN) on fully-masked rows; 0.7 * f32max
# keeps exp() underflowing to exactly 0.0 without overflow on negation.
# The CUDA sources spell the same constant as REPRO_NEG_INF.
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

# element types the CUDA kernels take, by the code their C entry points read
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def check_cuda(q, k, v, *positions):
    """Device, dtype and stride checks shared by the CUDA wrappers: one
    card, q/k/v of one supported dtype with a contiguous last dimension,
    int32 positions."""
    if q.device.type != "cuda":
        raise ValueError(f"attention kernels run on CUDA or CPU tensors, got {q.device}")
    for t in (k, v, *positions):
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share a dtype in {list(DTYPE_CODES)}, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError("q/k/v need a contiguous last dimension")
    for t in positions:
        if t.dtype != torch.int32:
            raise ValueError(f"positions and segments must be int32, got {t.dtype}")
