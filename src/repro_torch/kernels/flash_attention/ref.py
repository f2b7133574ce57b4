"""Plain-PyTorch oracle for attention (counterpart of the reference's
``kernels/flash_attention/ref.py``).

Supports GQA/MQA, causal + sliding-window masks, gemma-style logit
softcap, explicit position vectors (slotted and ring-buffer KV caches),
``kv_valid`` and packed-segment masking (ragged prefill: a query never
attends across a prompt boundary).  Fully-masked rows give exact zeros.

Besides being the test oracle it is an execution path: chunked-prefill
attention (``Sq > 1`` with explicit positions) runs here on the card too,
as the reference sends it to its oracle on a TPU — there is no kernel to
port for that route.  Like the reference, the probabilities are cast to
``v.dtype`` before the value product.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.common import NEG_INF


def _mask(q_pos, kv_pos, kv_valid, causal, window, q_seg=None, kv_seg=None):
    """(B, Sq, Skv) bool — True = attend."""
    m = torch.ones((q_pos.shape[0], q_pos.shape[1], kv_pos.shape[1]),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= kv_pos[:, None, :] <= q_pos[:, :, None]
    if window:
        m &= q_pos[:, :, None] - kv_pos[:, None, :] < window
    if kv_valid is not None:
        m &= kv_valid[:, None, :]
    if q_seg is not None:
        # pad rows (id -1) are fully masked -> exact zero outputs
        m &= (q_seg[:, :, None] == kv_seg[:, None, :]) & (q_seg[:, :, None] >= 0)
    return m


def attention_ref(
    q: torch.Tensor,            # (B, Sq, Hq, hd)
    k: torch.Tensor,            # (B, Skv, Hkv, hd)
    v: torch.Tensor,            # (B, Skv, Hkv, hdv)
    *,
    q_pos: Optional[torch.Tensor] = None,    # (B, Sq) int32
    kv_pos: Optional[torch.Tensor] = None,   # (B, Skv) int32
    kv_valid: Optional[torch.Tensor] = None,  # (B, Skv) bool
    q_seg: Optional[torch.Tensor] = None,    # (B, Sq) int32 packed prompt ids
    kv_seg: Optional[torch.Tensor] = None,   # (B, Skv) int32
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    rep = Hq // Hkv
    scale = scale if scale is not None else hd ** -0.5
    dev = q.device
    if q_pos is None:
        q_pos = torch.arange(Sq, dtype=torch.int32, device=dev).expand(B, Sq)
    if kv_pos is None:
        kv_pos = torch.arange(Skv, dtype=torch.int32, device=dev).expand(B, Skv)
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("q_seg and kv_seg must be passed together")

    mask = _mask(q_pos, kv_pos, kv_valid, causal, window, q_seg, kv_seg)
    qr = q.reshape(B, Sq, Hkv, rep, hd)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qr.float(), k.float()) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    # fully-masked rows (no valid kv) must produce zeros, not NaN
    w = torch.where(mask.any(dim=-1)[:, None, None, :, None], w, 0.0)
    out = torch.einsum("bhrqk,bkhd->bqhrd", w.to(v.dtype), v)
    return out.reshape(B, Sq, Hq, v.shape[-1])
