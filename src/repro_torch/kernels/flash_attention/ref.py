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
    q_chunk: int = 1024,
) -> torch.Tensor:
    """``q_chunk``: where it divides ``Sq`` and ``Sq`` is longer, the
    queries run in chunks of that many rows, each over every key, so the
    scores of one chunk (not all ``Sq x Skv``) are alive at a time, as the
    reference does; the result is the same."""
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    scale = scale if scale is not None else hd ** -0.5
    dev = q.device
    if q_pos is None:
        q_pos = torch.arange(Sq, dtype=torch.int32, device=dev).expand(B, Sq)
    if kv_pos is None:
        kv_pos = torch.arange(Skv, dtype=torch.int32, device=dev).expand(B, Skv)
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("q_seg and kv_seg must be passed together")

    def attend(rows):
        qs = None if q_seg is None else q_seg[:, rows]
        mask = _mask(q_pos[:, rows], kv_pos, kv_valid, causal, window, qs, kv_seg)
        return _attend_block(q[:, rows], k, v, mask, scale, softcap)

    if q_chunk and Sq > q_chunk and Sq % q_chunk == 0:
        return torch.cat([attend(slice(i, i + q_chunk)) for i in range(0, Sq, q_chunk)],
                         dim=1)
    return attend(slice(None))


def _attend_block(q, k, v, mask, scale, softcap):
    """Masked softmax attention of q (B, Sq, Hq, hd) over k/v; ``mask``
    (B, Sq, Skv)."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    qr = q.reshape(B, Sq, Hkv, Hq // Hkv, hd)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qr.float(), k.float()) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    # fully-masked rows (no valid kv) must produce zeros, not NaN
    w = torch.where(mask.any(dim=-1)[:, None, None, :, None], w, 0.0)
    out = torch.einsum("bhrqk,bkhd->bqhrd", w.to(v.dtype), v)
    return out.reshape(B, Sq, Hq, v.shape[-1])
