"""Flash-attention forward for prefill, contiguous and packed/ragged
(counterpart of the reference's ``kernels/flash_attention/kernel.py::
flash_attention_fwd``).

:func:`flash_attention_fwd` is the wrapper of the CUDA kernel in
``kernels/csrc/prefill.cu`` (the note there says what bounds it and how it
is laid out).  On a CUDA tensor it launches the kernel or raises; on a CPU
tensor it runs :func:`flash_attention_plain`, the plain PyTorch version
with the same numerics (f32 throughout, one cast at the end).

**Packed mode** (``segments=``): several prompts back-to-back in one token
stream, ``segments`` giving each token its prompt id (``-1`` = pad).  A
same-segment predicate joins the causal/window masks, so a query never
attends across a prompt boundary, and a pad query row gives exact zeros.
Segments are contiguous, so packed-index causality plus segment equality
is within-prompt causality, and the packed-index distance is the
positional distance for the window.

The public layout is the reference's ``(B, H, S, hd)``; the kernel reads
its inputs through their strides, so transposed views cost no copy.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.common import (
    DTYPE_CODES, MAX_HEAD_DIM, NEG_INF, check_cuda)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = ((_P,) * 5 + (_I,) * 7 + (_L,) * 14 + (_I, _I, _F, _F, _I, _P))


def _mask(Sq, Skv, segments, causal, window, device):
    """(B or 1, Sq, Skv) bool on packed token indices — True = attend."""
    qi = torch.arange(Sq, device=device)[:, None]
    kj = torch.arange(Skv, device=device)[None, :]
    m = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        m &= kj <= qi
    if window:
        m &= qi - kj < window
    m = m[None]
    if segments is not None:
        qs = segments[:, :, None]
        m = m & (qs == segments[:, None, :]) & (qs >= 0)   # pad q rows -> 0
    return m


def flash_attention_plain(q, k, v, *, segments=None, causal: bool = True,
                          window: int = 0, softcap: float = 0.0,
                          scale: float | None = None):
    """The plain PyTorch version of the prefill kernel (same arguments)."""
    B, Hq, Sq, hd = q.shape
    _, Hkv, Skv, hdv = v.shape
    rep = Hq // Hkv
    scale = scale if scale is not None else hd ** -0.5
    qf = q.float().reshape(B, Hkv, rep, Sq, hd)
    s = torch.einsum("bhrqd,bhkd->bhrqk", qf, k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = _mask(Sq, Skv, segments, causal, window, q.device)[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)                   # fully-masked rows -> 0
    out = torch.einsum("bhrqk,bhkd->bhrqd", p, v.float()) / l
    return out.reshape(B, Hq, Sq, hdv).to(q.dtype)


def flash_attention_fwd(q, k, v, *, segments=None, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        scale: float | None = None):
    """q (B, Hq, Sq, hd), k/v (B, Hkv, Skv, hd|hdv), optional segments
    (B, S) int32 -> (B, Hq, Sq, hdv) in q's dtype."""
    B, Hq, Sq, hd = q.shape
    _, Hkv, Skv, hdv = v.shape
    if Hq % Hkv:
        raise ValueError(f"Hq ({Hq}) must be a multiple of Hkv ({Hkv})")
    if k.shape != (B, Hkv, Skv, hd):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if segments is not None:
        if Sq != Skv:
            raise ValueError("packed-segment attention is self-attention: "
                             "Sq must equal Skv")
        if tuple(segments.shape) != (B, Sq):
            raise ValueError(f"segments {tuple(segments.shape)} != ({B}, {Sq})")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, segments=segments, causal=causal,
                                     window=window, softcap=softcap, scale=scale)
    check_cuda(q, k, v, *(() if segments is None else (segments,)))
    if max(hd, hdv) > MAX_HEAD_DIM or hd % 8 or hdv % 8:
        raise ValueError(f"head dims must be multiples of 8 up to "
                         f"{MAX_HEAD_DIM}, got {hd}/{hdv}")
    scale = scale if scale is not None else hd ** -0.5
    # written as (B, Sq, Hq, hdv): the caller's transpose back is free
    out = torch.empty((B, Sq, Hq, hdv), dtype=q.dtype, device=q.device)
    seg = segments
    fn = build.bind("prefill", "repro_prefill_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             None if seg is None else seg.data_ptr(), out.data_ptr(),
             B, Sq, Skv, Hq, Hkv, hd, hdv,
             q.stride(0), q.stride(2), q.stride(1),
             k.stride(0), k.stride(2), k.stride(1),
             v.stride(0), v.stride(2), v.stride(1),
             0 if seg is None else seg.stride(0),
             0 if seg is None else seg.stride(1),
             out.stride(0), out.stride(1), out.stride(2),
             int(causal), int(window), float(softcap), float(scale),
             DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"prefill attention kernel launch failed: cudaError {err}")
    flash_attention_fwd.launches += 1
    return out.transpose(1, 2)


flash_attention_fwd.launches = 0
