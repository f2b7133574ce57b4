"""Decode attention: one query token per KV slot (counterpart of the
reference's ``kernels/flash_attention/decode.py::flash_decode_fwd``).

:func:`flash_decode_fwd` is the wrapper of the CUDA kernel in
``kernels/csrc/decode.cu`` (the note there says what bounds it and how it
is laid out).  On a CUDA tensor it launches the kernel or raises; on a CPU
tensor it runs :func:`flash_decode_plain`, the plain PyTorch version with
the same numerics (f32 throughout, one cast at the end).

Positions are explicit: ``kv_pos`` is the token position of each pool
entry (``-1`` = empty) and ``q_pos`` the query position of each slot.
Causality, sliding window, per-slot lengths and empty-slot masking all
reduce to one mask on ``(q_pos, kv_pos)``; entries need not be ordered,
so ring-buffer caches work unmodified.  An empty slot gives exact zeros.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.common import (
    DTYPE_CODES, MAX_HEAD_DIM, NEG_INF, check_cuda)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = ((_P,) * 6 + (_I,) * 6 + (_L,) * 13 + (_I, _F, _F, _I, _P))


def flash_decode_plain(q, k, v, *, q_pos, kv_pos, window: int = 0,
                       softcap: float = 0.0, scale: float | None = None):
    """The plain PyTorch version of the decode kernel (same arguments)."""
    B, _, Hq, hd = q.shape
    _, Skv, Hkv, hdv = v.shape
    rep = Hq // Hkv
    scale = scale if scale is not None else hd ** -0.5
    qf = q[:, 0].float().reshape(B, Hkv, rep, hd)
    s = torch.einsum("bhrd,bkhd->bhrk", qf, k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qp = q_pos.reshape(B, 1)
    mask = (kv_pos >= 0) & (kv_pos <= qp)
    if window:
        mask &= qp - kv_pos < window
    mask = mask[:, None, None, :]                       # (B, 1, 1, Skv)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)                   # empty slot -> zeros
    out = torch.einsum("bhrk,bkhd->bhrd", p, v.float()) / l
    return out.reshape(B, 1, Hq, hdv).to(q.dtype)


def flash_decode_fwd(q, k, v, *, q_pos, kv_pos, window: int = 0,
                     softcap: float = 0.0, scale: float | None = None):
    """q (B, 1, Hq, hd), pool k/v (B, Skv, Hkv, hd|hdv), q_pos (B, 1) and
    kv_pos (B, Skv) int32 -> (B, 1, Hq, hdv) in q's dtype."""
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, hdv = v.shape
    if Sq != 1:
        raise ValueError(f"decode kernel needs Sq == 1, got {Sq}")
    if Hq % Hkv:
        raise ValueError(f"Hq ({Hq}) must be a multiple of Hkv ({Hkv})")
    if k.shape != (B, Skv, Hkv, hd) or tuple(q_pos.shape) != (B, 1) \
            or tuple(kv_pos.shape) != (B, Skv):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} q_pos {tuple(q_pos.shape)} "
                         f"kv_pos {tuple(kv_pos.shape)}")
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                  window=window, softcap=softcap, scale=scale)
    check_cuda(q, k, v, q_pos, kv_pos)
    if max(hd, hdv) > MAX_HEAD_DIM or hd % 8 or hdv % 8:
        raise ValueError(f"head dims must be multiples of 8 up to "
                         f"{MAX_HEAD_DIM}, got {hd}/{hdv}")
    vec = 16 // k.element_size()       # the kernel reads K rows in 16-byte loads
    if k.data_ptr() % 16 or any(s % vec for s in k.stride()[:3]):
        raise ValueError("the decode kernel needs 16-byte aligned K rows")
    scale = scale if scale is not None else hd ** -0.5
    out = torch.empty((B, 1, Hq, hdv), dtype=q.dtype, device=q.device)
    fn = build.bind("decode", "repro_decode_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
             kv_pos.data_ptr(), out.data_ptr(), B, Skv, Hq, Hkv, hd, hdv,
             q.stride(0), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2), q_pos.stride(0),
             kv_pos.stride(0), kv_pos.stride(1), out.stride(0), out.stride(2),
             int(window), float(softcap), float(scale), DTYPE_CODES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode attention kernel launch failed: cudaError {err}")
    flash_decode_fwd.launches += 1
    return out


flash_decode_fwd.launches = 0
