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

The source has two designs, tensor cores (bf16) and CUDA cores (f32, or
head dims the tensor-core tiles do not take): :func:`prefill_plan` picks
one, with the block's shape, and :data:`kernel_launches` counts the
launches of each (design, heads a block, query rows a block, dtype).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.common import (
    DTYPE_CODES, MAX_HEAD_DIM, NEG_INF, check_cuda)
from repro_torch.kernels.scratch import sm_count

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = ((_P,) * 5 + (_I,) * 7 + (_L,) * 14 + (_I, _I, _F, _F, _I, _I, _I, _I, _P))

DESIGNS = ("cuda_core", "tensor_core")   # by the code prefill.cu reads
TC_HEAD_DIMS = (64, 128)  # head dims (q/k and v alike) the tensor-core design takes
TC_MAX_WARPS = 8          # warps a block of the tensor-core design

# the block of a call: its design, query heads (of one KV head) and query
# rows; CUDA cores always take one head and 32 rows
Plan = collections.namedtuple("Plan", "design heads rows")
Kernel = collections.namedtuple("Kernel", "design heads rows dtype")

# launches of each Kernel
kernel_launches: collections.Counter = collections.Counter()


def _aligned(*tensors) -> bool:
    """Rows in whole 16-byte pieces: what the tensor-core design copies."""
    return all(t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:-1])
               for t in tensors)


def prefill_plan(B: int, Sq: int, Hq: int, Hkv: int, hd: int, hdv: int,
                 dtype: torch.dtype, aligned: bool, sms: int) -> Plan:
    """What ``prefill.cu`` runs: tensor cores for bf16 with one head dim
    of ``TC_HEAD_DIMS`` for q/k and v and 16-byte aligned rows, else CUDA
    cores.  A tensor-core warp takes 16 query rows of one head; a block
    shares its K/V tiles among more query heads of its KV head, then more
    16-row tiles: up to 4 warps, which an SM runs on its 4 sub-partitions
    side by side, and up to 8 while the blocks still make a wave of the
    card's ``sms`` SMs."""
    if dtype != torch.bfloat16 or hd != hdv or hd not in TC_HEAD_DIMS or not aligned:
        return Plan("cuda_core", 1, 32)
    rep = Hq // Hkv

    def blocks(heads, tiles):
        return -(-Sq // (16 * tiles)) * Hkv * -(-rep // heads) * B

    def grows(heads, tiles):
        warps = heads * tiles
        return warps <= 4 or (warps <= TC_MAX_WARPS and blocks(heads, tiles) >= sms)

    heads = tiles = 1
    while heads < rep and grows(2 * heads, tiles):
        heads *= 2
    while grows(heads, 2 * tiles):
        tiles *= 2
    return Plan("tensor_core", heads, 16 * tiles)


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
    plan = prefill_plan(B, Sq, Hq, Hkv, hd, hdv, q.dtype, _aligned(q, k, v),
                        sm_count(q.device))
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
             DTYPE_CODES[q.dtype], DESIGNS.index(plan.design), plan.heads,
             plan.rows // 16, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"prefill attention kernel launch failed: cudaError {err}")
    kernel_launches[Kernel(*plan, str(q.dtype))] += 1
    flash_attention_fwd.launches += 1
    return out.transpose(1, 2)


flash_attention_fwd.launches = 0
