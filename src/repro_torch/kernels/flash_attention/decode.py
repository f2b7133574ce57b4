"""Decode attention: one query token per KV slot (counterpart of the
reference's ``kernels/flash_attention/decode.py::flash_decode_fwd`` and
``flash_decode_quant_fwd``).

:func:`flash_decode_fwd` (fp pool) and :func:`flash_decode_quant_fwd`
(int8 / packed-int4 pool with per-(entry, head) scales) wrap the CUDA
kernels in ``kernels/csrc/decode.cu`` and ``decode_quant.cu`` (the notes
there say what bounds them and how they are laid out), each with its own
launch counter.  On a CUDA tensor each launches its kernel or raises; on
a CPU tensor it runs its plain PyTorch version with the same numerics
(f32 throughout, one cast at the end; the quantised pool dequantised as
``float(code) * scale``).

Positions are explicit: ``kv_pos`` is the token position of each pool
entry (``-1`` = empty) and ``q_pos`` the query position of each slot.
Causality, sliding window, per-slot lengths and empty-slot masking all
reduce to one mask on ``(q_pos, kv_pos)``; entries need not be ordered,
so ring-buffer caches work unmodified.  An empty slot gives exact zeros.

Both kernels split the pool across blocks (split-KV, merged in the same
launch): :func:`decode_splits` is their plan and :func:`split_scratch`
makes it with its workspace and tickets.  ``return_lse`` adds each query
row's log-sum-exp of its masked scores, ``(B, Hq)`` f32 (``NEG_INF`` for
a row with no valid entry): a rank of a sequence-split pool attends its
own entries and hands its rows and their LSE to the merge across ranks
(``ops.merge_splits``).  Without it the kernels write no LSE and run as
they did before it existed.  :data:`kernel_launches` (fp) and
:data:`quant_kernel_launches` count launches by kernel (q's dtype, [code
bits,] query rows a warp, value dims a lane, splits).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.common import (
    DTYPE_CODES, MAX_HEAD_DIM, NEG_INF, check_cuda)
from repro_torch.kernels.scratch import sm_count, split_tickets
from repro_torch.parallel.api import refuse_dtensor
from repro_torch.quant.core import dequantize_kv

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = ((_P,) * 9 + (_I,) * 9 + (_L,) * 13 + (_I, _F, _F, _I, _P))
_QUANT_ARGTYPES = ((_P,) * 11 + (_I,) * 9 + (_L,) * 2 + (_P,) + (_L,) * 5
                   + (_I, _F, _F, _I, _I, _P))

TILE = 32              # pool entries a tile of decode.cu and decode_quant.cu
MAX_SPLITS = 64        # splits of one unit, so the merge stays short
MAX_REP = 16           # query rows a block (a row group): 8 warps of 1 or 2 rows

Split = collections.namedtuple("Split", "splits tiles")
# one kernel of decode.cu: q's dtype, query rows a warp, value dims a lane,
# and the split count of the launch
DecodeKernel = collections.namedtuple("DecodeKernel", "dtype rows dims splits")
# one kernel of decode_quant.cu: code bits and the same
QuantKernel = collections.namedtuple("QuantKernel", "bits dtype rows dims splits")

# launches of each DecodeKernel and of each QuantKernel
kernel_launches: collections.Counter = collections.Counter()
quant_kernel_launches: collections.Counter = collections.Counter()


def decode_splits(B: int, Hkv: int, Skv: int, sms: int) -> Split:
    """How ``decode.cu`` and ``decode_quant.cu`` split the pool of each of
    their ``B * Hkv`` units (slot, KV head and row group:
    :func:`split_scratch` passes the units as ``B``, ``Hkv = 1``):
    ``splits`` blocks, each over ``tiles`` whole 32-entry tiles of pool
    indices (the last one possibly short), together covering Skv.  The
    most tiles a split for which ``B * Hkv * splits`` blocks still make a
    wave of the card's ``sms`` SMs, where the pool has tiles enough (11
    splits of 3 tiles at B = 8, Hkv = 2, Skv = 1024 on 132 SMs); one split
    when ``B * Hkv`` blocks do alone; at most ``MAX_SPLITS``."""
    ntiles = max(1, -(-Skv // TILE))
    want = -(-sms // (B * Hkv))                    # splits for one wave
    tiles = max(1, ntiles // want, -(-ntiles // MAX_SPLITS))
    return Split(-(-ntiles // tiles), tiles)


def row_groups(rep: int) -> tuple:
    """The decode kernels' cut of a KV head's ``rep`` query rows: (groups,
    rows a group), groups of ``MAX_REP`` rows above it (the last one
    possibly short), one group of ``rep`` rows otherwise."""
    rows = min(rep, MAX_REP)
    return -(-rep // rows), rows


def decode_kernel(dtype: torch.dtype, rep: int, hdv: int, splits: int) -> DecodeKernel:
    """The kernel of ``decode.cu`` that a call launches: 1 or 2 query rows
    a warp (groups of up to 8, 16 rows), 4 or 8 value dims a lane (hdv up
    to 128, 256)."""
    rows = 1 if row_groups(rep)[1] <= 8 else 2
    return DecodeKernel(str(dtype), rows, 4 if hdv <= 128 else 8, splits)


def part_floats(rows: int, hdv: int) -> int:
    """f32 of one split's part of the workspace (``split_kv.cuh``): acc
    (rows x hdv), then m and l (rows each), padded to a multiple of 4."""
    return rows * hdv + (2 * rows + 3) // 4 * 4


def part_hdv(hdv: int) -> int:
    """The row length of ``decode_quant.cu``'s parts: hdv rounded up to 8,
    whole value pieces of a lane (``decode.cu`` takes hdv a multiple of 8
    already)."""
    return -(-hdv // 8) * 8


def split_scratch(q: torch.Tensor, units: int, Skv: int, rows: int, hdv: int):
    """The split plan of a decode launch over ``units`` (slot, KV head[,
    row group]) units of ``rows`` query rows, and its scratch: (plan,
    workspace, tickets).  With one split there is no workspace and no
    ticket (None, None); else ``units * splits`` parts of
    :func:`part_floats` f32 and this stream's tickets."""
    sp = decode_splits(units, 1, Skv, sm_count(q.device))
    if sp.splits == 1:
        return sp, None, None
    ws = torch.empty((units * sp.splits * part_floats(rows, hdv),), dtype=torch.float32,
                     device=q.device)
    stream = torch.cuda.current_stream(q.device)
    return sp, ws, split_tickets(q.device, stream, units)


def quant_kernel(bits: int, dtype: torch.dtype, rep: int, hdv: int, splits: int) -> QuantKernel:
    """The kernel of ``decode_quant.cu`` that a call launches: 1 or 2
    query rows a warp (groups of up to 8, 16 rows), 4 or 8 value dims a
    lane (hdv up to 128, 256)."""
    rows = 1 if row_groups(rep)[1] <= 8 else 2
    return QuantKernel(bits, str(dtype), rows, 4 if hdv <= 128 else 8, splits)


def flash_decode_plain(q, k, v, *, q_pos, kv_pos, window: int = 0,
                       softcap: float = 0.0, scale: float | None = None,
                       return_lse: bool = False):
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
    empty = l == 0.0
    l = torch.where(empty, 1.0, l)                      # empty slot -> zeros
    out = torch.einsum("bhrk,bkhd->bhrd", p, v.float()) / l
    out = out.reshape(B, 1, Hq, hdv).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(empty, NEG_INF, m + torch.log(l))
    return out, lse.reshape(B, Hq)


def flash_decode_fwd(q, k, v, *, q_pos, kv_pos, window: int = 0,
                     softcap: float = 0.0, scale: float | None = None,
                     return_lse: bool = False):
    """q (B, 1, Hq, hd), pool k/v (B, Skv, Hkv, hd|hdv), q_pos (B, 1) and
    kv_pos (B, Skv) int32 -> (B, 1, Hq, hdv) in q's dtype; with
    ``return_lse`` also its rows' log-sum-exp (B, Hq) f32."""
    refuse_dtensor("flash_decode_fwd", q, k, v)
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
        return flash_decode_plain(q, k, v, q_pos=q_pos, kv_pos=kv_pos, window=window,
                                  softcap=softcap, scale=scale, return_lse=return_lse)
    check_cuda(q, k, v, q_pos, kv_pos)
    if max(hd, hdv) > MAX_HEAD_DIM or hd % 8 or hdv % 8:
        raise ValueError(f"head dims must be multiples of 8 up to "
                         f"{MAX_HEAD_DIM}, got {hd}/{hdv}")
    vec = 16 // k.element_size()       # the kernel copies K rows in 16-byte pieces
    if k.data_ptr() % 16 or any(s % vec for s in k.stride()[:3]):
        raise ValueError("the decode kernel needs 16-byte aligned K rows")
    scale = scale if scale is not None else hd ** -0.5
    out = torch.empty((B, 1, Hq, hdv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq), dtype=torch.float32, device=q.device) if return_lse else None
    groups, rows = row_groups(Hq // Hkv)
    sp, ws, tickets = split_scratch(q, B * Hkv * groups, Skv, rows, hdv)
    fn = build.bind("decode", "repro_decode_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
             kv_pos.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
             None if ws is None else ws.data_ptr(),
             None if tickets is None else tickets.data_ptr(), B, Skv, Hq, Hkv, hd, hdv,
             rows, sp.splits, sp.tiles, q.stride(0), q.stride(2), k.stride(0),
             k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2),
             q_pos.stride(0), kv_pos.stride(0), kv_pos.stride(1), out.stride(0),
             out.stride(2), int(window), float(softcap), float(scale),
             DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode attention kernel launch failed: cudaError {err}")
    kernel_launches[decode_kernel(q.dtype, Hq // Hkv, hdv, sp.splits)] += 1
    flash_decode_fwd.launches += 1
    return out if lse is None else (out, lse)


flash_decode_fwd.launches = 0


def flash_decode_quant_plain(q, k_q, k_s, v_q, v_s, *, kv_bits: int, q_pos, kv_pos,
                             window: int = 0, softcap: float = 0.0,
                             scale: float | None = None, return_lse: bool = False):
    """The plain PyTorch version of the quantised-pool decode kernel: the
    fp plain version over the f32-dequantised pool."""
    return flash_decode_plain(q, dequantize_kv(k_q, k_s, kv_bits),
                              dequantize_kv(v_q, v_s, kv_bits), q_pos=q_pos,
                              kv_pos=kv_pos, window=window, softcap=softcap,
                              scale=scale, return_lse=return_lse)


def flash_decode_quant_fwd(q, k_q, k_s, v_q, v_s, *, kv_bits: int, q_pos, kv_pos,
                           window: int = 0, softcap: float = 0.0,
                           scale: float | None = None, return_lse: bool = False):
    """q (B, 1, Hq, hd); codes k_q/v_q (B, Skv, Hkv, hd/pack) int8 (two int4
    codes a byte, packed along the head dim, for ``kv_bits=4``); scales
    k_s/v_s (B, Skv, Hkv) f32; q_pos (B, 1) and kv_pos (B, Skv) int32 ->
    (B, 1, Hq, hdv) in q's dtype; with ``return_lse`` also its rows'
    log-sum-exp (B, Hq) f32."""
    refuse_dtensor("flash_decode_quant_fwd", q, k_q, k_s, v_q, v_s)
    if kv_bits not in (4, 8):
        raise ValueError(f"kv_bits must be 4 or 8, got {kv_bits}")
    pack = 2 if kv_bits == 4 else 1
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, hdq = k_q.shape
    hdv = v_q.shape[-1] * pack
    if Sq != 1:
        raise ValueError(f"decode kernel needs Sq == 1, got {Sq}")
    if hdq * pack != hd:
        raise ValueError(f"codes head dim {hdq} != {hd} at {kv_bits} bits")
    if Hq % Hkv:
        raise ValueError(f"Hq ({Hq}) must be a multiple of Hkv ({Hkv})")
    if tuple(v_q.shape[:3]) != (B, Skv, Hkv) or tuple(k_s.shape) != (B, Skv, Hkv) \
            or tuple(v_s.shape) != (B, Skv, Hkv) or tuple(q_pos.shape) != (B, 1) \
            or tuple(kv_pos.shape) != (B, Skv):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k_q {tuple(k_q.shape)} "
                         f"k_s {tuple(k_s.shape)} v_q {tuple(v_q.shape)} "
                         f"v_s {tuple(v_s.shape)} q_pos {tuple(q_pos.shape)} "
                         f"kv_pos {tuple(kv_pos.shape)}")
    args = dict(kv_bits=kv_bits, q_pos=q_pos, kv_pos=kv_pos, window=window,
                softcap=softcap, scale=scale, return_lse=return_lse)
    if q.device.type == "cpu":
        return flash_decode_quant_plain(q, k_q, k_s, v_q, v_s, **args)
    if q.device.type != "cuda":
        raise ValueError(f"attention kernels run on CUDA or CPU tensors, got {q.device}")
    for t in (k_q, k_s, v_q, v_s, q_pos, kv_pos):
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
    if q.dtype not in DTYPE_CODES or q.stride(-1) != 1:
        raise ValueError(f"q must be one of {list(DTYPE_CODES)} with a contiguous "
                         f"last dimension, got {q.dtype}")
    if k_q.dtype != torch.int8 or v_q.dtype != torch.int8 \
            or k_s.dtype != torch.float32 or v_s.dtype != torch.float32:
        raise ValueError("codes must be int8 and scales f32")
    if q_pos.dtype != torch.int32 or kv_pos.dtype != torch.int32:
        raise ValueError("positions must be int32")
    if k_q.stride(-1) != 1 or v_q.stride(-1) != 1:
        raise ValueError("code planes need a contiguous last dimension")
    if max(hd, hdv) > MAX_HEAD_DIM:
        raise ValueError(f"head dims up to {MAX_HEAD_DIM}, got {hd}/{hdv}")
    scale = scale if scale is not None else hd ** -0.5
    out = torch.empty((B, 1, Hq, hdv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq), dtype=torch.float32, device=q.device) if return_lse else None
    groups, rows = row_groups(Hq // Hkv)
    sp, ws, tickets = split_scratch(q, B * Hkv * groups, Skv, rows, part_hdv(hdv))
    strides = (ctypes.c_longlong * 12)(*k_q.stride()[:3], *v_q.stride()[:3],
                                       *k_s.stride(), *v_s.stride())
    fn = build.bind("decode_quant", "repro_decode_attention_quant", _QUANT_ARGTYPES)
    err = fn(q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
             v_s.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(), None if ws is None else ws.data_ptr(),
             None if tickets is None else tickets.data_ptr(),
             B, Skv, Hq, Hkv, hd, hdv, rows, sp.splits, sp.tiles, q.stride(0), q.stride(2),
             ctypes.cast(strides, ctypes.c_void_p), q_pos.stride(0),
             kv_pos.stride(0), kv_pos.stride(1), out.stride(0), out.stride(2),
             int(window), float(softcap), float(scale), kv_bits, DTYPE_CODES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"quantised decode attention kernel launch failed: "
                           f"cudaError {err}")
    quant_kernel_launches[quant_kernel(kv_bits, q.dtype, Hq // Hkv, hdv, sp.splits)] += 1
    flash_decode_quant_fwd.launches += 1
    return out if lse is None else (out, lse)


flash_decode_quant_fwd.launches = 0
