"""Dispatch wrapper for attention (counterpart of the reference's
``kernels/flash_attention/ops.py``).

``impl``:
  - ``flash``  the kernels: the CUDA kernels on CUDA tensors, their plain
               PyTorch versions on CPU tensors (the port's default);
  - ``ref``    the plain-PyTorch oracle :func:`.ref.attention_ref`.

Routing under ``flash`` follows the reference:

- ``Sq == 1`` with explicit ``q_pos``/``kv_pos`` (causal) — the decode
  kernel :func:`.decode.flash_decode_fwd`.  An explicit ``kv_valid`` mask
  is folded into ``kv_pos`` first (masked entries become -1);
- implicit positions, including segmented (packed) self-attention — the
  prefill kernel :func:`.kernel.flash_attention_fwd`;
- everything else (chunked prefill: ``Sq > 1`` with explicit positions) —
  the oracle, on the card too, as the reference does on a TPU.

``k_scale``/``v_scale`` switch K/V to the quantised pool: ``k``/``v``
carry int8 codes (two int4 codes a byte along the head dim for
``kv_bits=4``) with per-(entry, head) f32 scales.  Under ``flash`` the
decode-shaped call goes to :func:`.decode.flash_decode_quant_fwd`, which
dequantises inside the kernel; every other route dequantises up front to
q's dtype and proceeds as fp.

Under a plan (:mod:`repro_torch.parallel`) the inputs are DTensors, and
the call runs through ``local_map``: each rank runs the route above on
its own batch rows and heads, at the placements the plan's ``act_heads``
role gives the batch and head dims.  A role that shards the sequence
keeps q's rows split under ``impl="ref"`` (the train step, the dry run):
each rank attends its own rows, at their true positions, over K/V whole
along the sequence.  Under ``impl="flash"`` such a role is gathered at the
boundary, since a kernel attends whole rows from position 0.  The kernels
never see a DTensor.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention.decode import (flash_decode_fwd,
                                                        flash_decode_quant_fwd)
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.parallel.api import (current_plan, even, local_call, placements, planned_mesh,
                                      region_placements, shard_index, sharded_over)
from repro_torch.quant.core import dequantize_kv


def attention(
    q: torch.Tensor,            # (B, Sq, Hq, hd)
    k: torch.Tensor,            # (B, Skv, Hkv, hd)
    v: torch.Tensor,            # (B, Skv, Hkv, hdv)
    *,
    q_pos: Optional[torch.Tensor] = None,
    kv_pos: Optional[torch.Tensor] = None,
    kv_valid: Optional[torch.Tensor] = None,
    segments: Optional[torch.Tensor] = None,   # (B, S) packed prompt ids, -1 pad
    k_scale: Optional[torch.Tensor] = None,    # (B, Skv, Hkv) quantised-KV scales
    v_scale: Optional[torch.Tensor] = None,
    kv_bits: int = 0,                          # 8 | 4 with k_scale/v_scale
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    scale: Optional[float] = None,
    impl: str = "flash",
) -> torch.Tensor:
    if impl not in ("flash", "ref"):
        raise ValueError(f"unknown attention impl {impl!r}")
    mesh = planned_mesh("attention", q, k, v, k_scale, v_scale)
    if mesh is not None:
        return _planned(mesh, q, k, v, (q_pos, kv_pos, kv_valid, segments),
                        (k_scale, v_scale), dict(kv_bits=kv_bits, causal=causal, window=window,
                                                 softcap=softcap, scale=scale, impl=impl))
    Sq, Hq = q.shape[1], q.shape[2]
    Skv, Hkv = k.shape[1], k.shape[2]
    decode = impl == "flash" and Hq % Hkv == 0 and causal and Sq == 1 \
        and q_pos is not None and kv_pos is not None
    if decode and kv_valid is not None:                 # fold the mask into kv_pos
        kv_pos, kv_valid = torch.where(kv_valid, kv_pos, -1), None
    if k_scale is not None:
        if kv_bits not in (4, 8):
            raise ValueError(f"quantised KV needs kv_bits 4 or 8, got {kv_bits}")
        if decode:
            return flash_decode_quant_fwd(
                q, k, k_scale, v, v_scale, kv_bits=kv_bits, q_pos=q_pos, kv_pos=kv_pos,
                window=window, softcap=softcap, scale=scale)
        k = dequantize_kv(k, k_scale, kv_bits).to(q.dtype)
        v = dequantize_kv(v, v_scale, kv_bits).to(q.dtype)
    if impl == "flash" and Hq % Hkv == 0:
        if decode:
            return flash_decode_fwd(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                    window=window, softcap=softcap, scale=scale)
        if q_pos is None and kv_pos is None and kv_valid is None \
                and (segments is None or Sq == Skv):
            out = flash_attention_fwd(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                segments=segments, causal=causal, window=window,
                softcap=softcap, scale=scale)
            return out.transpose(1, 2)
    return attention_ref(
        q, k, v, q_pos=q_pos, kv_pos=kv_pos, kv_valid=kv_valid,
        q_seg=segments, kv_seg=segments,
        causal=causal, window=window, softcap=softcap, scale=scale)


def _planned(mesh, q, k, v, rows, scales, kw):
    """:func:`attention` on each rank's local shards: q/k/v (and the
    scales) sharded on their batch and head dims as the plan's
    ``act_heads`` role shards them, positions, masks and segments on their
    batch dim; the output as q.  Where the role splits the sequence over
    mesh dims of more than one rank, ``impl="ref"`` keeps q's rows split
    (:func:`_planned_rows`) and ``impl="flash"`` gathers them."""
    spec = current_plan().spec("act_heads") or (None,) * 4
    role = even(placements(spec, mesh), q.shape, mesh)
    batch, heads, seq = sharded_over(role, 0), sharded_over(role, 2), sharded_over(role, 1)
    if kw["impl"] == "ref" and math.prod(mesh.size(i) for i in seq) > 1:
        return _planned_rows(mesh, q, k, v, rows, scales, kw, batch, heads, seq)
    bh = region_placements(mesh, {0: batch, 2: heads})
    b = region_placements(mesh, {0: batch})
    args = (q, k, v, *rows, *scales)
    ins = [None if a is None else p for a, p in zip(args, (bh,) * 3 + (b,) * 4 + (bh,) * 2)]

    def local(q, k, v, q_pos, kv_pos, kv_valid, segments, k_scale, v_scale):
        return attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, kv_valid=kv_valid,
                         segments=segments, k_scale=k_scale, v_scale=v_scale, **kw)
    return local_call(local, args, ins, bh, mesh)


def _planned_rows(mesh, q, k, v, rows, scales, kw, batch, heads, seq):
    """Sequence-split attention (the reference's Megatron-SP ``act_heads``):
    each rank keeps its own rows of q and attends them, at their true
    positions (the rank's offset along the sequence plus ``arange``), over
    K/V whole along the sequence: gathered where ``kv_heads`` splits them,
    as they are where the plan replicates them.  Causal, window, softcap
    and segments stay exact across shard boundaries; the output keeps q's
    placement, and the local dK/dV, each rank's part of a sum over its own
    queries, go back to the ``kv_heads`` placement as partial sums."""
    from torch.distributed.tensor import Partial
    q_pos, kv_pos, kv_valid, segments = rows
    k_scale, v_scale = scales
    first = shard_index(mesh, seq) * (q.shape[1] // math.prod(mesh.size(i) for i in seq))
    bsh = region_placements(mesh, {0: batch, 1: seq, 2: heads})
    bh = region_placements(mesh, {0: batch, 2: heads})
    bs = region_placements(mesh, {0: batch, 1: seq})
    b = region_placements(mesh, {0: batch})
    kv_grad = tuple(Partial() if i in seq else p for i, p in enumerate(bh))
    args = (q, k, v, q_pos, kv_pos, kv_valid, segments, segments, k_scale, v_scale)
    ins = (bsh, bh, bh, bs, b, b, bs, b, bh, bh)
    grads = (bsh, kv_grad, kv_grad, bs, b, b, bs, b, kv_grad, kv_grad)
    ins, grads = ([None if a is None else p for a, p in zip(args, pl)] for pl in (ins, grads))

    def local(q, k, v, q_pos, kv_pos, kv_valid, q_seg, kv_seg, k_scale, v_scale):
        B, Sq, Skv = q.shape[0], q.shape[1], k.shape[1]
        if q_pos is None:
            q_pos = (first + torch.arange(Sq, dtype=torch.int32, device=q.device)).expand(B, Sq)
            kv_pos = torch.arange(Skv, dtype=torch.int32, device=q.device).expand(B, Skv)
        if k_scale is not None:
            k = dequantize_kv(k, k_scale, kw["kv_bits"]).to(q.dtype)
            v = dequantize_kv(v, v_scale, kw["kv_bits"]).to(q.dtype)
        return attention_ref(q, k, v, q_pos=q_pos, kv_pos=kv_pos, kv_valid=kv_valid,
                             q_seg=q_seg, kv_seg=kv_seg, causal=kw["causal"],
                             window=kw["window"], softcap=kw["softcap"], scale=kw["scale"])
    return local_call(local, args, ins, bsh, mesh, grad_placements=grads)
