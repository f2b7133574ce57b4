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
role gives the batch and head dims.  Two placements keep a sequence split
over mesh dims of more than one rank, as the reference's do:

- a role that shards q's rows (train, prefill): each rank attends its own
  rows, at their true positions, over K/V whole along the sequence
  (:func:`_planned_rows`; under ``impl="flash"`` the prefill kernel with
  its query row offset);
- a KV cache split along its entries (decode: KV heads that do not divide
  ``model``, or no batch axis; the reference's "q replicated; KV cache
  stays sequence-sharded"): each rank attends its own entries with q
  whole, and the ranks' rows are merged by their log-sum-exp
  (:func:`_planned_split_kv`, :func:`merge_splits`).

Every other split is gathered at the boundary.  The kernels never see a
DTensor.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention.decode import (flash_decode_fwd,
                                                        flash_decode_quant_fwd)
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.parallel.api import (current_plan, even, is_dtensor, local_call, placements,
                                      planned_mesh, region_placements, shard_index,
                                      sharded_over)
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
    return_lse: bool = False,
):
    """The rows (B, Sq, Hq, hdv) in q's dtype; with ``return_lse`` also
    each row's log-sum-exp of its masked scores (B, Sq, Hq) f32,
    ``NEG_INF`` for a row with no valid entry: from the decode kernels'
    LSE output on the decode route, else from the oracle (the prefill
    kernel writes none)."""
    if impl not in ("flash", "ref"):
        raise ValueError(f"unknown attention impl {impl!r}")
    mesh = planned_mesh("attention", q, k, v, k_scale, v_scale)
    if mesh is not None:
        if return_lse:
            raise ValueError("return_lse is for a rank's own part, not a planned call")
        return _planned(mesh, q, k, v, (q_pos, kv_pos, kv_valid, segments),
                        (k_scale, v_scale), dict(kv_bits=kv_bits, causal=causal, window=window,
                                                 softcap=softcap, scale=scale, impl=impl))
    Sq, Hq = q.shape[1], q.shape[2]
    Skv, Hkv = k.shape[1], k.shape[2]
    decode = impl == "flash" and Hq % Hkv == 0 and causal and Sq == 1 \
        and q_pos is not None and kv_pos is not None
    if decode and kv_valid is not None:                 # fold the mask into kv_pos
        kv_pos, kv_valid = torch.where(kv_valid, kv_pos, -1), None
    if decode:
        kw = dict(q_pos=q_pos, kv_pos=kv_pos, window=window, softcap=softcap, scale=scale,
                  return_lse=return_lse)
    if k_scale is not None:
        if kv_bits not in (4, 8):
            raise ValueError(f"quantised KV needs kv_bits 4 or 8, got {kv_bits}")
        if decode:
            return _rows(flash_decode_quant_fwd(q, k, k_scale, v, v_scale, kv_bits=kv_bits,
                                                **kw), return_lse)
        k = dequantize_kv(k, k_scale, kv_bits).to(q.dtype)
        v = dequantize_kv(v, v_scale, kv_bits).to(q.dtype)
    if impl == "flash" and Hq % Hkv == 0:
        if decode:
            return _rows(flash_decode_fwd(q, k, v, **kw), return_lse)
        if q_pos is None and kv_pos is None and kv_valid is None and not return_lse \
                and (segments is None or Sq == Skv):
            out = flash_attention_fwd(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                segments=segments, causal=causal, window=window,
                softcap=softcap, scale=scale)
            return out.transpose(1, 2)
    return attention_ref(
        q, k, v, q_pos=q_pos, kv_pos=kv_pos, kv_valid=kv_valid,
        q_seg=segments, kv_seg=segments,
        causal=causal, window=window, softcap=softcap, scale=scale, return_lse=return_lse)


def _rows(result, return_lse):
    """A decode kernel's result as :func:`attention` returns it: the LSE
    (B, Hq) gains q's row dim."""
    if not return_lse:
        return result
    out, lse = result
    return out, lse[:, None]


def _planned(mesh, q, k, v, rows, scales, kw):
    """:func:`attention` on each rank's local shards: q/k/v (and the
    scales) sharded on their batch and head dims as the plan's
    ``act_heads`` role shards them, positions, masks and segments on their
    batch dim; the output as q.  Where the role splits q's sequence over
    mesh dims of more than one rank, each rank keeps its own rows
    (:func:`_planned_rows`); where the cache splits its entries, each rank
    keeps its own entries (:func:`_planned_split_kv`)."""
    spec = current_plan().spec("act_heads") or (None,) * 4
    role = even(placements(spec, mesh), q.shape, mesh)
    batch, heads, seq = sharded_over(role, 0), sharded_over(role, 2), sharded_over(role, 1)
    if _ranks(mesh, seq) > 1:
        return _planned_rows(mesh, q, k, v, rows, scales, kw, batch, heads, seq)
    q_pos, kv_pos, _, segments = rows
    kv_seq = [] if q_pos is None or kv_pos is None or segments is not None \
        else _entry_split(mesh, k, batch + heads)
    if kv_seq:
        return _planned_split_kv(mesh, q, k, v, rows, scales, kw, batch, heads, kv_seq)
    bh = region_placements(mesh, {0: batch, 2: heads})
    b = region_placements(mesh, {0: batch})
    args = (q, k, v, *rows, *scales)
    ins = [None if a is None else p for a, p in zip(args, (bh,) * 3 + (b,) * 4 + (bh,) * 2)]

    def local(q, k, v, q_pos, kv_pos, kv_valid, segments, k_scale, v_scale):
        return attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, kv_valid=kv_valid,
                         segments=segments, k_scale=k_scale, v_scale=v_scale, **kw)
    return local_call(local, args, ins, bh, mesh)


def _ranks(mesh, dims) -> int:
    return math.prod(mesh.size(i) for i in dims)


def _entry_split(mesh, k, taken) -> list:
    """The mesh dims of more than one rank that split ``k``'s entries
    (dim 1: a sequence-split KV cache) and that no dim of ``taken`` (q's
    batch and head dims) uses."""
    if not is_dtensor(k):
        return []
    return [i for i in sharded_over(even(k.placements, k.shape, mesh), 1)
            if mesh.size(i) > 1 and i not in taken]


def _planned_split_kv(mesh, q, k, v, rows, scales, kw, batch, heads, kv_seq):
    """Attention over a KV cache split along its entries over the mesh dims
    ``kv_seq`` (split-KV across ranks): q whole over them, each rank
    attends its own entries (their masks from their own ``kv_pos``, so
    rings, windows and softcaps stay exact; a quantised pool's codes and
    scales split alike, each rank dequantising its own) and hands its
    rows and their log-sum-exp to :func:`merge_splits`.  The cache is
    never gathered."""
    q_pos, kv_pos, kv_valid, _ = rows
    k_scale, v_scale = scales
    bh = region_placements(mesh, {0: batch, 2: heads})
    bsh = region_placements(mesh, {0: batch, 1: kv_seq, 2: heads})
    b = region_placements(mesh, {0: batch})
    bs = region_placements(mesh, {0: batch, 1: kv_seq})
    groups = [mesh.get_group(i) for i in kv_seq]
    args = (q, k, v, q_pos, kv_pos, kv_valid, k_scale, v_scale)
    ins = [None if a is None else p for a, p in zip(args, (bh, bsh, bsh, b, bs, bs, bsh, bsh))]

    def local(q, k, v, q_pos, kv_pos, kv_valid, k_scale, v_scale):
        out, lse = attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, kv_valid=kv_valid,
                             k_scale=k_scale, v_scale=v_scale, return_lse=True, **kw)
        return merge_splits(out, lse, groups)
    return local_call(local, args, ins, bh, mesh)


def merge_splits(out, lse, groups):
    """The exact merge of attention over disjoint parts of the keys, one a
    rank of each of ``groups`` (process groups, reduced one after the
    other): ``out`` (B, Sq, Hq, hdv) and ``lse`` (B, Sq, Hq) f32 are this
    rank's rows and their log-sum-exp.  ``M = max_r lse_r``, ``w_r =
    exp(lse_r - M)``, ``out = sum_r w_r out_r / sum_r w_r`` in f32, rounded
    once to ``out``'s dtype.  A rank with no valid entry (``lse`` =
    ``NEG_INF``) adds nothing; a row with no valid entry anywhere has every
    ``w_r = 1`` and every ``out_r = 0``: exact zeros.  (Some rank has
    ``w_r = 1``, so the sum of weights is at least 1.)"""
    from torch.distributed import _functional_collectives as funcol
    m = lse
    for g in groups:
        m = funcol.wait_tensor(funcol.all_reduce(m, "max", g))
    part = _weighed(out, lse, m)
    for g in groups:
        part = funcol.wait_tensor(funcol.all_reduce(part, "sum", g))
    return _merged(part, out.dtype)


def _weighed(out, lse, m):
    """A part's weighted rows and its weight, ``[w out, w]`` (B, Sq, Hq,
    hdv + 1) f32, ``w = exp(lse - M)``: the two sums of the merge, in one
    tensor so that one reduction carries both."""
    w = torch.exp(lse - m)[..., None]
    return torch.cat([out.float() * w, w], dim=-1)


def _merged(part, dtype):
    return (part[..., :-1] / part[..., -1:]).to(dtype)


def _planned_rows(mesh, q, k, v, rows, scales, kw, batch, heads, seq):
    """Sequence-split attention (the reference's Megatron-SP ``act_heads``):
    each rank keeps its own rows of q and attends them, at their true
    positions (the rank's offset along the sequence plus ``arange``), over
    K/V whole along the sequence: gathered where ``kv_heads`` splits them,
    as they are where the plan replicates them.  Causal, window, softcap
    and segments stay exact across shard boundaries; the output keeps q's
    placement, and the local dK/dV, each rank's part of a sum over its own
    queries, go back to the ``kv_heads`` placement as partial sums.  Under
    ``impl="flash"`` with implicit positions the rows go to the prefill
    kernel at their offset (its plain version on CPU tensors), else to the
    oracle, whose chunks of rows bound its score blocks."""
    from torch.distributed.tensor import Partial
    q_pos, kv_pos, kv_valid, segments = rows
    k_scale, v_scale = scales
    first = shard_index(mesh, seq) * (q.shape[1] // _ranks(mesh, seq))
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
        if k_scale is not None:
            k = dequantize_kv(k, k_scale, kw["kv_bits"]).to(q.dtype)
            v = dequantize_kv(v, v_scale, kw["kv_bits"]).to(q.dtype)
        attn = dict(causal=kw["causal"], window=kw["window"], softcap=kw["softcap"],
                    scale=kw["scale"])
        if kw["impl"] == "flash" and q_pos is None and kv_valid is None \
                and q.shape[2] % k.shape[2] == 0:
            out = flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                      segments=kv_seg, q_offset=first, **attn)
            return out.transpose(1, 2)
        if q_pos is None:
            q_pos = (first + torch.arange(Sq, dtype=torch.int32, device=q.device)).expand(B, Sq)
            kv_pos = torch.arange(Skv, dtype=torch.int32, device=q.device).expand(B, Skv)
        return attention_ref(q, k, v, q_pos=q_pos, kv_pos=kv_pos, kv_valid=kv_valid,
                             q_seg=q_seg, kv_seg=kv_seg, **attn)
    return local_call(local, args, ins, bsh, mesh, grad_placements=grads)
