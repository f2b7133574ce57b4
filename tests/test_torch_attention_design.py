"""The order of operations of the port's redesigned attention kernels,
rendered in plain PyTorch on the CPU, against the plain versions behind the
wrappers and the reference's Pallas kernels in interpret mode, on the same
seeded numpy inputs.

- ``kernels/csrc/decode.cu`` (fp pool) and ``decode_quant.cu`` (int8 /
  int4 pool): split-KV.  Each split of a (slot, KV head[, group of 16
  query rows]) sweeps a contiguous range of pool indices in 32-entry tiles
  with its own f32 online softmax (m, l, acc); the splits are merged in
  split order.  Their plan, ``decode_splits``, its workspace and the
  kernels' names are checked here too.
- ``kernels/csrc/prefill.cu``'s tensor-core design: bf16 Q.K^T products
  summed in f32, an online softmax over 32-key tiles, and P split into
  three bf16 terms, whose sum is P exactly, for the P.V product.  Its plan,
  ``prefill_plan``, is checked here too.

Tolerances: 2e-5 in f32 (the reference's own decode-kernel pin).  The CUDA
kernels themselves are held against the plain versions on the card by
chip_smoke.py.
"""
import math
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.decode import flash_decode_fwd as jax_decode
from repro.kernels.flash_attention.decode import flash_decode_quant_fwd as jax_decode_quant
from repro.kernels.flash_attention.kernel import flash_attention_fwd as jax_prefill
from repro.quant import core as QJ
from repro_torch.kernels.flash_attention import decode as D
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.common import NEG_INF

T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731  numpy/jax -> torch
F32_TOL = 2e-5
H100_SMS = 132


# ---------------------------------------------------------------------------
# decode.cu and decode_quant.cu: split-KV
# ---------------------------------------------------------------------------

def _kv_codes(q: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., hd) integer codes decoded as decode_quant.cu decodes a code
    byte: int8 as byte ^ 0x80 = code + 128; int4 byte i holding dimension
    2i in its low nibble and 2i + 1 in its high one, each as nibble ^ 8 =
    code + 8; then minus the bias."""
    b = q.to(torch.int32) & 0xFF
    if bits == 8:
        return ((b ^ 0x80) - 128).float()
    lo, hi = ((b & 0x0F) ^ 8) - 8, (((b >> 4) & 0x0F) ^ 8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(*q.shape[:-1], 2 * q.shape[-1]).float()


def split_kv_rendering_over(q, keys, values, k_scale, v_scale, *, q_pos, kv_pos, splits,
                            tiles, rows, window=0, softcap=0.0, scale=None):
    """The split-KV order of operations over a pool read as f32 ``keys``
    and ``values`` (B, Skv, Hkv, hd|hdv) with a factor per (entry, head),
    ``k_scale`` and ``v_scale`` (B, Skv, Hkv): per (slot, KV head, group of
    ``rows`` query rows) and split, the split's 32-entry tiles of pool
    indices in order, skipping tiles with no valid entry; scores (q . key)
    * k_scale * scale, then softcap and mask; an online-softmax update per
    tile with v_scale folded into p and a masked entry's values zero-filled
    (as the kernels copy them); then the splits merged in split order."""
    B, _, Hq, hd = q.shape
    _, Skv, Hkv, hdv = values.shape
    rep = Hq // Hkv
    scale = scale if scale is not None else hd ** -0.5
    out = torch.zeros((B, 1, Hq, hdv), dtype=torch.float32)
    TILE = D.TILE
    for b in range(B):
        qp = int(q_pos[b, 0])
        valid = (kv_pos[b] >= 0) & (kv_pos[b] <= qp)
        if window:
            valid &= qp - kv_pos[b] < window
        for h in range(Hkv):
            for r0 in range(h * rep, (h + 1) * rep, rows):            # a unit's rows
                qr = q[b, 0, r0:min(r0 + rows, (h + 1) * rep)].float()
                n = qr.shape[0]
                parts = []
                for s in range(splits):
                    m = torch.full((n,), NEG_INF)
                    l = torch.zeros(n)
                    acc = torch.zeros((n, hdv))
                    for t in range(s * tiles, min((s + 1) * tiles, -(-Skv // TILE))):
                        j = torch.arange(t * TILE, min((t + 1) * TILE, Skv))
                        ok = valid[j]
                        if not ok.any():
                            continue                                  # never loaded
                        x = (qr @ keys[b, j, h].T) * k_scale[b, j, h] * scale
                        if softcap:
                            x = softcap * torch.tanh(x / softcap)
                        x = torch.where(ok, x, NEG_INF)
                        m_new = torch.maximum(m, x.amax(dim=1))
                        p = torch.where(ok, torch.exp(x - m_new[:, None]), 0.0)
                        alpha = torch.exp(m - m_new)
                        l = l * alpha + p.sum(dim=1)
                        m = m_new
                        vals = torch.where(ok[:, None], values[b, j, h], 0.0)
                        acc = acc * alpha[:, None] + (p * v_scale[b, j, h]) @ vals
                    parts.append((m, l, acc))
                M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
                o, L = torch.zeros((n, hdv)), torch.zeros(n)
                for m, l, acc in parts:                               # split order
                    f = torch.exp(m - M)
                    L = L + l * f
                    o = o + acc * f[:, None]
                L = torch.where(L == 0, 1.0, L)                       # empty slot -> zeros
                out[b, 0, r0:r0 + n] = o / L[:, None]
    return out


def split_kv_rendering(q, k_q, k_s, v_q, v_s, *, kv_bits, q_pos, kv_pos, splits, tiles,
                       window=0, softcap=0.0, scale=None):
    """decode_quant.cu's order of operations: the codes decoded as the
    kernel decodes a code byte, the scales as the factors, the rep query
    rows of a KV head in units of ``row_groups``."""
    _, rows = D.row_groups(q.shape[2] // k_q.shape[2])
    return split_kv_rendering_over(q, _kv_codes(k_q, kv_bits), _kv_codes(v_q, kv_bits), k_s,
                                   v_s, q_pos=q_pos, kv_pos=kv_pos, splits=splits,
                                   tiles=tiles, rows=rows, window=window, softcap=softcap,
                                   scale=scale)


def fp_split_kv_rendering(q, k, v, *, q_pos, kv_pos, splits, tiles, window=0, softcap=0.0,
                          scale=None):
    """decode.cu's order of operations: the fp pool in f32, factors of 1
    (exact), the rep query rows of a KV head in units of ``row_groups``."""
    ones = torch.ones(k.shape[:3])
    _, rows = D.row_groups(q.shape[2] // k.shape[2])
    return split_kv_rendering_over(q, k.float(), v.float(), ones, ones, q_pos=q_pos,
                                   kv_pos=kv_pos, splits=splits, tiles=tiles, rows=rows,
                                   window=window, softcap=softcap, scale=scale)


def _pool_positions(rng, B, Skv, *, lengths=None, ring=False, empty=()):
    """kv_pos/q_pos of a slot pool: slots of the given lengths from index
    0, or wrapped rings with holes in scrambled order; ``empty`` slots hold
    nothing."""
    kv_pos = np.full((B, Skv), -1, np.int32)
    for b in range(B):
        if b in empty:
            continue
        if ring:
            n = Skv + int(rng.integers(1, Skv))
            kv_pos[b] = rng.permutation(n - 1 - np.arange(Skv))
            kv_pos[b, rng.choice(Skv, Skv // 5, replace=False)] = -1
        else:
            kv_pos[b, :lengths[b]] = np.arange(lengths[b])
    q_pos = np.maximum(kv_pos.max(axis=1, keepdims=True), 0).astype(np.int32)
    return q_pos, kv_pos


def _quant_decode_inputs(seed, B, Skv, Hq, Hkv, hd, bits, *, lengths=None, ring=False,
                         empty=()):
    """A quantised slot pool (quantised by the reference): slots of the
    given lengths from index 0, or wrapped rings with holes in scrambled
    order; ``empty`` slots hold nothing."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
    q_pos, kv_pos = _pool_positions(rng, B, Skv, lengths=lengths, ring=ring, empty=empty)
    planes = (*QJ.quantize_kv(jnp.asarray(k), bits), *QJ.quantize_kv(jnp.asarray(v), bits))
    return q, planes, q_pos, kv_pos


_SPLIT_CASES = {  # name: (B, Skv, Hq, Hkv, hd, pool, window, softcap)
    "ring with holes": (3, 100, 8, 2, 32, dict(ring=True), 0, 0.0),
    "wholly masked splits": (3, 128, 8, 2, 32, dict(lengths=[5, 40, 128]), 0, 0.0),
    "empty slot": (3, 96, 4, 2, 32, dict(lengths=[20, 0, 96], empty=(1,)), 0, 0.0),
    "window softcap": (2, 128, 16, 1, 32, dict(lengths=[128, 77]), 24, 30.0),
    "rep1 ragged": (4, 70, 4, 4, 64, dict(ring=True), 0, 0.0),
    # the reduced configs' head dim: K code rows of 8 bytes at kv4
    "hd16": (3, 100, 8, 2, 16, dict(lengths=[100, 37, 64]), 16, 50.0),
    # code rows of 3 (kv4) and 6 (kv8) bytes, V rows short of a value piece
    "hd6": (2, 96, 4, 2, 6, dict(ring=True), 0, 0.0),
    "rep32 in row groups": (2, 128, 32, 1, 16, dict(lengths=[128, 50]), 0, 0.0),
}


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", list(_SPLIT_CASES))
def test_split_kv_rendering_matches_plain_and_pallas(case, bits):
    """Per-split online softmax over contiguous index ranges, merged in
    split order: the plain version's function and the TPU kernel's, to f32
    rounding, with the split count the plan gives on an H100."""
    B, Skv, Hq, Hkv, hd, pool, window, softcap = _SPLIT_CASES[case]
    q, planes, q_pos, kv_pos = _quant_decode_inputs(zlib.crc32(case.encode()) + bits, B,
                                                    Skv, Hq, Hkv, hd, bits, **pool)
    groups, rows = D.row_groups(Hq // Hkv)
    sp = D.decode_splits(B, Hkv * groups, Skv, H100_SMS)
    assert sp.splits > 1
    k_q, k_s, v_q, v_s = (T(p) for p in planes)
    args = dict(kv_bits=bits, q_pos=T(q_pos), kv_pos=T(kv_pos), window=window,
                softcap=softcap)
    got = split_kv_rendering(T(q), k_q, k_s, v_q, v_s, splits=sp.splits, tiles=sp.tiles,
                             **args)
    plain = D.flash_decode_quant_plain(T(q), k_q, k_s, v_q, v_s, **args)
    ref = jax_decode_quant(jnp.asarray(q), *planes, kv_bits=bits, q_pos=jnp.asarray(q_pos),
                           kv_pos=jnp.asarray(kv_pos), window=window, softcap=softcap,
                           interpret=True)
    for want in (plain.numpy(), np.asarray(ref)):
        np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)
    for b in pool.get("empty", ()):
        assert torch.all(got[b] == 0)                  # the empty slot: exact zeros
    if case == "wholly masked splits":                 # splits past slot 0's 5 entries
        tile_valid = (kv_pos[0] >= 0).reshape(-1, D.TILE).any(axis=1)
        assert not tile_valid[sp.tiles:].any()
    if case == "rep32 in row groups":                  # two full groups of 16
        assert (groups, rows) == (2, 16)


_FP_SPLIT_CASES = {  # name: (B, Skv, Hq, Hkv, hd, hdv, pool, window, softcap)
    "ring with holes": (3, 100, 8, 2, 32, 32, dict(ring=True), 0, 0.0),
    "wholly masked splits": (3, 128, 8, 2, 32, 32, dict(lengths=[5, 40, 128]), 0, 0.0),
    "empty slot": (3, 96, 4, 2, 32, 32, dict(lengths=[20, 0, 96], empty=(1,)), 0, 0.0),
    "window softcap": (2, 128, 16, 1, 32, 32, dict(lengths=[128, 77]), 24, 30.0),
    "rep1 ragged hd64 hdv48": (4, 70, 4, 4, 64, 48, dict(ring=True), 0, 0.0),
    "rep20 in row groups": (2, 128, 40, 2, 16, 16, dict(lengths=[128, 50]), 0, 0.0),
}


@pytest.mark.parametrize("case", list(_FP_SPLIT_CASES))
def test_fp_split_kv_rendering_matches_plain_and_pallas(case):
    """decode.cu's order over the fp pool (per-split online softmax over
    contiguous index ranges, masked tiles skipped, masked entries
    zero-filled, rows in groups of at most 16, splits merged in split
    order): the plain version's function and the TPU kernel's, to f32
    rounding, with the split count the plan gives on an H100."""
    B, Skv, Hq, Hkv, hd, hdv, pool, window, softcap = _FP_SPLIT_CASES[case]
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    q = rng.standard_normal((B, 1, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, hdv)).astype(np.float32)
    q_pos, kv_pos = _pool_positions(rng, B, Skv, **pool)
    groups, rows = D.row_groups(Hq // Hkv)
    sp = D.decode_splits(B, Hkv * groups, Skv, H100_SMS)
    assert sp.splits > 1
    args = dict(q_pos=T(q_pos), kv_pos=T(kv_pos), window=window, softcap=softcap)
    got = fp_split_kv_rendering(T(q), T(k), T(v), splits=sp.splits, tiles=sp.tiles, **args)
    plain = D.flash_decode_plain(T(q), T(k), T(v), **args)
    ref = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_pos=jnp.asarray(q_pos),
                     kv_pos=jnp.asarray(kv_pos), window=window, softcap=softcap,
                     interpret=True)
    for want in (plain.numpy(), np.asarray(ref)):
        np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)
    for b in pool.get("empty", ()):
        assert torch.all(got[b] == 0)                  # the empty slot: exact zeros
    if case == "wholly masked splits":                 # splits past slot 0's 5 entries
        tile_valid = (kv_pos[0] >= 0).reshape(-1, D.TILE).any(axis=1)
        assert not tile_valid[sp.tiles:].any()
    if case == "rep20 in row groups":                  # a full group of 16 and one of 4
        assert (groups, rows) == (2, 16)


@pytest.mark.parametrize("B,Hkv,Skv", [(8, 2, 1024), (3, 2, 200), (1, 1, 65536),
                                       (40, 4, 1024), (2, 1, 31), (8, 2, 1000),
                                       (16, 8, 4096), (1, 2, 96)])
def test_decode_splits_plan(B, Hkv, Skv):
    """The splits cover Skv exactly in whole 32-entry tiles, none empty;
    the serving shape (B = 8, Hkv = 2, Skv = 1024) fills a wave of the
    H100's 132 SMs; B * Hkv blocks that do alone take one split; a long
    pool takes at most MAX_SPLITS."""
    sp = D.decode_splits(B, Hkv, Skv, H100_SMS)
    ntiles = -(-Skv // D.TILE)
    assert sp.tiles >= 1 and 1 <= sp.splits <= D.MAX_SPLITS
    assert sp.splits * sp.tiles >= ntiles > (sp.splits - 1) * sp.tiles
    if B * Hkv >= H100_SMS:
        assert sp == (1, ntiles)
    elif ntiles >= -(-H100_SMS // (B * Hkv)) and ntiles // D.MAX_SPLITS < 1:
        assert B * Hkv * sp.splits >= H100_SMS
    if (B, Hkv, Skv) == (8, 2, 1024):
        assert sp == (11, 3) and B * Hkv * sp.splits == 176


def test_decode_kernel_names_rows_dims_and_splits():
    """decode.cu's kernel a call takes: query rows a warp for groups of up
    to 8, 16 rows (rep above 16 in groups of 16), value dims a lane for
    hdv up to 128, 256, and the launch's split count."""
    k = D.decode_kernel(torch.bfloat16, 8, 128, 11)
    assert k == D.DecodeKernel("torch.bfloat16", 1, 4, 11)
    assert [D.decode_kernel(torch.float32, r, 128, 1).rows
            for r in (1, 8, 9, 16, 17, 32, 40)] == [1, 1, 2, 2, 2, 2, 2]
    assert [D.row_groups(r) for r in (1, 8, 16, 17, 32, 40)] == \
        [(1, 1), (1, 8), (1, 16), (2, 16), (2, 16), (3, 16)]
    assert D.decode_kernel(torch.float32, 2, 256, 4) == \
        D.DecodeKernel("torch.float32", 1, 8, 4)


@pytest.mark.parametrize("units,Skv,rows,hdv,splits", [
    (16, 1024, 8, 128, 11),      # the serving shape (B 8, Hkv 2, rep 8)
    (8, 1024, 16, 128, 32),      # rep 32 over one KV head, B 4: two groups of 16
    (64, 300, 2, 256, 4),        # gemma2-9b's heads in f32: B 8, Hkv 8
    (160, 1024, 4, 128, 1),      # B 40, Hkv 4: one split, no scratch
])
def test_split_scratch_part_size(monkeypatch, units, Skv, rows, hdv, splits):
    """The plan-and-workspace helper both decode wrappers call: the plan of
    ``units`` units, and a workspace of ``units * splits`` parts of ``rows
    * hdv + 2 * rows`` f32 padded to 4 (split_kv.cuh's part_floats), with
    one ticket a unit; nothing at one split."""
    monkeypatch.setattr(D, "sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(D.torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(D, "split_tickets",
                        lambda device, stream, n: torch.zeros(n, dtype=torch.int32))
    sp, ws, tickets = D.split_scratch(torch.zeros(1), units, Skv, rows, hdv)
    assert sp == D.decode_splits(units, 1, Skv, H100_SMS) and sp.splits == splits
    part = rows * hdv + ((2 * rows + 3) & ~3)
    assert D.part_floats(rows, hdv) == part and part % 4 == 0
    if splits == 1:
        assert ws is None and tickets is None
    else:
        assert ws.dtype == torch.float32 and ws.numel() == units * splits * part
        assert tickets.numel() == units


def test_quant_kernel_names_rows_and_dims():
    """The kernel a call takes: query rows a warp for groups of up to 8, 16
    rows (rep above 16 in groups of 16), value dims a lane for hdv up to
    128, 256."""
    k = D.quant_kernel(8, torch.bfloat16, 8, 128, 11)
    assert k == D.QuantKernel(8, "torch.bfloat16", 1, 4, 11)
    assert [D.quant_kernel(4, torch.float32, r, 256, 1).rows for r in (1, 4, 5, 8, 9, 16)] \
        == [1, 1, 1, 1, 2, 2]
    assert D.quant_kernel(4, torch.float32, 1, 256, 1).dims == 8
    # rep 17, 20, 32, 40: groups of 16 rows, so 2 rows a warp
    assert [D.quant_kernel(8, torch.bfloat16, r, 16, 7).rows for r in (17, 20, 32, 40)] \
        == [2, 2, 2, 2]


@pytest.mark.parametrize("hdv,part", [(6, 8), (8, 8), (16, 16), (20, 24), (128, 128),
                                      (250, 256), (256, 256)])
def test_quant_parts_hold_whole_value_pieces(hdv, part):
    """decode_quant.cu's parts hold rows of hdv rounded up to 8 (a lane's
    4 or 8 value dims), so a head dim that is not a multiple of 8 keeps
    whole float4s for the merge, which writes out only the first hdv."""
    assert D.part_hdv(hdv) == part and part % 4 == 0


# ---------------------------------------------------------------------------
# prefill.cu: the tensor-core design
# ---------------------------------------------------------------------------

def bf16_terms(p: torch.Tensor, terms: int) -> list:
    """p (f32) as ``terms`` bf16 values, each the rounding of what the
    previous ones leave: three give p exactly (24 significant bits, 8 a
    term, every remainder exact in f32)."""
    out = []
    for _ in range(terms):
        t = p.to(torch.bfloat16).float()
        out.append(t)
        p = p - t
    return out


def tensor_core_prefill_rendering(q, k, v, *, segments=None, causal=True, window=0,
                                  softcap=0.0, scale=None, terms=3):
    """The tensor-core design's order of operations, for each 16-row tile
    of each query head: the 32-key tiles of its block's range in order,
    S = q . k^T of bf16 values summed in f32, scale, softcap, mask; an
    online-softmax update per tile; O += P_1 . V + P_2 . V + P_3 . V, P's
    bf16 terms (``terms`` of them)."""
    B, Hq, Sq, hd = q.shape
    _, Hkv, Skv, hdv = v.shape
    rep = Hq // Hkv
    scale = scale if scale is not None else hd ** -0.5
    qb, kb, vb = (t.to(torch.bfloat16).float() for t in (q, k, v))
    assert torch.equal(qb, q.float()) and torch.equal(kb, k.float()), "inputs bf16-exact"
    mask = K._mask(Sq, Skv, segments, causal, window, q.device)
    mask = mask.expand(B, Sq, Skv)
    out = torch.zeros((B, Hq, Sq, hdv))
    for b in range(B):
        for h in range(Hq):
            for q0 in range(0, Sq, 16):
                rows = slice(q0, min(q0 + 16, Sq))
                k_end = min(Skv, rows.stop) if causal else Skv
                k_begin = max(0, q0 - window + 1) // 32 * 32 if window else 0
                n = rows.stop - q0
                m, l = torch.full((n,), NEG_INF), torch.zeros(n)
                acc = torch.zeros((n, hdv))
                for k0 in range(k_begin, k_end, 32):
                    keys = slice(k0, min(k0 + 32, Skv))
                    ok = mask[b, rows, keys]
                    if not ok.any():
                        continue
                    x = (qb[b, h, rows] @ kb[b, h // rep, keys].T) * scale
                    if softcap:
                        x = softcap * torch.tanh(x / softcap)
                    x = torch.where(ok, x, NEG_INF)
                    m_new = torch.maximum(m, x.amax(dim=1))
                    alpha = torch.exp(m - m_new)
                    p = torch.where(ok, torch.exp(x - m_new[:, None]), 0.0)
                    l = l * alpha + p.sum(dim=1)
                    m = m_new
                    vt = vb[b, h // rep, keys]
                    acc = acc * alpha[:, None]
                    for pt in bf16_terms(p, terms):
                        acc = acc + pt @ vt
                out[b, h, rows] = acc / torch.where(l == 0, 1.0, l)[:, None]
    return out


def _segments(S, lens):
    seg = np.full((1, S), -1, np.int32)
    off = 0
    for i, n in enumerate(lens):
        seg[0, off:off + n] = i
        off += n
    return seg


_PREFILL_CASES = {  # name: (S, Hq, Hkv, hd, lens or None, causal, window, softcap)
    "segmented rep8": (64, 8, 1, 32, (20, 25, 10), True, 0, 0.0),
    "pad-only tiles": (128, 4, 2, 32, (40, 30), True, 0, 0.0),
    "ragged S rep1": (75, 2, 2, 48, (30, 33), True, 0, 0.0),
    "window softcap": (96, 4, 2, 32, (50, 40), True, 20, 10.0),
    "no segments causal": (80, 8, 1, 16, None, True, 0, 0.0),
    "no segments full": (48, 2, 2, 32, None, False, 0, 0.0),
}


@pytest.mark.parametrize("case", list(_PREFILL_CASES))
def test_tensor_core_prefill_rendering_matches_plain_and_pallas(case):
    """bf16-exact inputs, f32 sums, an online softmax over the kernel's
    32-key tiles and P as three bf16 terms: the plain version's function
    and the TPU kernel's, within f32 rounding; one bf16 P would miss by
    far more."""
    S, Hq, Hkv, hd, lens, causal, window, softcap = _PREFILL_CASES[case]
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    bf = lambda a: T(a).to(torch.bfloat16).float().numpy()  # noqa: E731
    q = bf(rng.standard_normal((1, Hq, S, hd)).astype(np.float32))
    k = bf(rng.standard_normal((1, Hkv, S, hd)).astype(np.float32))
    v = bf(rng.standard_normal((1, Hkv, S, hd)).astype(np.float32) * 4)
    seg = None if lens is None else _segments(S, lens)
    tseg = None if seg is None else T(seg)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = tensor_core_prefill_rendering(T(q), T(k), T(v), segments=tseg, **kw)
    plain = K.flash_attention_plain(T(q), T(k), T(v), segments=tseg, **kw)
    ref = jax_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      segments=None if seg is None else jnp.asarray(seg), interpret=True, **kw)
    tol = F32_TOL
    for want in (plain.numpy(), np.asarray(ref)):
        np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)
    if seg is not None:
        assert torch.all(got[:, :, seg[0] < 0] == 0)   # pad rows: exact zeros
    single = tensor_core_prefill_rendering(T(q), T(k), T(v), segments=tseg, terms=1, **kw)
    assert np.abs(single.numpy() - plain.numpy()).max() > 4 * tol


def test_three_bf16_terms_are_p_exactly():
    """Every f32 in [0, 1] (a sample of each binade down to 2^-100) is the
    sum of its three bf16 terms exactly, in f32 and in f64; two terms keep
    it to 2^-17 of itself, one to 2^-8 only."""
    rng = np.random.default_rng(0)
    p = T(np.concatenate([rng.uniform(0.5, 1.0, 4096) * 2.0 ** -e for e in range(0, 100)])
          .astype(np.float32))
    t1, t2, t3 = bf16_terms(p, 3)
    assert torch.equal(t1 + t2 + t3, p)
    assert torch.equal(t1.double() + t2.double() + t3.double(), p.double())
    assert float(((p - t1 - t2).abs() / p).max()) <= 2.0 ** -17
    assert 2.0 ** -10 < float(((p - t1).abs() / p).max()) <= 2.0 ** -8


@pytest.mark.parametrize("S,Hq,Hkv,hd,dtype,aligned,want", [
    (128, 16, 2, 128, torch.bfloat16, True, ("tensor_core", 4, 16)),
    (1024, 16, 2, 128, torch.bfloat16, True, ("tensor_core", 4, 16)),
    (4096, 16, 2, 128, torch.bfloat16, True, ("tensor_core", 8, 16)),
    (4096, 16, 16, 128, torch.bfloat16, True, ("tensor_core", 1, 128)),
    (128, 16, 16, 128, torch.bfloat16, True, ("tensor_core", 1, 64)),
    (128, 8, 1, 256, torch.bfloat16, True, ("cuda_core", 1, 32)),
    (128, 8, 2, 128, torch.float32, True, ("cuda_core", 1, 32)),
    (128, 8, 2, 64, torch.bfloat16, True, ("tensor_core", 4, 16)),
    (128, 8, 2, 96, torch.bfloat16, True, ("cuda_core", 1, 32)),
    (128, 8, 2, 40, torch.bfloat16, True, ("cuda_core", 1, 32)),
    (128, 8, 2, 128, torch.bfloat16, False, ("cuda_core", 1, 32)),
])
def test_prefill_plan(S, Hq, Hkv, hd, dtype, aligned, want):
    """Tensor cores for bf16 with head dim 64 or 128 and aligned rows;
    a block shares its K/V tiles among up to 4 warps (one an SM
    sub-partition), more while the blocks still fill a wave; the engine's
    packed stream (S = 128, 16 heads) puts 128 warps on the card."""
    plan = K.prefill_plan(1, S, Hq, Hkv, hd, hd, dtype, aligned, H100_SMS)
    assert tuple(plan) == want
    if plan.design == "tensor_core":
        warps = plan.heads * plan.rows // 16
        blocks = -(-S // plan.rows) * Hkv * -(-(Hq // Hkv) // plan.heads)
        assert warps <= K.TC_MAX_WARPS and blocks * warps == -(-S // 16) * Hq
        assert warps <= 4 or blocks >= H100_SMS
        if (S, Hq) == (128, 16):
            assert blocks * warps >= 128
        assert math.gcd(plan.heads, Hq // Hkv) == plan.heads
