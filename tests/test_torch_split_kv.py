"""The pieces of the port's split routes on the CPU, against numpy and the
reference: the decode kernels' log-sum-exp output (their plain versions),
the exact merge of a pool cut in parts, the prefill kernel's query row
offset, the oracle's bounded score blocks and ``ops.attention``'s
``return_lse``.

Under a plan a rank of a sequence-split KV cache attends its own entries
and the ranks' rows are merged by their log-sum-exp
(``flash_attention.ops._planned_split_kv``); a rank of a sequence-split
prefill attends its own query rows at their offset
(``ops._planned_rows``).  The gloo cases of ``test_torch_multidevice.py``
hold the routes end to end; the card holds the CUDA kernels' new outputs
against these plain versions (``chip_smoke.py`` phase ``kernels``).

Tolerances: f32 2e-5 as the decode kernels' own pin; the LSE to 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.decode import flash_decode_fwd as jax_decode
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attention import ref as R
from repro_torch.kernels.flash_attention.common import NEG_INF
from repro_torch.kernels.flash_attention.decode import (flash_decode_fwd, flash_decode_plain,
                                                        flash_decode_quant_fwd)
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ops import _merged, _weighed, attention
from repro_torch.quant.core import dequantize_kv, quantize_kv

TOL = 2e-5


def merge_parts(outs, lses):
    """``ops.merge_splits`` of parts held in one process: ``outs`` and
    ``lses`` list each part's rows and their log-sum-exp, summed in list
    order."""
    m = torch.stack(lses).amax(dim=0)
    return _merged(sum(_weighed(o, l, m) for o, l in zip(outs, lses)), outs[0].dtype)


def _pool(rng, B=3, Skv=48, Hkv=2, rep=4, hd=16, q_scale=1.0):
    """A slot pool: slot 0 full to position Skv - 1, slot 1 empty, slot 2 a
    wrapped ring with holes; q scaled by ``q_scale``."""
    q = (rng.standard_normal((B, 1, Hkv * rep, hd)) * q_scale).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
    kv_pos = np.full((B, Skv), -1, np.int32)
    kv_pos[0] = np.arange(Skv)
    n = Skv + 11
    kv_pos[2] = n - 1 - ((n - 1 - np.arange(Skv)) % Skv)
    kv_pos[2, rng.choice(Skv, 5, replace=False)] = -1
    q_pos = np.array([[Skv - 1], [4], [n - 1]], np.int32)
    return q, k, v, q_pos, kv_pos


def _np_lse(q, k, kv_pos, q_pos, *, window=0, softcap=0.0):
    """(B, Hq) log-sum-exp of each query row's masked scores, in f64;
    NEG_INF for a row with no valid entry."""
    B, _, Hq, hd = q.shape
    Hkv = k.shape[2]
    s = np.einsum("bhrd,bkhd->bhrk", q[:, 0].reshape(B, Hkv, Hq // Hkv, hd).astype(np.float64),
                  k.astype(np.float64)) * hd ** -0.5
    if softcap:
        s = softcap * np.tanh(s / softcap)
    ok = (kv_pos >= 0) & (kv_pos <= q_pos)
    if window:
        ok &= q_pos - kv_pos < window
    s = np.where(ok[:, None, None], s, -np.inf)
    m = np.where(ok.any(-1)[:, None, None, None], s.max(axis=-1, keepdims=True), 0.0)
    total = np.exp(s - m).sum(-1)
    lse = np.log(np.where(total > 0, total, 1.0)) + m[..., 0]
    return np.where(ok.any(-1)[:, None, None], lse, NEG_INF).reshape(B, Hq)


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (8, 0.0), (0, 30.0), (8, 30.0)])
def test_decode_lse_matches_numpy(bits, window, softcap):
    """The decode wrappers' ``return_lse`` (their plain versions on CPU
    tensors), fp and quantised: each row's log-sum-exp of its masked
    scores (the quantised pool's over its dequantised entries), the empty
    slot's rows ``NEG_INF``; the output is the call's without it."""
    rng = np.random.default_rng(bits + window)
    q, k, v, q_pos, kv_pos = _pool(rng)
    qt, kt, vt, qp, kp = _t(q, k, v, q_pos, kv_pos)
    kw = dict(q_pos=qp, kv_pos=kp, window=window, softcap=softcap)
    if bits:
        (kq, ks), (vq, vs) = quantize_kv(kt, bits), quantize_kv(vt, bits)
        out, lse = flash_decode_quant_fwd(qt, kq, ks, vq, vs, kv_bits=bits, return_lse=True,
                                          **kw)
        plain = flash_decode_quant_fwd(qt, kq, ks, vq, vs, kv_bits=bits, **kw)
        k = dequantize_kv(kq, ks, bits).numpy()
    else:
        out, lse = flash_decode_fwd(qt, kt, vt, return_lse=True, **kw)
        plain = flash_decode_fwd(qt, kt, vt, **kw)
    assert lse.dtype == torch.float32 and lse.shape == (3, 8)
    assert torch.equal(out, plain)
    want = _np_lse(q, k, kv_pos, q_pos, window=window, softcap=softcap)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.all(lse[1] == NEG_INF) and torch.all(out[1] == 0)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (8, 30.0)])
@pytest.mark.parametrize("cut", [[24], [8, 16, 40]])
def test_merged_parts_match_the_reference_decode_over_the_whole_pool(window, softcap, cut):
    """The pool cut along its entries, each part attended alone with its
    log-sum-exp and the parts merged (:func:`merge_parts`, the formula of
    the merge across ranks): the reference's decode kernel (interpret
    mode) over the whole pool.  The scores reach past 88, where ``exp``
    overflows f32 without the merge's max; a part with no valid entry of a
    slot adds nothing, and the empty slot stays exact zeros."""
    rng = np.random.default_rng(len(cut) + window)
    q, k, v, q_pos, kv_pos = _pool(rng, q_scale=40.0)
    qt, kt, vt, qp, kp = _t(q, k, v, q_pos, kv_pos)
    edges = [0, *cut, k.shape[1]]
    parts = [flash_decode_plain(qt, kt[:, a:b], vt[:, a:b], q_pos=qp, kv_pos=kp[:, a:b],
                                window=window, softcap=softcap, return_lse=True)
             for a, b in zip(edges, edges[1:])]
    if not softcap:
        assert max(float(lse.max()) for _, lse in parts) > 89.0
    out = merge_parts([o[:, 0] for o, _ in parts], [lse for _, lse in parts])
    ref = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_pos=jnp.asarray(q_pos),
                     kv_pos=jnp.asarray(kv_pos), window=window, softcap=softcap,
                     interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref)[:, 0], atol=TOL, rtol=TOL)
    assert torch.all(out[1] == 0)


def _segments(S, lens):
    seg = np.full((1, S), -1, np.int32)
    off = 0
    for i, n in enumerate(lens):
        seg[0, off:off + n] = i
        off += n
    return seg


@pytest.mark.parametrize("offset,rows", [(0, 16), (37, 21), (48, 16)])
@pytest.mark.parametrize("window,softcap,segmented", [
    (0, 0.0, False), (9, 0.0, False), (0, 30.0, False), (0, 0.0, True), (9, 30.0, True)])
def test_prefill_rows_at_an_offset_match_the_reference(offset, rows, window, softcap,
                                                       segmented):
    """The prefill wrapper's ``q_offset`` (its plain version on CPU
    tensors): query rows ``offset .. offset + rows`` of a 64-token causal
    stream over all 64 keys, q's segments read at their offset, equal the
    reference's oracle with ``q_pos = offset + arange`` (GQA rep 2) and the
    same rows of the whole call."""
    rng = np.random.default_rng(offset + rows)
    B, S, Hq, Hkv, hd = 1, 64, 4, 2, 16
    q = rng.standard_normal((B, S, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    seg = _segments(S, (20, 25, 13)) if segmented else None
    part = slice(offset, offset + rows)
    kw = dict(window=window, softcap=softcap,
              segments=None if seg is None else torch.from_numpy(seg))
    qt, kt, vt = (torch.from_numpy(x).transpose(1, 2) for x in (q, k, v))
    out = flash_attention_fwd(qt[:, :, part], kt, vt, q_offset=offset, **kw)
    whole = flash_attention_fwd(qt, kt, vt, **kw)
    q_pos = (offset + np.arange(rows, dtype=np.int32))[None]
    ref = jax_attention_ref(jnp.asarray(q[:, part]), jnp.asarray(k), jnp.asarray(v),
                            q_pos=jnp.asarray(q_pos),
                            kv_pos=jnp.asarray(np.arange(S, dtype=np.int32)[None]),
                            q_seg=None if seg is None else jnp.asarray(seg[:, part]),
                            kv_seg=None if seg is None else jnp.asarray(seg),
                            window=window, softcap=softcap)
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(out.numpy(), whole[:, :, part].numpy(), atol=1e-6, rtol=1e-6)


def test_prefill_offset_past_the_keys_is_refused():
    q = torch.zeros((1, 2, 8, 16))
    k = torch.zeros((1, 2, 32, 16))
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k, k, q_offset=30)
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k, k, q_offset=-1)


def test_oracle_chunks_bound_their_score_block(monkeypatch):
    """``ref.chunk_rows`` halves the 1024-row chunks until a chunk's f32
    scores fit :data:`ref.SCORE_BLOCK_BYTES` (qwen2.5-3b's prefill_32k
    rank: 64 rows of 32768 keys over 2 x 16 heads, 256 MiB); chunks of
    whole rows give the unchunked oracle's output and LSE bit for bit."""
    assert R.chunk_rows(2, 2048, 16, 32768, 1024) == 64
    assert R.chunk_rows(2, 4096, 16, 4096, 1024) == 512
    assert R.chunk_rows(1, 100, 4, 64, 1024) == 100
    assert R.chunk_rows(16, 8192, 64, 32768, 1024) == 2
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 96, h, 16)).astype(np.float32))
               for h in (4, 2, 2))
    kw = dict(window=40, softcap=30.0, return_lse=True)
    whole = R.attention_ref(q, k, v, q_chunk=0, **kw)
    monkeypatch.setattr(R, "SCORE_BLOCK_BYTES", 4 * 2 * 4 * 12 * 96)
    assert R.chunk_rows(2, 96, 4, 96, 1024) == 12
    chunked = R.attention_ref(q, k, v, **kw)
    assert all(torch.equal(a, b) for a, b in zip(whole, chunked))


@pytest.mark.parametrize("bits", [0, 8])
def test_attention_lse_routes_agree(bits):
    """``ops.attention(return_lse=True)``: the decode route (``flash``, the kernels'
    plain versions here) and the oracle route (``ref``) give the same rows
    and log-sum-exp, with ``kv_valid`` folded into the positions."""
    rng = np.random.default_rng(bits)
    q, k, v, q_pos, kv_pos = _pool(rng)
    qt, kt, vt, qp, kp = _t(q, k, v, q_pos, kv_pos)
    kw = dict(q_pos=qp, kv_pos=kp, kv_valid=kp >= 0, window=8, softcap=30.0)
    if bits:
        (kt, ks), (vt, vs) = quantize_kv(kt, bits), quantize_kv(vt, bits)
        kw.update(k_scale=ks, v_scale=vs, kv_bits=bits)
    a_out, a_lse = attention(qt, kt, vt, impl="flash", return_lse=True, **kw)
    b_out, b_lse = attention(qt, kt, vt, impl="ref", return_lse=True, **kw)
    assert a_lse.shape == b_lse.shape == (3, 1, 8)
    np.testing.assert_allclose(a_out.numpy(), b_out.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(a_lse.numpy(), b_lse.numpy(), atol=1e-5, rtol=1e-5)
