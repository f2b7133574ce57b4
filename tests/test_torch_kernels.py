"""The port's attention kernels, as they run on the CPU (their plain
PyTorch versions behind the wrappers), against the reference's Pallas
kernels in interpret mode on the same numpy inputs.

Tolerances: f32 to 2e-5 (the reference's own decode-kernel pin,
tests/test_decode_kernel.py); bf16 to 1e-2.  The CUDA kernels themselves
are held against the same plain versions on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.decode import flash_decode_fwd as jax_decode
from repro.kernels.flash_attention.kernel import flash_attention_fwd as jax_prefill
from repro_torch.kernels.flash_attention.decode import flash_decode_fwd
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ops import attention

TOL = {np.float32: 2e-5, "bf16": 1e-2}


def _cast(x, dtype):
    """numpy f32 -> (jax array, torch tensor) of the test dtype."""
    if dtype == "bf16":
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _ring_pool_positions(rng, B, Skv):
    """kv_pos/q_pos of a slot pool: slot 0 a scrambled ring with -1 holes,
    slot 1 empty, slot 2 a ring cache that wrapped (length > Skv)."""
    kv_pos = np.full((B, Skv), -1, np.int32)
    kv_pos[0] = rng.permutation(Skv) + 5
    kv_pos[0, rng.choice(Skv, 6, replace=False)] = -1
    length = Skv + 9
    s = np.arange(Skv)
    kv_pos[2] = length - 1 - ((length - 1 - s) % Skv)
    q_pos = np.array([[kv_pos[0].max() + 1], [3], [length]], np.int32)
    return q_pos, kv_pos


DECODE_CASES = [(rep, window, softcap, np.float32) for rep in (1, 2, 4)
                for window in (0, 8) for softcap in (0.0, 30.0)] + \
    [(1, 0, 0.0, "bf16"), (2, 8, 0.0, "bf16"), (4, 8, 30.0, "bf16")]


@pytest.mark.parametrize("rep,window,softcap,dtype", DECODE_CASES)
def test_decode_matches_pallas_interpret(rep, window, softcap, dtype):
    rng = np.random.default_rng(rep * 10 + window)
    B, Skv, Hkv, hd = 3, 32, 2, 16
    q = rng.standard_normal((B, 1, Hkv * rep, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
    q_pos, kv_pos = _ring_pool_positions(rng, B, Skv)
    (qj, qt), (kj, kt), (vj, vt) = (_cast(x, dtype) for x in (q, k, v))

    ref = jax_decode(qj, kj, vj, q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos),
                     window=window, softcap=softcap, interpret=True)
    out = flash_decode_fwd(qt, kt, vt, q_pos=torch.from_numpy(q_pos),
                           kv_pos=torch.from_numpy(kv_pos), window=window,
                           softcap=softcap)
    assert out.dtype == qt.dtype and out.shape == (B, 1, Hkv * rep, hd)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.all(out[1] == 0)                  # the empty slot: exact zeros


def _segments(S, lens):
    seg = np.full((1, S), -1, np.int32)
    off = 0
    for i, n in enumerate(lens):
        seg[0, off:off + n] = i
        off += n
    return seg


@pytest.mark.parametrize("Hq,Hkv,window,softcap,dtype", [
    (4, 4, 0, 0.0, np.float32), (4, 2, 0, 0.0, np.float32),
    (8, 1, 0, 0.0, np.float32), (4, 2, 7, 0.0, np.float32),
    (4, 2, 0, 10.0, np.float32), (4, 2, 0, 0.0, "bf16"), (8, 1, 7, 10.0, "bf16")])
def test_segmented_prefill_matches_pallas_interpret(Hq, Hkv, window, softcap,
                                                   dtype):
    rng = np.random.default_rng(Hq + Hkv + window)
    S, lens, hd = 64, [20, 25, 10], 16            # 3 prompts + 9 pad tokens
    q = rng.standard_normal((1, Hq, S, hd)).astype(np.float32)
    k = rng.standard_normal((1, Hkv, S, hd)).astype(np.float32)
    v = rng.standard_normal((1, Hkv, S, hd)).astype(np.float32)
    seg = _segments(S, lens)
    (qj, qt), (kj, kt), (vj, vt) = (_cast(x, dtype) for x in (q, k, v))

    ref = jax_prefill(qj, kj, vj, segments=jnp.asarray(seg), window=window,
                      softcap=softcap, interpret=True)
    out = flash_attention_fwd(qt, kt, vt, segments=torch.from_numpy(seg),
                              window=window, softcap=softcap)
    assert out.dtype == qt.dtype and out.shape == (1, Hq, S, hd)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.all(out[:, :, sum(lens):] == 0)   # pad rows: exact zeros


def test_routing_matches_oracle_and_counts_no_cpu_launch():
    """``impl="flash"`` routes decode- and prefill-shaped calls to the kernel
    wrappers, which on CPU tensors run their plain versions (launch counters
    stay put) and agree with the oracle."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 24, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 24, 2, 16)).astype(np.float32))
    kv_pos = torch.arange(24, dtype=torch.int32).expand(2, 24).clone()
    kv_pos[1, 10:] = -1
    q_pos = torch.tensor([[23], [9]], dtype=torch.int32)
    before = (flash_decode_fwd.launches, flash_attention_fwd.launches)
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, kv_valid=kv_pos >= 0, window=6)
    np.testing.assert_allclose(attention(q, k, v, impl="flash", **kw).numpy(),
                               attention(q, k, v, impl="ref", **kw).numpy(),
                               atol=2e-5)
    seg = torch.from_numpy(_segments(24, [7, 11]))
    qs = torch.from_numpy(rng.standard_normal((1, 24, 4, 16)).astype(np.float32))
    np.testing.assert_allclose(
        attention(qs, k[:1], v[:1], segments=seg, impl="flash").numpy(),
        attention(qs, k[:1], v[:1], segments=seg, impl="ref").numpy(), atol=2e-5)
    assert (flash_decode_fwd.launches, flash_attention_fwd.launches) == before


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a card is refused, not
    quietly computed by the plain version."""
    q = torch.empty((1, 1, 4, 16), device="meta")
    kv = torch.empty((1, 8, 2, 16), device="meta")
    pos = torch.empty((1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_decode_fwd(q, kv, kv, q_pos=pos[:, :1], kv_pos=pos)
    qp = torch.empty((1, 4, 8, 16), device="meta")
    kp = torch.empty((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_attention_fwd(qp, kp, kp, segments=pos)


@pytest.mark.parametrize("Sq,q_chunk,segmented", [(64, 16, False), (64, 16, True),
                                                   (48, 32, False)])
def test_oracle_query_chunks_give_the_unchunked_result(Sq, q_chunk, segmented):
    """``attention_ref`` splits ``Sq`` into ``q_chunk`` rows where that
    divides it (64 in 16s), as the reference's oracle does, and otherwise
    (48 by 32) runs whole: the same result either way, equal to the
    reference's chunked oracle within the f32 pin."""
    from repro.kernels.flash_attention.ref import attention_ref as jax_ref
    from repro_torch.kernels.flash_attention.ref import attention_ref
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, Sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, Sq, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, Sq, 2, 16)).astype(np.float32)
    seg = np.broadcast_to(_segments(Sq, [Sq // 3, Sq // 2]), (2, Sq)).copy()
    kw = dict(window=20, softcap=30.0)
    tk = {"q_seg": torch.from_numpy(seg), "kv_seg": torch.from_numpy(seg)} if segmented else {}
    jk = {"q_seg": jnp.asarray(seg), "kv_seg": jnp.asarray(seg)} if segmented else {}
    t = [torch.from_numpy(a) for a in (q, k, v)]
    chunked = attention_ref(*t, q_chunk=q_chunk, **tk, **kw)
    whole = attention_ref(*t, q_chunk=0, **tk, **kw)
    assert torch.equal(chunked, whole)
    want = jax_ref(*(jnp.asarray(a) for a in (q, k, v)), q_chunk=q_chunk, **jk, **kw)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
