"""The port's quantisation plane against the reference's, live, on the CPU.

Quantisers (int4 packing, weights, KV rows, crossbar tiles, a model's
parameters) must give bit-identical codes and scales on the same f32
input.  The plain versions behind the kernel wrappers are held against
the reference's Pallas kernels in interpret mode on the same numpy
inputs, with the tolerances the reference's own tests pin
(tests/test_quant.py): 1e-5 for the dequant-matmul, 2e-5 for the
quantised decode.  The CUDA kernels themselves are held against the same
plain versions on the card by chip_smoke.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import reduce_config as jax_reduce_config
from repro.kernels.flash_attention.decode import flash_decode_quant_fwd as jax_decode_quant
from repro.kernels.pim_mvm.kernel import pim_mvm_pallas
from repro.models import transformer as TJ
from repro.quant import core as QJ
from repro.quant.kernel import quant_matmul_pallas
from repro.quant.ops import quant_matmul as jax_quant_matmul
from repro_torch.config import get_config, reduce_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.flash_attention.decode import (flash_decode_fwd,
                                                        flash_decode_quant_fwd)
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.pim_mvm import kernel as pim_kernel
from repro_torch.kernels.pim_mvm.ops import pim_mvm
from repro_torch.models.transformer import QuantWeight, Transformer
from repro_torch.quant import core as Q
from repro_torch.quant.kernel import quant_matmul_fwd
from repro_torch.quant.ops import qdense, quant_matmul

T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731  numpy/jax -> torch


def _same(got: torch.Tensor, want, what=""):
    """Bit-exact equality of a port tensor and a reference array."""
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, what
    np.testing.assert_array_equal(got.numpy(), want, err_msg=what)


# ---------------------------------------------------------------------------
# quantisers: bit-exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [-1, 0, 1])
def test_int4_pack_unpack_every_code_matches_reference(axis):
    """Every code in [-8, 7] at every pair position, packed on any axis:
    the same bytes as the reference, and back."""
    codes = np.stack(np.meshgrid(np.arange(-8, 8), np.arange(-8, 8)), -1)
    codes = np.broadcast_to(codes.reshape(16, 16, 2), (3, 16, 16, 2)).reshape(3, 16, 32)
    codes = np.moveaxis(codes, -1, axis).astype(np.int8).copy()
    packed = Q.pack_int4(T(codes), axis)
    _same(packed, QJ.pack_int4(jnp.asarray(codes), axis))
    _same(Q.unpack_int4(packed, axis), codes)


def test_pack_int4_odd_axis_raises():
    with pytest.raises(ValueError, match="even"):
        Q.pack_int4(torch.zeros((3, 5), dtype=torch.int8), axis=-1)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("group", [0, 32])
def test_quantize_matches_reference_bit_exact(bits, group):
    rng = np.random.default_rng(bits + group)
    w = (rng.standard_normal((2, 64, 96)) * rng.uniform(0.01, 3.0, (2, 1, 96))
         ).astype(np.float32)
    w[0, :, 5] = 0.0                                  # an all-zero column
    qj, qt = QJ.quantize(jnp.asarray(w), bits, group=group), Q.quantize(T(w), bits, group=group)
    assert (qt.bits, qt.group, qt.k_dim) == (qj.bits, qj.group, qj.k_dim) == (bits, group, 64)
    _same(qt.q, qj.q, "codes")
    _same(qt.scale, qj.scale, "scales")
    _same(Q.dequantize(qt), QJ.dequantize(qj), "dequantised")
    with pytest.raises(ValueError):
        Q.quantize(T(w), 16)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_kv_matches_reference_bit_exact(bits, dtype):
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((3, 10, 2, 32)).astype(np.float32) * 4
    x[1, 4:] = 0.0                                    # empty entries: zero rows
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    xt = T(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    (cj, sj), (ct, st) = QJ.quantize_kv(xj, bits), Q.quantize_kv(xt, bits)
    _same(ct, cj, "codes")
    _same(st, sj, "scales")
    _same(Q.dequantize_kv(ct, st, bits), QJ.dequantize_kv(cj, sj, bits), "dequantised")
    assert torch.all(Q.dequantize_kv(ct, st, bits)[1, 4:] == 0)
    cache = {"k": xt, "v": -xt, "pos": torch.zeros((3, 10), dtype=torch.int32)}
    qc = Q.quantize_kv_cache(cache, bits)
    assert Q.kv_cache_bits(qc, 32) == bits
    _same(qc["v_q"], QJ.quantize_kv(-xj, bits)[0], "cache codes")


def test_quantize_weights_matches_reference_bit_exact():
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((256, 384)) * rng.uniform(0.1, 2.0, (1, 384))).astype(np.float32)
    (qj, sj), (qt, st) = QJ.quantize_weights(jnp.asarray(w)), Q.quantize_weights(T(w))
    _same(qt, qj, "codes")
    _same(st, sj, "tile scales")
    with pytest.raises(ValueError, match="crossbars"):
        Q.quantize_weights(T(w[:100]))


@pytest.fixture(scope="module")
def qwen():
    cfg_j = jax_reduce_config(jax_get_config("qwen2.5-3b"))
    cfg_t = reduce_config(get_config("qwen2.5-3b"))
    tree = jax.device_get(TJ.init_params(cfg_j, jax.random.PRNGKey(0),
                                         param_dtype=jnp.float32))
    return cfg_j, cfg_t, tree


def _flat_jax(tree):
    """name -> leaf of a reference tree, a QuantTensor kept whole."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, QJ.QuantTensor))[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in leaves}


def _flat_port(params):
    """name -> leaf of a port tree or parameter module, a quantised weight
    as its QuantTensor."""
    out = {}

    def walk(tree, name):
        if isinstance(tree, QuantWeight):
            out[name] = tree.tensor()
        elif hasattr(tree, "items"):
            for k, t in tree.items():
                walk(t, f"{name}.{k}" if name else k)
        elif isinstance(tree, (list, torch.nn.ModuleList)):
            for i, t in enumerate(tree):
                walk(t, f"{name}.{i}")
        else:
            out[name] = tree.detach() if isinstance(tree, torch.Tensor) else tree
    walk(params, "")
    return out


def _compare_quantised_trees(port, ref):
    fp, fj = _flat_port(port), _flat_jax(ref)
    assert set(fp) == set(fj)
    quant = {n for n, leaf in fj.items() if isinstance(leaf, QJ.QuantTensor)}
    assert {n for n, leaf in fp.items() if isinstance(leaf, Q.QuantTensor)} == quant
    for n in quant:
        assert (fp[n].bits, fp[n].group) == (fj[n].bits, fj[n].group), n
        _same(fp[n].q, fj[n].q, n)
        _same(fp[n].scale, fj[n].scale, n)
    return quant


@pytest.mark.parametrize("bits,group", [(8, 0), (4, 0), (8, 32), (4, 64)])
def test_quantize_params_matches_reference(qwen, bits, group):
    """The same leaves quantised (group 64 does not divide w_down's K = 96:
    that leaf falls back to per-channel scales on both sides), with the
    same code and scale planes; the reference's quantised tree carried over
    by ``params_from_jax`` is the port's own quantised module."""
    _, cfg_t, tree = qwen
    ref = QJ.quantize_params(tree, bits, group=group)
    port = Transformer(cfg_t, Q.quantize_params(
        params_from_jax(tree, cfg_t, device="cpu", dtype=torch.float32), bits, group=group))
    quant = _compare_quantised_trees(port, ref)
    assert len(quant) == 7 * len(tree["stack"])
    carried = params_from_jax(jax.device_get(ref), cfg_t, device="cpu", dtype=torch.float32)
    _compare_quantised_trees(carried, ref)
    assert {n for n, _ in carried.named_buffers()} == {n for n, _ in port.named_buffers()}


def test_quantize_params_skips_odd_k_at_int4():
    """d_model 65: every projection reading the residual stream has an odd
    K, which int4 cannot pack; both packages leave those leaves fp."""
    cfg_j = dataclasses.replace(jax_reduce_config(jax_get_config("qwen2.5-3b")), d_model=65)
    cfg_t = dataclasses.replace(reduce_config(get_config("qwen2.5-3b")), d_model=65)
    tree = jax.device_get(TJ.init_params(cfg_j, jax.random.PRNGKey(1),
                                         param_dtype=jnp.float32))
    pt = params_from_jax(tree, cfg_t, device="cpu", dtype=torch.float32)
    for bits in (8, 4):
        quant = _compare_quantised_trees(Q.quantize_params(pt, bits),
                                         QJ.quantize_params(tree, bits))
        assert {n.rsplit(".", 1)[-1] for n in quant} == (
            {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"} if bits == 8
            else {"wo", "w_down"})


def test_fake_quantize_params_matches_reference(qwen):
    _, cfg_t, tree = qwen
    ref = _flat_jax(QJ.fake_quantize_params(tree, 4, group=32))
    port = _flat_port(Q.fake_quantize_params(
        params_from_jax(tree, cfg_t, device="cpu", dtype=torch.float32), 4, group=32))
    assert set(port) == set(ref)
    for n, leaf in ref.items():
        _same(port[n], leaf, n)


# ---------------------------------------------------------------------------
# plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("group", [0, 32])
def test_quant_matmul_plain_matches_pallas_interpret(bits, group):
    rng = np.random.default_rng(10 * bits + group)
    x = rng.standard_normal((8, 128)).astype(np.float32)
    w = rng.standard_normal((128, 256)).astype(np.float32)
    qj = QJ.quantize(jnp.asarray(w), bits, group=group)
    ref = quant_matmul_pallas(jnp.asarray(x), qj.q, qj.scale, bits=bits, group=group,
                              interpret=True)
    before = quant_matmul_fwd.launches
    out = quant_matmul_fwd(T(x), T(qj.q), T(qj.scale), bits=bits, group=group)
    assert out.dtype == torch.float32 and out.shape == (8, 256)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    assert quant_matmul_fwd.launches == before        # the CPU launches nothing


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_ragged_matches_reference_fallback(bits):
    """A shape the TPU grid cannot tile takes the reference's fallback
    there; the port's kernel (here its plain version) masks the edges."""
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((3, 48)).astype(np.float32)
    w = rng.standard_normal((48, 50)).astype(np.float32)
    qj = QJ.quantize(jnp.asarray(w), bits)
    ref = jax_quant_matmul(jnp.asarray(x), qj, impl="ref")
    qt = Q.quantize(T(w), bits)
    out = quant_matmul(T(x), qt, impl="flash")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(quant_matmul(T(x), qt, impl="ref").numpy(),
                                  (T(x) @ Q.dequantize(qt)).numpy())


def _quant_pool(seed, B, Skv, Hq, Hkv, hd, lengths, bits):
    """A slot pool of given lengths, quantised by the reference."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
    L = np.asarray(lengths, np.int32)
    kv_pos = np.where(np.arange(Skv)[None] < L[:, None], np.arange(Skv)[None], -1)
    kv_pos = kv_pos.astype(np.int32)
    q_pos = np.maximum(L[:, None] - 1, 0).astype(np.int32)
    k_q, k_s = QJ.quantize_kv(jnp.asarray(k), bits)
    v_q, v_s = QJ.quantize_kv(jnp.asarray(v), bits)
    return q, (k_q, k_s, v_q, v_s), q_pos, kv_pos


@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_decode_plain_matches_pallas_interpret(Hq, Hkv, window, bits):
    q, planes, q_pos, kv_pos = _quant_pool(Hq + Hkv, 3, 64, Hq, Hkv, 32, [3, 31, 64], bits)
    ref = jax_decode_quant(jnp.asarray(q), *planes, kv_bits=bits, q_pos=jnp.asarray(q_pos),
                           kv_pos=jnp.asarray(kv_pos), window=window, interpret=True)
    before = flash_decode_quant_fwd.launches
    out = flash_decode_quant_fwd(T(q), *(T(p) for p in planes), kv_bits=bits,
                                 q_pos=T(q_pos), kv_pos=T(kv_pos), window=window)
    assert out.dtype == torch.float32 and out.shape == (3, 1, Hq, 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
    assert flash_decode_quant_fwd.launches == before


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_decode_empty_slot_gives_exact_zeros(bits):
    q, planes, q_pos, kv_pos = _quant_pool(bits, 2, 32, 4, 2, 16, [10, 20], bits)
    kv_pos[1] = -1
    ref = jax_decode_quant(jnp.asarray(q), *planes, kv_bits=bits, q_pos=jnp.asarray(q_pos),
                           kv_pos=jnp.asarray(kv_pos), interpret=True)
    out = flash_decode_quant_fwd(T(q), *(T(p) for p in planes), kv_bits=bits,
                                 q_pos=T(q_pos), kv_pos=T(kv_pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
    assert torch.all(out[1] == 0)


def test_pim_mvm_plain_matches_pallas_interpret():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((128, 256)).astype(np.float32)
    w = rng.standard_normal((256, 256)).astype(np.float32)
    wq, sc = QJ.quantize_weights(jnp.asarray(w))
    ref = pim_mvm_pallas(jnp.asarray(x), wq, sc, interpret=True)
    before = pim_kernel.pim_mvm_fwd.launches
    out = pim_mvm(T(x), T(wq), T(sc))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(out.numpy(), pim_mvm(T(x), T(wq), T(sc), impl="ref").numpy())
    assert pim_kernel.pim_mvm_fwd.launches == before
    with pytest.raises(ValueError, match="crossbars"):
        pim_mvm(T(x[:, :200]), T(wq[:200]), T(sc))


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def test_attention_quantised_route_matches_dequantise_up_front():
    """Decode-shaped calls with scales take the quantised decode kernel;
    the same call over the pool dequantised up front (the route every
    other shape takes) gives the same numbers.  A chunk-shaped call with
    scales dequantises and goes on as fp."""
    q, planes, q_pos, kv_pos = _quant_pool(3, 3, 24, 4, 2, 16, [24, 9, 0], 8)
    k_q, k_s, v_q, v_s = (T(p) for p in planes)
    k, v = Q.dequantize_kv(k_q, k_s, 8), Q.dequantize_kv(v_q, v_s, 8)
    kw = dict(q_pos=T(q_pos), kv_pos=T(kv_pos), kv_valid=T(kv_pos) >= 0, window=6)
    launches = (flash_decode_fwd.launches, flash_decode_quant_fwd.launches)
    got = attention(T(q), k_q, v_q, k_scale=k_s, v_scale=v_s, kv_bits=8, **kw)
    np.testing.assert_allclose(got.numpy(), attention(T(q), k, v, **kw).numpy(),
                               atol=1e-6, rtol=0)
    assert torch.all(got[2] == 0)
    rng = np.random.default_rng(4)
    qc = T(rng.standard_normal((3, 5, 4, 16)).astype(np.float32))
    pos = torch.arange(24, 29, dtype=torch.int32).expand(3, 5)
    kwc = dict(q_pos=pos, kv_pos=T(kv_pos), kv_valid=T(kv_pos) >= 0)
    np.testing.assert_array_equal(
        attention(qc, k_q, v_q, k_scale=k_s, v_scale=v_s, kv_bits=8, **kwc).numpy(),
        attention(qc, k, v, **kwc).numpy())
    assert (flash_decode_fwd.launches, flash_decode_quant_fwd.launches) == launches
    with pytest.raises(ValueError, match="kv_bits"):
        attention(T(q), k_q, v_q, k_scale=k_s, v_scale=v_s, kv_bits=3, **kw)


def test_qdense_fp_path_is_the_plain_matmul():
    rng = np.random.default_rng(5)
    x = T(rng.standard_normal((2, 3, 64)).astype(np.float32)).to(torch.bfloat16)
    w = T(rng.standard_normal((64, 40)).astype(np.float32))
    np.testing.assert_array_equal(qdense(x, w, torch.bfloat16).float().numpy(),
                                  (x @ w.to(torch.bfloat16)).float().numpy())
    qt = Q.quantize(w, 8)
    np.testing.assert_array_equal(qdense(x, qt, impl="ref").float().numpy(),
                                  (x @ Q.dequantize(qt).to(torch.bfloat16)).float().numpy())
    out = qdense(x, qt, impl="flash")
    assert out.shape == (2, 3, 40) and out.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="impl"):
        qdense(x, qt, impl="pallas")


def test_quant_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a card is refused, not
    quietly computed by the plain version."""
    x = torch.empty((4, 128), device="meta")
    q = torch.empty((128, 128), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        quant_matmul_fwd(x, q, torch.empty((1, 128), device="meta"), bits=8)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        pim_kernel.pim_mvm_fwd(x, q, torch.empty((1, 1), device="meta"))
    qd = torch.empty((1, 1, 4, 32), device="meta")
    codes = torch.empty((1, 8, 2, 32), dtype=torch.int8, device="meta")
    sc = torch.empty((1, 8, 2), device="meta")
    pos = torch.empty((1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_decode_quant_fwd(qd, codes, sc, codes, sc, kv_bits=8, q_pos=pos[:, :1],
                               kv_pos=pos)
