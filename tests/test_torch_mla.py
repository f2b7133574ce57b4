"""The port's multi-head latent attention (MLA) against the reference's,
live, on the CPU: reduced deepseek-v2-236b (4 heads, no-RoPE q/k dim 16,
RoPE dim 8, v dim 16, latent 32, query rank 48; a dense first layer, then
8 experts top-2 with shared experts).

Inputs come from numpy with a seed; the reference's f32 parameter tree is
carried over by ``repro_torch.convert``.  Tolerances, per case:

- the pieces (``_mla_q``, ``_mla_kv_latent``) in f32: 1e-5 relative to
  each tensor's scale (its largest magnitude, at least 1): the same
  products summed in another order;
- ``apply_mla`` in f32, every serving mode (padded prefill, packed
  prefill, decode, chunk): 2e-5 of the output's scale (the reference's
  kernel pin), cache latents likewise, ``pos`` exactly; a write at
  ``pos = -1`` leaves its pool row bit for bit, and a query row with no
  valid entry gives exact zeros;
- one layer in bf16: 1e-2 of the output's scale (a bf16 value moves by up
  to 1/128 of itself on one rounding flip);
- decode against the full forward (the reference's ``tests/test_models.py``
  rule): 5e-2 absolute and relative, f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import reduce_config as jax_reduce_config
from repro.models import attention as AJ
from repro.models import transformer as TJ
from repro.quant.core import quantize_params as jax_quantize_params
from repro_torch.config import get_config, reduce_config
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as AT
from repro_torch.models import transformer as T
from repro_torch.quant.core import quantize_params

ARCH = "deepseek-v2-236b"
F32_TOL = 1e-5
KERNEL_TOL = 2e-5
BF16_TOL = 1e-2


def _configs(**replace):
    return (dataclasses.replace(jax_reduce_config(jax_get_config(ARCH)), **replace),
            dataclasses.replace(reduce_config(get_config(ARCH)), **replace))


def _tree(cfg_j, seed=0):
    return TJ.init_params(cfg_j, jax.random.PRNGKey(seed), param_dtype=jnp.float32)


@pytest.fixture(scope="module")
def model():
    cfg_j, cfg_t = _configs()
    tree = _tree(cfg_j)
    host = jax.device_get(tree)
    return {"cfg": (cfg_j, cfg_t), "ref": tree, "host": host,
            "f32": params_from_jax(host, cfg_t, device="cpu", dtype=torch.float32),
            "bf16": params_from_jax(host, cfg_t, device="cpu", dtype=torch.bfloat16)}


def _attn(model, gi=1, dtype="f32"):
    """The MLA subtree of repeat 0 of group ``gi``, both packages."""
    p_j = jax.tree_util.tree_map(lambda a: a[0], model["ref"]["stack"][gi]["u0"]["attn"])
    return p_j, T._layer(model[dtype]["stack"][gi]["u0"]["attn"], 0)


def T_(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# config, parameters, pieces
# ---------------------------------------------------------------------------

def test_configs_match_the_reference():
    """The full config's MLA fields and the reduced dims (latent 32, query
    rank 48, RoPE 8, v 16) are the reference's, and so are the groups: the
    dense first layer, then the MoE run."""
    for full in (False, True):
        cj = jax_get_config(ARCH) if full else jax_reduce_config(jax_get_config(ARCH))
        ct = get_config(ARCH) if full else reduce_config(get_config(ARCH))
        for f in dataclasses.fields(ct):
            assert getattr(ct, f.name) == getattr(cj, f.name), f.name
        assert ct.is_mla and cj.is_mla
        assert [(g.units, g.repeats) for g in T.build_groups(ct)] == \
            [(g.units, g.repeats) for g in TJ.build_groups(cj)]
    ct = reduce_config(get_config(ARCH))
    assert (ct.kv_lora_rank, ct.q_lora_rank, ct.rope_head_dim, ct.v_head_dim) == (32, 48, 8, 16)
    assert [g.units for g in T.build_groups(get_config(ARCH))] == \
        [(("global", False),), (("global", True),)]


def test_init_mla_converts_and_draws_the_reference_leaves(model):
    """The converted tree holds the reference's MLA leaves stacked under the
    groups, norms in f32; the port's own draw has the same names, shapes and
    spreads."""
    cfg_t = model["cfg"][1]
    attn = model["bf16"]["stack"][1]["u0"]["attn"]
    shapes = {k: tuple(v.shape) for k, v in attn.items()}
    assert shapes == {"wq_a": (1, 64, 48), "q_norm": (1, 48), "wq_b": (1, 48, 4, 24),
                      "wkv_a": (1, 64, 40), "kv_norm": (1, 32), "wkv_b": (1, 32, 4, 32),
                      "wo": (1, 64, 64)}
    assert attn["kv_norm"].dtype == attn["q_norm"].dtype == torch.float32
    assert attn["wkv_b"].dtype == torch.bfloat16
    for k, v in model["host"]["stack"][1]["u0"]["attn"].items():
        np.testing.assert_array_equal(model["f32"]["stack"][1]["u0"]["attn"][k].numpy(), v)
    own = T.init_params(cfg_t, torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.float32)
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(model["host"])[0]}
    names = {n.replace(".", "/"): p for n, p in own.named_parameters()}
    assert set(names) == set(flat)
    for n, p in names.items():
        assert tuple(p.shape) == flat[n].shape, n
        if "/attn/w" in n:
            np.testing.assert_allclose(p.std().item(), np.std(flat[n]), rtol=0.15, err_msg=n)


@pytest.mark.parametrize("piece", ["_mla_q", "_mla_kv_latent"])
def test_mla_pieces_match_reference_f32(model, piece):
    cfg_j, cfg_t = model["cfg"]
    p_j, p_t = _attn(model)
    x = _x((2, 9, 64), 1)
    pos = np.stack([np.arange(9), np.arange(5, 14)]).astype(np.int32)
    want = getattr(AJ, piece)(p_j, jnp.asarray(x), jnp.asarray(pos), cfg_j)
    got = getattr(AT, piece)(p_t, T_(x), T_(pos), cfg_t)
    for w, g, name in zip(want, got, ("first", "second")):
        assert tuple(g.shape) == w.shape
        _close(g, w, F32_TOL, f"{piece} {name}")


# ---------------------------------------------------------------------------
# apply_mla in each serving mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,kv_cap,ref_impl", [(9, 16, "ref"), (13, 13, "ref"),
                                               (128, 160, "pallas_interpret")],
                         ids=["padded", "exact", "S128-pallas"])
def test_padded_prefill_matches_reference(model, S, kv_cap, ref_impl):
    """The expanded path through the prefill kernel's wrapper (its plain
    version here) against the reference's ``impl="ref"``, and at S 128
    against its Pallas kernel in interpret mode (q/k head dim 24, v 16).
    The cache is the latents padded to ``kv_cap``, the stream's positions
    kept on every row, pads included (no length)."""
    cfg_j, cfg_t = model["cfg"]
    p_j, p_t = _attn(model)
    x = _x((2, S, 64), 2)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    want, cj = AJ.apply_mla(p_j, jnp.asarray(x), cfg=cfg_j, mode="prefill",
                            pos=jnp.asarray(pos), impl=ref_impl, kv_cap=kv_cap)
    got, ct = AT.apply_mla(p_t, T_(x), cfg=cfg_t, mode="prefill", pos=T_(pos),
                           kv_cap=kv_cap)
    _close(got, want, KERNEL_TOL, "out")
    assert set(ct) == {"ckv", "kr", "pos"}
    for name in ("ckv", "kr"):
        assert tuple(ct[name].shape) == cj[name].shape
        _close(ct[name], cj[name], KERNEL_TOL, name)
    np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))


def _pool(cfg, B=3, cap=24, seed=3):
    """A latent pool with rows of 10, 0 and 17 valid entries, the rest
    holding stale values at pos -1."""
    rng = np.random.default_rng(seed)
    ckv = rng.standard_normal((B, cap, cfg.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((B, cap, cfg.rope_head_dim)).astype(np.float32)
    pos = np.full((B, cap), -1, np.int32)
    for b, n in enumerate((10, 0, 17)[:B]):
        pos[b, :n] = np.arange(n)
    return {"ckv": ckv, "kr": kr, "pos": pos}


@pytest.mark.parametrize("mode", ["decode", "chunk"])
def test_absorbed_decode_and_chunk_match_reference(model, mode):
    """Rows writing at their next position, a dead row (decode) or pad
    entries (chunk) at pos -1 and a write at pos == cap, all dropped:
    outputs and the post-write pool against the reference's, the dropped
    targets bit for bit as they were, and every query row with no valid
    entry exact zeros."""
    cfg_j, cfg_t = model["cfg"]
    p_j, p_t = _attn(model)
    pool = _pool(cfg_t)
    cap = pool["pos"].shape[1]
    if mode == "decode":
        pos = np.array([[10], [-1], [cap]], np.int32)
    else:
        pos = np.array([[10, 11, 12, -1], [-1, -1, -1, -1], [17, 18, -1, -1]], np.int32)
    x = _x((3, pos.shape[1], 64), 4)
    want, cj = AJ.apply_mla(p_j, jnp.asarray(x), cfg=cfg_j, mode=mode, pos=jnp.asarray(pos),
                            cache={k: jnp.asarray(v) for k, v in pool.items()}, impl="ref")
    cache = {k: T_(v) for k, v in pool.items()}
    got, ct = AT.apply_mla(p_t, T_(x), cfg=cfg_t, mode=mode, pos=T_(pos), cache=cache)
    assert ct is cache                                      # written in place
    _close(got, want, KERNEL_TOL, "out")
    for name in ("ckv", "kr"):
        _close(ct[name], cj[name], KERNEL_TOL, name)
    np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))
    written = np.zeros((3, cap), bool)
    for b, row in enumerate(pos):
        for p in row:
            if 0 <= p < cap:
                written[b, p] = True
    for name in ("ckv", "kr", "pos"):
        assert np.array_equal(ct[name].numpy()[~written], pool[name][~written]), name
    # a query at pos -1 attends to nothing; one at pos == cap to its row
    assert (got.numpy()[pos < 0] == 0).all()
    assert (got.numpy()[pos >= 0] != 0).any(axis=-1).all()


def test_packed_prefill_matches_reference():
    """The packed-segment prefill on an MLA variant without experts (the
    engine packs it): three prompts and pads in one stream, logits and the
    raw per-token latents against the reference's ``prefill_packed`` (its
    Pallas kernel in interpret mode, the stream a 128-token tile), ``pos``
    -1 on pads."""
    cfg_j, cfg_t = _configs(n_experts=0, first_k_dense=0)
    tree = _tree(cfg_j, seed=1)
    params = params_from_jax(jax.device_get(tree), cfg_t, device="cpu", dtype=torch.float32)
    lens, C = (37, 50, 20), 128
    rng = np.random.default_rng(5)
    toks, seg = np.zeros((1, C), np.int32), np.full((1, C), -1, np.int32)
    positions, gather = np.zeros((1, C), np.int32), np.zeros((3,), np.int32)
    off = 0
    for i, n in enumerate(lens):
        toks[0, off:off + n] = rng.integers(0, cfg_t.vocab_size, n)
        seg[0, off:off + n], positions[0, off:off + n] = i, np.arange(n)
        gather[i] = off + n - 1
        off += n
    lj, cj = TJ.prefill_packed(tree, cfg_j, *map(jnp.asarray, (toks, positions, seg, gather)),
                               impl="pallas_interpret", compute_dtype=jnp.float32)
    lt, ct = T.prefill_packed(params, cfg_t, *map(T_, (toks, positions, seg, gather)),
                              compute_dtype=torch.float32)
    _close(lt, lj, KERNEL_TOL, "logits")
    for gj, gt in zip(cj["stack"], ct["stack"]):
        leaves_j, leaves_t = gj["u0"]["attn"], gt["u0"]["attn"]
        assert set(leaves_t) == {"ckv", "kr", "pos"}
        for name in ("ckv", "kr"):
            _close(leaves_t[name], leaves_j[name], KERNEL_TOL, name)
        np.testing.assert_array_equal(leaves_t["pos"].numpy(), np.asarray(leaves_j["pos"]))
        assert (leaves_t["pos"].numpy()[..., seg[0] < 0] == -1).all()


def test_decode_matches_full_forward(model):
    """Prefill then decode token by token against teacher-forced prefills
    of the longer prefix (the reference's rule), f32."""
    cfg_t = model["cfg"][1]
    params = model["f32"]
    seq, steps = 16, 4
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg_t.vocab_size, (1, seq + steps)).astype(np.int32))
    logits, cache = T.prefill(params, cfg_t, toks[:, :seq], kv_cap=seq + steps,
                              compute_dtype=torch.float32)
    inc = [logits]
    for s in range(steps - 1):
        logits, cache = T.decode_step(params, cfg_t, cache, toks[:, seq + s],
                                      torch.tensor([seq + s], dtype=torch.int32),
                                      compute_dtype=torch.float32)
        inc.append(logits)
    for s in range(steps):
        ref, _ = T.prefill(params, cfg_t, toks[:, :seq + s], kv_cap=seq + steps,
                           compute_dtype=torch.float32)
        np.testing.assert_allclose(inc[s].numpy(), ref.numpy(), atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_one_layer_bf16_within_its_bound(model, mode):
    """One MLA layer in bf16 against the reference's in bf16 (prefill on
    ``impl="ref"``; decode over a bf16 pool), 1e-2 of the output's scale."""
    cfg_j, cfg_t = model["cfg"]
    p_j, p_t = _attn(model, dtype="bf16")
    bf = jnp.bfloat16
    if mode == "prefill":
        x = _x((2, 11, 64), 7)
        pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11)).copy()
        kw_j, kw_t = dict(kv_cap=16), dict(kv_cap=16)
    else:
        pool = _pool(cfg_t, seed=8)
        x, pos = _x((3, 1, 64), 7), np.array([[10], [0], [17]], np.int32)
        kw_j = dict(cache={k: jnp.asarray(v).astype(bf if v.dtype == np.float32 else v.dtype)
                           for k, v in pool.items()})
        kw_t = dict(cache={k: T_(v).to(torch.bfloat16 if v.dtype == np.float32 else torch.int32)
                           for k, v in pool.items()})
    want, _ = AJ.apply_mla(p_j, jnp.asarray(x).astype(bf), cfg=cfg_j, mode=mode,
                           pos=jnp.asarray(pos), impl="ref", **kw_j)
    got, _ = AT.apply_mla(p_t, T_(x).bfloat16(), cfg=cfg_t, mode=mode, pos=T_(pos), **kw_t)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), BF16_TOL, mode)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantised_leaves_are_the_references(model, bits):
    """``quantize_params`` quantises what the reference's does: MLA's
    ``wo``, the dense layer's and the shared experts' MLP and ``lm_head``;
    the MLA factors and the expert banks stay fp."""
    def quantised(tree, path=""):
        if isinstance(tree, dict):
            return {p for k, t in tree.items() for p in quantised(t, f"{path}/{k}")}
        if isinstance(tree, list):
            return {p for i, t in enumerate(tree) for p in quantised(t, f"{path}/{i}")}
        return {path} if hasattr(tree, "bits") else set()

    got = quantised(quantize_params(model["f32"], bits))
    assert got == quantised(jax_quantize_params(model["ref"], bits))
    assert got == {"/stack/0/u0/attn/wo", "/stack/1/u0/attn/wo", "/lm_head",
                   *(f"/stack/0/u0/mlp/{k}" for k in ("w_gate", "w_up", "w_down")),
                   *(f"/stack/1/u0/moe/shared/{k}" for k in ("w_gate", "w_up", "w_down"))}


def test_pool_holds_fp_latents_at_every_kv_bits():
    """``init_cache`` gives the latent leaves in the compute dtype whatever
    ``kv_bits``, with the reference's shapes."""
    cfg_j, cfg_t = _configs()
    for bits in (0, 8, 4):
        pj = TJ.init_cache(cfg_j, 2, 16, kv_bits=bits)
        pt = T.init_cache(cfg_t, 2, 16, kv_bits=bits, device="cpu")
        for gj, gt in zip(pj["stack"], pt["stack"]):
            got = {k: (tuple(v.shape), v.dtype) for k, v in gt["u0"]["attn"].items()}
            assert got == {"ckv": ((1, 2, 16, 32), torch.bfloat16),
                           "kr": ((1, 2, 16, 8), torch.bfloat16),
                           "pos": ((1, 2, 16), torch.int32)}
            assert {k: v.shape for k, v in gj["u0"]["attn"].items()} == \
                {k: v[0] for k, v in got.items()}


# ---------------------------------------------------------------------------
# the full-rank query (no q_lora_rank)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def full_rank():
    """Reduced deepseek-v2-236b with ``q_lora_rank=0``: every MLA layer's
    query is the reference's full-rank ``wq`` (D, H, dn + dr)."""
    cfg_j, cfg_t = _configs(q_lora_rank=0)
    tree = _tree(cfg_j, seed=5)
    host = jax.device_get(tree)
    return {"cfg": (cfg_j, cfg_t), "ref": tree, "host": host,
            "f32": params_from_jax(host, cfg_t, device="cpu", dtype=torch.float32)}


def test_full_rank_query_draws_and_converts_the_reference_leaves(full_rank):
    """``init_mla`` without ``q_lora_rank`` draws ``wq`` (R, D, H, dn + dr)
    at the reference's spread and no low-rank pair; the converted tree
    holds the reference's leaves."""
    cfg_j, cfg_t = full_rank["cfg"]
    own = T.init_params(cfg_t, torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.float32)
    attn = own["stack"][1]["u0"]["attn"]
    ref = full_rank["host"]["stack"][1]["u0"]["attn"]
    assert {k for k, _ in attn.items()} == set(ref) == \
        {"wq", "wkv_a", "kv_norm", "wkv_b", "wo"}
    assert tuple(attn["wq"].shape) == ref["wq"].shape == (1, 64, 4, 24)
    np.testing.assert_allclose(attn["wq"].std().item(), np.std(ref["wq"]), rtol=0.15)
    for k, v in ref.items():
        np.testing.assert_array_equal(full_rank["f32"]["stack"][1]["u0"]["attn"][k].numpy(), v)


@pytest.mark.parametrize("mode", ["q", "prefill", "decode", "chunk"])
def test_full_rank_query_matches_reference_f32(full_rank, mode):
    """The query alone, the expanded prefill and the absorbed decode and
    chunk steps of a full-rank layer against the live reference, f32."""
    cfg_j, cfg_t = full_rank["cfg"]
    p_j, p_t = _attn(full_rank)
    if mode == "q":
        x = _x((2, 9, 64), 6)
        pos = np.stack([np.arange(9), np.arange(3, 12)]).astype(np.int32)
        for w, g in zip(AJ._mla_q(p_j, jnp.asarray(x), jnp.asarray(pos), cfg_j),
                        AT._mla_q(p_t, T_(x), T_(pos), cfg_t)):
            _close(g, w, F32_TOL, "q")
        return
    if mode == "prefill":
        x = _x((2, 11, 64), 7)
        pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11)).copy()
        want, _ = AJ.apply_mla(p_j, jnp.asarray(x), cfg=cfg_j, mode="prefill",
                               pos=jnp.asarray(pos), impl="ref", kv_cap=16)
        got, _ = AT.apply_mla(p_t, T_(x), cfg=cfg_t, mode="prefill", pos=T_(pos), kv_cap=16)
        _close(got, want, KERNEL_TOL, "prefill")
        return
    pool = _pool(cfg_t)
    pos = np.array([[10], [-1], [17]], np.int32) if mode == "decode" else \
        np.array([[10, 11, -1], [-1, -1, -1], [17, 18, 19]], np.int32)
    x = _x((3, pos.shape[1], 64), 8)
    want, cj = AJ.apply_mla(p_j, jnp.asarray(x), cfg=cfg_j, mode=mode, pos=jnp.asarray(pos),
                            cache={k: jnp.asarray(v) for k, v in pool.items()}, impl="ref")
    got, ct = AT.apply_mla(p_t, T_(x), cfg=cfg_t, mode=mode, pos=T_(pos),
                           cache={k: T_(v) for k, v in pool.items()})
    _close(got, want, KERNEL_TOL, mode)
    for name in ("ckv", "kr"):
        _close(ct[name], cj[name], KERNEL_TOL, name)
