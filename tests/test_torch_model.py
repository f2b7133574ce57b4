"""The port's model against the reference's, live, on reduced qwen2.5-3b,
gemma2-9b, gemma3-27b and minitron-8b.

The reference's f32 parameter tree (``repro.models.transformer.init_params``)
goes through ``repro_torch.convert``; both sides then run packed prefill,
two chunked-prefill continuations and a teacher-forced run of decode steps
on the same numpy inputs.  Logits and every cache leaf are compared after
each call — ``pos`` exactly, including the writes dropped at ``pos=-1``
(a dead slot, chunk pads).

Tolerances: f32 to 2e-5 (the reference's kernel pin).  bf16 to 1e-2 of
each tensor's scale (its largest magnitude, at least 1): a bf16 value of
magnitude m moves by up to m/128 on one rounding flip, the two sides sum the
attention in different orders, and RoPE rotates the error of a large
component into a small one, so an elementwise relative bound would
measure the rotation, not the port.  In bf16 both sides run
``impl="flash"``: the reference's Pallas kernels in interpret mode, the
port's kernel wrappers (their plain versions on CPU).

Quantised cases (``w8kv8``, ``w4kv4``) run the reference's parameters as
its engine quantises them (``quantize_params`` of the f32 tree; the port
quantises the same f32 values, so the code planes are equal) over a
quantised slot pool.  In f32 the bounds above hold as they are: cache
codes may differ by 1 where the values feeding them differ in their last
bit (a tie of ``round(x / scale)`` that the last bit decides); the test
counts those entries and bounds their share to 1e-3; scales agree to 2e-5,
positions exactly.

In bf16 the quantiser re-rounds each K/V row to 8 or 4 bits, which turns
a last-bit difference of a value into a whole code step (1/127 or 1/7 of
the row's largest magnitude), and the next layer reads those steps; so the
bf16 cases hold the cache's codes by what they hold: each dequantised
value within one code step of its row plus 5e-2 of the row's largest
magnitude (the worst seen is 5 int8 steps, 3.9%).  Scales keep the file's
1e-2.  With ``impl="ref"`` both sides round the dequantised weights to
bf16 and the logits keep the file's 1e-2.  With ``impl="flash"`` they do
not compute with the same weights: the reference's CPU ``qdense`` takes
its fallback, which rounds every dequantised weight to bf16 (relative
2^-9), while the port's plain version keeps them in f32 as the Pallas
kernel does; at w8kv8 the logits part by up to 0.9% of their scale, and
the bound is 3e-2.  (At w4kv4 that difference moves a row's largest K
value, and with it the row's scale, by up to 9% in the second layer: the
w4kv4 flash path is held here in f32, and in bf16 by the engine test.)
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import reduce_config as jax_reduce_config
from repro.models import transformer as TJ
from repro.quant.core import quantize_params as jax_quantize_params
from repro_torch.config import get_config, reduce_config
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as TT
from repro_torch.quant.core import QMAX, dequantize_kv, quantize_params, unpack_int4

# case -> (compute dtype, impl, weight_bits, kv_bits)
CASES = {"f32-ref": (np.float32, "ref", 0, 0), "f32-flash": (np.float32, "flash", 0, 0),
         "bf16-flash": ("bf16", "flash", 0, 0),
         "w8kv8-f32-ref": (np.float32, "ref", 8, 8),
         "w4kv4-f32-flash": (np.float32, "flash", 4, 4),
         "w8kv8-bf16-flash": ("bf16", "flash", 8, 8),
         "w4kv4-bf16-ref": ("bf16", "ref", 4, 4)}
CODE_FLIP_SHARE = 1e-3          # f32: share of codes one step apart
QUANT_BF16_LOGIT_TOL = 3e-2      # bf16 quantised flash cases (see the docstring)
QUANT_BF16_ROW_TOL = 5e-2
B, KV_LEN, C = 3, 48, 16


# the dense zoo models beside qwen2.5-3b: gemma2-9b (local ring and global
# layers, post-norms, embedding scale, both softcaps, GELU GLU), gemma3-27b
# (qk-norm, a local RoPE theta) and minitron-8b (untied lm_head, ReLU^2
# without GLU).  Reduced gemma3-27b has 7 layers (one pattern period and
# the remainder) against the others' 2, and is held in f32 only: in bf16
# the reference computes SiLU and GELU op by op in bf16 (about 40% of the
# activations differ from a once-rounded f32 one), so the two packages'
# caches part by up to 2.4% of their scale by its seventh layer (the
# reference's 3.0% and the port's 5.0% from the f32 run), and at w8kv8
# the code flips of the f32 bounds move its last decode step's logits by
# up to 4e-5.
ZOO = ("gemma2-9b", "gemma3-27b", "minitron-8b")
ZOO_CASES = [(arch, case) for arch in ZOO for case in ("f32-ref", "f32-flash")] + \
    [(arch, case) for arch in ("gemma2-9b", "minitron-8b")
     for case in ("bf16-flash", "w8kv8-f32-ref")]


def _reduced(arch, **change):
    """The reduced config of ``arch`` in both packages (with ``change``
    applied to both) and the reference's f32 parameter tree for it."""
    import dataclasses
    cfg_j = dataclasses.replace(jax_reduce_config(jax_get_config(arch)), **change)
    cfg_t = dataclasses.replace(reduce_config(get_config(arch)), **change)
    tree = jax.device_get(TJ.init_params(cfg_j, jax.random.PRNGKey(0),
                                         param_dtype=jnp.float32))
    return cfg_j, cfg_t, tree


@pytest.fixture(scope="module")
def models():
    return _reduced("qwen2.5-3b")


@pytest.fixture(scope="module")
def zoo():
    return {arch: _reduced(arch) for arch in ZOO}


def _dtypes(dtype):
    return ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
            else (jnp.float32, torch.float32))


def _close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    if tol > 1e-3:                       # bf16: relative to the tensor's scale
        atol, rtol = tol * max(1.0, float(np.abs(want).max())), 0.0
    else:
        atol = rtol = tol
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=rtol,
                               err_msg=what)


def _compare_codes(got, want, bits, where):
    """f32: codes at most one step apart, in at most CODE_FLIP_SHARE of the
    entries."""
    want = torch.from_numpy(np.array(want))
    if bits == 4:
        got, want = unpack_int4(got), unpack_int4(want)
    diff = (got.int() - want.int()).abs()
    flips = int((diff > 0).sum())
    assert int(diff.max()) <= 1, f"{where}: codes {int(diff.max())} steps apart"
    assert flips <= CODE_FLIP_SHARE * diff.numel(), \
        f"{where}: {flips} of {diff.numel()} codes differ"


def _compare_dequantised(codes, scale, codes_j, scale_j, bits, where):
    """bf16: each dequantised value within one code step of its row plus
    QUANT_BF16_ROW_TOL of the row's largest magnitude."""
    scale_j = torch.from_numpy(np.array(scale_j))
    got = dequantize_kv(codes, scale, bits)
    want = dequantize_kv(torch.from_numpy(np.array(codes_j)), scale_j, bits)
    bound = (QUANT_BF16_ROW_TOL * QMAX[bits] + 1.0) * scale_j
    excess = float(((got - want).abs() - bound[..., None]).max())
    assert excess <= 0, f"{where}: dequantised values apart by {excess:.3g} beyond the bound"


def _compare_cache(ct, cj, tol, what, dtype=np.float32, kv_bits=0):
    for gi, (gt, gj) in enumerate(zip(ct["stack"], cj["stack"])):
        for unit in gj:
            pool_t, pool_j = gt[unit]["attn"], gj[unit]["attn"]
            assert set(pool_t) == set(pool_j)
            for name, leaf in pool_j.items():
                got = pool_t[name]
                where = f"{what}: stack[{gi}].{unit}.attn.{name}"
                assert tuple(got.shape) == leaf.shape, where
                if name == "pos":
                    np.testing.assert_array_equal(got.numpy(), np.asarray(leaf),
                                                  err_msg=where)
                elif name in ("k_q", "v_q") and dtype == "bf16":
                    s = name[0] + "_s"
                    _compare_dequantised(got, pool_t[s], leaf, pool_j[s], kv_bits, where)
                elif name in ("k_q", "v_q"):
                    _compare_codes(got, leaf, kv_bits, where)
                else:
                    _close(got, leaf, tol, where)


def _prefill_chunk_decode_match(cfg_j, cfg_t, tree, case):
    """Packed prefill, two chunked continuations and three decode steps of
    both packages on the same inputs: logits and every cache leaf."""
    dtype, impl, wbits, kvbits = CASES[case]
    tol = 1e-2 if dtype == "bf16" else 2e-5
    logit_tol = QUANT_BF16_LOGIT_TOL if dtype == "bf16" and wbits and impl == "flash" \
        else tol
    jdt, tdt = _dtypes(dtype)
    if wbits:
        # quantised from the same f32 values on both sides
        pt = TT.Transformer(cfg_t, quantize_params(
            params_from_jax(tree, cfg_t, device="cpu", dtype=torch.float32), wbits))
        tree = jax_quantize_params(tree, wbits)
    else:
        pt = params_from_jax(tree, cfg_t, device="cpu", dtype=tdt)
    cmp = dict(dtype=dtype, kv_bits=kvbits)
    rng = np.random.default_rng(1)
    V = cfg_t.vocab_size
    T = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731

    # -- packed prefill: 3 prompts + a pad tail in one (1, 2C) stream ------
    S, lens = 2 * C, [7, 12, 5]
    toks = rng.integers(0, V, (1, S)).astype(np.int32)
    seg = np.full((1, S), -1, np.int32)
    pos = np.zeros((1, S), np.int32)
    off = 0
    for i, n in enumerate(lens):
        seg[0, off:off + n], pos[0, off:off + n] = i, np.arange(n)
        off += n
    gather = np.cumsum(lens).astype(np.int32) - 1
    lj, cj = TJ.prefill_packed(tree, cfg_j, toks, pos, seg, gather, impl=impl,
                               compute_dtype=jdt, kv_bits=kvbits)
    lt, ct = TT.prefill_packed(pt, cfg_t, T(toks), T(pos), T(seg), T(gather),
                               impl=impl, compute_dtype=tdt, kv_bits=kvbits)
    _close(lt, lj, logit_tol, "packed prefill logits")
    _compare_cache(ct, cj, tol, "packed prefill cache", **cmp)

    # -- chunked continuation: row 0 full chunks, row 1 a padded chunk, row 2
    #    inactive (all pads: every write dropped) ---------------------------
    cache_j = TJ.init_cache(cfg_j, B, KV_LEN, dtype=jdt, kv_bits=kvbits)
    cache_t = TT.init_cache(cfg_t, B, KV_LEN, dtype=tdt, device="cpu", kv_bits=kvbits)
    starts = [0, 0]
    for step, takes in enumerate([(C, 10), (C, 6)]):
        toks = rng.integers(0, V, (B, C)).astype(np.int32)
        cpos = np.full((B, C), -1, np.int32)
        for r, c in enumerate(takes):
            cpos[r, :c] = starts[r] + np.arange(c)
            starts[r] += c
        take = np.array([takes[0] - 1, takes[1] - 1, 0], np.int32)
        lj, cache_j = TJ.chunk_prefill_step(tree, cfg_j, cache_j, toks, cpos, take,
                                            impl=impl, compute_dtype=jdt)
        lt, cache_t = TT.chunk_prefill_step(pt, cfg_t, cache_t, T(toks), T(cpos),
                                            T(take), impl=impl, compute_dtype=tdt)
        _close(lt, lj, logit_tol, f"chunk {step} logits")
        _compare_cache(cache_t, cache_j, tol, f"chunk {step} cache", **cmp)

    # -- teacher-forced decode: row 2 is a dead slot (pos -1, write dropped)
    for step in range(3):
        toks = rng.integers(0, V, (B,)).astype(np.int32)
        dpos = np.array([starts[0] + step, starts[1] + step, -1], np.int32)
        lj, cache_j = TJ.decode_step(tree, cfg_j, cache_j, toks, dpos, impl=impl,
                                     compute_dtype=jdt)
        lt, cache_t = TT.decode_step(pt, cfg_t, cache_t, T(toks), T(dpos),
                                     impl=impl, compute_dtype=tdt)
        _close(lt, lj, logit_tol, f"decode {step} logits")
        _compare_cache(cache_t, cache_j, tol, f"decode {step} cache", **cmp)
    assert torch.all(cache_t["stack"][0]["u0"]["attn"]["pos"][:, 2] == -1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_chunk_decode_match_reference(models, case):
    _prefill_chunk_decode_match(*models, case)


@pytest.mark.parametrize("arch,case", ZOO_CASES)
def test_zoo_prefill_chunk_decode_match_reference(zoo, arch, case):
    _prefill_chunk_decode_match(*zoo[arch], case)


@pytest.mark.parametrize("change", [dict(tie_embeddings=False), dict(final_softcap=30.0),
                                    dict(act="gelu"), dict(glu=False)])
def test_model_options_match_reference(change):
    """Each option of the zoo alone, on reduced qwen2.5-3b: an untied
    lm_head, the final softcap, the GELU GLU, the plain MLP."""
    _prefill_chunk_decode_match(*_reduced("qwen2.5-3b", **change), "f32-flash")


def test_embedding_scale_and_final_softcap_round_as_the_reference():
    """embed_tokens and unembed of gemma2-9b at its real d_model 3584 (a
    vocab of 64), bf16, bit for bit against the reference's: the embedding
    times sqrt(3584) rounded to bf16 (59.75, not 59.87), and the final
    softcap's tanh taken in f32, rounded to bf16, then scaled.  One-hot
    hidden rows make the logits exact copies of table entries, so the
    softcap alone sets them; tied and untied."""
    import dataclasses
    cfg_j = dataclasses.replace(jax_get_config("gemma2-9b"), vocab_size=64)
    cfg_t = dataclasses.replace(get_config("gemma2-9b"), vocab_size=64)
    rng = np.random.default_rng(7)
    D, V = cfg_t.d_model, cfg_t.vocab_size
    table = (rng.standard_normal((V, D)) * 40).astype(np.float32)
    tj = {"embed": {"tok": jnp.asarray(table, jnp.bfloat16)}}
    tt = {"embed": {"tok": torch.from_numpy(table).to(torch.bfloat16)}}
    toks = rng.integers(0, V, (2, 5)).astype(np.int32)
    ej = TJ.embed_tokens(tj, cfg_j, jnp.asarray(toks), jnp.zeros((2, 5), jnp.int32),
                         jnp.bfloat16)
    et = TT.embed_tokens(tt, cfg_t, torch.from_numpy(toks).long(), torch.bfloat16)
    assert torch.equal(et.float(), torch.from_numpy(np.asarray(ej, np.float32)))
    assert not torch.equal(et, (tt["embed"]["tok"][toks].float()
                                * math.sqrt(D)).to(torch.bfloat16))
    hid = np.eye(D, dtype=np.float32)[rng.choice(D, 8, replace=False)][None]  # (1, 8, D)
    for tied in (True, False):
        cj = dataclasses.replace(cfg_j, tie_embeddings=tied)
        ct = dataclasses.replace(cfg_t, tie_embeddings=tied)
        if not tied:
            tj["lm_head"] = jnp.asarray(table.T, jnp.bfloat16)
            tt["lm_head"] = torch.from_numpy(table.T.copy()).to(torch.bfloat16)
        lj = TJ.unembed(tj, cj, jnp.asarray(hid, jnp.bfloat16))
        lt = TT.unembed(tt, ct, torch.from_numpy(hid).to(torch.bfloat16))
        assert lt.dtype == torch.bfloat16
        assert torch.equal(lt.float(), torch.from_numpy(np.asarray(lj, np.float32))), tied
        assert float(lt.float().abs().max()) > 25        # the softcap bends them


def test_convert_rejects_a_foreign_tree(models):
    _, cfg_t, tree = models
    bad = dict(tree, stack=[{"u0": dict(tree["stack"][0]["u0"], extra={"w": np.zeros(3)})}])
    with pytest.raises(ValueError, match="does not match"):
        params_from_jax(bad, cfg_t, device="cpu")


def _names_and_layout_match(cfg_t, tree):
    pt = params_from_jax(tree, cfg_t, device="cpu", dtype=torch.bfloat16)
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    names = {n.replace(".", "/"): p for n, p in pt.named_parameters()}
    assert set(names) == set(flat)
    for n, leaf in flat.items():
        assert tuple(names[n].shape) == leaf.shape, n
        assert names[n].dtype == (torch.float32 if n.rsplit("/", 1)[-1] in
                                  ("bq", "bk", "bv", "scale", "q_norm", "k_norm")
                                  else torch.bfloat16), n
    # the port's own init draws the same names, shapes and spreads
    own = TT.init_params(cfg_t, torch.Generator().manual_seed(0), device="cpu",
                         dtype=torch.float32)
    for n, p in own.named_parameters():
        ref = flat[n.replace(".", "/")]
        assert tuple(p.shape) == ref.shape, n
        np.testing.assert_allclose(p.std().item(), np.std(ref), rtol=0.1, atol=1e-6,
                                   err_msg=n)
    return set(names)


def test_params_keep_the_reference_names_and_layout(models):
    _, cfg_t, tree = models
    _names_and_layout_match(cfg_t, tree)


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_params_keep_the_reference_names_and_layout(zoo, arch):
    """Besides the shared names: gemma2/3's post-norms, gemma3's f32
    q_norm/k_norm, minitron's lm_head and no w_gate."""
    _, cfg_t, tree = zoo[arch]
    names = _names_and_layout_match(cfg_t, tree)
    leaves = {part for n in names for part in n.split("/")}
    assert ("ln1_post" in leaves) == ("ln2_post" in leaves) == (arch != "minitron-8b")
    assert ("q_norm" in leaves) == ("k_norm" in leaves) == (arch == "gemma3-27b")
    assert ("lm_head" in names) == ("w_gate" not in leaves) == (arch == "minitron-8b")


# ---------------------------------------------------------------------------
# local (sliding-window, ring-buffer) caches, on reduced gemma2-9b's
# attention geometry: window 16 = ring capacity, softcap 50
# ---------------------------------------------------------------------------

def _gemma_cfgs():
    import dataclasses
    from repro_torch.config import ModelConfig
    cfg_j = jax_reduce_config(jax_get_config("gemma2-9b"))
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    return cfg_j, ModelConfig(**{f: getattr(cfg_j, f) for f in fields})


def test_local_ring_attention_matches_reference():
    """Chunks that wrap the 16-entry ring (with pads and an idle row), then
    decode steps, through the local attention layer of both packages."""
    from repro.models.attention import apply_attention as jax_apply
    from repro.models.attention import init_attention as jax_init
    from repro.models.attention import init_kv_cache as jax_cache
    from repro_torch.models.attention import apply_attention, init_kv_cache
    cfg_j, cfg_t = _gemma_cfgs()
    pj = jax_init(jax.random.PRNGKey(3), cfg_j)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    B, C, D = 2, 12, cfg_t.d_model
    cj = jax_cache(cfg_j, "local", B, 48, jnp.float32)
    ct = init_kv_cache(cfg_t, "local", B, 48, torch.float32, "cpu")
    assert tuple(ct["pos"].shape) == (B, cfg_t.window)
    rng = np.random.default_rng(4)
    steps = []
    for start, n1 in [(0, 7), (12, 0), (24, 0)]:         # row 1 idles after 7
        pos = np.full((B, C), -1, np.int32)
        pos[0] = start + np.arange(C)
        pos[1, :n1] = np.arange(n1)
        steps.append(("chunk", pos))
    for t in range(3):
        steps.append(("decode", np.array([[36 + t], [7 + t]], np.int32)))
    for mode, pos in steps:
        x = rng.standard_normal((B, pos.shape[1], D)).astype(np.float32)
        oj, cj = jax_apply(pj, jnp.asarray(x), cfg=cfg_j, kind="local", mode=mode,
                           pos=jnp.asarray(pos), cache=cj, impl="flash")
        ot, ct = apply_attention(pt, torch.from_numpy(x), cfg=cfg_t, kind="local",
                                 mode=mode, pos=torch.from_numpy(pos), cache=ct,
                                 impl="flash")
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=2e-5, rtol=2e-5,
                                   err_msg=mode)
        np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))
        for name in ("k", "v"):
            np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]),
                                       atol=2e-5, rtol=2e-5, err_msg=name)


def test_packed_insert_into_ring_and_global_caches_matches_reference():
    """The engine's multi-slot scatter of a packed stream: a 20-token
    segment overflows the 16-entry local ring (only its last 16 tokens
    stay), a 9-token one fits; slot 1 is inactive."""
    from repro.serving.engine import EngineConfig as JaxEngineConfig
    from repro.serving.executor import Executor as JaxExecutor
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.executor import Executor
    cfg_j, cfg_t = _gemma_cfgs()
    B, S, C = 3, 48, 32
    cache_j = TJ.init_cache(cfg_j, B, S, dtype=jnp.float32)
    cache_t = TT.init_cache(cfg_t, B, S, dtype=torch.float32, device="cpu")
    seg = np.full((1, C), -1, np.int32)
    pos = np.zeros((1, C), np.int32)
    seg[0, :20], pos[0, :20] = 0, np.arange(20)
    seg[0, 20:29], pos[0, 20:29] = 2, np.arange(9)
    seg_len = np.array([20, 0, 9], np.int32)
    active = np.array([True, False, True])
    rng = np.random.default_rng(5)
    Hkv, hd = cfg_t.n_kv_heads, cfg_t.head_dim
    pstack = [{u: {"attn": {
        "k": rng.standard_normal((1, 1, C, Hkv, hd)).astype(np.float32),
        "v": rng.standard_normal((1, 1, C, Hkv, hd)).astype(np.float32),
        "pos": np.where(seg >= 0, pos, -1)[None]}} for u in ("u0", "u1")}]
    jex = JaxExecutor(cfg_j, None, JaxEngineConfig(max_batch=B, kv_len=S))
    new_j = jex._packed_insert(cache_j, jax.tree_util.tree_map(jnp.asarray, pstack),
                               jnp.asarray(seg), jnp.asarray(pos),
                               jnp.asarray(seg_len), jnp.asarray(active))
    ex = Executor(cfg_t, None, EngineConfig(max_batch=B, kv_len=S), device="cpu")
    T = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    ex.packed_insert(cache_t, [{u: {"attn": {k: T(a) for k, a in c["attn"].items()}}
                                for u, c in pstack[0].items()}],
                     T(seg), T(pos), T(seg_len), T(active))
    for u in ("u0", "u1"):
        for name in ("k", "v", "pos"):
            np.testing.assert_array_equal(
                cache_t["stack"][0][u]["attn"][name].numpy(),
                np.asarray(new_j["stack"][0][u]["attn"][name]), err_msg=f"{u}.{name}")


# ---------------------------------------------------------------------------
# non-segmented prefill (the sequential baseline): one right-padded prompt
# whose cache is exact at ``length``
# ---------------------------------------------------------------------------

# (kind, stream S, length, kv_cap) on reduced gemma2-9b's geometry (ring of
# 16): a wrapped ring, a short prompt in a long pad, a wrapped ring under
# pads, a padded global cache, one with no padding
FILL_CASES = [("local", 24, 24, 48), ("local", 24, 11, 48), ("local", 32, 20, 48),
              ("local", 8, 5, 48), ("global", 24, 17, 48), ("global", 16, 16, 16)]


@pytest.mark.parametrize("kind,S,length,kv_cap", FILL_CASES)
def test_unsegmented_prefill_cache_is_the_reference_bit_for_bit(kind, S, length, kv_cap):
    """``_ring_fill`` (local) and ``_pad_cache``/``_pad_pos`` (global) on the
    same f32 K/V as the reference's: equal bit for bit, pads out of the
    ring and past ``length``."""
    from repro.models import attention as AJ
    from repro_torch.models import attention as AT
    rng = np.random.default_rng(8)
    k = rng.standard_normal((1, S, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, S, 2, 8)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    if kind == "local":
        cap = min(16, kv_cap)
        want = AJ._ring_fill(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), cap,
                             length=jnp.int32(length))
        got = AT._ring_fill(torch.from_numpy(k), torch.from_numpy(v), cap, length)
        assert int(got[2].max()) == length - 1 and int((got[2] >= 0).sum()) == min(cap, length)
    else:
        want = (AJ._pad_cache(jnp.asarray(k), kv_cap), AJ._pad_cache(jnp.asarray(v), kv_cap),
                AJ._pad_pos(jnp.asarray(pos), kv_cap))
        got = (AT._pad_cache(torch.from_numpy(k), kv_cap),
               AT._pad_cache(torch.from_numpy(v), kv_cap),
               AT._pad_pos(torch.from_numpy(pos), kv_cap))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert np.array_equal(g.numpy(), np.asarray(w))


# (arch, case, prompt length in a stream of 24): the ring wraps at 20
UNSEGMENTED = [(arch, case, n) for arch in ("qwen2.5-3b", "gemma2-9b")
               for case in ("f32-flash", "w8kv8-f32-ref") for n in (13, 20)]


@pytest.mark.parametrize("arch,case,length", UNSEGMENTED)
def test_unsegmented_prefill_matches_reference(arch, case, length):
    """``prefill`` of one right-padded prompt (stream 24, ``kv_cap`` 48,
    ``length`` 13 or 20): logits at ``length - 1`` and every cache leaf
    against the reference's, with the file's f32 bounds; then the engine's
    insert of that cache into a pool slot, as the reference's executor
    inserts it (``pos`` at or past ``length`` invalidated)."""
    from repro.serving.engine import EngineConfig as JaxEngineConfig
    from repro.serving.executor import Executor as JaxExecutor
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.executor import Executor
    cfg_j, cfg_t, tree = _reduced(arch)
    _, impl, wbits, kvbits = CASES[case]
    if wbits:
        pt = TT.Transformer(cfg_t, quantize_params(
            params_from_jax(tree, cfg_t, device="cpu", dtype=torch.float32), wbits))
        tree = jax_quantize_params(tree, wbits)
    else:
        pt = params_from_jax(tree, cfg_t, device="cpu", dtype=torch.float32)
    S = 24
    toks = np.zeros((1, S), np.int32)
    toks[0, :length] = np.random.default_rng(9).integers(0, cfg_t.vocab_size, length)
    lj, cj = TJ.prefill(tree, cfg_j, {"tokens": jnp.asarray(toks)}, impl=impl,
                        compute_dtype=jnp.float32, kv_cap=48, length=jnp.int32(length),
                        kv_bits=kvbits)
    lt, ct = TT.prefill(pt, cfg_t, torch.from_numpy(toks), impl=impl,
                        compute_dtype=torch.float32, kv_cap=48, length=length,
                        kv_bits=kvbits)
    _close(lt, lj, 2e-5, "prefill logits")
    _compare_cache(ct, cj, 2e-5, "prefill cache", kv_bits=kvbits)
    settings = dict(max_batch=B, kv_len=48, kv_bits=kvbits)
    pool_j = TJ.init_cache(cfg_j, B, 48, dtype=jnp.float32, kv_bits=kvbits)
    pool_t = TT.init_cache(cfg_t, B, 48, dtype=torch.float32, device="cpu", kv_bits=kvbits)
    pool_j = JaxExecutor(cfg_j, None, JaxEngineConfig(**settings))._insert_fn(
        pool_j, cj, jnp.int32(1), jnp.int32(length))
    Executor(cfg_t, None, EngineConfig(**settings), device="cpu").insert(
        pool_t, ct, 1, length)
    _compare_cache(pool_t, pool_j, 2e-5, "inserted cache", kv_bits=kvbits)


@pytest.mark.parametrize("n,n_loc", [(12, 40), (40, 40), (64, 24)])
def test_unique_targets_give_every_write_its_own_target(n, n_loc):
    """The scatter behind the ring write and the packed insert: kept
    entries at their locations, every dropped one at a location of its
    own that no kept entry takes, all targets distinct, also with more
    entries than locations (a chunk longer than its ring)."""
    from repro_torch.models.attention import put_unique, unique_targets
    rng = np.random.default_rng(n)
    k = min(n, n_loc) // 2
    loc = rng.integers(-3, n_loc + 3, n)               # dropped entries point anywhere
    kept = rng.choice(n, k, replace=False)
    loc[kept] = rng.choice(n_loc, k, replace=False)    # kept locations are distinct
    keep = np.zeros(n, bool)
    keep[kept] = True
    sel, tgt, kp = unique_targets(torch.from_numpy(loc), torch.from_numpy(keep), n_loc)
    sel, tgt, kp = sel.numpy(), tgt.numpy(), kp.numpy()
    assert len(set(tgt.tolist())) == len(tgt) == min(n, n_loc)
    assert sorted(sel[kp].tolist()) == sorted(kept.tolist())
    assert np.array_equal(tgt[kp], loc[sel[kp]])
    assert not set(tgt[~kp].tolist()) & set(loc[kept].tolist())
    # the write, on a (2, n_loc / 4, 4, 3) tensor with a leading axis
    pool = torch.from_numpy(rng.standard_normal((2, n_loc // 4, 4, 3)))
    vals = torch.from_numpy(rng.standard_normal((2, n, 3)))
    want = pool.clone()
    want.view(2, n_loc, 3)[:, loc[keep]] = vals[:, keep]
    put_unique(pool, torch.from_numpy(sel), torch.from_numpy(tgt), torch.from_numpy(kp),
               vals, lead=1)
    assert torch.equal(pool, want)


def test_chunk_longer_than_its_ring_matches_reference():
    """A 24-token chunk through a 16-entry local ring (only its last 16
    positions stay): the ring write with more entries than ring slots."""
    from repro.models.attention import apply_attention as jax_apply
    from repro.models.attention import init_attention as jax_init
    from repro.models.attention import init_kv_cache as jax_cache
    from repro_torch.models.attention import apply_attention, init_kv_cache
    cfg_j, cfg_t = _gemma_cfgs()
    pj = jax_init(jax.random.PRNGKey(6), cfg_j)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    B, C, D = 2, 24, cfg_t.d_model
    cj = jax_cache(cfg_j, "local", B, 48, jnp.float32)
    ct = init_kv_cache(cfg_t, "local", B, 48, torch.float32, "cpu")
    rng = np.random.default_rng(6)
    for start in (0, 24):
        pos = np.full((B, C), -1, np.int32)
        pos[0] = start + np.arange(C)
        pos[1, :5] = start + np.arange(5)
        x = rng.standard_normal((B, C, D)).astype(np.float32)
        oj, cj = jax_apply(pj, jnp.asarray(x), cfg=cfg_j, kind="local", mode="chunk",
                           pos=jnp.asarray(pos), cache=cj, impl="flash")
        ot, ct = apply_attention(pt, torch.from_numpy(x), cfg=cfg_t, kind="local",
                                 mode="chunk", pos=torch.from_numpy(pos), cache=ct,
                                 impl="flash")
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=2e-5, rtol=2e-5)
        np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))
        for name in ("k", "v"):
            np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]),
                                       atol=2e-5, rtol=2e-5, err_msg=name)
