"""The building blocks the paper's Table 3 models bring to the port, each
against the reference, live, on the CPU, on reduced llama2-7b, gpt-j,
bert-base and bert-large: the norm (LayerNorm with a bias for bert,
RMSNorm otherwise), the MLP with its biases (bert) or gated (llama2-7b),
the learned position table's gather (``jnp.take``'s semantics: -1 wraps
to the last row, past the table gives NaN), one whole layer (GPT-J's
parallel block among them), the quantiser leaving the new leaves fp, bart
initialised and its prefill held to the reference's, and a request whose positions run past the table
failing as the reference's does.

Tolerances: f32 to 2e-5 of the tensor's scale (at least 1), bf16 to 1e-2,
as ``test_torch_model.py`` holds them; the gather bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import reduce_config as jax_reduce_config
from repro.models import modules as MJ
from repro.models import transformer as TJ
from repro.quant.core import quantize_params as jax_quantize_params
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.config import get_config, reduce_config
from repro_torch.convert import params_from_jax
from repro_torch.models import modules as M
from repro_torch.models import transformer as T
from repro_torch.quant.core import QuantTensor, quantize_params
from repro_torch.serving.engine import EngineConfig, ServingEngine

PAPER = ("llama2-7b", "gpt-j", "bert-base", "bert-large")
BERT = ("bert-base", "bert-large")
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _cfgs(arch):
    return jax_reduce_config(jax_get_config(arch)), reduce_config(get_config(arch))


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0, err_msg=what)


def _t(tree, dtype=torch.float32):
    """A reference subtree as torch tensors (kept f32: the leaves the port
    keeps f32 are cast at use, the weights rounded to ``dtype``)."""
    if isinstance(tree, dict):
        return {k: _t(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def _randomised(tree, rng):
    """The tree with every leaf redrawn (norm scales, biases and tables
    included, so that the zeros and ones of init hide nothing)."""
    if isinstance(tree, dict):
        return {k: _randomised(v, rng) for k, v in tree.items()}
    return jnp.asarray(rng.standard_normal(np.shape(tree)).astype(np.float32) * 0.5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", PAPER)
def test_norm_matches_reference(arch, dtype):
    """``init_norm`` by ``cfg.norm`` (LayerNorm: a scale of ones and a zero
    bias; RMSNorm: scale - 1, zeros) and ``apply_norm`` (LayerNorm in f32,
    eps 1e-5) with random scale and bias, on the reference's inputs."""
    cfg_j, cfg_t = _cfgs(arch)
    jdt, tdt, tol = DTYPES[dtype]
    pj = MJ.init_norm(jax.random.PRNGKey(0), cfg_j)
    pt = M.init_norm(cfg_t, (cfg_t.d_model,), "cpu")
    assert set(pt) == set(pj) == ({"scale", "bias"} if arch in BERT else {"scale"})
    for k in pj:
        np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pj[k]))
    rng = np.random.default_rng(1)
    pj = _randomised(pj, rng)
    x = (rng.standard_normal((2, 5, cfg_t.d_model)) * 3 + 1).astype(np.float32)
    want = MJ.apply_norm(pj, jnp.asarray(x, jdt))
    got = M.apply_norm(_t(pj), torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    _close(got, want, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", PAPER)
def test_mlp_with_biases_matches_reference(arch, dtype):
    """``init_mlp`` (bert: ``b_up`` and ``b_down``; llama2-7b gated) and
    ``apply_mlp`` with random biases: ``b_up`` before the activation,
    ``b_down`` after the down projection."""
    cfg_j, cfg_t = _cfgs(arch)
    jdt, tdt, tol = DTYPES[dtype]
    pj = MJ.init_mlp(jax.random.PRNGKey(2), cfg_j)
    own = M.init_mlp(torch.Generator().manual_seed(0), cfg_t, repeats=1,
                     dtype=torch.float32, device="cpu")
    assert set(own) == set(pj)
    assert ({"b_up", "b_down"} <= set(pj)) == (arch in BERT)
    assert ("w_gate" in pj) == (arch == "llama2-7b")
    for k, v in own.items():
        assert tuple(v.shape[1:]) == np.shape(pj[k]), k
        if k.startswith("b_"):
            assert v.dtype == torch.float32 and not v.any()
    rng = np.random.default_rng(3)
    pj = _randomised(pj, rng)
    x = rng.standard_normal((2, 7, cfg_t.d_model)).astype(np.float32)
    want = MJ.apply_mlp(pj, jnp.asarray(x, jdt), cfg_j)
    pt = {k: (v if k.startswith("b_") else v.to(tdt)) for k, v in _t(pj).items()}
    got = M.apply_mlp(pt, torch.from_numpy(x).to(tdt), cfg_t, impl="ref")
    _close(got, want, tol)


@pytest.mark.parametrize("arch", BERT)
def test_position_gather_matches_jnp_take(arch):
    """``embed_tokens`` without RoPE adds the learned table's rows at
    ``pos``: -1 (a dead slot) gives the last row, a position inside the
    table its row, and one at or past its end (or below -n) NaN, bit for
    bit as the reference's ``jnp.take``."""
    cfg_j, cfg_t = _cfgs(arch)
    n = cfg_t.max_abs_positions
    rng = np.random.default_rng(4)
    tree = {"embed": {"tok": rng.standard_normal((cfg_t.vocab_size, cfg_t.d_model)),
                      "pos": rng.standard_normal((n, cfg_t.d_model))}}
    tree = {"embed": {k: v.astype(np.float32) for k, v in tree["embed"].items()}}
    pos = np.array([[-1, 0, 5, n - 1], [n, n + 3, -n, -n - 1]], np.int32)
    toks = rng.integers(0, cfg_t.vocab_size, pos.shape).astype(np.int32)
    want = np.asarray(TJ.embed_tokens(jax.tree_util.tree_map(jnp.asarray, tree), cfg_j,
                                      jnp.asarray(toks), jnp.asarray(pos), jnp.float32))
    got = T.embed_tokens({"embed": _t(tree["embed"])}, cfg_t, torch.from_numpy(toks),
                         torch.from_numpy(pos), torch.float32).numpy()
    np.testing.assert_array_equal(got, want)
    nan_rows = np.isnan(got).all(axis=-1)
    assert nan_rows.tolist() == [[False] * 4, [True, True, False, True]]
    np.testing.assert_array_equal(got[0, 0], (tree["embed"]["tok"][toks[0, 0]]
                                               + tree["embed"]["pos"][n - 1]))
    # the table alone, at every index from below -n to past n
    idx = np.arange(-n - 3, n + 3, dtype=np.int32)
    np.testing.assert_array_equal(
        T.take_rows(torch.from_numpy(tree["embed"]["pos"]), torch.from_numpy(idx)).numpy(),
        np.asarray(jnp.take(jnp.asarray(tree["embed"]["pos"]), jnp.asarray(idx), axis=0)))


@pytest.mark.parametrize("arch", PAPER)
def test_layer_matches_reference(arch):
    """One whole layer in prefill, f32, random leaves (norms and biases
    included): gpt-j's parallel block (``x + attn(ln1 x) + mlp(ln1 x)``, no
    ``ln2``), bert's LayerNorm, biases and no RoPE, llama2-7b's MHA; the
    output and the layer's cache."""
    cfg_j, cfg_t = _cfgs(arch)
    pj = jax.tree_util.tree_map(lambda a: a[0], TJ.init_params(
        cfg_j, jax.random.PRNGKey(5), param_dtype=jnp.float32)["stack"][0]["u0"])
    want_keys = {"ln1", "attn", "mlp"} | (set() if cfg_t.parallel_block else {"ln2"})
    assert set(pj) == want_keys
    pj = _randomised(pj, np.random.default_rng(6))
    own = T.init_params(cfg_t, None, device="meta")["stack"][0]["u0"]
    assert {k for k, _ in own.items()} == want_keys
    S = 12
    x = np.random.default_rng(7).standard_normal((1, S, cfg_t.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    xj, cj, _ = TJ._apply_layer(pj, jnp.asarray(x), cfg=cfg_j, kind="global", use_moe=False,
                                mode="prefill", pos=jnp.asarray(pos), cache=None,
                                cross_src=None, impl="ref", causal=True, kv_cap=S)
    xt, ct, _ = T._apply_layer(_t(pj), torch.from_numpy(x), cfg=cfg_t, kind="global",
                            use_moe=False, mode="prefill", pos=torch.from_numpy(pos),
                            cache=None, impl="ref", segments=None, kv_bits=0, kv_cap=S,
                            length=None)
    _close(xt, xj, 2e-5, "layer output")
    for name in ("k", "v"):
        _close(ct["attn"][name], cj["attn"][name], 2e-5, name)
    np.testing.assert_array_equal(ct["attn"]["pos"].numpy(), np.asarray(cj["attn"]["pos"]))


@pytest.mark.parametrize("arch", ["bart-base", "bart-large"])
def test_bart_is_registered_but_not_served(arch):
    """The encoder/decoder configs register (Plane B reads them), the port
    draws bart's tree (encoder, ``encoder_norm``, the decoder's
    ``ln_cross``/``cross``) on the CPU and as shapes alone, the reduced
    model's prefill over encoder tokens gives the reference's logits in
    f32 (2e-5 of their scale), and the serving engine refuses it, as the
    reference's cannot serve it."""
    cfg = get_config(arch)
    assert cfg.n_encoder_layers and cfg.cross_attn_decoder
    assert cfg.encoder_layer_kinds == jax_get_config(arch).encoder_layer_kinds
    cfg_j, cfg_t = _cfgs(arch)
    own = T.init_params(cfg_t, torch.Generator().manual_seed(0), device="cpu")
    meta = T.init_params(cfg, None, device="meta")
    for m in (own, meta):
        names = {n for n, _ in m.named_parameters()}
        assert {"encoder_norm.scale", "encoder.0.u0.attn.wq", "stack.0.u0.cross.wq",
                "stack.0.u0.ln_cross.bias", "embed.pos"} <= names
    tree = jax.device_get(TJ.init_params(cfg_j, jax.random.PRNGKey(3), param_dtype=jnp.float32))
    pt = params_from_jax(tree, cfg_t, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg_t.vocab_size, (2, 9)).astype(np.int32)
    src = rng.integers(0, cfg_t.vocab_size, (2, 13)).astype(np.int32)
    lj, _ = TJ.prefill(tree, cfg_j, {"tokens": jnp.asarray(toks),
                                     "encoder_tokens": jnp.asarray(src)},
                       impl="flash", compute_dtype=jnp.float32)
    lt, _ = T.prefill(pt, cfg_t, torch.from_numpy(toks), compute_dtype=torch.float32,
                      encoder_tokens=torch.from_numpy(src))
    _close(lt, lj, 2e-5, "logits")
    with pytest.raises(NotImplementedError, match="cross-attention"):
        ServingEngine(cfg_t, own, device="cpu")


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("arch", PAPER)
def test_quantize_params_keeps_new_leaves_fp(arch, bits):
    """Weight-only quantisation takes the projections alone: biases,
    ``embed.pos`` and the LayerNorm leaves stay fp and untouched, and the
    quantised leaves are the reference's, code planes equal."""
    cfg_j, cfg_t = _cfgs(arch)
    tree = jax.device_get(TJ.init_params(cfg_j, jax.random.PRNGKey(8),
                                         param_dtype=jnp.float32))
    pt = params_from_jax(tree, cfg_t, device="cpu", dtype=torch.float32)
    qt = T.Transformer(cfg_t, quantize_params(pt, bits))
    qj = jax_quantize_params(tree, bits)
    quant_t = {n.rsplit(".", 1)[0] for n, _ in qt.named_buffers() if n.endswith(".q")}
    flat_j = jax.tree_util.tree_flatten_with_path(
        qj, is_leaf=lambda x: hasattr(x, "bits"))[0]
    quant_j = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
               for path, leaf in flat_j if hasattr(leaf, "bits")}
    assert quant_t == set(quant_j) and quant_t
    fp = dict(qt.named_parameters())
    for name, p in pt.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("b_up", "b_down", "bias", "scale", "bq", "bk", "bv") or \
                name == "embed.pos":
            assert torch.equal(fp[name], p), name
    assert ("embed.pos" in fp) == (arch in BERT)
    for name, leaf in quant_j.items():
        mod = qt.get_submodule(name)
        assert isinstance(mod.tensor(), QuantTensor) and mod.bits == bits
        np.testing.assert_array_equal(mod.q.numpy(), np.asarray(leaf.q), err_msg=name)


def test_positions_past_the_table_fail_the_request_as_the_reference():
    """Reduced bert-base (a 64-row table) in a pool of 96 positions: a
    request that runs past the table gets NaN logits there and fails
    (``failed_anomaly``) after the same tokens in both engines, and every
    request ends as the reference's does."""
    cfg_j, cfg_t = _cfgs("bert-base")
    tree = TJ.init_params(cfg_j, jax.random.PRNGKey(0), param_dtype=jnp.float32)
    settings = dict(max_batch=2, kv_len=96, prefill_chunk=32, max_new_tokens=12,
                    impl="flash")
    eng_j = JaxServingEngine(cfg_j, tree, JaxEngineConfig(**settings))
    eng_t = ServingEngine(cfg_t, params_from_jax(jax.device_get(tree), cfg_t, device="cpu"),
                          EngineConfig(**settings), device="cpu")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg_t.vocab_size, size=n) for n in (58, 9, 20)]
    reqs = {}
    for name, eng in (("ref", eng_j), ("port", eng_t)):
        reqs[name] = [eng.submit(p) for p in prompts]
        eng.run_until_drained()
    for a, b in zip(reqs["port"], reqs["ref"]):
        assert a.status == b.status and len(a.output) == len(b.output)
    # the third request takes the failed one's slot, whose NaN K/V rows
    # past the table stay in the pool (masked, but NaN times a zero weight
    # is NaN): it fails too, in both engines
    assert [r.status for r in reqs["port"]] == ["failed_anomaly", "done", "failed_anomaly"]
    # the prefill's token, then decodes at positions 58..63: the one at 64 is NaN
    assert len(reqs["port"][0].output) == cfg_t.max_abs_positions - 58 + 1
    for key in ("finished", "prefill_calls", "decode_steps"):
        assert eng_t.stats()[key] == eng_j.stats()[key], key
