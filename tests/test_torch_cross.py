"""Cross-attention and the encoder in the port, against the reference,
live, on the CPU: reduced whisper-large-v3 (an encoder of frame
embeddings, a decoder without a position table), bart-base and bart-large
(a text encoder, learned positions) and llama-3.2-vision-90b (gated cross
layers over patch embeddings), each run as the reference runs them:
``prefill`` with the source, then ``decode_step`` over a cache whose cross
entries stay fixed.

Inputs come from numpy with a seed: frames and patches standard normal
(a conv frontend's and a vision projector's outputs are of unit scale),
encoder tokens uniform ids.  The reference's f32 tree is carried over by
``repro_torch.convert`` after its norms, biases and gates are redrawn (the
vision stack's gates are zero at init, tanh(0) = 0, which would make every
cross layer inert: they are set to 0.5 and 1.0 in both trees).
Tolerances:

- f32 (the whole model, both ``impl``): 2e-5 of the tensor's scale (at
  least 1), logits and every cache leaf, as ``test_torch_model.py`` holds
  the zoo;
- bf16 at 2 layers: 1e-2 of the scale against the reference's bf16 run
  (the reference computes GELU and SiLU op by op in bf16, so the packages
  drift apart with depth);
- the incremental decode against a teacher-forced prefill over the longer
  prefix, in the port itself: 5e-2 absolute and relative (the reference's
  ``tests/test_models.py`` rule), f32;
- ``kv_bits`` 8: in f32 the self-attention codes within one code step
  of the reference's, their scales 1e-5 relative, the cross leaves at the
  f32 bound in the compute dtype; in bf16 the dequantised values by
  ``test_torch_model.py``'s row rule, the cross leaves bf16;
- the kernels' plain prefill, non-causal with Sq != Skv: 2e-5 of the
  scale against the reference's Pallas kernel in interpret mode (Sq 128,
  Skv 256, where its alignment rule takes the shape) and its oracle (Sq 5,
  Skv 24).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import reduce_config as jax_reduce_config
from repro.kernels.flash_attention.ops import attention as jax_attention
from repro.models import transformer as TJ
from repro.quant.core import quantize_params as jax_quantize_params
from repro_torch.ckpt import flatten_tree
from repro_torch.config import get_config, reduce_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.quant.core import quantize_params
from repro_torch.serving.engine import ServingEngine
from test_torch_model import _compare_dequantised

ARCHS = ("whisper-large-v3", "bart-base", "bart-large", "llama-3.2-vision-90b")
FAMILIES = ("whisper-large-v3", "bart-base", "llama-3.2-vision-90b")
F32_TOL = 2e-5
BF16_TOL = 1e-2
DECODE_TOL = 5e-2
S, KV_CAP, STEPS, B = 6, 12, 4, 2
GATES = {"gate_attn": 0.5, "gate_mlp": 1.0}


def _cfgs(arch, **replace):
    return (dataclasses.replace(jax_reduce_config(jax_get_config(arch)), **replace),
            dataclasses.replace(reduce_config(get_config(arch)), **replace))


def _two_layers(arch):
    """The bf16 configuration: 2 layers.  Reduced whisper and bart have 2
    encoder and 2 decoder layers already; the vision stack takes one global
    and one gated cross layer, so that a cross layer stays in it."""
    if arch == "llama-3.2-vision-90b":
        return dict(n_layers=2, pattern=("global", "cross"))
    return {}


def _redrawn(tree, rng):
    """The reference's tree with its norms, biases and gates redrawn (norm
    scales 1 + 0.1 N, biases 0.1 N, the gates ``GATES``); weights as
    drawn."""
    def visit(path, a):
        key = str(getattr(path[-1], "key", ""))
        a = np.asarray(a)
        if key in GATES:
            return np.full(a.shape, GATES[key], np.float32)
        if key in ("bq", "bk", "bv", "b_up", "b_down", "bias"):
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if key == "scale":
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(visit, jax.device_get(tree))


def _model(arch, seed=0, **replace):
    cfg_j, cfg_t = _cfgs(arch, **replace)
    tree = _redrawn(TJ.init_params(cfg_j, jax.random.PRNGKey(seed), param_dtype=jnp.float32),
                    np.random.default_rng(seed))
    return cfg_j, cfg_t, tree


def _source(cfg, rng, batch=B):
    """The source of one prefill, as numpy: {reference batch key: array}."""
    if cfg.family == "audio":
        return {"frames": rng.standard_normal(
            (batch, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        return {"image_embeds": rng.standard_normal(
            (batch, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)}
    return {"encoder_tokens": rng.integers(0, cfg.vocab_size, (batch, 11)).astype(np.int32)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


def _flat_ref(tree):
    """{``/``-joined path: leaf} of a reference tree, the port's key layout."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _run_both(arch, impl, *, jdt=jnp.float32, tdt=torch.float32, kv_bits=0, seed=0,
              **replace):
    """prefill with the source, then ``STEPS`` decode steps, in both
    packages on the same inputs: [(logits_j, cache_j, logits_t, cache_t)]
    after the prefill and after each step (the reference's cache flattened,
    the port's copied, since it is updated in place)."""
    cfg_j, cfg_t, tree = _model(arch, seed, **replace)
    pt = params_from_jax(tree, cfg_t, device="cpu", dtype=tdt)
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, cfg_t.vocab_size, (B, S)).astype(np.int32)
    src = _source(cfg_t, rng)
    steps = rng.integers(0, cfg_t.vocab_size, (STEPS, B)).astype(np.int32)
    lj, cj = TJ.prefill(tree, cfg_j, {"tokens": jnp.asarray(toks),
                                      **{k: jnp.asarray(v) for k, v in src.items()}},
                        impl="ref" if impl == "ref" else "flash", compute_dtype=jdt,
                        kv_cap=KV_CAP, kv_bits=kv_bits)
    with torch.no_grad():
        lt, ct = T.prefill(pt, cfg_t, _t(toks), impl=impl, compute_dtype=tdt, kv_cap=KV_CAP,
                           kv_bits=kv_bits, **{k: _t(v) for k, v in src.items()})
    out = [(lj, _flat_ref(cj), lt, flatten_tree(ct))]
    for s in range(STEPS):
        pos = np.full((B,), S + s, np.int32)
        lj, cj = TJ.decode_step(tree, cfg_j, cj, jnp.asarray(steps[s]), jnp.asarray(pos),
                                impl="ref" if impl == "ref" else "flash", compute_dtype=jdt)
        with torch.no_grad():
            lt, ct = T.decode_step(pt, cfg_t, ct, _t(steps[s]), _t(pos), impl=impl,
                                   compute_dtype=tdt)
        out.append((lj, _flat_ref(cj), lt, flatten_tree(ct)))
    return out


# ---------------------------------------------------------------------------
# configs and parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_groups_match_the_reference(arch):
    """Full and reduced configs field for field (reduced: 16 source
    entries, two encoder layers where there is an encoder), and the
    decoder's and encoder's groups."""
    for full in (True, False):
        cj = jax_get_config(arch) if full else jax_reduce_config(jax_get_config(arch))
        ct = get_config(arch) if full else reduce_config(get_config(arch))
        for f in dataclasses.fields(ct):
            assert getattr(ct, f.name) == getattr(cj, f.name), f.name
        for enc in (False, True):
            assert [(g.units, g.repeats) for g in T.build_groups(ct, encoder=enc)] == \
                [(g.units, g.repeats) for g in TJ.build_groups(cj, encoder=enc)]
    ct = reduce_config(get_config(arch))
    assert ct.n_frontend_tokens == 16
    assert T.needs_source(ct) and T.needs_source(get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_names_shapes_and_dtypes_match_the_reference(arch):
    """The port's own draw, the converted reference tree and the
    reference's tree hold the same leaves with the same shapes; gates,
    biases and norms stay f32, the encoder's and cross projections take
    the weights' dtype; whisper has no position table, bart has one."""
    cfg_j, cfg_t, tree = _model(arch)
    want = {k.replace("/", "."): tuple(np.shape(v)) for k, v in _flat_ref(tree).items()}
    own = T.init_params(cfg_t, torch.Generator().manual_seed(0), device="cpu")
    meta = T.init_params(cfg_t, None, device="meta")
    conv = params_from_jax(tree, cfg_t, device="cpu", dtype=torch.bfloat16)
    for m in (own, meta, conv):
        assert {n: tuple(p.shape) for n, p in m.named_parameters()} == want
    f32 = ("gate_attn", "gate_mlp", "bq", "bk", "bv", "b_up", "b_down", "scale", "bias")
    for m in (own, conv):
        for n, p in m.named_parameters():
            assert p.dtype == (torch.float32 if n.rsplit(".", 1)[-1] in f32
                               else torch.bfloat16), n
    assert ("embed.pos" in want) == arch.startswith("bart")
    assert ("encoder.0.u0.attn.wq" in want) == (arch != "llama-3.2-vision-90b")
    if arch == "llama-3.2-vision-90b":
        cross = own["stack"][0]["u4"]
        assert {k for k, _ in cross.items()} == {"ln1", "attn", "gate_attn", "ln2", "mlp",
                                                 "gate_mlp"}
        assert float(cross["gate_attn"].abs().sum()) == 0.0
    else:
        assert {"ln_cross", "cross"} <= {k for k, _ in own["stack"][0]["u0"].items()}
        assert "cross" not in {k for k, _ in own["encoder"][0]["u0"].items()}


def test_whisper_decoder_takes_sinusoidal_positions():
    """No table on either side, and the decoder's embedding is the token
    row plus the sinusoid of its position, as the reference's."""
    cfg_j, cfg_t, tree = _model("whisper-large-v3")
    assert "pos" not in tree["embed"] and cfg_t.max_abs_positions == 64
    pt = params_from_jax(tree, cfg_t, device="cpu", dtype=torch.float32)
    toks = np.array([[3, 7, 9]], np.int32)
    pos = np.array([[0, 5, 40]], np.int32)
    hj = TJ.embed_tokens(tree, cfg_j, jnp.asarray(toks), jnp.asarray(pos), jnp.float32)
    ht = T.embed_tokens(pt, cfg_t, _t(toks), _t(pos), torch.float32)
    _close(ht, hj, F32_TOL, "embedding")
    assert not torch.allclose(ht[0, 1], pt["embed"]["tok"][7])


# ---------------------------------------------------------------------------
# prefill and decode against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["flash", "ref"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference_f32(arch, impl):
    """Logits and every cache leaf (self and cross) after the prefill and
    each of 4 decode steps, f32; ``flash`` runs the kernels' plain
    versions (the prefill non-causal with Sq != Skv, the cross decode at
    q_pos = Skv)."""
    for i, (lj, cj, lt, ct) in enumerate(_run_both(arch, impl)):
        _close(lt, lj, F32_TOL, f"logits {i}")
        assert set(ct) == set(cj)
        for k in cj:
            assert ct[k].dtype == (torch.int32 if k.endswith("pos") else torch.float32), k
            _close(ct[k], cj[k], F32_TOL, f"{k} at {i}")


@pytest.mark.parametrize("arch", ["whisper-large-v3", "bart-base", "bart-large"])
def test_two_layer_bf16_matches_the_reference(arch):
    """bf16 at 2 layers within 1e-2 of the logits' scale of the
    reference's bf16 run (f32 parameters in both, cast at use).  The
    vision stack is held in bf16 at ``kv_bits`` 8 (below) and in f32, as
    llama2-7b is: its fp bf16 logits part from the reference's op-by-op
    SiLU by two bf16 ulps of one logit in 512."""
    bf16 = _run_both(arch, "flash", jdt=jnp.bfloat16, tdt=torch.bfloat16,
                     **_two_layers(arch))
    for i, (lj, _, lt, ct) in enumerate(bf16):
        _close(lt, np.asarray(lj, np.float32), BF16_TOL, f"logits {i}")
        cross = [k for k in ct if "/cross/" in k]
        assert cross and all(ct[k].dtype == torch.bfloat16 for k in cross)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_a_teacher_forced_prefill(arch):
    """The port's incremental decode equals its own prefill over the longer
    prefix each step (the reference's ``_decode_matches_prefill``), f32."""
    cfg_j, cfg_t, tree = _model(arch)
    pt = params_from_jax(tree, cfg_t, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(3)
    toks = _t(rng.integers(0, cfg_t.vocab_size, (1, S + STEPS)).astype(np.int32))
    src = {k: _t(v) for k, v in _source(cfg_t, rng, batch=1).items()}
    kw = dict(impl="flash", compute_dtype=torch.float32, kv_cap=S + STEPS)
    with torch.no_grad():
        logits, cache = T.prefill(pt, cfg_t, toks[:, :S], **kw, **src)
        inc = [logits]
        for s in range(STEPS - 1):
            logits, cache = T.decode_step(pt, cfg_t, cache, toks[:, S + s],
                                          torch.full((1,), S + s, dtype=torch.int32),
                                          impl="flash", compute_dtype=torch.float32)
            inc.append(logits)
        for s in range(STEPS):
            full, _ = T.prefill(pt, cfg_t, toks[:, :S + s], **kw, **src)
            np.testing.assert_allclose(inc[s].numpy(), full.numpy(), atol=DECODE_TOL,
                                       rtol=DECODE_TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_leaves_the_cross_caches_unchanged(arch):
    """Every cross leaf is bit for bit the prefill's after the decode
    steps, and every self-attention pool has taken the steps' writes."""
    runs = _run_both(arch, "flash")
    first, last = runs[0][3], runs[-1][3]
    cross = [k for k in first if k.split("/")[-2] == "cross"
             or (arch.startswith("llama") and "/u4/" in k)]
    assert cross
    for k in cross:
        assert torch.equal(first[k], last[k]), k
    moved = [k for k in first if k.endswith("/attn/k") and not torch.equal(first[k], last[k])]
    assert moved


@pytest.mark.parametrize("arch", FAMILIES)
def test_the_source_moves_the_logits(arch):
    """A zeroed source (frames, patches, or encoder tokens all 0) changes
    the prefill's and a decode step's logits: cross-attention is wired."""
    cfg_j, cfg_t, tree = _model(arch)
    pt = params_from_jax(tree, cfg_t, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(4)
    toks = _t(rng.integers(0, cfg_t.vocab_size, (B, S)).astype(np.int32))
    src = _source(cfg_t, rng)
    out = []
    for s in (src, {k: np.zeros_like(v) for k, v in src.items()}):
        with torch.no_grad():
            logits, cache = T.prefill(pt, cfg_t, toks, compute_dtype=torch.float32,
                                      kv_cap=KV_CAP, **{k: _t(v) for k, v in s.items()})
            step, _ = T.decode_step(pt, cfg_t, cache, toks[:, 0],
                                    torch.full((B,), S, dtype=torch.int32),
                                    compute_dtype=torch.float32)
        out.append((logits, step))
    assert float((out[0][0] - out[1][0]).abs().max()) > 1e-3
    assert float((out[0][1] - out[1][1]).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", FAMILIES)
def test_kv8_self_codes_and_fp_cross_leaves(arch):
    """``kv_bits`` 8: in f32 the self-attention pools are int8 codes within
    one code step of the reference's, their f32 scales within 1e-5 of
    theirs, and the cross leaves stay in the compute dtype, equal to the
    reference's at the f32 bound; in bf16 at 2 layers the cross leaves are
    bf16, each dequantised self value within one code step plus
    ``test_torch_model``'s bf16 row bound of the reference's, the logits
    within 1e-2 of their scale."""
    for i, (lj, cj, lt, ct) in enumerate(_run_both(arch, "flash", kv_bits=8)):
        _close(lt, lj, F32_TOL, f"logits {i}")
        codes = [k for k in ct if k.endswith("_q")]
        assert codes and all(ct[k].dtype == torch.int8 for k in codes)
        for k in codes:
            assert int((ct[k].int() - _t(cj[k]).int()).abs().max()) <= 1, k
            _close(ct[k[:-2] + "_s"], cj[k[:-2] + "_s"], 1e-5, k)
        fp = [k for k in ct if k.split("/")[-1] in ("k", "v")]
        assert fp and all(ct[k].dtype == torch.float32 for k in fp)
        for k in fp:
            _close(ct[k], cj[k], F32_TOL, k)
    runs = _run_both(arch, "flash", jdt=jnp.bfloat16, tdt=torch.bfloat16, kv_bits=8,
                     **_two_layers(arch))
    for i, (lj, cj, lt, ct) in enumerate(runs):
        _close(lt, np.asarray(lj, np.float32), BF16_TOL, f"logits {i}")
        fp = [k for k in ct if k.split("/")[-1] in ("k", "v")]
        assert fp and all(ct[k].dtype == torch.bfloat16 for k in fp)
        for k in (k for k in ct if k.endswith("_q")):
            _compare_dequantised(ct[k], ct[k[:-2] + "_s"], cj[k], cj[k[:-2] + "_s"], 8,
                                 f"{k} at {i}")


# ---------------------------------------------------------------------------
# quantiser, cache trees, the kernels' plain prefill, refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("arch", FAMILIES)
def test_quantize_params_leaf_by_leaf(arch, bits):
    """The encoder's and the cross projections are quantised by leaf name
    as the reference's are, code and scale planes equal; the gates, norms,
    biases and embeddings stay as they were."""
    cfg_j, cfg_t, tree = _model(arch)
    pt = params_from_jax(tree, cfg_t, device="cpu", dtype=torch.float32)
    qt = T.Transformer(cfg_t, quantize_params(pt, bits))
    flat_j = jax.tree_util.tree_flatten_with_path(
        jax_quantize_params(tree, bits), is_leaf=lambda x: hasattr(x, "bits"))[0]
    quant_j = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
               for path, leaf in flat_j if hasattr(leaf, "bits")}
    quant_t = {n.rsplit(".", 1)[0] for n, _ in qt.named_buffers() if n.endswith(".q")}
    assert quant_t == set(quant_j)
    assert any(".cross." in n for n in quant_t) or arch.startswith("llama")
    assert any(n.startswith("encoder.") for n in quant_t) or arch.startswith("llama")
    for name, leaf in quant_j.items():
        mod = qt.get_submodule(name)
        np.testing.assert_array_equal(mod.q.numpy(), np.asarray(leaf.q), err_msg=name)
        np.testing.assert_array_equal(mod.scale.numpy(), np.asarray(leaf.scale), err_msg=name)
    fp = dict(qt.named_parameters())
    for name, p in pt.named_parameters():
        if name.rsplit(".", 1)[-1] in ("gate_attn", "gate_mlp", "scale", "bias", "bq", "bk",
                                       "bv", "b_up", "b_down", "tok", "pos"):
            assert torch.equal(fp[name], p), name


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
@pytest.mark.parametrize("arch", FAMILIES)
def test_init_cache_tree_matches_the_reference(arch, kv_bits):
    """The cache tree's keys, shapes and dtypes are the reference's: a
    cross unit the bare {"k", "v"}, a decoder unit of an encoder/decoder
    stack {"attn", "cross"}, the cross leaves in the compute dtype with
    ``n_frontend_tokens`` entries at every ``kv_bits``."""
    cfg_j, cfg_t = _cfgs(arch)
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
            _flat_ref(TJ.init_cache(cfg_j, 3, 24, kv_bits=kv_bits)).items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in flatten_tree(T.init_cache(cfg_t, 3, 24, device="cpu",
                                                 kv_bits=kv_bits)).items()}
    assert got == want
    cross = {k: v for k, v in got.items() if "/cross/" in k or k.split("/")[-2] == "u4"}
    assert cross and all(shape[2] == 16 and dt == "bfloat16" for shape, dt in cross.values())


@pytest.mark.parametrize("shape", [(2, 128, 256, 4, 4, 16), (1, 128, 256, 4, 2, 32),
                                   (2, 5, 24, 4, 4, 16), (1, 24, 5, 4, 2, 16)],
                         ids=["Sq128-Skv256", "Sq128-Skv256-gqa", "Sq5-Skv24", "Sq24-Skv5"])
def test_plain_noncausal_prefill_with_a_source_matches_the_reference(shape):
    """The prefill kernel's plain version, non-causal with Sq != Skv (a
    cross prefill, and Sq > Skv), against the reference's Pallas kernel in
    interpret mode where its alignment rule takes the shape (Sq 128, Skv
    256), and its oracle elsewhere."""
    B, Sq, Skv, Hq, Hkv, hd = shape
    rng = np.random.default_rng(sum(shape))
    q = rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
    impl = "pallas_interpret" if Sq % 128 == 0 and Skv % 128 == 0 else "ref"
    want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                         impl=impl)
    got = attention(_t(q), _t(k), _t(v), causal=False, impl="flash")
    _close(got, want, F32_TOL)
    # and against the port's own oracle
    _close(got, attention(_t(q), _t(k), _t(v), causal=False, impl="ref").numpy(), F32_TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_without_its_source_raises(arch):
    cfg_j, cfg_t, tree = _model(arch)
    pt = params_from_jax(tree, cfg_t, device="cpu", dtype=torch.float32)
    key = next(iter(_source(cfg_t, np.random.default_rng(0))))
    with pytest.raises(ValueError, match=key):
        T.prefill(pt, cfg_t, torch.zeros((1, 4), dtype=torch.int32))


@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_refuses_cross_attention_stacks(arch):
    """The serving engine refuses these stacks at construction and names
    the way to run them, as the reference's cannot serve them either."""
    cfg_t = reduce_config(get_config(arch))
    params = T.init_params(cfg_t, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="prefill"):
        ServingEngine(cfg_t, params, device="cpu")


@pytest.mark.parametrize("arch", FAMILIES)
def test_cli_refuses_cross_attention_stacks(arch):
    with pytest.raises(NotImplementedError, match="decode_step"):
        serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "1"])
