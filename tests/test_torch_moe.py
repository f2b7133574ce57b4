"""The port's mixture-of-experts slice against the reference, live, on the
CPU: reduced qwen3-moe-30b-a3b (8 experts, top-2, d_model 64, 2 layers).

- ``models/moe.py::apply_moe`` in ``prefill`` and ``decode`` against
  ``repro.models.moe.apply_moe`` (its dropless path) on converted
  parameters: f32 within 1e-5; bf16 within 1e-2 of the output's scale of
  the f32 oracle (one bf16 ulp of an output in [1, 2) is 7.8e-3, and both
  packages round the expert products, the activation and the weighted
  sum to bf16);
- the grouped matmul's plain version against ``jax.lax.ragged_dot`` with
  empty groups (f32, 1e-5);
- ``n_shared_experts`` and ``first_k_dense`` through
  ``dataclasses.replace``, model-level prefill logits in f32 (1e-5 of
  their scale);
- ``quantize_params`` quantising what the reference quantises and
  leaving every expert bank fp;
- the engine at fp, kv8, w8kv8 and w4kv4 against the reference engine
  (``tests/test_torch_serving.py``'s comparison: the same schedule,
  streams equal but at a reference near-tie), its prompts admitted one a
  call, right-padded to a chunk multiple;
- ``packed=True`` (chunk-multiple pads) against ``packed=False``
  (power-of-two buckets): equal streams, since dropless routing makes
  every row independent of the pads;
- ``spec_k`` refused with the reference's message;
- a snapshot taken mid-decode restores and finishes bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import reduce_config as jax_reduce_config
from repro.models import moe as MJ
from repro.models import transformer as TJ
from repro.quant.core import quantize_params as jax_quantize_params
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.config import get_config, reduce_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.grouped_matmul.kernel import grouped_matmul_fwd
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref
from repro_torch.models import modules as M
from repro_torch.models import moe as MT
from repro_torch.models import transformer as T
from repro_torch.quant.core import QuantTensor, quantize_params
from repro_torch.serving import checkpoint as sc
from repro_torch.serving.engine import EngineConfig, ServingEngine
from test_torch_serving import QUANT_CASES, _compare_engines

ARCH = "qwen3-moe-30b-a3b"
F32_TOL = 1e-5
BF16_TOL = 1e-2


def _configs(**replace):
    cfg_j = dataclasses.replace(jax_reduce_config(jax_get_config(ARCH)), **replace)
    cfg_t = dataclasses.replace(reduce_config(get_config(ARCH)), **replace)
    return cfg_j, cfg_t


@pytest.fixture(scope="module")
def model():
    cfg_j, cfg_t = _configs()
    params_j = TJ.init_params(cfg_j, jax.random.PRNGKey(0), param_dtype=jnp.float32)
    host = jax.device_get(params_j)
    return {"cfg": (cfg_j, cfg_t), "ref": params_j,
            "f32": params_from_jax(host, cfg_t, device="cpu", dtype=torch.float32),
            "bf16": params_from_jax(host, cfg_t, device="cpu", dtype=torch.bfloat16)}


def _moe_layer(params, r=0):
    """The MoE subtree of repeat ``r`` of the first layer."""
    return T._layer(params["stack"][0]["u0"]["moe"], r)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_apply_moe_matches_reference_f32(model, mode):
    cfg_j, cfg_t = model["cfg"]
    p_j = jax.tree_util.tree_map(lambda a: a[1], model["ref"]["stack"][0]["u0"]["moe"])
    x = np.random.default_rng(0).standard_normal((3, 7 if mode == "prefill" else 1, 64))
    x = x.astype(np.float32)
    want = np.asarray(MJ.apply_moe(p_j, jnp.asarray(x), cfg_j, mode=mode))
    got = MT.apply_moe(_moe_layer(model["f32"], 1), torch.from_numpy(x), cfg_t,
                       mode=mode).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_apply_moe_bf16_within_its_bound_of_the_f32_oracle(model, mode):
    cfg_j, cfg_t = model["cfg"]
    p_j = jax.tree_util.tree_map(lambda a: a[0], model["ref"]["stack"][0]["u0"]["moe"])
    x = np.random.default_rng(1).standard_normal((4, 6 if mode == "prefill" else 1, 64))
    x = x.astype(np.float32)
    oracle = np.asarray(MJ.apply_moe(p_j, jnp.asarray(x), cfg_j, mode=mode))
    got = MT.apply_moe(_moe_layer(model["bf16"]), torch.from_numpy(x).bfloat16(), cfg_t,
                       mode=mode)
    assert got.dtype == torch.bfloat16
    # the routing is the oracle's: the bf16 router input moves no top-2 here
    gates_t, idx_t = MT.route(_moe_layer(model["bf16"]), torch.from_numpy(x).bfloat16(),
                              cfg_t)
    probs = jax.nn.softmax(jnp.asarray(x) @ p_j["router"], axis=-1)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(jax.lax.top_k(probs, 2)[1]))
    scale = max(1.0, float(np.abs(oracle).max()))
    assert float(np.abs(got.float().numpy() - oracle).max()) <= BF16_TOL * scale


def test_grouped_matmul_plain_matches_ragged_dot():
    """Groups of 0, 5, 0, 1, 9 and 0 rows (empty ones first, between and
    last) against ``jax.lax.ragged_dot``."""
    rng = np.random.default_rng(2)
    sizes = np.array([0, 5, 0, 1, 9, 0], np.int32)
    x = rng.standard_normal((int(sizes.sum()), 24)).astype(np.float32)
    w = rng.standard_normal((len(sizes), 24, 40)).astype(np.float32)
    want = np.asarray(jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sizes)))
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32))
    got = grouped_matmul_fwd(torch.from_numpy(x), torch.from_numpy(w), offsets)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)
    # the plain version is the CPU path, and the wrapper counts no launch there
    assert grouped_matmul_fwd.launches == 0
    assert torch.equal(got, grouped_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                                               offsets))


def test_grouped_matmul_wrapper_refuses_bad_operands():
    x, w = torch.zeros((4, 8)), torch.zeros((3, 8, 16))
    with pytest.raises(ValueError, match="must be"):
        grouped_matmul_fwd(x, w, torch.zeros((3,), dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        grouped_matmul_fwd(x, w, torch.zeros((4,), dtype=torch.int64))


def _model_logits(cfg_j, cfg_t, params_j, params_t):
    """Last-token logits of a prefill of two 9-token rows, both packages,
    f32."""
    toks = np.random.default_rng(3).integers(0, cfg_t.vocab_size, (2, 9)).astype(np.int32)
    lj, _ = TJ.prefill(params_j, cfg_j, {"tokens": jnp.asarray(toks)}, impl="ref",
                        compute_dtype=jnp.float32)
    lt, _ = T.prefill(params_t, cfg_t, torch.from_numpy(toks), impl="ref",
                       compute_dtype=torch.float32, kv_cap=16)
    return np.asarray(lj), lt.numpy()


@pytest.mark.parametrize("replace", [dict(n_shared_experts=1), dict(first_k_dense=1)],
                         ids=["shared_experts", "first_k_dense"])
def test_shared_experts_and_first_k_dense_match_reference(replace):
    cfg_j, cfg_t = _configs(**replace)
    params_j = TJ.init_params(cfg_j, jax.random.PRNGKey(4), param_dtype=jnp.float32)
    params_t = params_from_jax(jax.device_get(params_j), cfg_t, device="cpu",
                               dtype=torch.float32)
    groups = T.build_groups(cfg_t)
    assert [(g.units, g.repeats) for g in groups] == \
        [(g.units, g.repeats) for g in TJ.build_groups(cfg_j)]
    if "first_k_dense" in replace:
        assert [g.units for g in groups] == [(("global", False),), (("global", True),)]
    else:
        assert "shared" in params_t["stack"][0]["u0"]["moe"]
    want, got = _model_logits(cfg_j, cfg_t, params_j, params_t)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=F32_TOL * scale, rtol=0)


def test_shared_experts_take_no_mlp_bias_as_the_reference():
    """With ``mlp_bias=True`` the dense layer's MLP has ``b_up``/``b_down``
    and the shared experts' MLP has none, in both packages (the reference
    builds it with ``mlp_bias=False``): the port's own tree has the
    reference's names and shapes, the shared leaves carry over unchanged,
    and the logits match with the dense biases drawn non-zero."""
    cfg_j, cfg_t = _configs(n_shared_experts=1, first_k_dense=1, mlp_bias=True)
    host = jax.device_get(TJ.init_params(cfg_j, jax.random.PRNGKey(6),
                                         param_dtype=jnp.float32))
    dense, shared = host["stack"][0]["u0"]["mlp"], host["stack"][1]["u0"]["moe"]["shared"]
    assert set(shared) == {"w_gate", "w_up", "w_down"}
    assert {"b_up", "b_down"} <= set(dense)
    rng = np.random.default_rng(6)
    for k in ("b_up", "b_down"):
        dense[k] = rng.standard_normal(dense[k].shape).astype(np.float32)
    params_t = params_from_jax(host, cfg_t, device="cpu", dtype=torch.float32)
    own = T.init_params(cfg_t, None, device="meta")
    assert {n: tuple(p.shape) for n, p in own.named_parameters()} == \
        {n: tuple(p.shape) for n, p in params_t.named_parameters()}
    got = params_t["stack"][1]["u0"]["moe"]["shared"]
    assert {n for n, _ in got.items()} == set(shared)
    for k, v in shared.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    want, out = _model_logits(cfg_j, cfg_t, jax.tree_util.tree_map(jnp.asarray, host),
                              params_t)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(out, want, atol=F32_TOL * scale, rtol=0)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_leaves_every_expert_leaf_fp(bits):
    """The port quantises the leaves the reference quantises (attention,
    the shared experts' MLP, the untied head) and leaves the 4-D expert
    banks and the router fp."""
    cfg_j, cfg_t = _configs(n_shared_experts=1)
    params_j = TJ.init_params(cfg_j, jax.random.PRNGKey(5), param_dtype=jnp.float32)
    params_t = params_from_jax(jax.device_get(params_j), cfg_t, device="cpu",
                               dtype=torch.float32)

    def quantised(tree, path=""):
        if isinstance(tree, dict):
            return {p for k, t in tree.items() for p in quantised(t, f"{path}/{k}")}
        if isinstance(tree, list):
            return {p for i, t in enumerate(tree) for p in quantised(t, f"{path}/{i}")}
        return {path} if hasattr(tree, "bits") else set()

    tree_t = quantize_params(params_t, bits)
    got = quantised(tree_t)
    assert got == quantised(jax_quantize_params(params_j, bits))
    moe = tree_t["stack"][0]["u0"]["moe"]
    assert all(isinstance(moe["experts"][k], torch.Tensor) and moe["experts"][k].dim() == 4
               for k in ("w_gate", "w_up", "w_down"))
    assert isinstance(moe["router"], torch.Tensor)
    assert {"/stack/0/u0/moe/shared/w_up", "/stack/0/u0/attn/wq", "/lm_head"} <= got
    assert isinstance(T.Transformer(cfg_t, tree_t)["stack"][0]["u0"]["moe"]["shared"]["w_up"],
                      T.QuantWeight)


def test_param_tree_holds_a_dict_that_mixes_tensors_and_dicts():
    """The MoE subtree: a tensor (``router``) beside a dict (``experts``)."""
    t = torch.ones((2, 3))
    tree = T._as_module({"router": t, "experts": {"w_up": t * 2},
                         "q": QuantTensor(torch.ones((2, 4, 3), dtype=torch.int8),
                                          torch.ones((2, 1, 3)), 8)})
    assert torch.equal(tree["router"], t) and torch.equal(tree["experts"]["w_up"], t * 2)
    assert sorted(k for k, _ in tree.items()) == ["experts", "q", "router"]
    assert sorted(n for n, _ in tree.named_parameters()) == ["experts.w_up", "router"]
    assert sorted(n for n, _ in tree.named_buffers()) == ["q.q", "q.scale"]
    view = T._layer(tree, 1)
    assert torch.equal(view["router"], t[1]) and view["q"].q.shape == (4, 3)


def test_large_leaves_are_drawn_a_repeat_at_a_time(monkeypatch):
    """Above ``WHOLE_DRAW_MAX`` elements a stacked leaf is drawn one repeat
    at a time into its dtype; below it the draw is the whole-leaf draw, so
    the dense models keep their weights."""
    def draw(shape):
        return M.dense_init(torch.Generator().manual_seed(0), shape, torch.bfloat16, "cpu")

    whole = draw((3, 8, 16))
    g = torch.Generator().manual_seed(0)
    per = torch.stack([M.dense_init(g, (8, 16), torch.bfloat16, "cpu") for _ in range(3)])
    monkeypatch.setattr(M, "WHOLE_DRAW_MAX", 200)      # one repeat is 128
    split = draw((3, 8, 16))
    assert split.dtype == torch.bfloat16 and torch.equal(split, per)
    assert not torch.equal(split, whole)
    assert float(split.float().abs().max()) <= 2.0 / 8 ** 0.5


@pytest.mark.parametrize("case", ["fp"] + sorted(QUANT_CASES))
def test_moe_engine_matches_reference_engine(monkeypatch, case):
    """The same schedule as the reference engine (one padded prefill call
    a request) and the same streams but at near-ties."""
    eng_j, eng_t = _compare_engines(monkeypatch, ARCH, **QUANT_CASES.get(case, {}))
    st = eng_t.stats()
    assert st["prefill_calls"] == st["finished"]


def test_padded_and_bucketed_admission_give_the_same_streams(model):
    """``packed=True`` pads each prompt to a chunk multiple (16, 32),
    ``packed=False`` to a power-of-two bucket (8..32): the pad rows are
    routed too, but dropless routing keeps every row to itself."""
    cfg_t = model["cfg"][1]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg_t.vocab_size, size=n) for n in (5, 23, 9, 12, 3, 17)]
    pads, streams = {}, {}
    for packed in (True, False):
        eng = ServingEngine(cfg_t, model["bf16"], EngineConfig(
            max_batch=3, kv_len=64, prefill_chunk=16, max_new_tokens=8, impl="flash",
            packed=packed), device="cpu")
        shapes, prefill = set(), eng.executor.prefill
        eng.executor.prefill = lambda toks, n: (shapes.add(toks.shape[1]), prefill(toks, n))[1]
        for p in prompts:
            eng.submit(p)
        eng.run_until_drained()
        pads[packed] = sorted(shapes)
        streams[packed] = [r.output for r in sorted(eng.finished, key=lambda r: r.uid)]
    assert pads == {True: [16, 32], False: [8, 16, 32]}
    assert streams[True] == streams[False]


def test_spec_k_is_refused_with_the_reference_message(model):
    cfg_j, cfg_t = model["cfg"]
    settings = dict(max_batch=2, kv_len=32, spec_k=2)
    with pytest.raises(ValueError, match="needs a packable stack") as port:
        ServingEngine(cfg_t, model["bf16"], EngineConfig(**settings), device="cpu")
    with pytest.raises(ValueError, match="needs a packable stack") as ref:
        JaxServingEngine(cfg_j, model["ref"], JaxEngineConfig(**settings))
    assert str(port.value) == str(ref.value)


def test_moe_snapshot_restores_bit_for_bit(model, tmp_path):
    """A snapshot taken mid-decode (one prompt still queued), a request in
    the journal only and two steps the crash throws away: the restored
    engine finishes every request with the uninterrupted run's streams."""
    cfg_t = model["cfg"][1]
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg_t.vocab_size, size=n) for n in (8, 5, 19, 11, 6)]
    ecfg = EngineConfig(max_batch=3, kv_len=48, prefill_chunk=8, max_new_tokens=6,
                        temperature=0.8, seed=0)

    def engine():
        return ServingEngine(cfg_t, model["f32"], ecfg, device="cpu")

    eng = engine()
    for p in prompts[:4]:
        eng.submit(p.copy())
    for _ in range(3):
        eng.step()
    eng.submit(prompts[4].copy())
    eng.run_until_drained()
    want = {r.uid: list(r.output) for r in eng.finished}

    eng = engine()
    ck = sc.EngineCheckpointer(eng, str(tmp_path))
    for p in prompts[:4]:
        ck.submit(p.copy())
    for _ in range(3):
        eng.step()
    assert eng.queue and any(r is not None for r in eng.pool.slot_req)
    ck.save()
    ck.submit(prompts[4].copy())
    eng.step()
    eng.step()
    del eng
    eng2 = ServingEngine.restore(cfg_t, model["f32"], str(tmp_path), device="cpu")
    eng2.run_until_drained()
    assert {r.uid: list(r.output) for r in eng2.finished} == want
    assert eng2.stats()["restores"] == 1


def test_params_keep_the_reference_names_and_layout(model):
    """The MoE subtree converts with the reference's names and shapes: the
    router f32, the expert banks ``(repeats, E, K, N)`` in the compute
    dtype; the port's own init draws the same names, shapes and
    spreads."""
    cfg_t = model["cfg"][1]
    tree = jax.device_get(model["ref"])
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    names = {n.replace(".", "/"): p for n, p in model["bf16"].named_parameters()}
    assert set(names) == set(flat)
    f32 = ("scale", "q_norm", "k_norm", "router")
    for n, leaf in flat.items():
        assert tuple(names[n].shape) == leaf.shape, n
        assert names[n].dtype == (torch.float32 if n.rsplit("/", 1)[-1] in f32
                                  else torch.bfloat16), n
    assert names["stack/0/u0/moe/experts/w_down"].shape == (2, 8, 32, 64)
    own = T.init_params(cfg_t, torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.float32)
    for n, p in own.named_parameters():
        ref = flat[n.replace(".", "/")]
        assert tuple(p.shape) == ref.shape, n
        np.testing.assert_allclose(p.std().item(), np.std(ref), rtol=0.1, atol=1e-6,
                                   err_msg=n)


def test_launcher_serves_the_reduced_model():
    """``python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b
    --reduced --device cpu``."""
    import contextlib
    import io

    from repro_torch.launch import serve
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "3",
                    "--kv-len", "64", "--max-new-tokens", "4"])
    assert f"arch={ARCH}" in out.getvalue()
