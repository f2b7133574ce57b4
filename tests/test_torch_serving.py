"""The port's serving engine against the reference's, live, on the CPU, on
reduced qwen2.5-3b and reduced gemma2-9b (its local ring through the
engine).

Both engines serve the same prompts with the same weights (the reference's
f32 tree, carried over by ``repro_torch.convert`` into bf16 — the values
the reference's bf16 compute casts them to), greedy, ``impl="flash"``:
``max_batch=3``, ``kv_len=64``, ``prefill_chunk=16``, one prompt longer
than the chunk so chunked continuation runs.

The schedule must match exactly.  Token streams must match too, except
where greedy decoding meets a near-tie: at the first token where a stream
diverges, the reference's top-1 minus top-2 logit margin must be below
twice the bf16 logit tolerance (2 x 1e-2), or the test fails.

The quantised engines (the reference's golden cases ``kv8``, ``w8kv8``,
``w4kv4``) run the same comparison.  Both engines quantise their own copy
of the weights at construction; the port gets the f32 values (stored f32,
cast at use), so the two quantise the same numbers into the same codes.
Both then compute with the weights as their kernels do, dequantised to f32
(the port's plain version; the reference's Pallas kernel in interpret
mode, which its CPU dispatch would otherwise replace by a fallback that
rounds every dequantised weight to bf16: at w4kv4 the int4 KV codes turn
that rounding into logits apart by more than the near-tie bound).  The
near-tie margin is the reference model's own on its quantised weights,
through the same kernel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import reduce_config as jax_reduce_config
from repro.models import transformer as TJ
from repro.quant.core import quantize_params
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.config import get_config, reduce_config
from repro_torch.convert import params_from_jax
from repro_torch.serving.engine import EngineConfig, ServingEngine

SETTINGS = dict(max_batch=3, kv_len=64, prefill_chunk=16, max_new_tokens=8,
                impl="flash")
PROMPT_LENS = [5, 23, 9, 12, 3, 17]
BF16_LOGIT_TOL = 1e-2
SCHEDULE_KEYS = ("finished", "prefill_calls", "prefill_tokens", "decode_steps",
                 "gen_lens", "prompt_lens", "active_slots_hist",
                 "max_stall_tokens", "host_transfers", "host_bytes")


def _margin(params, cfg, prompt, out, t):
    """The reference's top-1 minus top-2 logit margin for token ``t`` of a
    stream (bf16 compute, the engine's precision)."""
    seq = np.concatenate([prompt, np.asarray(out[:t], np.int32)])[None]
    logits, _ = TJ.prefill(params, cfg, {"tokens": jnp.asarray(seq)}, impl="ref",
                           compute_dtype=jnp.bfloat16)
    top = np.sort(np.asarray(logits[0], np.float32))[-2:]
    return float(top[1] - top[0])


# the reference's golden quantised cases (tests/test_layering.py)
QUANT_CASES = {"kv8": dict(kv_bits=8), "w8kv8": dict(weight_bits=8, kv_bits=8),
               "w4kv4": dict(weight_bits=4, kv_bits=4)}


def _reference_kernel_matmul(monkeypatch):
    """The reference's dequant-matmul through its Pallas kernel in
    interpret mode wherever its grid tiles the shape (as on its TPU)."""
    import repro.quant.ops as ops
    fallback = ops.quant_matmul
    monkeypatch.setattr(ops, "quant_matmul",
                        lambda x, qt, impl="auto": fallback(x, qt, impl="pallas_interpret"))


def _compare_engines(monkeypatch, arch="qwen2.5-3b", **bits):
    """Both engines over the same prompts; ``bits`` are further
    ``EngineConfig`` fields of both (the precision, a baseline path,
    ``decode_chunk``, ``eos_token``...).  Returns (reference, port)."""
    settings = dict(SETTINGS, **bits)
    if bits.get("weight_bits"):
        _reference_kernel_matmul(monkeypatch)
    cfg_j = jax_reduce_config(jax_get_config(arch))
    cfg_t = reduce_config(get_config(arch))
    params_j = TJ.init_params(cfg_j, jax.random.PRNGKey(0), param_dtype=jnp.float32)
    # quantised weights: the f32 values, as the reference quantises them
    params_t = params_from_jax(jax.device_get(params_j), cfg_t, device="cpu",
                               dtype=torch.float32 if bits.get("weight_bits")
                               else torch.bfloat16)
    eng_j = JaxServingEngine(cfg_j, params_j, JaxEngineConfig(**settings))
    eng_t = ServingEngine(cfg_t, params_t, EngineConfig(**settings), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg_t.vocab_size, size=n) for n in PROMPT_LENS]
    for p in prompts:
        eng_j.submit(p)
        eng_t.submit(p)
    eng_j.run_until_drained()
    eng_t.run_until_drained()

    sj, st = eng_j.stats(), eng_t.stats()
    assert set(st) == {k for k in sj if not k.startswith("spec_")}
    for key in SCHEDULE_KEYS + ("weight_bits", "kv_bits"):
        assert st[key] == sj[key], key
    assert st["finished"] == len(PROMPT_LENS)
    margin_params = params_j if not bits.get("weight_bits") else \
        quantize_params(params_j, bits["weight_bits"])

    out_j = {r.uid: r.output for r in eng_j.finished}
    out_t = {r.uid: r.output for r in eng_t.finished}
    for uid, prompt in enumerate(prompts):
        a, b = out_j[uid], out_t[uid]
        assert len(a) == len(b)
        assert len(a) == SETTINGS["max_new_tokens"] or a[-1] == settings.get("eos_token")
        diverged = [t for t in range(len(a)) if a[t] != b[t]]
        if diverged:
            t = diverged[0]
            margin = _margin(margin_params, cfg_j, prompt, a, t)
            assert margin < 2 * BF16_LOGIT_TOL, (
                f"request {uid} diverges at token {t} ({a[t]} vs {b[t]}) "
                f"with a reference margin of {margin:.4f}: not a near-tie")
    return eng_j, eng_t


def test_engine_matches_reference_engine(monkeypatch):
    _compare_engines(monkeypatch)


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quantised_engine_matches_reference_engine(monkeypatch, case):
    _compare_engines(monkeypatch, **QUANT_CASES[case])


@pytest.mark.parametrize("case", ["fp"] + sorted(QUANT_CASES))
def test_gemma2_engine_matches_reference_engine(monkeypatch, case):
    """Reduced gemma2-9b: prompts of up to 23 tokens and 8 new ones over
    its 16-entry local rings, which wrap in packed prefill, in chunked
    continuation and in decode."""
    _compare_engines(monkeypatch, "gemma2-9b", **QUANT_CASES.get(case, {}))


# the reference's golden baseline cases (tests/test_layering.py), at fp and
# w8kv8 on qwen2.5-3b, and the sequential path on gemma2-9b, whose
# batch-1 prefill of prompts up to 23 tokens fills its 16-entry rings
# through _ring_fill (no pow2 bucket: the stack has local layers)
BASELINES = {"hostpath": dict(fused=False), "unpacked": dict(packed=False)}
BASELINE_CASES = [("qwen2.5-3b", b, q) for b in sorted(BASELINES) for q in ("fp", "w8kv8")] \
    + [("gemma2-9b", "unpacked", "fp"), ("gemma2-9b", "hostpath", "kv8")]


@pytest.mark.parametrize("arch,baseline,case", BASELINE_CASES)
def test_baseline_engine_matches_reference_engine(monkeypatch, arch, baseline, case):
    """The host-looped step (``fused=False``) and sequential admission
    (``packed=False``) against the reference's: the same schedule (the
    stats' key set included), streams equal but at near-ties."""
    eng_j, eng_t = _compare_engines(monkeypatch, arch, **BASELINES[baseline],
                                    **QUANT_CASES.get(case, {}))
    assert eng_t.stats()["prefill_calls"] == len(PROMPT_LENS)   # one call a request


@pytest.mark.parametrize("fused", [True, False])
def test_traced_engine_matches_reference_engine(monkeypatch, fused):
    """``trace=True``: the stats' keys equal the reference's, ``trace_*``
    among them; one record a decode iteration, its split adding up."""
    eng_j, eng_t = _compare_engines(monkeypatch, trace=True, fused=fused)
    st = eng_t.stats()
    assert st["trace_iterations"] == len(eng_t.trace) == len(eng_j.trace)
    assert sum(t["iters"] for t in eng_t.trace) == st["decode_steps"]
    for t in eng_t.trace:
        assert t["step_s"] >= t["prefill_s"] + t["decode_s"] + t["d2h_s"] - 1e-9
    assert st["trace_decode_step_s"] == pytest.approx(
        np.mean([t["decode_s"] + t["d2h_s"] for t in eng_t.trace]))


@pytest.mark.parametrize("chunk", [2, 4])
def test_decode_chunk_engine_matches_reference_engine(monkeypatch, chunk):
    """``decode_chunk`` iterations a fused step (requests finishing
    mid-chunk): the same schedule, one host transfer a step."""
    _compare_engines(monkeypatch, decode_chunk=chunk)


def test_eos_engine_matches_reference_engine(monkeypatch):
    """``eos_token``: a token the reference emits third in one stream ends
    that stream there, in both engines."""
    cfg = jax_reduce_config(jax_get_config("qwen2.5-3b"))
    params = TJ.init_params(cfg, jax.random.PRNGKey(0), param_dtype=jnp.float32)
    eng = JaxServingEngine(cfg, params, JaxEngineConfig(**SETTINGS))
    eng.submit(np.random.default_rng(0).integers(0, cfg.vocab_size, size=PROMPT_LENS[0]))
    eos = eng.run_until_drained()[0].output[2]
    eng_j, eng_t = _compare_engines(monkeypatch, eos_token=eos)
    assert min(eng_t.stats()["gen_lens"]) < SETTINGS["max_new_tokens"]


@pytest.mark.parametrize("fused,packed", [(True, True), (True, False), (False, True)])
def test_request_budgets_zero_and_one_match_reference(fused, packed):
    """A request's own budget wins over the engine's: 0 finishes at once
    with no token, 1 with the prefill's sample alone, on every path."""
    cfg_j = jax_reduce_config(jax_get_config("qwen2.5-3b"))
    cfg_t = reduce_config(get_config("qwen2.5-3b"))
    params_j = TJ.init_params(cfg_j, jax.random.PRNGKey(0), param_dtype=jnp.float32)
    params_t = params_from_jax(jax.device_get(params_j), cfg_t, device="cpu")
    settings = dict(SETTINGS, fused=fused, packed=packed)
    engines = (JaxServingEngine(cfg_j, params_j, JaxEngineConfig(**settings)),
               ServingEngine(cfg_t, params_t, EngineConfig(**settings), device="cpu"))
    outs = []
    for eng in engines:
        reqs = [eng.submit(np.asarray([1, 2, 3]), max_new_tokens=n) for n in (0, 1, 3)]
        eng.run_until_drained()
        assert all(r.done and r.status == "done" for r in reqs)
        outs.append([r.output for r in reqs])
    assert [len(o) for o in outs[1]] == [0, 1, 3]
    assert outs[1] == outs[0]


@pytest.mark.parametrize("field,value", [
    ("weight_bits", 3), ("weight_bits", 16), ("kv_bits", 2), ("kv_bits", 16)])
def test_engine_invalid_bits_raise(field, value):
    cfg = reduce_config(get_config("qwen2.5-3b"))
    from repro_torch.models.transformer import init_params
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match=field):
        ServingEngine(cfg, params, EngineConfig(**{field: value}), device="cpu")


@pytest.mark.parametrize("field,value", [
    ("spec_k", 2), ("deadline_ms", 5.0), ("max_queue", 4)])
def test_unported_engine_options_raise(field, value):
    cfg = reduce_config(get_config("qwen2.5-3b"))
    from repro_torch.models.transformer import init_params
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match=field):
        ServingEngine(cfg, params, EngineConfig(**{field: value}), device="cpu")


def test_mesh_raises():
    """Sharded serving has no port yet: ``mesh=`` is refused."""
    cfg = reduce_config(get_config("qwen2.5-3b"))
    from repro_torch.models.transformer import init_params
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        ServingEngine(cfg, params, EngineConfig(), device="cpu", mesh=object())


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma2-9b", "gemma3-27b", "minitron-8b"])
def test_launcher_serves_each_registered_model_reduced_on_the_cpu(arch):
    """``python -m repro_torch.launch.serve --arch <id> --reduced --device
    cpu``: every request finishes with its budget of tokens."""
    from repro_torch.launch.serve import main
    stats = main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "3",
                  "--max-new-tokens", "4", "--kv-bits", "8"])
    assert stats["finished"] == 3 and stats["tokens"] == 12 and stats["kv_bits"] == 8
