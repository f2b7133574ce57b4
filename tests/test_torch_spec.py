"""The port's speculative decoding against the reference's, live, on the
CPU (the counterparts of ``tests/test_spec.py``).

Both engines serve the same prompts with the reference's f32 weights (the
port's copy stored f32 too, so that a quantised self-draft quantises the
same numbers into the same codes), compute in bf16 and use the attention
oracle (``impl="ref"``), as the reference's own spec tests do: the
schedule and the ``spec_*`` stats must be equal, and the greedy streams
too but at a near-tie of the reference (``_compare_engines``' rule: the
two packages' plain streams already part at exact ties).  One case runs
the port in bf16 with ``impl="flash"`` (the kernels' plain versions).
Greedy speculation is lossless, so the port's spec streams equal its plain
engine's exactly.

The port's own contracts follow: the spec step reads nothing back to the
host and changes nothing when run as it is captured (every slot dead),
its rollback touches only the committed columns and restores saved
columns byte for byte, and rejection sampling draws from the target's
distribution (a chi-square test against the reference model's softmax).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from repro.config import get_config as jax_get_config
from repro.config import reduce_config as jax_reduce_config
from repro.models import transformer as TJ
from repro.quant.core import quantize_params
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.config import get_config, reduce_config
from repro_torch.convert import params_from_jax
from repro_torch.serving.engine import DONE, EngineConfig, ServingEngine
from repro_torch.serving.executor import SPEC_PROGRAMS, pool_args
from repro_torch.serving.graphs import program_inputs
from repro_torch.serving.pool import cache_leaves
from test_torch_engine_paths import HostReadGuard
from test_torch_serving import (BF16_LOGIT_TOL, SCHEDULE_KEYS, _compare_engines, _margin,
                                _reference_kernel_matmul)

SETTINGS = dict(max_batch=2, kv_len=48, max_new_tokens=6, impl="ref")
SPEC_KEYS = ("spec_k", "spec_draft", "spec_draft_bits", "spec_steps", "spec_drafted",
             "spec_accepted", "spec_committed", "spec_acceptance", "spec_tokens_per_step")


@pytest.fixture(scope="module")
def models():
    """Reduced qwen2.5-3b and gemma2-9b: (reference cfg, params, port cfg,
    params), f32; and a 1-layer qwen draft model of its own seed."""
    out = {}
    for arch in ("qwen2.5-3b", "gemma2-9b"):
        cfg_j = jax_reduce_config(jax_get_config(arch))
        params_j = TJ.init_params(cfg_j, jax.random.PRNGKey(0), param_dtype=jnp.float32)
        cfg_t = reduce_config(get_config(arch))
        out[arch] = (cfg_j, params_j, cfg_t, params_from_jax(
            jax.device_get(params_j), cfg_t, device="cpu", dtype=torch.float32))
    cfg_j, _, cfg_t, _ = out["qwen2.5-3b"]
    dcfg_j = dataclasses.replace(cfg_j, n_layers=1, name=cfg_j.name + "-draft")
    dparams_j = TJ.init_params(dcfg_j, jax.random.PRNGKey(9), param_dtype=jnp.float32)
    dcfg_t = dataclasses.replace(cfg_t, n_layers=1, name=cfg_t.name + "-draft")
    out["draft"] = (dcfg_j, dparams_j, dcfg_t, params_from_jax(
        jax.device_get(dparams_j), dcfg_t, device="cpu", dtype=torch.float32))
    return out


def _port_engine(models, arch="qwen2.5-3b", draft=False, **kw):
    cfg, params = models[arch][2:]
    return ServingEngine(cfg, params, EngineConfig(**dict(SETTINGS, **kw)), device="cpu",
                         draft=models["draft"][2:] if draft else None)


def _submit(eng, n_req=4):
    rng = np.random.default_rng(7)
    return [eng.submit(rng.integers(0, eng.cfg.vocab_size, size=3 + 2 * i))
            for i in range(n_req)]


def _outputs(eng):
    return {r.uid: list(map(int, r.output)) for r in sorted(eng.finished, key=lambda r: r.uid)}


def _record_steps(eng) -> list:
    """Record each speculative step of ``eng`` as it is fetched: the uid of
    each decoding slot's request and its tokens so far, and the step's
    packed ``(spec_k+1, 4, B)`` array."""
    steps, fetch = [], eng.executor.fetch

    def record(x):
        arr = fetch(x)
        if arr.ndim == 3:
            rows = [(r.uid, len(r.output)) if r is not None and i not in eng.pool.prefilling
                    else None for i, r in enumerate(eng.pool.slot_req)]
            steps.append((rows, arr.copy()))
        return arr
    eng.executor.fetch = record
    return steps


def _acceptance(steps) -> dict:
    """{uid: [(tokens before the step, drafts accepted, tokens committed)]}."""
    out: dict = {}
    for rows, arr in steps:
        for i, row in enumerate(rows):
            if row is not None and arr[0, 0, i] >= 0:
                out.setdefault(row[0], []).append(
                    (row[1], int(arr[0, 3, i]), int((arr[:, 0, i] >= 0).sum())))
    return out


def _pair(models, arch="qwen2.5-3b", *, n_req=4, draft=False, **kw):
    """The same drain on the reference's engine and the port's: the same
    schedule and stats keys, and the same streams but at a near-tie of the
    reference.  Each request's speculative steps accept as many drafts on
    both engines up to the step that commits its first differing token
    (after it the contexts differ), and where no stream differs the
    ``spec_*`` stats are equal.  Returns (reference, port)."""
    cfg_j, params_j = models[arch][:2]
    eng_j = JaxServingEngine(cfg_j, params_j, JaxEngineConfig(**dict(SETTINGS, **kw)),
                             draft=models["draft"][:2] if draft else None)
    eng_t = _port_engine(models, arch, draft, **kw)
    steps = [_record_steps(eng) for eng in (eng_j, eng_t)]
    for eng in (eng_j, eng_t):
        _submit(eng, n_req)
        eng.run_until_drained()
    sj, st = eng_j.stats(), eng_t.stats()
    assert set(st) == set(sj)
    for key in SCHEDULE_KEYS:
        assert st[key] == sj[key], key
    margin_params = params_j if not kw.get("weight_bits") else \
        quantize_params(params_j, kw["weight_bits"])
    out_j, out_t = _outputs(eng_j), _outputs(eng_t)
    acc_j, acc_t = (_acceptance(s) for s in steps)
    for r in eng_j.finished:
        a, b = out_j[r.uid], out_t[r.uid]
        diverged = [t for t in range(len(a)) if a[t] != b[t]]
        first = diverged[0] if diverged else len(a)
        if diverged:
            margin = _margin(margin_params, cfg_j, r.prompt, a, first)
            assert margin < 2 * BF16_LOGIT_TOL, (
                f"request {r.uid} diverges at token {first} with a reference margin "
                f"of {margin:.4f}: not a near-tie")
        before = [[s for s in acc[r.uid] if s[0] + s[2] <= first] for acc in (acc_j, acc_t)]
        assert before[0] == before[1], r.uid
    if out_j == out_t:
        for key in SPEC_KEYS:
            assert st.get(key) == sj.get(key), key
    return eng_j, eng_t


def _plain(models, arch="qwen2.5-3b", n_req=4, **kw):
    eng = _port_engine(models, arch, **kw)
    _submit(eng, n_req)
    eng.run_until_drained()
    return eng


# -- greedy streams against the reference --------------------------------------

@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma2-9b"])
def test_acceptance_one_matches_reference(models, arch):
    """``spec_draft_bits=0`` drafts with the serving params: every draft is
    accepted, and the streams are the plain engine's in fewer steps."""
    eng_j, eng_t = _pair(models, arch, spec_k=4, spec_draft_bits=0)
    base = _plain(models, arch)
    st = eng_t.stats()
    assert _outputs(eng_t) == _outputs(base)
    assert st["spec_acceptance"] == 1.0
    assert st["spec_tokens_per_step"] == pytest.approx(5.0)
    assert eng_t.decode_steps < base.decode_steps


@pytest.mark.parametrize("bits", [8, 4])
def test_lossy_self_draft_matches_reference(monkeypatch, models, bits):
    """int8 / int4 self-drafts mispredict as the reference's do (equal
    ``spec_accepted``); the committed streams stay the plain engine's."""
    _reference_kernel_matmul(monkeypatch)
    _, eng_t = _pair(models, spec_k=4, spec_draft_bits=bits)
    st = eng_t.stats()
    assert _outputs(eng_t) == _outputs(_plain(models))
    assert 0.0 <= st["spec_acceptance"] <= 1.0
    # the prefill emits each request's first token, spec steps the rest
    assert st["spec_committed"] == st["tokens"] - st["finished"]


def test_draft_model_matches_reference(models):
    """A separate 1-layer draft model (the reference's init, converted):
    its own pool, ingested at admission, rolled back and caught up."""
    _, eng_t = _pair(models, draft=True, spec_k=3, spec_draft="model")
    assert eng_t.pool.draft_cache is not None
    assert eng_t.stats()["spec_draft"] == "model"
    assert _outputs(eng_t) == _outputs(_plain(models))


def test_quantised_target_with_spec_matches_reference(monkeypatch, models):
    """w8kv8 serving with a 4-bit self-draft (the reference's dequant-matmul
    through its Pallas kernel, which keeps the weights f32 as the port's
    does): the w8kv8 engine's own streams."""
    _reference_kernel_matmul(monkeypatch)
    _, eng_t = _pair(models, weight_bits=8, kv_bits=8, spec_k=4, spec_draft_bits=4)
    assert _outputs(eng_t) == _outputs(_plain(models, weight_bits=8, kv_bits=8))


def test_spec_through_chunked_prefill_keeps_stall_invariant(models):
    """Speculation beside chunked prefill: the plain chunked streams, and no
    admission burst stalls decode for more than two chunk budgets."""
    kw = dict(prefill_chunk=8, max_new_tokens=4)
    _, eng_t = _pair(models, n_req=6, spec_k=4, spec_draft_bits=0, **kw)
    assert _outputs(eng_t) == _outputs(_plain(models, n_req=6, **kw))
    assert eng_t.stats()["max_stall_tokens"] <= 2 * 8


def test_bf16_spec_engine_matches_reference_engine(monkeypatch):
    """The port in bf16 through the kernels' route (``impl="flash"``) against
    the reference: the same schedule, streams equal but at near-ties, and
    the same speculative steps, drafts and commits."""
    eng_j, eng_t = _compare_engines(monkeypatch, spec_k=4, spec_draft_bits=0)
    sj, st = eng_j.stats(), eng_t.stats()
    same = [k for k in SPEC_KEYS if k not in ("spec_accepted", "spec_acceptance")]
    assert {k: st[k] for k in same} == {k: sj[k] for k in same}
    # the drafts run the decode route and verify the chunk route, which
    # round apart in bf16: a near-tie can reject a draft (as on the card)
    assert sj["spec_acceptance"] == 1.0 and st["spec_acceptance"] >= 0.9


def test_dormant_stats_carry_no_spec_keys(models):
    """``spec_k=0`` adds no stats key; ``spec_k>0`` adds them all."""
    assert not any(k.startswith("spec_") for k in _plain(models).stats())
    eng = _port_engine(models, spec_k=2, spec_draft_bits=0)
    _submit(eng)
    eng.run_until_drained()
    assert set(SPEC_KEYS) <= set(eng.stats())


# -- validation ----------------------------------------------------------------

BAD_SPEC = {
    "packed": dict(packed=False, spec_k=2),
    "fused": dict(fused=False, spec_k=2),
    "decode_chunk": dict(decode_chunk=2, spec_k=2),
    "ring": dict(kv_len=4, spec_k=4),
    "no draft": dict(spec_k=2, spec_draft="model"),
    "spec_draft": dict(spec_k=2, spec_draft="other"),
    "spec_draft_bits": dict(spec_k=2, spec_draft_bits=3),
    "negative": dict(spec_k=-1),
    "gemma2 ring": dict(spec_k=16, kv_len=48),
}


@pytest.mark.parametrize("case", sorted(BAD_SPEC))
def test_spec_config_validation_matches_reference(models, case):
    """Each configuration the reference refuses, the port refuses with the
    reference's message."""
    arch = "gemma2-9b" if case == "gemma2 ring" else "qwen2.5-3b"
    cfg_j, params_j, cfg_t, params_t = models[arch]
    kw = dict(SETTINGS, **BAD_SPEC[case])
    with pytest.raises(ValueError) as want:
        JaxServingEngine(cfg_j, params_j, JaxEngineConfig(**kw))
    with pytest.raises(ValueError) as got:
        ServingEngine(cfg_t, params_t, EngineConfig(**kw), device="cpu")
    assert str(got.value) == str(want.value)


def test_draft_model_validation(models):
    """A draft model must share the target's vocabulary."""
    cfg_t, params_t = models["qwen2.5-3b"][2:]
    dcfg, dparams = models["draft"][2:]
    kw = dict(SETTINGS, spec_k=2, spec_draft="model")
    with pytest.raises(ValueError, match="draft vocab"):
        ServingEngine(cfg_t, params_t, EngineConfig(**kw), device="cpu",
                      draft=(dataclasses.replace(dcfg, vocab_size=128), dparams))


# -- what capture needs of the spec step ---------------------------------------

SPEC_CASES = {"qwen fp, bits 0": ("qwen2.5-3b", False, dict(spec_draft_bits=0)),
              "qwen kv8, int4 draft, sampled": ("qwen2.5-3b", False,
                                                dict(kv_bits=8, spec_draft_bits=4,
                                                     temperature=0.8)),
              "qwen w4kv4, int8 draft": ("qwen2.5-3b", False,
                                         dict(weight_bits=4, kv_bits=4, spec_draft_bits=8)),
              "qwen draft model": ("qwen2.5-3b", True, dict(spec_draft="model")),
              "gemma2 fp, int8 draft": ("gemma2-9b", False, dict(spec_draft_bits=8))}


def _flash_engine(models, case, **kw):
    arch, draft, spec = SPEC_CASES[case]
    return _port_engine(models, arch, draft, impl="flash", spec_k=4, max_batch=3,
                        prefill_chunk=16, **spec, **kw)


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spec_programs_read_nothing_back_to_the_host(models, case):
    """A drain (a 30-token prompt through chunk steps among them) with the
    spec step, the packed prefill and the chunk step each under the guard:
    each is capturable.  Every request finishes with its budget."""
    eng = _flash_engine(models, case)
    ex = eng.executor
    calls = dict.fromkeys(SPEC_PROGRAMS, 0)

    def guarded(name, fn):
        def run(*args):
            calls[name] += 1
            with HostReadGuard():
                return fn(*args)
        return run

    for name in SPEC_PROGRAMS:
        setattr(ex, name, guarded(name, getattr(ex, name)))
    rng = np.random.default_rng(3)
    reqs = [eng.submit(rng.integers(0, eng.cfg.vocab_size, size=n)) for n in (3, 9, 30, 5)]
    eng.run_until_drained()
    assert all(r.status == DONE and len(r.output) == SETTINGS["max_new_tokens"]
               for r in reqs)
    assert all(n > 0 for n in calls.values()), calls


def _pool_leaves(pool):
    return list(pool.state.values()) + [t for _, t in cache_leaves(pool.cache)] + \
        [t for _, t in cache_leaves(pool.draft_cache)]


def _fill(pool, seed=3):
    """Random data in every pool leaf (the draft pool's too)."""
    g = torch.Generator().manual_seed(seed)
    for cache in (pool.cache, pool.draft_cache):
        for _, leaf in cache_leaves(cache):
            if leaf.dtype == torch.int8:
                leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=g))
            elif leaf.dtype == torch.int32:
                leaf.copy_(torch.randint(0, 40, leaf.shape, generator=g))
            else:
                leaf.copy_(torch.randn(leaf.shape, generator=g))


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spec_step_at_capture_changes_nothing(models, case):
    """The spec step run as it is captured (every slot dead) leaves a pool
    full of data, the draft model's pool and the state as they were: the
    draft steps, the wipe, verify, the rollback and the catch-up all write
    nowhere."""
    eng = _flash_engine(models, case)
    _fill(eng.pool)
    eng.pool.state["pos"].fill_(9)
    before = [t.clone() for t in _pool_leaves(eng.pool)]
    assert program_inputs(eng.ecfg, eng._chunk)["spec_step"] == []
    eng.executor.spec_step(*pool_args("spec_step", eng.pool))
    assert all(torch.equal(a, b) for a, b in zip(_pool_leaves(eng.pool), before))


# -- rollback ------------------------------------------------------------------

@pytest.mark.parametrize("kv_bits", [0, 4])
def test_spec_step_touches_only_committed_columns(models, kv_bits):
    """One draft + verify step on a live slot: every cache column outside
    the committed ring range ``p .. p+m`` comes back byte for byte (the
    int4 pool packs two codes a byte along the head dim, never along the
    entry axis, so a column's bytes are its own)."""
    eng = _port_engine(models, max_batch=1, max_new_tokens=8, spec_k=4,
                       spec_draft_bits=4, kv_bits=kv_bits)
    eng.submit(np.random.default_rng(7).integers(0, eng.cfg.vocab_size, size=5))
    eng.step()                                           # admission + a spec step
    assert eng.pool.occupied() == 1
    p = eng.pool.valid_len(0)
    pre = [(name, leaf.clone()) for name, leaf in cache_leaves(eng.pool.cache)]
    c0 = eng.spec_committed
    eng.step()                                           # one speculative step
    m = eng.spec_committed - c0 - 1
    assert 0 <= m <= 4 and eng.pool.valid_len(0) == p + m + 1
    for (name, before), (_, after) in zip(pre, cache_leaves(eng.pool.cache)):
        cap = before.shape[2]
        touched = {(p + j) % cap for j in range(m + 1)}
        for c in range(cap):
            if c not in touched:
                assert torch.equal(before[:, :, c], after[:, :, c]), (name, c)


def test_quantised_rollback_keeps_the_positions_of_plain(models):
    """kv8: the validity plane (every ``pos`` leaf) and the streams equal the
    plain kv8 engine's (one slot pins the slot assignment)."""
    base = _plain(models, kv_bits=8, max_batch=1)
    eng = _port_engine(models, kv_bits=8, max_batch=1, spec_k=4, spec_draft_bits=4)
    _submit(eng)
    eng.run_until_drained()
    assert _outputs(eng) == _outputs(base)
    pos = [(a, b) for (n, a), (_, b) in zip(cache_leaves(eng.pool.cache),
                                            cache_leaves(base.pool.cache)) if n == "pos"]
    assert pos and all(torch.equal(a, b) for a, b in pos)


@pytest.mark.parametrize("case", ["qwen fp", "gemma2 kv4", "draft pool"])
def test_saved_columns_round_trip_byte_exact(models, case):
    """The rollback primitive: overwrite the ``spec_k+1`` columns of every
    row (the rings' wrapping ones among them), then write the saved columns
    back: the pool is byte for byte what it was."""
    arch = "gemma2-9b" if case.startswith("gemma2") else "qwen2.5-3b"
    eng = _port_engine(models, arch, draft=case == "draft pool", spec_k=4,
                       kv_bits=4 if "kv4" in case else 0,
                       spec_draft="model" if case == "draft pool" else "self")
    _fill(eng.pool)
    cache = eng.pool.draft_cache if case == "draft pool" else eng.pool.cache
    ex, B = eng.executor, eng.ecfg.max_batch
    p = torch.tensor([13, 46][:B], dtype=torch.int32)    # 46: wraps every ring
    ones = torch.ones((B, eng.ecfg.spec_k + 1), dtype=torch.bool)
    orig = [t.clone() for _, t in cache_leaves(cache)]
    saved = ex._spec_cols(cache, p)
    ex._spec_restore(cache, [s * 0 - 1 for s in saved], p, ones)
    assert not all(torch.equal(a, b) for (_, a), b in zip(cache_leaves(cache), orig))
    ex._spec_restore(cache, saved, p, ones)
    assert all(torch.equal(a, b) for (_, a), b in zip(cache_leaves(cache), orig))


def test_truncate_invalidates_every_position_past_the_prefix(models):
    """``SlotPool.truncate`` (the host-side rollback) cuts a slot's pools,
    the draft model's too, to ``keep_len``; ``valid_len`` reads it back."""
    eng = _port_engine(models, draft=True, spec_k=2, spec_draft="model", max_batch=1,
                       max_new_tokens=12)
    eng.submit(np.arange(9) % eng.cfg.vocab_size)
    eng.step()
    eng.step()
    assert eng.pool.valid_len(0) > 9
    eng.pool.truncate(0, 7)
    assert eng.pool.valid_len(0) == 7
    for cache in (eng.pool.cache, eng.pool.draft_cache):
        assert all(int(t[:, 0].max()) == 6 for n, t in cache_leaves(cache) if n == "pos")


# -- sampling -------------------------------------------------------------------

SAMPLES_A_STEP, TRIALS, TEMPERATURE = 32, 60, 0.3


def test_rejection_sampling_follows_the_target_distribution(models):
    """Temperature 0.3, the 1-layer draft model (whose distribution is far
    from the target's, so that the residual's draws weigh), 32 slots holding
    one prompt and the same pending token: the first token each spec step
    commits (an accepted draft or the residual's draw) over 60 steps, each
    from the same pools and state, against softmax(logits / 0.3) of the
    reference model on prompt + that token.  Pearson's chi-square over the
    tokens expected at least 5 times (the rest pooled) stays below its 0.999
    quantile; drafts were both accepted and rejected."""
    cfg_j, params_j = models["qwen2.5-3b"][:2]
    prompt, t0 = np.asarray([11, 42, 7, 99, 5], np.int32), 17
    seq = jnp.asarray(np.append(prompt, t0)[None])
    logits, _ = TJ.prefill(params_j, cfg_j, {"tokens": seq}, impl="ref",
                           compute_dtype=jnp.bfloat16)
    z = np.asarray(logits[0], np.float64) / TEMPERATURE
    p = np.exp(z - z.max())
    p /= p.sum()

    B = SAMPLES_A_STEP
    eng = _port_engine(models, draft=True, max_batch=B, kv_len=32, spec_k=2,
                       spec_draft="model", temperature=TEMPERATURE, seed=5)
    ex, pool = eng.executor, eng.pool
    toks = torch.from_numpy(prompt[None])
    for slot in range(B):
        ex.prefill_insert(pool.cache, pool.state, toks, slot, prompt.size, 20)
        ex.draft_prefill(pool.draft_cache, toks, slot, prompt.size)
    pool.state["tokens"].fill_(t0)
    start = [t.clone() for t in _pool_leaves(pool)]
    firsts, accepted = [], []
    for _ in range(TRIALS):
        for t, s in zip(_pool_leaves(pool), start):
            t.copy_(s)
        packed = ex.spec_step(*pool_args("spec_step", pool))[2].numpy()
        firsts += list(packed[0, 0])
        accepted += list(packed[0, 3])
    counts = np.bincount(firsts, minlength=p.size)
    big = p * len(firsts) >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(p[big], p[~big].sum()) * len(firsts)
    stat = float(((obs - exp) ** 2 / exp).sum())
    limit = scipy.stats.chi2.ppf(0.999, obs.size - 1)
    assert big.sum() > 20 and exp[-1] >= 5
    assert 0 < np.mean(np.asarray(accepted) > 0) < 1
    assert stat < limit, f"chi-square {stat:.1f} over {obs.size} bins, limit {limit:.1f}"


def test_sampled_spec_drain_repeats_with_its_seed(models):
    """Temperature 0.8 with an 8-bit self-draft: every request drains with
    its full budget, the acceptance accounting adds up, the same seed
    repeats its streams and another seed does not."""
    def drain(seed):
        eng = _port_engine(models, temperature=0.8, seed=seed, spec_k=4, spec_draft_bits=8)
        _submit(eng)
        eng.run_until_drained()
        st = eng.stats()
        assert all(len(v) == 6 for v in _outputs(eng).values()) and st["finished"] == 4
        assert 0.0 <= st["spec_acceptance"] <= 1.0
        assert st["spec_committed"] == st["tokens"] - st["finished"]
        return _outputs(eng)
    assert drain(3) == drain(3)
    assert drain(3) != drain(4)
