"""The port's engine paths on the CPU: what CUDA-graph capture needs of
the three programs (no host read, a no-op at capture), counted replays,
and the engine behaviours the reference's own tests pin
(``tests/test_serving.py``): one host transfer a fused iteration, submit
validation, the NaN quarantine and its retries, ``EngineStallError``,
and sampling at ``temperature > 0``, checked by distribution against the
reference model's softmax.

Reduced qwen2.5-3b and gemma2-9b (16-entry local rings), the reference's
f32 weights carried over in bf16, ``impl="flash"`` (the kernels' plain
versions on the CPU).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.config import get_config as jax_get_config
from repro.config import reduce_config as jax_reduce_config
from repro.models import transformer as TJ
from repro_torch.config import get_config, reduce_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import launches
from repro_torch.serving.engine import (DONE, FAILED_ANOMALY, FAILED_MAX_ITERS,
                                        EngineConfig, EngineStallError,
                                        ServingEngine)
from repro_torch.serving.executor import PROGRAMS
from repro_torch.serving.graphs import program_inputs

aten = torch.ops.aten
SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


class HostReadGuard(TorchDispatchMode):
    """Raises on every op that reads tensor data back to the host: what
    a CUDA graph cannot capture (a sync inside the program)."""
    READS = {aten.nonzero, aten._local_scalar_dense, aten.masked_select, aten.item,
             aten.equal, aten.is_nonzero}
    INDEXING = {aten.index, aten.index_put, aten.index_put_, aten._index_put_impl_}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        op = func.overloadpacket
        if op in self.READS:
            raise AssertionError(f"host read inside a program: {func}")
        if op in self.INDEXING and any(isinstance(t, torch.Tensor) and t.dtype == torch.bool
                                       for t in args[1]):
            raise AssertionError(f"boolean-mask indexing inside a program: {func}")
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ("qwen2.5-3b", "gemma2-9b"):
        cfg_j = jax_reduce_config(jax_get_config(arch))
        params_j = TJ.init_params(cfg_j, jax.random.PRNGKey(0), param_dtype=jnp.float32)
        cfg_t = reduce_config(get_config(arch))
        out[arch] = (cfg_j, params_j, cfg_t,
                     params_from_jax(jax.device_get(params_j), cfg_t, device="cpu"))
    return out


def _engine(models, arch="qwen2.5-3b", **kw):
    cfg_t, params = models[arch][2:]
    settings = dict(max_batch=3, kv_len=48, prefill_chunk=16, max_new_tokens=6,
                    impl="flash")
    settings.update(kw)
    return ServingEngine(cfg_t, params, EngineConfig(**settings), device="cpu")


def _submit_mix(eng, seed=7):
    """Six prompts of 3..13 tokens, and one of 30 (two chunk steps)."""
    rng = np.random.default_rng(seed)
    vocab = eng.cfg.vocab_size
    reqs = [eng.submit(rng.integers(0, vocab, size=3 + 2 * i)) for i in range(6)]
    return reqs + [eng.submit(rng.integers(0, vocab, size=30))]


# -- the guard ---------------------------------------------------------------

@pytest.mark.parametrize("read", ["nonzero", "item", "bool_index", "masked_select",
                                  "bool_index_put"])
def test_guard_refuses_each_host_read(read):
    x = torch.arange(6, dtype=torch.float32)
    fn = {"nonzero": lambda: x.nonzero(), "item": lambda: x[2].item(),
          "bool_index": lambda: x[x > 2], "masked_select": lambda: x.masked_select(x > 2),
          "bool_index_put": lambda: x.__setitem__(x > 2, 0.0)}[read]
    with pytest.raises(AssertionError, match="host read|boolean-mask"):
        with HostReadGuard():
            fn()


@pytest.mark.parametrize("arch,kw", [
    ("qwen2.5-3b", {}), ("qwen2.5-3b", dict(kv_bits=8, decode_chunk=2)),
    ("qwen2.5-3b", dict(weight_bits=4, kv_bits=4, temperature=0.8)),
    ("gemma2-9b", {}), ("gemma2-9b", dict(kv_bits=8, temperature=0.8))])
def test_programs_read_nothing_back_to_the_host(models, arch, kw):
    """A whole drain with ``fused_step``, ``packed_prefill`` and
    ``chunk_step`` each run under the guard: every program is capturable."""
    eng = _engine(models, arch, **kw)
    ex = eng.executor
    calls = dict.fromkeys(PROGRAMS, 0)

    def guarded(name, fn):
        def run(*args):
            calls[name] += 1
            with HostReadGuard():
                return fn(*args)
        return run

    for name in PROGRAMS:
        setattr(ex, name, guarded(name, getattr(ex, name)))
    reqs = _submit_mix(eng)
    eng.run_until_drained()
    assert all(r.status == DONE for r in reqs)
    assert all(n > 0 for n in calls.values()), calls


@pytest.mark.parametrize("name", ["executor.py", "graphs.py"])
def test_program_modules_hold_no_host_read(name):
    """The serving programs' modules (and the attention layer they run)
    spell no host read: the one transfer is ``Executor.fetch``'s."""
    for path in (SRC / "serving" / name, SRC / "models" / "attention.py"):
        text = path.read_text()
        for read in (r"\.nonzero\(", r"\.item\(\)", r"\.tolist\(\)", r"\.cpu\(\)"):
            assert not re.search(read, text), f"{path.name}: {read}"


@pytest.mark.parametrize("arch,kv_bits", [("qwen2.5-3b", 0), ("gemma2-9b", 8)])
def test_programs_at_capture_change_nothing(models, arch, kv_bits):
    """Each program run as it is captured (every slot dead, the inputs of
    ``program_inputs``) leaves a pool full of data, and the state, as they
    were: capture at engine construction is a no-op."""
    eng = _engine(models, arch, kv_bits=kv_bits)
    g = torch.Generator().manual_seed(3)
    for grp in eng.pool.cache["stack"]:
        for unit in grp.values():
            for leaf in unit["attn"].values():
                if leaf.dtype == torch.int8:
                    leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=g))
                elif leaf.dtype == torch.int32:
                    leaf.copy_(torch.randint(0, 40, leaf.shape, generator=g))
                else:
                    leaf.copy_(torch.randn(leaf.shape, generator=g))
    eng.pool.state["pos"].fill_(9)
    before = [t.clone() for t in _leaves(eng.pool)]
    specs = program_inputs(eng.ecfg, eng._chunk)
    for name in PROGRAMS:
        args = [torch.full(shape, fill, dtype=dtype) for shape, dtype, fill in specs[name]]
        getattr(eng.executor, name)(eng.pool.cache, eng.pool.state, *args)
        assert all(torch.equal(a, b) for a, b in zip(_leaves(eng.pool), before)), name


def _leaves(pool):
    out = list(pool.state.values())
    for grp in pool.cache["stack"]:
        for unit in grp.values():
            out += list(unit["attn"].values())
    return out


def test_counted_replays_add_what_the_capture_counted():
    """``launches``: a capture's counts are taken back out, and added again
    at every replay."""
    from repro_torch.kernels.flash_attention.decode import flash_decode_fwd, kernel_launches
    before = launches.snapshot()
    flash_decode_fwd.launches += 3                      # what a capture counts
    kernel_launches["k"] += 3
    delta = launches.since(before)
    launches.restore(before)
    assert launches.snapshot() == before
    for _ in range(2):                                  # two replays
        launches.add(delta)
    assert flash_decode_fwd.launches == before.calls["flash_decode"] + 6
    assert kernel_launches["k"] == before.kernels["decode"]["k"] + 6
    launches.restore(before)


# -- the reference's engine behaviours -----------------------------------------

def test_single_host_transfer_per_fused_iteration(models):
    """Steady-state decode: exactly one device→host transfer an iteration,
    and nothing in a step reads the host otherwise (the guard around the
    whole step)."""
    eng = _engine(models, max_batch=2, max_new_tokens=8)
    eng.submit(np.asarray([1, 2, 3, 4]))
    eng.submit(np.asarray([5, 6, 7]))
    eng.step()                                          # admissions + a decode
    base = eng.host_transfers
    with HostReadGuard():
        for _ in range(3):
            eng.step()
    assert eng.host_transfers - base == 3
    assert eng.host_bytes == (1 + 3) * 3 * 2 * 4 + 4 * 2   # (1, 3, B) int32 + 2 firsts


def test_submit_validation(models):
    """Malformed submissions fail at submit(): wrong rank, empty, float
    dtype, negative budget, over-long prompt."""
    eng = _engine(models)
    with pytest.raises(ValueError, match="1-D"):
        eng.submit(np.asarray([[1, 2], [3, 4]]))
    with pytest.raises(ValueError, match="at least one token"):
        eng.submit(np.asarray([], np.int32))
    with pytest.raises(ValueError, match="integer"):
        eng.submit(np.asarray([1.0, 2.0]))
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(np.asarray([1, 2, 3]), max_new_tokens=-1)
    with pytest.raises(ValueError, match="kv_len"):
        eng.submit(np.arange(47) % eng.cfg.vocab_size)
    assert not eng.queue


def _poison_slot(pool, slot):
    """NaN one slot's float KV leaves (batch axis 1 of every leaf), in place."""
    for grp in pool.cache["stack"]:
        for unit in grp.values():
            for leaf in unit["attn"].values():
                if leaf.is_floating_point():
                    leaf[:, slot] = float("nan")


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_nan_quarantine_spares_the_batch(models, kv_bits):
    """A slot whose logits go non-finite is retried, then failed alone; the
    co-resident request's stream equals a clean run's."""
    good_prompt, bad_prompt = np.asarray([1, 2, 3, 4]), np.asarray([7, 8, 9])
    ref = _engine(models, max_batch=2, max_new_tokens=5, kv_bits=kv_bits)
    ref.submit(good_prompt)
    want = ref.run_until_drained()[0].output

    eng = _engine(models, max_batch=2, max_new_tokens=5, kv_bits=kv_bits)
    good, bad = eng.submit(good_prompt), eng.submit(bad_prompt)
    eng.step()                                          # both admitted + a decode
    _poison_slot(eng.pool, eng.pool.slot_req.index(bad))
    eng.run_until_drained()
    assert bad.status == FAILED_ANOMALY and len(bad.output) == 2
    assert good.status == DONE and good.output == want
    assert eng.stats()["failed_anomaly"] == 1


def test_transient_anomaly_retries_and_recovers(models):
    """A non-finite step within the retry budget freezes the slot (no
    token, same position) and retries it: once the fault clears, the
    stream equals a clean run's."""
    prompt = np.asarray([1, 2, 3, 4])
    ref = _engine(models, max_batch=1, max_new_tokens=6)
    ref.submit(prompt)
    want = ref.run_until_drained()[0].output

    eng = _engine(models, max_batch=1, max_new_tokens=6, anomaly_retries=3)
    r = eng.submit(prompt)
    eng.step()
    snap = [t.clone() for t in _leaves(eng.pool)]
    _poison_slot(eng.pool, 0)
    eng.step()                                          # frozen: no token
    assert len(r.output) == 2 and eng.pool.anomalies[0] == 1
    for t, s in zip(_leaves(eng.pool), snap):           # the fault clears
        t.copy_(s)
    eng.run_until_drained()
    assert r.status == DONE and r.output == want
    assert eng.stats()["failed_anomaly"] == 0


@pytest.mark.parametrize("fused", [True, False])
def test_run_until_drained_marks_stranded(models, fused):
    """Exhausting ``max_iters`` raises ``EngineStallError`` after marking
    every stranded request ``FAILED_MAX_ITERS``, on both decode paths."""
    eng = _engine(models, max_batch=1, max_new_tokens=40, fused=fused)
    reqs = [eng.submit(np.asarray([1, 2, 3])) for _ in range(4)]
    with pytest.raises(EngineStallError, match="did not drain"):
        eng.run_until_drained(max_iters=2)
    assert all(r.status == FAILED_MAX_ITERS for r in reqs)
    assert not eng.queue and all(x is None for x in eng.pool.slot_req)
    assert eng.stats()["failed_max_iters"] == 4


# -- sampling at temperature > 0 ---------------------------------------------

SAMPLES, TEMPERATURE = 4096, 0.15


def test_first_tokens_follow_the_reference_softmax(models):
    """``temperature`` 0.15: the first tokens of 4096 requests of one
    prompt (one draw each, from the executor's generator) against
    softmax(logits / 0.15) of the reference model on that prompt (the
    reduced model's logits span 0.73, so its softmax spans a factor of
    about 130).  Pearson's chi-square over the tokens expected at least 5
    times (the rest pooled in one bin) must stay below its 0.999 quantile:
    a sampler that draws from the right distribution fails one seed in a
    thousand; greedy, or another temperature, fails by far."""
    cfg_j, params_j = models["qwen2.5-3b"][:2]
    prompt = np.asarray([11, 42, 7], np.int32)
    logits, _ = TJ.prefill(params_j, cfg_j, {"tokens": jnp.asarray(prompt[None])},
                           impl="ref", compute_dtype=jnp.bfloat16)
    z = np.asarray(logits[0], np.float64) / TEMPERATURE
    p = np.exp(z - z.max())
    p /= p.sum()
    eng = _engine(models, max_batch=32, kv_len=64, prefill_chunk=64, max_new_tokens=1,
                  temperature=TEMPERATURE, seed=5)
    for _ in range(SAMPLES):
        eng.submit(prompt)
    eng.run_until_drained()
    counts = np.bincount([r.output[0] for r in eng.finished], minlength=p.size)
    big = p * SAMPLES >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(p[big], p[~big].sum()) * SAMPLES
    stat = float(((obs - exp) ** 2 / exp).sum())
    limit = scipy.stats.chi2.ppf(0.999, obs.size - 1)
    assert big.sum() > 50 and p.max() > 5 / p.size and exp[-1] >= 5   # p is spread
    assert stat < limit, f"chi-square {stat:.1f} over {obs.size} bins, limit {limit:.1f}"


def test_sampling_repeats_with_its_seed(models):
    """The same seed gives the same streams; another seed others."""
    def streams(seed):
        eng = _engine(models, temperature=1.0, seed=seed)
        _submit_mix(eng)
        return [r.output for r in sorted(eng.run_until_drained(), key=lambda r: r.uid)]
    assert streams(3) == streams(3)
    assert streams(3) != streams(4)
