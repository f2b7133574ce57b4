"""The port's recurrent layer kinds against the reference's, live, on the
CPU: Mamba-2's SSD block (``ssm``) and the RG-LRU block (``recurrent``),
module by module and as reduced mamba2-130m and recurrentgemma-9b.

Inputs come from numpy with a seed; the reference's functions run as they
are (plain jnp: neither block reaches a Pallas kernel).  Tolerances, per
case:

- ``causal_conv`` in f32: bit for bit (the same products summed in the
  same order, from the first tap);
- ``_segsum``, ``ssd_scan``, ``ssd_step``, ``_rglru_core`` and the scans in
  f32: 2e-5 absolute and relative (the reference's f32 kernel pin): the
  einsums and cumsums sum in another order, and the doubling scan composes
  its steps in another tree than ``associative_scan``.  ``softplus`` is
  ``logaddexp(x, 0)`` in JAX and returns x above 20 in PyTorch: the two
  are within one f32 ulp, far inside the bound;
- a layer in bf16: 1e-2 of each tensor's scale (its largest magnitude, at
  least 1), as ``tests/test_torch_model.py`` holds bf16: a bf16 value moves
  by up to 1/128 of itself on one rounding flip, and the reference computes
  SiLU and GELU op by op in bf16 while the port rounds once;
- the padded prefill against the unpadded one (the port alone, the
  reference's ``test_padded_prefill_state_exact``): ``conv`` bit for bit,
  ``state``/``h`` to 1e-5 absolute and 1e-3 relative, logits to 1e-2;
- decode against the full forward (the reference's
  ``tests/test_models.py`` rule): 5e-2 absolute and relative, f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import reduce_config as jax_reduce_config
from repro.models import rglru as RJ
from repro.models import ssm as SJ
from repro.models import transformer as TJ
from repro.quant.core import quantize_params as jax_quantize_params
from repro_torch.config import get_config, reduce_config
from repro_torch.convert import params_from_jax
from repro_torch.models import rglru as RT
from repro_torch.models import ssm as ST
from repro_torch.models import transformer as TT

ARCHS = ("mamba2-130m", "recurrentgemma-9b")
F32_TOL = 2e-5
BF16_TOL = 1e-2


def T(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    if tol > 1e-3:                       # bf16: relative to the tensor's scale
        atol, rtol = tol * max(1.0, float(np.abs(want).max())), 0.0
    else:
        atol = rtol = tol
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)


def _cfgs(arch):
    return jax_reduce_config(jax_get_config(arch)), reduce_config(get_config(arch))


@pytest.fixture(scope="module")
def trees():
    """The reference's f32 parameter tree of each reduced model."""
    return {arch: jax.device_get(TJ.init_params(_cfgs(arch)[0], jax.random.PRNGKey(0),
                                                param_dtype=jnp.float32))
            for arch in ARCHS}


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("state,length", [(False, None), (True, None), (False, 9),
                                          (False, 2), (False, 0)])
def test_causal_conv_is_the_reference_bit_for_bit(state, length):
    """With and without a streaming state; with ``length`` inside the
    stream, short of the W-1 taps (zeros before it) and at 0."""
    rng = np.random.default_rng(0)
    B, S, C, W = 2, 12, 10, 4
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    w = rng.standard_normal((W, C)).astype(np.float32)
    b = rng.standard_normal((C,)).astype(np.float32)
    st = rng.standard_normal((B, W - 1, C)).astype(np.float32) if state else None
    yj, sj = SJ.causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            None if st is None else jnp.asarray(st),
                            length=None if length is None else jnp.int32(length))
    yt, s_t = ST.causal_conv(T(x), T(w), T(b), None if st is None else T(st), length=length)
    assert np.array_equal(yt.numpy(), np.asarray(yj))
    assert np.array_equal(s_t.numpy(), np.asarray(sj))


def test_segsum_matches_reference():
    x = -np.abs(np.random.default_rng(1).standard_normal((2, 3, 16))).astype(np.float32)
    _close(ST._segsum(T(x)), SJ._segsum(jnp.asarray(x)), F32_TOL)


def _ssd_inputs(l, seed=2, b=2, h=4, p=8, g=2, n=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, l, h)))) * 0.1).astype(np.float32)
    A = -np.linspace(1.0, 4.0, h).astype(np.float32)
    Bm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    Cm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("l", [24, 20])
def test_ssd_scan_matches_reference(l):
    """Chunk 8: three chunks (24), and the single-chunk fallback (20 is not
    a multiple of 8)."""
    args = _ssd_inputs(l)
    yj, fj = SJ.ssd_scan(*map(jnp.asarray, args), chunk=8)
    yt, ft = ST.ssd_scan(*map(T, args), chunk=8)
    _close(yt, yj, F32_TOL, "y")
    _close(ft, fj, F32_TOL, "final state")


def test_ssd_step_matches_reference_and_continues_the_scan():
    """One step against the reference's; and steps iterated over a stream
    give the chunked scan's final state."""
    x, dt, A, Bm, Cm = _ssd_inputs(16, seed=3)
    state = np.random.default_rng(4).standard_normal((2, 4, 8, 6)).astype(np.float32)
    yj, sj = SJ.ssd_step(*(jnp.asarray(a[:, 0]) for a in (x, dt)), jnp.asarray(A),
                         *(jnp.asarray(a[:, 0]) for a in (Bm, Cm)), jnp.asarray(state))
    yt, s_t = ST.ssd_step(T(x[:, 0]), T(dt[:, 0]), T(A), T(Bm[:, 0]), T(Cm[:, 0]), T(state))
    _close(yt, yj, F32_TOL, "y")
    _close(s_t, sj, F32_TOL, "state")
    s = torch.zeros((2, 4, 8, 6))
    for t in range(16):
        _, s = ST.ssd_step(T(x[:, t]), T(dt[:, t]), T(A), T(Bm[:, t]), T(Cm[:, t]), s)
    _, final = ST.ssd_scan(T(x), T(dt), T(A), T(Bm), T(Cm), chunk=8)
    _close(s, final, F32_TOL, "iterated steps against the scan")


def _rglru_params(seed=5, W=16):
    cfg = dataclasses.replace(_cfgs("recurrentgemma-9b")[0], lru_width=W, d_model=24)
    return cfg, jax.device_get(RJ.init_rglru(jax.random.PRNGKey(seed), cfg))


def test_rglru_core_matches_reference():
    _, p = _rglru_params()
    u = np.random.default_rng(6).standard_normal((2, 10, 16)).astype(np.float32)
    aj, bj = RJ._rglru_core(jnp.asarray(u), p)
    at, bt = RT._rglru_core(T(u), {k: T(v) for k, v in p.items()})
    _close(at, aj, F32_TOL, "a")
    _close(bt, bj, F32_TOL, "b")


@pytest.mark.parametrize("S", [1, 7, 64, 100])
def test_doubling_scan_matches_associative_scan(S):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.8, 1.0, (2, S, 5)).astype(np.float32)
    b = rng.standard_normal((2, S, 5)).astype(np.float32)

    def combine(e1, e2):
        return e1[0] * e2[0], e2[0] * e1[1] + e2[1]

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    _close(RT.linear_scan(T(a), T(b)), want, F32_TOL)


# ---------------------------------------------------------------------------
# one layer at prefill and decode
# ---------------------------------------------------------------------------

def _layer(kind, seed=7):
    cfg_j, cfg_t = _cfgs("mamba2-130m" if kind == "ssm" else "recurrentgemma-9b")
    key = jax.random.PRNGKey(seed)
    if kind == "ssm":
        p = SJ.init_mamba(key, cfg_j)
        return cfg_j, cfg_t, jax.device_get(p), SJ.apply_mamba, ST.apply_mamba
    p = RJ.init_rglru(key, cfg_j)
    return cfg_j, cfg_t, jax.device_get(p), RJ.apply_rglru, RT.apply_rglru


@pytest.mark.parametrize("kind", ["ssm", "recurrent"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layer_prefill_and_decode_match_reference(kind, dtype):
    """A right-padded prefill (16 tokens, 11 real: its cache exact at 11),
    then three decode steps from that cache (the port's in place), in f32
    and bf16."""
    cfg_j, cfg_t, p, apply_j, apply_t = _layer(kind)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16,
                                                                      torch.bfloat16)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    pt = {k: T(v) for k, v in p.items()}
    rng = np.random.default_rng(8)
    B, S, L, D = 2, 16, 11, cfg_t.d_model
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    yj, cj = apply_j(p, jnp.asarray(x, jdt), cfg=cfg_j, mode="prefill", length=jnp.int32(L))
    yt, ct = apply_t(pt, T(x).to(tdt), cfg=cfg_t, mode="prefill", length=L)
    _close(yt[:, :L], np.asarray(yj, np.float32)[:, :L], tol, "prefill output")
    for name in cj:
        assert ct[name].dtype == (tdt if name == "conv" else torch.float32), name
        _close(ct[name], cj[name], tol, f"prefill {name}")
    cj = {k: v.astype(jdt) if k == "conv" else v for k, v in cj.items()}
    ct = {k: v.clone() for k, v in ct.items()}
    for step in range(3):
        xd = rng.standard_normal((B, 1, D)).astype(np.float32)
        held = dict(ct)
        yj, cj = apply_j(p, jnp.asarray(xd, jdt), cfg=cfg_j, mode="decode", cache=cj)
        yt, ct = apply_t(pt, T(xd).to(tdt), cfg=cfg_t, mode="decode", cache=ct)
        _close(yt, yj, tol, f"decode {step} output")
        for name in cj:
            assert ct[name] is held[name], f"{name} not updated in place"
            _close(ct[name], cj[name], tol, f"decode {step} {name}")


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def _cache_leaves(cache):
    """(path, leaf) of a cache tree, in either package."""
    if isinstance(cache, dict):
        return [(f"{k}/{p}" if p else k, leaf) for k in sorted(cache)
                for p, leaf in _cache_leaves(cache[k])]
    if isinstance(cache, (list, tuple)):
        return [(f"{i}/{p}" if p else str(i), leaf) for i, c in enumerate(cache)
                for p, leaf in _cache_leaves(c)]
    return [("", cache)]


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_prefill_state_exact(trees, arch):
    """The reference's rule on the port: a 21-token prompt right-padded to
    32 with ``length`` gives the unpadded prompt's cache (bf16 compute, f32
    parameters) — ``conv`` bit for bit, ``state``/``h`` to 1e-5 + 1e-3
    relative, ring positions as a set, K/V entry by entry."""
    _, cfg = _cfgs(arch)
    params = params_from_jax(trees[arch], cfg, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(1)
    plen, pad = 21, 32
    prompt = rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32)
    toks = np.zeros((1, pad), np.int32)
    toks[0, :plen] = prompt
    lp, cache_pad = TT.prefill(params, cfg, T(toks), kv_cap=pad, length=plen)
    le, cache_ex = TT.prefill(params, cfg, T(prompt[None]), kv_cap=pad)
    _close(lp, le.float().numpy(), BF16_TOL, "logits")
    flat_p, flat_e = _cache_leaves(cache_pad), _cache_leaves(cache_ex)
    assert [k for k, _ in flat_p] == [k for k, _ in flat_e]
    names = {k.rsplit("/", 1)[-1] for k, _ in flat_p}
    assert {"conv"} | ({"state"} if arch == "mamba2-130m" else {"h", "pos"}) <= names
    for (key, a), (_, b) in zip(flat_p, flat_e):
        name = key.rsplit("/", 1)[-1]
        if name == "conv":
            assert torch.equal(a, b), key
        elif name in ("state", "h"):
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=1e-5,
                                       rtol=1e-3, err_msg=key)
        elif name == "pos":
            np.testing.assert_array_equal(np.sort(a.numpy(), -1), np.sort(b.numpy(), -1))
            kp, ke = dict(flat_p), dict(flat_e)
            base = key[:-len("pos")]
            for p_ in range(plen):
                ia, ib = np.argwhere(a.numpy() == p_), np.argwhere(b.numpy() == p_)
                assert len(ia) == len(ib)
                for nm in ("k", "v"):
                    for i, j in zip(ia, ib):
                        assert torch.equal(kp[base + nm][tuple(i)], ke[base + nm][tuple(j)])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(trees, arch):
    """Prefill of 16 tokens then decode steps, each step's logits against a
    full prefill over the longer prefix (the reference's
    ``tests/test_models.py`` rule), f32: the conv, SSD and RG-LRU states
    carry what the full forward sees."""
    _, cfg = _cfgs(arch)
    params = params_from_jax(trees[arch], cfg, device="cpu", dtype=torch.float32)
    steps, seq = 4, 16
    toks = T(np.random.default_rng(0).integers(0, cfg.vocab_size, (1, seq + steps)))
    f32 = dict(compute_dtype=torch.float32, kv_cap=seq + steps)
    logits, cache = TT.prefill(params, cfg, toks[:, :seq], **f32)
    inc = [logits]
    for s in range(steps - 1):
        logits, cache = TT.decode_step(params, cfg, cache, toks[:, seq + s],
                                       torch.full((1,), seq + s, dtype=torch.int32),
                                       compute_dtype=torch.float32)
        inc.append(logits)
    for s in range(steps):
        ref, _ = TT.prefill(params, cfg, toks[:, :seq + s], **f32)
        np.testing.assert_allclose(inc[s].numpy(), ref.numpy(), atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("bits", [0, 8])
def test_params_from_jax_names_layout_and_f32_leaves(trees, arch, bits):
    """The reference's tree, fp and quantised, carried across: every name
    and shape, the recurrent blocks' f32 leaves in f32 (the convs, A_log,
    D, dt_bias, the norm vector, wa, wi, ba, bi, lam), weights in bf16, the
    RG-LRU's ``w_gate`` quantised (a ``QUANT_PARAM_KEYS`` name) and Mamba's
    ``in_proj``/``out_proj`` not; the port's own init draws the same names,
    shapes and spreads."""
    _, cfg = _cfgs(arch)
    tree = jax_quantize_params(trees[arch], bits) if bits else trees[arch]
    pt = params_from_jax(jax.device_get(tree), cfg, device="cpu", dtype=torch.bfloat16)
    names = {n.replace(".", "/"): t for n, t in (*pt.named_parameters(), *pt.named_buffers())}
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: hasattr(x, "bits"))[0]}
    f32 = {"conv_w", "conv_b", "A_log", "D", "dt_bias", "norm", "wa", "wi", "ba", "bi",
           "lam", "scale"}
    want = {}
    for n, leaf in flat.items():
        if hasattr(leaf, "bits"):
            want[n + "/q"], want[n + "/scale"] = leaf.q, leaf.scale
        else:
            want[n] = leaf
    assert set(names) == set(want)
    for n, leaf in want.items():
        assert tuple(names[n].shape) == tuple(leaf.shape), n
        last = n.rsplit("/", 1)[-1]
        quant = n.endswith(("/q", "/scale")) and n.rsplit("/", 2)[-2] in ("w_gate", "w_up",
                                                                         "w_down", "wq", "wk",
                                                                         "wv", "wo")
        dtype = (torch.int8 if last == "q" else torch.float32) if quant else \
            (torch.float32 if last in f32 else torch.bfloat16)
        assert names[n].dtype == dtype, n
    leaves = {part for n in names for part in n.split("/")}
    if arch == "mamba2-130m":
        assert {"mamba", "in_proj", "out_proj", "dt_bias", "A_log"} <= leaves
        assert "stack/0/u0/mamba/in_proj" in names and "stack/0/u0/mamba/out_proj" in names
    else:
        assert {"rec", "w_gate", "w_branch", "w_out", "wa", "lam", "mlp", "attn"} <= leaves
        assert ("stack/0/u0/rec/w_gate/q" in names) == bool(bits)
        assert "stack/0/u0/rec/w_branch" in names
    if not bits:
        own = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                             dtype=torch.float32)
        for n, p in own.named_parameters():
            ref = flat[n.replace(".", "/")]
            assert tuple(p.shape) == ref.shape, n
            np.testing.assert_allclose(p.std().item(), np.std(ref), rtol=0.15, atol=1e-6,
                                       err_msg=n)


def test_packed_prefill_and_chunk_refuse_recurrent_kinds(trees):
    """Only attention stacks pack (the reference's error); the recurrent
    layers run prefill and decode, not the chunk step."""
    _, cfg = _cfgs("mamba2-130m")
    params = params_from_jax(trees["mamba2-130m"], cfg, device="cpu", dtype=torch.float32)
    z = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="attention-only"):
        TT.prefill_packed(params, cfg, z, z, z, torch.zeros(1, dtype=torch.int32))
    cache = TT.init_cache(cfg, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="prefill and decode"):
        TT.chunk_prefill_step(params, cfg, cache, z, z, torch.zeros(1, dtype=torch.int32))
