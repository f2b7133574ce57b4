"""The MoE layer's expert path in the port (``kernels/grouped_matmul``: the
fused gate/up, the scaled grouped matmul and the combine) on the CPU,
where each wrapper runs its plain version:

- ``grouped_gate_up_ref`` is the unfused chain ``act(grouped_matmul_ref(
  x[rows], w_gate)) * grouped_matmul_ref(x[rows], w_up)`` bit for bit, in
  bf16 and f32, for every activation; in f32 it matches the reference's
  ``act(jax.lax.ragged_dot) * jax.lax.ragged_dot`` within 1e-5 of the
  output's scale (the same f32 sums in another order), empty experts and a
  single row among the cases;
- ``combine_ref`` is the gather-and-add chain it replaces bit for bit in
  bf16; in f32 it matches the reference's scatter-add
  ``zeros.at[tok].add(ys * gate_sorted[:, None])`` within 1e-5;
- the scaled product is ``bf16(bf16(y) * gate)``;
- the wrappers refuse bad operands;
- ``_apply_dropless`` calls each wrapper once a MoE layer, and none of the
  old chain's separate steps (activation, multiply, scatter, sort, adds)
  is left in it;
- ``apply_moe`` on reduced qwen3-moe-30b-a3b gives, bit for bit, the
  previous composition of the same ops (kept here as a local helper).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models.modules import activation as jax_activation
from repro_torch.config import get_config, reduce_config
from repro_torch.kernels.grouped_matmul import kernel as G
from repro_torch.kernels.grouped_matmul.ref import (combine_ref, grouped_gate_up_ref,
                                                    grouped_matmul_ref)
from repro_torch.models import modules as M
from repro_torch.models import moe as MT
from repro_torch.models import transformer as T

ARCH = "qwen3-moe-30b-a3b"
F32_TOL = 1e-5
ACTS = ("silu", "gelu", "relu2")
# group sizes: empty experts first, between and last; one row; one expert
SIZES = {"empty_experts": [0, 5, 0, 1, 9, 0], "T1": [0, 1, 0], "one_expert": [0, 12, 0, 0]}


def _routing(rng, tokens, experts, k):
    """``tokens`` tokens routed to ``k`` distinct experts each, in any order:
    the flat expert ids, their stable sort and the offsets."""
    picks = np.stack([rng.choice(experts, k, replace=False) for _ in range(tokens)])
    flat = picks.reshape(-1)
    order = np.argsort(flat, kind="stable")
    sizes = np.bincount(flat, minlength=experts)
    off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    return flat, torch.from_numpy(order), torch.from_numpy(off), sizes


def _banks(rng, E, K, N, dtype):
    return [torch.from_numpy(rng.standard_normal((E, K, N)).astype(np.float32) / K ** 0.5)
            .to(dtype) for _ in range(2)]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_gate_up_ref_is_the_unfused_chain(dtype, act):
    rng = np.random.default_rng(0)
    _, order, off, _ = _routing(rng, 7, 6, 2)
    x = torch.from_numpy(rng.standard_normal((7, 24)).astype(np.float32)).to(dtype)
    wg, wu = _banks(rng, 6, 24, 40, dtype)
    rows = order // 2
    got = grouped_gate_up_ref(x, rows, wg, wu, off, act)
    want = M.activation(act)(grouped_matmul_ref(x[rows], wg, off)) * \
        grouped_matmul_ref(x[rows], wu, off)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(G.grouped_gate_up_fwd(x, rows, wg, wu, off, act), got)
    assert G.grouped_gate_up_fwd.launches == 0


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("case", sorted(SIZES))
def test_gate_up_matches_ragged_dot_f32(case, act):
    rng = np.random.default_rng(1)
    sizes = np.array(SIZES[case], np.int32)
    T_ = int(sizes.sum())
    x = rng.standard_normal((T_ + 3, 16)).astype(np.float32)
    rows = rng.permutation(T_ + 3)[:T_]
    wg, wu = (rng.standard_normal((len(sizes), 16, 24)).astype(np.float32) / 4
              for _ in range(2))
    xs = jnp.asarray(x[rows])
    want = np.asarray(jax_activation(act)(jax.lax.ragged_dot(xs, jnp.asarray(wg), sizes))
                      * jax.lax.ragged_dot(xs, jnp.asarray(wu), sizes))
    off = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32))
    got = G.grouped_gate_up_fwd(torch.from_numpy(x), torch.from_numpy(rows), torch.from_numpy(wg),
                                torch.from_numpy(wu), off, act)
    assert got.shape == (T_, 24)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL * scale, rtol=0)


def _gather_add_chain(ys, order, k):
    """The combine as the MoE layer spelled it before the combine kernel:
    the inverse permutation, each token's places sorted, gathers and adds."""
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), dtype=order.dtype))
    places = torch.sort(inv.reshape(-1, k), dim=1).values
    y = ys[places[:, 0]]
    for j in range(1, k):
        y = y + ys[places[:, j]]
    return y


@pytest.mark.parametrize("k", [1, 2, 8])
def test_combine_ref_is_the_gather_add_chain_bf16(k):
    rng = np.random.default_rng(2)
    _, order, _, _ = _routing(rng, 9, 16, k)
    ys = torch.from_numpy(rng.standard_normal((9 * k, 40)).astype(np.float32)).bfloat16()
    got = combine_ref(ys, order, k)
    assert got.dtype == torch.bfloat16 and got.shape == (9, 40)
    assert torch.equal(got, _gather_add_chain(ys, order, k))
    assert torch.equal(G.combine_fwd(ys, order, k), got)
    assert G.combine_fwd.launches == 0


@pytest.mark.parametrize("k", [1, 2, 8])
def test_combine_matches_reference_scatter_add_f32(k):
    """The scaled down product and the combine against the reference's
    ``zeros.at[tok].add(ragged_dot(h, w_down) * gate_sorted[:, None])``."""
    rng = np.random.default_rng(3)
    tokens, E, F, D = 6, 12, 16, 24
    flat, order, off, sizes = _routing(rng, tokens, E, k)
    h = rng.standard_normal((tokens * k, F)).astype(np.float32)
    w = rng.standard_normal((E, F, D)).astype(np.float32)
    gates = rng.random(tokens * k).astype(np.float32)
    o = order.numpy()
    gate_sorted = gates[o]
    want = np.asarray(jnp.zeros((tokens, D), jnp.float32).at[o // k].add(
        jax.lax.ragged_dot(jnp.asarray(h), jnp.asarray(w), sizes.astype(np.int32))
        * gate_sorted[:, None]))
    ys = G.grouped_matmul_fwd(torch.from_numpy(h), torch.from_numpy(w), off,
                              scale=torch.from_numpy(gate_sorted))
    got = G.combine_fwd(ys, order, k)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)


def test_scaled_product_rounds_twice_bf16():
    rng = np.random.default_rng(4)
    sizes = np.array([3, 0, 6, 2], np.int32)
    off = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32))
    x = torch.from_numpy(rng.standard_normal((11, 32)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((4, 32, 16)).astype(np.float32)).bfloat16()
    gate = torch.from_numpy(rng.random(11).astype(np.float32)).bfloat16()
    y = grouped_matmul_ref(x, w, off)
    got = G.grouped_matmul_fwd(x, w, off, scale=gate)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, (y.float() * gate.float()[:, None]).bfloat16())
    assert torch.equal(G.grouped_matmul_fwd(x, w, off), y)


def test_wrappers_refuse_bad_operands():
    x, w = torch.zeros((4, 8)), torch.zeros((3, 8, 16))
    off = torch.tensor([0, 2, 2, 4], dtype=torch.int32)
    rows = torch.arange(4)
    with pytest.raises(ValueError, match="scale"):
        G.grouped_matmul_fwd(x, w, off, scale=torch.ones(3))
    with pytest.raises(ValueError, match="must be"):
        G.grouped_gate_up_fwd(x, rows, w, w, off[:3], "silu")
    with pytest.raises(ValueError, match="differ"):
        G.grouped_gate_up_fwd(x, rows, w, torch.zeros((3, 8, 12)), off, "silu")
    with pytest.raises(ValueError, match="rows must be 1-D int64"):
        G.grouped_gate_up_fwd(x, rows.int(), w, w, off, "silu")
    with pytest.raises(ValueError, match="rows must be 1-D int64"):
        G.grouped_gate_up_fwd(x, rows[None], w, w, off, "silu")
    with pytest.raises(ValueError, match="int32"):
        G.grouped_gate_up_fwd(x, rows, w, w, off.long(), "silu")
    with pytest.raises(ValueError, match="unknown activation"):
        G.grouped_gate_up_fwd(x, rows, w, w, off, "tanh")
    with pytest.raises(ValueError, match=r"\(T \* k, D\)"):
        G.combine_fwd(torch.zeros((6, 8)), torch.arange(5), 2)
    with pytest.raises(ValueError, match=r"\(T \* k, D\)"):
        G.combine_fwd(torch.zeros((6, 8)), torch.arange(6), 4)
    with pytest.raises(ValueError, match="int64"):
        G.combine_fwd(torch.zeros((6, 8)), torch.arange(6, dtype=torch.int32), 2)
    meta = [t.to("meta") for t in (x, w, off)]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        G.grouped_matmul_fwd(*meta)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        G.combine_fwd(torch.zeros((6, 8), device="meta"), torch.arange(6, device="meta"), 2)


def test_plan_states_its_rule():
    """bf16 with K and N multiples of 8 and at least the 64 x 64 box runs
    on TMA; the rest on CUDA cores, each with the rule that sent it."""
    def p(K, N, dtype=torch.bfloat16, E=4):
        x, w = torch.zeros((8, K), dtype=dtype), torch.zeros((E, K, N), dtype=dtype)
        return G.plan(x, w, torch.zeros((8, N), dtype=dtype))
    assert p(2048, 768) == ("tma", "bf16, K and N multiples of 8 and >= 64, aligned")
    assert p(2048, 768, torch.float32).design == "cuda_core"
    assert "multiple of 8" in p(96, 36).rule
    assert "box" in p(48, 64).rule
    assert "experts" in p(64, 64, E=G.TMA_MAX_EXPERTS + 1).rule


def _configs():
    return reduce_config(get_config(ARCH))


def _moe_layer(params, r=0):
    return T._layer(params["stack"][0]["u0"]["moe"], r)


def _previous_dropless(p, x, gates, idx, cfg):
    """The dropless layer as composed before the fused expert path: the
    gathered rows, three grouped matmuls, the activation and multiply, the
    gate gather and scale, the inverse permutation, the sort and the
    gathers and adds."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    act = M.activation(cfg.act)
    we = p["experts"]
    xf = x.reshape(B * S, D)
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    xs = xf[order // k]
    experts = torch.arange(E + 1, dtype=sorted_e.dtype, device=x.device)
    offsets = torch.searchsorted(sorted_e, experts, out_int32=True)
    h = act(grouped_matmul_ref(xs, we["w_gate"], offsets)) * \
        grouped_matmul_ref(xs, we["w_up"], offsets)
    ys = grouped_matmul_ref(h, we["w_down"], offsets)
    ys = ys * gates.reshape(-1)[order][:, None]
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), dtype=order.dtype, device=x.device))
    places = torch.sort(inv.reshape(B * S, k), dim=1).values
    y = ys[places[:, 0]]
    for j in range(1, k):
        y = y + ys[places[:, j]]
    return y.reshape(B, S, D)


@pytest.mark.parametrize("top_k", [2, 8])
@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_apply_moe_is_the_previous_composition_bit_for_bit(dtype, mode, top_k):
    cfg = dataclasses.replace(_configs(), top_k=top_k)
    params = T.init_params(cfg, torch.Generator().manual_seed(5), device="cpu", dtype=dtype)
    p = _moe_layer(params)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (3, 7 if mode == "prefill" else 1, cfg.d_model)).astype(np.float32)).to(dtype)
    got = MT.apply_moe(p, x, cfg, mode=mode)
    gates, idx = MT.route(p, x, cfg)
    assert torch.equal(got, _previous_dropless(p, x, gates, idx, cfg))


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket.__name__))
        return func(*args, **(kwargs or {}))


def test_dropless_calls_each_wrapper_once_a_layer(monkeypatch):
    """With the three wrappers counted (and their work stubbed out), a
    prefill of the reduced model calls each once a MoE layer, and what is
    left of ``_apply_dropless`` is the routing glue and two small index
    ops (the rows and the gates in sorted order): no activation, multiply,
    scatter, second sort or add."""
    cfg = _configs()
    params = T.init_params(cfg, torch.Generator().manual_seed(7), device="cpu",
                           dtype=torch.float32)
    calls = {"grouped_gate_up": 0, "grouped_matmul": 0, "combine": 0}
    stubs = {
        "grouped_gate_up": lambda x, rows, wg, wu, off, act: torch.zeros(
            (rows.shape[0], wg.shape[2]), dtype=x.dtype),
        "grouped_matmul": lambda x, w, off, scale=None: torch.zeros(
            (x.shape[0], w.shape[2]), dtype=x.dtype),
        "combine": lambda ys, order, k: torch.zeros(
            (ys.shape[0] // k, ys.shape[1]), dtype=ys.dtype),
    }

    def counted(name):
        def run(*a, **kw):
            calls[name] += 1
            if name == "grouped_matmul":
                assert kw.get("scale") is not None      # the down product takes the gates
            return stubs[name](*a, **kw)
        return run

    for name in calls:
        monkeypatch.setattr(MT, name, counted(name))
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 5)))
    T.prefill(params, cfg, toks, impl="ref", compute_dtype=torch.float32, kv_cap=8)
    layers = sum(cfg.moe_layer_mask())
    assert layers >= 2 and calls == dict.fromkeys(calls, layers)

    p = _moe_layer(params)
    x = torch.randn((2, 5, cfg.d_model), generator=torch.Generator().manual_seed(9))
    gates, idx = MT.route(p, x, cfg)
    with _OpCounter() as ops:
        MT._apply_dropless(p, x, gates, idx, cfg)
    seen = ops.ops
    for gone in ("silu", "gelu", "relu", "mul", "scatter", "add", "searchsorted_out"):
        assert gone not in seen, (gone, seen)
    assert seen.count("sort") == 1 and seen.count("index") == 2, seen
    assert seen.count("floor_divide") + seen.count("div") == 1, seen
