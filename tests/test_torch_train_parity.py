"""The port's training path against the reference's, live, for every
registered config at reduced size: ``loss_fn`` and its gradients, the
train step (with gradient accumulation), remat, and the MoE capacity
dispatch.

The reference's f32 parameter tree goes through ``params_from_jax(...,
dtype=torch.float32)`` into the port's master tree (``T.trainable``); both
sides take the same numpy batch.  The reference differentiates with
``jax.value_and_grad`` of its ``loss_fn(impl="ref")``, the port with
autograd through its own.

Bounds.  f32: the loss within 1e-5 relative, each gradient leaf within
1e-4 of its scale (its largest magnitude in the reference).  The key bias
of attention without RoPE (bert, bart, whisper; every cross-attention) has
a gradient of zero in exact arithmetic, since softmax ignores a shift
shared by a row's scores: both sides hold rounding noise there (~1e-9
against leaves of ~1e-1), so those leaves are held to 1e-6 of the largest
leaf's scale on both sides instead.  bf16 (2 layers, ``ROADMAP.md``'s
depth-drift rule): the loss within 1e-2, each leaf within 5e-2 of its
scale.  The vision stack's cross layers are gated by tanh of zero-init
gates, which would zero their weights' gradients; both trees take gates
0.5 and 1.0, so every leaf is live.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import flatten_tree as jax_flatten
from repro.config import get_config as jax_get_config
from repro.config import list_archs
from repro.config import reduce_config as jax_reduce_config
from repro.launch import steps as SJ
from repro.models import moe as MJ
from repro.models import transformer as TJ
from repro.training.optimizer import OptConfig as JOptConfig
from repro.training.optimizer import adamw_init as jax_adamw_init
from repro_torch.ckpt import flatten_tree
from repro_torch.config import get_config, reduce_config
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.launch.steps import make_train_step
from repro_torch.models import moe as MT
from repro_torch.models import transformer as TT
from repro_torch.training.optimizer import OptConfig
from repro_torch.tree import tree_leaves, tree_unflatten

ARCHS = sorted(list_archs())
B, S = 2, 16
GATES = {"gate_attn": 0.5, "gate_mlp": 1.0}
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=20)


def test_every_registered_config_is_covered():
    from repro_torch.config import _REGISTRY
    get_config("qwen2.5-3b")
    assert set(ARCHS) == set(_REGISTRY) and len(ARCHS) == 16


def _cfgs(arch):
    return jax_reduce_config(jax_get_config(arch)), reduce_config(get_config(arch))


def _params_j(cfg_j, seed=0):
    tree = jax.device_get(TJ.init_params(cfg_j, jax.random.PRNGKey(seed)))
    for g in tree["stack"]:
        for unit in g.values():
            for name, value in GATES.items():
                if name in unit:
                    unit[name] = np.full_like(unit[name], value)
    return tree


def _batch(cfg, seed=1, batch=B):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (batch, S)).astype(np.int32)}
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal((batch, S, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        b["encoder_tokens"] = rng.integers(0, cfg.vocab_size, (batch, S)).astype(np.int32)
    if cfg.family == "vlm":
        b["image_embeds"] = rng.standard_normal(
            (batch, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return b


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _shift_free(cfg, key):
    """A key bias whose gradient is zero in exact arithmetic."""
    return key.endswith("/bk") and (not cfg.use_rope or "/cross/" in key)


def _ref_grads(cfg_j, params_j, batch, dtype=jnp.float32, **kw):
    f = jax.value_and_grad(
        lambda p, b: TJ.loss_fn(p, cfg_j, b, impl="ref", compute_dtype=dtype, **kw),
        has_aux=True)
    (loss, metrics), grads = jax.jit(f)(params_j, _jb(batch))
    return float(loss), jax.device_get(metrics), jax_flatten(jax.device_get(grads))


def _port_grads(cfg_t, params, batch, dtype=torch.float32, **kw):
    loss, metrics = TT.loss_fn(params, cfg_t, _tb(batch), compute_dtype=dtype, **kw)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    flat = {k: v.numpy() for k, v in flatten_tree(tree_unflatten(params, list(grads))).items()}
    return float(loss.detach()), metrics, flat


def _check_grads(cfg, got, want, tol):
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for key, w in want.items():
        g = got[key]
        assert np.isfinite(g).all(), key
        if _shift_free(cfg, key):
            assert max(float(np.abs(g).max()), float(np.abs(w).max())) <= 1e-6 * top, key
            continue
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, (key, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_the_reference_f32(arch):
    cfg_j, cfg_t = _cfgs(arch)
    params_j = _params_j(cfg_j)
    batch = _batch(cfg_j)
    lj, mj, gj = _ref_grads(cfg_j, params_j, batch)
    params = TT.trainable(params_from_jax(params_j, cfg_t, device="cpu", dtype=torch.float32))
    lt, mt, gt = _port_grads(cfg_t, params, batch)
    assert abs(lt - lj) <= 1e-5 * abs(lj), (lt, lj)
    assert abs(float(mt["aux"]) - float(mj["aux"])) <= 1e-5 * max(abs(float(mj["aux"])), 1.0)
    _check_grads(cfg_t, gt, gj, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_gets_a_finite_nonzero_gradient(arch):
    """No leaf's gradient is cut (a kernel's output outside the autograd
    graph would give zeros and fail nothing else), on the port's own
    init; the shift-free key biases aside (see the module's docstring)."""
    _, cfg = _cfgs(arch)
    params = TT.init_params(cfg, torch.Generator().manual_seed(3), device="cpu",
                            dtype=torch.float32)
    tree = TT.trainable(params)
    for name, value in GATES.items():
        for g in tree["stack"]:
            for unit in g.values():
                if name in unit:
                    unit[name].data.fill_(value)
    _, _, grads = _port_grads(cfg, tree, _batch(cfg, seed=4))
    assert len(grads) == len(tree_leaves(tree))
    for key, g in grads.items():
        assert np.isfinite(g).all(), key
        assert _shift_free(cfg, key) or np.abs(g).max() > 0, key


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-moe-30b-a3b"])
def test_two_layer_bf16_loss_and_gradients(arch):
    cfg_j, cfg_t = _cfgs(arch)
    assert cfg_t.n_layers == 2
    params_j = _params_j(cfg_j, seed=5)
    batch = _batch(cfg_j, seed=6)
    lj, _, gj = _ref_grads(cfg_j, params_j, batch, dtype=jnp.bfloat16)
    params = TT.trainable(params_from_jax(params_j, cfg_t, device="cpu", dtype=torch.float32))
    lt, _, gt = _port_grads(cfg_t, params, batch, dtype=torch.bfloat16)
    assert abs(lt - lj) <= 1e-2 * abs(lj), (lt, lj)
    _check_grads(cfg_t, gt, gj, 5e-2)


@pytest.mark.parametrize("arch,accum", [("qwen2.5-3b", 1), ("qwen2.5-3b", 2),
                                        ("qwen3-moe-30b-a3b", 1), ("qwen3-moe-30b-a3b", 2)])
def test_train_step_matches_the_reference(arch, accum, monkeypatch):
    """One step of ``make_train_step`` (f32 compute, remat on as the
    reference's default; the ``loss_fn`` of both, bf16 by default, is
    wrapped to f32): loss and gnorm within 1e-5 relative, lr and the count
    equal, ``m`` within 1e-4 of its scale and ``v`` within 2e-4 (linear and
    quadratic in the gradients, which agree to 1e-4 of their scale).

    The parameters are held to what that gradient bound allows: from zero
    moments the step is ``g / (|g| + eps)`` (plus weight decay), whose
    slope ``eps / (|g| + eps)^2`` is steep where ``|g|`` is near ``eps``:
    an element whose gradient is within the bound ``d`` of zero may move by
    up to ``2 lr``.  Each element is held within ``lr * min(2, eps * d /
    (max(|g| - d, 0) + eps)^2)`` plus 1e-6 of its leaf's scale, ``g`` the
    reference's clipped gradient (its ``m / (1 - b1)``)."""
    cfg_j, cfg_t = _cfgs(arch)
    monkeypatch.setattr(TJ, "loss_fn", functools.partial(TJ.loss_fn,
                                                         compute_dtype=jnp.float32))
    monkeypatch.setattr(TT, "loss_fn", functools.partial(TT.loss_fn,
                                                         compute_dtype=torch.float32))
    params_j = _params_j(cfg_j, seed=7)
    opt_j = jax_adamw_init(params_j)
    step_j = jax.jit(SJ.make_train_step(cfg_j, opt_cfg=JOptConfig(**OPT), accum=accum))
    params = TT.trainable(params_from_jax(params_j, cfg_t, device="cpu", dtype=torch.float32))
    opt = opt_state_from_jax(jax.device_get(opt_j), cfg_t, device="cpu")
    step_t = make_train_step(cfg_t, opt_cfg=OptConfig(**OPT), accum=accum)
    batch = _batch(cfg_j, seed=10, batch=4)
    new_j, opt_j, mj = step_j(params_j, opt_j, _jb(batch))
    new_t, opt, mt = step_t(params, opt, _tb(batch))
    for k in ("loss", "gnorm"):
        assert abs(float(mt[k]) - float(mj[k])) <= 1e-5 * abs(float(mj[k])), k
    assert float(mt["lr"]) == float(mj["lr"])
    assert int(opt["count"]) == int(opt_j["count"]) == 1

    def flat(tree):
        return {k: v.detach().numpy() for k, v in flatten_tree(tree).items()}
    got = {name: flat(t) for name, t in (("p", new_t), ("m", opt["m"]), ("v", opt["v"]))}
    want = {name: jax_flatten(jax.device_get(t))
            for name, t in (("p", new_j), ("m", opt_j["m"]), ("v", opt_j["v"]))}
    lr, eps, b1 = float(mj["lr"]), JOptConfig().eps, JOptConfig().b1
    for key in want["p"]:
        for name, tol in (("m", 1e-4), ("v", 2e-4)):
            w = want[name][key]
            assert float(np.abs(got[name][key] - w).max()) <= tol * float(np.abs(w).max()), \
                (name, key)
        g = want["m"][key] / (1 - b1)
        d = 1e-4 * float(np.abs(g).max())
        slope = eps * d / (np.maximum(np.abs(g) - d, 0.0) + eps) ** 2
        w = want["p"][key]
        bound = lr * np.minimum(2.0, slope) + 1e-6 * float(np.abs(w).max())
        assert (np.abs(got["p"][key] - w) <= bound).all(), key


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-moe-30b-a3b", "mamba2-130m",
                                  "recurrentgemma-9b", "deepseek-v2-236b", "whisper-large-v3"])
def test_remat_and_dots_give_the_same_gradients(arch):
    """``remat`` (each layer recomputed in the backward pass) and
    ``remat_policy="dots"`` (matrix products kept) give the gradients of
    the plain run, bit for bit on the CPU."""
    _, cfg = _cfgs(arch)
    tree = TT.trainable(TT.init_params(cfg, torch.Generator().manual_seed(8), device="cpu",
                                       dtype=torch.float32))
    batch = _batch(cfg, seed=9)
    loss0, _, g0 = _port_grads(cfg, tree, batch)
    for kw in (dict(remat=True), dict(remat=True, remat_policy="dots")):
        loss, _, g = _port_grads(cfg, tree, batch, **kw)
        assert loss == loss0, kw
        for key in g0:
            np.testing.assert_array_equal(g[key], g0[key], err_msg=f"{kw} {key}")


def _moe_case(capacity_factor, seed):
    cfg_j, cfg_t = _cfgs("qwen3-moe-30b-a3b")
    cfg_j = dataclasses.replace(cfg_j, capacity_factor=capacity_factor)
    cfg_t = dataclasses.replace(cfg_t, capacity_factor=capacity_factor)
    pj = jax.device_get(MJ.init_moe(jax.random.PRNGKey(seed), cfg_j))
    x = np.random.default_rng(seed).standard_normal((3, 24, cfg_j.d_model)).astype(np.float32)
    return cfg_j, cfg_t, pj, x


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_capacity_moe_matches_the_reference(capacity_factor):
    """The capacity-sort layer (``apply_moe(mode="train")``) and its router
    aux loss against the reference's, f32, output and gradients (the
    router, the three expert banks and x).  At capacity factor 0.5 an
    expert takes 3 of 24 tokens' 48 pairs, so tokens are dropped: the test
    checks that some are."""
    cfg_j, cfg_t, pj, x = _moe_case(capacity_factor, seed=11)
    C = MT._capacity(x.shape[1], cfg_t)
    assert C == MJ._capacity(x.shape[1], cfg_j)
    w = np.random.default_rng(12).standard_normal(x.shape).astype(np.float32)

    def f_j(p, xx):
        y = MJ.apply_moe(p, xx, cfg_j, mode="train")
        return jnp.sum(y * w) + MJ.router_aux_loss(p, xx, cfg_j), y
    (lj, yj), (gpj, gxj) = jax.value_and_grad(f_j, argnums=(0, 1), has_aux=True)(pj, x)

    pt = {"router": torch.from_numpy(np.array(pj["router"])).requires_grad_(),
          "experts": {k: torch.from_numpy(np.array(v)).requires_grad_()
                      for k, v in pj["experts"].items()}}
    xt = torch.from_numpy(x).requires_grad_()
    yt = MT.apply_moe(pt, xt, cfg_t, mode="train")
    lt = torch.sum(yt * torch.from_numpy(w)) + MT.router_aux_loss(pt, xt, cfg_t)
    grads = torch.autograd.grad(lt, [pt["router"], *pt["experts"].values(), xt])
    assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), atol=2e-5 * np.abs(yj).max())
    want = [gpj["router"], *[gpj["experts"][k] for k in pt["experts"]], gxj]
    for g, wnt in zip(grads, want):
        wnt = np.asarray(wnt)
        assert float(np.abs(g.numpy() - wnt).max()) <= 1e-4 * float(np.abs(wnt).max())
    # the dispatch keeps at most C pairs an expert a row and, at factor 0.5, drops some
    gates, idx = MT.route(pt, xt, cfg_t)
    _, slot, _, keep, _ = MT._dispatch(xt, gates, idx, cfg_t.n_experts, C)
    for row in range(x.shape[0]):
        kept = torch.bincount(slot[row][keep[row]] // C, minlength=cfg_t.n_experts)
        assert int(kept.max()) <= C
    if capacity_factor < 1:
        assert int((~keep).sum()) > 0


def test_train_mode_takes_the_capacity_path_and_serving_the_dropless():
    """At a capacity that drops pairs, ``train`` differs from ``prefill``
    (the dropless path, every pair computed), which equals the capacity
    path at a capacity that keeps them all."""
    _, cfg, pj, x = _moe_case(0.5, seed=13)
    p = {"router": torch.from_numpy(np.array(pj["router"])),
         "experts": {k: torch.from_numpy(np.array(v)) for k, v in pj["experts"].items()}}
    xt = torch.from_numpy(x)
    dropless = MT.apply_moe(p, xt, cfg, mode="prefill")
    assert not torch.allclose(MT.apply_moe(p, xt, cfg, mode="train"), dropless, atol=1e-3)
    full = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    torch.testing.assert_close(MT.apply_moe(p, xt, full, mode="train"), dropless,
                               rtol=1e-5, atol=1e-5)


def test_loss_fn_refuses_a_kernel_impl():
    _, cfg = _cfgs("qwen2.5-3b")
    tree = TT.trainable(TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                                       dtype=torch.float32))
    with pytest.raises(ValueError, match="no backward"):
        TT.loss_fn(tree, cfg, _tb(_batch(cfg)), impl="flash")
