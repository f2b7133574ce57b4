"""Mixture-of-experts FFN for serving: the dropless path of the reference's
``models/moe.py`` (``apply_moe`` in modes ``prefill`` and ``decode``,
``_apply_dropless``), with its ``init_moe``.

Every token's ``top_k`` experts are computed: no capacity, so a token's
output depends on no other token (a padded prompt's pad rows cannot move
a live row) and shapes are static in ``B * S * top_k``.  The (token,
expert) pairs are sorted by expert and the expert path runs as three
kernels (``kernels/grouped_matmul``) over the sorted rows, whose group
offsets stay on the device: gate/up with the activation and the row
gather, down with the gate scale, and the ordered combine.  Nothing here
reads the host, so the engine's captured decode step holds the layer.

Not ported: the capacity-sort dispatch, ``_apply_gshard`` (both for
training and sharded execution) and ``router_aux_loss`` (training).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.grouped_matmul.ops import combine, grouped_gate_up, grouped_matmul
from repro_torch.models import modules as M

SERVING_MODES = ("prefill", "decode")


def init_moe(generator, cfg, *, repeats, dtype, device):
    """The router (f32, as the reference makes it), the expert banks
    ``(repeats, E, K, N)`` in ``dtype`` and, with ``n_shared_experts``, a
    shared gated MLP of ``n_shared_experts * d_ff_expert`` columns."""
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    p = {
        "router": M.dense_init(generator, (repeats, D, E), torch.float32, device),
        "experts": {
            "w_gate": M.dense_init(generator, (repeats, E, D, Fe), dtype, device),
            "w_up": M.dense_init(generator, (repeats, E, D, Fe), dtype, device),
            "w_down": M.dense_init(generator, (repeats, E, Fe, D), dtype, device, fan_in=Fe),
        },
    }
    if cfg.n_shared_experts:
        p["shared"] = M.init_mlp(generator, shared_config(cfg), repeats=repeats,
                                 dtype=dtype, device=device)
    return p


def shared_config(cfg):
    """The shared experts' MLP: gated, without biases (whatever the dense
    MLP's ``mlp_bias``), ``n_shared_experts * d_ff_expert`` wide."""
    return dataclasses.replace(cfg, glu=True, mlp_bias=False,
                               d_ff=cfg.n_shared_experts * cfg.d_ff_expert)


def route(p, x, cfg):
    """Router logits ``x @ router`` in f32 (the reference promotes its bf16
    x against the f32 router), softmax, top-k, gates renormalised in f32
    and cast to x's dtype.  Returns (gates (B, S, k), expert ids (B, S, k))."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    return gates.to(x.dtype), idx


def apply_moe(p, x, cfg, *, mode: str, impl: str = "flash"):
    """x (B, S, D) -> (B, S, D), the dropless layer (plus the shared
    experts).  Modes other than ``prefill`` and ``decode`` belong to
    training or chunked continuation, which the port's MoE stacks do not
    run."""
    if mode not in SERVING_MODES:
        raise NotImplementedError(f"MoE mode {mode!r} has no port (serving runs "
                                  f"{SERVING_MODES})")
    gates, idx = route(p, x, cfg)
    y = _apply_dropless(p, x, gates, idx, cfg)
    if "shared" in p:
        y = y + M.apply_mlp(p["shared"], x, shared_config(cfg), impl=impl)
    return y


def _apply_dropless(p, x, gates, idx, cfg):
    """Sort the (token, expert) pairs by expert (stable, so a token's pairs
    keep their order within an expert), then three kernels over the sorted
    rows: gate/up (``act(x[tok] @ w_gate) * (x[tok] @ w_up)``, the token
    rows gathered in its loads), down times each pair's gate, and the
    combine: each token's ``k`` weighted rows summed in ascending expert
    id, rounding to x's dtype after each add, the order in which the
    reference's scatter-add over the stably sorted pairs sums them.  The
    sum is a gather and adds, no atomics, so it is the same from run to
    run."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    we = p["experts"]
    xf = x.reshape(B * S, D)
    flat_e = idx.reshape(-1)                                  # (B*S*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    experts = torch.arange(E + 1, dtype=sorted_e.dtype, device=x.device)
    offsets = torch.searchsorted(sorted_e, experts, out_int32=True)   # (E+1,)
    h = grouped_gate_up(xf, order // k, we["w_gate"], we["w_up"], offsets, cfg.act)
    ys = grouped_matmul(h, we["w_down"], offsets, scale=gates.reshape(-1)[order])
    return combine(ys, order, k).reshape(B, S, D)
