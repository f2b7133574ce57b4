"""Mixture-of-experts FFN (counterpart of the reference's ``models/moe.py``):
the dropless path of serving (modes ``prefill`` and ``decode``), the
capacity-sort dispatch of training (mode ``train``), ``init_moe`` and
``router_aux_loss``.

Serving computes every token's ``top_k`` experts: no capacity, so a
token's output depends on no other token (a padded prompt's pad rows
cannot move a live row) and shapes are static in ``B * S * top_k``.  The
(token, expert) pairs are sorted by expert and the expert path runs as
three kernels (``kernels/grouped_matmul``) over the sorted rows, whose
group offsets stay on the device: gate/up with the activation and the row
gather, down with the gate scale, and the ordered combine.  Nothing here
reads the host, so the engine's captured decode step holds the layer.

Training takes the reference's static-shape capacity path through
autograd: each batch row's pairs sorted by expert, at most ``C`` tokens an
expert (:func:`_capacity`; the rest dropped, GShard's rule), three expert
einsums over the ``(B, E, C, D)`` buffer and a combine by ``index_add``.
Not ported: ``_apply_gshard``, the one-hot dispatch of sharded execution
(it waits for the sharded plane).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels.grouped_matmul.ops import combine, grouped_gate_up, grouped_matmul
from repro_torch.models import modules as M

MODES = ("train", "prefill", "decode")


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
    """x (B, S, D) -> (B, S, D), plus the shared experts: the dropless
    layer in ``prefill`` and ``decode``, the capacity path in ``train``.
    The chunked continuation does not run MoE stacks."""
    if mode not in MODES:
        raise ValueError(f"MoE mode {mode!r}: the layer runs {MODES}")
    gates, idx = route(p, x, cfg)
    if mode == "train":
        y = _apply_capacity(p, x, gates, idx, cfg)
    else:
        y = _apply_dropless(p, x, gates, idx, cfg)
    if "shared" in p:
        y = y + M.apply_mlp(p["shared"], x, shared_config(cfg), impl=impl)
    return y


def _capacity(tokens: int, cfg) -> int:
    """Slots an expert takes in a row of ``tokens``: ``tokens * top_k /
    n_experts * capacity_factor`` rounded up, within [1, tokens]."""
    c = math.ceil(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(min(int(c), tokens), 1)


def _dispatch(x, gates, idx, E: int, C: int):
    """Each row's (token, expert) pairs sorted by expert (stable), the
    first ``C`` of an expert kept.  x (B, S, D); gates/idx (B, S, k) ->
    (buf (B, E*C, D), slot, tok, keep, gate_sorted, each (B, S*k)).  A
    dropped pair's slot is ``E*C``: written into a buffer one row longer,
    which is then cut."""
    B, S, D = x.shape
    k = idx.shape[-1]
    flat_e = idx.reshape(B, S * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    tok = order // k
    experts = torch.arange(E, dtype=sorted_e.dtype, device=x.device).expand(B, E)
    starts = torch.searchsorted(sorted_e, experts.contiguous())
    rank = torch.arange(S * k, device=x.device) - torch.gather(starts, 1, sorted_e)
    keep = rank < C
    slot = torch.where(keep, sorted_e * C + rank, E * C)
    rows = torch.arange(B, device=x.device)[:, None]
    buf = x.new_zeros((B, E * C + 1, D)).index_put((rows, slot), x[rows, tok])
    gate_sorted = torch.gather(gates.reshape(B, S * k), 1, order)
    return buf[:, :E * C], slot, tok, keep, gate_sorted


def _apply_capacity(p, x, gates, idx, cfg):
    """The capacity-sort layer: dispatch, ``act(xe w_gate) * (xe w_up)``
    and ``w_down`` as einsums over the expert buffer, then each kept pair's
    output times its gate added into its token's row (``index_add``; a
    dropped pair adds zeros)."""
    B, S, D = x.shape
    E = cfg.n_experts
    C = _capacity(S, cfg)
    dt = x.dtype
    act = M.activation(cfg.act)
    buf, slot, tok, keep, gate_sorted = _dispatch(x, gates, idx, E, C)
    xe = buf.reshape(B, E, C, D)
    we = p["experts"]
    h = act(torch.einsum("becd,edf->becf", xe, we["w_gate"].to(dt))) * \
        torch.einsum("becd,edf->becf", xe, we["w_up"].to(dt))
    ye = torch.einsum("becf,efd->becd", h, we["w_down"].to(dt)).reshape(B, E * C, D)
    rows = torch.arange(B, device=x.device)[:, None]
    gathered = ye[rows, slot.clamp_max(E * C - 1)] * keep[..., None].to(dt)
    y = x.new_zeros((B * S, D)).index_add(
        0, (rows * S + tok).reshape(-1), (gathered * gate_sorted[..., None]).reshape(-1, D))
    return y.reshape(B, S, D)


def router_aux_loss(p, x, cfg):
    """Switch-style load-balance loss of the router on x (B, S, D), f32:
    ``n_experts * sum_e(share of tokens whose top expert is e * mean
    probability of e)``."""
    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    frac_tokens = torch.nn.functional.one_hot(top1, cfg.n_experts).float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    return cfg.n_experts * torch.sum(frac_tokens * frac_probs)


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
