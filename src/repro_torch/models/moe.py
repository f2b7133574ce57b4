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

Under a plan (:mod:`repro_torch.parallel`) the layer chooses as the
reference's does: more than one token a row goes through
:func:`_apply_gshard` (one-hot dispatch and combine einsums, in groups
aligned to the ``model`` axis, a capacity a group), one token a row (a
decode step) through the capacity path, whose sort and scatter run on
each rank's own batch rows (DTensor has no sharding rule for them).  The
expert buffer and its hidden activations take the plan's ``expert_buf``
and ``expert_hidden`` roles: the experts are sharded over ``model``.  No
planned call reaches the grouped matmul.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from repro_torch.kernels.grouped_matmul.ops import combine, grouped_gate_up, grouped_matmul
from repro_torch.models import modules as M
from repro_torch.quant.ops import qdense
from repro_torch.parallel.api import (constrain, current_plan, even, local_call, mesh_shape,
                                      planned_mesh, region_placements, sharded_over)

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
    logits = qdense(x.float(), p["router"], torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    return gates.to(x.dtype), idx


def apply_moe(p, x, cfg, *, mode: str, impl: str = "flash"):
    """x (B, S, D) -> (B, S, D), plus the shared experts.  Without a plan:
    the dropless layer in ``prefill`` and ``decode``, the capacity path in
    ``train``; under a plan: :func:`_apply_gshard` for more than one token
    a row, else the capacity path.  The chunked continuation does not run
    MoE stacks."""
    if mode not in MODES:
        raise ValueError(f"MoE mode {mode!r}: the layer runs {MODES}")
    gates, idx = route(p, x, cfg)
    plan = current_plan()
    if mode != "train" and plan is None:
        y = _apply_dropless(p, x, gates, idx, cfg)
    elif plan is not None and x.shape[1] > 1:
        y = _apply_gshard(p, x, gates, idx, cfg)
    else:
        y = _apply_capacity(p, x, gates, idx, cfg)
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
    mesh = planned_mesh("moe dispatch", x)
    rows = None if mesh is None else region_placements(
        mesh, {0: sharded_over(even(x.placements, x.shape, mesh), 0)})
    dispatched = _rows(mesh, (rows,) * 3, (rows,) * 5, lambda x, g, i: _dispatch(x, g, i, E, C),
                       (x, gates, idx))
    buf, slot, tok, keep, gate_sorted = dispatched
    ye = _expert_ffn(p, buf.reshape(B, E, C, D), dt, act)
    return _rows(mesh, (rows,) * 5, rows, lambda ye, *d: _combine(
        ye.reshape(ye.shape[0], E * C, D), *d, S), (ye, slot, tok, keep, gate_sorted))


def _expert_ffn(p, xe, dt, act):
    """``act(xe w_gate) * (xe w_up)``, then ``w_down``, as einsums over the
    expert buffer xe (B, E, C, D), placed by the ``expert_buf`` and
    ``expert_hidden`` roles.  Under a plan each rank multiplies its own
    batch rows and experts (``local_map``; DTensor's einsum would flatten
    a sharded expert dim), the banks gathered over any other axis and
    their gradients partial sums over the batch's."""
    from torch.distributed.tensor import Partial
    we = p["experts"]
    banks = (we["w_gate"], we["w_up"], we["w_down"])

    def ffn(xe, wg, wu, wd):
        h = act(torch.einsum("becd,edf->becf", xe, wg.to(dt))) * \
            torch.einsum("becd,edf->becf", xe, wu.to(dt))
        h = constrain(h, "expert_hidden")
        return torch.einsum("becf,efd->becd", h, wd.to(dt))
    xe = constrain(xe, "expert_buf")
    mesh = planned_mesh("moe experts", xe, *banks)
    if mesh is None:
        return constrain(ffn(xe, *banks), "expert_buf")
    pl = even(xe.placements, xe.shape, mesh)
    batch, experts = sharded_over(pl, 0), sharded_over(pl, 1)
    bx = region_placements(mesh, {0: batch, 1: experts})
    bw = region_placements(mesh, {0: experts})
    gw = tuple(Partial() if i in batch else w for i, w in enumerate(bw))
    return local_call(ffn, (xe, *banks), (bx, bw, bw, bw), bx, mesh,
                      grad_placements=(bx, gw, gw, gw))


def _rows(mesh, ins, out, fn, args):
    """``fn(*args)``, or under a plan on each rank's own shards (placements
    ``ins`` for the inputs, ``out`` for the output)."""
    if mesh is None:
        return fn(*args)
    return local_call(fn, args, ins, out, mesh)


def _combine(ye, slot, tok, keep, gate_sorted, S: int):
    """Each kept pair's expert output (``ye`` (B, E*C, D)) times its gate,
    added into its token's row (``index_add``; a dropped pair adds
    zeros) -> (B, S, D)."""
    B, EC, D = ye.shape
    rows = torch.arange(B, device=ye.device)[:, None]
    gathered = ye[rows, slot.clamp_max(EC - 1)] * keep[..., None].to(ye.dtype)
    y = ye.new_zeros((B * S, D)).index_add(
        0, (rows * S + tok).reshape(-1), (gathered * gate_sorted[..., None]).reshape(-1, D))
    return y.reshape(B, S, D)


def _one_hot(x, n: int):
    """``jax.nn.one_hot``: f32 rows of ``x == arange(n)`` (an index outside
    ``[0, n)`` gives a row of zeros)."""
    return (x[..., None] == torch.arange(n, device=x.device)).float()


def _apply_gshard(p, x, gates, idx, cfg):
    """GShard-style dispatch: per-sequence-group one-hot dispatch/combine
    einsums with a local capacity.  Groups are aligned to the sequence
    sharding (G = the plan's model-axis size when it divides S), so the
    rank cumsum is group-local and every op partitions.

    x (B, S, D), gates/idx (B, S, k) -> (B, S, D)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    dt = x.dtype
    act = M.activation(cfg.act)
    plan = current_plan()
    G = 1
    if plan is not None:
        g = mesh_shape(plan.mesh).get("model", 1)
        if S % g == 0:
            G = g
    Sg = S // G
    Cg = _capacity(Sg, cfg)
    xg = x.reshape(B, G, Sg, D)
    wg = gates.reshape(B, G, Sg, k)
    # position-in-expert ranks, the k slots taken in priority order
    onehot = _one_hot(idx.reshape(B, G, Sg, k), E)               # (B,G,Sg,k,E)
    # tokens before s (all k slots) + earlier slots at s
    per_tok = onehot.sum(3)
    cum_tok = torch.cumsum(per_tok, dim=2) - per_tok             # (B,G,Sg,E)
    cum_slot = torch.cumsum(onehot, dim=3) - onehot              # (B,G,Sg,k,E)
    rank = cum_tok[:, :, :, None, :] + cum_slot                  # (B,G,Sg,k,E)
    keep = (rank < Cg) & (onehot > 0)
    rank = torch.sum(rank * onehot, dim=-1)                      # (B,G,Sg,k)
    keepk = keep.any(dim=-1)                                     # (B,G,Sg,k)
    oh_c = _one_hot(rank.to(torch.int32), Cg)
    # dispatch (B,G,Sg,k,E,Cg), contracted at once
    disp = onehot[..., None] * oh_c[..., None, :] * keepk[..., None, None].float()
    disp_sum = disp.sum(3).to(dt)                                # (B,G,Sg,E,Cg)
    comb = (disp * wg[..., None, None].float()).sum(3).to(dt)    # (B,G,Sg,E,Cg)

    # under a plan each rank dispatches and combines its own batch rows and
    # its own groups, where the sequence's split is the groups'; its slots
    # of the expert buffer are its groups' (dim 2 of (B, E, G*Cg, D))
    mesh = planned_mesh("moe gshard", x)
    rows = bufs = None
    if mesh is not None:
        pl = even(x.placements, x.shape, mesh)
        batch, seq = sharded_over(pl, 0), sharded_over(pl, 1)
        if G == 1 or math.prod(mesh.size(i) for i in seq) != G:
            seq = []
        rows = region_placements(mesh, {0: batch, 1: seq})
        bufs = region_placements(mesh, {0: batch, 2: seq})
    xe = _rows(mesh, (rows, rows), bufs, lambda d, xg: torch.einsum(
        "bgsec,bgsd->begcd", d, xg).reshape(d.shape[0], E, d.shape[1] * Cg, D), (disp_sum, xg))
    ye = _expert_ffn(p, xe, dt, act)

    def combine_(c, ye):
        with combine_product():
            y = torch.einsum("bgsec,begcd->bgsd", c, ye.reshape(c.shape[0], E, c.shape[1], Cg, D))
        return y.reshape(c.shape[0], c.shape[1] * Sg, D)
    return _rows(mesh, (rows, bufs), rows, combine_, (comb, ye))


# open GShard combine products: a remat'd layer keeps their outputs (no
# gradient reads them, so the backward pass need not compute them again)
_combining = [0]


@contextlib.contextmanager
def combine_product():
    _combining[0] += 1
    try:
        yield
    finally:
        _combining[0] -= 1


def in_combine_product() -> bool:
    return _combining[0] > 0


def router_aux_loss(p, x, cfg):
    """Switch-style load-balance loss of the router on x (B, S, D), f32:
    ``n_experts * sum_e(share of tokens whose top expert is e * mean
    probability of e)``."""
    probs = torch.softmax(qdense(x.float(), p["router"], torch.float32), dim=-1)
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
