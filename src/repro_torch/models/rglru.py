"""Griffin / RecurrentGemma recurrent block: a causal conv and the RG-LRU
linear recurrence (counterpart of the reference's ``models/rglru.py``).

Prefill scans the recurrence ``h_t = a_t h_{t-1} + b_t`` over the sequence
in log depth: where the reference calls ``jax.lax.associative_scan``, the
port runs a doubling (Hillis–Steele) scan, ceil(log2 S) elementwise steps
(13 at 4608 tokens).  Decode is the one-step recurrence, written into the
slot pool's ``conv`` and ``h`` leaves in place.  Plain PyTorch throughout,
as the reference is plain jnp; the gate projection ``w_gate`` goes through
``qdense`` (a quantised weight runs the dequant-matmul).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.modules import dense_init
from repro_torch.models.ssm import _GatherChunks, _Tied, causal_conv, planned_conv
from repro_torch.parallel.api import (constrain, even, local_call, planned_mesh,
                                      region_placements, shard_index, sharded_over)
from repro_torch.quant.ops import qdense

_C = 8.0  # RG-LRU temperature (Griffin paper)


def init_rglru(generator, cfg, *, repeats, dtype, device):
    """``w_gate``, ``w_branch`` and ``w_out`` in ``dtype``; the conv, the
    gates ``wa``/``wi`` with their biases and ``lam`` in f32, as the
    reference keeps them (it multiplies the gates in f32)."""
    D, W, R = cfg.d_model, cfg.lru_width, repeats
    f32 = dict(dtype=torch.float32, device=device)
    if generator is None:
        lam = torch.empty((R, W), dtype=torch.float32, device="meta")
    else:
        # a = exp(-c softplus(lam) r) lands in ~(0.9, 0.999) at r ~ 0.5
        lam = (torch.rand((R, W), generator=generator, dtype=torch.float32,
                          device=generator.device) * 0.7 + 0.2).to(device)
    return {
        "w_gate": dense_init(generator, (R, D, W), dtype, device),       # GeLU branch
        "w_branch": dense_init(generator, (R, D, W), dtype, device),     # recurrent branch
        "conv_w": dense_init(generator, (R, cfg.conv_width, W), torch.float32, device,
                             fan_in=cfg.conv_width),
        "conv_b": torch.zeros((R, W), **f32),
        "wa": dense_init(generator, (R, W, W), torch.float32, device),   # recurrence gate
        "ba": torch.zeros((R, W), **f32),
        "wi": dense_init(generator, (R, W, W), torch.float32, device),   # input gate
        "bi": torch.zeros((R, W), **f32),
        "lam": lam,
        "w_out": dense_init(generator, (R, W, D), dtype, device, fan_in=W),
    }


def init_rglru_cache(cfg, batch, dtype, device):
    """``conv`` (B, W-1, lru_width) in the pool's dtype, ``h`` (B, lru_width) f32."""
    W = cfg.lru_width
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, W), dtype=dtype, device=device),
        "h": torch.zeros((batch, W), dtype=torch.float32, device=device),
    }


def _rglru_core(u, p):
    """u (B, S, W) -> (a, b), both (B, S, W) f32: h_t = a_t h_{t-1} + b_t."""
    uf = u.float()
    r = torch.sigmoid(qdense(uf, p["wa"]) + p["ba"])
    i = torch.sigmoid(qdense(uf, p["wi"]) + p["bi"])
    log_a = -_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, mult * (i * uf)


def linear_scan(a, b, split=None):
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` from h = 0 over axis 1,
    by doubling: after the step of offset d each position holds the
    composition of its last 2d elements, ``(a1, b1) then (a2, b2) = (a1 a2,
    a2 b1 + b2)``.  Returns h (the scanned b).

    ``split`` (groups, index): ``a``, ``b`` are this rank's part, the
    ``index``-th, of a sequence split over the process ``groups``; every
    rank's whole composition (its product of ``a``, its last state) is
    gathered, the state entering this rank's part composed from the ranks
    before it, and carried through the part's prefix products."""
    S, d = a.shape[1], 1
    while d < S:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        b = torch.cat([b[:, :d], a[:, d:] * b_prev + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a_prev * a[:, d:]], dim=1)
        d *= 2
    if split is None:
        return b
    groups, index = split
    ends = _GatherChunks.apply(torch.stack([a[:, -1], b[:, -1]], dim=1), 1, groups)
    h = torch.zeros_like(b[:, 0])
    for r in range(index):                   # the ranks before this one, in order
        h = ends[:, 2 * r] * h + ends[:, 2 * r + 1]
    return _Tied.apply(b + a * h[:, None], ends)


def _planned_linear_scan(a, b):
    """:func:`linear_scan` under a plan on each rank's own rows and widths,
    and on its own part of the sequence where ``a``'s placement splits it
    over mesh dims of more than one rank (``split``), so that no rank scans
    the whole sequence."""
    mesh = planned_mesh("rg-lru scan", a, b)
    if mesh is None:
        return linear_scan(a, b)
    pl = even(a.placements, a.shape, mesh)
    batch, width = sharded_over(pl, 0), sharded_over(pl, 2)
    seq = [i for i in sharded_over(pl, 1) if mesh.size(i) > 1]
    place = region_placements(mesh, {0: batch, 1: seq, 2: width})
    split = ([mesh.get_group(i) for i in seq], shard_index(mesh, seq)) if seq else None
    return local_call(lambda a, b: linear_scan(a, b, split), (a, b), (place, place), place, mesh)


def apply_rglru(p, x, *, cfg, mode, cache=None, length=None, impl="flash"):
    """x (B, S, D) -> (y, cache).

    ``prefill`` returns a fresh cache, exact at ``length`` (an int, the
    true length of a right-padded stream): pads are identity steps (a = 1,
    b = 0) and the conv state is taken before ``length``.  ``train`` is the
    same full-sequence scan with no cache (None), the reference's train
    mode.  ``decode`` (S = 1) writes the new ``conv`` and ``h`` into
    ``cache`` in place, for every row, as the reference advances every row,
    and returns it."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"the recurrent layer runs train, prefill and decode, "
                         f"not {mode!r}")
    S, dt = x.shape[1], x.dtype
    decode = mode == "decode"

    g = F.gelu(qdense(x, p["w_gate"], dt, impl=impl), approximate="tanh")
    u = qdense(x, p["w_branch"], dt)
    if decode:
        u, new_conv = causal_conv(u, p["conv_w"], p["conv_b"], cache["conv"])
    else:
        u, new_conv = planned_conv(u, p["conv_w"], p["conv_b"], length=length)
    u = constrain(u, "act_ff")
    a, b = _rglru_core(u, p)
    if length is not None and not decode:
        real = (torch.arange(S, device=x.device) < length)[None, :, None]
        a = torch.where(real, a, 1.0)
        b = torch.where(real, b, 0.0)

    if decode:
        h = a[:, 0] * cache["h"] + b[:, 0]                    # (B, W)
        hs = h[:, None]
        cache["conv"].copy_(new_conv)
        cache["h"].copy_(h)
        new_cache = cache
    else:
        hs = _planned_linear_scan(a, b)                       # zero initial state
        new_cache = {"conv": new_conv, "h": hs[:, -1]} if mode == "prefill" else None

    y = qdense(g * hs.to(dt), p["w_out"], dt)
    return y, new_cache
