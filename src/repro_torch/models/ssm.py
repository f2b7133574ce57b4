"""Mamba-2 SSD (state-space duality) block: the chunked scan of prefill and
the one-token recurrence of decode (counterpart of the reference's
``models/ssm.py``).

Everything here is plain PyTorch (einsum, cumsum, elementwise), as the
reference's is plain jnp: no Pallas kernel stands behind it.  The
reference's ``lax.scan`` over the chunk states becomes a Python loop over
the chunks.  Decode updates the slot pool's ``conv`` and ``state`` leaves
in place, so a captured decode step replays them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.modules import dense_init, rmsnorm
from repro_torch.parallel.api import (constrain, even, local_call, planned_mesh,
                                      region_placements, sharded_over)
from repro_torch.quant.ops import qdense

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# causal depthwise conv (width W) with optional streaming state
# ---------------------------------------------------------------------------

def causal_conv(x, w, b, state=None, length=None):
    """x (B, S, C); w (W, C); state (B, W-1, C) or None -> (y, new_state).

    The taps are summed op by op in x's dtype from the first, as the
    reference sums them.  ``length`` (an int): the true token count of a
    right-padded stream — the new state is then the last W-1 inputs
    *before* ``length``, zeros where there are fewer, so pads never enter
    it.  Outputs at positions >= length are garbage and must not be
    consumed."""
    B, S, C = x.shape
    W = w.shape[0]
    pad = x.new_zeros((B, W - 1, C)) if state is None else state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                      # (B, S+W-1, C)
    y = xp[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, W):
        y = y + xp[:, i:i + S] * w[i].to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    if length is None:
        return y, xp[:, S:]                              # last W-1 inputs
    idx = length - (W - 1) + torch.arange(W - 1, device=x.device)
    new_state = torch.where((idx >= 0)[None, :, None], x[:, idx.clamp(0, S - 1)], 0)
    return y, new_state.to(x.dtype)


# ---------------------------------------------------------------------------
# SSD chunked scan (Dao & Gu 2024, alg. 1)
# ---------------------------------------------------------------------------

def _segsum(x):
    """x (..., q) -> (..., q, q): ss[i, j] = sum_{j<t<=i} x[t] (a cumsum
    difference), NEG_INF above the diagonal."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return torch.where(mask, d, NEG_INF)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int, init_state=None):
    """Chunked SSD.  x (b, l, h, p); dt (b, l, h) f32 (post-softplus); A
    (h,) f32 (negative); Bm, Cm (b, l, g, n).  Returns (y (b, l, h, p) in
    x's dtype, final_state (b, h, p, n) f32).  A length that ``chunk`` does
    not divide is one chunk of that length, as in the reference."""
    b, l, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    if l % chunk:
        chunk = l
    nc = l // chunk

    xf = (x.float() * dt[..., None]).reshape(b, nc, chunk, h, p)
    dA = (dt * A).reshape(b, nc, chunk, h)                     # (b,c,q,h)
    Bc = Bm.float().repeat_interleave(rep, dim=2).reshape(b, nc, chunk, h, n)
    Cc = Cm.float().repeat_interleave(rep, dim=2).reshape(b, nc, chunk, h, n)

    dA_h = dA.permute(0, 3, 1, 2)                              # (b,h,c,q)
    dA_cs = torch.cumsum(dA_h, dim=-1)

    # 1. intra-chunk (diagonal blocks)
    L = torch.exp(_segsum(dA_h))                               # (b,h,c,q,q)
    scores = torch.einsum("bcqhn,bckhn->bhcqk", Cc, Bc)
    y_diag = torch.einsum("bhcqk,bckhp->bcqhp", scores * L, xf)
    del L, scores

    # 2. per-chunk final states
    decay = torch.exp(dA_cs[..., -1:] - dA_cs)                 # (b,h,c,q)
    states = torch.einsum("bckhn,bhck,bckhp->bchpn", Bc, decay, xf)

    # 3. inter-chunk recurrence over the nc chunk states, each chunk given
    #    the state before it
    chunk_decay = torch.exp(dA_cs[..., -1])                    # (b,h,c)
    s = x.new_zeros((b, h, p, n), dtype=torch.float32) if init_state is None \
        else init_state.float()
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                     # (b,c,h,p,n)

    # 4. inter-chunk contribution
    state_decay = torch.exp(dA_cs)                             # (b,h,c,q)
    y_off = torch.einsum("bcqhn,bchpn,bhcq->bcqhp", Cc, prev_states, state_decay)

    y = (y_diag + y_off).reshape(b, l, h, p)
    return y.to(x.dtype), s


def ssd_step(x, dt, A, Bm, Cm, state):
    """One-token recurrence.  x (b, h, p); dt (b, h); Bm/Cm (b, g, n);
    state (b, h, p, n) f32 -> (y (b, h, p), new_state)."""
    rep = x.shape[1] // Bm.shape[1]
    Bh = Bm.float().repeat_interleave(rep, dim=1)              # (b,h,n)
    Ch = Cm.float().repeat_interleave(rep, dim=1)
    dA = torch.exp(dt * A)                                     # (b,h)
    xs = x.float() * dt[..., None]                             # (b,h,p)
    new_state = state * dA[..., None, None] + xs[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# the mamba2 block
# ---------------------------------------------------------------------------

def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    return d_inner, H, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups


def init_mamba(generator, cfg, *, repeats, dtype, device):
    """The reference's distributions: ``dt`` log-uniform in [1e-3, 0.1]
    stored as its inverse softplus (``dt_bias``), ``A_log = log(1..16)``.
    ``in_proj``/``out_proj`` in ``dtype``; the conv, ``A_log``, ``D``,
    ``dt_bias`` and the norm vector in f32, as the reference keeps them."""
    d_inner, H, P, N, G = _dims(cfg)
    R = repeats
    conv_ch = d_inner + 2 * G * N
    d_in = 2 * d_inner + 2 * G * N + H
    f32 = dict(dtype=torch.float32, device=device)
    if generator is None:
        dt_bias = torch.empty((R, H), dtype=torch.float32, device="meta")
    else:
        u = torch.rand((R, H), generator=generator, dtype=torch.float32,
                       device=generator.device)
        dt0 = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
        dt_bias = torch.log(torch.expm1(dt0)).to(device)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, **f32))
    return {
        "in_proj": dense_init(generator, (R, cfg.d_model, d_in), dtype, device),
        "conv_w": dense_init(generator, (R, cfg.conv_width, conv_ch), torch.float32,
                             device, fan_in=cfg.conv_width),
        "conv_b": torch.zeros((R, conv_ch), **f32),
        "A_log": a_log.expand(R, H).clone(),
        "D": torch.ones((R, H), **f32),
        "dt_bias": dt_bias,
        "norm": torch.zeros((R, d_inner), **f32),
        "out_proj": dense_init(generator, (R, d_inner, cfg.d_model), dtype, device,
                               fan_in=d_inner),
    }


def init_ssm_cache(cfg, batch, dtype, device):
    """``conv`` (B, W-1, C) in the pool's dtype, ``state`` (B, H, P, N) f32."""
    d_inner, H, P, N, G = _dims(cfg)
    conv_ch = d_inner + 2 * G * N
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch), dtype=dtype, device=device),
        "state": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
    }


def _planned_scan(x, dt, A, Bm, Cm, *, chunk: int):
    """:func:`ssd_scan`, under a plan on each rank's own batch rows
    (``local_map``), the sequence and heads whole: the scan runs along the
    whole sequence, and its einsums' batched products would flatten a
    batch dim sharded over ``data`` with a chunk or head dim sharded over
    ``model``, which DTensor refuses (torch 2.11) or meets by replicating
    every operand.  ``A`` is replicated into the region; its gradient is
    each rank's part of a sum over the batch rows."""
    mesh = planned_mesh("ssd scan", x, dt, Bm, Cm)
    if mesh is None:
        return ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    from torch.distributed.tensor import Partial
    batch = sharded_over(even(x.placements, x.shape, mesh), 0)
    rows, whole = region_placements(mesh, {0: batch}), region_placements(mesh, {})
    a_grad = tuple(Partial() if i in batch else p for i, p in enumerate(whole))
    return local_call(lambda *t: ssd_scan(*t, chunk=chunk), (x, dt, A, Bm, Cm),
                      (rows, rows, whole, rows, rows), (rows, rows), mesh,
                      grad_placements=(rows, rows, a_grad, rows, rows))


def apply_mamba(p, x, *, cfg, mode, cache=None, length=None):
    """x (B, S, D) -> (y, cache).

    ``prefill`` returns a fresh cache, exact at ``length`` (an int, the
    true length of a right-padded stream): ``dt = 0`` on pads, so the state
    passes them through unchanged, and the conv state is taken before
    ``length``.  ``train`` is the same full-sequence scan from a zero state
    with no cache (None), the reference's train mode.  ``decode`` (S = 1)
    writes the new ``conv`` and ``state`` into ``cache`` in place, for
    every row (a dead slot's too, as the reference advances them;
    admission overwrites a slot whole) and returns it."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"the ssm layer runs train, prefill and decode, not {mode!r}")
    B, S, D = x.shape
    d_inner, H, P, N, G = _dims(cfg)
    dt_x = x.dtype

    zxbcdt = qdense(x, p["in_proj"], dt_x)
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * G * N]
    dt_raw = zxbcdt[..., -H:]

    decode = mode == "decode"
    xBC, new_conv = causal_conv(xBC, p["conv_w"], p["conv_b"],
                                cache["conv"] if decode else None,
                                length=None if decode else length)
    xBC = F.silu(xBC)

    x_ssm = xBC[..., :d_inner].reshape(B, S, H, P)
    Bm = xBC[..., d_inner:d_inner + G * N].reshape(B, S, G, N)
    Cm = xBC[..., d_inner + G * N:].reshape(B, S, G, N)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    if length is not None and not decode:
        # dt = 0 on pads: exp(dt*A) = 1 and dt*x = 0, an identity update
        real = torch.arange(S, device=x.device) < length
        dt = torch.where(real[None, :, None], dt, 0.0)
    A = -torch.exp(p["A_log"])

    if decode:
        y, new_state = ssd_step(x_ssm[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0],
                                cache["state"])
        y = y[:, None]
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(new_state)
        new_cache = cache
    else:
        y, final_state = _planned_scan(x_ssm, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
        new_cache = {"conv": new_conv, "state": final_state} if mode == "prefill" else None

    y = y + x_ssm * p["D"][None, None, :, None].to(dt_x)
    y = y.reshape(B, S, d_inner)
    y = constrain(rmsnorm(y * F.silu(z), p["norm"]), "act_ff")
    return qdense(y, p["out_proj"], dt_x), new_cache
