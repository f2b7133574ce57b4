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
from repro_torch.parallel.api import (constrain, current_plan, even, local_call, placements,
                                      planned_mesh, region_placements, shard_index, sharded_over)
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


def planned_conv(x, w, b, length=None):
    """:func:`causal_conv` from a zero state (a prefill or train stream),
    under a plan on each rank's own rows and channels, and on its own part
    of the sequence where ``x``'s placement splits it over mesh dims of
    more than one rank: each rank takes the ``W-1`` inputs before its part
    from the rank before it (every rank's last ``W-1`` inputs gathered, a
    few rows a rank), and the new state is the last rank's last ``W-1``
    inputs, on every rank.  A ``length`` short of the stream, or parts
    shorter than ``W-1``, take the unsplit conv."""
    mesh = planned_mesh("causal conv", x)
    if mesh is None:
        return causal_conv(x, w, b, None, length=length)
    from torch.distributed.tensor import Partial
    W = w.shape[0]
    pl = even(x.placements, x.shape, mesh)
    batch, chans = sharded_over(pl, 0), sharded_over(pl, 2)
    seq = [i for i in sharded_over(pl, 1) if mesh.size(i) > 1]
    ranks = math.prod(mesh.size(i) for i in seq)
    if not seq or W < 2 or (length is not None and length != x.shape[1]) \
            or x.shape[1] // ranks < W - 1:
        return causal_conv(x, w, b, None, length=length)
    groups, index = [mesh.get_group(i) for i in seq], shard_index(mesh, seq)
    rows = region_placements(mesh, {0: batch, 1: seq, 2: chans})
    state = region_placements(mesh, {0: batch, 2: chans})
    taps, bias = region_placements(mesh, {1: chans}), region_placements(mesh, {0: chans})
    summed = set(batch + seq)

    def grads(pl_):
        return tuple(Partial() if i in summed else p for i, p in enumerate(pl_))

    def local(x, w, b):
        tails = _GatherChunks.apply(x[:, x.shape[1] - (W - 1):], 1, groups)
        before = x.new_zeros((x.shape[0], W - 1, x.shape[2])) if index == 0 else \
            tails[:, (index - 1) * (W - 1):index * (W - 1)]
        y, _ = causal_conv(x, w, b, before)
        return _Tied.apply(y, tails), tails[:, tails.shape[1] - (W - 1):]
    ins = (rows, taps, None if b is None else bias)
    return local_call(local, (x, w, b), ins, (rows, state), mesh,
                      grad_placements=(rows, grads(taps), None if b is None else grads(bias)))


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


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int, init_state=None, split=None):
    """Chunked SSD.  x (b, l, h, p); dt (b, l, h) f32 (post-softplus); A
    (h,) f32 (negative); Bm, Cm (b, l, g, n).  Returns (y (b, l, h, p) in
    x's dtype, final_state (b, h, p, n) f32).  A length that ``chunk`` does
    not divide is one chunk of that length, as in the reference.

    ``split`` (groups, index): the inputs are this rank's slice, the
    ``index``-th, of a sequence split over the process ``groups`` (major
    to minor) in whole chunks.  The intra-chunk products and the chunk
    states are the rank's own; the chunk states and decays of every rank
    are gathered (:class:`_GatherChunks`), so that each rank runs the
    small inter-chunk recurrence over the whole sequence, in the same
    order as unsplit, and takes the states before its own chunks.  The
    final state is then every rank's, without a gradient (a cache, which
    nothing trains through)."""
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
    #    the state before it (over every rank's chunks under ``split``)
    chunk_decay = torch.exp(dA_cs[..., -1])                    # (b,h,c)
    c0 = 0
    if split is not None:
        groups, index = split
        c0 = index * nc
        states = _GatherChunks.apply(states, 1, groups)
        chunk_decay = _GatherChunks.apply(chunk_decay, 2, groups)
        gathered = (states, chunk_decay)
    s = x.new_zeros((b, h, p, n), dtype=torch.float32) if init_state is None \
        else init_state.float()
    prev = []
    for c in range(states.shape[1]):
        prev.append(s)
        s = s * chunk_decay[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(prev[c0:c0 + nc], dim=1)         # (b,c,h,p,n)

    # 4. inter-chunk contribution
    state_decay = torch.exp(dA_cs)                             # (b,h,c,q)
    y_off = torch.einsum("bcqhn,bchpn,bhcq->bcqhp", Cc, prev_states, state_decay)

    y = (y_diag + y_off).reshape(b, l, h, p)
    if split is None:
        return y.to(x.dtype), s
    y = _Tied.apply(_Tied.apply(y, gathered[0]), gathered[1])
    return y.to(x.dtype), s.detach()


class _GatherChunks(torch.autograd.Function):
    """``x``'s dim ``d`` gathered over the process ``groups`` (major to
    minor: the minor group first), every rank's chunks in sequence order;
    the gradient reduced and scattered back (each rank's part of the sum
    over every rank that read its chunks).  Every rank must run the
    backward, a collective: a rank whose output does not read what was
    gathered ties it to its output (:class:`_Tied`)."""

    @staticmethod
    def forward(ctx, x, d, groups):
        from torch.distributed import _functional_collectives as funcol
        ctx.d, ctx.groups = d, groups
        for g in reversed(groups):
            x = funcol.wait_tensor(funcol.all_gather_tensor(x.contiguous(), d, g))
        return x

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed import _functional_collectives as funcol
        for g in ctx.groups:
            grad = funcol.wait_tensor(funcol.reduce_scatter_tensor(grad.contiguous(), "sum",
                                                                   ctx.d, g))
        return grad, None, None


class _Tied(torch.autograd.Function):
    """``y`` as it is, tied to ``x`` in the autograd graph with a zero
    gradient, so that every rank runs the backward of ``x``'s gather (a
    collective every rank must join), whether or not its output read it."""

    @staticmethod
    def forward(ctx, y, x):
        ctx.like = (x.shape, x.dtype)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        shape, dtype = ctx.like
        return grad, grad.new_zeros(shape, dtype=dtype)


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
    (``local_map``), and on its own part of the sequence where the plan's
    ``residual`` role splits the sequence over mesh dims of more than one
    rank in whole chunks (``split``: the reference's partitioned program
    splits the chunks' products the same way), the heads whole: its
    einsums' batched products would flatten a batch dim sharded over
    ``data`` with a chunk or head dim sharded over ``model``, which
    DTensor refuses (torch 2.11) or meets by replicating every operand.
    ``A`` is replicated into the region; its gradient is each rank's part
    of a sum over the batch rows and chunks."""
    mesh = planned_mesh("ssd scan", x, dt, Bm, Cm)
    if mesh is None:
        return ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    from torch.distributed.tensor import Partial
    batch = sharded_over(even(x.placements, x.shape, mesh), 0)
    spec = current_plan().spec("residual") or (None,)
    seq = [i for i in sharded_over(even(placements(spec, mesh), (*x.shape[:2], 1), mesh), 1)
           if mesh.size(i) > 1 and i not in batch]
    ranks = math.prod(mesh.size(i) for i in seq)
    if x.shape[1] % (chunk * ranks):
        seq = []                            # the sequence is not whole chunks a rank
    rows = region_placements(mesh, {0: batch, 1: seq})
    whole = region_placements(mesh, {})
    state = region_placements(mesh, {0: batch})
    a_grad = tuple(Partial() if i in batch + seq else p for i, p in enumerate(whole))
    split = ([mesh.get_group(i) for i in seq], shard_index(mesh, seq)) if seq else None
    return local_call(lambda *t: ssd_scan(*t, chunk=chunk, split=split), (x, dt, A, Bm, Cm),
                      (rows, rows, whole, rows, rows), (rows, state), mesh,
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
    if decode:
        xBC, new_conv = causal_conv(xBC, p["conv_w"], p["conv_b"], cache["conv"])
    else:
        xBC, new_conv = planned_conv(xBC, p["conv_w"], p["conv_b"], length=length)
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
