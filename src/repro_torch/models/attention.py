"""Attention layers: MHA/GQA/MQA with global or local (sliding-window,
ring-buffer cache) attention (counterpart of the reference's
``models/attention.py``, self-attention).

The slot pool is fp (``k``/``v``) or, with ``kv_bits`` 8 or 4, quantised:
int8 code planes ``k_q``/``v_q`` (two int4 codes a byte along the head
dim) with per-(entry, head) f32 scales ``k_s``/``v_s``, quantised on
commit and dequantised on read.  Every projection goes through
:func:`repro_torch.quant.ops.qdense`, so a quantised weight runs the
dequant-matmul.

Serving modes:

- ``mode="prefill"`` with ``segments=`` — **packed ragged prefill**:
  several prompts in one token stream, per-token prompt ids, no
  cross-prompt attention.  Returns the *raw per-token* cache; the serving
  engine scatters each segment into its KV slot;
- ``mode="prefill"`` without ``segments`` — one right-padded prompt
  whose cache is *exact* at ``length`` (the sequential baseline): a
  global layer's cache is the stream padded to ``kv_cap`` entries, a
  local layer's a ring of the last real tokens (pads never enter it);
- ``mode="chunk"`` — **chunked prefill continuation**: S tokens per batch
  row are written into the KV cache at explicit positions (``pos < 0`` =
  pad, dropped) and attend to the pre-write cache plus the chunk;
- ``mode="decode"`` — one token per slot, written at ``pos`` (``-1`` =
  dead slot, dropped), attending to the post-write cache.

The reference's functional cache update becomes an **in-place** update
of the pool tensors here: ``chunk``/``decode`` write into ``cache`` and
return it, with fixed shapes and no read of device data by the host, so
that the serving engine can capture them in a CUDA graph.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import attention as flash_attention
from repro_torch.models.modules import apply_rope, dense_init, rmsnorm
from repro_torch.quant.core import (dequantize_kv, kv_cache_bits, quantize_kv,
                                    quantize_kv_cache)
from repro_torch.quant.ops import qdense


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_attention(generator, cfg, *, repeats, dtype, device):
    D = cfg.d_model
    Hq, Hkv, hd, hdv = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.v_head_dim
    R = repeats
    p = {
        "wq": dense_init(generator, (R, D, Hq * hd), dtype, device),
        "wk": dense_init(generator, (R, D, Hkv * hd), dtype, device),
        "wv": dense_init(generator, (R, D, Hkv * hdv), dtype, device),
        "wo": dense_init(generator, (R, Hq * hdv, D), dtype, device, fan_in=Hq * hdv),
    }
    f32 = dict(dtype=torch.float32, device=device)
    if cfg.qk_norm:
        # (scale - 1) of the per-head rms norms of q and k, as the reference's
        p["q_norm"] = torch.zeros((R, hd), **f32)
        p["k_norm"] = torch.zeros((R, hd), **f32)
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((R, Hq * hd), **f32)
        p["bk"] = torch.zeros((R, Hkv * hd), **f32)
        p["bv"] = torch.zeros((R, Hkv * hdv), **f32)
    return p


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

def init_kv_cache(cfg, kind: str, batch: int, kv_len: int, dtype, device,
                  kv_bits: int = 0):
    """``kv_bits`` 0 keeps the fp pool; 8/4 allocate the quantised pool."""
    Hkv, hd, hdv = cfg.n_kv_heads, cfg.head_dim, cfg.v_head_dim
    cap = kv_len if kind == "global" else min(cfg.window, kv_len)
    if kv_bits in (4, 8):
        pack = 2 if kv_bits == 4 else 1
        if hd % pack or hdv % pack:
            raise ValueError(f"int4 KV needs even head dims, got {hd}/{hdv}")
        i8 = dict(dtype=torch.int8, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        return {
            "k_q": torch.zeros((batch, cap, Hkv, hd // pack), **i8),
            "k_s": torch.zeros((batch, cap, Hkv), **f32),
            "v_q": torch.zeros((batch, cap, Hkv, hdv // pack), **i8),
            "v_s": torch.zeros((batch, cap, Hkv), **f32),
            "pos": torch.full((batch, cap), -1, dtype=torch.int32, device=device),
        }
    if kv_bits:
        raise ValueError(f"kv_bits must be 0, 4 or 8, got {kv_bits}")
    return {
        "k": torch.zeros((batch, cap, Hkv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, cap, Hkv, hdv), dtype=dtype, device=device),
        "pos": torch.full((batch, cap), -1, dtype=torch.int32, device=device),
    }


def ring_positions(length, cap: int):
    """Position held by each slot of a ``cap``-entry ring cache after
    prefilling ``length`` tokens: slot ``s`` holds ``p ≡ s (mod cap)``,
    ``p ∈ [length-cap, length)``; ``p < 0`` = empty.  ``length`` (B, 1)
    gives (B, cap).  For global caches (cap >= length) this is the
    identity layout."""
    s_idx = torch.arange(cap, dtype=torch.int32, device=length.device)
    return length - 1 - torch.remainder(length - 1 - s_idx, cap)


def _ring_fill(k, v, cap: int, length):
    """A ring cache of ``cap`` entries holding the last real tokens of a
    right-padded stream (positions ``arange(S)``, ``length`` of them
    real): ring index ``s`` holds position ``p ≡ s (mod cap)``, ``p ∈
    [length-cap, length)``, pulled from the stream; pads never enter the
    ring and never evict a real entry."""
    B, S = k.shape[:2]
    p = ring_positions(torch.full((), length, dtype=torch.int32, device=k.device), cap)
    valid = p >= 0
    src = p.clamp(0, S - 1).long()
    keep = valid[None, :, None, None]
    return (torch.where(keep, k[:, src], 0), torch.where(keep, v[:, src], 0),
            torch.where(valid, p, -1).expand(B, cap))


def _pad_cache(x, cap: int):
    """``x`` (B, S, ...) padded with zeros to ``cap`` entries."""
    B, S = x.shape[:2]
    if cap <= S:
        return x
    return torch.cat([x, x.new_zeros((B, cap - S) + tuple(x.shape[2:]))], dim=1)


def _pad_pos(pos, cap: int):
    """``pos`` (B, S) padded with empty entries (-1) to ``cap``."""
    B, S = pos.shape
    if cap <= S:
        return pos
    return torch.cat([pos, pos.new_full((B, cap - S), -1)], dim=1)


def unique_targets(loc, keep, n_loc: int):
    """Where to write entries bound for flat locations ``loc`` (those with
    ``keep``; their locations distinct) of a tensor holding ``n_loc``, so
    that no two writes share a target (``index_put_`` with duplicate
    indices is undefined on CUDA): (entries, targets, kept).  The kept
    entries come first, and at most ``n_loc`` entries are taken; each
    dropped one is sent to its own location that no kept entry targets,
    where it writes back what is there.  Fixed shapes, no host read."""
    n = min(loc.shape[0], n_loc)
    sel = torch.sort(keep.to(torch.uint8), descending=True, stable=True).indices[:n]
    loc, keep = loc[sel].long(), keep[sel]
    taken = torch.zeros(n_loc, dtype=torch.int32, device=loc.device).scatter_add_(
        0, loc.clamp(0, n_loc - 1), keep.to(torch.int32))
    # the d-th dropped entry takes the d-th location that no kept one takes
    spare = torch.searchsorted(torch.cumsum(taken == 0, 0), torch.cumsum(~keep, 0))
    return sel, torch.where(keep, loc, spare), keep


def put_unique(pool, sel, tgt, keep, vals, lead: int = 0):
    """``vals[sel]`` written at :func:`unique_targets`' targets of ``pool``,
    in place: the two axes after ``lead`` are the flat locations, and a
    dropped entry's target keeps its value."""
    flat = pool.view(*pool.shape[:lead], -1, *pool.shape[lead + 2:])
    ix = (slice(None),) * lead
    k = keep.view((-1,) + (1,) * (flat.dim() - lead - 1))
    flat[ix + (tgt,)] = torch.where(k, vals[ix + (sel,)].to(flat.dtype), flat[ix + (tgt,)])


def _ring_write(cache, new_leaves: dict, pos):
    """Write S tokens at per-(row, token) ``pos`` into the cache in place
    (ring for local, direct for global).  ``new_leaves`` maps cache leaf
    names to the (B, S, ...) values to commit: k/v, or the code and scale
    planes.  ``pos < 0`` entries are dropped:
    dead pool slots and chunk pads never touch the cache.  Within one call
    only the last ``cap`` positions of a row survive the ring, so those are
    the only ones written (each row's targets stay unique)."""
    cap = cache["pos"].shape[1]
    B, S = pos.shape
    row_max = torch.where(pos >= 0, pos, -1).amax(dim=1, keepdim=True)
    valid = (pos >= 0) & (pos > row_max - cap)
    slot = torch.remainder(pos, cap)
    leaves = dict(new_leaves, pos=pos)
    if S == 1:
        # decode, the hot path, in fewer launches: one target per row, so a
        # row without a valid write rewrites what its target holds
        bidx = torch.arange(B, device=pos.device)
        s = torch.where(valid[:, 0], slot[:, 0], 0)
        for name, leaf in leaves.items():
            pool = cache[name]
            keep = valid[:, 0].reshape((B,) + (1,) * (pool.dim() - 2))
            pool[bidx, s] = torch.where(keep, leaf[:, 0].to(pool.dtype), pool[bidx, s])
    else:
        row = torch.arange(B, device=pos.device)[:, None]
        sel, tgt, keep = unique_targets((row * cap + slot).reshape(-1), valid.reshape(-1),
                                        B * cap)
        for name, leaf in leaves.items():
            put_unique(cache[name], sel, tgt, keep,
                       leaf.reshape((B * S,) + tuple(leaf.shape[2:])))
    return cache


def _commit_kv(cache, new_k, new_v, pos):
    """Commit fresh K/V rows into the slot pool (in place): a quantised pool
    quantises them on commit (one scale per (token, head) row), so an fp
    copy of the pool never exists between steps."""
    if "k_q" in cache:
        bits = kv_cache_bits(cache, new_k.shape[-1])
        k_q, k_s = quantize_kv(new_k, bits)
        v_q, v_s = quantize_kv(new_v, bits)
        return _ring_write(cache, {"k_q": k_q, "k_s": k_s, "v_q": v_q, "v_s": v_s}, pos)
    return _ring_write(cache, {"k": new_k, "v": new_v}, pos)


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def apply_attention(p, x, *, cfg, kind: str, mode: str, pos, cache=None,
                    impl: str = "flash", segments=None, kv_bits: int = 0,
                    kv_cap: int = 0, length=None):
    """x (B, S, D); pos (B, S) int32 (decode: (B, 1); chunk: -1 = pad).
    Prefill: ``kv_bits`` returns a quantised cache; without ``segments``,
    ``kv_cap`` is the cache's capacity (at least S) and ``length`` the
    prompt's true length (default S).  Returns (out (B, S, D), cache)."""
    if kind not in ("global", "local"):
        raise NotImplementedError(f"layer kind {kind!r} has no port yet")
    if mode not in ("prefill", "chunk", "decode"):
        raise NotImplementedError(
            f"attention mode {mode!r} has no port yet: serving runs prefill, "
            f"chunk and decode")
    B, S, D = x.shape
    Hq, Hkv, hd, hdv = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.v_head_dim
    dt = x.dtype
    window = cfg.window if kind == "local" else 0
    theta = cfg.rope_theta_local if (kind == "local" and cfg.rope_theta_local) \
        else cfg.rope_theta

    q = qdense(x, p["wq"], dt, impl=impl)
    k = qdense(x, p["wk"], dt, impl=impl)
    v = qdense(x, p["wv"], dt, impl=impl)
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q, k = q.reshape(B, S, Hq, hd), k.reshape(B, S, Hkv, hd)
    if cfg.qk_norm:
        q, k = rmsnorm(q, p["q_norm"]), rmsnorm(k, p["k_norm"])
    q, k = apply_rope(q, pos, theta), apply_rope(k, pos, theta)
    v = v.reshape(B, S, Hkv, hdv)

    if mode == "prefill":
        out = flash_attention(q, k, v, causal=True, window=window,
                              softcap=cfg.attn_softcap, impl=impl,
                              segments=segments)
        if segments is not None:
            # packed ragged prefill: raw per-token cache; the serving
            # engine scatters each segment into its KV slot
            new_cache = {"k": k, "v": v, "pos": torch.where(segments >= 0, pos, -1)}
        elif kind == "local":
            kc, vc, pc = _ring_fill(k, v, min(cfg.window, max(kv_cap, S)),
                                    S if length is None else length)
            new_cache = {"k": kc, "v": vc, "pos": pc}
        else:
            cap = max(kv_cap, S)
            new_cache = {"k": _pad_cache(k, cap), "v": _pad_cache(v, cap),
                         "pos": _pad_pos(pos, cap)}
        if kv_bits:
            # the engine's quantised pool takes these rows as codes + scales
            # (empty entries quantise to zeros)
            new_cache = quantize_kv_cache(new_cache, kv_bits)
    else:
        quant = "k_q" in cache
        bits = kv_cache_bits(cache, hd) if quant else 0
        qkw = {}
        if mode == "chunk":
            # attend to the PRE-write cache plus the in-stream chunk: the
            # chunk write may evict ring entries that early chunk queries
            # still need, and cache positions are all < the chunk's.  The
            # concatenation is a copy, taken before the in-place commit; a
            # quantised pool is dequantised for it (the chunk attends at fp)
            if quant:
                ck = dequantize_kv(cache["k_q"], cache["k_s"], bits)
                cv = dequantize_kv(cache["v_q"], cache["v_s"], bits)
            else:
                ck, cv = cache["k"], cache["v"]
            kc = torch.cat([ck.to(dt), k], dim=1)
            vc = torch.cat([cv.to(dt), v], dim=1)
            kv_pos = torch.cat([cache["pos"], pos], dim=1)
        new_cache = _commit_kv(cache, k, v, pos)
        if mode == "decode" and quant:
            # codes and scales go to the kernel route, dequantised inside it
            kc, vc, kv_pos = new_cache["k_q"], new_cache["v_q"], new_cache["pos"]
            qkw = dict(k_scale=new_cache["k_s"], v_scale=new_cache["v_s"], kv_bits=bits)
        elif mode == "decode":
            kc, vc, kv_pos = new_cache["k"], new_cache["v"], new_cache["pos"]
        out = flash_attention(
            q, kc, vc, q_pos=pos, kv_pos=kv_pos, kv_valid=kv_pos >= 0,
            causal=True, window=window, softcap=cfg.attn_softcap, impl=impl, **qkw)

    out = qdense(out.reshape(B, S, Hq * hdv), p["wo"], dt, impl=impl)
    return out, new_cache
