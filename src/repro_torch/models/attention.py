"""Attention layers: MHA/GQA/MQA with global or local (sliding-window,
ring-buffer cache) attention, cross-attention to a fixed source, and
DeepSeek's multi-head latent attention (MLA) (counterpart of the
reference's ``models/attention.py``).

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
  dead slot, dropped), attending to the post-write cache;
- ``mode="encode"`` — an encoder's cache-free forward, without a causal
  mask.

Training (``mode="train"``) is the cache-free causal forward, the
reference's train mode; an encoder's layers train in ``encode``.  Both go
through autograd with ``impl="ref"``, as the reference trains on its
attention oracle: the CUDA kernels have no backward.

Cross-attention (:func:`apply_cross_attention`, ``kind="cross"``) reads
keys and values projected from a source (an encoder's output, or patch
embeddings): its cache is ``{"k", "v"}`` in the compute dtype at every
``kv_bits`` with no ``pos``, written by prefill and only read after.

MLA (:func:`apply_mla`) caches one compressed latent a token, ``ckv``
(``kv_lora_rank`` wide) and its RoPE key ``kr`` (``rope_head_dim``),
shared by every head, in the compute dtype whatever ``kv_bits`` (the
reference's documented exception).  Prefill expands the latents into
per-head K/V and runs the prefill kernel (q/k head dim ``head_dim +
rope_head_dim``, v ``v_head_dim``); decode and chunk run the absorbed
path in latent space, plain PyTorch as the reference's is plain jnp.

The reference's functional cache update becomes an **in-place** update
of the pool tensors here: ``chunk``/``decode`` write into ``cache`` and
return it, with fixed shapes and no read of device data by the host, so
that the serving engine can capture them in a CUDA graph.

Under a plan (:mod:`repro_torch.parallel`) q, k and v are constrained to
the reference's roles (``act_heads``, ``kv_heads``), the projections of
prefill gather their weights (``weight_full``), and a write into a
sharded pool runs on each rank's own slots and heads (:func:`_planned`):
DTensor has no sharding rule for an indexed write.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.common import NEG_INF
from repro_torch.kernels.flash_attention.ops import attention as flash_attention
from repro_torch.models.modules import apply_rope, dense_init, rmsnorm
from repro_torch.parallel.api import (constrain, current_plan, even, is_dtensor, local_views,
                                      mesh_shape, placements, planned_mesh,
                                      region_placements, shard_index, sharded_over,
                                      to_placements)
from repro_torch.quant.core import (dequantize_kv, kv_cache_bits, quantize_kv,
                                    quantize_kv_cache)
from repro_torch.quant.ops import qdense


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_attention(generator, cfg, *, repeats, dtype, device, cross: bool = False):
    """q/k/v/o projections, with the biases of ``qkv_bias`` and the
    per-head q/k norms of ``qk_norm``; a cross projection (``cross``)
    takes no q/k norm, as the reference's."""
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
    if cfg.qk_norm and not cross:
        # (scale - 1) of the per-head rms norms of q and k, as the reference's
        p["q_norm"] = torch.zeros((R, hd), **f32)
        p["k_norm"] = torch.zeros((R, hd), **f32)
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((R, Hq * hd), **f32)
        p["bk"] = torch.zeros((R, Hkv * hd), **f32)
        p["bv"] = torch.zeros((R, Hkv * hdv), **f32)
    return p


def init_mla(generator, cfg, *, repeats, dtype, device):
    """The MLA projections, drawn as the reference draws them: the KV
    down-projection ``wkv_a`` (latent and RoPE key), its norm, the
    up-projection ``wkv_b`` (kvr, H, dn + dv) to per-head no-RoPE keys and
    values, ``wo``, and the query: with ``q_lora_rank`` its low-rank pair
    ``wq_a``/``q_norm``/``wq_b`` (qr, H, dn + dr), else the full-rank
    ``wq`` (D, H, dn + dr), drawn as the reference draws it (fan-in H).
    Norm vectors are f32 (scale - 1)."""
    D, H, R = cfg.d_model, cfg.n_heads, repeats
    dn, dr, dv = cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    f32 = dict(dtype=torch.float32, device=device)
    p = {
        "wkv_a": dense_init(generator, (R, D, kvr + dr), dtype, device),
        "kv_norm": torch.zeros((R, kvr), **f32),
        "wkv_b": dense_init(generator, (R, kvr, H, dn + dv), dtype, device, fan_in=kvr),
        "wo": dense_init(generator, (R, H * dv, D), dtype, device, fan_in=H * dv),
    }
    if not qr:
        p["wq"] = dense_init(generator, (R, D, H, dn + dr), dtype, device)
        return p
    p["wq_a"] = dense_init(generator, (R, D, qr), dtype, device)
    p["q_norm"] = torch.zeros((R, qr), **f32)
    p["wq_b"] = dense_init(generator, (R, qr, H, dn + dr), dtype, device, fan_in=qr)
    return p


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

def init_kv_cache(cfg, kind: str, batch: int, kv_len: int, dtype, device,
                  kv_bits: int = 0, n_cross: int = 0):
    """``kv_bits`` 0 keeps the fp pool; 8/4 allocate the quantised pool.
    An MLA stack's pool is its latents ``ckv``/``kr`` in ``dtype`` and
    ``pos``, at every ``kv_bits``.  A cross cache (``kind="cross"``) is the
    source's keys and values, ``n_cross`` entries in ``dtype`` at every
    ``kv_bits`` and no ``pos`` (every entry valid), as the reference's."""
    Hkv, hd, hdv = cfg.n_kv_heads, cfg.head_dim, cfg.v_head_dim
    if kind == "cross":
        return {"k": torch.zeros((batch, n_cross, Hkv, hd), dtype=dtype, device=device),
                "v": torch.zeros((batch, n_cross, Hkv, hdv), dtype=dtype, device=device)}
    if cfg.is_mla:
        return {
            "ckv": torch.zeros((batch, kv_len, cfg.kv_lora_rank), dtype=dtype, device=device),
            "kr": torch.zeros((batch, kv_len, cfg.rope_head_dim), dtype=dtype, device=device),
            "pos": torch.full((batch, kv_len), -1, dtype=torch.int32, device=device),
        }
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


def _ring_write(cache, new_leaves: dict, pos, span=None):
    """Write S tokens at per-(row, token) ``pos`` into the cache in place
    (ring for local, direct for global).  ``new_leaves`` maps cache leaf
    names to the (B, S, ...) values to commit: k/v, or the code and scale
    planes.  ``pos < 0`` entries are dropped:
    dead pool slots and chunk pads never touch the cache.  Within one call
    only the last ``cap`` positions of a row survive the ring, so those are
    the only ones written (each row's targets stay unique).  ``span``
    (cap, {leaf: its first entry}): ``cache`` holds a rank's slice of a
    pool of ``cap`` entries split along them (:func:`_planned`), and a
    leaf takes only the writes that land in its slice."""
    if _planned(_ring_write, cache, new_leaves, pos) is not None:
        return cache
    cap = cache["pos"].shape[1] if span is None else span[0]
    first = {} if span is None else span[1]
    B, S = pos.shape
    row_max = torch.where(pos >= 0, pos, -1).amax(dim=1, keepdim=True)
    valid = (pos >= 0) & (pos > row_max - cap)
    slot = torch.remainder(pos, cap)
    leaves = dict(new_leaves, pos=pos)
    targets = {}                          # (first entry, entries) -> where its leaves write

    def where(pool, f):
        n = pool.shape[1]
        if (f, n) not in targets:
            ok, loc = valid, slot
            if (f, n) != (0, cap):        # a slice: the writes that land in it
                loc = slot - f
                ok = valid & (loc >= 0) & (loc < n)
            if S == 1:
                # decode, the hot path, in fewer launches: one target per
                # row, so a row without a valid write rewrites what its
                # target holds
                targets[f, n] = (ok[:, 0], torch.where(ok[:, 0], loc[:, 0], 0))
            else:
                row = torch.arange(B, device=pos.device)[:, None]
                targets[f, n] = unique_targets((row * n + loc).reshape(-1), ok.reshape(-1),
                                               B * n)
        return targets[f, n]
    bidx = torch.arange(B, device=pos.device) if S == 1 else None
    for name, leaf in leaves.items():
        pool = cache[name]
        t = where(pool, first.get(name, 0))
        if S == 1:
            keep = t[0].reshape((B,) + (1,) * (pool.dim() - 2))
            pool[bidx, t[1]] = torch.where(keep, leaf[:, 0].to(pool.dtype), pool[bidx, t[1]])
        else:
            put_unique(pool, *t, leaf.reshape((B * S,) + tuple(leaf.shape[2:])))
    return cache


# pool leaves whose axis 2 is the KV head
HEAD_LEAVES = ("k", "v", "k_q", "v_q", "k_s", "v_s")


def _planned(write, cache, values: dict, pos):
    """``write(cache, values, pos, span)`` on each rank's local shards of a
    sharded pool: its slots (axis 0 of a layer's leaves), its KV heads
    (axis 2 of K/V leaves) where the pool shards them, and its entries
    (axis 1) where the pool splits them along the sequence, with the
    values and positions cut to the same slots and heads: a rank writes
    only the entries it holds (``span``), so a sequence-split pool is never
    gathered.  A pool split otherwise is written through a gathered copy
    (:func:`local_views`).  None when the pool is not a DTensor."""
    mesh = planned_mesh("cache write", *cache.values())
    if mesh is None:
        return None
    batch = sharded_over(cache["pos"].placements, 0)
    heads = next((sharded_over(cache[n].placements, 2) for n in HEAD_LEAVES if n in cache), [])
    entries = {n: [i for i in sharded_over(even(t.placements, t.shape, mesh), 1)
                   if mesh.size(i) > 1 and i not in batch + heads] for n, t in cache.items()}

    def target(name, split=True):
        dims = {0: batch, 2: heads} if name in HEAD_LEAVES else {0: batch}
        if split and entries[name]:
            dims[1] = entries[name]
        return region_placements(mesh, dims)
    cap = cache["pos"].shape[1]
    first = {n: shard_index(mesh, e) * (cache[n].shape[1] // math.prod(mesh.size(i) for i in e))
             for n, e in entries.items() if e}
    with local_views(mesh, dict(cache), {n: target(n) for n in cache}) as local:
        write(local, {n: to_placements(v, mesh, target(n, False)).to_local()
                      for n, v in values.items()},
              to_placements(pos, mesh, target("pos", False)).to_local(), (cap, first))
    return cache


def _commit_kv(cache, new_k, new_v, pos, span=None):
    """Commit fresh K/V rows into the slot pool (in place): a quantised pool
    quantises them on commit (one scale per (token, head) row), so an fp
    copy of the pool never exists between steps.  ``span`` as
    :func:`_ring_write`'s."""
    if _planned(lambda c, kv, p, sp: _commit_kv(c, kv["k"], kv["v"], p, sp), cache,
                {"k": new_k, "v": new_v}, pos) is not None:
        return cache
    if "k_q" in cache:
        bits = kv_cache_bits(cache, new_k.shape[-1])
        k_q, k_s = quantize_kv(new_k, bits)
        v_q, v_s = quantize_kv(new_v, bits)
        return _ring_write(cache, {"k_q": k_q, "k_s": k_s, "v_q": v_q, "v_s": v_s}, pos, span)
    return _ring_write(cache, {"k": new_k, "v": new_v}, pos, span)


def _heads(x, n: int, d: int, role: str):
    """A flat projection (B, S, n * d) as heads (B, S, n, d).  DTensor
    splits a dim sharded over a mesh axis only into factors the axis
    divides (XLA reshards instead): where ``n`` does not divide the
    ``model`` axis, the projection (its last dim split over ``model`` by
    the weight) is brought to ``role``'s placement first, the head dim's
    entry left out; the plan keeps such heads whole on every rank.
    Elsewhere, and with no plan, the view is a plain ``reshape``."""
    B, S = x.shape[:2]
    plan = current_plan()
    if is_dtensor(x) and plan is not None and n % mesh_shape(plan.mesh).get("model", 1):
        spec = plan.spec(role)
        spec = (None, None, None) if spec is None else spec[:3]
        x = to_placements(x, plan.mesh, even(placements(spec, plan.mesh), x.shape, plan.mesh))
    return x.reshape(B, S, n, d)


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def apply_cross_attention(p, x, *, cfg, mode: str, cache=None, cross_src=None,
                          impl: str = "flash"):
    """Attention of x (B, S, D) to a source held fixed for the request.
    ``train``/``prefill``/``encode``: K and V projected from ``cross_src``
    (B, S_src, D), with the biases, and attended without a causal mask
    through the prefill kernel (Sq != Skv); prefill returns them as the
    cache ``{"k", "v"}``.  ``decode``/``chunk``: the cache is read and never written,
    through the decode route with every query at position ``Skv`` over
    entries ``arange(Skv)`` -- the reference's way to say "non-causal" to a
    causal decode kernel.  Returns (out (B, S, D), cache)."""
    B, S, _ = x.shape
    Hq, Hkv, hd, hdv = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.v_head_dim
    dt = x.dtype
    q = qdense(x, p["wq"], dt, "weight_full", impl=impl)
    if "bq" in p:
        q = q + p["bq"].to(dt)
    q = constrain(_heads(q, Hq, hd, "act_heads"), "act_heads")
    if mode in ("decode", "chunk"):
        k, v = cache["k"], cache["v"]
        Skv = k.shape[1]
        kv_pos = torch.arange(Skv, dtype=torch.int32, device=x.device).expand(B, Skv)
        q_pos = torch.full((B, S), Skv, dtype=torch.int32, device=x.device)
        out = flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, causal=True,
                              softcap=cfg.attn_softcap, impl=impl)
        new_cache = cache
    else:
        src = cross_src.to(dt)
        k = qdense(src, p["wk"], dt, impl=impl)
        v = qdense(src, p["wv"], dt, impl=impl)
        if "bk" in p:
            k = k + p["bk"].to(dt)
            v = v + p["bv"].to(dt)
        k, v = _heads(k, Hkv, hd, "kv_heads"), _heads(v, Hkv, hdv, "kv_heads")
        out = flash_attention(q, k, v, causal=False, softcap=cfg.attn_softcap, impl=impl)
        new_cache = {"k": k, "v": v} if mode == "prefill" else None
    return qdense(out.reshape(B, S, Hq * hdv), p["wo"], dt, impl=impl), new_cache


def apply_attention(p, x, *, cfg, kind: str, mode: str, pos, cache=None,
                    impl: str = "flash", segments=None, kv_bits: int = 0,
                    kv_cap: int = 0, length=None):
    """x (B, S, D); pos (B, S) int32 (decode: (B, 1); chunk: -1 = pad).
    Prefill: ``kv_bits`` returns a quantised cache; without ``segments``,
    ``kv_cap`` is the cache's capacity (at least S) and ``length`` the
    prompt's true length (default S).  ``train`` (causal) and ``encode``
    (an encoder's, without a causal mask) are the cache-free forwards; they
    return no cache.  Returns (out (B, S, D), cache)."""
    if mode not in ("train", "prefill", "chunk", "decode", "encode"):
        raise ValueError(f"unknown attention mode {mode!r}")
    if kind not in ("global", "local"):
        raise ValueError(f"apply_attention runs global and local layers, not {kind!r} "
                         f"(cross: apply_cross_attention)")
    B, S, D = x.shape
    Hq, Hkv, hd, hdv = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.v_head_dim
    dt = x.dtype
    window = cfg.window if kind == "local" else 0
    theta = cfg.rope_theta_local if (kind == "local" and cfg.rope_theta_local) \
        else cfg.rope_theta

    q = qdense(x, p["wq"], dt, "weight_full", impl=impl)
    k = qdense(x, p["wk"], dt, "weight_full", impl=impl)
    v = qdense(x, p["wv"], dt, "weight_full", impl=impl)
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q, k = _heads(q, Hq, hd, "act_heads"), _heads(k, Hkv, hd, "kv_heads")
    if cfg.qk_norm:
        q, k = rmsnorm(q, p["q_norm"]), rmsnorm(k, p["k_norm"])
    if cfg.use_rope:
        q, k = apply_rope(q, pos, theta), apply_rope(k, pos, theta)
    v = _heads(v, Hkv, hdv, "kv_heads")
    q, k, v = constrain(q, "act_heads"), constrain(k, "kv_heads"), constrain(v, "kv_heads")

    if mode in ("train", "encode"):
        out = flash_attention(q, k, v, causal=mode == "train", window=window,
                              softcap=cfg.attn_softcap, impl=impl)
        new_cache = None
    elif mode == "prefill":
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

    out = qdense(out.reshape(B, S, Hq * hdv), p["wo"], dt, "weight_full", impl=impl)
    return out, new_cache


# ---------------------------------------------------------------------------
# apply — MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------

def _mla_q(p, x, pos, cfg):
    """(q_nope (B, S, H, dn), q_rope (B, S, H, dr)): the low-rank query
    (normed latent, then per-head up-projection), or the full-rank one
    (``wq`` (D, H, dn + dr)), RoPE on its last dims."""
    dt = x.dtype
    H, dn, dr = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
    if "wq_a" in p:
        x = rmsnorm(qdense(x, p["wq_a"], dt), p["q_norm"])
        w = p["wq_b"].to(dt)
    else:
        w = p["wq"].to(dt)
    q = _heads(qdense(x, w.reshape(w.shape[0], -1)), H, dn + dr, "act_heads")
    return q[..., :dn], apply_rope(q[..., dn:], pos, cfg.rope_theta)


def _mla_kv_latent(p, x, pos, cfg):
    """(ckv (B, S, kvr) normed, kr (B, S, dr) with RoPE): what the cache
    holds of a token."""
    kvr = cfg.kv_lora_rank
    ckv_full = qdense(x, p["wkv_a"], x.dtype)
    ckv = rmsnorm(ckv_full[..., :kvr], p["kv_norm"])
    kr = apply_rope(ckv_full[..., None, kvr:], pos, cfg.rope_theta)[:, :, 0]
    return ckv, kr


def apply_mla(p, x, *, cfg, mode: str, pos, cache=None, impl: str = "flash",
              segments=None, kv_cap: int = 0):
    """MLA self-attention.  ``train``: the expanded path without a cache
    (the reference's naive train path).  ``prefill``: the expanded path
    through the prefill kernel (packed with ``segments``: the raw
    per-token latents, ``pos`` -1 on pads; else the latents padded to
    ``kv_cap`` entries with the stream's positions, pad rows included, as
    the reference's, which takes no ``length``: the engine's insert
    invalidates them).  ``decode``
    and ``chunk``: the latents written into the pool in place at ``pos``
    (``pos < 0`` or past the pool dropped; slot == position), then the
    absorbed path over the post-write pool: scores in f32 from
    ``q_nope W_uk . ckv + q_rope . kr`` times ``(dn + dr) ** -0.5``, masked
    to the finite ``NEG_INF``, softmax, a row with no valid entry exact
    zeros, the weights cast to the compute dtype for ``w . ckv``, then
    ``W_uv``.  Returns (out (B, S, D), cache)."""
    if mode not in ("train", "prefill", "chunk", "decode"):
        raise ValueError(f"unknown MLA mode {mode!r}")
    B, S, _ = x.shape
    dt = x.dtype
    H, dn, dr, dv = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim
    scale = (dn + dr) ** -0.5
    q_nope, q_rope = _mla_q(p, x, pos, cfg)
    ckv, kr = _mla_kv_latent(p, x, pos, cfg)
    wkv_b = p["wkv_b"].to(dt)                           # (kvr, H, dn + dv)

    if mode in ("train", "prefill"):
        kv = _heads(qdense(ckv, wkv_b.reshape(wkv_b.shape[0], -1)), H, dn + dv, "kv_heads")
        kv = constrain(kv, "kv_heads")
        k = torch.cat([kv[..., :dn], kr[:, :, None].expand(B, S, H, dr)], dim=-1)
        # the value block as rows of its own (the kernel's input, contiguous)
        k, v = constrain(k, "kv_heads"), constrain(kv[..., dn:].contiguous(), "kv_heads")
        q = constrain(torch.cat([q_nope, q_rope], dim=-1), "act_heads")
        out = flash_attention(q, k, v, causal=True, scale=scale, impl=impl,
                              segments=segments)
        if mode == "train":
            new_cache = None
        elif segments is not None:
            new_cache = {"ckv": ckv, "kr": kr, "pos": torch.where(segments >= 0, pos, -1)}
        else:
            cap = max(kv_cap, S)
            new_cache = {"ckv": _pad_cache(ckv, cap), "kr": _pad_cache(kr, cap),
                         "pos": _pad_pos(pos, cap)}
    else:
        cap = cache["ckv"].shape[1]
        # the reference drops a write at pos < 0 or pos >= cap (slot == position)
        new_cache = _ring_write(cache, {"ckv": ckv, "kr": kr},
                                torch.where(pos < cap, pos, -1))
        out = mla_absorbed(q_nope, q_rope, new_cache, pos, wkv_b, scale)

    out = qdense(out.reshape(B, S, H * dv), p["wo"], dt, impl=impl)
    return out, new_cache


def mla_absorbed(q_nope, q_rope, cache, pos, wkv_b, scale: float):
    """The absorbed attention of a decode or chunk step over the latent
    pool ``cache`` (``ckv``, ``kr``, ``pos``): q_nope (B, S, H, dn) and
    q_rope (B, S, H, dr) at positions ``pos`` (B, S), ``wkv_b`` (kvr, H,
    dn + dv) in the compute dtype -> (B, S, H, dv) in q's dtype, before
    ``wo``.  No read of device data by the host."""
    dt, dn = q_nope.dtype, q_nope.shape[-1]
    ckv_all, kr_all, kv_pos = cache["ckv"], cache["kr"], cache["pos"]
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, wkv_b[..., :dn])
    logits = (torch.einsum("bqhr,bkr->bhqk", q_lat.float(), ckv_all.float())
              + torch.einsum("bqhd,bkd->bhqk", q_rope.float(), kr_all.float())) * scale
    mask = (kv_pos[:, None, None, :] <= pos[:, None, :, None]) & \
        (kv_pos >= 0)[:, None, None, :]
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    # a row with no valid entry (a chunk pad, a dead slot) gives zeros
    w = torch.where(mask.any(dim=-1, keepdim=True), w, 0.0).to(dt)
    ctx = torch.einsum("bhqk,bkr->bqhr", w, ckv_all.to(dt))
    return torch.einsum("bqhr,rhd->bqhd", ctx, wkv_b[..., dn:])
