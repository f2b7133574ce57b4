"""Model assembly: grouped layer stacks, embeddings and the serving entry points
(counterpart of the reference's ``models/transformer.py``).

The parameters are an ``nn.Module`` (:class:`Transformer`) whose names
follow the reference's parameter tree: ``embed.tok``,
``stack.<group>.u<i>.attn.wq``, ``final_norm.scale``...  Each group's
leaves keep the reference's leading ``(repeats, ...)`` axis and every
weight its ``(K, N)`` layout, used as ``x @ W`` (no ``nn.Linear``).  Where
the reference scans a group, the port loops over its repeats in Python.
A quantised weight (a leaf of the tree that
:func:`repro_torch.quant.core.quantize_params` returns) sits in the module
as a :class:`QuantWeight`, whose code and scale planes are
buffers: ``stack.<group>.u<i>.attn.wq.q`` and ``...wq.scale``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models import modules as M
from repro_torch.models.attention import (apply_attention, init_attention,
                                          init_kv_cache)
from repro_torch.quant.core import QuantTensor
from repro_torch.quant.ops import qdense


# ---------------------------------------------------------------------------
# group derivation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GroupSpec:
    units: tuple[str, ...]   # layer kind of each unit of one pattern period
    repeats: int


def build_groups(cfg: ModelConfig) -> list[GroupSpec]:
    """One group per maximal run of identical pattern periods, plus a
    remainder group — the reference's grouping, so group and unit indices
    (and hence parameter names) match."""
    units = cfg.layer_kinds
    period = len(cfg.pattern)
    n = len(units)
    groups: list[GroupSpec] = []
    full = n // period
    periods = [units[i * period:(i + 1) * period] for i in range(full)]
    i = 0
    while i < len(periods):
        j = i
        while j < len(periods) and periods[j] == periods[i]:
            j += 1
        groups.append(GroupSpec(periods[i], j - i))
        i = j
    rem = units[full * period:]
    if rem:
        groups.append(GroupSpec(rem, 1))
    return groups


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class QuantWeight(nn.Module):
    """A :class:`QuantTensor` held by the parameter module: its code and
    scale planes are buffers (not parameters), ``bits``/``group`` plain
    attributes."""

    def __init__(self, qt: QuantTensor):
        super().__init__()
        self.register_buffer("q", qt.q)
        self.register_buffer("scale", qt.scale)
        self.bits, self.group = qt.bits, qt.group

    def tensor(self) -> QuantTensor:
        return QuantTensor(self.q, self.scale, self.bits, self.group)


def _as_module(tree):
    """Nested dict/list of tensors and QuantTensors -> ModuleDict/ModuleList/
    ParameterDict with the same keys (frozen parameters: the port serves,
    it does not train).  A ParameterDict holds a QuantWeight beside the
    tensors of its dict (``wq`` beside ``bq``)."""
    if isinstance(tree, list):
        return nn.ModuleList([_as_module(t) for t in tree])
    if all(isinstance(t, (torch.Tensor, QuantTensor)) for t in tree.values()):
        return nn.ParameterDict({
            k: QuantWeight(t) if isinstance(t, QuantTensor)
            else nn.Parameter(t, requires_grad=False) for k, t in tree.items()})
    return nn.ModuleDict({k: _as_module(t) for k, t in tree.items()})


class Transformer(nn.ModuleDict):
    """The parameters of one model, indexed like the reference's tree:
    ``params["stack"][g]["u0"]["attn"]["wq"]``.  A tensor at the top of
    the tree (the untied ``lm_head``) is a parameter of the module itself,
    a quantised one a :class:`QuantWeight`, both under their own name."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__({k: _as_module(t) for k, t in tree.items()
                          if isinstance(t, (dict, list))})
        for k, t in tree.items():
            if isinstance(t, QuantTensor):
                self[k] = QuantWeight(t)
            elif isinstance(t, torch.Tensor):
                self.register_parameter(k, nn.Parameter(t, requires_grad=False))
        self.cfg = cfg

    def __getitem__(self, key):
        if key in self._parameters:
            return self._parameters[key]
        return super().__getitem__(key)

    def items(self):
        return [*super().items(), *self._parameters.items()]


def init_params(cfg: ModelConfig, generator: torch.Generator | None, *,
                device=None, dtype=torch.bfloat16) -> Transformer:
    """Random parameters with the reference's distributions, drawn with
    ``generator`` (on the generator's device) and stored on ``device``.
    Weights and the embedding are stored in ``dtype``; biases and norm
    scales in f32, cast at use.  ``generator=None`` with ``device="meta"``
    builds only the names and shapes."""
    device = resolve_device(device)
    if generator is None and device.type != "meta":
        raise ValueError("init_params draws with an explicit torch.Generator")
    tree = {"embed": {"tok": M.embed_init(
        generator, (cfg.vocab_size, cfg.d_model), dtype, device)}}
    stack = []
    for spec in build_groups(cfg):
        blk = {}
        for ui in range(len(spec.units)):
            layer = {"ln1": M.init_norm((spec.repeats, cfg.d_model), device),
                     "attn": init_attention(generator, cfg, repeats=spec.repeats,
                                            dtype=dtype, device=device),
                     "ln2": M.init_norm((spec.repeats, cfg.d_model), device),
                     "mlp": M.init_mlp(generator, cfg, repeats=spec.repeats,
                                       dtype=dtype, device=device)}
            if cfg.post_norm:
                for name in ("ln1_post", "ln2_post"):
                    layer[name] = M.init_norm((spec.repeats, cfg.d_model), device)
            blk[f"u{ui}"] = layer
        stack.append(blk)
    tree["stack"] = stack
    tree["final_norm"] = M.init_norm((cfg.d_model,), device)
    if not cfg.tie_embeddings:
        tree["lm_head"] = M.dense_init(generator, (cfg.d_model, cfg.vocab_size), dtype,
                                       device)
    return Transformer(cfg, tree)


def _layer(tree, r: int):
    """Views of repeat ``r`` of a group's stacked leaves (or pool); a
    quantised weight gives its codes and scales of repeat ``r`` together."""
    if isinstance(tree, torch.Tensor):
        return tree[r]
    if isinstance(tree, QuantWeight):
        return tree.tensor()[r]
    return {k: _layer(t, r) for k, t in tree.items()}


# ---------------------------------------------------------------------------
# stack runner
# ---------------------------------------------------------------------------

def _apply_layer(p, x, *, cfg, kind, mode, pos, cache, impl, segments, kv_bits,
                 kv_cap, length):
    h = M.rmsnorm(x, p["ln1"]["scale"])
    out, c = apply_attention(p["attn"], h, cfg=cfg, kind=kind, mode=mode,
                             pos=pos, cache=None if cache is None else cache["attn"],
                             impl=impl, segments=segments, kv_bits=kv_bits,
                             kv_cap=kv_cap, length=length)
    if cfg.post_norm:
        out = M.rmsnorm(out, p["ln1_post"]["scale"])
    x = x + out
    h = M.rmsnorm(x, p["ln2"]["scale"])
    ff = M.apply_mlp(p["mlp"], h, cfg, impl=impl)
    if cfg.post_norm:
        ff = M.rmsnorm(ff, p["ln2_post"]["scale"])
    x = x + ff
    return x, {"attn": c}


def run_stack(stack, x, *, cfg, groups, mode, pos, caches=None,
              impl="flash", segments=None, kv_bits=0, kv_cap=0, length=None):
    """Run every layer.  ``prefill`` returns the per-layer caches stacked
    as ``(repeats, ...)`` per group (quantised with ``kv_bits``): raw
    per-token with ``segments``, else exact at ``length`` with ``kv_cap``
    entries (a ring for local layers); ``chunk``/``decode`` update the pool
    ``caches`` in place and return them."""
    new_caches = []
    for gi, spec in enumerate(groups):
        gp = stack[gi]
        gc = None if caches is None else caches[gi]
        outs = []
        for r in range(spec.repeats):
            p_blk = _layer(gp, r)
            c_blk = None if gc is None else _layer(gc, r)
            c_out = {}
            for ui, kind in enumerate(spec.units):
                x, c_out[f"u{ui}"] = _apply_layer(
                    p_blk[f"u{ui}"], x, cfg=cfg, kind=kind, mode=mode, pos=pos,
                    cache=None if c_blk is None else c_blk[f"u{ui}"],
                    impl=impl, segments=segments, kv_bits=kv_bits, kv_cap=kv_cap,
                    length=length)
            outs.append(c_out)
        new_caches.append(gc if gc is not None else _stack_trees(outs))
    return x, new_caches


def _stack_trees(trees):
    if isinstance(trees[0], torch.Tensor):
        return torch.stack(trees)
    return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------

def round_to(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` (bf16, f16 or f32) to nearest even, in
    plain Python: no tensor, so no read of one by the host."""
    f32 = np.float32(x)
    if dtype == torch.bfloat16:
        bits = int(f32.view(np.uint32))
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16 << 16
        return float(np.uint32(bits).view(np.float32))
    return float(np.float16(x)) if dtype == torch.float16 else float(f32)


def embed_tokens(params, cfg, tokens, dtype):
    """The embedding rows in ``dtype``; with ``embed_scale``, times
    sqrt(d_model) rounded to ``dtype`` first, as the reference multiplies
    (59.75 in bf16 at d_model 3584)."""
    h = params["embed"]["tok"][tokens].to(dtype)
    if cfg.embed_scale:
        h = h * round_to(math.sqrt(cfg.d_model), dtype)
    return h


def unembed(params, cfg, h, impl="flash"):
    """Logits from the tied embedding table or the untied ``lm_head`` (a
    projection like any other: ``weight_bits`` quantises it), then the
    final softcap: tanh in f32, rounded to the logits' dtype, then
    scaled."""
    if cfg.tie_embeddings:
        logits = h @ params["embed"]["tok"].to(h.dtype).T
    else:
        w = params["lm_head"]
        logits = qdense(h, w.tensor() if isinstance(w, QuantWeight) else w, h.dtype,
                        impl=impl)
    if cfg.final_softcap:
        cap = cfg.final_softcap
        logits = cap * torch.tanh(logits.float() / cap).to(logits.dtype)
    return logits


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def prefill(params, cfg: ModelConfig, tokens, *, impl="flash",
            compute_dtype=torch.bfloat16, kv_cap: int = 0, length=None,
            kv_bits: int = 0):
    """One right-padded prompt a row: ``tokens`` (B, S) at positions
    ``arange(S)``, ``length`` (an int, default S) of them real.  Returns
    (logits (B, V) at position ``length - 1``, cache): per group the
    layers' caches, exact at ``length`` with ``kv_cap`` entries (at least
    S; a ring of ``min(window, kv_cap)`` for local layers), quantised with
    ``kv_bits``.  Causal masking makes attention exact under the pads."""
    B, S = tokens.shape
    length = S if length is None else length
    pos = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    h = embed_tokens(params, cfg, tokens, compute_dtype)
    h, caches = run_stack(params["stack"], h, cfg=cfg, groups=build_groups(cfg),
                          mode="prefill", pos=pos, impl=impl, kv_bits=kv_bits,
                          kv_cap=kv_cap, length=length)
    h = M.rmsnorm(h, params["final_norm"]["scale"])
    logits = unembed(params, cfg, h[:, length - 1:length], impl)[:, 0]
    return logits, {"stack": caches}


def prefill_packed(params, cfg: ModelConfig, tokens, positions, segments,
                   gather_idx, *, impl="flash", compute_dtype=torch.bfloat16,
                   kv_bits: int = 0):
    """Packed ragged prefill: several prompts in one ``(1, C)`` stream.

    ``positions`` are within-prompt positions (RoPE), ``segments`` per-token
    prompt ids (-1 = pad) — a query never attends across a prompt
    boundary.  ``gather_idx`` (n_seg,) picks the packed index of each
    prompt's last token; returns (logits (n_seg, V), raw per-token cache) —
    cache leaves keep the packed stream layout (k/v, or with ``kv_bits`` the
    code and scale planes, and pos), the caller scatters segments into KV
    slots."""
    h = embed_tokens(params, cfg, tokens, compute_dtype)
    h, caches = run_stack(params["stack"], h, cfg=cfg, groups=build_groups(cfg),
                          mode="prefill", pos=positions, impl=impl,
                          segments=segments, kv_bits=kv_bits)
    h = M.rmsnorm(h, params["final_norm"]["scale"])
    last = h[0][gather_idx][:, None]                    # (n_seg, 1, D)
    logits = unembed(params, cfg, last, impl)[:, 0]
    return logits, {"stack": caches}


def chunk_prefill_step(params, cfg: ModelConfig, cache, tokens, pos, take_idx,
                       *, impl="flash", compute_dtype=torch.bfloat16):
    """One chunked-prefill continuation step over the slot pool.

    ``tokens`` (B, C): next chunk per row (right-padded); ``pos`` (B, C):
    absolute positions, -1 = pad / inactive row; ``take_idx`` (B,): index
    of each row's last real chunk token.  The chunk's K/V is written into
    each row's cache in place, and the chunk attends to the whole cache.
    Returns (logits (B, V) at take_idx, cache)."""
    h = embed_tokens(params, cfg, tokens, compute_dtype)
    h, caches = run_stack(params["stack"], h, cfg=cfg, groups=build_groups(cfg),
                          mode="chunk", pos=pos, caches=cache["stack"], impl=impl)
    h = M.rmsnorm(h, params["final_norm"]["scale"])
    idx = take_idx.long()[:, None, None].expand(-1, 1, h.shape[-1])
    last = torch.gather(h, 1, idx)                      # (B, 1, D)
    logits = unembed(params, cfg, last, impl)[:, 0]
    return logits, {"stack": caches}


def decode_step(params, cfg: ModelConfig, cache, tokens, pos, *, impl="flash",
                compute_dtype=torch.bfloat16):
    """One decode step.  tokens (B,), pos (B,) -> (logits (B, V), cache);
    the cache is updated in place."""
    pos2 = pos[:, None]
    h = embed_tokens(params, cfg, tokens[:, None], compute_dtype)
    h, caches = run_stack(params["stack"], h, cfg=cfg, groups=build_groups(cfg),
                          mode="decode", pos=pos2, caches=cache["stack"], impl=impl)
    h = M.rmsnorm(h, params["final_norm"]["scale"])
    logits = unembed(params, cfg, h, impl)[:, 0]
    return logits, {"stack": caches}


# ---------------------------------------------------------------------------
# cache init (serving engine)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, kv_len: int, *,
               dtype=torch.bfloat16, device=None, kv_bits: int = 0):
    """The slot pool: per group, per unit, ``{"attn": {"k", "v", "pos"}}``
    leaves (with ``kv_bits`` 8/4: ``{"k_q", "k_s", "v_q", "v_s", "pos"}``)
    with a leading ``repeats`` axis."""
    device = resolve_device(device)
    caches = []
    for spec in build_groups(cfg):
        blk = {}
        for ui, kind in enumerate(spec.units):
            one = init_kv_cache(cfg, kind, batch, kv_len, dtype, device,
                                kv_bits=kv_bits)
            blk[f"u{ui}"] = {"attn": {
                k: t[None].repeat((spec.repeats,) + (1,) * t.dim())
                for k, t in one.items()}}
        caches.append(blk)
    return {"stack": caches}
