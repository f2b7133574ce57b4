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

Besides the attention layers (``global``, ``local``), a unit may be a
Mamba-2 SSD block (``ssm``: ``{"ln1", "mamba"}``) or an RG-LRU block and
its MLP (``recurrent``: ``{"ln1", "rec", "ln2", "mlp"}``), as in the
reference's tree.  Their caches are ``{"conv", "state"}`` and ``{"conv",
"h"}``, held directly under ``u<i>``; they run prefill (exact at
``length``) and decode, not the packed prefill or the chunk step.  In an
MLA stack (``cfg.is_mla``) every attention unit's ``attn`` holds the
latent projections (``wq_a``, ``q_norm``, ``wq_b``, ``wkv_a``,
``kv_norm``, ``wkv_b``, ``wo``) and its cache ``{"ckv", "kr", "pos"}``.

Cross-attention: an encoder/decoder stack (whisper, bart) holds an
``encoder`` stack and ``encoder_norm`` beside the decoder's, whose layers
each add ``ln_cross``/``cross`` (cache ``{"attn", "cross"}``); the vision
stack's ``cross`` units are gated layers (``gate_attn``, ``gate_mlp``; cache
the bare ``{"k", "v"}``).  Their source goes to :func:`prefill` by keyword
(``frames``, ``encoder_tokens``, ``image_embeds``); :func:`decode_step`
reads the cross caches and never writes them.  These stacks run through
``prefill``/``decode_step`` only: the serving engine refuses them, as the
reference's cannot serve them.

Training: :func:`loss_fn` is the reference's next-token loss (an
encoder's, the MLM proxy) plus the MoE router's aux loss, through autograd
over the plain modules (``impl="ref"``: the CUDA kernels have no
backward), on an f32 master tree (:func:`trainable`) computed in
``compute_dtype``; ``remat`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models import modules as M
from repro_torch.models.attention import (apply_attention, apply_cross_attention,
                                          apply_mla, init_attention, init_kv_cache,
                                          init_mla)
from repro_torch.models.moe import apply_moe, in_combine_product, init_moe, router_aux_loss
from repro_torch.models.rglru import apply_rglru, init_rglru, init_rglru_cache
from repro_torch.models.ssm import apply_mamba, init_mamba, init_ssm_cache
from repro_torch.parallel.api import (constrain, current_plan, even, gather_dim, local_call,
                                      placements, planned_mesh, region_placements, replicated,
                                      shard_index, sharded_over, to_placements)
from repro_torch.quant.core import QuantTensor
from repro_torch.quant.ops import qdense
from repro_torch.tree import tree_map


# ---------------------------------------------------------------------------
# group derivation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GroupSpec:
    units: tuple[tuple[str, bool], ...]   # (layer kind, use_moe) of each unit
    repeats: int


def build_groups(cfg: ModelConfig, *, encoder: bool = False) -> list[GroupSpec]:
    """One group per maximal run of identical pattern periods (a unit is a
    layer kind and whether its FFN is MoE), plus a remainder group — the
    reference's grouping, so group and unit indices (and hence parameter
    names) match.  ``encoder``: the encoder stack's groups (its pattern,
    no MoE)."""
    if encoder:
        kinds, period = cfg.encoder_layer_kinds, len(cfg.encoder_pattern)
        units = tuple((k, False) for k in kinds)
    else:
        units = tuple(zip(cfg.layer_kinds, cfg.moe_layer_mask()))
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
    """Nested dict/list of tensors and QuantTensors -> ModuleList or
    :class:`ParamTree` with the same keys.  The parameters are frozen
    (serving's trees take no gradient); :func:`trainable` gives training
    its tree of them with gradients on."""
    if isinstance(tree, list):
        return nn.ModuleList([_as_module(t) for t in tree])
    return ParamTree(tree)


class ParamTree(nn.ModuleDict):
    """One dict of the parameter tree: its tensors are parameters of the
    module, its QuantTensors :class:`QuantWeight` submodules and its dicts
    and lists submodules, all under their own names, so a dict may mix them
    (the MoE layer's ``router`` beside its ``experts``).  Indexed and
    iterated like the dict."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, t in tree.items():
            if isinstance(t, torch.Tensor):
                self.register_parameter(k, nn.Parameter(t, requires_grad=False))
            else:
                self[k] = QuantWeight(t) if isinstance(t, QuantTensor) else _as_module(t)

    def __getitem__(self, key):
        if key in self._parameters:
            return self._parameters[key]
        return super().__getitem__(key)

    def __contains__(self, key):
        return key in self._parameters or super().__contains__(key)

    def items(self):
        return [*super().items(), *self._parameters.items()]


class Transformer(ParamTree):
    """The parameters of one model, indexed like the reference's tree:
    ``params["stack"][g]["u0"]["attn"]["wq"]``."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg


def param_tree(params):
    """The tensors of a parameter module as the reference's nested tree:
    dicts of the names, lists for the stacks (the same tensor objects, no
    copy).  A dict or list tree is returned as it is."""
    if isinstance(params, nn.ModuleList):
        return [param_tree(m) for m in params]
    if isinstance(params, ParamTree):
        return {k: param_tree(v) for k, v in params.items()}
    if isinstance(params, QuantWeight):
        raise ValueError("a quantised weight has no place in a parameter tree to train")
    return params


def trainable(params):
    """Training's tree: :func:`param_tree` of ``params`` with every leaf
    taking gradients (build it in f32, the master weights:
    ``init_params(..., dtype=torch.float32)`` or ``params_from_jax(...,
    dtype=torch.float32)``)."""
    return tree_map(lambda t: t.requires_grad_(True), param_tree(params))


def _init_stack(generator, cfg, groups, *, causal: bool, dtype, device):
    """The layers of one stack, group by group.  A decoder layer of an
    encoder/decoder stack (``cross_attn_decoder`` and ``causal``) holds
    ``ln_cross`` and ``cross`` between attention and its MLP; a ``cross``
    unit (the vision stack's gated layer) ``ln1``, ``attn`` (a cross
    projection), ``gate_attn``, ``ln2``, ``mlp`` and ``gate_mlp``, the
    gates f32 zeros, as the reference's."""
    stack = []
    for spec in groups:
        blk = {}
        for ui, (kind, use_moe) in enumerate(spec.units):
            norm = functools.partial(M.init_norm, cfg, (spec.repeats, cfg.d_model), device)
            init = dict(repeats=spec.repeats, dtype=dtype, device=device)
            if kind == "ssm":
                blk[f"u{ui}"] = {"ln1": norm(), "mamba": init_mamba(generator, cfg, **init)}
                continue
            if kind == "recurrent":
                blk[f"u{ui}"] = {"ln1": norm(), "rec": init_rglru(generator, cfg, **init),
                                 "ln2": norm(), "mlp": M.init_mlp(generator, cfg, **init)}
                continue
            if kind == "cross":
                gate = functools.partial(torch.zeros, (spec.repeats,), dtype=torch.float32,
                                         device=device)
                blk[f"u{ui}"] = {"ln1": norm(),
                                 "attn": init_attention(generator, cfg, cross=True, **init),
                                 "gate_attn": gate(), "ln2": norm(),
                                 "mlp": M.init_mlp(generator, cfg, **init),
                                 "gate_mlp": gate()}
                continue
            layer = {"ln1": norm(),
                     "attn": (init_mla if cfg.is_mla else init_attention)(generator, cfg,
                                                                          **init)}
            if cfg.parallel_block:
                layer["mlp"] = M.init_mlp(generator, cfg, **init)
                blk[f"u{ui}"] = layer
                continue
            if cfg.cross_attn_decoder and causal:
                layer["ln_cross"] = norm()
                layer["cross"] = init_attention(generator, cfg, cross=True, **init)
            layer["ln2"] = norm()
            layer["moe" if use_moe else "mlp"] = (init_moe if use_moe else M.init_mlp)(
                generator, cfg, **init)
            if cfg.post_norm:
                for name in ("ln1_post", "ln2_post"):
                    layer[name] = norm()
            blk[f"u{ui}"] = layer
        stack.append(blk)
    return stack


def init_params(cfg: ModelConfig, generator: torch.Generator | None, *,
                device=None, dtype=torch.bfloat16) -> Transformer:
    """Random parameters with the reference's distributions, drawn with
    ``generator`` (on the generator's device) and stored on ``device``.
    Weights, the embedding and the position table are stored in ``dtype``;
    biases, norm vectors and the cross layers' gates in f32, cast at use.
    ``generator=None`` with ``device="meta"`` builds only the names and
    shapes.  A parallel block (GPT-J) holds ``ln1``, ``attn`` and ``mlp``
    alone; an ``ssm`` unit ``ln1`` and ``mamba``, a ``recurrent`` one
    ``ln1``, ``rec``, ``ln2`` and ``mlp``.  An encoder/decoder stack adds
    ``encoder`` (its layers) and ``encoder_norm``.  Without RoPE a learned
    position table ``embed.pos``, but for audio (whisper), whose tokens
    take sinusoidal positions, as the reference's."""
    device = resolve_device(device)
    if generator is None and device.type != "meta":
        raise ValueError("init_params draws with an explicit torch.Generator")
    tree = {"embed": {"tok": M.embed_init(
        generator, (cfg.vocab_size, cfg.d_model), dtype, device)}}
    if not cfg.use_rope and cfg.family != "audio" and cfg.max_abs_positions:
        tree["embed"]["pos"] = M.embed_init(
            generator, (cfg.max_abs_positions, cfg.d_model), dtype, device)
    kw = dict(dtype=dtype, device=device)
    tree["stack"] = _init_stack(generator, cfg, build_groups(cfg), causal=True, **kw)
    tree["final_norm"] = M.init_norm(cfg, (cfg.d_model,), device)
    if cfg.n_encoder_layers:
        tree["encoder"] = _init_stack(generator, cfg, build_groups(cfg, encoder=True),
                                      causal=False, **kw)
        tree["encoder_norm"] = M.init_norm(cfg, (cfg.d_model,), device)
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

CACHE_FREE = ("train", "encode")


def _apply_layer(p, x, *, cfg, kind, use_moe, mode, pos, cache, impl, segments,
                 kv_bits, kv_cap, length, cross_src=None):
    """One layer: (x, its cache, its router aux loss).  The aux is 0.0 but
    in a MoE layer in ``train`` mode; the cache is None in the cache-free
    modes (``train``, ``encode``)."""
    if kind == "cross":
        # the vision stack's gated layer: tanh of the f32 gates, cast to x's
        # dtype, on both residuals; its cache is the bare {"k", "v"}
        out, c = apply_cross_attention(p["attn"], M.apply_norm(p["ln1"], x), cfg=cfg,
                                       mode=mode, cache=cache, cross_src=cross_src,
                                       impl=impl)
        x = constrain(x + torch.tanh(p["gate_attn"]).to(x.dtype) * out, "residual")
        ff = M.apply_mlp(p["mlp"], M.apply_norm(p["ln2"], x), cfg, impl=impl)
        return constrain(x + torch.tanh(p["gate_mlp"]).to(x.dtype) * ff, "residual"), c, 0.0
    if kind in ("ssm", "recurrent"):
        h = M.apply_norm(p["ln1"], x)
        if kind == "ssm":
            out, c = apply_mamba(p["mamba"], h, cfg=cfg, mode=mode, cache=cache,
                                 length=length)
            return constrain(x + out, "residual"), c, 0.0
        out, c = apply_rglru(p["rec"], h, cfg=cfg, mode=mode, cache=cache, length=length,
                             impl=impl)
        x = constrain(x + out, "residual")
        ff = M.apply_mlp(p["mlp"], M.apply_norm(p["ln2"], x), cfg, impl=impl)
        return constrain(x + ff, "residual"), c, 0.0
    h = M.apply_norm(p["ln1"], x)
    c_self = None if cache is None else cache["attn"]
    if cfg.is_mla:
        # the latents stay in the compute dtype at every kv_bits, and the
        # prefill's cache keeps the pad rows' positions (no length)
        out, c = apply_mla(p["attn"], h, cfg=cfg, mode=mode, pos=pos, cache=c_self,
                           impl=impl, segments=segments, kv_cap=kv_cap)
    else:
        out, c = apply_attention(p["attn"], h, cfg=cfg, kind=kind, mode=mode,
                                 pos=pos, cache=c_self, impl=impl, segments=segments,
                                 kv_bits=kv_bits, kv_cap=kv_cap, length=length)
    cache_free = mode in CACHE_FREE
    if cfg.parallel_block:
        # GPT-J: attention and the MLP both read ln1's output
        return (constrain(x + out + M.apply_mlp(p["mlp"], h, cfg, impl=impl), "residual"),
                None if cache_free else {"attn": c}, 0.0)
    if cfg.post_norm:
        out = M.apply_norm(p["ln1_post"], out)
    x = constrain(x + out, "residual")
    blk_cache = {"attn": c}
    if "cross" in p:
        # an encoder/decoder stack's decoder layer: cross-attention to the
        # encoder's output between attention and the MLP, cached under "cross"
        out, blk_cache["cross"] = apply_cross_attention(
            p["cross"], M.apply_norm(p["ln_cross"], x), cfg=cfg, mode=mode,
            cache=None if cache is None else cache["cross"], cross_src=cross_src,
            impl=impl)
        x = constrain(x + out, "residual")
    h = M.apply_norm(p["ln2"], x)
    aux = 0.0
    if use_moe:
        ff = apply_moe(p["moe"], h, cfg, mode=mode, impl=impl)
        if mode == "train":
            aux = router_aux_loss(p["moe"], h, cfg)
    else:
        ff = M.apply_mlp(p["mlp"], h, cfg, impl=impl)
    if cfg.post_norm:
        ff = M.apply_norm(p["ln2_post"], ff)
    x = constrain(x + ff, "residual")
    return x, (None if cache_free else blk_cache), aux


def _unstack(tree, repeats: int) -> list:
    """A group's stacked leaves as ``repeats`` trees of per-layer views, by
    one ``unbind`` a leaf: its backward stacks the layers' gradients once,
    where indexing each layer would add a whole-leaf gradient per layer."""
    if isinstance(tree, torch.Tensor):
        return list(torch.unbind(tree, 0))
    if isinstance(tree, QuantWeight):
        return [tree.tensor()[r] for r in range(repeats)]
    per_key = {k: _unstack(t, repeats) for k, t in tree.items()}
    return [{k: v[r] for k, v in per_key.items()} for r in range(repeats)]


def _remat_policy(dots: bool):
    """The remat's selective policy: keep the outputs of a GShard combine
    product (:func:`moe.in_combine_product`: the layer's last product, read
    by no gradient), and with ``dots`` (the ``"dots"`` policy) those of
    matrix products with no batch axis (the reference's
    ``dots_with_no_batch_dims_saveable``); recompute the rest."""
    def policy(ctx, op, *args, **kwargs):
        if (dots and op is torch.ops.aten.mm.default) or \
                (op is torch.ops.aten.bmm.default and in_combine_product()):
            return torch_checkpoint.CheckpointPolicy.MUST_SAVE
        return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def run_stack(stack, x, *, cfg, groups, mode, pos, caches=None,
              impl="flash", segments=None, kv_bits=0, kv_cap=0, length=None,
              cross_src=None, remat=False, remat_policy=None):
    """Run every layer: (x, caches, aux).  ``prefill`` returns the per-layer
    caches stacked as ``(repeats, ...)`` per group (quantised with
    ``kv_bits``): raw per-token with ``segments``, else exact at ``length``
    with ``kv_cap`` entries (a ring for local layers); ``chunk``/``decode``
    update the pool ``caches`` in place and return them (a cross cache is
    read, never written).  ``train`` (causal) and ``encode`` (an encoder,
    without a causal mask) return no caches (None).  ``aux`` is the sum of
    the MoE layers' router aux losses in ``train`` mode, else 0.0.
    ``cross_src`` (B, S_src, D) is what the cross-attention attends to.

    In the cache-free modes ``remat`` runs each layer under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in the backward pass, all but a MoE stack's GShard combine
    products under a plan (:func:`_remat_policy`) and the outputs of plain
    matrix products with ``remat_policy="dots"``.  The numbers are the
    same."""
    cache_free = mode in CACHE_FREE
    new_caches = []
    aux_total = 0.0
    kw = dict(cfg=cfg, mode=mode, pos=pos, impl=impl, segments=segments, kv_bits=kv_bits,
              kv_cap=kv_cap, length=length, cross_src=cross_src)
    for gi, spec in enumerate(groups):
        gp = stack[gi]
        if cache_free:
            def block(x, p_blk, spec=spec):
                aux = 0.0
                for ui, (kind, use_moe) in enumerate(spec.units):
                    x, _, a = _apply_layer(p_blk[f"u{ui}"], x, kind=kind, use_moe=use_moe,
                                           cache=None, **kw)
                    aux = aux + a
                return x, aux
            if remat:
                if remat_policy not in (None, "dots"):
                    raise ValueError(f"unknown remat policy {remat_policy!r}")
                # a MoE stack's GShard combine runs only under a plan
                gshard = cfg.is_moe and current_plan() is not None
                ctx = {} if remat_policy is None and not gshard else dict(
                    context_fn=functools.partial(
                        torch_checkpoint.create_selective_checkpoint_contexts,
                        _remat_policy(remat_policy == "dots")))
                block = functools.partial(torch_checkpoint.checkpoint, block,
                                          use_reentrant=False, **ctx)
            for p_blk in _unstack(gp, spec.repeats):
                x, aux = block(x, p_blk)
                aux_total = aux_total + aux
            continue
        gc = None if caches is None else caches[gi]
        outs = []
        for r in range(spec.repeats):
            p_blk = _layer(gp, r)
            c_blk = None if gc is None else _layer(gc, r)
            c_out = {}
            for ui, (kind, use_moe) in enumerate(spec.units):
                x, c_out[f"u{ui}"], _ = _apply_layer(
                    p_blk[f"u{ui}"], x, kind=kind, use_moe=use_moe,
                    cache=None if c_blk is None else c_blk[f"u{ui}"], **kw)
            outs.append(c_out)
        new_caches.append(gc if gc is not None else _stack_trees(outs))
    return x, (None if cache_free else new_caches), aux_total


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


def take_rows(table, idx):
    """``table[idx]`` with the reference's ``jnp.take`` semantics, and no
    index out of range ever reaching the device: an index in ``[-n, 0)``
    wraps to ``idx + n``, and any other outside ``[0, n)`` gives a row of
    NaN (an out-of-range gather on a card is a device-side assert, which
    inside a captured graph ends the context)."""
    n = table.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    inside = (idx >= 0) & (idx < n)
    return torch.where(inside[..., None], rows_of(table, idx.clamp(0, n - 1)), float("nan"))


def rows_of(table, idx):
    """``table[idx]``.  Under a plan (a DTensor table) each rank gathers
    every row of its own columns (``local_map``: the vocab whole, the
    indices whole), so that no indexed op or its scatter-add backward goes
    through DTensor's sharding rules."""
    mesh = planned_mesh("embedding", table)
    if mesh is None:
        return table[idx]
    cols = sharded_over(table.placements, 1)
    return local_call(lambda t, i: t[i], (table, idx),
                      (region_placements(mesh, {1: cols}), region_placements(mesh, {})),
                      region_placements(mesh, {idx.dim(): cols}), mesh)


def embed_tokens(params, cfg, tokens, pos, dtype):
    """The embedding rows in ``dtype``; with ``embed_scale``, times
    sqrt(d_model) rounded to ``dtype`` first, as the reference multiplies
    (59.75 in bf16 at d_model 3584).  Without RoPE, plus the learned
    position table's rows at ``pos`` (:func:`take_rows`: a position past
    the table gives NaN, and its request fails as the reference's does), or
    where there is no table (mamba2), the reference's sinusoidal
    embedding of ``pos``."""
    h = rows_of(params["embed"]["tok"], tokens).to(dtype)
    if cfg.embed_scale:
        h = h * round_to(math.sqrt(cfg.d_model), dtype)
    if not cfg.use_rope:
        if "pos" in params["embed"]:
            h = h + take_rows(params["embed"]["pos"], pos).to(dtype)
        else:
            h = h + M.sinusoidal_positions(pos, cfg.d_model).to(dtype)
    return constrain(h, "residual")


def unembed(params, cfg, h, impl="flash"):
    """Logits from the tied embedding table or the untied ``lm_head`` (a
    projection like any other: ``weight_bits`` quantises it), then the
    final softcap: tanh in f32, rounded to the logits' dtype, then
    scaled.  Under a plan whose ``logits`` role splits the vocab, an fp
    table comes to each rank as its own vocab columns over the whole of
    ``d_model`` (:func:`_vocab_columns`), so the logits come out split over
    the vocab and no rank forms a whole-vocab partial sum."""
    h = constrain(h, "pre_logits")
    if cfg.tie_embeddings:
        logits = qdense(h, _vocab_columns(params["embed"]["tok"].T, h), h.dtype)
    else:
        w = params["lm_head"]
        w = w.tensor() if isinstance(w, QuantWeight) else w
        logits = qdense(h, w if isinstance(w, QuantTensor) else _vocab_columns(w, h),
                        h.dtype, impl=impl)
    if cfg.final_softcap:
        cap = cfg.final_softcap
        logits = cap * torch.tanh(logits.float() / cap).to(logits.dtype)
    return constrain(logits, "logits")


def _vocab_columns(w, h):
    """The (D, V) table ``w`` with its vocab split over the mesh dims that
    the plan's ``logits`` role splits the vocab on and its ``d_model``
    whole: each rank's own columns (``w`` itself with no plan, or a role
    that keeps the vocab whole).  The vocab shards are cut first, locally,
    so that the gather over ``d_model`` moves only a rank's columns."""
    mesh = planned_mesh("unembed", h, w)
    spec = None if mesh is None else current_plan().spec("logits")
    if spec is None:
        return w
    from torch.distributed.tensor import Replicate, Shard
    cols = [i for i in sharded_over(even(placements(spec, mesh), (*h.shape[:-1], w.shape[-1]),
                                         mesh), 2) if mesh.size(i) > 1]
    if not cols:
        return w
    w = replicated(w, mesh)
    w = to_placements(w, mesh, [Shard(1) if i in cols else p for i, p in enumerate(w.placements)])
    return to_placements(w, mesh, [Shard(1) if i in cols else Replicate()
                                   for i in range(mesh.ndim)])


# ---------------------------------------------------------------------------
# the cross-attention source
# ---------------------------------------------------------------------------

def needs_source(cfg: ModelConfig) -> bool:
    """An encoder/decoder stack or one with cross layers: its prefill takes
    a source (``frames``, ``encoder_tokens`` or ``image_embeds``)."""
    return bool(cfg.n_encoder_layers or cfg.cross_attn_decoder or "cross" in cfg.layer_kinds)


def run_encoder(params, cfg: ModelConfig, *, frames=None, encoder_tokens=None,
                impl="flash", compute_dtype=torch.bfloat16, remat=False, remat_policy=None):
    """The encoder's output (B, S_src, D) after ``encoder_norm``: audio
    (whisper) takes the frame embeddings ``frames`` (B, S_src, D) in the
    compute dtype plus sinusoidal positions; a text encoder (bart) embeds
    ``encoder_tokens`` (B, S_src) with the position table.  Its layers run
    without a causal mask and return no cache (``remat`` as in
    :func:`run_stack`)."""
    if cfg.family == "audio":
        if frames is None:
            raise ValueError(f"{cfg.name}: prefill needs frames= (B, frames, d_model)")
        h = frames.to(compute_dtype)
        B, S = h.shape[:2]
        pos = torch.arange(S, dtype=torch.int32, device=h.device).expand(B, S)
        h = constrain(h + M.sinusoidal_positions(pos, cfg.d_model).to(compute_dtype),
                      "residual")
    else:
        if encoder_tokens is None:
            raise ValueError(f"{cfg.name}: prefill needs encoder_tokens= (B, S_src)")
        B, S = encoder_tokens.shape
        pos = torch.arange(S, dtype=torch.int32, device=encoder_tokens.device).expand(B, S)
        h = embed_tokens(params, cfg, encoder_tokens, pos, compute_dtype)
    h, _, _ = run_stack(params["encoder"], h, cfg=cfg,
                        groups=build_groups(cfg, encoder=True), mode="encode", pos=pos,
                        impl=impl, remat=remat, remat_policy=remat_policy)
    return M.apply_norm(params["encoder_norm"], h)


def cross_source(params, cfg: ModelConfig, *, frames=None, encoder_tokens=None,
                 image_embeds=None, impl="flash", compute_dtype=torch.bfloat16,
                 remat=False, remat_policy=None):
    """What the cross-attention of a prefill attends to: the encoder's
    output (:func:`run_encoder`), the patch embeddings ``image_embeds`` (B,
    n_frontend_tokens, D) of a vision stack in the compute dtype, or None
    for a stack without cross-attention.  A stack that needs a source and
    is given none raises."""
    if cfg.n_encoder_layers:
        return run_encoder(params, cfg, frames=frames, encoder_tokens=encoder_tokens,
                           impl=impl, compute_dtype=compute_dtype, remat=remat,
                           remat_policy=remat_policy)
    if needs_source(cfg):
        if image_embeds is None:
            raise ValueError(f"{cfg.name}: prefill needs image_embeds= "
                             f"(B, n_frontend_tokens, d_model)")
        return image_embeds.to(compute_dtype)
    return None


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def loss_fn(params, cfg: ModelConfig, batch, *, impl="ref", compute_dtype=torch.bfloat16,
            remat=False, remat_policy=None, aux_weight=0.01):
    """The training loss: (loss, {"nll", "aux"}).

    ``batch``: ``tokens`` (B, S) and the source a stack needs (``frames``,
    ``encoder_tokens`` or ``image_embeds``).  A decoder's loss is the mean
    next-token NLL of the f32 logits; an encoder's (bert) the NLL of the
    tokens themselves at the positions ``% 7 == 3`` (the reference's MLM
    proxy), its layers without a causal mask.  Plus ``aux_weight`` times
    the MoE layers' router aux loss.  Computed in ``compute_dtype`` through
    the plain modules: ``impl`` must be ``"ref"``, as the reference trains
    on its oracle (a kernel's output would leave the autograd graph)."""
    if impl != "ref":
        raise ValueError(f"loss_fn trains through impl='ref', not {impl!r}: the "
                         f"port's kernels have no backward")
    tokens = batch["tokens"]
    B, S = tokens.shape
    pos = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    causal = cfg.family != "encoder"
    cross_src = cross_source(params, cfg, frames=batch.get("frames"),
                             encoder_tokens=batch.get("encoder_tokens"),
                             image_embeds=batch.get("image_embeds"), impl=impl,
                             compute_dtype=compute_dtype, remat=remat,
                             remat_policy=remat_policy)
    h = embed_tokens(params, cfg, tokens, pos, compute_dtype)
    h, _, aux = run_stack(params["stack"], h, cfg=cfg, groups=build_groups(cfg),
                          mode="train" if causal else "encode", pos=pos, impl=impl,
                          cross_src=cross_src, remat=remat, remat_policy=remat_policy)
    h = M.apply_norm(params["final_norm"], h)
    # batch, sequence and vocab stay as the plan put them
    lf = unembed(params, cfg, h, impl).float()
    targets = tokens.long()
    if causal:
        # each position scores the next token, the last position masked:
        # slicing the logits would gather a sequence-sharded tensor whole
        targets = torch.cat([targets[:, 1:], targets[:, :1]], dim=1)
        keep = torch.arange(S, device=tokens.device) < S - 1
    else:
        keep = torch.arange(S, device=tokens.device) % 7 == 3
    nll = _rows_nll(lf, targets)
    loss = torch.where(keep, nll, 0.0).sum() / (keep.sum() * B)
    if isinstance(aux, torch.Tensor):
        # a plan's aux loss, a sum over the layers' DTensors: whole on every rank
        aux = gather_dim(aux.reshape(1), 0).reshape(())
    else:
        aux = torch.as_tensor(aux, dtype=torch.float32, device=tokens.device)
    return loss + aux_weight * aux, {"nll": loss.detach(), "aux": aux.detach()}


def _nll(lf, targets):
    return torch.logsumexp(lf, dim=-1) - torch.gather(lf, -1, targets[..., None])[..., 0]


def _rows_nll(lf, targets):
    """Each position's NLL of its target under the f32 logits ``lf``.
    Under a plan each rank scores its own batch rows and positions over its
    own vocab columns (``local_map``, :class:`_VocabNLL`): the vocab is
    never gathered."""
    mesh = planned_mesh("loss", lf)
    if mesh is None:
        return _nll(lf, targets)
    placed = even(lf.placements, lf.shape, mesh)
    batch, seq, cols = (sharded_over(placed, d) for d in range(3))
    rows = region_placements(mesh, {0: batch, 1: seq})
    cols = [i for i in cols if mesh.size(i) > 1]
    if not cols:
        return local_call(_nll, (lf, targets), (rows, rows), rows, mesh)
    groups = [mesh.get_group(i) for i in cols]
    first = shard_index(mesh, cols) * (lf.shape[-1] // math.prod(mesh.size(i) for i in cols))
    return local_call(lambda l, t: _VocabNLL.apply(l, t, first, groups), (lf, targets),
                      (region_placements(mesh, {0: batch, 1: seq, 2: cols}), rows), rows, mesh)


class _VocabNLL(torch.autograd.Function):
    """``logsumexp - gold`` per position of a rank's vocab columns ``lf``
    (its first column ``first`` of the whole vocab): the columns' max, sum
    of ``exp(l - max)`` and the target's logit (zero where the target is
    another rank's column) are each reduced over ``groups`` (the vocab's
    mesh dims).  The gradient is ``softmax - onehot`` on the rank's own
    columns."""

    @staticmethod
    def forward(ctx, lf, targets, first, groups):
        from torch.distributed import _functional_collectives as funcol
        m = lf.amax(dim=-1)
        for g in groups:
            m = funcol.wait_tensor(funcol.all_reduce(m, "max", g))
        z = torch.exp(lf - m[..., None]).sum(dim=-1)
        idx = targets - first
        mine = (idx >= 0) & (idx < lf.shape[-1])
        gold = torch.where(mine, torch.gather(lf, -1, idx.clamp(0, lf.shape[-1] - 1)[..., None])
                           [..., 0], 0.0)
        for g in groups:
            z = funcol.wait_tensor(funcol.all_reduce(z, "sum", g))
            gold = funcol.wait_tensor(funcol.all_reduce(gold, "sum", g))
        logz = torch.log(z) + m
        ctx.save_for_backward(lf, logz, idx, mine)
        return logz - gold

    @staticmethod
    def backward(ctx, grad):
        lf, logz, idx, mine = ctx.saved_tensors
        g = torch.exp(lf - logz[..., None])
        g.scatter_add_(-1, idx.clamp(0, lf.shape[-1] - 1)[..., None],
                       -mine.to(g.dtype)[..., None])
        return g * grad[..., None], None, None, None


def prefill(params, cfg: ModelConfig, tokens, *, impl="flash",
            compute_dtype=torch.bfloat16, kv_cap: int = 0, length=None,
            kv_bits: int = 0, frames=None, encoder_tokens=None, image_embeds=None):
    """One right-padded prompt a row: ``tokens`` (B, S) at positions
    ``arange(S)``, ``length`` (an int, default S) of them real.  Returns
    (logits (B, V) at position ``length - 1``, cache): per group the
    layers' caches, exact at ``length`` with ``kv_cap`` entries (at least
    S; a ring of ``min(window, kv_cap)`` for local layers), quantised with
    ``kv_bits``.  Causal masking makes attention exact under the pads; the
    SSM and RG-LRU layers take ``length`` too (pads are identity steps and
    never enter the conv state), so their caches are exact as well.

    A stack with cross-attention takes its source, named after the
    reference's batch keys: ``frames`` (whisper), ``encoder_tokens``
    (bart) or ``image_embeds`` (the vision stack); without it this raises.
    Its cross caches are the source's keys and values in the compute dtype
    at every ``kv_bits``, which :func:`decode_step` reads and never
    writes."""
    B, S = tokens.shape
    length = S if length is None else length
    cross_src = cross_source(params, cfg, frames=frames, encoder_tokens=encoder_tokens,
                             image_embeds=image_embeds, impl=impl,
                             compute_dtype=compute_dtype)
    pos = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    h = embed_tokens(params, cfg, tokens, pos, compute_dtype)
    h, caches, _ = run_stack(params["stack"], h, cfg=cfg, groups=build_groups(cfg),
                             mode="prefill", pos=pos, impl=impl, kv_bits=kv_bits,
                             kv_cap=kv_cap, length=length, cross_src=cross_src)
    h = M.apply_norm(params["final_norm"], h)
    logits = unembed(params, cfg, h[:, length - 1:length], impl)[:, 0]
    return logits, {"stack": caches}


def prefill_packed(params, cfg: ModelConfig, tokens, positions, segments,
                   gather_idx, *, impl="flash", compute_dtype=torch.bfloat16,
                   kv_bits: int = 0):
    """Packed ragged prefill: several prompts in one ``(1, C)`` stream.

    ``positions`` are within-prompt positions (RoPE, or the position
    table's rows, where a pad reads row 0), ``segments`` per-token
    prompt ids (-1 = pad) — a query never attends across a prompt
    boundary.  ``gather_idx`` (n_seg,) picks the packed index of each
    prompt's last token; returns (logits (n_seg, V), raw per-token cache) —
    cache leaves keep the packed stream layout (k/v, or with ``kv_bits`` the
    code and scale planes, and pos), the caller scatters segments into KV
    slots.  Only attention layer kinds can be packed (SSM or recurrent
    state would integrate across prompt boundaries)."""
    if not all(k in ("global", "local") for k in cfg.layer_kinds):
        raise ValueError(
            f"packed prefill needs attention-only stacks, got {cfg.layer_kinds}")
    h = embed_tokens(params, cfg, tokens, positions.clamp_min(0), compute_dtype)
    h, caches, _ = run_stack(params["stack"], h, cfg=cfg, groups=build_groups(cfg),
                             mode="prefill", pos=positions, impl=impl,
                             segments=segments, kv_bits=kv_bits)
    h = M.apply_norm(params["final_norm"], h)
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
    h = embed_tokens(params, cfg, tokens, pos.clamp_min(0), compute_dtype)
    h, caches, _ = run_stack(params["stack"], h, cfg=cfg, groups=build_groups(cfg),
                             mode="chunk", pos=pos, caches=cache["stack"], impl=impl)
    h = M.apply_norm(params["final_norm"], h)
    idx = take_idx.long()[:, None, None].expand(-1, 1, h.shape[-1])
    last = torch.gather(h, 1, idx)                      # (B, 1, D)
    logits = unembed(params, cfg, last, impl)[:, 0]
    return logits, {"stack": caches}


def verify_step(params, cfg: ModelConfig, cache, tokens, pos, *, impl="flash",
                compute_dtype=torch.bfloat16):
    """Batched multi-position scoring (the speculative step's verify): the
    chunk pass of :func:`chunk_prefill_step` — ``tokens`` (B, C) written
    into each row's cache in place at ``pos`` (B, C) (-1 = pad / inactive
    row), attending to the pre-write cache plus the in-stream block — with
    the logits kept at every position: those at index ``i`` are the
    distribution of the token after ``tokens[:, i]``.  Returns (logits
    (B, C, V), cache)."""
    h = embed_tokens(params, cfg, tokens, pos.clamp_min(0), compute_dtype)
    h, caches, _ = run_stack(params["stack"], h, cfg=cfg, groups=build_groups(cfg),
                             mode="chunk", pos=pos, caches=cache["stack"], impl=impl)
    h = M.apply_norm(params["final_norm"], h)
    return unembed(params, cfg, h, impl), {"stack": caches}


def decode_step(params, cfg: ModelConfig, cache, tokens, pos, *, impl="flash",
                compute_dtype=torch.bfloat16):
    """One decode step.  tokens (B,), pos (B,) -> (logits (B, V), cache);
    the cache is updated in place (its cross caches read, never written).
    A dead slot's ``pos`` -1 reads the position table's last row, as the
    reference's gather does."""
    pos2 = pos[:, None]
    h = embed_tokens(params, cfg, tokens[:, None], pos2, compute_dtype)
    h, caches, _ = run_stack(params["stack"], h, cfg=cfg, groups=build_groups(cfg),
                             mode="decode", pos=pos2, caches=cache["stack"], impl=impl)
    h = M.apply_norm(params["final_norm"], h)
    logits = unembed(params, cfg, h, impl)[:, 0]
    return logits, {"stack": caches}


# ---------------------------------------------------------------------------
# cache init (serving engine)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, kv_len: int, *,
               dtype=torch.bfloat16, device=None, kv_bits: int = 0):
    """The slot pool: per group, per unit, ``{"attn": {"k", "v", "pos"}}``
    leaves (with ``kv_bits`` 8/4: ``{"k_q", "k_s", "v_q", "v_s", "pos"}``;
    an MLA stack's ``{"ckv", "kr", "pos"}`` in ``dtype`` whatever
    ``kv_bits``),
    or for a recurrent unit ``{"conv", "state"}`` (ssm) or ``{"conv", "h"}``
    (recurrent): ``conv`` in ``dtype``, ``state``/``h`` f32, whatever
    ``kv_bits``.  A ``cross`` unit holds the bare ``{"k", "v"}`` of
    ``n_frontend_tokens`` entries, and a decoder unit of an encoder/decoder
    stack ``{"attn": ..., "cross": {"k", "v"}}``, the cross leaves in
    ``dtype`` at every ``kv_bits``.  Every leaf has a leading ``repeats``
    axis."""
    device = resolve_device(device)
    n_cross = cfg.n_frontend_tokens
    caches = []
    for spec in build_groups(cfg):
        blk = {}
        for ui, (kind, _) in enumerate(spec.units):
            if kind == "ssm":
                one = init_ssm_cache(cfg, batch, dtype, device)
            elif kind == "recurrent":
                one = init_rglru_cache(cfg, batch, dtype, device)
            elif kind == "cross":
                one = init_kv_cache(cfg, "cross", batch, kv_len, dtype, device,
                                    n_cross=n_cross)
            else:
                one = {"attn": init_kv_cache(cfg, kind, batch, kv_len, dtype, device,
                                             kv_bits=kv_bits)}
                if cfg.cross_attn_decoder:
                    one["cross"] = init_kv_cache(cfg, "cross", batch, kv_len, dtype,
                                                 device, n_cross=n_cross)
            blk[f"u{ui}"] = _repeat_tree(one, spec.repeats)
        caches.append(blk)
    return {"stack": caches}


def _repeat_tree(tree, repeats: int):
    """Each leaf of a nested dict with a leading ``repeats`` axis."""
    if isinstance(tree, torch.Tensor):
        return tree[None].repeat((repeats,) + (1,) * tree.dim())
    return {k: _repeat_tree(t, repeats) for k, t in tree.items()}


# ---------------------------------------------------------------------------
# parameter counting
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _param_shapes(cfg: ModelConfig) -> tuple:
    """(dotted name, element count) of every parameter ``init_params``
    builds, on the meta device (no memory)."""
    return tuple((name, p.numel()) for name, p in
                 init_params(cfg, None, device="meta", dtype=torch.float32).named_parameters())


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Every element of the parameter tree; ``active_only``: those a token
    multiplies by (the reference's rules): an untied embedding or position
    table is skipped (a gather, no matmul), and the routed experts count
    ``top_k / n_experts`` of their elements."""
    total = 0.0
    for name, n in _param_shapes(cfg):
        keys = name.split(".")
        if active_only:
            if any(k in ("tok", "pos") for k in keys) and not (
                    cfg.tie_embeddings and "tok" in keys):
                continue
            if "experts" in keys:
                n = n * cfg.top_k / cfg.n_experts
        total += n
    return int(total)
