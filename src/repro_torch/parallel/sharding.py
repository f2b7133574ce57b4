"""Per-kernel-class sharding plans — the paper's heterogeneous mapping on a
mesh (counterpart of the reference's ``parallel/sharding.py``).

The paper assigns each transformer kernel class to the substrate matching
its operand-update behaviour (§3.1): dynamic attention operands → SM/MC/DRAM
plane; static weight-stationary FFN/embedding → ReRAM macro.  On a
homogeneous mesh the same classification decides *placement*:

  kernel class        paper substrate     placement (this module)
  ------------------  ------------------  -----------------------------------
  QKV/score/PV        SM cluster + HBM    activations head-sharded over
                                          ``model`` ("SM cluster" axis group)
  FFN / experts       ReRAM macro (SFC)   weights stationary, f-dim sharded
                                          over ``model``; experts → EP
  embedding/LM head   ReRAM (one-time)    vocab-sharded over ``model``
  residual stream     NoI traffic         sequence-sharded over ``model``
                                          (SP) in train/prefill
  batch/grad sync     —                   ``data`` (+``pod``) axes: FSDP + DP

The rules are the reference's, line for line, and return specs (tuples
of ``None``, axis names and axis tuples) that compare one to one with the
reference's ``PartitionSpec``s.  A plan is pure data: built on an
:class:`~repro_torch.parallel.api.AbstractMesh` it needs no process group.
The functions at the end put a parameter module, a tree (optimizer
moments, a slot pool, a batch) or a tensor on a ``DeviceMesh`` at those
specs, and gather them back.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.config import ModelConfig, ShapeSpec
from repro_torch.parallel.api import Plan, even, is_dtensor, mesh_shape, placements

# serving: params go 2-D (model × data) above this per-device budget for
# pure-TP bf16 weights
_TP_ONLY_BYTES = 6 << 30


def _div(n: int, mesh, axis) -> bool:
    """True if dim of size n is divisible by the mesh axis (or axis tuple)."""
    if axis is None:
        return True
    shape = mesh_shape(mesh)
    size = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        size *= shape[a]
    return n > 0 and n % size == 0


def _maybe(n: int, mesh, axis):
    return axis if _div(n, mesh, axis) else None


@dataclasses.dataclass
class PlanContext:
    cfg: ModelConfig
    shape: ShapeSpec
    mesh: object
    fsdp: Optional[object]     # axis (or axis tuple) for weight sharding on the d_model dim
    dp: tuple[str, ...]        # batch axes
    seq_axis: Optional[str]    # SP axis for the residual stream (train/prefill)


def _plan_context(cfg, shape, mesh, *, mode) -> PlanContext:
    ms = mesh_shape(mesh)
    multi_pod = "pod" in ms
    if mode == "train":
        dp = ("pod", "data") if multi_pod else ("data",)
        # ZeRO/FSDP spans every batch axis
        fsdp = ("pod", "data") if multi_pod else "data"
        seq_axis = "model" if shape.seq_len % ms["model"] == 0 else None
    elif mode == "prefill":
        dp = ("pod", "data") if multi_pod else ("data",)
        fsdp = _serving_fsdp(cfg, mesh)
        seq_axis = "model" if shape.seq_len % ms["model"] == 0 else None
    else:  # decode
        dp = ()
        gb = shape.global_batch
        if multi_pod and gb % (ms["pod"] * ms["data"]) == 0:
            dp = ("pod", "data")
        elif gb % ms["data"] == 0:
            dp = ("data",)
        fsdp = _serving_fsdp(cfg, mesh)
        seq_axis = None
    return PlanContext(cfg, shape, mesh, fsdp, dp, seq_axis)


def _serving_fsdp(cfg, mesh) -> Optional[str]:
    per_dev = 2 * cfg.param_count() / mesh_shape(mesh)["model"]
    return "data" if per_dev > _TP_ONLY_BYTES else None


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

def param_spec(path: str, shape: tuple[int, ...], ctx: PlanContext) -> tuple:
    """Spec for one parameter, by ``/``-joined path + shape.

    Stack params carry a leading repeats dim — detected via path prefix
    ``stack/``/``encoder/`` and left unsharded.
    """
    mesh, fsdp = ctx.mesh, ctx.fsdp
    lead: tuple = ()
    dims = tuple(shape)
    if path.startswith(("stack/", "encoder/")):
        lead = (None,)
        dims = dims[1:]

    name = path.split("/")[-1]
    parent = path.split("/")[-2] if "/" in path else ""

    def fs(n):  # fsdp axis if divisible
        return _maybe(n, mesh, fsdp)

    def mp(n):  # model axis if divisible
        return _maybe(n, mesh, "model")

    # ---- embeddings -------------------------------------------------------
    if path == "embed/tok":
        # d-dim sharded (FSDP); vocab replicated
        return (None, fs(dims[1]))
    if path == "embed/pos":
        return (None, fs(dims[1]))
    if path == "lm_head":
        return (fs(dims[0]), mp(dims[1]))

    # ---- experts (EP: the ReRAM-macro analogue) ---------------------------
    if "experts" in path:
        if name in ("w_gate", "w_up"):        # (E, D, Fe)
            return (*lead, mp(dims[0]), fs(dims[1]), None)
        if name == "w_down":                  # (E, Fe, D)
            return (*lead, mp(dims[0]), None, fs(dims[2]))
    if name == "router":                      # (D, E)
        return (*lead, fs(dims[0]), None)

    # ---- attention --------------------------------------------------------
    if parent in ("attn", "cross") or name in ("wq", "wk", "wv", "wo"):
        if name == "wq":
            if len(dims) == 3:                # MLA direct (D, H, dn+dr)
                return (*lead, fs(dims[0]), mp(dims[1]), None)
            return (*lead, fs(dims[0]), mp(dims[1]))
        if name in ("wk", "wv"):
            return (*lead, fs(dims[0]), mp(dims[1]))
        if name == "wo":
            return (*lead, mp(dims[0]), fs(dims[1]))
        if name == "wq_a":                    # (D, qr)
            return (*lead, fs(dims[0]), None)
        if name == "wq_b":                    # (qr, H, dn+dr)
            return (*lead, None, mp(dims[1]), None)
        if name == "wkv_a":                   # (D, kvr+dr)
            return (*lead, fs(dims[0]), None)
        if name == "wkv_b":                   # (kvr, H, dn+dv)
            return (*lead, None, mp(dims[1]), None)
        if name in ("bq", "bk", "bv"):
            return (*lead, mp(dims[0]))

    # ---- dense MLP (weight-stationary plane) ------------------------------
    if name in ("w_gate", "w_up"):            # (D, F)
        return (*lead, fs(dims[0]), mp(dims[1]))
    if name == "w_down":                      # (F, D)
        return (*lead, mp(dims[0]), fs(dims[1]))
    if name == "b_up":
        return (*lead, mp(dims[0]))

    # ---- mamba2 ------------------------------------------------------------
    if name == "in_proj":                     # (D, Z)
        return (*lead, fs(dims[0]), mp(dims[1]))
    if name == "out_proj":                    # (di, D)
        return (*lead, mp(dims[0]), fs(dims[1]))

    # ---- RG-LRU -------------------------------------------------------------
    if name in ("w_branch",):                 # (D, W)
        return (*lead, fs(dims[0]), mp(dims[1]))
    if name in ("wa", "wi"):                  # (W, W)
        return (*lead, None, mp(dims[1]))
    if name == "w_out":                       # (W, D)
        return (*lead, mp(dims[0]), fs(dims[1]))

    # ---- everything else (norm scales, gates, conv, scalars) --------------
    return (*lead, *(None for _ in dims))


def quant_plane_specs(spec: tuple, q: torch.Tensor, scale: torch.Tensor, mesh) -> tuple:
    """(codes' spec, scales' spec) of a quantised weight whose weight has
    ``spec``: a plane keeps an axis where its dim divides it.  The
    contraction dim (packed int4 codes, a grouped scale's ``K / group``
    rows) is sharded on both planes or on neither, so that a rank's codes
    and scales hold the same rows; a per-channel scale's one row is
    replicated."""
    qs = [e if _div(n, mesh, e) else None for e, n in zip(spec, q.shape)]
    ss = [e if _div(n, mesh, e) else None for e, n in zip(spec, scale.shape)]
    if scale.shape[-2] == 1:
        ss[-2] = None
    elif qs[-2] is None or ss[-2] is None:
        qs[-2] = ss[-2] = None
    return tuple(qs), tuple(ss)


def module_path(name: str) -> str:
    """A parameter module's dotted name as the reference's tree path."""
    return name.replace(".", "/")


def params_shardings(params, ctx: PlanContext) -> dict[str, tuple]:
    """{path: spec} of every leaf of a parameter module (:class:`~repro_torch.
    models.transformer.Transformer`, real or on the meta device) or a tree
    of tensors.  A quantised weight's code and scale planes
    (``<path>/q``, ``<path>/scale``) follow its weight's spec
    (:func:`quant_plane_spec`)."""
    from repro_torch.ckpt import tree_items
    from repro_torch.models.transformer import QuantWeight
    if isinstance(params, torch.nn.Module):
        out = {}
        for name, mod in params.named_modules():
            if isinstance(mod, QuantWeight):
                path = module_path(name)
                k = mod.q.shape[-2] * (2 if mod.bits == 4 else 1)
                wshape = tuple(mod.q.shape[:-2]) + (k, mod.q.shape[-1])
                out[path + "/q"], out[path + "/scale"] = quant_plane_specs(
                    param_spec(path, wshape, ctx), mod.q, mod.scale, ctx.mesh)
        for name, p in params.named_parameters():
            path = module_path(name)
            out[path] = param_spec(path, tuple(p.shape), ctx)
        return out
    return {path: param_spec(path, tuple(leaf.shape), ctx) for path, leaf in tree_items(params)}


# ---------------------------------------------------------------------------
# activation roles
# ---------------------------------------------------------------------------

def _roles(ctx: PlanContext, *, mode: str) -> dict[str, tuple]:
    cfg, mesh = ctx.cfg, ctx.mesh
    dp = ctx.dp if ctx.dp else None
    Hq = cfg.n_heads
    Hkv = cfg.n_kv_heads

    # Head-parallel attention only when *both* q and kv head counts divide
    # the axis; else sequence-parallel q blocks
    heads_ok = _div(Hq, mesh, "model") and _div(Hkv, mesh, "model")

    vocab_ax = _maybe(cfg.vocab_size, mesh, "model")
    if mode == "decode":
        if heads_ok:
            return {
                "residual": (dp, None, None),
                "act_heads": (dp, None, "model", None),
                "kv_heads": (dp, None, "model", None),
                "act_ff": (dp, None, "model"),
                "expert_buf": (dp, "model", None, None),
                "expert_hidden": (dp, "model", None, None),
                "logits": (dp, None, vocab_ax),
            }
        return {
            "residual": (dp, None, None),
            "act_heads": (dp, None, None, None),   # q replicated; KV cache
            "kv_heads": (dp, None, None, None),    # stays sequence-sharded
            "act_ff": (dp, None, "model"),
            "expert_buf": (dp, "model", None, None),
            "expert_hidden": (dp, "model", None, None),
            "logits": (dp, None, vocab_ax),
        }

    seq = ctx.seq_axis
    if heads_ok:
        attn_roles = {
            "act_heads": (dp, None, "model", None),
            "kv_heads": (dp, None, "model", None),
        }
    elif mode == "prefill":
        # forward-only GQA with fewer KV heads than the model axis:
        # K/V replicated over the axis, q sequence-sharded
        attn_roles = {
            "act_heads": (dp, seq, None, None),
            "kv_heads": (dp, None, None, None),
        }
    else:
        # training: the Megatron-SP pattern
        attn_roles = {
            "act_heads": (dp, seq, None, None),
            "kv_heads": (dp, seq, None, None),
        }
    # FFN hidden activations: train f-dim TP-sharded; prefill sequence-
    # sharded with the layer weights gathered
    ff_spec = (dp, seq, None) if mode == "prefill" else (dp, None, "model")
    roles_extra = {}
    if mode == "prefill":
        # the weight-gathered strategy on the attention projections too
        roles_extra["weight_full"] = (None, None)
    return {
        "residual": (dp, seq, None),
        **attn_roles,
        "act_ff": ff_spec,
        "expert_buf": (dp, "model", None, None),
        "expert_hidden": (dp, "model", None, None),
        **roles_extra,
        # unembed boundary: activations re-gathered over seq, the vocab dim
        # sharded; a vocab that does not divide stays sequence-sharded
        "pre_logits": (dp, None, None) if vocab_ax else (dp, seq, None),
        "logits": (dp, None, vocab_ax) if vocab_ax else (dp, seq, None),
    }


# ---------------------------------------------------------------------------
# KV-cache shardings
# ---------------------------------------------------------------------------

def _cache_spec(name: str, dims: tuple, ctx: PlanContext) -> tuple:
    mesh = ctx.mesh
    dp = ctx.dp if ctx.dp else None
    if name in ("k", "v", "k_q", "v_q", "k_s", "v_s"):
        # (R, B, S, Hkv, hd): code planes and scale planes shard the same
        # leading axes, so codes and scales stay co-located
        S, H = dims[2], dims[3]
        tail = (None,) * (len(dims) - 4)
        if dp is None:
            # batch unshardable: spread the sequence
            seq_ax = ("data", "model") if _div(S, mesh, ("data", "model")) \
                else _maybe(S, mesh, "data")
            h_ax = _maybe(H, mesh, "model") if not (
                isinstance(seq_ax, tuple)) else None
            return (None, None, seq_ax, h_ax, *tail)
        h_ax = _maybe(H, mesh, "model")
        seq_ax = "model" if h_ax is None and _div(S, mesh, "model") else None
        return (None, dp, seq_ax, h_ax, *tail)
    if name in ("ckv", "kr"):              # (R, B, S, r)
        S = dims[2]
        if dp is None:
            seq_ax = ("data", "model") if _div(S, mesh, ("data", "model")) \
                else _maybe(S, mesh, "data")
            return (None, None, seq_ax, None)
        return (None, dp, _maybe(S, mesh, "model"), None)
    if name == "pos":                      # (R, B, S)
        S = dims[2]
        if dp is None:
            seq_ax = ("data", "model") if _div(S, mesh, ("data", "model")) \
                else _maybe(S, mesh, "data")
            return (None, None, seq_ax)
        return (None, dp, None)
    if name == "state":                    # (R, B, H, P, N) ssd state
        return (None, dp, _maybe(dims[2], mesh, "model"), None, None)
    if name == "conv":                     # (R, B, W-1, C)
        return (None, dp, None, _maybe(dims[3], mesh, "model"))
    if name == "h":                        # (R, B, W) rg-lru state
        return (None, dp, _maybe(dims[2], mesh, "model"))
    return tuple(None for _ in dims)


def cache_shardings(cache, ctx: PlanContext):
    """The specs of a stacked cache tree (``T.init_cache``'s, real or on
    the meta device), in its structure: batch → dp, then heads → model if
    divisible, else sequence → model (long-context single-batch decode
    shards the sequence across everything available)."""
    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, name) for v in tree]
        return _cache_spec(name, tuple(tree.shape), ctx)
    return walk(cache, "")


def place_layer_cache(tree, ctx: PlanContext):
    """One layer's cache tree (leaves (B, ...), as a prefill makes them) at
    the specs :func:`cache_shardings` gives the stacked cache, less its
    leading repeats dim: each rank keeps its own slice of a leaf the plan
    splits, nothing is sent."""
    def walk(t, name):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        return distribute(t, ctx.mesh, _cache_spec(name, (1, *t.shape), ctx)[1:])
    return walk(tree, "")


# ---------------------------------------------------------------------------
# batch shardings + plan assembly
# ---------------------------------------------------------------------------

def batch_shardings(batch_shapes: dict, ctx: PlanContext) -> dict[str, tuple]:
    """Each batch input's spec, its batch dim over dp: ``batch_shapes``
    maps names to tensors or ``(shape, dtype)`` (``steps.batch_specs``)."""
    dp = ctx.dp if ctx.dp else None

    def ndim(v):
        return v.dim() if isinstance(v, torch.Tensor) else len(v[0])
    return {k: (dp, *(None,) * (ndim(v) - 1)) for k, v in batch_shapes.items()}


def build_plan(cfg: ModelConfig, shape: ShapeSpec, mesh, *, mode: str) -> tuple[Plan, PlanContext]:
    ctx = _plan_context(cfg, shape, mesh, mode=mode)
    plan = Plan(mesh=mesh, roles=_roles(ctx, mode=mode),
                name=f"{cfg.name}:{shape.name}:{mode}")
    return plan, ctx


def serving_decode_plan(cfg: ModelConfig, mesh, *, max_batch: int,
                        kv_len: int) -> tuple[Plan, PlanContext]:
    """Decode-mode plan for the serving engine's slotted KV pool: the slot
    (batch) axis maps to the data axes when divisible, KV heads to the model
    axis — the placement the paper gives dynamic attention operands
    (§3.1).  Feed the returned ctx to :func:`cache_shardings` for the pool."""
    shape = ShapeSpec("serving", "decode", kv_len, max_batch)
    return build_plan(cfg, shape, mesh, mode="decode")


def serving_prefill_plan(cfg: ModelConfig, mesh, *,
                         prefill_chunk: int) -> tuple[Plan, PlanContext]:
    """Prefill-mode plan for the engine's packed ragged prefill call: the
    packed stream is one ``(1, C)`` batch row, so it is sequence-sharded
    over ``model`` instead, with the weight-gathered projections.  The
    chunked continuation runs over the whole slot pool under the decode
    plan."""
    shape = ShapeSpec("serving_packed", "prefill", prefill_chunk, 1)
    seq_ax = "model" if prefill_chunk % mesh_shape(mesh)["model"] == 0 else None
    ctx = PlanContext(cfg, shape, mesh, fsdp=_serving_fsdp(cfg, mesh),
                      dp=(), seq_axis=seq_ax)
    plan = Plan(mesh=mesh, roles=_roles(ctx, mode="prefill"),
                name=f"{cfg.name}:serving_packed:prefill")
    return plan, ctx


# ---------------------------------------------------------------------------
# putting tensors on a mesh
# ---------------------------------------------------------------------------

def distribute(t: torch.Tensor, mesh, spec: tuple):
    """``t`` (the whole value, the same on every rank) as a DTensor at
    ``spec`` (a dim it cannot split evenly replicated, :func:`~repro_torch.
    parallel.api.even`): each rank keeps its own slice, nothing is sent.  A
    DTensor is redistributed."""
    from torch.distributed.tensor import distribute_tensor
    target = even(placements(spec, mesh), t.shape, mesh)
    if is_dtensor(t):
        return t.redistribute(mesh, target)
    return distribute_tensor(t, mesh, target, src_data_rank=None)


def distribute_like(whole: torch.Tensor, like):
    """``whole`` (the same on every rank) as a DTensor placed as the
    DTensor ``like``: each rank keeps its own slice, nothing is sent."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(whole.to(like.to_local().device), like.device_mesh,
                             like.placements, src_data_rank=None)


def spec_items(specs, prefix: str = ""):
    """(``/``-joined path, spec) of a tree of specs (dicts and lists; a
    spec is a tuple, a leaf)."""
    if isinstance(specs, dict):
        for k, v in specs.items():
            yield from spec_items(v, f"{prefix}{k}/")
    elif isinstance(specs, list):
        for i, v in enumerate(specs):
            yield from spec_items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], specs


def map_tree(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a tree of tensors (dicts, lists and tuples),
    in its structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def distribute_tree(tree, specs, mesh):
    """A tree of whole tensors as DTensors at ``specs`` (a tree of specs in
    its structure, as :func:`cache_shardings` gives, or a ``{path: spec}``
    dict); a leaf that takes gradients keeps taking them."""
    flat = dict(spec_items(specs))

    def one(path, leaf):
        d = distribute(leaf.detach(), mesh, flat[path])
        return d.requires_grad_(True) if leaf.requires_grad else d
    return map_tree(one, tree)


def gather_tree(tree):
    """Every DTensor leaf of ``tree`` as its whole value (a collective on
    its mesh); plain leaves as they are.  A leaf that takes gradients keeps
    taking them."""
    def one(path, leaf):
        if not is_dtensor(leaf):
            return leaf
        g = leaf.detach().full_tensor()
        return g.requires_grad_(True) if leaf.requires_grad else g
    return map_tree(one, tree)


def distribute_params(params, ctx: PlanContext):
    """A parameter module (:class:`~repro_torch.models.transformer.
    Transformer`) on ``ctx.mesh``: a new module of the same tree whose
    parameters and quantised weights' planes are DTensors at their specs
    (:func:`params_shardings`).  ``params`` is left as it is; a rank keeps
    a slice of each tensor (a replicated one shares its storage)."""
    from repro_torch.models import transformer as T
    from repro_torch.quant.core import QuantTensor
    specs = params_shardings(params, ctx)

    def tree(mod, prefix):
        if isinstance(mod, T.QuantWeight):
            qt = mod.tensor()
            return QuantTensor(distribute(qt.q, ctx.mesh, specs[prefix + "q"]),
                               distribute(qt.scale, ctx.mesh, specs[prefix + "scale"]),
                               qt.bits, qt.group)
        if isinstance(mod, torch.nn.ModuleList):
            return [tree(m, f"{prefix}{i}/") for i, m in enumerate(mod)]
        return {k: (distribute(v.detach(), ctx.mesh, specs[prefix + k])
                    if isinstance(v, torch.Tensor) else tree(v, f"{prefix}{k}/"))
                for k, v in mod.items()}
    return T.Transformer(params.cfg, tree(params, ""))
