"""The steps and their input specs (counterpart of the reference's
``launch/steps.py``): the train step (loss, gradients, AdamW), the prefill
step and the decode step, each under an optional plan
(:mod:`repro_torch.parallel`), and :func:`build_cell`, which assembles one
(arch x shape x mesh) cell: the planned step, its example arguments as
meta-device tensors, and the plan.
"""
from __future__ import annotations

import functools

from typing import Optional

import torch

from repro_torch.config import ModelConfig, ShapeSpec
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.api import (Plan, activate_plan, full, is_dtensor, sharded_over,
                                      to_placements)
from repro_torch.training.optimizer import OptConfig, adamw_apply_, adamw_init, adamw_prepare
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


# ---------------------------------------------------------------------------
# batch specs
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict[str, tuple[tuple, torch.dtype]]:
    """(shape, dtype) of each input of a step at ``shape``: tokens (and for
    decode, positions), and the source a stack needs (``frames``,
    ``encoder_tokens``, ``image_embeds``)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": ((B,), torch.int32), "pos": ((B,), torch.int32)}
    b = {"tokens": ((B, S), torch.int32)}
    if cfg.family == "audio":
        b["frames"] = ((B, S, cfg.d_model), torch.bfloat16)
    if cfg.family == "encdec":
        b["encoder_tokens"] = ((B, S), torch.int32)
    if cfg.family == "vlm":
        b["image_embeds"] = ((B, cfg.n_frontend_tokens, cfg.d_model), torch.bfloat16)
    return b


def params_specs(cfg: ModelConfig, param_dtype=torch.float32):
    """The parameter tree as meta-device tensors (names, shapes, dtype; no
    memory): the reference's ``jax.eval_shape`` of ``init_params``."""
    return T.param_tree(T.init_params(cfg, None, device="meta", dtype=param_dtype))


def cache_specs(cfg: ModelConfig, shape: ShapeSpec, *, kv_bits: int = 0):
    """The decode cache of ``shape`` (``global_batch`` rows, ``seq_len``
    entries) as meta-device tensors."""
    return T.init_cache(cfg, shape.global_batch, shape.seq_len, dtype=torch.bfloat16,
                        device="meta", kv_bits=kv_bits)


def _meta_batch(cfg, shape):
    return {k: torch.empty(s, dtype=d, device="meta")
            for k, (s, d) in batch_specs(cfg, shape).items()}


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def micro_batches(v, accum: int) -> list:
    """``v`` cut along its first axis into ``accum`` contiguous
    micro-batches, as the reference's reshape cuts it.  DTensor splits a
    sharded dim only into factors its shard count divides (XLA reshards
    instead), so a DTensor sharded along the batch first moves those
    shards to another dim they divide (an all-to-all: no rank holds the
    whole batch; replicated where no dim takes them), is cut there, and
    each micro-batch comes back to the batch's own placements."""
    shape = (accum, v.shape[0] // accum) + tuple(v.shape[1:])
    over = sharded_over(v.placements, 0) if is_dtensor(v) else []
    if not over:
        return list(v.reshape(shape))
    from torch.distributed.tensor import Replicate, Shard
    mesh, n = v.device_mesh, 1
    for i in over:
        n *= mesh.size(i)
    taken = {p.dim for p in v.placements if p.is_shard()}
    d = next((d for d in range(1, v.dim()) if d not in taken and v.shape[d] % n == 0), None)
    moved = list(v.placements)
    for i in over:
        moved[i] = Replicate() if d is None else Shard(d)
    cut = to_placements(v, mesh, moved).reshape(shape)
    return [to_placements(cut[i], mesh, v.placements) for i in range(accum)]


class CommitError(RuntimeError):
    """A fault inside a train step's in-place update: some leaves of the
    parameters and moments may hold the new step and others the old."""


def make_train_step(cfg: ModelConfig, plan: Optional[Plan] = None, *,
                    opt_cfg: OptConfig = OptConfig(), accum: int = 1, remat: bool = True):
    """``train_step(params, opt_state, batch) -> (params, opt_state',
    {"loss", "gnorm", "lr"})`` on trees of tensors (:func:`T.trainable`),
    trained through ``loss_fn``'s plain modules; the metrics are floats.
    Under ``plan`` the loss runs with the plan active, on parameters,
    moments and a batch distributed at the plan's specs, and each gradient
    is redistributed to its parameter's placement (partial sums reduced
    and scattered), so the update runs shard by shard.

    With ``accum`` > 1 the batch is cut into ``accum`` micro-batches along
    its first axis, one after the other (the reference's ``lax.scan``):
    their gradients summed in f32, then the sum and the mean loss divided
    by ``accum``.  The update is written into ``params`` and
    ``opt_state``'s moments (:func:`adamw_apply_`), and only once
    everything before it has run and its metrics are read: a fault before
    the update leaves the state as it was; a fault inside it raises
    :class:`CommitError`."""
    def grads_of(params, batch):
        leaves = tree_leaves(params)
        with activate_plan(plan):
            loss, _ = T.loss_fn(params, cfg, batch, remat=remat)
            grads = torch.autograd.grad(loss, leaves)
        grads = [g.redistribute(p.device_mesh, p.placements) if is_dtensor(g) else g
                 for g, p in zip(grads, leaves)]
        return full(loss.detach()), tree_unflatten(params, list(grads))

    def train_step(params, opt_state, batch):
        if accum == 1:
            loss, grads = grads_of(params, batch)
        else:
            micro = {k: micro_batches(v, accum) for k, v in batch.items()}
            grads = adamw_init(params)["m"]                  # f32 zeros, placed alike
            loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            for i in range(accum):
                l, g = grads_of(params, {k: v[i] for k, v in micro.items()})
                grads = tree_map(lambda a, b: a + b.float(), grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / accum, grads)
            loss = loss / accum
        prep = adamw_prepare(grads, opt_state, opt_cfg)
        # reading the metrics waits for the gradients: a fault of the
        # backward surfaces here, before anything is written
        metrics = {"loss": float(loss), "gnorm": float(full(prep["gnorm"])),
                   "lr": float(full(prep["lr"]))}
        try:
            opt_state = adamw_apply_(grads, opt_state, params, opt_cfg, prep)
            if loss.is_cuda:
                torch.cuda.synchronize(loss.device)
        except Exception as e:
            raise CommitError("the train step failed inside its in-place update") from e
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, plan: Optional[Plan] = None, *,
                      impl: str = "flash", kv_cap: int = 0, ctx=None):
    """``prefill_step(params, batch) -> (last-token logits, cache)`` under
    ``plan``: the source keys of ``batch`` go to :func:`T.prefill` by
    name.  With the plan's ``ctx`` each layer's cache comes out at the
    specs of :func:`~repro_torch.parallel.sharding.cache_shardings`, the
    reference's ``out_shardings``."""
    place = None if ctx is None else functools.partial(SH.place_layer_cache, ctx=ctx)

    def prefill_step(params, batch):
        src = {k: v for k, v in batch.items() if k != "tokens"}
        with activate_plan(plan):
            return T.prefill(params, cfg, batch["tokens"], impl=impl, kv_cap=kv_cap,
                             place_cache=place, **src)
    return prefill_step


def make_decode_step(cfg: ModelConfig, plan: Optional[Plan] = None, *, impl: str = "flash"):
    """``decode(params, cache, tokens, pos) -> (logits, cache)`` under
    ``plan``."""
    def decode(params, cache, tokens, pos):
        with activate_plan(plan):
            return T.decode_step(params, cfg, cache, tokens, pos, impl=impl)
    return decode


# ---------------------------------------------------------------------------
# one (arch x shape x mesh) cell
# ---------------------------------------------------------------------------

def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, *, accum: int = 1,
               impl: Optional[str] = None, opt_cfg: OptConfig = OptConfig(),
               remat: bool = True):
    """(step, example arguments, plan) of one cell, the reference's
    ``build_cell``: the plan of ``shape.kind`` on ``mesh``, and the step
    under it (:func:`make_train_step`, :func:`make_prefill_step` at
    ``kv_cap = seq_len``, or :func:`make_decode_step`).  The arguments are
    meta-device tensors of the unsharded shapes (params f32 for training,
    bf16 for serving; AdamW's moments; the batch; the decode cache): put
    real ones on the mesh with :func:`place_args` before calling the step.
    ``impl`` defaults to ``"ref"`` for training (the kernels have no
    backward) and ``"flash"`` for serving."""
    mode = shape.kind
    plan, ctx = SH.build_plan(cfg, shape, mesh, mode=mode)
    batch = _meta_batch(cfg, shape)
    if mode == "train":
        pspecs = params_specs(cfg, torch.float32)
        fn = make_train_step(cfg, plan, opt_cfg=opt_cfg, accum=accum, remat=remat)
        return fn, (pspecs, adamw_init(pspecs), batch), plan
    pspecs = params_specs(cfg, torch.bfloat16)
    impl = impl or "flash"
    if mode == "prefill":
        return make_prefill_step(cfg, plan, impl=impl, kv_cap=shape.seq_len, ctx=ctx), \
            (pspecs, batch), plan
    return make_decode_step(cfg, plan, impl=impl), \
        (pspecs, cache_specs(cfg, shape), batch["tokens"], batch["pos"]), plan


def place_args(cfg: ModelConfig, shape: ShapeSpec, mesh, *args):
    """A cell's real arguments (whole tensors, the same on every rank) on
    ``mesh`` at its plan's specs: a parameter tree at ``params_shardings``,
    AdamW's state with its moments placed as the parameters (ZeRO), a
    decode cache at ``cache_shardings``, a batch at ``batch_shardings``;
    anything else as it is."""
    _, ctx = SH.build_plan(cfg, shape, mesh, mode=shape.kind)
    specs = None
    placed = []
    for arg in args:
        if isinstance(arg, dict) and "embed" in arg:
            specs = SH.params_shardings(arg, ctx)
            placed.append(SH.distribute_tree(arg, specs, mesh))
        elif isinstance(arg, dict) and "count" in arg:
            placed.append({"m": SH.distribute_tree(arg["m"], specs, mesh),
                           "v": SH.distribute_tree(arg["v"], specs, mesh),
                           "count": arg["count"]})
        elif isinstance(arg, dict) and "stack" in arg:
            placed.append(SH.distribute_tree(arg, SH.cache_shardings(arg, ctx), mesh))
        elif isinstance(arg, dict):
            placed.append(SH.distribute_tree(arg, SH.batch_shardings(arg, ctx), mesh))
        else:
            placed.append(arg)
    return placed
