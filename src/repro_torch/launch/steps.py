"""The steps and batch specs (counterpart of the reference's
``launch/steps.py``): the train step (loss, gradients, AdamW), the prefill
step and the decode step.

The reference's ``build_cell`` and its sharded parameter specs belong to
the dry run and the sharded plane, which the port has yet to take up.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig, ShapeSpec
from repro_torch.models import transformer as T
from repro_torch.training.optimizer import OptConfig, adamw_apply_, adamw_prepare
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


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

class CommitError(RuntimeError):
    """A fault inside a train step's in-place update: some leaves of the
    parameters and moments may hold the new step and others the old."""


def make_train_step(cfg: ModelConfig, *, opt_cfg: OptConfig = OptConfig(), accum: int = 1,
                    remat: bool = True):
    """``train_step(params, opt_state, batch) -> (params, opt_state',
    {"loss", "gnorm", "lr"})`` on trees of tensors (:func:`T.trainable`),
    trained through ``loss_fn``'s plain modules; the metrics are floats.

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
        loss, _ = T.loss_fn(params, cfg, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(params, list(grads))

    def train_step(params, opt_state, batch):
        if accum == 1:
            loss, grads = grads_of(params, batch)
        else:
            micro = {k: v.reshape((accum, v.shape[0] // accum) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
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
        metrics = {"loss": float(loss), "gnorm": float(prep["gnorm"]), "lr": float(prep["lr"])}
        try:
            opt_state = adamw_apply_(grads, opt_state, params, opt_cfg, prep)
            if loss.is_cuda:
                torch.cuda.synchronize(loss.device)
        except Exception as e:
            raise CommitError("the train step failed inside its in-place update") from e
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, *, impl: str = "flash", kv_cap: int = 0):
    """``prefill_step(params, batch) -> (last-token logits, cache)``: the
    source keys of ``batch`` go to :func:`T.prefill` by name."""
    def prefill_step(params, batch):
        src = {k: v for k, v in batch.items() if k != "tokens"}
        return T.prefill(params, cfg, batch["tokens"], impl=impl, kv_cap=kv_cap, **src)
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, impl: str = "flash"):
    """``decode(params, cache, tokens, pos) -> (logits, cache)``."""
    def decode(params, cache, tokens, pos):
        return T.decode_step(params, cfg, cache, tokens, pos, impl=impl)
    return decode
